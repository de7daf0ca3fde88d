"""Port parity: the batched shared scan (`make_batched_query_fn`,
`BlinkDB.query_batch`) and the fused kernel's launch plan.

query_batch runs on the CPU through the plain version of the fused scan and
is held against the reference's query_batch at the tolerances of
tests/test_batched.py, with the reference's sample units carried into the
port. Batches holding a QUANTILE query run the reference with
use_pallas=True (the port's one QUANTILE semantics is its kernel path's).
Within the port, a batched answer equals query()'s on the same engine bit
for bit: the launch plan of a query does not depend on how many queries
share the launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import elp as ref_elp
from repro.core import executor as ref_exec
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.data import synth as ref_synth
import repro_torch.core as P
from repro_torch import state
from repro_torch.core import elp
from repro_torch.core import engine as engine_lib
from repro_torch.core import executor as exec_lib
from repro_torch.core import table as table_lib
from repro_torch.core.types import CmpOp
from repro_torch.data import synth
from repro_torch.kernels import agg_scan

N_ROWS, SEED = 25_000, 1
FAMILIES = (("City",), ("OS",), ())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------- launch plan

@pytest.mark.parametrize("n, g", [(0, 1), (1, 1), (100_003, 1), (100_003, 6),
                                  (5_000_000, 500), (20_000_000, 200),
                                  (2_000_000, 70_000)])
@pytest.mark.parametrize("n_sms", [132, 114])
def test_launch_plan_is_the_same_for_every_q(n, g, n_sms):
    """A query's chunking and group tile, which fix its sum order, are the
    same at every Q in 1..64; only the blocks per chunk grow with Q."""
    rows, chunks, gt, tiles = agg_scan.launch_plan(n, 1, g, n_sms)
    for q in range(1, agg_scan.MAX_QUERIES + 1):
        assert agg_scan.launch_plan(n, q, g, n_sms) == \
            (rows, chunks, gt, q * tiles)
    assert agg_scan.hist_plan(n, g, n_sms)[1] <= chunks


def test_hist_plan_caps_the_histogram_scratch():
    rows, chunks = agg_scan.hist_plan(20_000_000, 500, 132)
    assert chunks * 500 * 256 * 4 <= 64 << 20
    assert rows % 256 == 0 and rows * chunks >= 20_000_000


@pytest.mark.parametrize("n", [0, 1, 100_003, 20_000_000])
@pytest.mark.parametrize("g", [1, 6, 8, 9, 32, 33, 64, 65, 200, 500, 1024,
                               1025, 4096])
@pytest.mark.parametrize("n_sms", [132, 114])
def test_hist_plan_covers_rows_and_caps_scratch(n, g, n_sms):
    """The histogram's chunks cover every row once, its scratch
    [chunks, G, 256] floats stays within 64 MiB, and up to 32 groups (one
    pass with the moments) it is the moments' plan."""
    rows, chunks = agg_scan.hist_plan(n, g, n_sms)
    assert rows % 1024 == 0 and rows * chunks >= n
    assert chunks == 1 or rows * (chunks - 1) < n
    assert chunks * g * 256 * 4 <= max(64 << 20, g * 256 * 4)
    if g <= 32:
        assert (rows, chunks) == agg_scan.launch_plan(n, 1, g, n_sms)[:2]
    assert agg_scan.hist_plan(n, g, n_sms) == (rows, chunks)


def _header_constants() -> dict:
    """The `constexpr int kName = value;` constants of csrc/scan_common.cuh."""
    import re
    return {m[0]: int(m[1]) for m in
            re.findall(r"constexpr int (k\w+) = (\d+);",
                       agg_scan.HEADER.read_text())}


def _shared_bytes(c: dict, n_tab: int, gt: int, moments: bool,
                  hist: bool) -> int:
    """Dynamic shared bytes of one scan pass: a copy of csrc/scan_common.cuh
    `scan::layout` over the header's constants c. The producer's table of
    n_tab floats, the moments of a group tile gt (shared mode) or the
    threads' and warps' sums (register mode), the histogram tile (one per
    warp beside register mode) and the staged step."""
    def up4(x):
        return -(-x // 4) * 4
    threads, warps, bins = c["kThreads"], c["kThreads"] // 32, c["kBins"]
    reg = moments and gt <= c["kRegGroups"]
    priv = hist and reg
    floats = up4(n_tab)
    floats += up4(7 * gt) if moments and not reg else 0
    floats += 7 * gt * threads if reg and gt >= c["kColGroups"] and not hist \
        else 0
    floats += warps * 7 * gt if reg else 0
    floats += (warps if priv else 1) * gt * bins if hist else 0
    floats += warps * 32 if priv else 0
    staged = (moments and not reg) or (hist and not priv)
    floats += 5 * threads * c["kRows"] + 2 * threads + warps if staged else 0
    return 4 * floats


@pytest.mark.parametrize("n_strata", [1, 300, 4096, 4097, 70_000])
def test_scan_passes_fit_shared_memory(n_strata):
    """Every scan pass of a fused or quantile call fits a block's dynamic
    shared memory, for every G in 1..4096: the moments pass at the plan's
    group tile, and the quantile histogram in it up to kOnePassGroups or in
    its own pass of kHistTile groups above. A table of more than kMaxStrata
    strata is read through L2 and takes no shared memory."""
    c = _header_constants()
    n_tab = n_strata if n_strata <= c["kMaxStrata"] else 0
    for g in range(1, 4097):
        gt = agg_scan.launch_plan(0, 1, g, 1)[2]
        fused = [_shared_bytes(c, n_tab, gt, True, False)]
        if g <= c["kOnePassGroups"]:
            quantile = [_shared_bytes(c, n_tab, gt, True, True)]
        else:
            quantile = fused + [_shared_bytes(c, n_tab, c["kHistTile"],
                                              False, True)]
        for sizes in (fused, quantile):
            assert max(sizes) <= agg_scan.MAX_SHARED, (g, sizes)


def test_plan_constants_match_the_kernel_header():
    """The Python plan mirrors csrc/scan_common.cuh's constants."""
    const = _header_constants()
    assert const["kThreads"] * const["kRows"] == agg_scan._STAGE
    assert const["kRegGroups"] == agg_scan._REG_GROUPS
    assert const["kMaxTile"] == agg_scan._MAX_TILE
    assert const["kOnePassGroups"] == agg_scan._ONE_PASS_GROUPS
    assert const["kBins"] == 256
    assert const["kMaxShared"] == agg_scan.MAX_SHARED
    assert const["kMaxQ"] == agg_scan.MAX_QUERIES
    assert const["kMaxStrata"] == agg_scan.SHARED_STRATA


# ---------------------------------------------------- make_batched_query_fn

def _tables():
    raw = ref_synth.sessions_table(N_ROWS, seed=4)
    return (ref_table.from_columns("s", raw),
            table_lib.from_columns("s", synth.sessions_table(N_ROWS, seed=4)))


def _units():
    return {phi: ref_samp.base_units(N_ROWS, SEED, uniform=phi == ())
            for phi in FAMILIES}


def _ref_db(tbl, use_pallas):
    db = R.BlinkDB(R.EngineConfig(k1=500.0, m=3, seed=SEED,
                                  use_pallas=use_pallas))
    db.register_table("s", tbl)
    for phi in FAMILIES:
        db.add_family("s", phi)
    return db


def _port_db(tbl, **cfg):
    db = P.BlinkDB(P.EngineConfig(k1=500.0, m=3, seed=SEED, **cfg),
                   device="cpu")
    db.register_table("s", tbl)
    state.install_families(db, "s", _units())
    return db


@pytest.fixture(scope="module")
def tables():
    return _tables()


def test_make_batched_query_fn_matches_reference_and_single(tables):
    ref_tbl, port_tbl = tables
    port = _port_db(port_tbl)
    r_striped = ref_exec.stripe_family(
        ref_samp.build_family(ref_tbl, ("City",), 500.0, m=3, seed=SEED), 1)
    p_striped = port._striped_for("s", ("City",))
    n_groups = port_tbl.cardinality("OS")
    ks = [500.0, 250.0, 125.0]
    consts = [[0.0], [1.0], [2.0]]
    r_fn = ref_exec.make_batched_query_fn(
        ((("City", R.CmpOp.EQ),),), "SessionTime", "OS", n_groups)
    want = r_fn(jnp.asarray(ks, jnp.float32), jnp.asarray(consts, jnp.float32),
                *ref_exec.scan_args(r_striped))
    struct = ((("City", CmpOp.EQ),),)
    b_fn = exec_lib.make_batched_query_fn(struct, "SessionTime", "OS",
                                          n_groups)
    s_fn = exec_lib.make_query_fn(struct, "SessionTime", "OS", n_groups)
    args = exec_lib.scan_args(p_striped)
    got = b_fn(torch.tensor(ks), torch.tensor(consts), *args)
    np.testing.assert_allclose(
        got.stacked().numpy(),
        np.stack([np.asarray(x) for x in jax.tree.leaves(want)], axis=1),
        rtol=1e-5, atol=1e-3)
    for i in range(3):
        one = s_fn(ks[i], ((consts[i][0],),), *args)
        assert torch.equal(one.stacked(),
                           exec_lib.est_lib.moments_slice(got, i).stacked())


# ---------------------------------------------------------- query_batch

def _assert_answers_match(a, b):
    """tests/test_batched.py's tolerances, plus the same keys and K."""
    assert a.sample_phi == b.sample_phi
    assert a.sample_k == b.sample_k
    ka = {g.key: g for g in a.groups}
    kb = {g.key: g for g in b.groups}
    assert ka.keys() == kb.keys()
    for key in ka:
        np.testing.assert_allclose(kb[key].estimate, ka[key].estimate,
                                   rtol=1e-5)
        np.testing.assert_allclose(kb[key].stderr, ka[key].stderr,
                                   rtol=1e-4, atol=1e-9)


def _assert_bit_identical(a, b):
    assert (a.sample_phi, a.sample_k, a.rows_read, a.bound_met, a.certified,
            a.predicted_half_width) == \
        (b.sample_phi, b.sample_k, b.rows_read, b.bound_met, b.certified,
         b.predicted_half_width)
    assert [(g.key, g.estimate, g.stderr, g.ci_low, g.ci_high, g.n_selected,
             g.exact) for g in a.groups] == \
        [(g.key, g.estimate, g.stderr, g.ci_low, g.ci_high, g.n_selected,
          g.exact) for g in b.groups]


def _mixed(m, cities):
    return (
        [m.Query("s", m.AggOp.COUNT,
                 predicate=m.Predicate.where(m.Atom("City", m.CmpOp.EQ, c)),
                 bound=m.ErrorBound(0.1)) for c in cities[:4]]
        + [m.Query("s", m.AggOp.AVG, value_column="SessionTime",
                   group_by=("OS",), bound=m.ErrorBound(0.1)),
           m.Query("s", m.AggOp.SUM, value_column="Bitrate",
                   predicate=m.Predicate.where(m.Atom("OS", m.CmpOp.EQ,
                                                      "os1"))),
           m.Query("s", m.AggOp.QUANTILE, value_column="SessionTime",
                   quantile=0.5,
                   predicate=m.Predicate.where(m.Atom("City", m.CmpOp.EQ,
                                                      cities[0]))),
           m.Query("s", m.AggOp.QUANTILE, value_column="SessionTime",
                   quantile=0.9, group_by=("OS",), bound=m.ErrorBound(0.1)),
           m.Query("s", m.AggOp.COUNT, predicate=m.Predicate((
               m.Conjunction((m.Atom("City", m.CmpOp.EQ, cities[0]),)),
               m.Conjunction((m.Atom("City", m.CmpOp.EQ, cities[1]),)))),
               bound=m.ErrorBound(0.2)),
           m.Query("s", m.AggOp.AVG, value_column="Bitrate",
                   group_by=("City",), bound=m.ErrorBound(0.005)),
           ])


def test_query_batch_matches_reference(tables):
    """A mixed batch (a template shared by four queries, QUANTILE with and
    without a bound, a disjunction, an exact-fallback job) against the
    reference's query_batch."""
    ref_tbl, port_tbl = tables
    cities = list(port_tbl.dictionaries["City"])
    want = _ref_db(ref_tbl, use_pallas=True).query_batch(_mixed(R, cities))
    got = _port_db(port_tbl).query_batch(_mixed(P, cities))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        _assert_answers_match(a, b)
    assert got[-1].sample_phi == ("<exact>",) and got[-1].bound_met


def test_query_batch_over_64_jobs_matches_reference_and_query(tables):
    """70 jobs of one template run as launches of 64 and 6; each answer
    matches the reference and query() on the same engine bit for bit."""
    ref_tbl, port_tbl = tables
    cities = list(port_tbl.dictionaries["City"])[:70]
    assert len(cities) == 70

    def batch(m):
        return [m.Query("s", m.AggOp.SUM, value_column="SessionTime",
                        predicate=m.Predicate.where(
                            m.Atom("City", m.CmpOp.EQ, c)),
                        bound=m.ErrorBound(0.2)) for c in cities]
    want = _ref_db(ref_tbl, use_pallas=False).query_batch(batch(R))
    port = _port_db(port_tbl)
    launch_sizes = []
    run = port._run_batched

    def counting(scan_key, ks, consts):
        launch_sizes.append(len(ks))
        return run(scan_key, ks, consts)
    port._run_batched = counting
    got = port.query_batch(batch(P))
    assert max(launch_sizes) == 70 and 64 in launch_sizes
    for a, b in zip(want, got):
        _assert_answers_match(a, b)
    for q, b in zip(batch(P), got):
        _assert_bit_identical(b, port.query(q))


def test_query_batch_equals_query_bitwise(tables):
    """Send a batch to a fresh engine, then the same queries through
    query() on that engine: every answer is bit-identical (ROADMAP: the
    port promises the reference's coalesced == query() identity)."""
    _, port_tbl = tables
    cities = list(port_tbl.dictionaries["City"])
    qs = _mixed(P, cities) + [
        P.Query("s", P.AggOp.QUANTILE, value_column="Bitrate", quantile=0.9,
                group_by=("OS",), bound=P.TimeBound(0.0003))]
    port = _port_db(port_tbl)
    port._latency[("s", ("OS",))] = elp.LatencyModel(2e-8, 1e-4)
    batched = port.query_batch(qs)
    for q, b in zip(qs, batched):
        _assert_bit_identical(b, port.query(q))


def test_query_batch_headroom_tightens_time_bounds(tables):
    ref_tbl, port_tbl = tables
    qs = [m.Query("s", m.AggOp.AVG, value_column="Bitrate", group_by=("OS",),
                  bound=m.TimeBound(0.0003)) for m in (R, P)]
    ref_db = _ref_db(ref_tbl, use_pallas=False)
    port = _port_db(port_tbl)
    ref_db._latency[("s", ("OS",))] = ref_elp.LatencyModel(1e-7, 1e-4)
    port._latency[("s", ("OS",))] = elp.LatencyModel(1e-7, 1e-4)
    for headroom in (0.0, 0.0001):
        [a] = ref_db.query_batch([qs[0]], deadline_headroom_s=headroom)
        [b] = port.query_batch([qs[1]], deadline_headroom_s=headroom)
        _assert_answers_match(a, b)
    k_full = port.query_batch([qs[1]])[0].sample_k
    assert port.query_batch([qs[1]], deadline_headroom_s=0.0001
                            )[0].sample_k < k_full


def test_query_batch_empty_and_single(tables):
    _, port_tbl = tables
    port = _port_db(port_tbl)
    assert port.query_batch([]) == []
    q = P.Query("s", P.AggOp.COUNT, bound=P.ErrorBound(0.2))
    [got] = port.query_batch([q])
    _assert_bit_identical(got, _port_db(port_tbl).query(q))


def test_query_batch_strict_bound_raises(tables):
    _, port_tbl = tables
    port = _port_db(port_tbl, exact_fallback=False)
    q = P.Query("s", P.AggOp.AVG, value_column="SessionTime",
                group_by=("City",), bound=P.ErrorBound(0.002, strict=True))
    with pytest.raises(P.BoundUnreachableError):
        port.query_batch([q])


def test_max_scan_batch_is_the_kernel_limit():
    assert engine_lib._MAX_SCAN_BATCH == agg_scan.MAX_QUERIES == 64
