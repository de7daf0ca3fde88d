"""The CUDA kernel on the card, against the port's own plain versions.

These tests need an NVIDIA GPU (the kernel has no CPU mode) and carry the
`cuda` marker; without a card each skips with its reason. This file imports
neither jax nor `repro`, so it also runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (AggOp, Atom, BlinkDB, CmpOp, Conjunction,
                              EngineConfig, ErrorBound, Predicate, Query)
from repro_torch.core import table as table_lib
from repro_torch.data import synth
from repro_torch.kernels import agg_scan, ops, ref

RTOL, ATOL = 2e-5, 1e-3   # the reference's kernel tolerance


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(rng, n, n_groups, q, n_atoms, device):
    unit = rng.random(n).astype(np.float32)
    unit[-500:] = np.inf
    host = dict(values=rng.normal(5, 2, n).astype(np.float32), unit=unit,
                strat=rng.integers(0, 300, n).astype(np.int16),
                freq_table=rng.integers(1, 500, 300).astype(np.float32),
                valid=rng.random(n) >= 0.1,
                group_codes=rng.integers(0, n_groups, n).astype(np.int16),
                ks=rng.uniform(20, 400, q).astype(np.float32),
                pred_consts=rng.integers(0, 8, (q, n_atoms)).astype(np.float32))
    t = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    t["atom_cols"] = (torch.from_numpy(rng.integers(0, 8, n).astype(
        np.int8)).to(device),)
    return t


def _call(fn, t, struct, slots, g, **kw):
    return fn(t["values"], t["unit"], t["strat"], t["freq_table"], t["valid"],
              t["atom_cols"], t["group_codes"], t["ks"], t["pred_consts"],
              struct, slots, g, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("q, n_groups", [
    (1, 1), (7, 6), (64, 500),
    # the register / shared mode edge, and the first kernel's tile edges
    (1, 8), (1, 9), (1, 128), (1, 129), (1, 256), (1, 257), (1, 500),
    # one shared-mode tile holds up to 1024 groups
    (1, 1024), (1, 1025)])
def test_kernel_matches_plain_and_repeats_bitwise(cuda_device, q, n_groups):
    rng = np.random.default_rng(q + n_groups)
    t = _case(rng, 100_003, n_groups, q, 2, cuda_device)
    struct, slots = ((CmpOp.EQ,), (CmpOp.GT,)), (0, 0)
    before = agg_scan.agg_scan_fused_cuda.launches
    got = _call(agg_scan.agg_scan_fused_cuda, t, struct, slots, n_groups)
    again = _call(agg_scan.agg_scan_fused_cuda, t, struct, slots, n_groups)
    assert agg_scan.agg_scan_fused_cuda.launches == before + 2
    want = _call(ref.agg_scan_fused_ref, t, struct, slots, n_groups,
                 accumulate=torch.float64)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_ops_dispatch_launches_on_cuda_tensors(cuda_device):
    rng = np.random.default_rng(5)
    t = _case(rng, 4099, 6, 1, 1, cuda_device)
    before = agg_scan.agg_scan_fused_cuda.launches
    mom = _call(ops.agg_scan_fused, t, ((CmpOp.LE,),), (0,), 6)
    assert agg_scan.agg_scan_fused_cuda.launches == before + 1
    assert mom.n.device.type == "cuda" and mom.n.shape == (1, 6)


@pytest.mark.cuda
def test_engine_on_card_matches_engine_on_cpu(cuda_device):
    dbs = []
    for dev in ("cpu", cuda_device):
        db = BlinkDB(EngineConfig(k1=800.0, m=3), device=dev)
        db.register_table("sessions", table_lib.from_columns(
            "sessions", synth.sessions_table(50_000, seed=3)))
        db.add_family("sessions", ("OS",))
        db.add_family("sessions", ())
        dbs.append(db)
    queries = [
        Query("sessions", AggOp.AVG, "SessionTime", group_by=("OS",),
              bound=ErrorBound(0.1)),
        Query("sessions", AggOp.COUNT, group_by=("OS",),
              predicate=Predicate.where(Atom("Genre", CmpOp.EQ, "genre03")),
              bound=ErrorBound(0.1)),
        Query("sessions", AggOp.SUM, "Bitrate",
              predicate=Predicate.where(Atom("dt", CmpOp.LT, 15)),
              bound=ErrorBound(0.05)),
        Query("sessions", AggOp.COUNT, predicate=Predicate((
            Conjunction((Atom("OS", CmpOp.EQ, "os1"),)),
            Conjunction((Atom("OS", CmpOp.EQ, "os3"),)))),
            bound=ErrorBound(0.1)),
    ]
    for q in queries:
        before = agg_scan.agg_scan_fused_cuda.launches
        b = dbs[1].query(q)
        assert agg_scan.agg_scan_fused_cuda.launches > before
        a = dbs[0].query(q)
        assert (b.sample_phi, b.sample_k, b.rows_read) == \
            (a.sample_phi, a.sample_k, a.rows_read)
        assert [g.key for g in b.groups] == [g.key for g in a.groups]
        for ga, gb in zip(a.groups, b.groups):
            np.testing.assert_allclose([gb.estimate, gb.ci_low, gb.ci_high],
                                       [ga.estimate, ga.ci_low, ga.ci_high],
                                       rtol=1e-4)


@pytest.mark.cuda
def test_engine_on_card_refuses_128_atoms(cuda_device):
    """The fused kernel's wrapper refuses a 128-atom template and counts no
    launch; the engine on the card does not refuse it: it answers through
    agg_scan (the wide path) with no fused launch, and agrees with the
    engine on the CPU."""
    dbs = []
    for dev in ("cpu", cuda_device):
        db = BlinkDB(EngineConfig(k1=800.0, m=3), device=dev)
        db.register_table("sessions", table_lib.from_columns(
            "sessions", synth.sessions_table(20_000, seed=3)))
        db.add_family("sessions", ())
        dbs.append(db)
    q = Query("sessions", AggOp.COUNT, predicate=Predicate.where(
        *[Atom("dt", CmpOp.GE, i % 3) for i in range(128)]))
    before = agg_scan.agg_scan_fused_cuda.launches
    wide = agg_scan.agg_scan_cuda.launches
    b = dbs[1].query(q)
    assert agg_scan.agg_scan_fused_cuda.launches == before
    assert agg_scan.agg_scan_cuda.launches > wide
    a = dbs[0].query(q)
    assert (b.sample_phi, b.sample_k) == (a.sample_phi, a.sample_k)
    np.testing.assert_allclose([g.estimate for g in b.groups],
                               [g.estimate for g in a.groups], rtol=1e-4)
    t = _case(np.random.default_rng(9), 4099, 6, 1, 128, cuda_device)
    with pytest.raises(ValueError, match="atoms"):
        _call(agg_scan.agg_scan_fused_cuda, t, ((CmpOp.GE,) * 128,),
              (0,) * 128, 6)
    assert agg_scan.agg_scan_fused_cuda.launches == before


def _quantile_call(fn, t, struct, slots, g, **kw):
    lo, hi = t["values"].min().item(), t["values"].max().item()
    return fn(t["values"], t["unit"], t["strat"], t["freq_table"], t["valid"],
              t["atom_cols"], t["group_codes"], t["ks"][:1], lo, hi,
              t["pred_consts"][:1], struct, slots, g, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups", [1, 6, 32, 33, 200, 500])
def test_quantile_kernel_matches_plain_and_repeats_bitwise(cuda_device,
                                                           n_groups):
    """Up to 32 groups the histogram rides the moments pass (one read of
    the block); from 33 it takes its own pass; both against the plain
    version, repeat launches bit-identical, the moments equal to the fused
    scan's at Q = 1."""
    rng = np.random.default_rng(30 + n_groups)
    t = _case(rng, 100_003, n_groups, 1, 2, cuda_device)
    struct, slots = ((CmpOp.EQ,), (CmpOp.GT,)), (0, 0)
    before = agg_scan.quantile_scan_cuda.launches
    mom, hist = _quantile_call(agg_scan.quantile_scan_cuda, t, struct, slots,
                               n_groups)
    mom2, hist2 = _quantile_call(agg_scan.quantile_scan_cuda, t, struct,
                                 slots, n_groups)
    assert agg_scan.quantile_scan_cuda.launches == before + 2
    want_mom, want_hist = _quantile_call(ref.quantile_scan_ref, t, struct,
                                         slots, n_groups,
                                         accumulate=torch.float64)
    torch.testing.assert_close(mom, want_mom, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(hist, want_hist, rtol=RTOL, atol=ATOL)
    assert torch.equal(mom, mom2) and torch.equal(hist, hist2)
    # the moment half is the fused scan's at Q = 1, bit for bit
    fused = _call(agg_scan.agg_scan_fused_cuda,
                  dict(t, ks=t["ks"][:1], pred_consts=t["pred_consts"][:1]),
                  struct, slots, n_groups)
    assert torch.equal(mom, fused[0])


@pytest.mark.cuda
@pytest.mark.parametrize("q, n_groups", [(7, 1), (7, 6), (7, 200),
                                         (64, 500)])
def test_batched_query_slices_equal_single_launches(cuda_device, q, n_groups):
    rng = np.random.default_rng(40 + q)
    t = _case(rng, 100_003, n_groups, q, 2, cuda_device)
    struct, slots = ((CmpOp.EQ,), (CmpOp.GT,)), (0, 0)
    batched = _call(agg_scan.agg_scan_fused_cuda, t, struct, slots, n_groups)
    for i in range(q):
        one = _call(agg_scan.agg_scan_fused_cuda,
                    dict(t, ks=t["ks"][i:i + 1],
                         pred_consts=t["pred_consts"][i:i + 1]),
                    struct, slots, n_groups)
        assert torch.equal(batched[i], one[0]), i


@pytest.mark.cuda
def test_engine_quantile_and_batch_on_card(cuda_device):
    dbs = []
    for dev in ("cpu", cuda_device):
        db = BlinkDB(EngineConfig(k1=800.0, m=3), device=dev)
        db.register_table("sessions", table_lib.from_columns(
            "sessions", synth.sessions_table(50_000, seed=3)))
        db.add_family("sessions", ("OS",))
        db.add_family("sessions", ())
        dbs.append(db)
    genre = Predicate.where(Atom("Genre", CmpOp.EQ, "genre03"))
    queries = [
        Query("sessions", AggOp.QUANTILE, "SessionTime", quantile=0.5,
              bound=ErrorBound(0.1)),
        Query("sessions", AggOp.QUANTILE, "SessionTime", quantile=0.9,
              group_by=("OS",), bound=ErrorBound(0.05)),
        Query("sessions", AggOp.QUANTILE, "Bitrate", quantile=0.99,
              predicate=genre, bound=ErrorBound(0.1)),
        Query("sessions", AggOp.AVG, "SessionTime", group_by=("OS",),
              bound=ErrorBound(0.1)),
    ]
    before = agg_scan.quantile_scan_cuda.launches
    batched = dbs[1].query_batch(queries * 3)
    assert agg_scan.quantile_scan_cuda.launches > before
    for q, b in zip(queries * 3, batched):
        one = dbs[1].query(q)
        assert [(g.key, g.estimate, g.ci_low, g.ci_high) for g in b.groups] \
            == [(g.key, g.estimate, g.ci_low, g.ci_high) for g in one.groups]
    for q in queries:
        a, b = dbs[0].query(q), dbs[1].query(q)
        assert (b.sample_phi, b.sample_k) == (a.sample_phi, a.sample_k)
        assert [g.key for g in b.groups] == [g.key for g in a.groups]
        for ga, gb in zip(a.groups, b.groups):
            np.testing.assert_allclose([gb.estimate, gb.ci_low, gb.ci_high],
                                       [ga.estimate, ga.ci_low, ga.ci_high],
                                       rtol=1e-4)


# ------------------------------------------- agg_scan, agg_scan_batched,
# ------------------------------------------- weighted_sum

def _rate_case(rng, n, n_groups, dtype, device):
    """agg_scan inputs: rates from a frequency table, a random mask, and
    codes with a few outside [0, n_groups) that must land in no group."""
    values = (rng.integers(0, 100, n) if dtype == np.int32
              else rng.normal(5, 2, n)).astype(dtype)
    freq = rng.integers(1, 500, n).astype(np.float32)
    codes = rng.integers(-2, n_groups + 2, n).astype(np.int32)
    host = (values, np.minimum(1.0, 100.0 / freq).astype(np.float32),
            rng.random(n) < 0.5, codes)
    return tuple(torch.from_numpy(a).to(device) for a in host)


@pytest.mark.cuda
@pytest.mark.parametrize("n, n_groups, dtype", [
    (1, 1, np.float32), (4099, 6, np.float16), (100_003, 600, np.int32),
    (100_003, 6, np.float32)])
def test_agg_scan_kernel_matches_plain_and_repeats_bitwise(cuda_device, n,
                                                           n_groups, dtype):
    args = _rate_case(np.random.default_rng(n + n_groups), n, n_groups, dtype,
                      cuda_device)
    before = agg_scan.agg_scan_cuda.launches
    got = agg_scan.agg_scan_cuda(*args, n_groups)
    again = agg_scan.agg_scan_cuda(*args, n_groups)
    assert agg_scan.agg_scan_cuda.launches == before + 2
    want = ref.agg_scan_ref(*args, n_groups, accumulate=torch.float64)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups", [1, 6, 500])
def test_agg_scan_equals_quantile_moments_over_a_selection(cuda_device,
                                                           n_groups):
    """The wide QUANTILE path's promise: quantile_scan over a selection
    given as one atom column has the moments of agg_scan over the same
    selection and rates, bit for bit."""
    rng = np.random.default_rng(50 + n_groups)
    t = _case(rng, 100_003, n_groups, 1, 2, cuda_device)
    k = t["ks"][:1]
    freq = t["freq_table"][t["strat"].long()]
    sel = t["valid"] & (t["unit"] * freq < k[0]) & (t["atom_cols"][0] > 3)
    rates = torch.clamp_max(k[0] / freq, 1.0)
    got = agg_scan.agg_scan_cuda(t["values"], rates, sel, t["group_codes"],
                                 n_groups)
    lo, hi = t["values"].min().item(), t["values"].max().item()
    mom, _ = agg_scan.quantile_scan_cuda(
        t["values"], t["unit"], t["strat"], t["freq_table"], t["valid"],
        (sel,), t["group_codes"], k, lo, hi,
        torch.ones((1, 1), device=cuda_device), ((CmpOp.EQ,),), (0,),
        n_groups)
    assert torch.equal(got, mom)


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups", [1, 6])
def test_agg_scan_kernel_absent_values_and_codes(cuda_device, n_groups):
    """values None (COUNT) reads 1 and group_codes None is group 0: the
    kernel's bits equal its bits on explicit ones and zeros."""
    values, rates, mask, codes = _rate_case(np.random.default_rng(80),
                                            100_003, n_groups, np.float32,
                                            cuda_device)
    ones, zeros = torch.ones_like(rates), torch.zeros_like(codes)
    for args, full in (((None, rates, mask, codes), (ones, rates, mask, codes)),
                       ((values, rates, mask, None),
                        (values, rates, mask, zeros)),
                       ((None, rates, mask, None), (ones, rates, mask, zeros))):
        got = agg_scan.agg_scan_cuda(*args, n_groups)
        assert torch.equal(got, agg_scan.agg_scan_cuda(*full, n_groups))
        torch.testing.assert_close(
            got, ref.agg_scan_ref(*args, n_groups, accumulate=torch.float64),
            rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["nowhere", "last row of chunk 0",
                                   "first row past a warp boundary",
                                   "first row of chunk 1", "last row"])
@pytest.mark.parametrize("n_groups", [1, 6])
def test_agg_scan_mask_at_the_edges(cuda_device, n_groups, where):
    """A mask false everywhere gives zeros; a mask true in one row at the
    edge of a chunk or a warp gives that row's float32 terms, bit for bit
    the plain version's (one term a group: no order to differ in)."""
    n = 100_003
    values, rates, _, codes = _rate_case(np.random.default_rng(90), n,
                                         n_groups, np.float32, cuda_device)
    codes = codes.clamp(0, n_groups - 1)
    rows = agg_scan.agg_scan_plan(n, n_groups, agg_scan._n_sms(cuda_device))[0]
    at = {"nowhere": None, "last row of chunk 0": rows - 1,
          "first row past a warp boundary": 32, "first row of chunk 1": rows,
          "last row": n - 1}[where]
    mask = torch.zeros(n, dtype=torch.bool, device=cuda_device)
    if at is not None:
        mask[at] = True
    for vals in (values, None):
        got = agg_scan.agg_scan_cuda(vals, rates, mask, codes, n_groups)
        assert torch.equal(got, ref.agg_scan_ref(vals, rates, mask, codes,
                                                 n_groups))
        assert (got[0].sum().item() == 0) == (at is None)


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups", [1, 6, 8])
def test_agg_scan_small_prefix_equals_quantile_moments(cuda_device, n_groups):
    """Rows in entry-key order and K at 1-5% of them, as the wide path scans
    a block at a small K: most warps hold no selected row and skip their
    divisions. Against the plain version, and bit for bit against the
    quantile kernel's moments over the same selection."""
    rng = np.random.default_rng(95 + n_groups)
    t = _small_k_case(rng, 100_003, n_groups, 1, 2, cuda_device)
    k = t["ks"][:1]
    freq = t["freq_table"][t["strat"].long()]
    sel = t["valid"] & (t["unit"] * freq < k[0]) & (t["atom_cols"][0] > 3)
    rates = torch.clamp_max(k[0] / freq, 1.0)
    got = agg_scan.agg_scan_cuda(t["values"], rates, sel, t["group_codes"],
                                 n_groups)
    want = ref.agg_scan_ref(t["values"], rates, sel, t["group_codes"],
                            n_groups, accumulate=torch.float64)
    assert 0 < want[0].sum().item() < 0.1 * sel.numel()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    lo, hi = t["values"].min().item(), t["values"].max().item()
    mom, _ = agg_scan.quantile_scan_cuda(
        t["values"], t["unit"], t["strat"], t["freq_table"], t["valid"],
        (sel,), t["group_codes"], k, lo, hi,
        torch.ones((1, 1), device=cuda_device), ((CmpOp.EQ,),), (0,),
        n_groups)
    assert torch.equal(got, mom)


@pytest.mark.cuda
def test_agg_scan_calls_in_a_row_and_on_two_streams(cuda_device):
    """Two calls in a row on one stream return two fresh outputs, each with
    its own answer (the calls share the stream's scratch in order); a call
    on a second stream, beside one on the first, takes its own scratch."""
    a = _rate_case(np.random.default_rng(91), 100_003, 6, np.float32,
                   cuda_device)
    b = _rate_case(np.random.default_rng(92), 200_003, 6, np.float32,
                   cuda_device)
    want_a = agg_scan.agg_scan_cuda(*a, 6).clone()
    want_b = agg_scan.agg_scan_cuda(*b, 6).clone()
    got_a = agg_scan.agg_scan_cuda(*a, 6)
    got_b = agg_scan.agg_scan_cuda(*b, 6)
    assert got_a.data_ptr() != got_b.data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = [agg_scan.agg_scan_cuda(*b, 6) for _ in range(4)]
    on_main = [agg_scan.agg_scan_cuda(*a, 6) for _ in range(4)]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(x, want_b) for x in on_side)
    assert all(torch.equal(x, want_a) for x in on_main)


@pytest.mark.cuda
def test_agg_scan_fast_divisions_are_the_shared_pass_bits(cuda_device):
    """The one-launch kernel's branch-free w = 1/r and vfac = (1 - r)/r²
    equal the correctly rounded divisions, bit for bit, for every float
    rate in [2^-60, 1] (the range its warps check before using them)."""
    assert agg_scan.agg_scan_rounding_mismatches(cuda_device) == 0


def _misaligned(t):
    """A copy of t whose data starts one element past a 16-byte boundary."""
    if t is None:
        return None
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()]
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups", range(1, 10))
def test_agg_scan_one_launch_and_shared_pass_agree_bitwise(cuda_device,
                                                           n_groups):
    """Up to 8 groups on 16-byte-aligned columns agg_scan takes its
    one-launch kernel, otherwise the shared pass of scan_common.cuh: the
    same rows give the same bits either way, against the plain version."""
    dtype = np.float16 if n_groups % 3 == 0 else np.float32
    values, rates, mask, codes = _rate_case(
        np.random.default_rng(100 + n_groups), 100_003, n_groups, dtype,
        cuda_device)
    if n_groups % 2:
        codes = codes.to(torch.int8)
    args = (None if n_groups == 2 else values, rates, mask, codes)
    got = agg_scan.agg_scan_cuda(*args, n_groups)
    shifted = agg_scan.agg_scan_cuda(*map(_misaligned, args), n_groups)
    assert torch.equal(got, shifted)
    torch.testing.assert_close(
        got, ref.agg_scan_ref(*args, n_groups, accumulate=torch.float64),
        rtol=RTOL, atol=ATOL)


def _batched_from_fused(t, n_atoms):
    """agg_scan_batched inputs with freq = freq_table[strat] and
    entry_key = where(valid, unit·freq, inf), the atoms as f32 rows."""
    freq = t["freq_table"][t["strat"].long()]
    ek = torch.where(t["valid"], t["unit"] * freq,
                     torch.full_like(freq, float("inf")))
    atoms = torch.stack([t["atom_cols"][0].float()] * n_atoms) if n_atoms \
        else torch.zeros((0, freq.shape[0]), device=freq.device)
    return t["values"], freq, ek, atoms, t["group_codes"]


@pytest.mark.cuda
@pytest.mark.parametrize("q, n_atoms, n_groups", [(1, 0, 1), (7, 1, 6),
                                                  (65, 127, 6), (64, 1, 500)])
def test_batched_kernel_matches_plain_and_fused_bitwise(cuda_device, q,
                                                        n_atoms, n_groups):
    rng = np.random.default_rng(60 + q + n_atoms)
    t = _case(rng, 100_003, n_groups, q, n_atoms, cuda_device)
    struct = ((CmpOp.GE,) * n_atoms,) if n_atoms else ()
    args = (*_batched_from_fused(t, n_atoms), t["ks"], t["pred_consts"],
            struct, n_groups)
    before = agg_scan.agg_scan_batched_cuda.launches
    got = agg_scan.agg_scan_batched_cuda(*args)
    again = agg_scan.agg_scan_batched_cuda(*args)
    assert agg_scan.agg_scan_batched_cuda.launches == \
        before + 2 * -(-q // agg_scan.MAX_QUERIES)
    want = ref.agg_scan_batched_ref(*args, accumulate=torch.float64)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, again)
    fused = torch.cat([
        _call(agg_scan.agg_scan_fused_cuda,
              dict(t, ks=t["ks"][i:i + 64], pred_consts=t["pred_consts"][i:i + 64]),
              struct, (0,) * n_atoms, n_groups)
        for i in range(0, q, 64)])
    assert (got - fused).abs().max().item() == 0.0



def _batched_and_fused(t, struct, n_atoms, n_groups):
    """agg_scan_batched on t's materialized state, and agg_scan_fused on t
    (in launches of 64 queries)."""
    got = agg_scan.agg_scan_batched_cuda(
        *_batched_from_fused(t, n_atoms), t["ks"], t["pred_consts"], struct,
        n_groups)
    q = t["ks"].shape[0]
    fused = torch.cat([
        _call(agg_scan.agg_scan_fused_cuda,
              dict(t, ks=t["ks"][i:i + 64],
                   pred_consts=t["pred_consts"][i:i + 64]),
              struct, (0,) * n_atoms, n_groups)
        for i in range(0, q, 64)])
    return got, fused


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups", [1, 6])
@pytest.mark.parametrize("q", [1, 7, 8, 9, 33, 64])
def test_batched_select_then_add_equals_fused_bitwise(cuda_device, q,
                                                      n_groups):
    """Query counts at and around the powers of two, one atom (the one-atom
    selection) and a two-conjunction template (the general one): equal to
    the fused scan at max |diff| 0.0 and within the plain version's
    tolerance."""
    rng = np.random.default_rng(100 + q + n_groups)
    for struct in (((CmpOp.EQ,),), ((CmpOp.GE, CmpOp.LT), (CmpOp.EQ,))):
        n_atoms = sum(len(c) for c in struct)
        t = _case(rng, 100_003, n_groups, q, n_atoms, cuda_device)
        got, fused = _batched_and_fused(t, struct, n_atoms, n_groups)
        want = ref.agg_scan_batched_ref(
            *_batched_from_fused(t, n_atoms), t["ks"], t["pred_consts"],
            struct, n_groups, accumulate=torch.float64)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        assert (got - fused).abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("q, n_groups", [(9, 1), (33, 6)])
def test_batched_slices_equal_queries_launched_alone(cuda_device, q,
                                                     n_groups):
    rng = np.random.default_rng(110 + q)
    t = _case(rng, 100_003, n_groups, q, 1, cuda_device)
    mat = _batched_from_fused(t, 1)
    struct = ((CmpOp.EQ,),)
    batched = agg_scan.agg_scan_batched_cuda(*mat, t["ks"], t["pred_consts"],
                                             struct, n_groups)
    for i in range(q):
        one = agg_scan.agg_scan_batched_cuda(
            *mat, t["ks"][i:i + 1], t["pred_consts"][i:i + 1], struct,
            n_groups)
        assert torch.equal(batched[i], one[0]), i


@pytest.mark.cuda
def test_batched_repeats_and_calls_in_a_row(cuda_device):
    """Repeat launches are bit-identical; two calls in a row on one stream
    (sharing its scratch in order) return separate outputs, each its own
    answer."""
    rng = np.random.default_rng(120)
    a = _case(rng, 100_003, 6, 33, 1, cuda_device)
    b = _case(rng, 200_003, 6, 64, 1, cuda_device)
    struct = ((CmpOp.EQ,),)

    def run(t):
        return agg_scan.agg_scan_batched_cuda(
            *_batched_from_fused(t, 1), t["ks"], t["pred_consts"], struct, 6)
    want_a, want_b = run(a).clone(), run(b).clone()
    got_a, got_b = run(a), run(b)
    assert got_a.data_ptr() != got_b.data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 1_000_001, 2_049_003, 20_000_003])
def test_batched_unaligned_rows_and_ragged_last_chunk(cuda_device, n):
    """Row counts that are no multiple of 4 (atom rows off 16-byte
    alignment) and whose last chunk is ragged: equal to the fused scan.
    At 20M rows a chunk is 76 rows a thread, three windows of 32."""
    rng = np.random.default_rng(130)
    t = _case(rng, n, 6, 9, 1, cuda_device)
    n_sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    rows, _, _ = agg_scan.agg_scan_plan(n, 6, n_sms)
    assert n % 4 and n % rows
    got, fused = _batched_and_fused(t, ((CmpOp.EQ,),), 1, 6)
    assert got[:, 0].sum().item() > 0
    assert (got - fused).abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups", [1, 6])
def test_batched_queries_selecting_no_row_give_zeros(cuda_device, n_groups):
    """Queries whose constant no row holds, or whose K is below every
    entry key, add nothing: their sums are +0; the others equal the fused
    scan's."""
    rng = np.random.default_rng(140 + n_groups)
    t = _case(rng, 100_003, n_groups, 12, 1, cuda_device)
    t["pred_consts"][::3] = 99.0            # atoms are 0..7
    t["ks"][1::3] = 0.0                     # entry keys are > 0
    got, fused = _batched_and_fused(t, ((CmpOp.EQ,),), 1, n_groups)
    assert (got - fused).abs().max().item() == 0.0
    dead = torch.zeros(12, dtype=torch.bool)
    dead[::3] = dead[1::3] = True
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    assert not torch.signbit(got[dead]).any()
    assert got[~dead][:, 0].sum().item() > 0


def _small_k_case(rng, n, n_groups, q, n_atoms, device):
    """_case with its rows in entry-key order, as a sample block is, and
    each query's K at 1-5% of the rows, so most warps hold no prefix row."""
    t = _case(rng, n, n_groups, q, n_atoms, device)
    ek = torch.where(t["valid"], t["unit"] * t["freq_table"][t["strat"].long()],
                     torch.full_like(t["unit"], float("inf")))
    ek, order = torch.sort(ek, stable=True)
    for k in ("values", "unit", "strat", "valid", "group_codes"):
        t[k] = t[k][order]
    t["atom_cols"] = tuple(c[order] for c in t["atom_cols"])
    at = torch.from_numpy(rng.uniform(0.01, 0.05, q) * n).long().to(device)
    t["ks"] = ek[at]
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups", [1, 6, 200])
def test_kernels_past_a_small_prefix_match_plain(cuda_device, n_groups):
    """Warps with no row in the prefix skip their value and atom loads: a
    100-atom template at a small K through the fused, batched and quantile
    kernels against their plain versions, repeats bit-identical, batched
    equal to fused and the quantile's moments to the fused scan's."""
    rng = np.random.default_rng(80 + n_groups)
    t = _small_k_case(rng, 100_003, n_groups, 3, 100, cuda_device)
    struct, slots = ((CmpOp.GE,) * 100,), (0,) * 100
    got = _call(agg_scan.agg_scan_fused_cuda, t, struct, slots, n_groups)
    again = _call(agg_scan.agg_scan_fused_cuda, t, struct, slots, n_groups)
    want = _call(ref.agg_scan_fused_ref, t, struct, slots, n_groups,
                 accumulate=torch.float64)
    assert want[:, 0].sum().item() > 0            # some rows are selected
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, again)
    batched = agg_scan.agg_scan_batched_cuda(
        *_batched_from_fused(t, 100), t["ks"], t["pred_consts"], struct,
        n_groups)
    assert (batched - got).abs().max().item() == 0.0
    mom, hist = _quantile_call(agg_scan.quantile_scan_cuda, t, struct, slots,
                               n_groups)
    want_mom, want_hist = _quantile_call(ref.quantile_scan_ref, t, struct,
                                         slots, n_groups,
                                         accumulate=torch.float64)
    torch.testing.assert_close(mom, want_mom, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(hist, want_hist, rtol=RTOL, atol=ATOL)
    assert torch.equal(mom, got[0])


@pytest.mark.cuda
def test_batched_kernel_refuses_128_atoms(cuda_device):
    t = _case(np.random.default_rng(70), 4099, 6, 1, 128, cuda_device)
    before = agg_scan.agg_scan_batched_cuda.launches
    with pytest.raises(ValueError, match="atoms"):
        agg_scan.agg_scan_batched_cuda(*_batched_from_fused(t, 128), t["ks"],
                                       t["pred_consts"], ((CmpOp.GE,) * 128,),
                                       6)
    assert agg_scan.agg_scan_batched_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 9999, 1_000_003])
def test_weighted_sum_kernel_matches_plain_and_repeats_bitwise(cuda_device, n):
    from repro_torch.kernels import weighted_sum
    rng = np.random.default_rng(n)
    host = (rng.normal(0, 3, n).astype(np.float32),
            (rng.random(n) + 0.5).astype(np.float32), rng.random(n) < 0.6)
    args = tuple(torch.from_numpy(a).to(cuda_device) for a in host)
    before = weighted_sum.weighted_sum_cuda.launches
    got = torch.stack(weighted_sum.weighted_sum_cuda(*args))
    again = torch.stack(ops.weighted_sum(*args))
    assert weighted_sum.weighted_sum_cuda.launches == before + 2
    want = torch.stack(ref.weighted_sum_ref(*args))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)
    assert torch.equal(got, again)


def _strata_case(rng, n, n_groups, q, n_strata, device):
    """_case with a frequency table of n_strata entries and stratum ids at
    the width the striped layout gives them (int16 up to 32,767, int32
    above), every stratum present."""
    t = _case(rng, n, n_groups, q, 2, device)
    sdt = np.int16 if n_strata <= 32_767 else np.int32
    strat = rng.integers(0, n_strata, n)
    strat[:n_strata] = np.arange(n_strata)
    t["strat"] = torch.from_numpy(strat.astype(sdt)).to(device)
    t["freq_table"] = torch.from_numpy(
        rng.integers(1, 500, n_strata).astype(np.float32)).to(device)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("n_strata", [4096, 4097, 12_000, 70_000])
@pytest.mark.parametrize("n_groups", [1, 6, 200])
def test_kernels_past_4096_strata_match_plain(cuda_device, n_strata,
                                              n_groups):
    """A family of more than 4096 strata (a two-column stratification)
    reads its frequency table through L2 instead of shared memory: the
    fused and quantile kernels against their plain versions, repeats
    bit-identical, the quantile's moments equal to the fused scan's and
    the batched kernel over the materialized freq equal to the fused."""
    rng = np.random.default_rng(n_strata + n_groups)
    t = _strata_case(rng, 100_003, n_groups, 3, n_strata, cuda_device)
    struct, slots = ((CmpOp.EQ,), (CmpOp.GT,)), (0, 0)
    before = agg_scan.agg_scan_fused_cuda.launches
    got = _call(agg_scan.agg_scan_fused_cuda, t, struct, slots, n_groups)
    again = _call(agg_scan.agg_scan_fused_cuda, t, struct, slots, n_groups)
    assert agg_scan.agg_scan_fused_cuda.launches == before + 2
    want = _call(ref.agg_scan_fused_ref, t, struct, slots, n_groups,
                 accumulate=torch.float64)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, again)
    batched = agg_scan.agg_scan_batched_cuda(
        *_batched_from_fused(t, 2), t["ks"], t["pred_consts"], struct,
        n_groups)
    assert (batched - got).abs().max().item() == 0.0
    before = agg_scan.quantile_scan_cuda.launches
    mom, hist = _quantile_call(agg_scan.quantile_scan_cuda, t, struct, slots,
                               n_groups)
    assert agg_scan.quantile_scan_cuda.launches == before + 1
    want_mom, want_hist = _quantile_call(ref.quantile_scan_ref, t, struct,
                                         slots, n_groups,
                                         accumulate=torch.float64)
    torch.testing.assert_close(mom, want_mom, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(hist, want_hist, rtol=RTOL, atol=ATOL)
    fused = _call(agg_scan.agg_scan_fused_cuda,
                  dict(t, ks=t["ks"][:1], pred_consts=t["pred_consts"][:1]),
                  struct, slots, n_groups)
    assert torch.equal(mom, fused[0])


@pytest.mark.cuda
def test_build_samples_on_card_matches_cpu_and_answers_many_strata(
        cuda_device):
    """build_samples on the card chooses and builds what it does on the
    CPU; a forced (City, URL) family of 11,838 strata answers COUNT, AVG
    and QUANTILE through the fused and quantile kernels, within rtol 1e-4
    of the engine on the CPU."""
    from repro_torch.core import QueryTemplate
    templates = [QueryTemplate(frozenset({"City"}), 0.3),
                 QueryTemplate(frozenset({"Genre", "City"}), 0.25),
                 QueryTemplate(frozenset({"OS", "URL"}), 0.25),
                 QueryTemplate(frozenset({"Genre"}), 0.1),
                 QueryTemplate(frozenset({"URL"}), 0.1)]
    dbs, sols = [], []
    for dev in ("cpu", cuda_device):
        db = BlinkDB(EngineConfig(k1=800.0, m=3), device=dev)
        db.register_table("sessions", table_lib.from_columns(
            "sessions", synth.sessions_table(100_000, seed=3)))
        sols.append(db.build_samples("sessions", templates, 0.5))
        db.add_family("sessions", ("City", "URL"))
        dbs.append(db)
    assert sols[0] == sols[1]
    assert sorted(dbs[0].families["sessions"]) == \
        sorted(dbs[1].families["sessions"])
    assert dbs[1].families["sessions"][("City", "URL")].n_distinct > 4096
    both = Predicate.where(Atom("City", CmpOp.EQ, "city001"),
                           Atom("URL", CmpOp.EQ, "url001"))
    queries = [
        Query("sessions", AggOp.COUNT, predicate=both, bound=ErrorBound(0.1)),
        Query("sessions", AggOp.AVG, "Bitrate", predicate=Predicate.where(
            Atom("URL", CmpOp.EQ, "url003"), Atom("City", CmpOp.EQ,
                                                  "city000")),
            bound=ErrorBound(0.05)),
        Query("sessions", AggOp.QUANTILE, "SessionTime", quantile=0.5,
              predicate=both, bound=ErrorBound(0.1))]
    for q in queries:
        fused = agg_scan.agg_scan_fused_cuda.launches
        quant = agg_scan.quantile_scan_cuda.launches
        b = dbs[1].query(q)
        assert b.sample_phi == ("City", "URL")
        launched = (agg_scan.quantile_scan_cuda.launches - quant
                    if q.agg is AggOp.QUANTILE
                    else agg_scan.agg_scan_fused_cuda.launches - fused)
        assert launched > 0
        a = dbs[0].query(q)
        assert (b.sample_phi, b.sample_k, b.rows_read) == \
            (a.sample_phi, a.sample_k, a.rows_read)
        np.testing.assert_allclose([g.estimate for g in b.groups],
                                   [g.estimate for g in a.groups], rtol=1e-4)
