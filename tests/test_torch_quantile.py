"""Port parity: the one-pass QUANTILE scan and QUANTILE queries.

On the CPU the port's `quantile_scan` runs its plain PyTorch version; it is
held against the reference's Pallas kernel in interpret mode at the
reference's kernel tolerance (rtol 2e-5, atol 1e-3) over the axes of
chip_smoke.py's sweep. The port has one QUANTILE semantics, the kernel's:
the histogram spans the family-global [lo, hi], so end-to-end answers are
held against the reference engine with use_pallas=True. `hist_to_quantile`
rounds as the reference's compiled program does and is held to it bit for
bit. The CUDA kernel runs only on the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import executor as ref_exec
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.core.estimators import GroupedMoments as RefMoments
from repro.core.estimators import estimate as ref_estimate
from repro.core.types import CmpOp as JaxCmpOp
from repro.data import synth as ref_synth
from repro.kernels.agg_scan import quantile_scan_pallas
import repro_torch.core as P
from repro_torch import state
from repro_torch.core import estimators as est_lib
from repro_torch.core import executor as exec_lib
from repro_torch.core import table as table_lib
from repro_torch.core.types import AggOp, CmpOp
from repro_torch.data import synth
from repro_torch.kernels import agg_scan, ops, ref

RTOL, ATOL = 2e-5, 1e-3
N_ROWS, SEED = 50_000, 0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(rng, n, n_groups, n_cols, n_strata=37, strat_dtype=np.int8,
          atom_dtype=np.int8, ghost_frac=0.1, pad_rows=0, n_atoms=None):
    n_atoms = n_cols if n_atoms is None else n_atoms
    unit = rng.random(n).astype(np.float32)
    if pad_rows:
        unit[-pad_rows:] = np.inf
    values = rng.normal(5, 2, n).astype(np.float32)
    return dict(
        values=values, unit=unit,
        strat=rng.integers(0, n_strata, n).astype(strat_dtype),
        freq_table=rng.integers(1, 500, n_strata).astype(np.float32),
        valid=rng.random(n) >= ghost_frac,
        atom_cols=tuple(rng.integers(0, 8, n).astype(atom_dtype)
                        for _ in range(n_cols)),
        group_codes=rng.integers(0, n_groups, n).astype(
            np.int16 if n_groups > 127 else np.int8),
        k=rng.uniform(20, 400, 1).astype(np.float32),
        lo=float(values.min()), hi=float(values.max()),
        pred_consts=rng.integers(0, 8, (1, n_atoms)).astype(np.float32))


def _torch(c):
    return {k: (tuple(torch.from_numpy(a) for a in v) if k == "atom_cols"
                else v if k in ("lo", "hi") else torch.from_numpy(v))
            for k, v in c.items()}


def _port(c, ops_struct, atom_slots, n_groups):
    t = _torch(c)
    mom, hist = ops.quantile_scan(
        t["values"], t["unit"], t["strat"], t["freq_table"], t["valid"],
        t["atom_cols"], t["group_codes"], t["k"], t["lo"], t["hi"],
        t["pred_consts"], ops_struct, atom_slots, n_groups)
    return mom.stacked().numpy(), hist.numpy()


def _pallas(c, ops_struct, atom_slots, n_groups):
    ops_struct = tuple(tuple(JaxCmpOp[op.name] for op in conj)
                       for conj in ops_struct)
    mom, hist = quantile_scan_pallas(
        jnp.asarray(c["values"]), jnp.asarray(c["unit"]),
        jnp.asarray(c["strat"]), jnp.asarray(c["freq_table"]),
        jnp.asarray(c["valid"]),
        tuple(jnp.asarray(a) for a in c["atom_cols"]),
        jnp.asarray(c["group_codes"]), jnp.float32(c["k"][0]),
        jnp.float32(c["lo"]), jnp.float32(c["hi"]),
        jnp.asarray(c["pred_consts"][0]), ops_struct=ops_struct,
        atom_slots=atom_slots, n_groups=n_groups, interpret=True)
    return np.asarray(mom), np.asarray(hist).T


# ------------------------------------------------ plain version vs reference

_EQ_GT = ((CmpOp.EQ,), (CmpOp.GT,))


@pytest.mark.parametrize("label, n, g, n_cols, struct, slots, kw", [
    ("G=1 dnf2 dup col", 3000, 1, 1, _EQ_GT, (0, 0), {}),
    ("G=6 dnf2 dup col", 3000, 6, 1, _EQ_GT, (0, 0), {}),
    ("G=500 dnf2 dup col", 3000, 500, 1, _EQ_GT, (0, 0), {}),
    ("1 stratum", 2500, 6, 2, ((CmpOp.LE, CmpOp.NE),), (0, 1),
     dict(n_strata=1)),
    ("300 strata int16", 2500, 6, 2, ((CmpOp.LE, CmpOp.NE),), (0, 1),
     dict(n_strata=300, strat_dtype=np.int16)),
    ("4096 strata int32", 2500, 6, 2, ((CmpOp.LE, CmpOp.NE),), (0, 1),
     dict(n_strata=4096, strat_dtype=np.int32)),
    ("atoms int16", 2000, 12, 1, ((CmpOp.GE, CmpOp.LT),), (0, 0),
     dict(atom_dtype=np.int16)),
    ("atoms int32", 2000, 12, 1, ((CmpOp.GE, CmpOp.LT),), (0, 0),
     dict(atom_dtype=np.int32)),
    ("atoms float32", 2000, 12, 1, ((CmpOp.GE, CmpOp.LT),), (0, 0),
     dict(atom_dtype=np.float32)),
    ("0 atoms", 2000, 4, 0, (), (), {}),
    ("1 atom, ghosts and pads", 3000, 8, 1, ((CmpOp.GT,),), (0,),
     dict(ghost_frac=0.35, pad_rows=200)),
])
def test_quantile_ref_matches_pallas(label, n, g, n_cols, struct, slots, kw):
    rng = np.random.default_rng(len(label) * 31 + n + g)
    c = _case(rng, n, g, n_cols, n_atoms=len(slots), **kw)
    mom, hist = _port(c, struct, slots, g)
    want_mom, want_hist = _pallas(c, struct, slots, g)
    assert hist.shape == (g, 256)
    np.testing.assert_allclose(mom, want_mom, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hist, want_hist, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("g", [1, 6, 500])
def test_quantile_moment_half_equals_fused_ref_bitwise(g):
    rng = np.random.default_rng(40 + g)
    c = _case(rng, 4000, g, 2, ghost_frac=0.2, pad_rows=100)
    t = _torch(c)
    struct, slots = ((CmpOp.LE,), (CmpOp.NE, CmpOp.GE)), (0, 1, 1)
    t["pred_consts"] = torch.tensor([[3.0, 2.0, 1.0]])
    mom, _ = ref.quantile_scan_ref(
        t["values"], t["unit"], t["strat"], t["freq_table"], t["valid"],
        t["atom_cols"], t["group_codes"], t["k"], t["lo"], t["hi"],
        t["pred_consts"], struct, slots, g)
    fused = ref.agg_scan_fused_ref(
        t["values"], t["unit"], t["strat"], t["freq_table"], t["valid"],
        t["atom_cols"], t["group_codes"], t["k"], t["pred_consts"], struct,
        slots, g)
    assert torch.equal(mom, fused[0])


def test_quantile_histogram_holds_the_selected_mass():
    """Nothing is lost to clipping: each group's histogram sums to its Σw,
    also when [lo, hi] is narrower than the data."""
    rng = np.random.default_rng(52)
    c = _case(rng, 5000, 5, 1)
    c["lo"], c["hi"] = 4.0, 6.0
    mom, hist = _port(c, ((CmpOp.LT,),), (0,), 5)
    np.testing.assert_allclose(hist.sum(axis=1), mom[1], rtol=RTOL)
    assert hist[:, 0].sum() > 0 and hist[:, -1].sum() > 0


def test_quantile_float64_accumulation_agrees():
    rng = np.random.default_rng(53)
    c = _case(rng, 5000, 7, 1)
    t = _torch(c)
    args = (t["values"], t["unit"], t["strat"], t["freq_table"], t["valid"],
            t["atom_cols"], t["group_codes"], t["k"], t["lo"], t["hi"],
            t["pred_consts"], ((CmpOp.NE,),), (0,), 7)
    a = ref.quantile_scan_ref(*args)
    b = ref.quantile_scan_ref(*args, accumulate=torch.float64)
    for x, y in zip(a, b):
        assert y.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("field, value, match", [
    ("hi", float("inf"), "finite"), ("lo", float("nan"), "finite"),
    ("k", torch.tensor([1.0, 2.0]), "k has shape")])
def test_quantile_check_rejects(field, value, match):
    rng = np.random.default_rng(54)
    t = _torch(_case(rng, 300, 3, 1))
    t[field] = value
    with pytest.raises(ValueError, match=match):
        ops.quantile_scan(t["values"], t["unit"], t["strat"],
                          t["freq_table"], t["valid"], t["atom_cols"],
                          t["group_codes"], t["k"], t["lo"], t["hi"],
                          t["pred_consts"], ((CmpOp.EQ,),), (0,), 3)


def test_quantile_cuda_wrapper_refuses_cpu_tensors():
    t = _torch(_case(np.random.default_rng(55), 300, 3, 1))
    before = agg_scan.quantile_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        agg_scan.quantile_scan_cuda(
            t["values"], t["unit"], t["strat"], t["freq_table"], t["valid"],
            t["atom_cols"], t["group_codes"], t["k"], t["lo"], t["hi"],
            t["pred_consts"], ((CmpOp.EQ,),), (0,), 3)
    assert agg_scan.quantile_scan_cuda.launches == before


def test_make_quantile_fn_refuses_128_atoms():
    """The quantile kernel refuses a 128-atom template; make_quantile_fn
    never hands it one, and answers it: from 126 atoms on it scans the
    torch-evaluated selection as a single atom column (the reference's
    wide path). This checks the refusal and that the answer has its
    shapes; tests/test_torch_wide_templates.py holds the wide answers
    against the reference."""
    rng = np.random.default_rng(12)
    c = _case(rng, 3000, 3, 1)
    t = _torch(c)
    with pytest.raises(ValueError, match="atoms"):
        ops.quantile_scan(t["values"], t["unit"], t["strat"],
                          t["freq_table"], t["valid"], t["atom_cols"] * 128,
                          t["group_codes"], t["k"], t["lo"], t["hi"],
                          torch.zeros(1, 128), ((CmpOp.GE,) * 128,),
                          tuple(range(128)), 3)
    cols = {"v": t["values"], "g": t["group_codes"], "a": t["atom_cols"][0]}
    struct = ((("a", CmpOp.GE),) * 128,)
    fn = exec_lib.make_quantile_fn(struct, "v", "g", 3)
    mom, qv, dens = fn(200.0, ((0.0,) * 128,), 0.5, t["lo"], t["hi"], cols,
                       t["unit"], t["strat"], t["freq_table"], t["valid"])
    assert mom.n.shape == qv.shape == dens.shape == (3,)
    assert float(mom.n.sum()) > 0 and torch.isfinite(qv).all()


# ------------------------------------------------------ hist_to_quantile

_ref_hist_to_quantile = jax.jit(ref_exec.hist_to_quantile)


def _random_hists(rng, g):
    hist = (rng.random((g, 256)) ** 3 * rng.integers(0, 2, (g, 256))
            * rng.uniform(1.0, 1e4)).astype(np.float32)
    hist[0] = 0.0                      # an empty group
    hist[-1] = 0.0
    hist[-1, rng.integers(256)] = 7.0  # all mass in one bin
    return hist


def _hist_case(seed, g):
    rng = np.random.default_rng(seed * 1000 + g)
    hist = _random_hists(rng, g)
    lo = np.float32(rng.normal(0, 100))
    hi = np.float32(lo + abs(rng.normal(0, 1000)))
    for q in (0.5, 0.9, 0.99, 0.1):
        want = _ref_hist_to_quantile(jnp.asarray(hist), jnp.float32(lo),
                                     jnp.float32(hi), jnp.float32(q))
        got = exec_lib.hist_to_quantile(torch.from_numpy(hist), float(lo),
                                        float(hi), q)
        # one rounding of a product of the range's magnitude
        ulp = np.spacing(np.float32(max(abs(lo), abs(hi), hi - lo)))
        yield (got[0].numpy(), got[1].numpy(), np.asarray(want[0]),
               np.asarray(want[1]), ulp)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("g", [16, 64, 128])
def test_hist_to_quantile_bit_identical(seed, g):
    """The reference's query path runs hist_to_quantile compiled: XLA sums
    the CDF in 16 blocks of 16 bins and, in its vectorised loop over
    groups, fuses the two interpolations into multiply-adds. The port does
    both: the same histogram gives the same quantile and density bits."""
    for qv, dens, want_qv, want_dens, _ in _hist_case(seed, g):
        np.testing.assert_array_equal(qv, want_qv)
        np.testing.assert_array_equal(dens, want_dens)


@pytest.mark.parametrize("g", [1, 6, 97, 500])
def test_hist_to_quantile_within_two_ulps_at_any_group_count(g):
    """XLA's CPU code runs the groups that fall outside its vector loop
    (the remainder of each parallel task) without fused multiply-adds, so
    there the reference's own quantile moves with the group count and the
    machine, by the rounding of the two products: at most two float32 ulps
    of the histogram range's magnitude. Densities stay bit-identical."""
    for seed in range(3):
        for qv, dens, want_qv, want_dens, ulp in _hist_case(seed, g):
            np.testing.assert_array_equal(dens, want_dens)
            assert (np.abs(qv - want_qv) <= 2 * ulp).all()


def test_hist_to_quantile_empty_guard():
    qv, dens = exec_lib.hist_to_quantile(torch.zeros(3, 256), 0.0, 1.0, 0.5)
    assert (qv == 0).all() and (dens == 0).all()


def test_hist_to_quantile_needs_256_bins():
    with pytest.raises(ValueError, match="256"):
        exec_lib.hist_to_quantile(torch.ones(2, 128), 0.0, 1.0, 0.5)


# ------------------------------------------------------ grouped_quantile

def test_grouped_quantile_empty_selection_is_defined():
    v = torch.linspace(0, 10, 64)
    w = torch.zeros(64)
    g = torch.arange(64) % 4
    qv, dens = exec_lib.grouped_quantile(v, w, g, 4, 0.5)
    assert (qv == 0).all() and (dens == 0).all()
    assert torch.isfinite(qv).all()


def test_grouped_quantile_one_empty_group():
    rng = np.random.default_rng(60)
    v = rng.normal(5, 2, 512).astype(np.float32)
    g = (np.arange(512) % 3).astype(np.int32)
    w = (g != 1).astype(np.float32)
    qv, dens = exec_lib.grouped_quantile(torch.from_numpy(v),
                                         torch.from_numpy(w),
                                         torch.from_numpy(g), 3, 0.5)
    assert qv[1] == 0.0 and dens[1] == 0.0
    for gi in (0, 2):
        sel = np.sort(v[g == gi])
        assert abs(qv[gi].item() - np.median(sel)) < (sel.max() - sel.min()) / 16


@pytest.mark.parametrize("accumulate", [torch.float32, torch.float64])
def test_grouped_quantile_matches_reference(accumulate):
    """The data-range semantics of the reference's grouped_quantile. The
    reference evaluates it op by op (no fused multiply-adds), the port as
    the compiled program rounds: the two agree to an ulp."""
    rng = np.random.default_rng(61)
    v = rng.gamma(2.0, 10.0, 6000).astype(np.float32)
    g = rng.integers(0, 9, 6000).astype(np.int32)
    w = (rng.random(6000) < 0.7).astype(np.float32)
    want = ref_exec.grouped_quantile(jnp.asarray(v), jnp.asarray(w),
                                     jnp.asarray(g), 9, 0.9)
    got = exec_lib.grouped_quantile(torch.from_numpy(v), torch.from_numpy(w),
                                    torch.from_numpy(g), 9, 0.9,
                                    accumulate=accumulate)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ------------------------------------------------------------- estimator

def test_quantile_estimate_matches_reference():
    rng = np.random.default_rng(62)
    leaves = [rng.uniform(0, 100, 9).astype(np.float32) for _ in range(7)]
    leaves[4][2] = 0.0
    qv = rng.normal(50, 9, 9).astype(np.float32)
    dens = rng.uniform(0, 0.1, 9).astype(np.float32)
    dens[3] = 0.0
    for q in (0.5, 0.9, 0.99):
        want = ref_estimate(R.AggOp.QUANTILE,
                            RefMoments(*map(jnp.asarray, leaves)),
                            quantile_value=jnp.asarray(qv),
                            quantile_density=jnp.asarray(dens), q=q)
        got = est_lib.estimate(AggOp.QUANTILE,
                               est_lib.GroupedMoments(*map(torch.from_numpy,
                                                           leaves)),
                               quantile_value=torch.from_numpy(qv),
                               quantile_density=torch.from_numpy(dens), q=q)
        for f in ("value", "variance", "n"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)
    with pytest.raises(ValueError, match="quantile_value"):
        est_lib.estimate(AggOp.QUANTILE, est_lib.GroupedMoments(
            *map(torch.from_numpy, leaves)))


# ---------------------------------------------------- executor + engine

def _engines():
    ref_db = R.BlinkDB(R.EngineConfig(k1=800.0, m=3, seed=SEED,
                                      use_pallas=True))
    ref_db.register_table("sessions", ref_table.from_columns(
        "sessions", ref_synth.sessions_table(N_ROWS, seed=3)))
    ref_db.add_family("sessions", ("OS",))
    ref_db.add_family("sessions", ())
    port = P.BlinkDB(P.EngineConfig(k1=800.0, m=3, seed=SEED), device="cpu")
    port.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(N_ROWS, seed=3)))
    state.install_families(port, "sessions", {
        ("OS",): ref_samp.base_units(N_ROWS, SEED),
        (): ref_samp.base_units(N_ROWS, SEED, uniform=True)})
    return ref_db, port


@pytest.fixture(scope="module")
def engines():
    return _engines()


def test_make_quantile_fn_matches_reference_kernel_path(engines):
    ref_db, port = engines
    phi = ("OS",)
    r_striped = ref_db._striped_for("sessions", phi)
    p_striped = port._striped_for("sessions", phi)
    genre = port.tables["sessions"].encode_value("Genre", "genre03")
    lo, hi = port._family_range("sessions", phi, "SessionTime")
    assert (lo, hi) == ref_db._family_range("sessions", phi, "SessionTime")
    for struct_p, struct_r, vals in [
            ((), (), ()),
            (((("Genre", CmpOp.EQ),),), ((("Genre", JaxCmpOp.EQ),),),
             ((float(genre),),))]:
        n_groups = port._column_card("sessions", "OS")
        rfn = ref_exec.make_quantile_fn(struct_r, "SessionTime", "OS",
                                        n_groups, use_pallas=True)
        pfn = exec_lib.make_quantile_fn(struct_p, "SessionTime", "OS",
                                        n_groups)
        for k, level in ((200.0, 0.5), (800.0, 0.9)):
            rm, rq, rd = rfn(jnp.float32(k), vals, jnp.float32(level),
                             jnp.float32(lo), jnp.float32(hi),
                             *ref_exec.scan_args(r_striped))
            pm, pq, pd = pfn(k, vals, level, lo, hi,
                             *exec_lib.scan_args(p_striped))
            want = np.stack([np.asarray(x) for x in jax.tree.leaves(rm)])
            np.testing.assert_allclose(pm.stacked().numpy(), want,
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(pq.numpy(), np.asarray(rq), rtol=1e-4)
            np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-4)


def _query(m, name):
    genre = m.Predicate.where(m.Atom("Genre", m.CmpOp.EQ, "genre03"))
    return {
        "median": m.Query("sessions", m.AggOp.QUANTILE, "SessionTime",
                          quantile=0.5, bound=m.ErrorBound(0.1)),
        "p90_by_os": m.Query("sessions", m.AggOp.QUANTILE, "SessionTime",
                             quantile=0.9, group_by=("OS",),
                             bound=m.ErrorBound(0.05)),
        "median_bitrate_pred_by_os": m.Query(
            "sessions", m.AggOp.QUANTILE, "Bitrate", quantile=0.5,
            predicate=genre, group_by=("OS",), bound=m.ErrorBound(0.1)),
        "p99_pred_unbounded": m.Query("sessions", m.AggOp.QUANTILE,
                                      "SessionTime", quantile=0.99,
                                      predicate=genre),
        "exact_fallback": m.Query("sessions", m.AggOp.QUANTILE,
                                  "SessionTime", quantile=0.5,
                                  group_by=("City",),
                                  bound=m.ErrorBound(0.01)),
    }[name]


def _assert_same_answer(a, b):
    """Same family, K, rows and keys; values at rtol 1e-4. A quantile that
    moved by one bin would show here as a relative error near 1/256 of the
    range and fail: it is reported, not re-seeded away."""
    assert (b.sample_phi, b.sample_k, b.rows_read) == \
        (a.sample_phi, a.sample_k, a.rows_read)
    assert (b.bound_met, b.certified) == (a.bound_met, a.certified)
    assert [g.key for g in b.groups] == [g.key for g in a.groups]
    for ga, gb in zip(a.groups, b.groups):
        assert gb.exact == ga.exact and gb.n_selected == ga.n_selected
        for f in ("estimate", "ci_low", "ci_high", "stderr"):
            np.testing.assert_allclose(getattr(gb, f), getattr(ga, f),
                                       rtol=1e-4, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("name", ["median", "p90_by_os",
                                  "median_bitrate_pred_by_os",
                                  "p99_pred_unbounded", "exact_fallback"])
def test_quantile_query_matches_reference(engines, name):
    ref_db, port = engines
    a = ref_db.query(_query(R, name))
    b = port.query(_query(P, name))
    _assert_same_answer(a, b)
    if name == "exact_fallback":
        assert b.sample_phi == ("<exact>",) and b.bound_met


@pytest.mark.parametrize("name", ["p90_by_os", "median_bitrate_pred_by_os"])
def test_quantile_exact_query_matches_reference(engines, name):
    ref_db, port = engines
    _assert_same_answer(ref_db.exact_query(_query(R, name)),
                        port.exact_query(_query(P, name)))


def test_quantile_time_bound_with_injected_latency_model(engines):
    from repro.core import elp as ref_elp
    from repro_torch.core import elp
    ref_db, port = engines
    qs = [m.Query("sessions", m.AggOp.QUANTILE, "Bitrate", quantile=0.9,
                  group_by=("OS",), bound=m.TimeBound(0.0003)) for m in (R, P)]
    ref_db._latency[("sessions", ("OS",))] = ref_elp.LatencyModel(2e-8, 1e-4)
    port._latency[("sessions", ("OS",))] = elp.LatencyModel(2e-8, 1e-4)
    _assert_same_answer(ref_db.query(qs[0]), port.query(qs[1]))


def test_family_range_is_dropped_with_the_family(engines):
    _, port = engines
    port._family_range("sessions", ("OS",), "SessionTime")
    assert ("sessions", ("OS",), "SessionTime") in port._quantile_ranges
    port._drop_derived("sessions", ("OS",))
    assert ("sessions", ("OS",), "SessionTime") not in port._quantile_ranges


# ------------------------------------------ the port's QUANTILE sample floor

def test_quantile_sample_suffices_floor():
    """n_eff · min(q, 1 - q) ≥ 10 effective rows on the thin side, or the
    sample holds the group whole (every rate 1)."""
    def mom(n, wsum, w2sum):
        t = torch.tensor
        return est_lib.GroupedMoments(t([n]), t([wsum]), t([0.0]), t([0.0]),
                                      t([w2sum - wsum]), t([0.0]), t([0.0]))
    whole = mom(5.0, 5.0, 5.0)                 # 5 rows, every weight 1
    assert est_lib.quantile_sample_suffices(whole, 0.99)
    heavy = mom(136.0, 2e6, 8e11)              # n_eff = 5
    assert not est_lib.quantile_sample_suffices(heavy, 0.5)
    ten_each_side = mom(400.0, 4e3, 8e5)       # n_eff = 20
    assert est_lib.quantile_sample_suffices(ten_each_side, 0.5)
    assert not est_lib.quantile_sample_suffices(ten_each_side, 0.9)


def test_tail_quantile_floor_refuses_what_the_reference_certifies(engines):
    """A deliberate difference from the reference: it certifies this p99 on
    the OS family at K = 200, where the few effective rows above the
    quantile cannot carry Table 2's CI, and its answer misses the exact
    p99 by more than the 10% bound. The port refuses that K, climbs the
    ladder to the exact fallback, and keeps the bound."""
    ref_db, port = engines
    qs = [m.Query("sessions", m.AggOp.QUANTILE, "SessionTime", quantile=0.99,
                  predicate=m.Predicate.where(
                      m.Atom("Genre", m.CmpOp.EQ, "genre07")),
                  bound=m.ErrorBound(0.1)) for m in (R, P)]
    a, b = ref_db.query(qs[0]), port.query(qs[1])
    assert (a.sample_phi, a.sample_k, a.certified) == (("OS",), 200.0, True)
    assert not port._quantile_floor_met("sessions", qs[1], ("OS",), 200.0)
    exact = port.exact_query(qs[1]).groups[0].estimate
    assert abs(a.groups[0].estimate - exact) > 0.1 * exact
    assert b.sample_phi == ("<exact>",) and b.bound_met
    assert b.groups[0].estimate == exact
