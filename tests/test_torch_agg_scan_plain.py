"""Port parity: agg_scan, agg_scan_batched and weighted_sum, and the
executor's scan_moments / run_query_striped.

On the CPU the port's `kernels.ops` entries run their plain PyTorch
versions; they are held against the reference's Pallas kernels in
interpret mode and its jnp oracles, over the sweeps of tests/test_kernels.py
and tests/test_kernel_fused.py, at the reference's tolerances (rtol 2e-5 /
atol 1e-3; 2e-3 / 1e-2 for float16 and int32 values; weighted_sum 1e-4 /
1e-2). The CUDA kernels run only on the card: tests/test_torch_cuda.py holds
them against these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimators as ref_est
from repro.core import executor as ref_exec
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.core.types import CmpOp as JaxCmpOp
from repro.data import synth as ref_synth
from repro.kernels import ref as jax_ref
from repro.kernels.agg_scan import (agg_scan_batched_pallas,
                                    agg_scan_pallas)
from repro.kernels.weighted_sum import weighted_sum_pallas
import repro_torch.core as P
from repro_torch import state
from repro_torch.core import estimators as est_lib
from repro_torch.core import executor as exec_lib
from repro_torch.core import table as table_lib
from repro_torch.core.types import CmpOp
from repro_torch.data import synth
from repro_torch.kernels import ops

RTOL, ATOL = 2e-5, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rate_case(rng, n, n_groups, dtype=np.float32, code_lo=0, code_hi=None):
    """tests/test_kernels.py's inputs: values, rates = min(1, 100/freq), a
    random mask, group codes (optionally outside [0, n_groups))."""
    values = (rng.integers(0, 100, n) if dtype == np.int32
              else rng.normal(5, 2, n)).astype(dtype)
    freq = rng.integers(1, 500, n).astype(np.float32)
    rates = np.minimum(1.0, 100.0 / freq).astype(np.float32)
    mask = rng.random(n) < 0.4
    hi = n_groups if code_hi is None else code_hi
    codes = rng.integers(code_lo, hi, n).astype(np.int32)
    return values, rates, mask, codes


def _port_agg_scan(case, n_groups):
    return ops.agg_scan(*map(torch.from_numpy, case),
                        n_groups).stacked().numpy()


# ---------------------------------------------------------------- agg_scan

@pytest.mark.parametrize("n", [1, 100, 2048, 5000, 16384])
@pytest.mark.parametrize("n_groups", [1, 3, 128, 600])
def test_agg_scan_matches_pallas_shapes(n, n_groups):
    case = _rate_case(np.random.default_rng(n * 1000 + n_groups), n, n_groups)
    want = agg_scan_pallas(*map(jnp.asarray, case), n_groups, interpret=True)
    np.testing.assert_allclose(_port_agg_scan(case, n_groups),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32])
def test_agg_scan_matches_pallas_dtypes(dtype):
    case = _rate_case(np.random.default_rng(7), 4096, 16, dtype)
    want = agg_scan_pallas(*map(jnp.asarray, case), 16, interpret=True)
    tol = (RTOL, ATOL) if dtype == np.float32 else (2e-3, 1e-2)
    np.testing.assert_allclose(_port_agg_scan(case, 16), np.asarray(want),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("n_groups", [1, 6, 300])
def test_agg_scan_drops_codes_outside_the_groups(n_groups):
    """Codes below 0 or at and above n_groups land in no group: the
    reference's one-hot misses them and its segment_sum drops them."""
    case = _rate_case(np.random.default_rng(11 + n_groups), 5000, n_groups,
                      code_lo=-3, code_hi=n_groups + 3)
    got = _port_agg_scan(case, n_groups)
    kern = agg_scan_pallas(*map(jnp.asarray, case), n_groups, interpret=True)
    oracle = jnp.stack(jax_ref.agg_scan_ref(*map(jnp.asarray, case), n_groups))
    np.testing.assert_allclose(got, np.asarray(kern), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=RTOL, atol=ATOL)
    values, rates, mask, codes = case
    keep = (codes >= 0) & (codes < n_groups)
    assert got[0].sum() == (mask & keep).sum()


def test_agg_scan_matches_grouped_moments_in_both_packages():
    """ops.agg_scan is the drop-in for estimators.grouped_moments."""
    case = _rate_case(np.random.default_rng(3), 6000, 300)
    got = _port_agg_scan(case, 300)
    port = est_lib.grouped_moments(*map(torch.from_numpy, case), 300)
    ref = ref_est.grouped_moments(*map(jnp.asarray, case), 300)
    np.testing.assert_allclose(got, port.stacked().numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        got, np.stack([np.asarray(x) for x in jax.tree.leaves(ref)]),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_groups", [1, 6])
def test_agg_scan_absent_values_and_codes_read_one_and_group_zero(n_groups):
    """values None is a COUNT (every value 1) and group_codes None one
    group: the same bits as explicit ones and zeros, and the reference's
    kernel on those."""
    values, rates, mask, codes = _rate_case(np.random.default_rng(21), 5000,
                                            n_groups)
    ones, zeros = np.ones_like(rates), np.zeros_like(codes)
    t = {k: torch.from_numpy(a) for k, a in dict(
        values=values, rates=rates, mask=mask, codes=codes, ones=ones,
        zeros=zeros).items()}
    for got, full in (
            (ops.agg_scan(None, t["rates"], t["mask"], t["codes"], n_groups),
             (ones, rates, mask, codes)),
            (ops.agg_scan(t["values"], t["rates"], t["mask"], None, n_groups),
             (values, rates, mask, zeros)),
            (ops.agg_scan(None, t["rates"], t["mask"], None, n_groups),
             (ones, rates, mask, zeros))):
        np.testing.assert_array_equal(got.stacked().numpy(),
                                      _port_agg_scan(full, n_groups))
        want = agg_scan_pallas(*map(jnp.asarray, full), n_groups,
                               interpret=True)
        np.testing.assert_allclose(got.stacked().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("field, bad, match", [
    ("rates", torch.ones(10, dtype=torch.float64), "rates must be float32"),
    ("mask", torch.ones(10), "mask must be bool"),
    ("codes", torch.zeros(10), "group codes dtype"),
    ("values", torch.ones(9), "values has shape"),
])
def test_agg_scan_check_rejects(field, bad, match):
    args = dict(values=torch.ones(10), rates=torch.ones(10),
                mask=torch.ones(10, dtype=torch.bool),
                codes=torch.zeros(10, dtype=torch.int32))
    args[field] = bad
    with pytest.raises(ValueError, match=match):
        ops.agg_scan(args["values"], args["rates"], args["mask"],
                     args["codes"], 2)


# -------------------------------------------------------- agg_scan_batched

def _batched_case(rng, n, n_groups, q, n_atoms):
    unit = rng.random(n).astype(np.float32)
    unit[-7:] = np.inf
    strat = rng.integers(0, 37, n).astype(np.int8)
    ftab = rng.integers(1, 500, 37).astype(np.float32)
    valid = rng.random(n) >= 0.1
    cols = tuple(rng.integers(0, 8, n).astype(np.int8) for _ in range(2))
    return dict(values=rng.normal(5, 2, n).astype(np.float32), unit=unit,
                strat=strat, freq_table=ftab, valid=valid, atom_cols=cols,
                group_codes=rng.integers(0, n_groups, n).astype(np.int16),
                ks=rng.uniform(20, 400, q).astype(np.float32),
                pred_consts=rng.integers(0, 8, (q, n_atoms)).astype(
                    np.float32))


def _materialized(c, atom_slots):
    """(values, freq, entry_key, atoms f32[A, n], codes) as the batched
    kernel takes them, derived as the reference's agg_scan_fused_ref does."""
    freq = c["freq_table"][c["strat"].astype(np.int32)]
    ek = np.where(c["valid"], c["unit"] * freq, np.inf).astype(np.float32)
    atoms = (np.stack([c["atom_cols"][s].astype(np.float32)
                       for s in atom_slots]) if atom_slots
             else np.zeros((0, len(freq)), np.float32))
    return c["values"], freq, ek, atoms, c["group_codes"]


_TEMPLATES = {
    0: ((), ()),
    1: (((CmpOp.GT,),), (0,)),
    3: (((CmpOp.EQ,), (CmpOp.LE, CmpOp.NE)), (0, 1, 0)),
}


@pytest.mark.parametrize("q", [1, 7, 65])
@pytest.mark.parametrize("n_atoms", [0, 1, 3])
@pytest.mark.parametrize("n_groups", [1, 6, 300])
def test_agg_scan_batched_matches_pallas_and_fused_bitwise(q, n_atoms,
                                                           n_groups):
    c = _batched_case(np.random.default_rng(q * 100 + n_atoms + n_groups),
                      3001, n_groups, q, n_atoms)
    struct, slots = _TEMPLATES[n_atoms]
    mat = _materialized(c, slots)
    t = [torch.from_numpy(a) for a in mat]
    got = ops.agg_scan_batched(*t, torch.from_numpy(c["ks"]),
                               torch.from_numpy(c["pred_consts"]), struct,
                               n_groups).stacked().numpy()
    jstruct = tuple(tuple(JaxCmpOp[o.name] for o in conj) for conj in struct)
    if q < 65 or n_atoms == 1:   # interpret mode is slow: one Q = 65 case
        want = agg_scan_batched_pallas(
            *map(jnp.asarray, mat), jnp.asarray(c["ks"]),
            jnp.asarray(c["pred_consts"]), ops_struct=jstruct,
            n_groups=n_groups, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    # Within the port: the fused scan over the primitives, bit for bit.
    fused = np.concatenate([
        ops.agg_scan_fused(
            torch.from_numpy(c["values"]), torch.from_numpy(c["unit"]),
            torch.from_numpy(c["strat"]), torch.from_numpy(c["freq_table"]),
            torch.from_numpy(c["valid"]),
            tuple(map(torch.from_numpy, c["atom_cols"])),
            torch.from_numpy(c["group_codes"]),
            torch.from_numpy(c["ks"][i:i + 64]),
            torch.from_numpy(c["pred_consts"][i:i + 64]), struct, slots,
            n_groups).stacked().numpy()
        for i in range(0, q, 64)])
    assert np.abs(got - fused).max() == 0.0


def test_agg_scan_batched_refuses_128_atoms_like_the_reference():
    c = _batched_case(np.random.default_rng(5), 500, 2, 1, 128)
    struct, slots = ((CmpOp.GE,) * 128,), (0,) * 128
    mat = _materialized(c, slots)
    jstruct = ((JaxCmpOp.GE,) * 128,)
    with pytest.raises(ValueError, match="atoms"):
        agg_scan_batched_pallas(*map(jnp.asarray, mat), jnp.asarray(c["ks"]),
                                jnp.asarray(c["pred_consts"]),
                                ops_struct=jstruct, n_groups=2,
                                interpret=True)
    with pytest.raises(ValueError, match="atoms"):
        ops.agg_scan_batched(*map(torch.from_numpy, mat),
                             torch.from_numpy(c["ks"]),
                             torch.from_numpy(c["pred_consts"]), struct, 2)


# ------------------------------------------------------------ weighted_sum

@pytest.mark.parametrize("n", [1, 127, 4096, 9999])
def test_weighted_sum_matches_pallas(n):
    rng = np.random.default_rng(n)
    case = (rng.normal(0, 3, n).astype(np.float32),
            (rng.random(n) + 0.5).astype(np.float32), rng.random(n) < 0.6)
    got = ops.weighted_sum(*map(torch.from_numpy, case))
    want = weighted_sum_pallas(*map(jnp.asarray, case), interpret=True)
    oracle = jax_ref.weighted_sum_ref(*map(jnp.asarray, case))
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(float(g), float(o), rtol=1e-4, atol=1e-2)


def test_weighted_sum_equals_the_ungrouped_moments():
    """Σw·m, Σw·m·x, Σw·m·x² with w = 1/r are agg_scan's wsum, wxsum and
    wx2sum over one group."""
    values, rates, mask, _ = _rate_case(np.random.default_rng(9), 7000, 1)
    t = [torch.from_numpy(a) for a in (values, rates, mask)]
    sums = ops.weighted_sum(t[0], 1.0 / t[1], t[2])
    mom = ops.agg_scan(*t, torch.zeros(7000, dtype=torch.int8), 1)
    for s, leaf in zip(sums, (mom.wsum, mom.wxsum, mom.wx2sum)):
        np.testing.assert_allclose(float(s), float(leaf[0]), rtol=1e-4)


def test_weighted_sum_check_rejects():
    with pytest.raises(ValueError, match="weights must be float32"):
        ops.weighted_sum(torch.ones(4), torch.ones(4, dtype=torch.float64),
                         torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="mask has shape"):
        ops.weighted_sum(torch.ones(4), torch.ones(4),
                         torch.ones(3, dtype=torch.bool))


# ----------------------------------------- scan_moments, run_query_striped

N_ROWS, SEED = 20_000, 2


@pytest.fixture(scope="module")
def striped():
    raw = ref_synth.sessions_table(N_ROWS, seed=5)
    ref_tbl = ref_table.from_columns("s", raw)
    r = ref_exec.stripe_family(
        ref_samp.build_family(ref_tbl, ("OS",), 400.0, m=3, seed=SEED), 1)
    port = P.BlinkDB(P.EngineConfig(k1=400.0, m=3, seed=SEED), device="cpu")
    port.register_table("s", table_lib.from_columns(
        "s", synth.sessions_table(N_ROWS, seed=5)))
    state.install_families(port, "s", {("OS",): ref_samp.base_units(N_ROWS,
                                                                    SEED)})
    return r, port._striped_for("s", ("OS",)), port


def _bound(m, port, atoms):
    enc = port._encode("s")
    return tuple((tuple(m.BoundAtom(c, op, float(enc(c, v)))
                        for c, op, v in atoms),))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("k", [400.0, 37.5])
def test_run_query_striped_matches_reference(striped, use_pallas, k):
    r, p, port = striped
    n_groups = port._column_card("s", "Genre")
    for atoms, value_col in (((), "SessionTime"),
                             ((("City", "EQ", "city001"),), None),
                             ((("dt", "LT", 15), ("OS", "NE", "os2")),
                              "Bitrate")):
        rb = _bound(ref_exec, port, [(c, JaxCmpOp[o], v) for c, o, v in atoms])
        pb = _bound(exec_lib, port, [(c, CmpOp[o], v) for c, o, v in atoms])
        want = ref_exec.run_query_striped(r, rb, value_col, "Genre",
                                          n_groups, k, use_pallas=use_pallas)
        got = exec_lib.run_query_striped(p, pb, value_col, "Genre", n_groups,
                                         k, use_pallas=use_pallas)
        np.testing.assert_allclose(
            got.stacked().numpy(),
            np.stack([np.asarray(x) for x in jax.tree.leaves(want)]),
            rtol=RTOL, atol=ATOL)


def test_run_query_striped_paths_agree_and_mesh_waits(striped, tmp_path):
    """use_pallas=True (ops.agg_scan) and False (grouped_moments) agree;
    over a world-1 gloo DeviceMesh the mesh branch (the stripe's partial,
    all-gathered and summed in shard order) gives the no-mesh moments bit
    for bit, and a mesh that is not a DeviceMesh is refused."""
    from repro_torch.launch import mesh as mesh_lib
    _, p, port = striped
    bound = _bound(exec_lib, port, [("dt", CmpOp.GE, 3)])
    a = exec_lib.run_query_striped(p, bound, "SessionTime", None, 1, 200.0)
    b = exec_lib.run_query_striped(p, bound, "SessionTime", None, 1, 200.0,
                                   use_pallas=True)
    np.testing.assert_allclose(a.stacked().numpy(), b.stacked().numpy(),
                               rtol=RTOL, atol=ATOL)
    with mesh_lib.process_group(0, 1, str(tmp_path / "store")):
        m = mesh_lib.make_host_mesh()
        for use_pallas, want in ((False, a), (True, b)):
            got = exec_lib.run_query_striped(p, bound, "SessionTime", None,
                                             1, 200.0, mesh=m,
                                             use_pallas=use_pallas)
            assert torch.equal(got.stacked(), want.stacked())
    with pytest.raises(TypeError, match="DeviceMesh"):
        exec_lib.run_query_striped(p, bound, "SessionTime", None, 1, 200.0,
                                   mesh=object())


@pytest.mark.parametrize("value_col, group_col", [(None, "OS"),
                                                   ("SessionTime", None)])
def test_run_query_striped_is_the_engines_wide_program(striped, value_col,
                                                       group_col):
    """run_query_striped(use_pallas=True) and the engine's program for a
    template over 127 atoms run the same steps: equal bits."""
    _, p, port = striped
    atoms = [("URL", CmpOp.NE, f"url{i:03d}") for i in range(130)]
    bound = _bound(exec_lib, port, atoms)
    n_groups = port._column_card("s", "OS") if group_col else 1
    got = exec_lib.run_query_striped(p, bound, value_col, group_col,
                                     n_groups, 150.0, use_pallas=True)
    struct, vals = exec_lib.pred_structure(bound)
    assert not exec_lib.fits_const_block(struct, 1)
    fn = exec_lib.make_query_fn(struct, value_col, group_col, n_groups)
    want = fn(150.0, vals, *exec_lib.scan_args(p))
    assert float(want.n.sum()) > 0
    assert torch.equal(got.stacked(), want.stacked())


def test_scan_moments_and_predicate_mask_match_reference(striped):
    r, p, port = striped
    pb = _bound(exec_lib, port, [("City", CmpOp.LE, "city010")])
    rb = _bound(ref_exec, port, [("City", JaxCmpOp.LE, "city010")])
    pcols = p.columns
    rcols = {c: v[0] for c, v in r.columns.items()}
    np.testing.assert_array_equal(
        exec_lib.predicate_mask(pcols, pb).numpy(),
        np.asarray(ref_exec.predicate_mask(rcols, rb)))
    freq, ek = exec_lib.derive_ht(p.unit, p.strat, p.freq_table)
    rfreq, rek = ref_exec.derive_ht(r.unit[0], r.strat[0], r.freq_table)
    np.testing.assert_array_equal(freq.numpy(), np.asarray(rfreq))
    np.testing.assert_array_equal(ek.numpy(), np.asarray(rek))
    for use_pallas in (False, True):
        got = exec_lib.scan_moments(pcols, freq, pb, "Bitrate", "OS",
                                    port._column_card("s", "OS"), 100.0,
                                    p.valid & (ek < 100.0),
                                    use_pallas=use_pallas)
        want = ref_exec.scan_moments(rcols, rfreq, rb, "Bitrate", "OS",
                                     port._column_card("s", "OS"), 100.0,
                                     r.valid[0] & (rek < 100.0),
                                     use_pallas=use_pallas)
        np.testing.assert_allclose(
            got.stacked().numpy(),
            np.stack([np.asarray(x) for x in jax.tree.leaves(want)]),
            rtol=RTOL, atol=ATOL)
