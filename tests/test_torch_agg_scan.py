"""Port parity: the fused memory-lean scan.

On the CPU the port's `agg_scan_fused` runs its plain PyTorch version; it
is held against the reference's Pallas kernel in interpret mode and the
reference's jnp oracle over the sweep of tests/test_kernel_fused.py, at the
reference's kernel tolerance (rtol 2e-5, atol 1e-3). The CUDA kernel runs
only on the card: tests/test_torch_cuda.py holds it against this plain
version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import CmpOp as JaxCmpOp
from repro.kernels import ref as jax_ref
from repro.kernels.agg_scan import agg_scan_fused_pallas
from repro_torch.core.types import CmpOp
from repro_torch.kernels import agg_scan, ops, ref

RTOL, ATOL = 2e-5, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(rng, n, n_groups, q, n_atoms, n_strata=37, strat_dtype=np.int8,
          atom_dtype=np.int8, ghost_frac=0.0, pad_rows=0):
    unit = rng.random(n).astype(np.float32)
    if pad_rows:
        unit[-pad_rows:] = np.inf
    return dict(
        values=rng.normal(5, 2, n).astype(np.float32),
        unit=unit,
        strat=rng.integers(0, n_strata, n).astype(strat_dtype),
        freq_table=rng.integers(1, 500, n_strata).astype(np.float32),
        valid=rng.random(n) >= ghost_frac,
        atom_cols=tuple(rng.integers(0, 8, n).astype(atom_dtype)
                        for _ in range(n_atoms)),
        group_codes=rng.integers(0, n_groups, n).astype(atom_dtype),
        ks=rng.uniform(20, 400, q).astype(np.float32),
        pred_consts=rng.integers(0, 8, (q, n_atoms)).astype(np.float32))


def _port(c, ops_struct, atom_slots, n_groups):
    t = {k: (tuple(torch.from_numpy(a) for a in v)
             if k == "atom_cols" else torch.from_numpy(v))
         for k, v in c.items()}
    mom = ops.agg_scan_fused(t["values"], t["unit"], t["strat"],
                             t["freq_table"], t["valid"], t["atom_cols"],
                             t["group_codes"], t["ks"], t["pred_consts"],
                             ops_struct, atom_slots, n_groups)
    return mom.stacked().cpu().numpy()


def _jax_args(c):
    return (jnp.asarray(c["values"]), jnp.asarray(c["unit"]),
            jnp.asarray(c["strat"]), jnp.asarray(c["freq_table"]),
            jnp.asarray(c["valid"]),
            tuple(jnp.asarray(a) for a in c["atom_cols"]),
            jnp.asarray(c["group_codes"]), jnp.asarray(c["ks"]),
            jnp.asarray(c["pred_consts"]))


def _assert_parity(c, ops_struct, n_groups, atom_slots=None, pallas=False):
    got = _port(c, ops_struct, atom_slots, n_groups)
    args = _jax_args(c)
    # the same template in the reference's own operator enum
    ops_struct = tuple(tuple(JaxCmpOp[op.name] for op in conj)
                       for conj in ops_struct)
    want = jax_ref.agg_scan_fused_ref(*args, ops_struct=ops_struct,
                                      atom_slots=atom_slots, n_groups=n_groups)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    if pallas:   # interpret mode is slow: a representative subset runs it
        kern = agg_scan_fused_pallas(*args, ops_struct=ops_struct,
                                     atom_slots=atom_slots, n_groups=n_groups,
                                     interpret=True)
        np.testing.assert_allclose(got, np.asarray(kern), rtol=RTOL, atol=ATOL)
    return got


# ------------------------------------------------ plain version vs reference

@pytest.mark.parametrize("n", [1, 100, 5000])
@pytest.mark.parametrize("n_groups", [1, 600])
def test_fused_shapes(n, n_groups):
    rng = np.random.default_rng(n * 7 + n_groups)
    c = _case(rng, n, n_groups, q=5, n_atoms=2,
              atom_dtype=np.int16 if n_groups > 127 else np.int8)
    _assert_parity(c, ((CmpOp.EQ,), (CmpOp.GT,)), n_groups,
                   pallas=n == 100)


@pytest.mark.parametrize("strat_dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("atom_dtype", [np.int8, np.int16, np.int32,
                                        np.float32])
def test_fused_narrow_dtype_widths(strat_dtype, atom_dtype):
    rng = np.random.default_rng(11)
    c = _case(rng, 4096, 12, q=4, n_atoms=2, strat_dtype=strat_dtype,
              atom_dtype=atom_dtype)
    if atom_dtype == np.float32:   # group codes are always integers
        c["group_codes"] = c["group_codes"].astype(np.int8)
    _assert_parity(c, ((CmpOp.EQ, CmpOp.LE),), 12,
                   pallas=strat_dtype == atom_dtype == np.int16)


def test_fused_ghost_and_pad_rows():
    rng = np.random.default_rng(12)
    c = _case(rng, 3000, 8, q=3, n_atoms=1, ghost_frac=0.35, pad_rows=200)
    _assert_parity(c, ((CmpOp.GT,),), 8, pallas=True)


def test_fused_all_ghosts_is_zero():
    rng = np.random.default_rng(13)
    c = _case(rng, 1000, 4, q=2, n_atoms=1)
    c["valid"] = np.zeros(1000, bool)
    got = _assert_parity(c, ((CmpOp.GT,),), 4)
    assert (got == 0.0).all()


@pytest.mark.parametrize("n_strata, strat_dtype", [(1, np.int8),
                                                   (300, np.int16),
                                                   (4096, np.int16)])
def test_fused_strata_counts(n_strata, strat_dtype):
    rng = np.random.default_rng(14 + n_strata)
    c = _case(rng, 2500, 6, q=3, n_atoms=1, n_strata=n_strata,
              strat_dtype=strat_dtype)
    _assert_parity(c, ((CmpOp.LE,),), 6, pallas=n_strata == 300)


def test_fused_no_predicate():
    rng = np.random.default_rng(16)
    c = _case(rng, 3000, 5, q=3, n_atoms=0)
    _assert_parity(c, (), 5, pallas=True)


def test_fused_empty_conjunction_is_true():
    """Predicate.true() binds to one empty conjunction: every row passes."""
    rng = np.random.default_rng(21)
    c = _case(rng, 2000, 3, q=2, n_atoms=0)
    np.testing.assert_array_equal(_port(c, ((),), (), 3),
                                  _port(c, (), (), 3))


def test_fused_count_and_ungrouped_defaults():
    """values=None is COUNT's all-ones column, group_codes=None one group."""
    rng = np.random.default_rng(22)
    c = _case(rng, 2000, 1, q=2, n_atoms=1)
    c["values"] = np.ones(2000, np.float32)
    c["group_codes"] = np.zeros(2000, np.int8)
    want = _port(c, ((CmpOp.LT,),), (0,), 1)
    t = {k: torch.from_numpy(v) for k, v in c.items() if k != "atom_cols"}
    got = ref.agg_scan_fused_ref(
        None, t["unit"], t["strat"], t["freq_table"], t["valid"],
        tuple(torch.from_numpy(a) for a in c["atom_cols"]), None, t["ks"],
        t["pred_consts"], ((CmpOp.LT,),), (0,), 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_atom_slot_dedup():
    rng = np.random.default_rng(17)
    c = _case(rng, 2000, 4, q=2, n_atoms=1)
    c["pred_consts"] = rng.integers(0, 8, (2, 2)).astype(np.float32)
    _assert_parity(c, ((CmpOp.GE, CmpOp.LE),), 4, atom_slots=(0, 0),
                   pallas=True)


def test_fused_127_atoms():
    rng = np.random.default_rng(18)
    c = _case(rng, 512, 2, q=1, n_atoms=1)
    c["pred_consts"] = rng.integers(0, 8, (1, 127)).astype(np.float32)
    _assert_parity(c, ((CmpOp.GE,) * 127,), 2, atom_slots=(0,) * 127)


def test_fused_float64_accumulation_agrees():
    """The float64-accumulated plain version (the card's yardstick) agrees
    with the float32 one at the kernel tolerance."""
    rng = np.random.default_rng(23)
    c = _case(rng, 5000, 7, q=3, n_atoms=1)
    t = {k: (tuple(torch.from_numpy(a) for a in v) if k == "atom_cols"
             else torch.from_numpy(v)) for k, v in c.items()}
    args = (t["values"], t["unit"], t["strat"], t["freq_table"], t["valid"],
            t["atom_cols"], t["group_codes"], t["ks"], t["pred_consts"],
            ((CmpOp.NE,),), (0,), 7)
    a = ref.agg_scan_fused_ref(*args)
    b = ref.agg_scan_fused_ref(*args, accumulate=torch.float64)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------- input checks

def _torch_case(n_atoms=1, q=2, n_strata=37, n=300):
    rng = np.random.default_rng(3)
    c = _case(rng, n, 4, q=q, n_atoms=n_atoms, n_strata=n_strata)
    return {k: (tuple(torch.from_numpy(a) for a in v) if k == "atom_cols"
                else torch.from_numpy(v)) for k, v in c.items()}


def _call(t, ops_struct, atom_slots, n_groups=4, fn=ops.agg_scan_fused):
    return fn(t["values"], t["unit"], t["strat"], t["freq_table"], t["valid"],
              t["atom_cols"], t["group_codes"], t["ks"], t["pred_consts"],
              ops_struct, atom_slots, n_groups)


def test_check_rejects_128_atoms():
    t = _torch_case()
    t["pred_consts"] = torch.zeros((2, 128))
    with pytest.raises(ValueError, match="atoms"):
        _call(t, ((CmpOp.GE,) * 128,), (0,) * 128)


def test_check_rejects_4097_strata():
    """The fused scan took at most 4096 strata, the table the kernel held
    in shared memory; a longer table is now read through L2, so 4097
    strata pass the check and give the plain version's moments. What the
    check still rejects is an empty table (no stratum to read)."""
    t = _torch_case()
    t["freq_table"] = torch.ones(4097)
    t["strat"] = torch.arange(300, dtype=torch.int16) * 13
    got = _call(t, ((CmpOp.EQ,),), (0,)).stacked()
    want = ref.agg_scan_fused_ref(
        t["values"], t["unit"], t["strat"], t["freq_table"], t["valid"],
        t["atom_cols"], t["group_codes"], t["ks"], t["pred_consts"],
        ((CmpOp.EQ,),), (0,), 4)
    assert torch.equal(got, want) and got[:, 0].sum() > 0
    t["freq_table"] = torch.ones(0)
    with pytest.raises(ValueError, match="strata"):
        _call(t, ((CmpOp.EQ,),), (0,))


def test_check_rejects_65_queries():
    t = _torch_case(q=65)
    with pytest.raises(ValueError, match="queries"):
        _call(t, ((CmpOp.EQ,),), (0,))


@pytest.mark.parametrize("field, bad, match", [
    ("strat", torch.zeros(300, dtype=torch.int64), "strat dtype"),
    ("unit", torch.zeros(300, dtype=torch.float64), "float32"),
    ("valid", torch.ones(300, dtype=torch.uint8), "bool"),
    ("group_codes", torch.zeros(299, dtype=torch.int8), "shape"),
    ("pred_consts", torch.zeros((2, 3)), "pred_consts"),
])
def test_check_rejects_bad_arguments(field, bad, match):
    t = _torch_case()
    t[field] = bad
    with pytest.raises(ValueError, match=match):
        _call(t, ((CmpOp.EQ,),), (0,))


def test_check_rejects_missing_atom_slot():
    t = _torch_case()
    with pytest.raises(ValueError, match="atom_slots"):
        _call(t, ((CmpOp.EQ, CmpOp.LE),), (0, 1))


def test_cuda_wrapper_refuses_cpu_tensors():
    t = _torch_case()
    before = agg_scan.agg_scan_fused_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        _call(t, ((CmpOp.EQ,),), (0,), fn=agg_scan.agg_scan_fused_cuda)
    assert agg_scan.agg_scan_fused_cuda.launches == before


@pytest.mark.parametrize("n, q, g", [(0, 1, 1), (1, 1, 1), (10_000_019, 1, 1),
                                     (5_000_000, 1, 500), (100_003, 64, 500),
                                     (100_003, 7, 6), (2_000_000, 3, 70_000)])
@pytest.mark.parametrize("n_sms", [132, 114])
def test_launch_plan_covers_rows(n, q, g, n_sms):
    rows, chunks, gt, blocks = agg_scan.launch_plan(n, q, g, n_sms)
    assert rows % 256 == 0 and rows * chunks >= n
    assert chunks == 1 or rows * (chunks - 1) < n
    # register mode (a power of two up to 8 that covers G) or shared-mode
    # tiles of up to 1024 groups
    assert (gt <= 8) == (g <= 8) and gt <= 1024 and gt >= min(g, 1024)
    assert gt > 8 or gt & (gt - 1) == 0
    # the scratch is capped per query: [chunks, 7, G] floats of 64 MiB
    assert chunks * 7 * g * 4 <= max(64 << 20, 7 * g * 4)
    assert blocks == q * -(-g // gt) and chunks <= 65535
    assert chunks <= 8 * n_sms
