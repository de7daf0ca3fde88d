"""The CUDA kernel on the card, against the port's own plain versions.

These tests need an NVIDIA GPU (the kernel has no CPU mode) and carry the
`cuda` marker; without a card each skips with its reason. This file imports
neither jax nor `repro`, so it also runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import (AggOp, Atom, BlinkDB, CmpOp, Conjunction,
                              EngineConfig, ErrorBound, Predicate, Query)
from repro_torch.core import table as table_lib
from repro_torch.data import synth
from repro_torch.kernels import agg_scan, ops, ref
from repro_torch.models import model as model_lib
from repro_torch.models.common import ParamFactory
from repro_torch.serve.engine import ServeConfig, ServeEngine

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


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups", [6, 500])     # G·B = 192 and 16,000
def test_subsampled_fused_launch_matches_plain(cuda_device, n_groups):
    """The subsampled scans' launch: the fused kernel over the int32 group
    column g·B + sub (B = 32) and G·B groups, codes -1 (a dangling join
    key) among them, against its plain version; repeat launches and a
    query launched alone bit-identical to its slice of a Q = 7 launch."""
    from repro_torch.core import executor as exec_lib
    b = 32
    rng = np.random.default_rng(n_groups)
    n = 1_000_003
    t = _case(rng, n, n_groups, 7, 2, cuda_device)
    sub = torch.from_numpy(exec_lib.subsample_codes(1, n, b)[0]).to(
        cuda_device)
    codes = t["group_codes"].to(torch.int32)
    codes[::97] = -1
    t["group_codes"] = exec_lib.subsample_group_column(codes, sub, b)
    assert t["group_codes"].dtype == torch.int32
    struct, slots = ((CmpOp.EQ,), (CmpOp.GT,)), (0, 0)
    g = n_groups * b
    got = _call(agg_scan.agg_scan_fused_cuda, t, struct, slots, g)
    again = _call(agg_scan.agg_scan_fused_cuda, t, struct, slots, g)
    want = _call(ref.agg_scan_fused_ref, t, struct, slots, g,
                 accumulate=torch.float64)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, again)
    one = _call(agg_scan.agg_scan_fused_cuda,
                dict(t, ks=t["ks"][3:4], pred_consts=t["pred_consts"][3:4]),
                struct, slots, g)
    assert torch.equal(one[0], got[3])


@pytest.mark.cuda
def test_subsampled_and_joined_engine_on_card(cuda_device):
    """ci_method="subsampling" and a joined dimension on the card: answers
    within rtol 1e-4 of the engine on the CPU, and query_batch bit for bit
    query()'s on the card."""
    from repro_torch.core.joins import Join
    raw = synth.sessions_table(100_000, seed=3)
    urls = np.unique(raw["URL"])
    dim = {"url": urls[urls != urls[7]],
           "owner": np.array([f"own{i % 12}" for i in range(len(urls) - 1)])}
    join = (Join("media", "URL", "url"),)
    genre = Predicate.where(Atom("Genre", CmpOp.EQ, "genre03"))
    queries = [
        Query("sessions", AggOp.COUNT, bound=ErrorBound(0.1)),
        Query("sessions", AggOp.SUM, "SessionTime", group_by=("OS",),
              bound=ErrorBound(0.05)),
        Query("sessions", AggOp.AVG, "Bitrate", group_by=("URL",),
              bound=ErrorBound(0.1)),
        Query("sessions", AggOp.AVG, "SessionTime",
              group_by=("media.owner",), bound=ErrorBound(0.1), joins=join),
        Query("sessions", AggOp.COUNT, bound=ErrorBound(0.1), joins=join,
              predicate=Predicate.where(Atom("media.owner", CmpOp.EQ,
                                             "own3")))]
    quantile = Query("sessions", AggOp.QUANTILE, "SessionTime",
                     quantile=0.5, predicate=genre, bound=ErrorBound(0.1))
    dbs = []
    for dev in ("cpu", cuda_device):
        db = BlinkDB(EngineConfig(k1=800.0, m=3, ci_method="subsampling"),
                     device=dev)
        db.register_table("sessions", table_lib.from_columns("sessions",
                                                             raw))
        db.register_table("media", table_lib.from_columns("media", dim))
        for phi in (("City",), ("URL",), ()):
            db.add_family("sessions", phi)
        dbs.append(db)
    cpu, card = dbs
    before = (agg_scan.agg_scan_fused_cuda.launches,
              agg_scan.quantile_scan_cuda.launches)
    batched = card.query_batch(queries)
    single = [card.query(q) for q in queries + [quantile]]
    assert agg_scan.agg_scan_fused_cuda.launches > before[0]
    assert agg_scan.quantile_scan_cuda.launches > before[1]
    for q, a, b in zip(queries, batched, single):
        assert [(g.key, g.estimate, g.stderr) for g in a.groups] == \
            [(g.key, g.estimate, g.stderr) for g in b.groups], q
    for q, b in zip(queries + [quantile], single):
        a = cpu.query(q)
        assert (b.sample_phi, b.sample_k, b.rows_read) == \
            (a.sample_phi, a.sample_k, a.rows_read)
        assert [g.key for g in b.groups] == [g.key for g in a.groups]
        np.testing.assert_allclose([g.estimate for g in b.groups],
                                   [g.estimate for g in a.groups], rtol=1e-4)
        # A replicate quantile read off a subsample's small histogram may
        # cross into the next bin where the card's float sums differ from
        # the CPU's in the last bit: its stderr is held at rtol 0.1.
        np.testing.assert_allclose([g.stderr for g in b.groups],
                                   [g.stderr for g in a.groups],
                                   rtol=0.1 if q is quantile else 1e-4)


# -- mutation and maintenance on the card -------------------------------------

def _mutation_engines(cuda_device, raw, families, k1=400.0):
    """The same engine on the CPU and on the card, every block striped
    (the families' units come from the CPU generator on both)."""
    dbs = []
    for dev in ("cpu", cuda_device):
        db = BlinkDB(EngineConfig(k1=k1, m=3, seed=4), device=dev)
        db.register_table("s", table_lib.from_columns("s", raw))
        for phi in families:
            db.add_family("s", phi)
            db._striped_for("s", phi)
        dbs.append(db)
    return dbs


def _assert_blocks_equal(cpu, card):
    for (t, phi), a in cpu._striped.items():
        b = card._striped[(t, phi)]
        for f in ("valid", "unit", "strat", "freq_table"):
            assert torch.equal(getattr(b, f).cpu(), getattr(a, f)), (phi, f)
        assert b.columns.keys() == a.columns.keys()
        for c in a.columns:
            assert torch.equal(b.columns[c].cpu(), a.columns[c]), (phi, c)
        np.testing.assert_array_equal(b.slot_row_ids, a.slot_row_ids)
        assert (b.n_rows, b.n_ghosts, b.table_rows) == \
            (a.n_rows, a.n_ghosts, a.table_rows)


def _assert_answers_equal(cpu, card, queries, kernel_names):
    for q in queries:
        before = {k: getattr(agg_scan, f"{k}_cuda").launches
                  for k in kernel_names}
        b = card.query(q)
        a = cpu.query(q)
        assert any(getattr(agg_scan, f"{k}_cuda").launches > before[k]
                   for k in kernel_names), q
        assert (b.sample_phi, b.sample_k, b.rows_read, b.rows_total) == \
            (a.sample_phi, a.sample_k, a.rows_read, a.rows_total)
        assert [g.key for g in b.groups] == [g.key for g in a.groups]
        np.testing.assert_allclose([g.estimate for g in b.groups],
                                   [g.estimate for g in a.groups], rtol=1e-4)


def _mutation_queries():
    genre = Predicate.where(Atom("Genre", CmpOp.EQ, "genre03"))
    return [
        Query("s", AggOp.COUNT, group_by=("OS",), bound=ErrorBound(0.1)),
        Query("s", AggOp.AVG, "SessionTime", group_by=("City",),
              bound=ErrorBound(0.1)),
        Query("s", AggOp.SUM, "Bitrate", predicate=genre,
              bound=ErrorBound(0.05)),
        Query("s", AggOp.QUANTILE, "SessionTime", quantile=0.5,
              bound=ErrorBound(0.1)),
        Query("s", AggOp.COUNT, group_by=("OS",), bound=ErrorBound(0.1),
              predicate=Predicate.where(*[
                  Atom("URL", CmpOp.NE, f"url{499 - i:03d}")
                  for i in range(200)])),
    ]


@pytest.mark.cuda
def test_mutations_on_card_equal_the_cpu_block_and_answers(cuda_device):
    """Append (a new city among the rows), delete, update, base compaction,
    decay and ghost compaction on the card: after each, every striped
    block equals the CPU engine's slot for slot, and the card answers the
    fused, quantile and wide (agg_scan) queries as the CPU does."""
    from repro_torch.core import maintenance
    cpu, card = _mutation_engines(
        cuda_device, synth.sessions_table(40_000, seed=8),
        (("City",), ("URL",), ()))
    delta = synth.sessions_table(3000, seed=9)
    delta["City"] = np.where(np.arange(3000) < 50, "cityNEW",
                             delta["City"])
    steps = [
        lambda db: db.append_rows("s", delta),
        lambda db: db.delete_rows("s", Predicate.where(
            Atom("dt", CmpOp.LT, 6))),
        lambda db: db.update_rows("s", Predicate.where(
            Atom("Genre", CmpOp.EQ, "genre03")), {"Bitrate": 1000.0}),
        lambda db: db.compact_table("s"),
        lambda db: db.decay_family("s", ("City",), maintenance.strata_to_decay(
            db.families["s"][("City",)], 1.2)),
        lambda db: [db.compact_family("s", p) for p in db.families["s"]],
    ]
    kernels = ("agg_scan_fused", "quantile_scan", "agg_scan")
    _assert_answers_equal(cpu, card, _mutation_queries(), kernels)
    for step in steps:
        step(cpu)
        step(card)
        _assert_blocks_equal(cpu, card)
        _assert_answers_equal(cpu, card, _mutation_queries(), kernels)
        q = Query("s", AggOp.COUNT, group_by=("OS",))
        assert [(g.key, g.estimate) for g in card.exact_query(q).groups] == \
            [(g.key, g.estimate) for g in cpu.exact_query(q).groups]


@pytest.mark.cuda
def test_append_past_4096_strata_takes_the_l2_route(cuda_device):
    """A (City, URL) family of at most 4096 strata reads its table from
    shared memory; an append of new URLs grows it past 4096, and the next
    launches of the fused and quantile kernels read it through L2 (the
    route is chosen per launch from the table length) and agree with their
    plain versions and with the CPU engine."""
    raw = synth.sessions_table(25_000, seed=2, n_cities=40, n_urls=200)
    cpu, card = _mutation_engines(cuda_device, raw, (("City", "URL"), ()),
                                  k1=50.0)
    fam = card.families["s"][("City", "URL")]
    assert fam.n_distinct <= agg_scan.SHARED_STRATA
    assert card._striped_for("s", ("City", "URL")).freq_table.shape[0] <= \
        agg_scan.SHARED_STRATA
    # new URLs spread evenly over the cities: nearly a stratum a row, and
    # few enough rows to be scattered into the block's padding
    delta = synth.sessions_table(3000, seed=3, n_cities=40, n_urls=1000,
                                 city_s=0.2, url_s=0.2)
    delta["URL"] = np.char.add("new-", delta["URL"])
    for db in (cpu, card):
        assert db.append_rows("s", delta).restriped == []
    block = card._striped_for("s", ("City", "URL"))
    assert card.families["s"][("City", "URL")].n_distinct > \
        agg_scan.SHARED_STRATA
    assert block.freq_table.shape[0] > agg_scan.SHARED_STRATA
    _assert_blocks_equal(cpu, card)
    t = dict(values=block.columns["SessionTime"], unit=block.unit,
             strat=block.strat, freq_table=block.freq_table,
             valid=block.valid, atom_cols=(block.columns["OS"],),
             group_codes=block.columns["Genre"],
             ks=torch.tensor([50.0, 12.5], device=cuda_device),
             pred_consts=torch.tensor([[1.0], [3.0]], device=cuda_device))
    struct, slots, g = ((CmpOp.LE,),), (0,), 12
    got = _call(agg_scan.agg_scan_fused_cuda, t, struct, slots, g)
    want = _call(ref.agg_scan_fused_ref, t, struct, slots, g,
                 accumulate=torch.float64)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    mom, hist = _quantile_call(agg_scan.quantile_scan_cuda, t, struct, slots,
                               g)
    want_mom, want_hist = _quantile_call(ref.quantile_scan_ref, t, struct,
                                         slots, g, accumulate=torch.float64)
    torch.testing.assert_close(mom, want_mom, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(hist, want_hist, rtol=RTOL, atol=ATOL)
    both = Predicate.where(Atom("City", CmpOp.EQ, "city001"),
                           Atom("URL", CmpOp.EQ, "new-url002"))
    _assert_answers_equal(cpu, card, [
        Query("s", AggOp.COUNT, predicate=both, bound=ErrorBound(0.1)),
        Query("s", AggOp.QUANTILE, "SessionTime", quantile=0.5,
              predicate=both, bound=ErrorBound(0.1))],
        ("agg_scan_fused", "quantile_scan"))


@pytest.mark.cuda
def test_append_past_int8_stratum_ids_restripes(cuda_device):
    """A City family of 120 strata stores int8 stratum ids; an append of
    new cities takes the ids past 127: the block is restriped with int16
    ids (never a truncated scatter) and answers as the CPU engine does."""
    raw = synth.sessions_table(20_000, seed=5, n_cities=120, city_s=0.5)
    cpu, card = _mutation_engines(cuda_device, raw, (("City",),))
    assert card._striped_for("s", ("City",)).strat.dtype == torch.int8
    delta = synth.sessions_table(500, seed=6, n_cities=40)
    delta["City"] = np.char.add("more-", delta["City"])
    reps = [db.append_rows("s", delta) for db in (cpu, card)]
    assert reps[1].restriped == [("City",)] == reps[0].restriped
    assert card.families["s"][("City",)].n_distinct > 127
    assert card._striped_for("s", ("City",)).strat.dtype == torch.int16
    _assert_blocks_equal(cpu, card)
    _assert_answers_equal(cpu, card, [
        Query("s", AggOp.AVG, "SessionTime", group_by=("City",),
              bound=ErrorBound(0.1)),
        Query("s", AggOp.COUNT, bound=ErrorBound(0.1),
              predicate=Predicate.where(Atom("City", CmpOp.EQ,
                                             "more-city001")))],
        ("agg_scan_fused",))


@pytest.mark.cuda
def test_decayed_dead_stratum_zero_leaves_every_kernel_equal_plain(
        cuda_device):
    """Stratum 0 deleted whole and decayed has inclusion frequency 0: its
    ghost and pad slots (strat 0, unit +inf) derive entry_key +inf·0 = NaN,
    which must fail every kernel's prefix test as it fails the plain
    versions' ek < k. The fused, quantile, batched and agg_scan kernels on
    the decayed block against their plain versions."""
    from repro_torch.core import executor as exec_lib
    cpu, card = _mutation_engines(
        cuda_device, synth.sessions_table(30_000, seed=7, n_cities=50),
        (("City",),))
    for db in (cpu, card):
        db.delete_rows("s", Predicate.where(Atom("City", CmpOp.EQ, "city00")))
        fam = db.families["s"][("City",)]
        assert fam.live_freqs[0] == 0
        db.decay_family("s", ("City",), [0])
    block = card._striped_for("s", ("City",))
    assert block.freq_table[0].item() == 0.0
    assert bool((block.strat[~block.valid] == 0).all())
    ek = block.unit * block.freq_table[block.strat.long()]
    assert bool(ek.isnan().any())
    t = dict(values=block.columns["SessionTime"], unit=block.unit,
             strat=block.strat, freq_table=block.freq_table,
             valid=block.valid, atom_cols=(block.columns["OS"],),
             group_codes=block.columns["OS"],
             ks=torch.tensor([400.0, 100.0, 1e30], device=cuda_device),
             pred_consts=torch.tensor([[5.0]] * 3, device=cuda_device))
    struct, slots, g = ((CmpOp.LE,),), (0,), 6
    got = _call(agg_scan.agg_scan_fused_cuda, t, struct, slots, g)
    want = _call(ref.agg_scan_fused_ref, t, struct, slots, g,
                 accumulate=torch.float64)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert bool(got.isfinite().all())
    mom, hist = _quantile_call(agg_scan.quantile_scan_cuda, t, struct, slots,
                               g)
    want_mom, want_hist = _quantile_call(ref.quantile_scan_ref, t, struct,
                                         slots, g, accumulate=torch.float64)
    torch.testing.assert_close(mom, want_mom, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(hist, want_hist, rtol=RTOL, atol=ATOL)
    batched = agg_scan.agg_scan_batched_cuda(
        *_batched_from_fused(t, 1), t["ks"], t["pred_consts"], struct, g)
    assert (batched - got).abs().max().item() == 0.0
    for k in (400.0, 100.0):
        k_t = torch.tensor(k, device=cuda_device)
        freq, sel = exec_lib.query_selection(
            block.columns["OS"].float() <= 5.0, k_t, block.unit, block.strat,
            block.freq_table, block.valid)
        inputs = exec_lib.agg_scan_inputs(sel, freq, k_t, block.columns,
                                          "SessionTime", "OS")
        torch.testing.assert_close(
            agg_scan.agg_scan_cuda(*inputs, g),
            ref.agg_scan_ref(*inputs, g, accumulate=torch.float64),
            rtol=RTOL, atol=ATOL)
    _assert_answers_equal(cpu, card, _mutation_queries()[:4],
                          ("agg_scan_fused", "quantile_scan"))


@pytest.mark.cuda
def test_wrappers_from_eight_threads_equal_one_thread(cuda_device):
    """Eight threads launch agg_scan (its one-launch kernel with the
    per-stream scratch and ticket word), agg_scan_batched (its per-stream
    scratch) and the fused scan at once, the scratch buffers dropped first
    so their first use is concurrent: every output equals the same launch
    from one thread bit for bit, and every launch is counted."""
    import threading
    rng = np.random.default_rng(31)
    rates = _rate_case(rng, 100_003, 6, np.float32, cuda_device)
    t = _case(rng, 100_003, 6, 7, 1, cuda_device)
    struct, slots = ((CmpOp.LE,),), (0,)
    batched_in = _batched_from_fused(t, 1)

    def launch_all():
        return (agg_scan.agg_scan_cuda(*rates, 6),
                agg_scan.agg_scan_batched_cuda(*batched_in, t["ks"],
                                               t["pred_consts"], struct, 6),
                _call(agg_scan.agg_scan_fused_cuda, t, struct, slots, 6))
    want = launch_all()
    torch.cuda.synchronize()
    agg_scan._SCRATCH.clear()
    agg_scan._BATCHED_SCRATCH.clear()
    names = ("agg_scan_cuda", "agg_scan_batched_cuda", "agg_scan_fused_cuda")
    before = [getattr(agg_scan, n).launches for n in names]
    barrier = threading.Barrier(8)
    got, errors = {}, []

    def worker(i):
        try:
            barrier.wait()
            got[i] = launch_all()
            torch.cuda.synchronize()
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and not any(th.is_alive() for th in threads), errors
    for i in range(8):
        for a, b in zip(got[i], want):
            assert torch.equal(a, b)
    assert [getattr(agg_scan, n).launches - b0
            for n, b0 in zip(names, before)] == [8, 8, 8]


@pytest.mark.cuda
def test_fault_plans_and_service_on_the_card(cuda_device):
    """On the card: a replica-0 kill on every shard equals the clean
    sharded scan bit for bit, one shard lost degrades the answer, and
    BlinkQL from eight session threads answers bit for bit as query() on
    the same engine."""
    import threading
    from repro_torch.fault.inject import FaultPlan, FaultSpec, arm
    from repro_torch.service import (BlinkQLService, ServiceConfig,
                                     parse_blinkql)
    db = BlinkDB(EngineConfig(k1=400.0, m=3, seed=1), device="cuda")
    db.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(60_000, seed=2)))
    db.add_family("sessions", ("City",))
    db.add_family("sessions", ())
    assert db.device.index is not None
    text = ("SELECT SUM(SessionTime) FROM sessions GROUP BY City "
            "ERROR WITHIN 20%")
    q = parse_blinkql(text, db).normalized()
    db.query(q)

    def run(*specs):
        with arm(FaultPlan(list(specs), seed=0)):
            return db.query(q)
    clean = run(FaultSpec(site="shard.scan", kind="kill",
                          match=(("shard", 99),)))
    rerouted = run(FaultSpec(site="shard.scan", kind="kill",
                             match=(("replica", 0),)))
    lost = run(FaultSpec(site="shard.scan", kind="kill",
                         match=(("shard", 1),)))
    assert clean.shards_total == 4 and not clean.degraded
    assert [(g.key, g.estimate, g.stderr) for g in rerouted.groups] == \
        [(g.key, g.estimate, g.stderr) for g in clean.groups]
    assert lost.degraded and lost.shards_lost == 1
    cities = db.tables["sessions"].dictionaries["City"]
    texts = [f"SELECT AVG(SessionTime) FROM sessions WHERE City = '{c}' "
             "ERROR WITHIN 10%" for c in cities[:8]]
    got, barrier = {}, threading.Barrier(8)
    with BlinkQLService(db, config=ServiceConfig(batch_window_s=0.01,
                                                 use_cache=False)) as svc:
        def session(i):
            barrier.wait()
            got[i] = svc.submit(texts[i])
        threads = [threading.Thread(target=session, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    for i, t in enumerate(texts):
        want = db.query(parse_blinkql(t, db).normalized())
        assert [(g.key, g.estimate, g.stderr) for g in got[i].groups] == \
            [(g.key, g.estimate, g.stderr) for g in want.groups]


@pytest.mark.cuda
def test_two_rank_mesh_on_the_card_holds_every_launch_to_plain(cuda_device):
    """Two ranks on the card (gloo carries the partials): every launch of
    the fused, quantile and agg_scan kernels on each rank's stripe is held
    against its plain version, the ranks answer in equal bits, and the
    answers match one device's (family, K, keys exact; rtol 1e-4)."""
    from repro_torch.launch import mesh as mesh_lib
    t = "sessions"
    genre = Predicate.where(Atom("Genre", CmpOp.EQ, "genre03"))
    queries = (
        Query(t, AggOp.SUM, "SessionTime", group_by=("City",),
              bound=ErrorBound(0.1)),
        Query(t, AggOp.COUNT, predicate=genre, group_by=("OS",),
              bound=ErrorBound(0.1)),
        Query(t, AggOp.QUANTILE, "SessionTime", quantile=0.5,
              group_by=("OS",), bound=ErrorBound(0.1)),
        Query(t, AggOp.AVG, "SessionTime", bound=ErrorBound(0.1),
              predicate=Predicate.where(*[
                  Atom("City", CmpOp.NE, f"city{199 - j:03d}")
                  for j in range(130)])))
    session = mesh_lib.Session(
        t, {"k1": 400.0, "m": 3, "seed": 1},
        (mesh_lib.Step("query", "query", queries),
         mesh_lib.Step("batch", "batch", queries)),
        families=(("City",), ("OS",), ()), n_rows=200_000, table_seed=2,
        device="cuda", check_plain=True)
    one = mesh_lib.run_session(session)
    ranks = mesh_lib.run_ranks(mesh_lib.session_rank, 2, session,
                               timeout=600.0)
    for r, out in enumerate(ranks):
        assert all(out["launches"][k] > 0 for k in out["launches"]), r
        assert out["held"]["agg_scan_fused"][1] == \
            out["launches"]["agg_scan_fused"]
        assert out["runs"] == ranks[0]["runs"], r
    run = ranks[0]["runs"][0]
    assert mesh_lib.records_match(run, one["runs"][0], 1e-4) is None
    assert run[1][1] == run[0][1]      # query_batch = query(), bit for bit


# ------------------------------------------------------------ the LM substrate

def _lm_on_card(n_layers=3, arch="qwen2-1.5b", **changes):
    """A reduced arch (by default qwen2: GQA, QKV bias, tied head) drawn on
    the CPU from a seeded generator, and its copy on the card."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers,
                              **changes)
    cpu = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, cpu, copy.deepcopy(cpu).to("cuda")


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_lm_prefill_plus_decode_reproduces_forward_on_card(cuda_device):
    cfg, _, model = _lm_on_card()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)).to(cuda_device)
    with _no_tf32():
        full, _, _ = model_lib.forward(model, cfg, toks, "train",
                                       compute_dtype=torch.float32)
        caches = model_lib.init_cache(cfg, 2, 32, dtype=torch.float32,
                                      device=cuda_device)
        logits, caches = model_lib.prefill(model, cfg, toks[:, :16], caches,
                                           compute_dtype=torch.float32)
        got = [logits]
        for t in range(16, 32):
            lg, caches, _ = model_lib.forward(model, cfg, toks[:, t:t + 1],
                                              "decode", caches, t,
                                              torch.float32)
            got.append(lg)
    torch.testing.assert_close(torch.cat(got, 1), full, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_lm_bf16_generate_repeats_bitwise_on_card(cuda_device):
    cfg, _, model = _lm_on_card()
    eng = ServeEngine(cfg, model, ServeConfig())
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    a = eng.generate(prompts, 16)
    b = eng.generate(prompts, 16)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 32) and a.min() >= 0 and a.max() < cfg.vocab_size


@pytest.mark.cuda
def test_lm_f32_logits_on_card_equal_the_cpu(cuda_device):
    cfg, cpu, model = _lm_on_card()
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want, _, _ = model_lib.forward(cpu, cfg, torch.from_numpy(toks),
                                   compute_dtype=torch.float32)
    with _no_tf32():
        got, _, _ = model_lib.forward(
            model, cfg, torch.from_numpy(toks).to(cuda_device),
            compute_dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def _train_stream(cfg):
    from repro_torch.data.tokens import DataConfig, SyntheticTokenStream
    return SyntheticTokenStream(DataConfig(cfg.vocab_size, 32, 4, seed=5))


def _train_batch(stream):
    return {k: torch.from_numpy(v) for k, v in stream.next_batch().items()
            if k in ("tokens", "labels")}


def _train(cfg, model, policy, compute_dtype, n_steps):
    """n_steps of make_train_step on `model` (in place): the losses and
    grad norms, and the optimizer state."""
    from repro_torch.train import optim as optim_lib
    from repro_torch.train import step as step_lib

    @dataclasses.dataclass(frozen=True)
    class Step(step_lib.StepConfig):
        @property
        def compute_dtype(self):
            return compute_dtype

    step_cfg = Step(policy=policy)
    opt_cfg = optim_lib.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=10)
    opt = optim_lib.init_opt_state(model.param_tree(),
                                   step_cfg.opt_config(opt_cfg))
    step = step_lib.make_train_step(cfg, opt_cfg, step_cfg)
    stream = _train_stream(cfg)
    out = []
    for _ in range(n_steps):
        _, opt, m = step(model, opt, _train_batch(stream))
        out.append((m["loss"].item(), m["grad_norm"].item(), m["lr"].item()))
    return out, opt


@pytest.mark.cuda
def test_lm_train_steps_on_card_equal_the_cpu(cuda_device):
    cfg, cpu, model = _lm_on_card()
    _hold_train_steps_to_cpu(cfg, cpu, model)


def _hold_train_steps_to_cpu(cfg, cpu, model, zero_gradient=()):
    """Three float32 train steps (loss, gradients, AdamW) on the card and
    on the CPU from the same weights and batches: the trajectories of loss,
    grad norm and lr within rtol 1e-4, and every parameter after them
    within rtol 1e-3, atol 1e-5. Exempt from that bound are the elements
    whose first-step gradient on the CPU is at most 1e-4 of its leaf's
    largest: float32 gradients carry about 1e-6 of the leaf's largest in
    rounding (against float64 on the CPU), and Adam's first update is
    sign-like (m/√v = ±1), so such an element may step either way on each
    device. They are held to twice the update clip (3) times the steps'
    summed lr, and their count is printed by leaf. So are all elements of
    a leaf whose gradient is zero (`zero_gradient`, path suffixes: its
    float32 rounding is all Adam sees)."""
    from repro_torch.checkpoint.ckpt import flatten_with_paths
    first = copy.deepcopy(cpu)
    leaves = flatten_with_paths(first.param_tree())
    loss, _ = model_lib.loss_fn(first, cfg, _train_batch(_train_stream(cfg)),
                                compute_dtype=torch.float32)
    g1 = torch.autograd.grad(loss, [p for _, p in leaves])
    want, _ = _train(cfg, cpu, "f32", torch.float32, 3)
    with _no_tf32():
        got, opt = _train(cfg, model, "f32", torch.float32, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert opt["step"].item() == 3 and opt["step"].is_cuda
    moved = 2 * 3.0 * sum(lr for _, _, lr in want)
    card = dict(flatten_with_paths(model.param_tree()))
    exempt = {}
    for (name, b), g in zip(flatten_with_paths(cpu.param_tree()), g1):
        a, b = card[name].detach().cpu(), b.detach()
        tie = g.abs() <= 1e-4 * g.abs().max()
        if name.endswith(tuple(zero_gradient)):
            tie = torch.ones_like(tie)
        exempt[name] = f"{int(tie.sum())}/{g.numel()}"
        torch.testing.assert_close(a[~tie], b[~tie], rtol=1e-3, atol=1e-5,
                                   msg=name)
        torch.testing.assert_close(a[tie], b[tie], rtol=0, atol=moved,
                                   msg=name)
    print("exempt from rtol 1e-3/atol 1e-5 (first-step |g| <= 1e-4 max):",
          exempt)


@pytest.mark.cuda
def test_lm_lowmem_train_steps_on_card_are_finite(cuda_device):
    """The lowmem policy on the card: bfloat16 parameters updated in
    place, int8 moments, bfloat16 compute; the losses finite."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), n_layers=3)
    model = model_lib.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0),
        torch.bfloat16)
    ptr = model.embed.data_ptr()
    got, opt = _train(cfg, model, "lowmem", torch.bfloat16, 3)
    assert np.isfinite(got).all()
    assert model.embed.dtype == torch.bfloat16 and \
        model.embed.data_ptr() == ptr
    assert opt["m"]["embed"]["q"].dtype == torch.int8
    assert opt["v"]["embed"]["scale"].is_cuda


# ------------------------------------------------------------ the LM's MoE

MOE_ARCH = "granite-moe-3b-a800m"


def _recorded_routes(monkeypatch):
    """Every `moe._route` call's gate_idx, on the host, in call order."""
    from repro_torch.models import moe as moe_lib
    seen = []
    route = moe_lib._route

    def recorded(p, xt, dims):
        out = route(p, xt, dims)
        seen.append(out[1].cpu())
        return out
    monkeypatch.setattr(moe_lib, "_route", recorded)
    return seen


@pytest.mark.cuda
def test_moe_f32_logits_and_routing_on_card_equal_the_cpu(cuda_device,
                                                         monkeypatch):
    """The reduced granite (8 experts top 2, capacity dropping): the same
    experts for every token on the card as on the CPU, and the logits
    within rtol/atol 1e-4 (TF32 off)."""
    cfg, cpu, model = _lm_on_card(arch=MOE_ARCH)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    seen = _recorded_routes(monkeypatch)
    want, _, want_aux = model_lib.forward(cpu, cfg, torch.from_numpy(toks),
                                          compute_dtype=torch.float32)
    n = len(seen)
    with _no_tf32():
        got, _, aux = model_lib.forward(
            model, cfg, torch.from_numpy(toks).to(cuda_device),
            compute_dtype=torch.float32)
    assert n == cfg.n_layers and len(seen) == 2 * n
    for layer, (a, b) in enumerate(zip(seen[:n], seen[n:])):
        assert torch.equal(a, b), f"layer {layer}: routing differs"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_moe_grouped_equals_global_with_ample_capacity_on_card(cuda_device):
    from repro_torch.models import moe as moe_lib
    dims = moe_lib.MoEDims(64, 32, 8, 2, 16.0, "grouped")
    moe = moe_lib.MoE(ParamFactory(torch.Generator(
        device=cuda_device).manual_seed(0)), dims)
    p = {n: t.detach() for n, t in moe.named_parameters()}
    x = torch.randn(4, 64, 64, device=cuda_device,
                    generator=torch.Generator(device=cuda_device
                                              ).manual_seed(1))
    with _no_tf32():
        y1, aux1 = moe_lib.apply_moe(p, x, dims)
        y2, aux2 = moe_lib.apply_moe(
            p, x, dataclasses.replace(dims, dispatch="global"))
    torch.testing.assert_close(y1, y2, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(aux1, aux2, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_moe_bf16_generate_repeats_bitwise_on_card(cuda_device):
    """No atomics in the dispatch or the combine: two bfloat16 generates
    give the same tokens, bit for bit."""
    cfg, _, model = _lm_on_card(arch=MOE_ARCH)
    eng = ServeEngine(cfg, model, ServeConfig())
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    a = eng.generate(prompts, 16)
    b = eng.generate(prompts, 16)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 32) and a.min() >= 0 and a.max() < cfg.vocab_size


@pytest.mark.cuda
def test_moe_train_steps_on_card_equal_the_cpu(cuda_device):
    """Three float32 steps of the reduced granite on the card and on the
    CPU, held as the dense model's are (above)."""
    cfg, cpu, model = _lm_on_card(arch=MOE_ARCH)
    _hold_train_steps_to_cpu(cfg, cpu, model)


# ------------------------------------------------------------ the recurrent mixers

RECURRENT = ["xlstm-125m", "jamba-v0.1-52b"]


def _recurrent_on_card(arch, **changes):
    """xlstm-125m reduced to two repeats of [mLSTM, sLSTM]; jamba-v0.1-52b
    to one period of 8 layers (Mamba chunk 16)."""
    n = 4 if arch == "xlstm-125m" else 8
    return _lm_on_card(n_layers=n, arch=arch, **changes)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_f32_logits_on_card_equal_the_cpu(cuda_device, arch):
    cfg, cpu, model = _recurrent_on_card(arch)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want, _, want_aux = model_lib.forward(cpu, cfg, torch.from_numpy(toks),
                                          compute_dtype=torch.float32)
    with _no_tf32():
        got, _, aux = model_lib.forward(
            model, cfg, torch.from_numpy(toks).to(cuda_device),
            compute_dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), torch.as_tensor(want_aux),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_plus_decode_reproduces_forward_on_card(
        cuda_device, arch):
    """The float32 states on the card: prefill 16 + decode 16 against the
    forward over 32 (jamba at capacity factor 8: nothing drops)."""
    cfg, _, model = _recurrent_on_card(arch, capacity_factor=8.0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)).to(cuda_device)
    with _no_tf32():
        full, _, _ = model_lib.forward(model, cfg, toks, "train",
                                       compute_dtype=torch.float32)
        caches = model_lib.init_cache(cfg, 2, 32, dtype=torch.bfloat16,
                                      device=cuda_device)
        logits, caches = model_lib.prefill(model, cfg, toks[:, :16], caches,
                                           compute_dtype=torch.float32)
        got = [logits]
        for t in range(16, 32):
            lg, caches, _ = model_lib.forward(model, cfg, toks[:, t:t + 1],
                                              "decode", caches, t,
                                              torch.float32)
            got.append(lg)
    for spec, cache in zip(cfg.pattern, caches):
        want = torch.bfloat16 if spec.mixer == "attn" else torch.float32
        assert all(leaf.dtype == want and leaf.is_cuda for leaf in cache)
    torch.testing.assert_close(torch.cat(got, 1), full, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_bf16_generate_repeats_bitwise_on_card(cuda_device, arch):
    cfg, _, model = _recurrent_on_card(arch)
    eng = ServeEngine(cfg, model, ServeConfig())
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    a = eng.generate(prompts, 16)
    b = eng.generate(prompts, 16)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 32) and a.min() >= 0 and a.max() < cfg.vocab_size


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_train_steps_on_card_equal_the_cpu(cuda_device, arch):
    """Three float32 steps on the card and on the CPU, held as the dense
    model's are (above); sLSTM's input-gate bias has no gradient (a
    constant added to i_t scales c and n alike) and is held as exempt."""
    cfg, cpu, model = _recurrent_on_card(arch)
    _hold_train_steps_to_cpu(cfg, cpu, model, zero_gradient=("slstm/b_i",))


# ------------------------------------------------------------ cross-attention and codebooks

XATTN_ARCHS = ["llama-3.2-vision-90b", "musicgen-large"]


def _xattn_on_card(arch):
    """The vision arch reduced to its 5-layer period, its xattn gates at
    0.5 (at the zero init the layer adds nothing); musicgen-large reduced
    to 2 layers. Drawn on the CPU from a seed, and a copy on the card."""
    n = 5 if arch == "llama-3.2-vision-90b" else 2
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=n)
    cpu = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in cpu.layers:
            if hasattr(layer, "xattn"):
                layer.xattn.gate.fill_(0.5)
    return cfg, cpu, copy.deepcopy(cpu).to("cuda")


def _xattn_inputs(cfg, seed, batch=2, seq=32):
    rng = np.random.default_rng(seed)
    shape = ((batch, cfg.n_codebooks, seq) if cfg.n_codebooks
             else (batch, seq))
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    vision = (rng.normal(0, 1, (batch, cfg.n_vision_tokens, cfg.d_vision))
              .astype(np.float32) if cfg.n_vision_tokens else None)
    return toks, vision


@pytest.mark.cuda
@pytest.mark.parametrize("arch", XATTN_ARCHS)
def test_xattn_codebook_f32_logits_on_card_equal_the_cpu(cuda_device, arch):
    cfg, cpu, model = _xattn_on_card(arch)
    toks, vision = _xattn_inputs(cfg, 3)
    vis = None if vision is None else torch.from_numpy(vision)
    want, _, _ = model_lib.forward(cpu, cfg, torch.from_numpy(toks),
                                   compute_dtype=torch.float32, vision=vis)
    with _no_tf32():
        got, _, _ = model_lib.forward(
            model, cfg, torch.from_numpy(toks).to(cuda_device),
            compute_dtype=torch.float32,
            vision=None if vis is None else vis.to(cuda_device))
    assert got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", XATTN_ARCHS)
def test_xattn_codebook_bf16_generate_repeats_bitwise_on_card(cuda_device,
                                                              arch):
    cfg, _, model = _xattn_on_card(arch)
    toks, vision = _xattn_inputs(cfg, 2, batch=4, seq=16)
    eng = ServeEngine(cfg, model, ServeConfig())
    a = eng.generate(toks, 16, vision)
    b = eng.generate(toks, 16, vision)
    np.testing.assert_array_equal(a, b)
    assert a.shape == toks.shape[:-1] + (32,)
    assert a.min() >= 0 and a.max() < cfg.vocab_size


@pytest.mark.cuda
@pytest.mark.parametrize("arch", XATTN_ARCHS)
def test_xattn_codebook_lowmem_train_steps_on_card_are_finite(cuda_device,
                                                              arch):
    """Two lowmem steps on the card (bfloat16 parameters, int8 moments):
    musicgen's batches of [B, K, T] codebook streams, the vision arch's
    with a float32 vision source; the losses finite."""
    from repro_torch.train import optim as optim_lib
    from repro_torch.train import step as step_lib
    n = 5 if arch == "llama-3.2-vision-90b" else 2
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=n)
    model = model_lib.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0),
        torch.bfloat16)
    step_cfg = step_lib.StepConfig(policy="lowmem")
    opt_cfg = optim_lib.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=10)
    opt = optim_lib.init_opt_state(model.param_tree(),
                                   step_cfg.opt_config(opt_cfg))
    step = step_lib.make_train_step(cfg, opt_cfg, step_cfg)
    losses = []
    for seed in (4, 5):
        toks, vision = _xattn_inputs(cfg, seed, batch=4, seq=33)
        batch = {"tokens": torch.from_numpy(toks[..., :-1]),
                 "labels": torch.from_numpy(toks[..., 1:])}
        if vision is not None:
            batch["vision"] = torch.from_numpy(vision)
        _, opt, m = step(model, opt, batch)
        losses.append(m["loss"].item())
    assert np.isfinite(losses).all() and opt["step"].item() == 2
    assert model.embed.dtype == torch.bfloat16
    assert opt["m"]["embed"]["q"].dtype == torch.int8


@pytest.mark.cuda
def test_full_width_cross_attention_gradients_on_card_equal_the_cpu(
        cuda_device):
    """llama-3.2-vision-90b's cross-attention at full width (d 8192, 64
    heads, 8 KV heads, dh 128) in float32, TF32 off, the gate at 0.5:
    x [2, 128, 8192] against a projected source [2, 1601, 8192]; the
    output and the gradients of wq, wk, wv, wo and the gate, card against
    CPU (rtol 1e-3, atol 1e-3 of each leaf's largest)."""
    from repro_torch.models import attention as attn_lib
    cfg = get_config("llama-3.2-vision-90b")
    dims = model_lib.attn_dims(cfg)
    layer = attn_lib.CrossAttention(
        ParamFactory(torch.Generator().manual_seed(5)), dims, cfg.d_model)
    with torch.no_grad():
        layer.gate.fill_(0.5)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0, 1, (2, 128, cfg.d_model)).astype(
        np.float32))
    src = torch.from_numpy(rng.normal(0, 1, (2, cfg.n_vision_tokens,
                                             cfg.d_model)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(0, 1, (2, 128, cfg.d_model)).astype(
        np.float32))

    def run(device):
        p = {k: v.detach().to(device).requires_grad_()
             for k, v in layer.named_parameters()}
        y = attn_lib.cross_attention(p, x.to(device), src.to(device), dims)
        grads = torch.autograd.grad((y * cot.to(device)).sum(),
                                    list(p.values()))
        return y.detach().cpu(), dict(zip(p, (g.cpu() for g in grads)))
    want_y, want_g = run("cpu")
    with _no_tf32():
        got_y, got_g = run(cuda_device)
    torch.testing.assert_close(got_y, want_y, rtol=1e-3,
                               atol=1e-3 * want_y.abs().max().item())
    assert sorted(want_g) == ["gate", "wk", "wo", "wq", "wv"]
    for name, w in want_g.items():
        assert w.abs().max() > 0, name
        torch.testing.assert_close(got_g[name], w, rtol=1e-3,
                                   atol=1e-3 * w.abs().max().item(),
                                   msg=name)


# ------------------------------------------------------------ the LM mesh

def _mesh_jobs():
    rng = np.random.default_rng(0)
    train = {"arch": "qwen2-1.5b", "overrides": {"vocab_size": 64,
                                                 "d_ff": 64},
             "batch": {k: rng.integers(0, 64, (8, 16)).astype(np.int32)
                       for k in ("tokens", "labels")},
             "opt": dict(lr=1e-2, warmup_steps=1, decay_steps=10),
             "model_axis": 2, "more": 4, "device": "cuda"}
    serve = {"arch": "qwen2-1.5b", "model_axis": 2, "attn_dp": True,
             "prompts": rng.integers(0, 128, (4, 8)).astype(np.int32),
             "n_new": 6, "device": "cuda"}
    return train, serve


@pytest.mark.cuda
def test_lm_mesh_step_and_sharded_decode_on_the_card(cuda_device):
    """qwen2 .reduced() (vocab 64, d_ff 64) on a (2, 2) mesh of 4 ranks on
    cuda:0 (gloo, collectives staged through host buffers), float32
    compute, TF32 off: step 0's loss (rtol 1e-5), every gradient leaf
    (1e-4 of its largest) and the grad norm against the single-device
    card step, the parameters after it, four more steps lowering the loss;
    and ServeEngine.generate over sharded caches (attn_dp: KV over batch
    and seq) equal to one card's tokens."""
    import lm_mesh_ranks as ranks
    from repro_torch.launch import mesh as mesh_lib
    train, serve = _mesh_jobs()
    res = mesh_lib.run_ranks(ranks.run_jobs, 4, [("train", train),
                                                 ("serve", serve)],
                             timeout=600.0)
    with _no_tf32():
        want = ranks.one_device(train)
        engine = ServeEngine(ranks.config(serve),
                             ranks.model_for(serve, "cuda"),
                             ServeConfig(batch=4), ranks.F32Step())
        tokens = engine.generate(serve["prompts"], serve["n_new"])
    ranks.hold_step([r[0] for r in res], want, 1e-4, "card (2, 2)")
    for r in res:
        np.testing.assert_array_equal(r[1]["tokens"], tokens)
