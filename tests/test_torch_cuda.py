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
@pytest.mark.parametrize("q, n_groups", [(1, 1), (7, 6), (64, 500)])
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
    db = BlinkDB(EngineConfig(k1=800.0, m=3), device=cuda_device)
    db.register_table("sessions", table_lib.from_columns(
        "sessions", synth.sessions_table(20_000, seed=3)))
    db.add_family("sessions", ())
    q = Query("sessions", AggOp.COUNT, predicate=Predicate.where(
        *[Atom("dt", CmpOp.GE, i % 3) for i in range(128)]))
    before = agg_scan.agg_scan_fused_cuda.launches
    with pytest.raises(NotImplementedError, match="at most 127"):
        db.query(q)
    assert agg_scan.agg_scan_fused_cuda.launches == before
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
@pytest.mark.parametrize("n_groups", [1, 6, 500])
def test_quantile_kernel_matches_plain_and_repeats_bitwise(cuda_device,
                                                           n_groups):
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
@pytest.mark.parametrize("q, n_groups", [(7, 6), (64, 500)])
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
