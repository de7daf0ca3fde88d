"""The port's multi-device path: BlinkDB(mesh=) over torch.distributed.

One process per data shard (gloo, on the CPU here): each rank keeps its
row of the reference's [S, n_local] block and scans it with the same
kernels' plain versions; the partials are all-gathered and summed in shard
order. Held here:
  * without processes, each rank's stripe against the reference's
    stripe_family(fam, S) row for row, after an append and a tombstone too,
    and the subsample codes by rank;
  * with repro_torch.launch.mesh.run_ranks, worlds of 2 and 4 ranks (one
    spawn each, every case in it): answers bit-identical across ranks, and
    family, K and group keys equal to the port on one device, estimates
    within rtol 1e-4; a world-1 mesh in this process equal to no mesh bit
    for bit;
  * the reference's own 4-device mesh path (tests/test_distributed.py's
    setup, in a subprocess with 4 host devices) against the port's world-4
    answers: family, K and keys exact, estimates within rtol 1e-4.
Every wait is bounded (run_ranks' timeout, the subprocess's).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import executor as ref_exec
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.core import types as ref_types
from repro.data import synth as ref_synth
from repro_torch import state
from repro_torch.core import (AggOp, Atom, CmpOp, ErrorBound, Predicate,
                              Query)
from repro_torch.core import executor as exec_lib
from repro_torch.core import sampling as samp
from repro_torch.core import table as table_lib
from repro_torch.data import synth
from repro_torch.fault.inject import FaultSpec
from repro_torch.launch import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
# tests/test_distributed.py::test_blinkdb_sharded_query_matches_single_device
N_ROWS, TABLE_SEED, SEED, K1, M = 40_000, 2, 3, 800.0, 3
WORLDS = (2, 4)
JOIN_S = 150.0


# -- stripes, without processes ------------------------------------------------

def _families(n=3000):
    """The reference's and the port's (OS,) family of one table, built from
    the same units, with their tables."""
    raw = ref_synth.sessions_table(n, seed=1)
    tabs = (ref_table.from_columns("s", raw),
            table_lib.from_columns("s", synth.sessions_table(n, seed=1)))
    u = ref_samp.base_units(n, 4)
    return tabs, (ref_samp.build_family(tabs[0], ("OS",), 150.0, m=3, units=u),
                  samp.build_family(tabs[1], ("OS",), 150.0, m=3, units=u))


def _assert_rows(ref_block, stripes, label):
    """Each rank's stripe equals its row of the reference block."""
    want_all = {"unit": ref_block.unit, "strat": ref_block.strat,
                "valid": ref_block.valid, "columns": ref_block.columns}
    for r, got in enumerate(stripes):
        want = state.shard_row(want_all, r)
        assert got.n_local == ref_block.n_local, label
        for f in ("unit", "strat", "valid"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                          err_msg=f"{label} rank {r} {f}")
        assert set(got.columns) == set(want["columns"]), label
        for c, a in got.columns.items():
            np.testing.assert_array_equal(a.numpy(), want["columns"][c],
                                          err_msg=f"{label} rank {r} {c}")
        np.testing.assert_array_equal(got.freq_table.numpy(),
                                      np.asarray(ref_block.freq_table))
        np.testing.assert_array_equal(got.slot_row_ids,
                                      ref_block.slot_row_ids)
        assert (got.n_rows, got.n_ghosts, got.table_rows, got.capacity) == (
            ref_block.n_rows, ref_block.n_ghosts, ref_block.table_rows,
            ref_block.capacity), label


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_each_rank_holds_its_row_of_the_reference_block(n_shards):
    """stripe_family(fam, device, S, r) is row r of the reference's
    stripe_family(fam, S): every column, unit, strat and valid, and the
    host mirrors; so is each rank's stripe_append of an append delta and
    stripe_tombstone of a delete. S = 1 is the one-device block."""
    (rt, pt), (ra, pa) = _families()
    rs = ref_exec.stripe_family(ra, n_shards)
    ps = [exec_lib.stripe_family(pa, "cpu", n_shards=n_shards, shard=r)
          for r in range(n_shards)]
    _assert_rows(rs, ps, "stripe")
    if n_shards == 1:
        whole = exec_lib.stripe_family(pa, "cpu")
        assert torch.equal(whole.unit, ps[0].unit)
        assert whole.shape_class == ps[0].shape_class

    raw = synth.sessions_table(120, seed=9)
    d_ref, d_port = rt.append(raw), pt.append(raw)
    units = samp.delta_units(d_port.n_rows, 4, 1)
    ma, ba = ref_samp.merge_family(ra, d_ref.columns, units,
                                   start_row=d_ref.start_row)
    mb, bb = samp.merge_family(pa, d_port.columns, units,
                               start_row=d_port.start_row)
    rs = ref_exec.stripe_append(rs, ma, ba)
    ps = [exec_lib.stripe_append(p, mb, bb) for p in ps]
    assert rs is not None and all(p is not None for p in ps)
    assert bb.n_rows > n_shards
    _assert_rows(rs, ps, "append")

    mut_r = rt.delete(ref_types.Predicate.where(
        ref_types.Atom("dt", ref_types.CmpOp.LT, 7)))
    mut_p = pt.delete(Predicate.where(Atom("dt", CmpOp.LT, 7)))
    ta, tba = ref_samp.apply_tombstones(ma, mut_r.tombstoned,
                                        mut_r.tombstoned_columns)
    tb, tbb = samp.apply_tombstones(mb, mut_p.tombstoned,
                                    mut_p.tombstoned_columns)
    assert tbb.n_sampled > n_shards
    rs = ref_exec.stripe_tombstone(rs, tba.row_ids, table_rows=ta.table_rows)
    ps = [exec_lib.stripe_tombstone(p, tbb.row_ids, table_rows=tb.table_rows)
          for p in ps]
    _assert_rows(rs, ps, "tombstone")

    for r in range(n_shards):
        np.testing.assert_array_equal(
            exec_lib.subsample_codes(n_shards, rs.n_local, 32)[r],
            state.shard_row(ref_exec.subsample_codes(n_shards, rs.n_local,
                                                     32), r))


# -- the engine over a mesh, in spawned ranks -----------------------------------

def _queries():
    t = "s"
    genre = Predicate.where(Atom("Genre", CmpOp.EQ, "genre03"))
    grouped = (
        Query(t, AggOp.COUNT, predicate=genre, group_by=("OS",),
              bound=ErrorBound(0.1)),
        Query(t, AggOp.SUM, "SessionTime", group_by=("OS",),
              bound=ErrorBound(0.1)),
        Query(t, AggOp.AVG, "SessionTime", group_by=("OS",),
              bound=ErrorBound(0.1)),
        Query(t, AggOp.AVG, "Bitrate",
              predicate=Predicate.where(Atom("dt", CmpOp.LT, 15)),
              bound=ErrorBound(0.05)))
    quantile = (
        Query(t, AggOp.QUANTILE, "SessionTime", quantile=0.5,
              group_by=("OS",), bound=ErrorBound(0.1)),
        Query(t, AggOp.QUANTILE, "Bitrate", quantile=0.9,
              bound=ErrorBound(0.1)))
    return grouped, quantile


def _session() -> mesh_lib.Session:
    grouped, quantile = _queries()
    lose_shard1 = (FaultSpec(site="shard.scan", kind="kill",
                             match=(("shard", 1),)),)
    return mesh_lib.Session(
        "s", {"k1": K1, "m": M, "seed": SEED}, (
            mesh_lib.Step("grouped", "query", grouped),
            mesh_lib.Step("quantile", "query", quantile),
            mesh_lib.Step("batch", "batch", grouped + quantile),
            mesh_lib.Step("subsampled", "subsampled",
                          grouped[1:3] + quantile[:1]),
            mesh_lib.Step("faults", "faults", grouped, faults=lose_shard1),
            mesh_lib.Step("append", "append", grouped[:3],
                          rows=synth.sessions_table(2000, seed=7))),
        families=(("OS",), ()), n_rows=N_ROWS, table_seed=TABLE_SEED,
        units={("OS",): ref_samp.base_units(N_ROWS, SEED),
               (): ref_samp.base_units(N_ROWS, SEED, uniform=True)},
        device="cpu")


_REFERENCE_MESH = """
import json
import jax
from repro.core import (AggOp, Atom, BlinkDB, CmpOp, EngineConfig,
                        ErrorBound, Predicate, Query)
from repro.core import table as table_lib
from repro.data import synth

assert jax.device_count() == 4
db = BlinkDB(EngineConfig(k1={k1}, m={m}, seed={seed}),
             mesh=jax.make_mesh((4,), ("data",)))
db.register_table("s", table_lib.from_columns(
    "s", synth.sessions_table({n}, seed={tseed})))
db.add_family("s", ("OS",))
db.add_family("s", ())
t = "s"
genre = Predicate.where(Atom("Genre", CmpOp.EQ, "genre03"))
qs = [Query(t, AggOp.COUNT, predicate=genre, group_by=("OS",),
            bound=ErrorBound(0.1)),
      Query(t, AggOp.SUM, "SessionTime", group_by=("OS",),
            bound=ErrorBound(0.1)),
      Query(t, AggOp.AVG, "SessionTime", group_by=("OS",),
            bound=ErrorBound(0.1)),
      Query(t, AggOp.AVG, "Bitrate",
            predicate=Predicate.where(Atom("dt", CmpOp.LT, 15)),
            bound=ErrorBound(0.05))]
out = []
for q in qs:
    a = db.query(q)
    out.append([list(a.sample_phi), a.sample_k,
                [[list(g.key), g.estimate, g.exact] for g in a.groups]])
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The session on one device, over a world-1 mesh in this process, and
    in spawned worlds of 2 and 4 ranks; beside them the reference's
    4-device mesh answers, from a subprocess started first."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE_MESH.format(
            k1=K1, m=M, seed=SEED, n=N_ROWS, tseed=TABLE_SEED))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        session = _session()
        out = {"single": mesh_lib.run_session(session)["runs"][0]}
        with mesh_lib.process_group(
                0, 1, str(tmp_path_factory.mktemp("world1") / "store")):
            mesh = mesh_lib.make_host_mesh()
            out["world1"] = mesh_lib.run_session(session, mesh)["runs"][0]
            out["axes"] = [exec_lib.mesh_axes(mesh, axes)
                           for axes in (("data",), ("data", "model"))]
        for world in WORLDS:
            out[world] = [r["runs"][0] for r in mesh_lib.run_ranks(
                mesh_lib.session_rank, world, session, timeout=JOIN_S)]
        stdout, stderr = ref.communicate(timeout=JOIN_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait(10)
    assert ref.returncode == 0, stderr
    line = [s for s in stdout.splitlines() if s.startswith("RESULT ")][-1]
    out["reference_mesh4"] = json.loads(line[len("RESULT "):])
    return out


def _step(records, label):
    return [r for r in records if r[0] == label]


CASES = ("grouped", "quantile", "batch", "subsampled", "faults", "append")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_mesh_answers_agree_across_ranks_and_with_one_device(runs, world,
                                                             case):
    """Every rank returns the same bits; family, K, rows, certification,
    degradation and group keys equal the port's on one device, estimates
    within rtol 1e-4."""
    ranks = runs[world]
    assert len(ranks) == world
    first = _step(ranks[0], case)
    assert first and all(first[0][1])
    for r, other in enumerate(ranks[1:], 1):
        diff = mesh_lib.records_match(first, _step(other, case), 0.0)
        assert diff is None, f"rank {r}: {diff}"
    diff = mesh_lib.records_match(first, _step(runs["single"], case), RTOL)
    assert diff is None, diff
    answers = first[0][1]
    if case == "faults":
        # shard 1 lost on every replica: each sampled answer is degraded,
        # 1 of 4 logical shards lost (an exact fallback scans the table)
        sampled = [a for a in answers if a[0] != ("<exact>",)]
        assert len(sampled) >= 3
        assert all(a[5] and a[6] == 1 for a in sampled)
    if case == "batch":
        # query_batch on the same engine: query()'s bits
        assert answers == [a for label in ("grouped", "quantile")
                           for a in _step(ranks[0], label)[0][1]]


def test_world1_mesh_gives_the_bits_of_no_mesh(runs):
    """A world-1 mesh: the stripe is the whole block and the merge sums
    one partial, so every answer has the bits of the one-device engine.
    One or several data axes resolve to the same group of one shard."""
    assert mesh_lib.records_match(runs["world1"], runs["single"], 0.0) is None
    assert [(a.n_shards, a.shard) for a in runs["axes"]] == [(1, 0), (1, 0)]
    assert {s[0] for s in runs["world1"]} == set(CASES)


def test_world4_matches_the_references_mesh_path(runs):
    """The reference's shard_map path on 4 host devices and the port's 4
    ranks (the reference's units): family, K and group keys exact,
    estimates within rtol 1e-4."""
    got = _step(runs[4][0], "grouped")[0][1]
    want = runs["reference_mesh4"]
    assert len(got) == len(want) == 4
    for a, (phi, k, groups) in zip(got, want):
        assert a[0] == tuple(phi) and a[1] == k
        assert [g[0] for g in a[7]] == [tuple(g[0]) for g in groups]
        for g, (_, est, exact) in zip(a[7], groups):
            assert g[6] == exact
            np.testing.assert_allclose(g[1], est, rtol=RTOL)


def test_mesh_must_be_a_device_mesh_and_ranks_fail_loudly():
    """A mesh that is not a DeviceMesh is refused; a rank that raises
    fails run_ranks with its traceback, and the other ranks are stopped."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        exec_lib.mesh_axes(object())
    bad = mesh_lib.Session("s", {"k1": K1, "m": M},
                           (mesh_lib.Step("bad", "no such step"),),
                           n_rows=500, device="cpu")
    with pytest.raises(mesh_lib.RankError, match="unknown step kind"):
        mesh_lib.run_ranks(mesh_lib.session_rank, 2, bad, timeout=JOIN_S)


def test_held_to_plain_holds_each_launch_and_carries_the_counts(monkeypatch):
    """held_to_plain runs each wrapper call's plain version beside it: a
    wrapper that agrees is recorded and keeps counting its launches (the
    count comes back to the wrapper on exit), one that disagrees raises.
    The card's wrappers are stood in for by plain float32 launches."""
    from repro_torch.kernels import agg_scan, ref

    def stand_in(scale):
        def fn(*args, **kw):
            agg_scan.count_launch(agg_scan.agg_scan_cuda)
            return ref.agg_scan_ref(*args, **kw) * scale
        fn.launches = 0
        return fn

    rng = np.random.default_rng(0)
    args = (torch.from_numpy(rng.normal(5, 2, 1000).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.1, 1, 1000).astype(np.float32)),
            torch.from_numpy(rng.random(1000) < 0.5),
            torch.from_numpy(rng.integers(0, 6, 1000).astype(np.int8)), 6)
    monkeypatch.setattr(agg_scan, "agg_scan_cuda", stand_in(1.0))
    worst = {}
    with mesh_lib.held_to_plain(worst):
        agg_scan.agg_scan_cuda(*args)
        agg_scan.agg_scan_cuda(*args)
    assert agg_scan.agg_scan_cuda.launches == 2
    assert worst["agg_scan"][1] == 2 and 0.0 <= worst["agg_scan"][0] < 0.1
    assert mesh_lib.launch_counts()["agg_scan"] == 2
    monkeypatch.setattr(agg_scan, "agg_scan_cuda", stand_in(1.01))
    with pytest.raises(AssertionError, match="plain version"):
        with mesh_lib.held_to_plain({}):
            agg_scan.agg_scan_cuda(*args)
