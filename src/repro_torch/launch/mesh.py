"""Data meshes over torch.distributed (counterpart of `repro.launch.mesh`).

The reference runs one controller over a `jax.sharding.Mesh`; the port runs
one process per data shard (SPMD), each holding the whole engine but only
its own stripe of every family (core/executor.py). This module starts such
processes and gives them their mesh:

    results = run_ranks(session_rank, 4, session, timeout=120.0)

`run_ranks` spawns `world` fresh interpreters (never forked: the parent
may hold jax or a CUDA context), joins them in a gloo group through a
`file://` store in a temporary directory (no port to collide on), runs
`target(*args)` in each and returns the results by rank. A failed or late
rank stops them all and its traceback is raised here. On a card the kernel
libraries are built once in the parent before the ranks start, and every
rank scans on the engine's device (on a one-card machine, that card).

`make_production_mesh` gives the reference's (16, 16) or (2, 16, 16) mesh
over a world of that size (the dry run reads its extents by name from
`production_mesh_shape`).

`Session` and `run_session` describe and run one engine workload, the same
on every rank; `session_rank` is the rank target that runs it over
`make_host_mesh()`, and `run_session(session)` runs it on one device. With
`check_plain` every launch of the engine path's kernels is also held
against its plain version on the same tensors. Importing this module
starts nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import multiprocessing
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Mapping, Sequence

import numpy as np
import torch


# The reference's production meshes (a TPU pod of 16 x 16 chips, and two
# pods), by name: the dry run places every cell on these extents.
PRODUCTION_MESHES = {
    "pod": {"data": 16, "model": 16},
    "multipod": {"pod": 2, "data": 16, "model": 16},
}


def production_mesh_shape(multi_pod: bool = False) -> dict[str, int]:
    """{axis name: extent} of the production mesh."""
    return dict(PRODUCTION_MESHES["multipod" if multi_pod else "pod"])


def make_production_mesh(multi_pod: bool = False):
    """The production mesh over the initialized default process group:
    (16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model").
    Raises a ValueError naming the world it needs on any other world (a
    world of 1 without a process group)."""
    import torch.distributed as dist
    shape = production_mesh_shape(multi_pod)
    need = int(np.prod(list(shape.values())))
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world != need:
        raise ValueError(f"the production mesh {tuple(shape.values())} "
                         f"{tuple(shape)} needs a world of {need} ranks; "
                         f"this one has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def make_host_mesh(model: int = 1):
    """A (data, model) DeviceMesh of device type "cpu" (its groups are
    gloo's) over the initialized default process group: world // model
    data shards of `model` ranks each."""
    from torch.distributed import get_world_size
    from torch.distributed.device_mesh import init_device_mesh
    world = get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"model={model} does not divide the world of "
                         f"{world} ranks")
    return init_device_mesh("cpu", (world // model, model),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def process_group(rank: int, world: int, store: str,
                  timeout_s: float = 300.0):
    """The default gloo process group of `world` ranks over the file store
    `store` (a path no earlier group used), destroyed on exit."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(target: Callable, rank: int, world: int, out_dir: str,
               args: tuple, timeout_s: float) -> None:
    """One rank: join the group, run the target, write its result (or its
    traceback) under out_dir."""
    try:
        with process_group(rank, world, os.path.join(out_dir, "store"),
                           timeout_s):
            result = target(*args)
        path = os.path.join(out_dir, f"result{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


class RankError(RuntimeError):
    """A rank of run_ranks failed or did not finish in time."""


def run_ranks(target: Callable, world: int, *args,
              timeout: float = 300.0) -> list:
    """Run target(*args) in `world` spawned ranks of one gloo group and
    return the results in rank order. `target` must be importable by a
    fresh interpreter: a function of a module of this package (or of a
    script that guards its entry point); its arguments and result are
    pickled. Every wait is bounded by `timeout` seconds: on a rank's
    failure or at the timeout every rank is killed, and RankError carries
    the failed rank's traceback."""
    if torch.cuda.is_available():
        # One build for all ranks (each rank then loads the libraries).
        from repro_torch.kernels import agg_scan
        agg_scan.build_all()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mesh-") as out_dir:
        procs = [ctx.Process(target=_rank_main, name=f"rank{rank}",
                             args=(target, rank, world, out_dir, args,
                                   timeout))
                 for rank in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            running = list(procs)
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RankError(
                        f"ranks {[p.name for p in running]} did not finish "
                        f"within {timeout:.0f}s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in running], timeout=left)
                for rank, p in enumerate(procs):
                    if p.exitcode not in (None, 0):
                        raise RankError(_failure(out_dir, rank, p.exitcode))
                running = [p for p in running if p.exitcode is None]
            results = []
            for rank in range(world):
                with open(os.path.join(out_dir, f"result{rank}.pkl"),
                          "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10.0)


def _failure(out_dir: str, rank: int, exitcode: int) -> str:
    path = os.path.join(out_dir, f"error{rank}.txt")
    tb = (open(path).read() if os.path.exists(path)
          else "(no traceback: the rank was killed)")
    return f"rank {rank} exited with code {exitcode}:\n{tb}"


# ---------------------------------------------------------------------------
# One engine workload, the same on every rank
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Step:
    """One step of a Session. `kind` is "query" (each of `queries` through
    BlinkDB.query), "batch" (all of them through one query_batch),
    "subsampled" (query() on a second engine built as the first, with
    ci_method="subsampling"), "faults" (query() under a FaultPlan of the
    FaultSpecs `faults`, seed 0) or "append" (append_rows of the raw
    columns `rows`, then query() of `queries`)."""
    label: str
    kind: str
    queries: tuple = ()
    rows: Mapping[str, np.ndarray] | None = None
    faults: tuple = ()


@dataclasses.dataclass(frozen=True)
class Session:
    """An engine workload: a table (synth.sessions_table(n_rows,
    table_seed), or a pickled (Table, {phi: SampleFamily}) file `source`),
    its families (built from `units` where given, else from the config's
    seed), then `steps`, all of it `runs` times from scratch."""
    table: str
    config: Mapping
    steps: tuple[Step, ...]
    families: tuple[tuple[str, ...], ...] = ()
    n_rows: int = 0
    table_seed: int = 0
    units: Mapping | None = None
    source: str | None = None
    device: str | None = None
    runs: int = 1
    check_plain: bool = False


def answer_record(ans) -> tuple:
    """An Answer as plain values, to compare across ranks and runs: its
    family, K, rows read, contract flags, degradation and groups."""
    return (ans.sample_phi, ans.sample_k, ans.rows_read, ans.bound_met,
            ans.certified, ans.degraded, ans.shards_lost,
            tuple((g.key, g.estimate, g.stderr, g.ci_low, g.ci_high,
                   g.n_selected, g.exact) for g in ans.groups))


def _engine(session: Session, mesh, **overrides):
    """A fresh engine over the session's table and families, its config
    the session's with `overrides`."""
    from repro_torch import state
    from repro_torch.core import BlinkDB, EngineConfig
    from repro_torch.core import table as table_lib
    from repro_torch.data import synth
    db = BlinkDB(EngineConfig(**{**session.config, **overrides}),
                 device=session.device, mesh=mesh)
    if session.source is not None:
        with open(session.source, "rb") as f:
            tbl, fams = pickle.load(f)
        db.register_table(session.table, tbl)
        state.adopt_families(db, session.table, fams)
        return db
    db.register_table(session.table, table_lib.from_columns(
        session.table, synth.sessions_table(session.n_rows,
                                            seed=session.table_seed)))
    if session.units is not None:
        state.install_families(db, session.table, session.units)
    for phi in session.families:
        if session.units is None or phi not in session.units:
            db.add_family(session.table, phi)
    return db


def _run_step(db, session: Session, step: Step, mesh) -> list:
    from repro_torch.fault import inject
    from repro_torch.fault.inject import FaultPlan
    if step.kind == "query":
        return [db.query(q) for q in step.queries]
    if step.kind == "batch":
        return db.query_batch(list(step.queries))
    if step.kind == "subsampled":
        sub = _engine(session, mesh, ci_method="subsampling")
        return [sub.query(q) for q in step.queries]
    if step.kind == "faults":
        with inject.arm(FaultPlan(list(step.faults), seed=0)):
            return [db.query(q) for q in step.queries]
    if step.kind == "append":
        db.append_rows(session.table, step.rows)
        return [db.query(q) for q in step.queries]
    raise ValueError(f"unknown step kind {step.kind!r}")


# The kernels of the engine's path and their plain versions (kernels.ref).
_ENGINE_KERNELS = ("agg_scan_fused", "quantile_scan", "agg_scan")
PLAIN_RTOL, PLAIN_ATOL = 2e-5, 1e-3      # the reference's kernel tolerance


@contextlib.contextmanager
def held_to_plain(worst: dict):
    """While active, every launch of the engine path's three kernel
    wrappers also runs its plain version on the same tensors (sums in
    float64) and is held to it (rtol 2e-5, atol 1e-3): worst[name] =
    [max |diff|, launches held]. A wrapper counts its launches on the
    module attribute it is bound to (agg_scan.count_launch), so the holding
    wrapper starts from its count (functools.wraps copies it) and hands it
    back on exit; the plain versions launch no kernel."""
    from repro_torch.kernels import agg_scan, ref
    saved = {name: getattr(agg_scan, f"{name}_cuda")
             for name in _ENGINE_KERNELS}

    def flat(out):
        return (torch.cat([t.flatten() for t in out])
                if isinstance(out, tuple) else out.flatten())

    def held(name, fn):
        plain = getattr(ref, f"{name}_ref")

        @functools.wraps(fn)
        def call(*args, **kw):
            out = fn(*args, **kw)
            got = flat(out)
            want = flat(plain(*args, **kw, accumulate=torch.float64))
            diff = (got - want).abs().max().item() if got.numel() else 0.0
            if not torch.allclose(got, want, rtol=PLAIN_RTOL,
                                  atol=PLAIN_ATOL):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: max |diff| {diff}")
            w = worst.setdefault(name, [0.0, 0])
            w[0], w[1] = max(w[0], diff), w[1] + 1
            return out
        return call

    for name, fn in saved.items():
        setattr(agg_scan, f"{name}_cuda", held(name, fn))
    try:
        yield worst
    finally:
        for name, fn in saved.items():
            fn.launches = getattr(agg_scan, f"{name}_cuda").launches
            setattr(agg_scan, f"{name}_cuda", fn)


def launch_counts() -> dict[str, int]:
    """The engine path's kernel wrappers' launch counts."""
    from repro_torch.kernels import agg_scan
    return {name: getattr(agg_scan, f"{name}_cuda").launches
            for name in _ENGINE_KERNELS}


def _timed_step(db, session: Session, step: Step, mesh) -> tuple:
    """(answers, seconds) of one step under a trace of its own: the step's
    host-clock wall time (device synchronised), its outermost "scan"
    spans' and its "mesh.gather" spans' seconds, and the gathers."""
    from repro_torch.obs import trace as obs_trace
    tr = obs_trace.QueryTrace(step.label, "mesh session")
    t0 = time.perf_counter()
    with obs_trace.activate(tr):
        answers = _run_step(db, session, step, mesh)
    db._sync()
    wall = time.perf_counter() - t0
    tr.finish()
    gathers = tr.find("mesh.gather")
    return answers, {"wall_s": wall, "scan_s": tr.timings().get("scan", 0.0),
                     "gather_s": sum(s.dur_s for s in gathers),
                     "gathers": len(gathers)}


def run_session(session: Session, mesh=None) -> dict:
    """Run the session (over `mesh`, or on one device) →
    {"runs": per run, per step, (label, [answer_record of each answer]),
     "seconds": per run, per step, _timed_step's seconds,
     "launches": the engine path's kernel launches during the session,
     "held": held_to_plain's record (empty without check_plain)}."""
    before, worst = launch_counts(), {}
    runs, seconds = [], []
    with (held_to_plain(worst) if session.check_plain
          else contextlib.nullcontext()):
        for _ in range(session.runs):
            db = _engine(session, mesh)
            steps = [(step.label, *_timed_step(db, session, step, mesh))
                     for step in session.steps]
            runs.append([(label, [answer_record(a) for a in answers])
                         for label, answers, _ in steps])
            seconds.append([(label, secs) for label, _, secs in steps])
    after = launch_counts()
    return {"runs": runs, "seconds": seconds, "held": worst,
            "launches": {k: after[k] - before[k] for k in after}}


def session_rank(session: Session) -> dict:
    """run_ranks target: run_session over make_host_mesh()."""
    return run_session(session, make_host_mesh())


def records_match(a: Sequence, b: Sequence, rtol: float) -> str | None:
    """Compare the steps of two run_session runs: equal families, Ks, rows
    read, certification, degradation, group keys and exactness, estimates
    within rtol (0.0: every value in equal bits). Returns the first
    difference, or None."""
    for (la, ra), (lb, rb) in zip(a, b, strict=True):
        for i, (x, y) in enumerate(zip(ra, rb, strict=True)):
            if rtol == 0.0:
                if x != y:
                    return f"{la}[{i}]: {x} != {y}"
                continue
            if x[:3] != y[:3] or x[4:7] != y[4:7]:
                return f"{la}[{i}]: plan {x[:7]} != {y[:7]}"
            if [g[0] for g in x[7]] != [g[0] for g in y[7]]:
                return f"{la}[{i}]: group keys differ"
            for gx, gy in zip(x[7], y[7]):
                if gx[6] != gy[6] or not np.allclose(
                        gx[1], gy[1], rtol=rtol, atol=0.0):
                    return f"{la}[{i}] group {gx[0]}: {gx} vs {gy}"
    return None
