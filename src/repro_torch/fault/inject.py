"""Deterministic fault injection for the serving path (counterpart of
`repro.fault.inject`, pure Python and numpy; docs/FAULTS.md).

A `FaultPlan` is a seeded schedule of `FaultSpec`s. Code that can fail in
production declares *named sites* — `inject.site("shard.scan", shard=2,
replica=0)` — which are no-ops (one module-global read) unless a plan is
armed. An armed plan decides, deterministically given its seed and the
sequence of visits, whether each visit fires a fault:

  * ``kill``   — raise `InjectedFault` at the site (a dead shard, a crashed
                 engine call, a dispatcher thread hitting an unexpected
                 exception);
  * ``delay``  — sleep `delay_s` before the site's work (a straggler);
  * ``poison`` — the site's caller corrupts the result with NaNs (silent
                 data corruption the detection layer must catch — the site
                 returns the string "poison" and the caller applies it).

Sites currently wired (the serving path's fault domains):

  * ``engine.scan``        — every BlinkDB scan (_run_at_k's, the quantile
                             scan's, the subsampled ones, _batched_scan's),
                             before its launch (ctx: table);
  * ``shard.scan``         — executor.run_sharded_scan, once per
                             (logical shard, replica) attempt (ctx: shard,
                             replica, table);
  * ``scheduler.dispatch`` — BlinkQLService dispatcher loop, once per
                             iteration while the collected batch is held.

Determinism: each spec keeps its own visit counter and `numpy` Generator
seeded from (plan.seed, spec index), so two runs of the same single-threaded
execution under equal plans fire identically, in this package and in the
reference alike. Engine execution is serialized
(the service's execution lock), so engine/shard sites are visited in a
deterministic order even under concurrent sessions; `p=1.0` specs are
counter-based and deterministic regardless of threading.

Arming is process-global and exclusive (one plan at a time) — the fault
layer models the *environment*, which a process has exactly one of.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np


class FaultError(RuntimeError):
    """Base of every fault-layer error: injected faults and the failures the
    detection layer synthesizes from them (lost shards, poisoned partials).
    The degradation ladder treats any FaultError as transient."""


class InjectedFault(FaultError):
    """A kill-type fault fired at an injection site."""

    def __init__(self, site: str, spec_index: int, context: dict):
        self.site = site
        self.spec_index = spec_index
        self.context = dict(context)
        super().__init__(f"injected kill at {site!r} (spec {spec_index}, "
                         f"ctx {self.context})")


class ShardScanError(FaultError):
    """One (shard, replica) scan attempt failed or was disqualified
    (straggler deadline, non-finite partial)."""


class AllShardsLostError(FaultError):
    """Every logical shard lost every replica: no partial survives, so no
    reweighted estimate exists."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault rule.

    `match` filters on the site's context kwargs: every (key, value) pair
    must equal the visit's context (missing keys never match). `after`
    skips the first eligible visits; `p` is the per-visit fire probability
    (1.0 = counter-deterministic); `max_fires` caps total fires (None =
    unlimited).
    """
    site: str
    kind: str                         # "kill" | "delay" | "poison"
    match: tuple[tuple[str, object], ...] = ()
    p: float = 1.0
    after: int = 0
    max_fires: int | None = None
    delay_s: float = 0.02

    def __post_init__(self):
        if self.kind not in ("kill", "delay", "poison"):
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def matches(self, ctx: dict) -> bool:
        return all(k in ctx and ctx[k] == v for k, v in self.match)


class FaultPlan:
    """A seeded, deterministic fault schedule. Thread-safe; falsy when it
    holds no specs (the engagement rule: an armed EMPTY plan changes
    nothing, preserving bit-identical answers)."""

    def __init__(self, specs: tuple[FaultSpec, ...] | list[FaultSpec] = (),
                 seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._visits = [0] * len(self.specs)
        self._fires = [0] * len(self.specs)
        self._rngs = [np.random.default_rng((self.seed, i))
                      for i in range(len(self.specs))]
        self.log: list[tuple[str, int, str]] = []   # (site, spec idx, kind)

    def __bool__(self) -> bool:
        return bool(self.specs)

    @property
    def n_fires(self) -> int:
        with self._lock:
            return sum(self._fires)

    def visit(self, site: str, ctx: dict) -> list[tuple[int, FaultSpec]]:
        """Record one visit; return the specs that fire on it (plan order)."""
        fired: list[tuple[int, FaultSpec]] = []
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.site != site or not spec.matches(ctx):
                    continue
                self._visits[i] += 1
                if self._visits[i] <= spec.after:
                    continue
                if spec.max_fires is not None \
                        and self._fires[i] >= spec.max_fires:
                    continue
                if spec.p < 1.0 and self._rngs[i].random() >= spec.p:
                    continue
                self._fires[i] += 1
                self.log.append((site, i, spec.kind))
                fired.append((i, spec))
        return fired


_armed: FaultPlan | None = None
_arm_lock = threading.Lock()


def active() -> FaultPlan | None:
    """The currently armed plan (None outside any `arm` block)."""
    return _armed


@contextlib.contextmanager
def arm(plan: FaultPlan):
    """Arm `plan` process-globally for the duration of the block."""
    global _armed
    with _arm_lock:
        if _armed is not None:
            raise RuntimeError("a FaultPlan is already armed")
        _armed = plan
    try:
        yield plan
    finally:
        with _arm_lock:
            _armed = None


def site(name: str, **ctx) -> str | None:
    """Declare an injection site. No-op without an armed plan. With one:
    applies any delay fault (sleeps), raises `InjectedFault` for a kill,
    and returns "poison" when a poison fault fired (the caller corrupts
    its own result — the site cannot, it has no result yet)."""
    plan = _armed
    if plan is None or not plan.specs:
        return None
    fired = plan.visit(name, ctx)
    if not fired:
        return None
    # The fault layer is process-global (exactly one environment), so its
    # observed-injection counters live on the process-default registry —
    # BlinkService.metrics_snapshot() merges them next to the engine's.
    from repro_torch.obs import metrics as obs_metrics
    m = obs_metrics.default_registry().counter(
        "fault_injections_total", "Fault-plan specs observed firing",
        labels=("site", "kind"))
    poison = None
    kill: tuple[int, FaultSpec] | None = None
    for i, spec in fired:
        m.labels(name, spec.kind).inc()
        if spec.kind == "delay":
            time.sleep(spec.delay_s)
        elif spec.kind == "poison":
            poison = "poison"
        else:
            kill = (i, spec)
    if kill is not None:
        raise InjectedFault(name, kill[0], ctx)
    return poison


def random_plan(seed: int, n_shards: int = 4, n_replicas: int = 2,
                max_specs: int = 5, max_delay_s: float = 0.02) -> FaultPlan:
    """A bounded random schedule for chaos soaks. Engine-level kills are
    capped at `max_fires` below the service's retry budget + 1, so a plan
    can force the full ladder (retries, replica loss, reweighting, typed
    errors) but cannot wedge the harness; scheduler.dispatch is excluded
    (dispatcher death is covered by its own deterministic test — in a soak
    it would just turn the rest of the seed's queries into
    ServiceUnhealthyError noise)."""
    rng = np.random.default_rng(seed)
    specs: list[FaultSpec] = []
    for _ in range(int(rng.integers(1, max_specs + 1))):
        roll = rng.random()
        if roll < 0.7:
            # shard-level fault: kill/delay/poison one (shard[, replica])
            kind = ("kill", "delay", "poison")[int(rng.integers(0, 3))]
            match: list[tuple[str, object]] = \
                [("shard", int(rng.integers(0, n_shards)))]
            if rng.random() < 0.5:
                match.append(("replica", int(rng.integers(0, n_replicas))))
            specs.append(FaultSpec(
                site="shard.scan", kind=kind, match=tuple(match),
                p=float(rng.uniform(0.3, 1.0)),
                after=int(rng.integers(0, 3)),
                max_fires=(None if rng.random() < 0.5
                           else int(rng.integers(1, 9))),
                delay_s=float(rng.uniform(0.001, max_delay_s))))
        else:
            # engine-level kill: bounded so retries eventually succeed
            specs.append(FaultSpec(
                site="engine.scan", kind="kill",
                p=float(rng.uniform(0.3, 1.0)),
                after=int(rng.integers(0, 3)),
                max_fires=int(rng.integers(1, 3))))
    return FaultPlan(tuple(specs), seed=seed + 1)
