"""Fault-tolerance supervisor: heartbeats, straggler detection, retry policy
(counterpart of `repro.fault.supervisor`, pure Python and numpy).

On a real multi-host deployment every host runs a worker loop; the supervisor
(or a gang-scheduler sidecar) watches per-step heartbeats. The mechanisms
here are the production-shaped, unit-testable pieces:

  * `Heartbeat` — per-worker step/timestamp registry,
  * `StragglerPolicy` — deadline = median step time × factor; flags workers
    past the deadline (paper-adjacent: BlinkDB's §4.5 low-priority background
    work and Mantri-style [8] outlier mitigation),
  * `RetryLoop` — exponential-backoff wrapper that restarts a step function
    from the latest checkpoint on failure (preemption, OOM, numerical NaN),
  * `ElasticPlan` — recompute (data-shard → worker) assignment when the
    worker set changes (elastic scaling: batch stays global-deterministic
    because the data pipeline slices by shard index — data/tokens.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.obs.clock import now_s


@dataclasses.dataclass
class Heartbeat:
    n_workers: int

    def __post_init__(self):
        self.last_step = np.zeros(self.n_workers, dtype=np.int64)
        # Per-worker stamps (monotonic now_s — beat AGES must survive
        # wall-clock adjustments): one shared reading would give every
        # worker the registry's construction instant, skewing the first
        # deadline by however long construction-to-first-beat takes to
        # drift apart across workers.
        self.last_time = np.array([now_s()
                                   for _ in range(self.n_workers)])
        self.step_times: list[float] = []

    def beat(self, worker: int, step: int) -> None:
        now = now_s()
        if step > self.last_step[worker] and self.last_step[worker] > 0:
            self.step_times.append(now - self.last_time[worker])
        self.last_step[worker] = step
        self.last_time[worker] = now

    def last_beat_age_s(self, worker: int,
                        now: float | None = None) -> float:
        """Seconds since this worker's last beat — the per-worker liveness
        gauge the metrics plane exports (docs/OBSERVABILITY.md)."""
        now = now if now is not None else now_s()
        return max(0.0, float(now - self.last_time[worker]))

    def stalest(self, now: float | None = None) -> tuple[int, float]:
        """(worker, age_s) of the longest-silent worker — what
        ServiceUnhealthyError reports."""
        now = now if now is not None else now_s()
        ages = now - self.last_time
        w = int(np.argmax(ages))
        return w, max(0.0, float(ages[w]))


@dataclasses.dataclass
class StragglerPolicy:
    factor: float = 3.0          # deadline = factor × median step time
    min_deadline_s: float = 1.0

    def stragglers(self, hb: Heartbeat, now: float | None = None) -> list[int]:
        now = now if now is not None else now_s()
        if not hb.step_times:
            return []
        median = float(np.median(hb.step_times[-100:]))
        deadline = max(self.factor * median, self.min_deadline_s)
        return [w for w in range(hb.n_workers)
                if now - hb.last_time[w] > deadline]


@dataclasses.dataclass
class RetryLoop:
    """Exponential-backoff restart wrapper.

    `retry_on` is the injectable transient-failure tuple — anything outside
    it (a ValueError from a malformed query, a KeyError from a programming
    error) propagates immediately instead of burning retries on a failure
    that cannot heal. `raise_last=True` re-raises the final attempt's
    original exception (callers that promise per-error-type contracts, like
    the service's engine-error propagation) instead of the generic wrapper.
    torch raises a CUDA error or a failed kernel build as RuntimeError, so
    the default tuple must not wrap a launch: the service passes its own
    `retry_on`, (FaultError, FloatingPointError), and a launch failure
    propagates unretried.
    """
    max_retries: int = 3
    backoff_s: float = 0.1
    retry_on: tuple = (FloatingPointError, RuntimeError)
    raise_last: bool = False

    def run(self, step_fn: Callable[[], object],
            on_failure: Callable[[Exception, int], None] | None = None):
        """Run step_fn with restart-on-failure. Raises after max_retries."""
        err: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                return step_fn()
            except self.retry_on as e:
                err = e
                if on_failure:
                    on_failure(e, attempt)
                if attempt < self.max_retries:
                    # No backoff after the FINAL failure: the caller is
                    # about to see the error, not another attempt.
                    time.sleep(self.backoff_s * (2 ** attempt))
        if self.raise_last:
            raise err
        raise RuntimeError(
            f"step failed after {self.max_retries} retries") from err


def elastic_plan(n_shards_data: int, live_workers: list[int]) -> dict[int, list[int]]:
    """Assign data shards to the live worker set (round-robin)."""
    if not live_workers:
        raise ValueError("no live workers")
    plan: dict[int, list[int]] = {w: [] for w in live_workers}
    for s in range(n_shards_data):
        plan[live_workers[s % len(live_workers)]].append(s)
    return plan
