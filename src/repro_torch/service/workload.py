"""Workload monitor: observed query-column-set (QCS) statistics driving the
§3.2 adaptive-optimization loop (counterpart of `repro.service.workload`).

The paper's optimizer is workload-driven — the sample set should track the
TEMPLATES analysts actually send, not just the data distribution. The engine
side of that loop exists (`SampleMaintainer`), but until now it only reacted
to data deltas. This monitor closes the other half:

* `record` counts each query's QCS (WHERE ∪ GROUP BY columns — the paper's
  φ^T) in a sliding window, and tracks per-template hit/miss-of-target stats
  (did the answer actually meet its ERROR/TIME bound?);
* `drift_score` is the total-variation distance between the recent QCS
  distribution and the BASELINE distribution the current sample set was
  optimized for (seeded from the maintainer's templates, re-based after each
  epoch) — the same TV metric `maintenance.distribution_drift` applies to
  data histograms, applied to the workload;
* `should_reoptimize` gates epoch triggering (enough evidence + drift past
  threshold), and `templates()` exports the observed window as weighted
  `QueryTemplate`s for `SampleMaintainer.run_workload_epoch`.

All methods are thread-safe (the scheduler records from its dispatcher
thread while sessions may read stats).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import Counter, deque
from typing import Mapping, Sequence

from repro_torch.core.types import (Answer, ErrorBound, Query, QueryTemplate,
                              TimeBound)
from repro_torch.core import estimators as est_lib


@dataclasses.dataclass
class WorkloadConfig:
    window: int = 512          # sliding window of recent queries (QCS stream)
    drift_threshold: float = 0.4   # TV(recent, baseline) triggering an epoch
    min_queries: int = 32      # evidence floor before any trigger


@dataclasses.dataclass
class TemplateStats:
    """Per-template serving quality: how often answers met their bound."""
    n: int = 0
    bound_met: int = 0
    bound_missed: int = 0
    unbounded: int = 0
    cache_hits: int = 0

    @property
    def miss_rate(self) -> float:
        judged = self.bound_met + self.bound_missed
        return self.bound_missed / judged if judged else 0.0


def _tv_distance(a: Mapping[frozenset, float],
                 b: Mapping[frozenset, float]) -> float:
    """Total-variation distance between two QCS distributions (normalized)."""
    za = sum(a.values()) or 1.0
    zb = sum(b.values()) or 1.0
    keys = set(a) | set(b)
    return 0.5 * sum(abs(a.get(k, 0.0) / za - b.get(k, 0.0) / zb)
                     for k in keys)


def _met_bound(q: Query, answer: Answer,
               elapsed_s: float | None = None) -> bool | None:
    """Did the answer meet its a-priori contract? None when unbounded. The
    contract is on the CI half-width z·stderr (what required_n_for_error
    targets), not the bare stderr.

    ErrorBound answers from the contract engine carry their own verdict
    (Answer.bound_met: certified a-priori AND realized post-hoc) — trust it
    when present; the post-hoc recomputation below remains for answers that
    predate the contract path (stale cache entries, unions)."""
    if isinstance(q.bound, ErrorBound):
        if answer.bound_met is not None:
            return answer.bound_met
        z = est_lib.z_value(q.bound.confidence)
        if q.bound.relative:
            half = max((abs(z * g.stderr / g.estimate)
                        for g in answer.groups
                        if not g.exact and g.estimate), default=0.0)
        else:
            half = max((z * g.stderr for g in answer.groups if not g.exact),
                       default=0.0)
        return half <= q.bound.eps + 1e-12
    if isinstance(q.bound, TimeBound):
        # End-to-end latency (queue wait + window + scan) when the caller
        # supplies it — a scan inside the bound that waited past the
        # deadline in the batching queue still MISSED the user's contract.
        spent = elapsed_s if elapsed_s is not None else answer.elapsed_s
        return spent <= q.bound.seconds + 1e-9
    return None


class WorkloadMonitor:
    def __init__(self, config: WorkloadConfig | None = None,
                 baseline: Mapping[frozenset, float] | None = None):
        self.config = config or WorkloadConfig()
        self._lock = threading.Lock()
        # (table, QCS frozenset) stream, sliding window
        self._window: deque[tuple[str, frozenset]] = deque(
            maxlen=self.config.window)
        # Parallel window of (table, Answer.sample_phi): which FAMILY served
        # each recent answer — the hot-family replication signal.
        self._phi_window: deque[tuple[str, tuple[str, ...]]] = deque(
            maxlen=self.config.window)
        self._all_time: Counter = Counter()
        self.template_stats: dict[tuple[str, frozenset], TemplateStats] = {}
        self._baseline: dict[frozenset, float] = dict(baseline or {})
        self._since_epoch = 0
        self.epochs_triggered = 0
        self._m_outcomes = None    # registry mirror (attach_metrics)
        self._m_epochs = None

    def attach_metrics(self, registry) -> None:
        """Mirror the monitor's observations onto a shared MetricsRegistry
        (the scheduler attaches the engine's): per-(table, outcome) query
        counts, epoch triggers, and drift as a callback gauge evaluated at
        snapshot time."""
        self._m_outcomes = registry.counter(
            "workload_queries_total",
            "Recorded queries by table and contract outcome",
            labels=("table", "outcome"))
        self._m_epochs = registry.counter(
            "workload_epochs_total", "Re-optimization epochs triggered")
        registry.gauge("workload_drift_score",
                       "TV distance of recent QCS stream vs baseline"
                       ).labels().set_function(lambda: self.drift_score())

    @classmethod
    def from_templates(cls, templates: Sequence[QueryTemplate],
                       config: WorkloadConfig | None = None
                       ) -> "WorkloadMonitor":
        """Baseline = the template weights the current samples were built
        for: drift is measured AGAINST what the optimizer last saw."""
        return cls(config,
                   baseline={t.columns: t.weight for t in templates})

    # -- recording -----------------------------------------------------------
    def record(self, q: Query, answer: Answer | None = None,
               cache_hit: bool = False,
               elapsed_s: float | None = None) -> None:
        """`elapsed_s` is the END-TO-END latency (queue wait + window + scan)
        when known — deadline hit/miss is judged against it, not just the
        scan time the Answer reports."""
        qcs = frozenset(q.where_group_columns)
        key = (q.table, qcs)
        outcome = "unjudged"
        with self._lock:
            self._window.append(key)
            if answer is not None and answer.sample_phi is not None:
                self._phi_window.append((q.table, tuple(answer.sample_phi)))
            self._all_time[key] += 1
            self._since_epoch += 1
            st = self.template_stats.setdefault(key, TemplateStats())
            st.n += 1
            if cache_hit:
                st.cache_hits += 1
            if answer is not None:
                met = _met_bound(q, answer, elapsed_s)
                if met is None:
                    st.unbounded += 1
                    outcome = "unbounded"
                elif met:
                    st.bound_met += 1
                    outcome = "bound_met"
                else:
                    st.bound_missed += 1
                    outcome = "bound_missed"
        if self._m_outcomes is not None:
            self._m_outcomes.labels(q.table, outcome).inc()

    # -- statistics ----------------------------------------------------------
    def qcs_frequencies(self, table: str | None = None,
                        recent: bool = True) -> dict[frozenset, int]:
        with self._lock:
            src = (Counter(self._window) if recent
                   else Counter(self._all_time))
        out: Counter = Counter()
        for (tbl, qcs), n in src.items():
            if table is None or tbl == table:
                out[qcs] += n
        return dict(out)

    def drift_score(self, table: str | None = None) -> float:
        """TV distance between the recent-window QCS distribution and the
        baseline the current sample set was optimized for. 0 until a
        baseline exists (nothing to drift from)."""
        with self._lock:
            baseline = dict(self._baseline)
        if not baseline:
            return 0.0
        recent = {k: float(v)
                  for k, v in self.qcs_frequencies(table).items()}
        if not recent:
            return 0.0
        return _tv_distance(recent, baseline)

    def should_reoptimize(self, table: str | None = None) -> bool:
        with self._lock:
            if self._since_epoch < self.config.min_queries:
                return False
        return self.drift_score(table) > self.config.drift_threshold

    def templates(self, table: str | None = None,
                  max_templates: int = 16) -> list[QueryTemplate]:
        """The observed recent workload as weighted templates (§3.2.1 input):
        weight = share of the window, heaviest first. The empty QCS (pure
        aggregates — served by the always-present uniform family) is skipped:
        it is not a stratification candidate."""
        freqs = self.qcs_frequencies(table)
        freqs.pop(frozenset(), None)
        total = float(sum(freqs.values())) or 1.0
        top = sorted(freqs.items(), key=lambda kv: (-kv[1], sorted(kv[0])))
        return [QueryTemplate(qcs, n / total)
                for qcs, n in top[:max_templates]]

    def hot_families(self, min_share: float = 0.25,
                     min_n: int = 32) -> list[tuple[str, tuple[str, ...]]]:
        """Families serving at least `min_share` of the recent window — the
        replication signal: the scheduler promotes these via
        BlinkDB.mark_hot_family so their shard placements grow longer
        fail-over chains. Evidence-floored like should_reoptimize: no
        promotions until `min_n` answers accrue."""
        with self._lock:
            counts = Counter(self._phi_window)
            total = len(self._phi_window)
        if total < min_n:
            return []
        return sorted(key for key, n in counts.items()
                      if n / total >= min_share)

    def defer(self) -> None:
        """An epoch attempt failed: keep the baseline (the optimizer never
        consumed the new templates — the drift signal must survive) but
        reset the evidence counter so the retry backs off until another
        min_queries of traffic accrues."""
        with self._lock:
            self._since_epoch = 0

    def rebase(self, templates: Sequence[QueryTemplate] | None = None,
               table: str | None = None) -> None:
        """After a re-optimization epoch: the new baseline is what the
        optimizer just consumed; the trigger evidence counter resets. With
        no templates (nothing-stratifiable window), the baseline rebuilds
        from the window — restricted to `table` when given, so another
        table's traffic cannot leak into this table's drift signal — and
        does not count as a triggered epoch."""
        with self._lock:
            if templates is not None:
                self._baseline = {t.columns: t.weight for t in templates}
                self.epochs_triggered += 1
                if self._m_epochs is not None:
                    self._m_epochs.inc()
            else:
                self._baseline = {}
                for (tbl, qcs), n in Counter(self._window).items():
                    if table is None or tbl == table:
                        self._baseline[qcs] = self._baseline.get(qcs, 0.0) + n
            self._since_epoch = 0
