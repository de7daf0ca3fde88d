"""Concurrent admission scheduler: many sessions, shared scans (counterpart
of `repro.service.scheduler`, pure Python over the port's engine).

The paper's serving story (§2, §4.4) assumes many analysts firing templated
queries concurrently; the engine's `query_batch` already amortizes one family
scan per (table, family, template) group but takes a pre-assembled batch from
ONE caller. This scheduler closes the gap:

* **Admission**: `submit()` is thread-safe and blocking-per-caller. Each
  request is parsed (BlinkQL text) / taken as a `Query`, normalized
  (types.Query.normalized), checked against the answer cache, and enqueued.
  A full queue (`max_queue`) rejects with `AdmissionError` instead of
  accepting work it cannot serve — a-priori admission control. Deadline-aware
  LOAD SHEDDING extends this: when the queue depth times the observed batch
  execution time implies a TimeBound cannot be met, the request is rejected
  at admission with `DeadlineShedError` (a late answer to a deadline query is
  worth nothing — reject it while the caller can still go elsewhere).
* **Coalescing**: a single dispatcher thread drains the queue in batches: it
  waits up to `batch_window_s` after the first pending request (so
  near-simultaneous requests from different sessions land in one batch),
  flushes early when `max_batch` requests are pending or a deadline-bound
  request cannot afford the wait, deduplicates identical normalized queries,
  and executes ONE `query_batch` call — the engine groups compatible queries
  by (table, family, template) into shared scans (docs/BATCHING.md).
* **Solo bypass**: when traffic is demonstrably solo — nothing queued, and
  the previous batch had at most one request (a single blocking session can
  never have two requests in flight) — `submit()` executes inline on the
  caller thread under the execution lock, skipping the queue handoff, the
  dispatcher wakeup, and the batching window entirely. A lone analyst pays
  naive-`query()` latency instead of +window+handoff; the moment a second
  session's request races in, the bypass lock misses and everything
  coalesces as before.
* **Deadlines**: the batching window is threaded into ELP resolution
  selection as headroom (`query_batch(deadline_headroom_s=window)`): a
  TimeBound query that waited up to one window still picks a K whose scan
  fits the REMAINING budget (§4.2); a bound tighter than the window flushes
  the batch immediately rather than queuing past its deadline.
* **Degradation ladder** (docs/FAULTS.md): execution failures the config
  declares transient (`retry_on`, default: fault-layer errors) walk down a
  ladder instead of failing closed — retry with exponential backoff
  (fault.supervisor.RetryLoop); below that, the engine's own replica
  re-route and HT-reweighted partial answers (Answer.degraded provenance);
  below that, a STALE cache answer with declared staleness; and only then a
  typed `DegradedServiceError`. Non-transient errors (a malformed query's
  ValueError) propagate to their submitter immediately, exactly as before.
* **Dispatcher-death safety**: an unexpected exception escaping the
  dispatcher loop fails every pending request with a typed
  `ServiceUnhealthyError` and marks the service unhealthy — later submits
  are rejected at admission instead of hanging until their timeout; `close()`
  raises if the dispatcher fails to join.
* **Async submission**: `submit_async()` returns a `concurrent.futures.
  Future`; `submit_many()` routes through it with ONE atomic admission, so a
  session's pre-assembled batch lands in one coalesced scan instead of
  serializing request-by-request.
* **Workload loop**: every answered query is recorded in the
  `WorkloadMonitor`; when QCS drift crosses the threshold and a
  `SampleMaintainer` is attached, the dispatcher runs a workload-only
  re-optimization epoch (`run_workload_epoch`) between batches — template
  churn alone (no data delta) re-shapes the sample set (§3.2).

All engine execution happens on the dispatcher thread (or a solo caller
holding the execution lock), so the engine's single-caller contract is
preserved no matter how many sessions submit. Every launch lands on the
engine's card and that card's current stream of the executing thread:
the engine pins its device index (core/engine.py `resolve_device`), and
the kernel wrappers launch on the tensors' device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Sequence

from repro_torch.core.types import Answer, ErrorBound, Query, TimeBound
from repro_torch.fault import inject
from repro_torch.fault.inject import FaultError
from repro_torch.fault.supervisor import Heartbeat, RetryLoop
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import QueryTrace, Tracer
from repro_torch.service.cache import AnswerCache
from repro_torch.service.parser import (Explain, ShowMetrics, parse_blinkql,
                                  parse_statement)
from repro_torch.service.workload import WorkloadConfig, WorkloadMonitor


class AdmissionError(RuntimeError):
    """Queue depth exceeded: the request was rejected at admission."""


class DeadlineShedError(AdmissionError):
    """Rejected at admission: the observed load implies the request's
    TimeBound cannot be met, so accepting it would only produce a late
    answer (worthless for a deadline query) and delay everyone else."""


class ServiceUnhealthyError(RuntimeError):
    """The dispatcher thread died; the service no longer executes queries."""


class DegradedServiceError(RuntimeError):
    """The degradation ladder is exhausted: retries failed, no degraded
    answer could be computed, and no acceptable stale answer exists."""


@dataclasses.dataclass
class ServiceConfig:
    batch_window_s: float = 0.005   # coalescing window after first request
    max_batch: int = 64             # flush threshold (engine chunks past 64)
    max_queue: int = 1024           # admission bound
    use_cache: bool = True
    cache_capacity: int = 1024
    workload: WorkloadConfig = dataclasses.field(default_factory=WorkloadConfig)
    reoptimize: bool = True         # run workload epochs when drift triggers
    solo_bypass: bool = True        # inline execution when traffic is solo
    # Degradation ladder (docs/FAULTS.md). `retry_on` is the transient-error
    # tuple: execution failures matching it are retried with backoff and, if
    # they persist, degrade (stale answer, then DegradedServiceError) instead
    # of propagating; anything else (e.g. a ValueError for a malformed query)
    # reaches its submitter untouched on the first attempt.
    retry_attempts: int = 1
    retry_backoff_s: float = 0.01
    retry_on: tuple = (FaultError, FloatingPointError)
    serve_stale: bool = True        # stale-cache rung of the ladder
    stale_max_s: float = 300.0      # oldest stale answer worth serving
    shed_deadlines: bool = True     # deadline-aware admission load shedding
    # Observability (docs/OBSERVABILITY.md): per-query tracing is SAMPLED —
    # always-on for contract queries (ErrorBound/TimeBound) and while a
    # fault plan is armed, 1-in-`trace_sample_every` for the rest. `trace`
    # False disables the plane entirely (bit-identical answers, no trace
    # attached); `trace_capacity` bounds the ring of retained traces.
    trace: bool = True
    trace_sample_every: int = 16
    trace_capacity: int = 256
    # Hot-family replication (docs/SERVICE.md): families serving
    # ≥ hot_family_share of the monitor's recent window (after
    # hot_family_min answers of evidence) are promoted via
    # BlinkDB.mark_hot_family — their shard placements grow longer fail-over
    # chains. Promotion is placement metadata only; answers are unchanged.
    hot_replication: bool = True
    hot_family_share: float = 0.25
    hot_family_min: int = 32


@dataclasses.dataclass
class _Request:
    query: Query                    # normalized (cache/workload key)
    done: threading.Event
    t_submit: float
    answer: Answer | None = None
    error: BaseException | None = None
    future: Future | None = None    # submit_async/submit_many completion
    trace: QueryTrace | None = None  # sampled-in span tree (else None)


class BlinkQLService:
    """The BlinkQL frontend over one BlinkDB engine.

        svc = BlinkQLService(db, maintainer=maintainer)
        ans = svc.submit("SELECT AVG(SessionTime) FROM sessions "
                         "WHERE City = 'x' ERROR WITHIN 10% CONFIDENCE 95%")
        ...
        svc.close()

    Context-manager friendly; `submit` may be called from any number of
    threads ("sessions").
    """

    def __init__(self, db, maintainer=None,
                 config: ServiceConfig | None = None):
        self.db = db
        self.maintainer = maintainer
        self.config = config or ServiceConfig()
        self.cache = (AnswerCache(db, self.config.cache_capacity)
                      if self.config.use_cache else None)
        if maintainer is not None:
            # Fleet maintainer: the drift baseline seeds from
            # EVERY table's templates — per-table drift is still scored per
            # table (drift_score(table)), one monitor serves the fleet.
            self.monitor = WorkloadMonitor.from_templates(
                [t for name in maintainer.tables
                 for t in maintainer.templates_for(name)],
                self.config.workload)
        else:
            self.monitor = WorkloadMonitor(self.config.workload)
        self.workload_epochs: list[dict] = []
        self._queue: deque[_Request] = deque()
        # Observability plane (docs/OBSERVABILITY.md). Scheduler instruments
        # live on the ENGINE's registry so metrics_snapshot() exports one
        # coherent document per engine; the legacy n_* ints are read-through
        # properties over these handles — ONE bookkeeping path.
        m = db.metrics
        self._m_batches = m.counter("service_batches_total",
                                    "Coalesced engine executions")
        self._m_queries = m.counter(
            "service_queries_total", "Queries served, by path",
            labels=("path",))               # solo | batch | cache_hit
        self._m_ladder = m.counter(
            "service_ladder_total",
            "Degradation-ladder rung activations (docs/FAULTS.md)",
            labels=("rung",))  # shed|retry|degraded|stale_serve|exhausted
        self._m_solo = m.counter("service_solo_bypass_total",
                                 "Queries executed inline by the solo bypass")
        self._m_width = m.histogram("service_batch_width",
                                    "Requests per coalesced batch")
        m.gauge("service_queue_depth", "Requests awaiting dispatch"
                ).labels().set_function(lambda: float(len(self._queue)))
        # A registry outlives any one service (several services can be built
        # over one engine): the per-SERVICE n_* properties subtract the
        # values observed at construction.
        self._base = {
            "batches": self._m_batches.value(),
            "solo": self._m_queries.value("solo"),
            "batch": self._m_queries.value("batch"),
            "degraded": self._m_ladder.value("degraded"),
            "stale_serve": self._m_ladder.value("stale_serve"),
            "shed": self._m_ladder.value("shed"),
        }
        # The EWMA shedding load model reads/writes THROUGH the registry
        # (the `_exec_ewma` property below): the gauge is the state.
        self._g_ewma = m.gauge(
            "service_exec_ewma_seconds",
            "EWMA batch execution time (deadline-shedding load model)"
        ).labels()
        self.monitor.attach_metrics(m)
        # Dispatcher liveness: worker 0 of a one-worker Heartbeat, beaten
        # once per dispatch iteration; exported as a callback gauge and
        # quoted by ServiceUnhealthyError so a stuck dispatcher reports HOW
        # long it has been silent.
        self.heartbeat = Heartbeat(1)
        self._beat_step = 0
        m.gauge("service_last_beat_age_s",
                "Seconds since each worker's last heartbeat",
                labels=("worker",)
                ).set_function(lambda: self.heartbeat.last_beat_age_s(0),
                               "dispatcher")
        # Per-service tracing: sampling policy + ring retention.
        self.tracer = Tracer(capacity=self.config.trace_capacity,
                             sample_every=self.config.trace_sample_every)
        self.tracer.enabled = self.config.trace
        self._cond = threading.Condition()
        self._stop = False
        self._epoch_pending = False   # cache-hit path saw drift: wake & check
        # Dispatcher-death safety: set (under _cond) the moment the
        # dispatcher loop dies of an unexpected exception; every pending
        # request is failed with a typed error and every later admission
        # is rejected — a dead dispatcher must fail loudly, not hang
        # callers until their timeouts.
        self._failed: ServiceUnhealthyError | None = None
        self._in_flight: list[_Request] = []   # batch the dispatcher holds
        # EWMA of batch execution time — the load model behind deadline
        # shedding (a full latency model is overkill: shedding only needs
        # "roughly how long does a batch take right now").
        self._exec_ewma = 0.0
        # Serializes ALL engine execution — the dispatcher's batches, the
        # workload epochs, and the solo-bypass inline path (the engine is
        # single-caller; the lock is what lets submit() run it directly).
        self._exec_lock = threading.Lock()
        # Adaptive window: a size-1 batch means traffic is currently solo
        # (one blocking session can never have two requests in flight), so
        # the next batch flushes immediately instead of waiting a window
        # nothing will fill. Any coalesced batch re-arms the window.
        # Starts at 1 — "assume solo until concurrency shows up" — so the
        # FIRST request of a quiet service doesn't eat a full window either.
        self._last_batch_size = 1
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="blinkql-dispatcher",
                                            daemon=True)
        self._dispatcher.start()

    # ----------------------------------------------------------- lifecycle
    def __enter__(self) -> "BlinkQLService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._dispatcher.join(timeout=10.0)
        if self.cache is not None:
            self.cache.detach()   # don't leave hooks on a long-lived engine
        if self._dispatcher.is_alive():
            _, age = self.heartbeat.stalest()
            raise ServiceUnhealthyError(
                "dispatcher thread failed to join within 10s — it is wedged "
                "(likely stuck in the engine) and is being leaked "
                f"(last heartbeat {age:.1f}s ago)")

    @property
    def healthy(self) -> bool:
        return self._failed is None

    # Legacy counter surface: callers (and the test suite) read these as
    # plain ints; the metrics registry is the single source of truth, and
    # each property is this SERVICE's share (value since construction).
    def _since_base(self, key: str, value: float) -> int:
        return int(round(value - self._base[key]))

    @property
    def n_batches(self) -> int:
        return self._since_base("batches", self._m_batches.value())

    @property
    def n_queries(self) -> int:
        """Queries EXECUTED (solo + batch) — cache hits excluded, exactly
        the pre-registry semantics."""
        return (self._since_base("solo", self._m_queries.value("solo"))
                + self._since_base("batch", self._m_queries.value("batch")))

    @property
    def n_degraded(self) -> int:
        return self._since_base("degraded",
                                self._m_ladder.value("degraded"))

    @property
    def n_stale(self) -> int:
        return self._since_base("stale_serve",
                                self._m_ladder.value("stale_serve"))

    @property
    def n_shed(self) -> int:
        return self._since_base("shed", self._m_ladder.value("shed"))

    @property
    def _exec_ewma(self) -> float:
        return self._g_ewma.value

    @_exec_ewma.setter
    def _exec_ewma(self, v: float) -> None:
        self._g_ewma.set(v)

    # ----------------------------------------------------------- admission
    def _shed_guard(self, q: Query) -> None:
        """Deadline-aware load shedding (called with _cond held): reject a
        TimeBound request whose expected completion — one batching window
        plus the batches queued ahead of it at the observed per-batch
        execution time — already exceeds its bound."""
        if not self.config.shed_deadlines or self._exec_ewma <= 0.0:
            return
        bound = q.bound
        if not isinstance(bound, TimeBound):
            return
        batches_ahead = 1.0 + len(self._queue) / float(self.config.max_batch)
        expected = self.config.batch_window_s \
            + batches_ahead * self._exec_ewma
        if expected > bound.seconds:
            self._m_ladder.labels("shed").inc()
            raise DeadlineShedError(
                f"deadline {bound.seconds:.3f}s cannot be met: "
                f"{len(self._queue)} request(s) queued ahead at "
                f"~{self._exec_ewma:.3f}s per batch "
                f"(expected completion ~{expected:.3f}s)")

    def _admit(self, reqs: list[_Request]) -> None:
        """Atomically admit a group of requests: ONE lock acquisition, ONE
        dispatcher wakeup — so a pre-assembled submit_many batch is drained
        into a single coalesced scan, never split by a dispatcher that woke
        between two separate enqueues."""
        with self._cond:
            if self._failed is not None:
                raise ServiceUnhealthyError(str(self._failed)) \
                    from self._failed.__cause__
            if self._stop:
                raise RuntimeError("service is closed")
            if len(self._queue) + len(reqs) > self.config.max_queue:
                raise AdmissionError(
                    f"admission queue full ({self.config.max_queue} pending)")
            for r in reqs:
                self._shed_guard(r.query)
            self._queue.extend(reqs)
            self._cond.notify_all()

    def _record_hit(self, q: Query, hit: Answer, t0: float) -> None:
        """Bookkeeping for a cache hit: deadline stats judge the SERVE time
        (≈0 for a hit), and a cached workload still drifts — wake the
        dispatcher so the reoptimize trigger is evaluated even when nothing
        executes."""
        self._m_queries.labels("cache_hit").inc()
        self.monitor.record(q, hit, cache_hit=True,
                            elapsed_s=time.monotonic() - t0)
        if self._drift_pending():
            with self._cond:
                self._epoch_pending = True
                self._cond.notify_all()

    def _drift_pending(self) -> bool:
        """Any fleet table's workload drifted past the reoptimize trigger."""
        return (self.config.reoptimize and self.maintainer is not None
                and any(self.monitor.should_reoptimize(t)
                        for t in self.maintainer.tables))

    def _promote_hot_families(self) -> None:
        """Hot-family replication: promote families dominating
        the recent window so their shard placements grow longer fail-over
        chains (BlinkDB.mark_hot_family — placement metadata only, never an
        answer change). Monotone and idempotent, so re-running per dispatch
        iteration is cheap."""
        if not self.config.hot_replication:
            return
        for table, phi in self.monitor.hot_families(
                self.config.hot_family_share, self.config.hot_family_min):
            if phi:
                self.db.mark_hot_family(table, phi)

    # ----------------------------------------------------------- tracing
    def _start_trace(self, q: Query, text: str, t0: float, t_parsed: float,
                     forced: bool = False) -> QueryTrace | None:
        """Sampling decision + root/parse backfill. `t0` is the submit-path
        monotonic stamp taken before parsing; span clocks are the SAME
        monotonic clock (obs.clock.now_s is time.monotonic), so it backdates
        the trace and the parse span to cover the whole request."""
        reason = self.tracer.should_sample(
            contract=q.bound is not None, forced=forced)
        if reason is None:
            return None
        tr = self.tracer.start(text, reason)
        tr.t0 = t0
        root = tr.open_span("request", {})
        root.t0 = t0
        # New threads (the dispatcher) adopting this trace nest under the
        # request root, not at top level.
        tr.set_anchor(root.index)
        rec = tr.open_span("parse", {})
        tr.close_span(rec)
        rec.t0, rec.t1 = t0, t_parsed
        return tr

    def _finish_trace(self, tr: QueryTrace | None,
                      error: BaseException | None = None) -> None:
        """Close the request root and retire the trace into the ring."""
        if tr is None:
            return
        if tr.spans:
            tr.close_span(tr.spans[0])
        self.tracer.finish(
            tr, None if error is None else type(error).__name__)

    def _attach_trace(self, ans: Answer, tr: QueryTrace | None) -> Answer:
        """Finish `tr` and return a copy of `ans` carrying it. Called once
        per REQUEST at delivery, always AFTER caching — cached answers stay
        untraced (a trace is one request's history, not the answer's), and
        a traced answer is bit-identical to its untraced original."""
        if tr is None:
            return ans
        self._finish_trace(tr)
        return dataclasses.replace(ans, trace=tr, timings=tr.timings())

    def _cache_lookup(self, q: Query, tr: QueryTrace | None) -> Answer | None:
        """Cache probe with its span recorded straight onto `tr` (no
        thread-local activation needed: the probe is synchronous here)."""
        if self.cache is None:
            return None
        rec = None if tr is None else tr.open_span("cache", {})
        hit = self.cache.get(q)
        if rec is not None:
            rec.attrs["hit"] = hit is not None
            tr.close_span(rec)
        return hit

    # ----------------------------------------------------------- submission
    def submit(self, query: str | Query,
               timeout: float | None = None) -> Answer:
        """Parse (if text), admit, and block until answered.

        Raises BlinkQLError on parse/resolution failures, AdmissionError
        (incl. DeadlineShedError) when the request is rejected at admission,
        ServiceUnhealthyError when the dispatcher has died, and re-raises
        any engine-side execution error the degradation ladder could not
        absorb."""
        t0 = time.monotonic()
        text = query if isinstance(query, str) else repr(query)
        if isinstance(query, str):
            query = parse_blinkql(query, self.db)
        q = query.normalized()
        tr = self._start_trace(q, text, t0, time.monotonic())
        return self._submit_traced(q, tr, t0, timeout)

    def _submit_traced(self, q: Query, tr: QueryTrace | None, t0: float,
                       timeout: float | None) -> Answer:
        hit = self._cache_lookup(q, tr)
        if hit is not None:
            self._record_hit(q, hit, t0)
            return self._attach_trace(hit, tr)
        # Inline execution cannot honor a caller timeout (the caller IS the
        # executor — there is no one to stop waiting on), so timed submits
        # always take the queued path, whose done.wait(timeout) contract
        # raises TimeoutError as documented.
        if self.config.solo_bypass and timeout is None:
            ans = self._try_solo_bypass(q, t0, tr)
            if ans is not None:
                return ans
        req = _Request(q, threading.Event(), time.monotonic(), trace=tr)
        try:
            self._admit([req])
        except BaseException as e:
            self._finish_trace(tr, e)   # shed / unhealthy / closed
            raise
        if not req.done.wait(timeout):
            # Free the admission slot: an abandoned request must not occupy
            # max_queue (a no-op if the dispatcher already dequeued it).
            removed = False
            with self._cond:
                try:
                    self._queue.remove(req)
                    removed = True
                except ValueError:
                    pass
            err = TimeoutError("query was not answered within the timeout")
            if removed:
                # Still queued: nobody else will ever finish this trace.
                self._finish_trace(tr, err)
            raise err
        if req.error is not None:
            raise req.error
        assert req.answer is not None
        return req.answer

    def submit_async(self, query: str | Query) -> Future:
        """Admit without blocking; returns a Future resolving to the Answer
        (or raising the error `submit` would have raised). Parse and
        admission errors still raise HERE, synchronously — they are the
        caller's bug or backpressure signal, not a deferred result. Async
        submissions always take the queued path (the bypass exists to skip
        waiting, and an async caller is not waiting)."""
        t0 = time.monotonic()
        text = query if isinstance(query, str) else repr(query)
        if isinstance(query, str):
            query = parse_blinkql(query, self.db)
        q = query.normalized()
        tr = self._start_trace(q, text, t0, time.monotonic())
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        hit = self._cache_lookup(q, tr)
        if hit is not None:
            self._record_hit(q, hit, t0)
            fut.set_result(self._attach_trace(hit, tr))
            return fut
        req = _Request(q, threading.Event(), time.monotonic(), future=fut,
                       trace=tr)
        try:
            self._admit([req])
        except BaseException as e:
            self._finish_trace(tr, e)
            raise
        return fut

    def submit_many(self, queries: Sequence[str | Query],
                    timeout: float | None = None) -> list[Answer]:
        """Submit a pre-assembled batch from one session. The whole group is
        admitted ATOMICALLY (one lock acquisition, one dispatcher wakeup),
        so it lands in one coalesced `query_batch` scan — blocking per query
        would defeat the coalescing it exists to exploit. Returns answers in
        input order; `timeout` bounds the TOTAL wait."""
        t0 = time.monotonic()
        results: list[Answer | None] = [None] * len(queries)
        pending: list[tuple[int, _Request]] = []
        for i, query in enumerate(queries):
            text = query if isinstance(query, str) else repr(query)
            if isinstance(query, str):
                query = parse_blinkql(query, self.db)
            q = query.normalized()
            tr = self._start_trace(q, text, t0, time.monotonic())
            hit = self._cache_lookup(q, tr)
            if hit is not None:
                self._record_hit(q, hit, t0)
                results[i] = self._attach_trace(hit, tr)
            else:
                req = _Request(q, threading.Event(), time.monotonic(),
                               future=Future(), trace=tr)
                req.future.set_running_or_notify_cancel()
                pending.append((i, req))
        if pending:
            try:
                self._admit([r for _, r in pending])
            except BaseException as e:
                for _, req in pending:
                    self._finish_trace(req.trace, e)
                raise
            deadline = None if timeout is None else t0 + timeout
            try:
                for i, req in pending:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError
                    results[i] = req.future.result(timeout=remaining)
            except TimeoutError:
                # Free every still-queued slot of the batch (requests the
                # dispatcher already holds complete abandoned, as in submit).
                with self._cond:
                    for _, req in pending:
                        if not req.done.is_set():
                            try:
                                self._queue.remove(req)
                            except ValueError:
                                pass
                raise TimeoutError(
                    "batch was not answered within the timeout") from None
        return results

    def _try_solo_bypass(self, q: Query, t0: float,
                         tr: QueryTrace | None = None) -> Answer | None:
        """Inline execution for demonstrably solo traffic: nothing queued
        and the previous batch had ≤ 1 request. Returns None (caller falls
        back to the queued path) when another request is in flight, the
        execution lock is contended, or the service is draining — the bypass
        may only ever SKIP waiting, never serialize ahead of a batch that
        exists. Runs on the caller thread under the execution lock, so the
        engine's single-caller contract holds."""
        if self._last_batch_size > 1 or self._queue:
            return None
        if not self._exec_lock.acquire(blocking=False):
            return None
        try:
            with self._cond:
                if self._queue or self._stop:
                    return None   # raced: coalesce normally / reject at admit
                if self._failed is not None:
                    raise ServiceUnhealthyError(str(self._failed)) \
                        from self._failed.__cause__
            snapshot = (self.cache.snapshot(q.table)
                        if self.cache is not None else None)
            t_exec = time.monotonic()
            if tr is not None:
                # Admission marker: this request skipped the queue entirely.
                rec = tr.open_span("admit", {"solo_bypass": True})
                tr.close_span(rec)
                rec.t0, rec.t1 = t0, t_exec
            try:
                # Ladder rung 1: retry-with-backoff around the engine call
                # (the engine's own sharded path absorbs shard faults into
                # degraded answers before an error ever reaches here).
                # activate() makes this thread's engine spans record into
                # the request's trace.
                with obs_trace.activate(tr):
                    ans = self._retry(lambda: self.db.query(q))
            except BaseException as e:   # noqa: BLE001
                with obs_trace.activate(tr):
                    fallback = self._fallback_result(q, e)
                if isinstance(fallback, BaseException):
                    # A non-transient error propagates to this caller alone
                    # — exactly the per-query error contract of the batched
                    # fallback path. (No `from None`: _fallback_result sets
                    # __cause__ on the errors it mints.)
                    self._finish_trace(tr, fallback)
                    raise fallback
                ans = fallback
            self._note_exec_time(time.monotonic() - t_exec)
            self._last_batch_size = 1
            self._m_batches.inc()
            self._m_queries.labels("solo").inc()
            self._m_solo.inc()
            self._m_width.observe(1.0)
            self._count_served(ans)
            if self.cache is not None and not ans.degraded:
                self.cache.put(q, ans, snapshot=snapshot)
            self.monitor.record(q, ans, elapsed_s=time.monotonic() - t0)
            ans = self._attach_trace(ans, tr)
        finally:
            self._exec_lock.release()
        self._promote_hot_families()
        if self._drift_pending():
            # Epochs stay on the dispatcher thread (serialized with batches).
            with self._cond:
                self._epoch_pending = True
                self._cond.notify_all()
        return ans

    # ------------------------------------------------- degradation ladder
    def _retry(self, step_fn):
        """Rung 1: RetryLoop over the transient tuple; `raise_last` keeps
        the final original exception (per-error-type contracts downstream).
        Each transient failure leaves a ladder.retry marker span in any
        active traces and bumps the ladder counter."""
        def _on_failure(e: Exception, attempt: int) -> None:
            self._m_ladder.labels("retry").inc()
            with obs_trace.span("ladder.retry", attempt=attempt,
                                error=type(e).__name__):
                pass
        return RetryLoop(max_retries=self.config.retry_attempts,
                         backoff_s=self.config.retry_backoff_s,
                         retry_on=self.config.retry_on,
                         raise_last=True).run(step_fn,
                                              on_failure=_on_failure)

    def _fallback_result(self, q: Query, err: BaseException
                         ) -> Answer | BaseException:
        """Rungs below retry, for ONE query whose execution failed.

        Non-transient errors return unchanged (they reach the submitter:
        a malformed query is the caller's problem, not the environment's).
        Transient failures try the stale-cache rung — an invalidated answer
        younger than `stale_max_s`, re-annotated degraded with DECLARED
        staleness — and bottom out in a typed DegradedServiceError chaining
        the last failure."""
        if not isinstance(err, self.config.retry_on):
            return err
        if self.config.serve_stale and self.cache is not None:
            stale = self.cache.get_stale(q)
            if stale is not None:
                ans, age = stale
                if age <= self.config.stale_max_s:
                    with obs_trace.span("ladder.stale_serve", age_s=age,
                                        error=type(err).__name__):
                        pass
                    # A stale answer was certified against data that has
                    # since changed: the contract provenance cannot survive
                    # the serve, so an ErrorBound claim is demoted (never
                    # silently kept); unbounded/TimeBound stay None.
                    if isinstance(q.bound, ErrorBound):
                        return dataclasses.replace(
                            ans, degraded=True, staleness_s=age,
                            bound_met=False, certified=False)
                    return dataclasses.replace(ans, degraded=True,
                                               staleness_s=age)
        self._m_ladder.labels("exhausted").inc()
        with obs_trace.span("ladder.exhausted", error=type(err).__name__):
            pass
        final = DegradedServiceError(
            f"execution failed after {self.config.retry_attempts} "
            f"retr{'y' if self.config.retry_attempts == 1 else 'ies'} and "
            f"no stale answer is available: {err!r}")
        final.__cause__ = err
        return final

    def _note_exec_time(self, dt: float) -> None:
        self._exec_ewma = (dt if self._exec_ewma <= 0.0
                           else 0.2 * dt + 0.8 * self._exec_ewma)

    def _count_served(self, ans: Answer) -> None:
        if ans.degraded:
            self._m_ladder.labels("degraded").inc()
            if ans.staleness_s > 0.0:
                self._m_ladder.labels("stale_serve").inc()

    def _finish(self, r: _Request) -> None:
        """Deliver a request's result to both completion channels."""
        if r.future is not None:
            try:
                if r.error is not None:
                    r.future.set_exception(r.error)
                else:
                    r.future.set_result(r.answer)
            except Exception:   # caller cancelled the future: result dropped
                pass
        r.done.set()

    # ----------------------------------------------------------- dispatcher
    def _flush_deadline(self, batch: list[_Request], t_first: float) -> float:
        """Latest time the pending batch may keep waiting: one window after
        the first request, tightened by any TimeBound that cannot afford the
        full window (its wait counts against its own bound)."""
        if self._last_batch_size <= 1 and len(batch) <= 1:
            return t_first   # solo traffic: flush now, don't tax latency
        deadline = t_first + self.config.batch_window_s
        for r in batch:
            if isinstance(r.query.bound, TimeBound):
                deadline = min(deadline,
                               r.t_submit + 0.5 * r.query.bound.seconds)
        return deadline

    def _collect_batch(self) -> list[_Request]:
        """Block until requests are pending, then drain for up to one
        batching window (or max_batch / deadline pressure)."""
        with self._cond:
            while not self._queue and not self._stop \
                    and not self._epoch_pending:
                self._cond.wait()
            if not self._queue:
                return []
            batch = [self._queue.popleft()]
            t_first = batch[0].t_submit
            while len(batch) < self.config.max_batch:
                while self._queue and len(batch) < self.config.max_batch:
                    batch.append(self._queue.popleft())
                if len(batch) >= self.config.max_batch or self._stop:
                    break
                remaining = self._flush_deadline(batch, t_first) \
                    - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
                if not self._queue:
                    # woke on timeout (or spurious): re-check clock
                    if self._flush_deadline(batch, t_first) \
                            <= time.monotonic():
                        break
        return batch

    def _dispatch_loop(self) -> None:
        try:
            while True:
                batch = self._collect_batch()
                self._beat_step += 1
                self.heartbeat.beat(0, self._beat_step)
                # Track the held batch so a dispatcher death between
                # dequeue and delivery still fails these requests (they are
                # in neither the queue nor anyone else's hands).
                self._in_flight = batch
                # Fault site: a kill here models the dispatcher thread
                # dying unexpectedly while it owns a collected batch.
                inject.site("scheduler.dispatch")
                if batch:
                    self._execute(batch)
                self._in_flight = []
                with self._cond:
                    self._epoch_pending = False
                    if self._stop and not self._queue:
                        return
                self._promote_hot_families()
                if self._drift_pending():
                    self._run_workload_epoch()
        except BaseException as e:   # noqa: BLE001 — dispatcher-death safety
            self._on_dispatcher_death(e)

    def _on_dispatcher_death(self, err: BaseException) -> None:
        """The dispatcher loop died of an unexpected exception: mark the
        service unhealthy (later admissions are rejected with a typed
        error), then fail every request it was holding or that was queued —
        their submitters must not hang until their timeouts."""
        _, age = self.heartbeat.stalest()
        failure = ServiceUnhealthyError(
            f"dispatcher thread died: {err!r} "
            f"(last heartbeat {age:.1f}s ago)")
        failure.__cause__ = err
        with self._cond:
            self._failed = failure
            pending = list(self._in_flight) + list(self._queue)
            self._in_flight = []
            self._queue.clear()
            self._cond.notify_all()
        for r in pending:
            if r.done.is_set():
                continue
            e = ServiceUnhealthyError(
                f"request abandoned: dispatcher thread died ({err!r})")
            e.__cause__ = err
            r.error = e
            self._finish_trace(r.trace, e)
            self._finish(r)

    def _execute(self, batch: list[_Request]) -> None:
        """One coalesced engine call for the whole batch. Identical
        normalized queries collapse onto one slot (the scan answers once;
        every duplicate request gets the same Answer). Holds the execution
        lock end to end — the solo bypass serializes against it."""
        with self._exec_lock:
            self._execute_batch(batch)

    def _execute_batch(self, batch: list[_Request]) -> None:
        self._last_batch_size = len(batch)
        slots: dict[Query, int] = {}
        unique: list[Query] = []
        for r in batch:
            if r.query not in slots:
                slots[r.query] = len(unique)
                unique.append(r.query)
        # Generation snapshots BEFORE execution: an answer computed against
        # pre-mutation samples must be cached under pre-mutation generations
        # (a concurrent mutation then invalidates it instead of blessing it).
        snapshots = ({t: self.cache.snapshot(t)
                      for t in {q.table for q in unique}}
                     if self.cache is not None else {})
        t_exec = time.monotonic()
        for r in batch:
            if r.trace is not None:
                # Backfill the queue wait (admission → this execution slot):
                # t_submit is the same monotonic clock spans use.
                rec = r.trace.open_span("admit", {"batch": len(batch)})
                r.trace.close_span(rec)
                rec.t0, rec.t1 = r.t_submit, t_exec
        traces = [r.trace for r in batch if r.trace is not None]
        try:
            # The shared call activates EVERY sampled trace in the batch:
            # a coalesced scan legitimately belongs to each query it serves.
            with obs_trace.activate(*traces):
                answers: list = self._retry(lambda: self.db.query_batch(
                    unique, deadline_headroom_s=self.config.batch_window_s))
        except BaseException:                # noqa: BLE001
            # One bad query must not poison every session in the batch:
            # fall back to per-query execution so each request gets its OWN
            # answer, degraded answer, or error — and each failing query
            # walks the ladder's lower rungs individually. Only THAT query's
            # traces are active here — ladder spans must not leak into the
            # rest of the batch.
            answers = []
            for q in unique:
                trs = [r.trace for r in batch if r.query == q]
                try:
                    with obs_trace.activate(*trs):
                        answers.append(self._retry(
                            lambda q=q: self.db.query_batch(
                                [q],
                                deadline_headroom_s=self.config.batch_window_s
                            )[0]))
                except BaseException as e:   # noqa: BLE001 — per-query
                    with obs_trace.activate(*trs):
                        answers.append(self._fallback_result(q, e))
        self._note_exec_time(time.monotonic() - t_exec)
        self._m_batches.inc()
        self._m_queries.labels("batch").inc(len(batch))
        self._m_width.observe(float(len(batch)))
        for q, ans in zip(unique, answers):
            # Degraded answers (shard loss, stale re-serves) are never
            # cached: the cache must only ever hit with full-fidelity
            # answers, or a transient fault would echo for the key's
            # whole cache lifetime.
            if self.cache is not None and not isinstance(ans, BaseException) \
                    and not ans.degraded:
                self.cache.put(q, ans, snapshot=snapshots[q.table])
        claimed: set[int] = set()
        for r in batch:
            result = answers[slots[r.query]]
            if isinstance(result, BaseException):
                if id(result) in claimed:
                    # Deduped requests must not share one exception object —
                    # concurrent raises from several session threads would
                    # fight over __traceback__.
                    try:
                        copy = type(result)(*result.args)
                        copy.__cause__ = result
                        result = copy
                    except Exception:   # exotic ctor: fall back to sharing
                        pass
                claimed.add(id(result))
                r.error = result
                self._finish_trace(r.trace, result)
            else:
                # Trace attachment is per-REQUEST and happens here, after
                # the cache.put loop above: the cache only ever holds
                # untraced answers, and deduped requests each get their own
                # traced copy.
                r.answer = self._attach_trace(result, r.trace)
                self._count_served(result)
                self.monitor.record(
                    r.query, result,
                    elapsed_s=time.monotonic() - r.t_submit)
            self._finish(r)

    def _run_workload_epoch(self) -> None:
        """Template churn past the drift threshold: §3.2 re-optimization with
        the OBSERVED workload, no data delta (docs/SERVICE.md). Runs on the
        dispatcher thread, serialized with query execution. With a fleet
        maintainer each drifted table gets its own epoch — per-table drift
        scoring, per-table templates, one shared evidence counter."""
        for table in self.maintainer.tables:
            if not self.monitor.should_reoptimize(table):
                continue
            templates = self.monitor.templates(table)
            if not templates:
                # Nothing stratifiable in the window (pure aggregates):
                # rebase so the trigger doesn't re-fire on every request.
                self.monitor.rebase(table=table)
                continue
            try:
                with self._exec_lock:
                    report = self.maintainer.run_workload_epoch(
                        templates, table=table)
                report["table"] = table
                report["drift_score"] = self.monitor.drift_score(table)
            except Exception as e:   # noqa: BLE001 — an epoch failure must
                # not kill the dispatcher. Do NOT rebase: the optimizer
                # never consumed these templates, so the drift signal must
                # survive. Resetting the evidence counter backs the retry
                # off until another min_queries of traffic accrues.
                self.workload_epochs.append({"table": table,
                                             "error": repr(e)})
                self.monitor.defer()
                continue
            self.workload_epochs.append(report)
            self.monitor.rebase(templates)

    # ------------------------------------------------------- observability
    def metrics_snapshot(self) -> dict:
        """One merged, stable-schema document (docs/OBSERVABILITY.md): the
        engine's registry (engine/scheduler/cache/workload/maintenance
        planes) unioned with the process-global registry (fault injection).
        This is what `SHOW METRICS` returns."""
        return obs_metrics.merge_snapshots(
            self.db.metrics.snapshot(),
            obs_metrics.default_registry().snapshot())

    def render_prometheus(self) -> str:
        """The merged snapshot in Prometheus text exposition format."""
        return obs_metrics.render_prometheus(self.metrics_snapshot())

    def explain(self, query: str | Query,
                timeout: float | None = None) -> dict:
        """Execute with tracing FORCED (sampling bypassed; honored unless
        config.trace is False) and return a JSON-friendly report:
        {"answer": Answer, "trace": span tree, "timings": stage seconds,
        "plan": the planner's decision attributes (family, K, certified,
        ...)}."""
        t0 = time.monotonic()
        text = query if isinstance(query, str) else repr(query)
        if isinstance(query, str):
            query = parse_blinkql(query, self.db)
        q = query.normalized()
        tr = self._start_trace(q, text, t0, time.monotonic(), forced=True)
        ans = self._submit_traced(q, tr, t0, timeout)
        if tr is None:   # tracing disabled by config: answer only
            return {"answer": ans, "trace": None, "timings": {}, "plan": {}}
        plan: dict = {}
        for s in tr.find("plan"):
            plan.update(s.attrs)
        if not plan and tr.find("cache"):
            plan["cached"] = True
        return {"answer": ans, "trace": tr.to_dict(),
                "timings": tr.timings(), "plan": plan}

    def execute(self, text: str, timeout: float | None = None):
        """One BlinkQL statement of ANY kind:

        * ``SELECT ...``                     → Answer (exactly `submit`);
        * ``EXPLAIN <select>``               → the `explain` report dict;
        * ``SHOW METRICS``                   → merged snapshot dict;
        * ``SHOW METRICS FORMAT PROMETHEUS`` → exposition text (str).
        """
        stmt = parse_statement(text, self.db)
        if isinstance(stmt, ShowMetrics):
            if stmt.fmt == "prometheus":
                return self.render_prometheus()
            return self.metrics_snapshot()
        if isinstance(stmt, Explain):
            return self.explain(stmt.text, timeout=timeout)
        return self.submit(stmt, timeout=timeout)

    # ----------------------------------------------------------- stats
    def stats(self) -> dict:
        out = {
            "batches": self.n_batches,
            "queries": self.n_queries,
            "coalescing": (self.n_queries / self.n_batches
                           if self.n_batches else 0.0),
            "workload_epochs": len(self.workload_epochs),
            "degraded": self.n_degraded,
            "stale": self.n_stale,
            "shed": self.n_shed,
            "healthy": self.healthy,
        }
        if self.cache is not None:
            out["cache"] = dataclasses.asdict(self.cache.stats)
        return out
