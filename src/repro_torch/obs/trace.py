"""Per-query tracing: lightweight spans, `QueryTrace`, ring-buffer retention
(counterpart of `repro.obs.trace`, pure Python).

Design constraints (docs/OBSERVABILITY.md):

* **Cheap when off.** `span()` with no trace active on the calling thread is
  a few dict ops — one thread-local read and a singleton no-op context
  manager. Engine/executor code declares spans unconditionally; whether they
  record anything is the SERVICE's decision (sampling policy).
* **Sampled when on.** The service traces every contract query (ErrorBound /
  TimeBound — their provenance is the product) and every query submitted
  while a fault plan is armed (degraded answers must arrive with a complete
  trace); unbounded hot-path traffic is traced 1-in-N (`sample_every`).
* **Thread-safe across the scheduler.** A request's spans start on its
  session thread (parse, admission), continue on the dispatcher thread
  (plan, scan, estimate), and may interleave with other traces — the
  active-trace set is thread-local, each trace's span list is lock-guarded,
  and cross-thread spans nest under the anchor span the activating side
  designated (`QueryTrace.set_anchor`).
* **Monotonic.** All stamps come from `obs.clock.now_s`.

The span taxonomy the serving path emits is cataloged in
docs/OBSERVABILITY.md; tests/test_obs.py asserts ladder completeness.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from repro_torch.obs.clock import now_s

_TLS = threading.local()


@dataclass
class SpanRecord:
    """One completed (or still-open) span inside a QueryTrace."""
    index: int                    # position in QueryTrace.spans
    parent: int                   # parent span index (-1 = trace root)
    name: str
    t0: float                     # monotonic start
    t1: float                     # monotonic end (== t0 while open)
    thread: str
    attrs: dict[str, Any] = field(default_factory=dict)

    @property
    def dur_s(self) -> float:
        return max(0.0, self.t1 - self.t0)


class QueryTrace:
    """The span tree of one query's life through the service.

    Spans append under a per-trace lock (several threads may be recording
    into one trace); nesting is tracked per thread via index stacks, with
    cross-thread adoption anchored at `set_anchor`'s span.
    """

    __slots__ = ("query_text", "reason", "t0", "t1", "error", "spans",
                 "_lock", "_stacks", "_anchor")

    def __init__(self, query_text: str = "", reason: str = "sampled"):
        self.query_text = query_text
        self.reason = reason          # "contract" | "fault" | "sampled" | "forced"
        self.t0 = now_s()
        self.t1: float | None = None
        self.error: str | None = None
        self.spans: list[SpanRecord] = []
        self._lock = threading.Lock()
        self._stacks: dict[int, list[int]] = {}   # thread ident -> index stack
        self._anchor = -1

    # -- recording (called by _Span under activation) ------------------------
    def set_anchor(self, index: int) -> None:
        """Designate the span new threads nest under when they adopt this
        trace (the scheduler anchors at the request's root span before
        handing the trace to the dispatcher)."""
        self._anchor = index

    def open_span(self, name: str, attrs: dict[str, Any]) -> SpanRecord:
        ident = threading.get_ident()
        t0 = now_s()
        with self._lock:
            stack = self._stacks.get(ident)
            if stack is None:
                stack = self._stacks[ident] = [self._anchor]
            rec = SpanRecord(len(self.spans), stack[-1], name, t0, t0,
                             threading.current_thread().name, attrs)
            self.spans.append(rec)
            stack.append(rec.index)
        return rec

    def close_span(self, rec: SpanRecord) -> None:
        rec.t1 = now_s()
        ident = threading.get_ident()
        with self._lock:
            stack = self._stacks.get(ident)
            if stack and stack[-1] == rec.index:
                stack.pop()

    def finish(self, error: str | None = None) -> None:
        self.t1 = now_s()
        if error is not None:
            self.error = error

    # -- reading -------------------------------------------------------------
    @property
    def total_s(self) -> float:
        end = self.t1 if self.t1 is not None else now_s()
        return max(0.0, end - self.t0)

    def find(self, name: str) -> list[SpanRecord]:
        """All spans with this exact name (completed trace; no lock)."""
        return [s for s in self.spans if s.name == name]

    def span_names(self) -> list[str]:
        return [s.name for s in self.spans]

    def children(self, index: int) -> list[SpanRecord]:
        return [s for s in self.spans if s.parent == index]

    def timings(self) -> dict[str, float]:
        """Stage breakdown for `Answer.timings`: seconds per top-level stage
        (the dotted span prefix — "scan.shard" folds into "scan"), counting
        only OUTERMOST spans of each stage so nested same-stage spans don't
        double-bill, plus "total"."""
        stage_of = [s.name.split(".", 1)[0] for s in self.spans]
        out: dict[str, float] = {}
        for s in self.spans:
            stage = stage_of[s.index]
            p = s.parent
            inner = False
            while p >= 0:
                if stage_of[p] == stage:
                    inner = True
                    break
                p = self.spans[p].parent
            if not inner:
                out[stage] = out.get(stage, 0.0) + s.dur_s
        out["total"] = self.total_s
        return out

    def to_dict(self) -> dict:
        """JSON-friendly rendering (EXPLAIN / debugging)."""
        return {
            "query": self.query_text,
            "reason": self.reason,
            "total_s": self.total_s,
            "error": self.error,
            "spans": [
                {"index": s.index, "parent": s.parent, "name": s.name,
                 "dur_s": s.dur_s, "t_rel_s": s.t0 - self.t0,
                 "thread": s.thread, "attrs": dict(s.attrs)}
                for s in self.spans
            ],
        }


class _NullSpan:
    """Singleton no-op: the no-listener fast path of `span()`."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL = _NullSpan()


class _Span:
    """Live span recording into every trace active on this thread."""
    __slots__ = ("_recs",)

    def __init__(self, traces: tuple[QueryTrace, ...], name: str,
                 attrs: dict[str, Any]):
        # Each trace gets its OWN record (attrs shared copy-on-first is not
        # worth the aliasing risk: .set() must reach all of them anyway).
        self._recs = [(tr, tr.open_span(name, dict(attrs)))
                      for tr in traces]

    def set(self, **attrs) -> "_Span":
        for _, rec in self._recs:
            rec.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, etype, evalue, tb) -> bool:
        if etype is not None:
            for _, rec in self._recs:
                rec.attrs.setdefault("error", etype.__name__)
        for tr, rec in self._recs:
            tr.close_span(rec)
        return False


def span(name: str, **attrs):
    """Open a span on every trace active on this thread; a cheap no-op
    (thread-local read + singleton) when none is. Usable as a context
    manager; `.set(**attrs)` adds attributes discovered mid-span."""
    active = getattr(_TLS, "active", None)
    if not active:
        return _NULL
    return _Span(active, name, attrs)


class activate:
    """Context manager making `traces` active on the CURRENT thread (spans
    opened inside record into each). Nests: already-active traces stay
    active; duplicates are not double-recorded."""

    __slots__ = ("_traces", "_prev")

    def __init__(self, *traces: "QueryTrace | None"):
        self._traces = tuple(t for t in traces if t is not None)
        self._prev: tuple[QueryTrace, ...] = ()

    def __enter__(self) -> "activate":
        self._prev = getattr(_TLS, "active", ())
        fresh = tuple(t for t in self._traces if t not in self._prev)
        _TLS.active = self._prev + fresh
        return self

    def __exit__(self, *exc) -> bool:
        _TLS.active = self._prev
        return False


def active_traces() -> tuple[QueryTrace, ...]:
    """The traces active on this thread (tests / introspection)."""
    return tuple(getattr(_TLS, "active", ()))


def tracing_active() -> bool:
    """True when a trace is active on this thread — the guard instrumented
    code uses before computing EXPENSIVE span attributes (cheap attrs just
    ride `span(...)`/`.set(...)`, which no-op by themselves)."""
    return bool(getattr(_TLS, "active", None))


class Tracer:
    """Sampling policy + ring-buffer retention of finished QueryTraces.

    One per service (isolated retention); the module default serves direct
    engine use and tests. `should_sample` implements the policy: contract
    queries and armed-fault-plan traffic always trace; everything else
    1-in-`sample_every` (0 disables the unconditional stream)."""

    def __init__(self, capacity: int = 256, sample_every: int = 16):
        self.capacity = int(capacity)
        self.sample_every = int(sample_every)
        self.enabled = True
        self._ring: deque[QueryTrace] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def should_sample(self, *, contract: bool = False,
                      forced: bool = False) -> str | None:
        """The sampling decision as a retention REASON, or None (don't
        trace). Checked once at query start — degraded answers only arise
        under an armed fault plan, so "fault" covers always-on-for-degraded
        without needing to predict the outcome."""
        if not self.enabled:
            return None
        if forced:
            return "forced"
        if contract:
            return "contract"
        from repro_torch.fault import inject  # lazy: no import cycle at load
        if inject.active() is not None:
            return "fault"
        if self.sample_every <= 0:
            return None
        with self._lock:
            self._seq += 1
            n = self._seq
        return "sampled" if n % self.sample_every == 0 else None

    def start(self, query_text: str, reason: str) -> QueryTrace:
        return QueryTrace(query_text, reason)

    def finish(self, trace: QueryTrace, error: str | None = None) -> None:
        trace.finish(error)
        with self._lock:
            self._ring.append(trace)

    def recent(self) -> list[QueryTrace]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_DEFAULT_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-default tracer (direct engine use, tests)."""
    return _DEFAULT_TRACER
