"""Lock-light metrics registry: counters, gauges, log-bucketed histograms
(counterpart of `repro.obs.metrics`, pure Python, the same instruments and
snapshot document).

Design:

* **Typed instrument handles.** `registry.counter(name, ...)` returns the
  same `Counter` on every call (idempotent by name, type-checked), so
  subsystems grab their handles once at construction and the hot path is a
  bound method on a child — no registry lookup, no global lock.
* **Lock-light.** The registry lock is taken only to create instruments and
  label children; increments/sets take one tiny per-child lock.
* **Quantiles without samples.** `Histogram` buckets observations into a
  fixed geometric grid (factor 2 from 1 µs up), keeping count/sum per bucket
  — p50/p95/p99 interpolate inside the winning bucket, O(#buckets) memory
  regardless of traffic.
* **Stable snapshots.** `snapshot()` is a deterministic, JSON-serializable
  document (sorted names, sorted label keys, schema_version pinned);
  `render_prometheus()` emits text exposition format for scrapers.

Scoping: engine-owned state (the sample maintainer) lives on the ENGINE's
registry (`BlinkDB.metrics`), so two engines in one process do not bleed
counters into each other; `default_registry()` is the process-global one.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Callable, Iterable

SCHEMA_VERSION = 1

# Geometric bucket grid shared by every histogram: 1 µs · 2^i. 40 buckets
# reach ~1.1e6 s; observations outside clip into the end buckets.
_BUCKET_LO = 1e-6
_BUCKET_FACTOR = 2.0
_N_BUCKETS = 40
_BOUNDS = tuple(_BUCKET_LO * _BUCKET_FACTOR ** i for i in range(_N_BUCKETS))


def _label_key(values: tuple[str, ...]) -> str:
    return ",".join(values)


class _Instrument:
    """Shared naming/label plumbing. Children are keyed by label-value
    tuples; the default (unlabeled) child is created eagerly for ()-label
    instruments so the hot path never touches the children dict."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}

    def _child_cls(self):
        raise NotImplementedError

    def labels(self, *values):
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label "
                f"value(s) {self.label_names}, got {key}")
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._child_cls()())
        return child

    def collect(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class _CounterChild:
    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Counter(_Instrument):
    """Monotone accumulator. `inc()` on the default child for unlabeled
    counters, `labels(...).inc()` otherwise."""

    kind = "counter"

    def _child_cls(self):
        return _CounterChild

    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def value(self, *label_values) -> float:
        return self.labels(*label_values).value


class _GaugeChild:
    __slots__ = ("_lock", "_v", "_fn")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0
        self._fn: Callable[[], float] | None = None

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def set_function(self, fn: Callable[[], float]) -> None:
        """Callback gauge: evaluated at snapshot time (queue depths,
        heartbeat ages — values that already live somewhere)."""
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")   # a dead callback must not kill scrapes
        return self._v


class Gauge(_Instrument):
    kind = "gauge"

    def _child_cls(self):
        return _GaugeChild

    def set(self, v: float) -> None:
        self.labels().set(v)

    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def set_function(self, fn: Callable[[], float], *label_values) -> None:
        self.labels(*label_values).set_function(fn)

    def value(self, *label_values) -> float:
        return self.labels(*label_values).value


class _HistogramChild:
    __slots__ = ("_lock", "counts", "n", "sum")

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = [0] * _N_BUCKETS
        self.n = 0
        self.sum = 0.0

    def observe(self, x: float) -> None:
        x = float(x)
        if x <= _BUCKET_LO:
            i = 0
        else:
            i = min(_N_BUCKETS - 1,
                    int(math.log(x / _BUCKET_LO, _BUCKET_FACTOR)) + 1)
        with self._lock:
            self.counts[i] += 1
            self.n += 1
            self.sum += x

    def quantile(self, q: float) -> float:
        """Geometric interpolation inside the winning bucket — no stored
        samples. 0.0 with no observations."""
        with self._lock:
            n = self.n
            counts = list(self.counts)
        if n == 0:
            return 0.0
        target = q * n
        cum = 0
        for i, c in enumerate(counts):
            if cum + c >= target and c > 0:
                lo = _BUCKET_LO * _BUCKET_FACTOR ** max(i - 1, 0) \
                    if i > 0 else 0.0
                hi = _BOUNDS[i]
                frac = (target - cum) / c
                if lo <= 0.0:
                    return hi * frac
                return lo * (hi / lo) ** frac
            cum += c
        return _BOUNDS[-1]


class Histogram(_Instrument):
    """Log-bucketed duration/size histogram with p50/p95/p99 estimation."""

    kind = "histogram"

    def _child_cls(self):
        return _HistogramChild

    def observe(self, x: float) -> None:
        self.labels().observe(x)

    def quantile(self, q: float, *label_values) -> float:
        return self.labels(*label_values).quantile(q)


class MetricsRegistry:
    """A namespace of instruments. Creation is idempotent by name; a name
    re-declared as a different type or label set raises (catching the
    instrumentation bug at import/construction, not scrape time)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Instrument] = {}

    def _get(self, cls, name: str, help: str,
             labels: tuple[str, ...]) -> _Instrument:
        inst = self._metrics.get(name)
        if inst is not None:
            if not isinstance(inst, cls) or \
                    inst.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{inst.kind}{inst.label_names}, not "
                    f"{cls.kind}{tuple(labels)}")
            return inst
        with self._lock:
            inst = self._metrics.get(name)
            if inst is None:
                inst = self._metrics[name] = cls(name, help, tuple(labels))
        return inst

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get(Counter, name, help, tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, tuple(labels))

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = ()) -> Histogram:
        return self._get(Histogram, name, help, tuple(labels))

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """Stable-schema JSON document:

            {"schema_version": 1,
             "counters":   {name: {"help", "labels", "values": {key: v}}},
             "gauges":     {... same shape ...},
             "histograms": {name: {..., "values": {key:
                 {"count", "sum", "p50", "p95", "p99"}}}}}

        Names and label keys sort deterministically; the same system state
        renders the same document."""
        out = {"schema_version": SCHEMA_VERSION,
               "counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, inst in metrics:
            entry: dict = {"help": inst.help,
                           "labels": list(inst.label_names), "values": {}}
            for key, child in inst.collect():
                lk = _label_key(key)
                if isinstance(inst, Histogram):
                    entry["values"][lk] = {
                        "count": child.n, "sum": child.sum,
                        "p50": child.quantile(0.50),
                        "p95": child.quantile(0.95),
                        "p99": child.quantile(0.99)}
                else:
                    entry["values"][lk] = child.value
            out[inst.kind + "s"][name] = entry
        return out

    def render_prometheus(self) -> str:
        """Text exposition format (histograms render as summaries: the
        quantiles are estimates, not raw bucket counts)."""
        return render_prometheus(self.snapshot())


def render_prometheus(snap: dict) -> str:
    """Render one (or a merged) snapshot() document as Prometheus text."""
    lines: list[str] = []

    def label_str(names: list[str], key: str, extra: str = "") -> str:
        pairs = []
        if key:
            pairs = [f'{n}="{v}"' for n, v in zip(names, key.split(","))]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""

    for kind, prom_type in (("counters", "counter"), ("gauges", "gauge"),
                            ("histograms", "summary")):
        for name, entry in sorted(snap.get(kind, {}).items()):
            if entry["help"]:
                lines.append(f"# HELP {name} {entry['help']}")
            lines.append(f"# TYPE {name} {prom_type}")
            for key, v in sorted(entry["values"].items()):
                ls = label_str(entry["labels"], key)
                if kind == "histograms":
                    for q in ("0.5", "0.95", "0.99"):
                        pq = v[f"p{str(q)[2:]}" if q != "0.5" else "p50"]
                        lines.append(
                            f"{name}"
                            f"{label_str(entry['labels'], key, f'quantile={chr(34)}{q}{chr(34)}')}"
                            f" {pq:.9g}")
                    lines.append(f"{name}_sum{ls} {v['sum']:.9g}")
                    lines.append(f"{name}_count{ls} {v['count']}")
                else:
                    lines.append(f"{name}{ls} {v:.9g}")
    return "\n".join(lines) + "\n"


def merge_snapshots(*snaps: dict) -> dict:
    """Union several snapshot() documents (engine registry + process-global
    fault registry). Name collisions keep the FIRST occurrence — scopes are
    disjoint by convention (engine_*/service_* vs fault_*)."""
    out = {"schema_version": SCHEMA_VERSION,
           "counters": {}, "gauges": {}, "histograms": {}}
    for snap in snaps:
        for kind in ("counters", "gauges", "histograms"):
            for name, entry in snap.get(kind, {}).items():
                out[kind].setdefault(name, entry)
    return out


def to_json(snap: dict) -> str:
    """Canonical serialization of a snapshot (sorted keys, stable floats)."""
    return json.dumps(snap, sort_keys=True, default=float)


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry: process-global planes only (fault
    injection); engine-scoped state belongs on `BlinkDB.metrics`."""
    return _DEFAULT
