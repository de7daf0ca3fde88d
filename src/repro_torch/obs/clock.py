"""The observability plane's clocks (counterpart of `repro.obs.clock`;
docs/OBSERVABILITY.md).

Every duration in traces, histograms, and EWMA load models MUST come from
the monotonic clock — a wall-clock (`time.time`) stamp can jump backwards
under NTP slew and turn a span duration or a heartbeat age negative. The
repo-wide lint (ruff TID251) bans bare `time.time()` in library code and
points here:

* `now_s()`  — monotonic seconds; meaningless absolutely, exact relatively.
  Use for spans, ages, timeouts, backoffs, EWMAs.
* `wall_s()` — wall-clock UNIX seconds, for the few places an ABSOLUTE
  stamp is the point (checkpoint metadata that outlives the process).
"""
from __future__ import annotations

import time


def now_s() -> float:
    """Monotonic seconds (duration/age arithmetic only)."""
    return time.monotonic()


def wall_s() -> float:
    """Wall-clock UNIX seconds (absolute stamps that outlive the process)."""
    return time.time()  # noqa: TID251 — the one sanctioned wall-clock read
