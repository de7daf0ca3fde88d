"""Error-Latency Profiles (paper §4.2; counterpart of `repro.core.elp`).

Given a selected family, the ELP projects — from a probe run on the smallest
resolution — the resolution K_q that meets the query's error or time bound:

  * Error profile: Var ∝ 1/n (Table 2) ⇒ required selected-rows n_req =
    n_probe · Var_probe/Var_target; pick the smallest K whose expected
    selected rows ≥ n_req (paper: smallest K > n·K_m/n_{i,m}).
  * Latency profile: t(rows_read) is modeled linear (paper assumption,
    calibrated on small resolutions); pick the largest K with t(K) ≤ bound.

The port's scans read the whole block whatever K is (rows above K are
masked), so its probes time the largest resolution's scan: the engine fits
them there (`fit_whole_block`), not at the probed prefixes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.sampling import SampleFamily


@dataclasses.dataclass
class LatencyModel:
    """t = a * rows_read + b  (least squares over probe timings)."""
    a: float
    b: float

    def predict(self, rows: float) -> float:
        return self.a * rows + self.b

    def max_rows_within(self, seconds: float) -> float:
        if self.a <= 0:
            return float("inf")
        return max(0.0, (seconds - self.b) / self.a)


def fit_latency(rows: Sequence[float], times: Sequence[float]) -> LatencyModel:
    """Non-negative least squares for t = a·rows + b (both coefficients must
    be ≥ 0: negative throughput or startup cost is unphysical and corrupts
    `max_rows_within`). When the unconstrained optimum is infeasible the NNLS
    optimum lies on a boundary face, so refit each single-coefficient model
    under its own clamp and keep the lower-residual one — clamping the two
    coefficients independently (the old behaviour) keeps a coefficient that
    was biased by the very partner the clamp just discarded: a zeroed
    negative intercept leaves a too-steep slope that under-admits rows, and
    a zeroed negative slope leaves a flat model whose max_rows_within is
    unbounded, over-admitting without limit."""
    r = np.asarray(rows, dtype=np.float64)
    t = np.asarray(times, dtype=np.float64)
    if len(r) == 1:
        return LatencyModel(float(t[0] / max(r[0], 1.0)), 0.0)
    A = np.stack([r, np.ones_like(r)], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, t, rcond=None)
    if a >= 0.0 and b >= 0.0:
        return LatencyModel(float(a), float(b))
    a0 = max(float(np.dot(r, t) / max(np.dot(r, r), 1e-30)), 0.0)  # b = 0
    b0 = max(float(np.mean(t)), 0.0)                               # a = 0
    res_a = float(np.sum((a0 * r - t) ** 2))
    res_b = float(np.sum((b0 - t) ** 2))
    return LatencyModel(a0, 0.0) if res_a <= res_b else LatencyModel(0.0, b0)


def fit_whole_block(rows: float, times: Sequence[float]) -> LatencyModel:
    """t = a·rows through the origin, for probes that all read `rows`.

    Every probe's scan read the whole block, the largest resolution's
    `rows`, whatever its K. Fitted at the probed prefixes instead, the
    probes' spread, which is noise, became the slope, and the K admitted
    moved between the smallest and the largest from run to run. Here the
    mean time is the prediction at `rows`, so the largest K is admitted
    whenever that scan fits the bound."""
    return LatencyModel(float(np.mean(times)) / max(float(rows), 1.0), 0.0)


def pick_k_for_error(fam: SampleFamily, n_probe_selected, n_required,
                     k_probe: float) -> float | None:
    """Smallest K in the family whose expected selected rows ≥ n_required
    (paper §4.2: smallest K > n·K_m/n_{i,m}). Accepts per-group arrays —
    with GROUP BY, selected rows scale ∝ K *within each group-stratum*, so
    the binding constraint is the max over groups of n_req_g / n_probe_g.

    Returns None when the bound is UNREACHABLE on this family — no K (even
    the largest) projects enough selected rows, or the probe selected no
    rows at all (nothing to certify from). Callers must escalate (larger
    family, exact fallback) or annotate `bound_met=False`; the old code
    silently returned fam.ks[0] here and served a best-effort answer that
    claimed nothing about the bound it was busting."""
    n_probe = np.atleast_1d(np.asarray(n_probe_selected, dtype=np.float64))
    n_req = np.atleast_1d(np.asarray(n_required, dtype=np.float64))
    valid = n_probe > 0
    if not valid.any():
        return None  # no signal: nothing to certify from
    k_needed = float(np.max(n_req[valid] / n_probe[valid]) * k_probe)
    for k in sorted(fam.ks):           # ascending: smallest adequate K
        if k >= k_needed:
            return k
    return None


def pick_k_for_time(fam: SampleFamily, model: LatencyModel,
                    seconds: float, headroom_s: float = 0.0) -> float:
    """Largest K whose prefix is predicted to run within the bound.

    `headroom_s` is subtracted from the bound before projecting — the
    admission scheduler passes its batching-window length here, so a
    deadline-bound query that waits up to one window for coalescing still
    lands inside the user's bound: the scan budget is what remains AFTER the
    wait, not the full bound (docs/SERVICE.md)."""
    max_rows = model.max_rows_within(max(seconds - headroom_s, 0.0))
    best = min(fam.ks)
    for k, n_rows in zip(fam.ks, fam.prefix_sizes):  # ks descending
        if n_rows <= max_rows:
            return k
    return best


@dataclasses.dataclass
class ProbeResult:
    k: float
    rows_read: int
    rows_selected: float
    elapsed_s: float


def run_probes(fam: SampleFamily,
               run_at_k: Callable[[float], tuple[float, float]],
               n_probes: int = 2) -> list[ProbeResult]:
    """Time the query on the smallest n_probes resolutions (§4.2: run until
    scaling looks linear). run_at_k(k) -> (rows_selected, elapsed_s)."""
    out = []
    ks_asc = sorted(range(len(fam.ks)), key=lambda i: fam.ks[i])
    for i in ks_asc[:n_probes]:
        k = fam.ks[i]
        sel, dt = run_at_k(k)
        out.append(ProbeResult(k, fam.prefix_sizes[i], sel, dt))
    return out
