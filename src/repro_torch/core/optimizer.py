"""Sample-creation optimization framework (paper §3.2; counterpart of
`repro.core.optimizer`, numpy only, same semantics).

Decides which column-sets φ get stratified sample families, maximizing

    G = Σ_i w_i · y_i · Δ(φ_i^T)                                   (Eq. 2)
    s.t. Σ_j Store(φ_j) · z_j ≤ S                                  (Eq. 3)
         y_i ≤ max_{φ_j ⊆ φ_i^T} |D(φ_j)|/|D(φ_i^T)| · z_j         (Eq. 4)
         Σ_j (δ_j - z_j)² Store(φ_j) ≤ r · Σ_j δ_j Store(φ_j)      (Eq. 5)

with z_j ∈ {0,1}, 0 ≤ y_i ≤ 1. The paper solves this MILP with GLPK; GLPK is
unavailable here, so we exploit the structure: given z, the optimal y_i is
  y_i(z) = min(1, max_{φ_j ⊆ φ_i^T, z_j=1} cov_ij),
making G(z) a monotone submodular set function → solved by
  * exact branch-and-bound (small candidate counts; used in tests as oracle),
  * lazy greedy by marginal-gain/storage ratio + pairwise swap local search
    (production path; (1-1/e)-style quality, verified against exact in tests).

Candidate generation follows §3.2.2: subsets of template column-sets only,
capped at `max_cols` columns.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.types import QueryTemplate


@dataclasses.dataclass(frozen=True)
class Candidate:
    phi: frozenset[str]
    storage: float        # Store(φ): bytes for SFam(φ)
    n_distinct: float     # |D(φ)|
    delta: float          # Δ(φ): # values with F < K (skew/tail length)


@dataclasses.dataclass
class Workload:
    templates: tuple[QueryTemplate, ...]
    # Δ(φ_i^T) and |D(φ_i^T)| per template (from table stats)
    template_delta: tuple[float, ...]
    template_distinct: tuple[float, ...]


@dataclasses.dataclass
class Solution:
    chosen: list[Candidate]
    objective: float
    storage_used: float
    coverage: dict[frozenset[str], float]  # y_i per template column set


def enumerate_candidates(
    templates: Sequence[QueryTemplate],
    stats: Callable[[frozenset[str]], tuple[float, float, float]],
    max_cols: int = 3,
) -> list[Candidate]:
    """§3.2.2: candidates = subsets (≤ max_cols) of template column sets.
    `stats(phi) -> (storage, n_distinct, delta)`."""
    seen: set[frozenset[str]] = set()
    out: list[Candidate] = []
    for t in templates:
        cols = sorted(t.columns)
        for r in range(1, min(len(cols), max_cols) + 1):
            for combo in itertools.combinations(cols, r):
                phi = frozenset(combo)
                if phi in seen:
                    continue
                seen.add(phi)
                storage, nd, delta = stats(phi)
                out.append(Candidate(phi, storage, nd, delta))
    return out


def _coverage_matrix(cands: Sequence[Candidate], wl: Workload) -> np.ndarray:
    """cov[i, j] = |D(φ_j)|/|D(φ_i^T)| if φ_j ⊆ φ_i^T else 0, clipped to 1."""
    m, a = len(wl.templates), len(cands)
    cov = np.zeros((m, a))
    for i, t in enumerate(wl.templates):
        di = max(wl.template_distinct[i], 1.0)
        for j, c in enumerate(cands):
            if c.phi <= t.columns:
                cov[i, j] = min(1.0, c.n_distinct / di)
    return cov


def _objective(selected: np.ndarray, cov: np.ndarray, wl: Workload) -> tuple[float, np.ndarray]:
    """G(z) with optimal y (Eq. 2/4)."""
    if selected.any():
        y = (cov[:, selected]).max(axis=1)
    else:
        y = np.zeros(len(wl.templates))
    w = np.array([t.weight for t in wl.templates])
    d = np.asarray(wl.template_delta)
    return float((w * y * d).sum()), y


def solve_greedy(cands: Sequence[Candidate], wl: Workload, budget: float,
                 existing: frozenset[frozenset[str]] = frozenset(),
                 change_fraction: float = 1.0,
                 swap_rounds: int = 2) -> Solution:
    """Lazy greedy (marginal gain / storage) + swap local search, honoring the
    Eq.-5 change budget against `existing` families."""
    cov = _coverage_matrix(cands, wl)
    a = len(cands)
    existing_idx = {j for j, c in enumerate(cands) if c.phi in existing}
    existing_storage = sum(cands[j].storage for j in existing_idx)
    change_budget = change_fraction * existing_storage if existing else float("inf")

    def feasible(sel: np.ndarray) -> bool:
        storage = sum(c.storage for c, s in zip(cands, sel) if s)
        if storage > budget:
            return False
        churn = sum(cands[j].storage for j in range(a)
                    if sel[j] != (j in existing_idx))
        return churn <= change_budget + 1e-9

    sel = np.zeros(a, dtype=bool)
    # Seed with existing families that still fit (minimizes churn, Eq. 5).
    for j in sorted(existing_idx, key=lambda j: -cands[j].storage):
        sel[j] = True
        if not feasible(sel):
            sel[j] = False

    base, _ = _objective(sel, cov, wl)
    # Lazy greedy: max-heap of stale upper bounds on marginal gain per byte.
    heap = [(-np.inf, j) for j in range(a) if not sel[j]]
    heapq.heapify(heap)
    while heap:
        _, j = heapq.heappop(heap)
        if sel[j]:
            continue
        sel[j] = True
        if not feasible(sel):
            sel[j] = False
            continue
        gain, _ = _objective(sel, cov, wl)
        sel[j] = False
        marg = (gain - base) / max(cands[j].storage, 1.0)
        if marg <= 0:
            continue
        if heap and -heap[0][0] > marg + 1e-15:
            heapq.heappush(heap, (-marg, j))  # stale: reinsert with fresh bound
            continue
        sel[j] = True
        base = gain

    # Swap local search: try replacing one chosen with one unchosen.
    for _ in range(swap_rounds):
        improved = False
        chosen_idx = [j for j in range(a) if sel[j]]
        for jout in chosen_idx:
            for jin in range(a):
                if sel[jin]:
                    continue
                sel[jout], sel[jin] = False, True
                if feasible(sel):
                    g, _ = _objective(sel, cov, wl)
                    if g > base + 1e-12:
                        base, improved = g, True
                        break
                sel[jout], sel[jin] = True, False
            else:
                continue
            break
        if not improved:
            break

    obj, y = _objective(sel, cov, wl)
    chosen = [c for c, s in zip(cands, sel) if s]
    return Solution(chosen, obj, sum(c.storage for c in chosen),
                    {t.columns: float(yi) for t, yi in zip(wl.templates, y)})


def solve_exact(cands: Sequence[Candidate], wl: Workload, budget: float,
                existing: frozenset[frozenset[str]] = frozenset(),
                change_fraction: float = 1.0) -> Solution:
    """Branch-and-bound exact solver (oracle for tests; α ≲ 24)."""
    cov = _coverage_matrix(cands, wl)
    a = len(cands)
    order = sorted(range(a), key=lambda j: -cands[j].delta)  # strong branching
    w = np.array([t.weight for t in wl.templates])
    d = np.asarray(wl.template_delta)
    existing_idx = {j for j, c in enumerate(cands) if c.phi in existing}
    existing_storage = sum(cands[j].storage for j in existing_idx)
    change_budget = change_fraction * existing_storage if existing else float("inf")

    best = {"obj": -1.0, "sel": np.zeros(a, dtype=bool)}

    def upper_bound(sel, depth):
        # Optimistic: everything not yet decided counts as selected.
        opt = sel.copy()
        for j in order[depth:]:
            opt[j] = True
        y = cov[:, opt].max(axis=1) if opt.any() else np.zeros(len(w))
        return float((w * np.minimum(y, 1.0) * d).sum())

    def rec(depth, sel, storage, churn):
        if storage > budget or churn > change_budget + 1e-9:
            return
        if upper_bound(sel, depth) <= best["obj"] + 1e-15:
            return
        if depth == a:
            obj, _ = _objective(sel, cov, wl)
            if obj > best["obj"]:
                best["obj"], best["sel"] = obj, sel.copy()
            return
        j = order[depth]
        was_existing = j in existing_idx
        # include
        sel[j] = True
        rec(depth + 1, sel, storage + cands[j].storage,
            churn + (0.0 if was_existing else cands[j].storage))
        # exclude
        sel[j] = False
        rec(depth + 1, sel, storage,
            churn + (cands[j].storage if was_existing else 0.0))

    rec(0, np.zeros(a, dtype=bool), 0.0, 0.0)
    sel = best["sel"]
    obj, y = _objective(sel, cov, wl)
    chosen = [c for c, s in zip(cands, sel) if s]
    return Solution(chosen, obj, sum(c.storage for c in chosen),
                    {t.columns: float(yi) for t, yi in zip(wl.templates, y)})
