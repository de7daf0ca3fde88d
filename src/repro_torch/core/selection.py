"""Run-time sample-family selection (paper §4.1; counterpart of
`repro.core.selection`, host-only numpy).

Conjunctive queries: if some family's column set φ_i is a superset of the
query's columns φ, pick the φ_i with the fewest columns (ties → smaller
storage). Otherwise probe the SMALLEST resolution of every family in parallel
and pick the family with the highest (rows selected)/(rows read) ratio.
Disjunctive queries are rewritten as unions of conjunctive queries (§4.1.2).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

from repro_torch.core.types import AggOp, Predicate, Query


@dataclasses.dataclass
class SelectionResult:
    phi: tuple[str, ...]
    reason: str                     # "superset" | "probe"
    probe_ratios: dict[tuple[str, ...], float] | None = None


def select_family(
    query_columns: frozenset[str],
    families: Mapping[tuple[str, ...], object],
    probe: Callable[[tuple[str, ...]], tuple[float, float]] | None = None,
) -> SelectionResult:
    """`families` maps φ -> family (the uniform family has φ=()).
    `probe(phi) -> (rows_selected, rows_read)` runs the query on the family's
    smallest resolution; only needed when no superset family exists."""
    supersets = [phi for phi in families
                 if phi and query_columns <= frozenset(phi)]
    if supersets:
        best = min(supersets, key=lambda p: (len(p), p))
        return SelectionResult(best, "superset")
    if not query_columns and () in families:
        return SelectionResult((), "superset")  # pure aggregate → uniform
    if probe is None:
        # Fall back to the uniform family when probing is disabled.
        return SelectionResult((), "probe", {})
    ratios = {}
    for phi in families:
        sel, read = probe(phi)
        ratios[phi] = sel / max(read, 1.0)
    best = max(ratios, key=lambda p: (ratios[p], -len(p)))
    return SelectionResult(best, "probe", ratios)


def rewrite_disjuncts(q: Query) -> list[Query]:
    """§4.1.2: a disjunctive query becomes a union of conjunctive sub-queries,
    each inheriting the bound (the engine combines their answers).

    Only additive aggregates (COUNT/SUM) can be recombined by summing
    per-disjunct estimates; AVG and QUANTILE are rejected up front — the
    previous behaviour silently summed per-disjunct averages/quantiles,
    which is wrong whenever disjunct weights differ.
    """
    if len(q.predicate.disjuncts) <= 1:
        return [q]
    if q.agg not in (AggOp.COUNT, AggOp.SUM):
        raise ValueError(
            f"disjunctive (OR) predicates only support additive aggregates "
            f"(COUNT/SUM); {q.agg} over a union of disjuncts is not the "
            f"aggregate over the union — rewrite the query per disjunct")
    return [
        dataclasses.replace(q, predicate=Predicate((conj,)))
        for conj in q.predicate.disjuncts
    ]
