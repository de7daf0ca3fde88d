"""Core datatypes of the port (counterpart of `repro.core.types`).

Columns are columnar and dictionary-encoded for categoricals: integer codes
on the device, value dictionaries on the host. Queries are aggregation
queries with DNF predicates, GROUP BY, and an optional error or time bound
(paper §2).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np
import torch


class ColumnKind(enum.Enum):
    CATEGORICAL = "categorical"  # integer dictionary codes
    NUMERIC = "numeric"          # float32 measures


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    name: str
    kind: ColumnKind
    # Number of distinct dictionary entries (categoricals only).
    cardinality: int = 0


@dataclasses.dataclass(frozen=True)
class TableSchema:
    name: str
    columns: tuple[ColumnSchema, ...]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in {self.name}: {names}")

    def column(self, name: str) -> ColumnSchema:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"no column {name!r} in table {self.name!r}")

    @property
    def column_names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    def with_cardinality(self, name: str, cardinality: int) -> "TableSchema":
        """Schema after a dictionary extension (append-only ingestion): the
        named categorical column's cardinality grows, nothing else moves."""
        cols = tuple(
            dataclasses.replace(c, cardinality=cardinality)
            if c.name == name else c
            for c in self.columns)
        return dataclasses.replace(self, columns=cols)


@dataclasses.dataclass
class TableDelta:
    """One append's worth of ingested rows, already dictionary-encoded.

    `Table.append` encodes the raw host columns against the table's
    dictionaries, extending them for unseen categorical values and never
    recoding existing rows, and returns this record so the sampling and
    executor layers can merge the delta into materialized families without
    touching pre-existing data (docs/MAINTENANCE.md).
    """
    table: str
    start_row: int                       # first appended row's index
    n_rows: int                          # rows in this delta
    # column name -> encoded HOST array (int32 codes / float32 measures)
    columns: dict[str, np.ndarray]
    # categorical column -> dictionary values first seen in this delta
    new_dict_values: dict[str, np.ndarray]


@dataclasses.dataclass
class TableMutation:
    """One delete's or update's worth of tombstoned (and re-inserted) rows.

    `Table.delete` marks matched live rows dead in the host tombstone mask;
    physical rows never move, so a row's physical index is a stable id the
    sample families key their rows on. `Table.update` also appends the
    touched rows with the assignments applied as an ordinary `TableDelta`
    (tombstone the old, insert the new).
    """
    table: str
    # physical row indices newly tombstoned (sorted, unique)
    tombstoned: np.ndarray
    # column name -> encoded HOST values of the tombstoned rows, as of death:
    # the sampling layer finds each dead row's stratum from these without
    # re-reading the base table
    tombstoned_columns: dict[str, np.ndarray]
    # re-inserted new versions (updates only; None for a pure delete)
    delta: "TableDelta | None" = None

    @property
    def n_tombstoned(self) -> int:
        return int(self.tombstoned.size)

    @property
    def n_reinserted(self) -> int:
        return self.delta.n_rows if self.delta is not None else 0


@dataclasses.dataclass
class TableCompaction:
    """One base-table compaction's worth of physically dropped rows.

    `Table.compact` drops every tombstoned row from the host columns (the
    one place physical rows move) and returns this record so every layer
    keyed on physical row ids (family `row_ids`, striped-block
    `slot_row_ids`) re-keys through `remap`. `remap[old_id]` is the row's
    new index, or -1 for a dropped row; live rows keep their relative
    order, so remapped sorted id arrays stay sorted.
    """
    table: str
    # int64[n_rows_before]: old physical id -> new physical id (-1 = dropped)
    remap: np.ndarray
    n_rows_before: int
    n_dropped: int

    @property
    def n_rows_after(self) -> int:
        return self.n_rows_before - self.n_dropped


class CmpOp(enum.Enum):
    EQ = "=="
    NE = "!="
    LT = "<"
    LE = "<="
    GT = ">"
    GE = ">="


# Position of each operator in the kernel's op table (kernels/csrc).
CMP_CODES = {CmpOp.EQ: 0, CmpOp.NE: 1, CmpOp.LT: 2, CmpOp.LE: 3,
             CmpOp.GT: 4, CmpOp.GE: 5}

# Bins of a QUANTILE histogram (one thread per bin in kernels/csrc).
QUANTILE_BINS = 256


def cmp_fns():
    """Canonical CmpOp -> torch comparator table, shared by the executor and
    the plain kernel versions."""
    return {
        CmpOp.EQ: torch.eq, CmpOp.NE: torch.ne,
        CmpOp.LT: torch.lt, CmpOp.LE: torch.le,
        CmpOp.GT: torch.gt, CmpOp.GE: torch.ge,
    }


def _canon_value(v) -> Any:
    """Canonical hashable Python scalar for a predicate constant: numpy
    scalars fold onto their Python equivalents, so cache keys and QCS
    statistics do not split on the producer's array library."""
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, (str, np.str_)):
        return str(v)
    return v


def _atom_order(a: "Atom") -> tuple:
    """Total order over atoms of any value type (repr breaks ties across
    types where `<` would raise)."""
    return (a.column, a.op.value, type(a.value).__name__, repr(a.value))


@dataclasses.dataclass(frozen=True)
class Atom:
    """A single comparison predicate: `column <op> value`. For categorical
    columns the value is the decoded value; it is encoded to its dictionary
    code when the predicate is bound to a table."""
    column: str
    op: CmpOp
    value: Any

    def normalized(self) -> "Atom":
        v = _canon_value(self.value)
        return self if v is self.value else dataclasses.replace(self, value=v)


@dataclasses.dataclass(frozen=True)
class Conjunction:
    """AND of atoms (paper §4.1.1)."""
    atoms: tuple[Atom, ...] = ()

    @property
    def columns(self) -> frozenset[str]:
        return frozenset(a.column for a in self.atoms)

    def normalized(self) -> "Conjunction":
        """Canonical atom order, duplicate atoms dropped (AND is
        idempotent): permutations of one conjunction compare and hash
        equal."""
        atoms = sorted((a.normalized() for a in self.atoms), key=_atom_order)
        return Conjunction(tuple(a for i, a in enumerate(atoms)
                                 if i == 0 or a != atoms[i - 1]))


@dataclasses.dataclass(frozen=True)
class Predicate:
    """Disjunction of conjunctions (paper §4.1.2 rewrites OR as a union of
    conjunctive queries)."""
    disjuncts: tuple[Conjunction, ...] = (Conjunction(),)

    @classmethod
    def true(cls) -> "Predicate":
        return cls((Conjunction(),),)

    @classmethod
    def where(cls, *atoms: Atom) -> "Predicate":
        return cls((Conjunction(tuple(atoms)),))

    @property
    def columns(self) -> frozenset[str]:
        out: frozenset[str] = frozenset()
        for d in self.disjuncts:
            out |= d.columns
        return out

    def normalized(self) -> "Predicate":
        """Sorted conjuncts, each in canonical atom order, duplicates dropped
        (OR is idempotent). Disjunct order is not semantic for the union
        rewrite, so sorting keeps the answer."""
        conjs = sorted((c.normalized() for c in self.disjuncts),
                       key=lambda c: tuple(_atom_order(a) for a in c.atoms))
        return Predicate(tuple(c for i, c in enumerate(conjs)
                               if i == 0 or c != conjs[i - 1]))


class AggOp(enum.Enum):
    COUNT = "count"
    SUM = "sum"
    AVG = "avg"
    QUANTILE = "quantile"


@dataclasses.dataclass(frozen=True)
class ErrorBound:
    """`ERROR WITHIN eps AT CONFIDENCE conf` (paper §2). eps is relative when
    `relative` else absolute. `strict` (`... OR FAIL`) turns an uncertifiable
    bound into BoundUnreachableError instead of an annotated answer."""
    eps: float
    confidence: float = 0.95
    relative: bool = True
    strict: bool = False


class BoundUnreachableError(RuntimeError):
    """Typed refusal for a strict ERROR WITHIN contract. Carries the best
    predicted half-width (in the bound's units)."""

    def __init__(self, msg: str, predicted_half_width: float | None = None):
        super().__init__(msg)
        self.predicted_half_width = predicted_half_width


@dataclasses.dataclass(frozen=True)
class TimeBound:
    """`WITHIN seconds SECONDS` (paper §2)."""
    seconds: float
    confidence: float = 0.95


@dataclasses.dataclass(frozen=True)
class Query:
    """An aggregation query: op(value_column) WHERE pred GROUP BY group_by."""
    table: str
    agg: AggOp
    value_column: str | None = None  # None valid for COUNT
    predicate: Predicate = Predicate.true()
    group_by: tuple[str, ...] = ()
    quantile: float = 0.5  # for AggOp.QUANTILE
    bound: ErrorBound | TimeBound | None = None
    joins: tuple = ()

    @property
    def where_group_columns(self) -> frozenset[str]:
        """Query template columns: WHERE ∪ GROUP BY (paper's φ^T)."""
        return self.predicate.columns | frozenset(self.group_by)

    def normalized(self) -> "Query":
        """Canonical, hashable form: the normalized predicate, and fields
        without meaning for the aggregate folded to defaults (COUNT ignores
        the value column; `quantile` matters only for QUANTILE), so cache
        keys and QCS statistics never split on permutations of one query.
        Idempotent."""
        bound = self.bound
        if isinstance(bound, ErrorBound):
            bound = ErrorBound(float(bound.eps), float(bound.confidence),
                               bool(bound.relative), bool(bound.strict))
        elif isinstance(bound, TimeBound):
            bound = TimeBound(float(bound.seconds), float(bound.confidence))
        return dataclasses.replace(
            self,
            predicate=self.predicate.normalized(),
            value_column=None if self.agg is AggOp.COUNT else self.value_column,
            group_by=tuple(str(c) for c in self.group_by),
            quantile=(float(self.quantile) if self.agg is AggOp.QUANTILE
                      else 0.5),
            bound=bound,
            joins=tuple(self.joins))


def normalize_query(q: Query) -> Query:
    """Module-level alias of Query.normalized (service cache and workload
    keys)."""
    return q.normalized()


@dataclasses.dataclass(frozen=True)
class QueryTemplate:
    """A workload template: WHERE/GROUP BY column set plus a weight."""
    columns: frozenset[str]
    weight: float


@dataclasses.dataclass
class GroupResult:
    key: tuple[Any, ...]          # decoded group-by values
    estimate: float
    stderr: float
    ci_low: float
    ci_high: float
    n_selected: float             # sampled rows matching the predicate
    exact: bool = False           # stratum fully contained in the sample


@dataclasses.dataclass
class Answer:
    query: Query
    groups: list[GroupResult]
    sample_phi: tuple[str, ...]   # family the query ran on
    sample_k: float               # resolution cap K used
    rows_read: int                # prefix length scanned
    rows_total: int               # rows in the original table
    elapsed_s: float
    confidence: float
    # Degradation provenance (docs/FAULTS.md): `degraded` marks an answer
    # whose error contract differs from the clean path's, by shard loss
    # (HT-reweighted, CIs widened) or by a stale cache serve (staleness_s >
    # 0 says how old).
    degraded: bool = False
    shards_lost: int = 0          # fault-domain shards with no live replica
    shards_total: int = 0         # logical shards scanned (0: unsharded)
    staleness_s: float = 0.0      # age of a stale-cache serve (0: fresh)
    # A-priori ERROR WITHIN contract provenance: `certified` says whether
    # the pilot certified (family, K) before the main scan; `bound_met` is
    # certified AND the realized CI half-width (after any degradation
    # widening) inside eps. None on unbounded and TimeBound queries.
    bound_met: bool | None = None
    certified: bool | None = None
    predicted_half_width: float | None = None
    # When the query was traced: its span tree (obs.trace.QueryTrace) and
    # per-stage seconds ({"parse": s, "plan": s, "scan": s, ..., "total":
    # s}). Metadata attached after execution and never cached: a traced
    # answer is bit-identical to an untraced one.
    trace: Any = None
    timings: dict[str, float] | None = None

    @property
    def max_rel_err(self) -> float:
        """The largest stderr / |estimate| over the answer's groups that are
        not exact (0.0 for a zero estimate; 0.0 when every group is exact)."""
        errs = [
            abs(g.stderr / g.estimate) if g.estimate else 0.0
            for g in self.groups if not g.exact
        ]
        return max(errs) if errs else 0.0
