"""Columnar, dictionary-encoded tables (counterpart of `repro.core.table`).

Host side: value dictionaries and the encoded columns as numpy arrays (the
host mirrors every offline and mutation path reads). Device side: the same
columns as torch tensors on the engine's device, uploaded by `Table.to` —
only the exact base-table scan and the join gathers read them. Appends and
compactions change the host mirrors only and mark the device copies stale;
a stale column is uploaded again on its next access.

Mutation (docs/MAINTENANCE.md): appends extend the dictionaries without
recoding a row; deletes and updates tombstone rows in a host `live` mask,
so physical row indices stay stable ids until `compact` drops the dead rows.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.types import (CmpOp, ColumnKind, ColumnSchema,
                                    Predicate, TableCompaction, TableDelta,
                                    TableMutation, TableSchema)

# numpy comparators of the host-side predicate evaluation (the torch table
# is types.cmp_fns)
_NP_CMP = {
    CmpOp.EQ: np.equal, CmpOp.NE: np.not_equal,
    CmpOp.LT: np.less, CmpOp.LE: np.less_equal,
    CmpOp.GT: np.greater, CmpOp.GE: np.greater_equal,
}


class _LazyDeviceColumns(dict):
    """The device copies of a table's columns. A column whose host mirror
    changed (append, compact) is stale; it is uploaded again when it is
    next read through `[]`, `get`, `values` or `items`, so an append costs
    no device traffic until the exact path reads the table."""

    def __init__(self, mapping, owner: "Table"):
        super().__init__(mapping)
        self._owner = owner

    def _refresh(self, key) -> None:
        owner = self._owner
        if key in owner._stale_device:
            super().__setitem__(key, torch.from_numpy(
                owner.columns_host[key]).to(owner._device))
            owner._stale_device.discard(key)

    def __getitem__(self, key):
        self._refresh(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        return self[key] if key in self else default

    def items(self):
        for k in list(super().keys()):
            self._refresh(k)
        return super().items()

    def values(self):
        for k in list(super().keys()):
            self._refresh(k)
        return super().values()


@dataclasses.dataclass
class Table:
    schema: TableSchema
    # host mirrors: column name -> int32 codes (categorical) / f32 (numeric)
    columns_host: dict[str, np.ndarray]
    # column name -> numpy array of dictionary values (categoricals only)
    dictionaries: dict[str, np.ndarray]
    n_rows: int
    # device copies of columns_host (empty until `to` is called)
    columns: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # host tombstone mask: live[i] False once physical row i is deleted or
    # superseded by an update. None means every row is live. Physical rows
    # never move until `compact`: a row's index is the stable id the
    # sampling layer keys its rows on.
    live: np.ndarray | None = None
    # columns whose device copy lags the host mirror
    _stale_device: set = dataclasses.field(default_factory=set, repr=False)
    _device: torch.device | None = dataclasses.field(default=None, repr=False)
    _live_count: int | None = dataclasses.field(default=None, repr=False)
    _live_device: torch.Tensor | None = dataclasses.field(default=None,
                                                          repr=False)

    def __post_init__(self):
        if not isinstance(self.columns, _LazyDeviceColumns):
            if self.columns and self._device is None:
                self._device = next(iter(dict.values(self.columns))).device
            self.columns = _LazyDeviceColumns(self.columns, self)

    @property
    def n_live(self) -> int:
        """Live (non-tombstoned) rows; n_rows for a table without deletes."""
        if self.live is None:
            return self.n_rows
        if self._live_count is None:
            self._live_count = int(self.live.sum())
        return self._live_count

    def live_mask_device(self) -> torch.Tensor:
        """The tombstone mask on the table's device (the exact path ANDs
        it into its predicate). Cached; dropped by delete, update, append
        and compact."""
        if self._live_device is None:
            mask = (np.ones(self.n_rows, dtype=bool) if self.live is None
                    else self.live)
            self._live_device = torch.from_numpy(mask).to(
                self._device or "cpu")
        return self._live_device

    @property
    def device(self) -> torch.device | None:
        return self._device

    def to(self, device) -> "Table":
        """Upload every column to `device` (a no-op when already there)."""
        device = torch.device(device)
        if self._device != device:
            self._device = device
            self._stale_device.clear()
            self._live_device = None
            self.columns = _LazyDeviceColumns(
                {c: torch.from_numpy(a).to(device)
                 for c, a in self.columns_host.items()}, self)
        return self

    def host_column(self, name: str) -> np.ndarray:
        return self.columns_host[name]

    def column_codes(self, name: str) -> torch.Tensor:
        """The column on the table's device (a categorical's int32 codes)."""
        return self.columns[name]

    def cardinality(self, name: str) -> int:
        return self.schema.column(name).cardinality

    def encode_value(self, name: str, value) -> int:
        """Host-side: map a raw categorical value to its dictionary code."""
        d = self.dictionaries[name]
        idx = np.nonzero(d == value)[0]
        if idx.size == 0:
            return -1  # matches no row
        return int(idx[0])

    def decode_value(self, name: str, code: int):
        return self.dictionaries[name][code]

    def row_bytes(self) -> int:
        return 4 * len(self.columns_host)

    @property
    def nbytes(self) -> int:
        return self.row_bytes() * self.n_rows

    def _strip_gathered(self) -> None:
        """Drop the gathered join attributes ("dim.col"): they cannot ride a
        schema-only delta or a compaction (the engine regathers them)."""
        for c in [c for c in self.columns_host if "." in c]:
            del self.columns_host[c]
            dict.pop(self.columns, c, None)
            self._stale_device.discard(c)

    def _set_host(self, name: str, arr: np.ndarray) -> None:
        """Replace a host mirror; its device copy (if any) goes stale."""
        self.columns_host[name] = arr
        if name in self.columns:
            self._stale_device.add(name)

    def append(self, raw: Mapping[str, np.ndarray]) -> TableDelta:
        """Append-only ingestion: encode a delta of host rows against the
        existing dictionaries and concatenate it onto the host mirrors.

        Existing rows are never recoded: values already in a dictionary
        keep their code, unseen values get fresh codes past the current
        cardinality (the dictionary is extended, not rebuilt). Returns the
        TableDelta the sampling layer merges into the families.
        """
        schema_cols = set(self.schema.column_names)
        got = set(raw.keys())
        if got != schema_cols:
            raise ValueError(
                f"append to {self.schema.name!r}: delta columns {sorted(got)} "
                f"!= schema columns {sorted(schema_cols)}")
        # Validate AND encode the whole delta before mutating anything: a
        # rejection (ragged lengths, a measure that will not cast to f32)
        # must leave no dictionary entry or cardinality behind.
        n_delta = None
        encoded: dict[str, np.ndarray] = {}
        new_dict_values: dict[str, np.ndarray] = {}
        for cname in self.schema.column_names:
            values = np.asarray(raw[cname])
            if n_delta is None:
                n_delta = len(values)
            elif len(values) != n_delta:
                raise ValueError(
                    f"column {cname}: length {len(values)} != {n_delta}")
            if self.schema.column(cname).kind is ColumnKind.CATEGORICAL:
                encoded[cname], new_dict_values[cname] = _encode_against(
                    values, self.dictionaries[cname])
            else:
                encoded[cname] = values.astype(np.float32)
        # ---- commit point: nothing below raises ----
        self._strip_gathered()
        for cname, new_vals in new_dict_values.items():
            if new_vals.size:
                self.dictionaries[cname] = np.concatenate(
                    [self.dictionaries[cname], new_vals])
                self.schema = self.schema.with_cardinality(
                    cname, len(self.dictionaries[cname]))
        delta = TableDelta(self.schema.name, self.n_rows, int(n_delta or 0),
                           encoded, new_dict_values)
        for cname, arr in encoded.items():
            self._set_host(cname, np.concatenate([self.host_column(cname),
                                                  arr]))
        self.n_rows += delta.n_rows
        if self.live is not None:
            self.live = np.concatenate(
                [self.live, np.ones(delta.n_rows, dtype=bool)])
        self._live_count = None
        self._live_device = None
        return delta

    def eval_predicate_host(self, pred: Predicate) -> np.ndarray:
        """Host-side DNF predicate evaluation over the encoded columns.

        Categorical atoms compare dictionary CODES against the encoded value
        (-1 for a value the dictionary has never seen), as float32, exactly
        as the device path does after bind_predicate, so a host mutation and
        a device scan agree on which rows match.
        """
        cols_f32: dict[str, np.ndarray] = {}   # one cast per column
        disj = np.zeros(self.n_rows, dtype=bool)
        for conj in pred.disjuncts:
            m = np.ones(self.n_rows, dtype=bool)
            for a in conj.atoms:
                if self.schema.column(a.column).kind is ColumnKind.CATEGORICAL:
                    enc = float(self.encode_value(a.column, a.value))
                else:
                    enc = float(a.value)
                col = cols_f32.get(a.column)
                if col is None:
                    col = self.host_column(a.column).astype(np.float32)
                    cols_f32[a.column] = col
                m &= _NP_CMP[a.op](col, np.float32(enc))
            disj |= m
        return disj

    def _matched_live(self, predicate: Predicate) -> np.ndarray:
        match = self.eval_predicate_host(predicate)
        if self.live is not None:
            match &= self.live
        return np.flatnonzero(match).astype(np.int64)

    def _tombstone(self, idx: np.ndarray) -> None:
        if not idx.size:
            return   # a mutation that matched nothing keeps live None
        if self.live is None:
            self.live = np.ones(self.n_rows, dtype=bool)
        self.live[idx] = False
        self._live_count = None
        self._live_device = None

    def delete(self, predicate: Predicate) -> TableMutation:
        """Tombstone every live row matching `predicate`. Rows are marked
        dead in the host mask, never moved. Returns the TableMutation the
        sampling layer needs to ghost its copies and decrement live
        stratum counts."""
        idx = self._matched_live(predicate)
        tomb_cols = {c: self.host_column(c)[idx].copy()
                     for c in self.schema.column_names}
        self._tombstone(idx)
        return TableMutation(self.schema.name, idx, tomb_cols, None)

    def update(self, predicate: Predicate, assignments: Mapping) -> TableMutation:
        """Update matching live rows: tombstone the old versions and append
        re-encoded copies with `assignments` applied.

        `assignments` maps column name -> new RAW value (a scalar, broadcast
        to every matched row, or an array of per-row values). Categorical
        assignments may introduce new dictionary values. Atomic: `append`
        validates and commits the delta BEFORE any row is tombstoned, so a
        rejected assignment leaves the table untouched.
        """
        unknown = set(assignments) - set(self.schema.column_names)
        if unknown:
            raise KeyError(f"update assigns unknown columns {sorted(unknown)}")
        idx = self._matched_live(predicate)
        tomb_cols = {c: self.host_column(c)[idx].copy()
                     for c in self.schema.column_names}
        raw: dict[str, np.ndarray] = {}
        for cname in self.schema.column_names:
            if cname in assignments:
                vals = np.asarray(assignments[cname])
                if vals.ndim == 0:
                    vals = np.full(len(idx), vals[()])
                elif len(vals) != len(idx):
                    raise ValueError(
                        f"assignment {cname}: length {len(vals)} != "
                        f"{len(idx)} matched rows")
                raw[cname] = vals
            elif self.schema.column(cname).kind is ColumnKind.CATEGORICAL:
                # decoded, so append re-encodes against the same dictionary
                raw[cname] = self.dictionaries[cname][tomb_cols[cname]]
            else:
                raw[cname] = tomb_cols[cname]
        delta = self.append(raw) if len(idx) else None
        self._tombstone(idx)
        return TableMutation(self.schema.name, idx, tomb_cols, delta)

    def compact(self) -> TableCompaction | None:
        """Physically drop every tombstoned row (base-table compaction,
        docs/MAINTENANCE.md). Every row id changes, so the returned remap
        (old id -> new id, -1 for a dropped row) must reach every layer
        keyed on physical ids before the table is used again
        (`BlinkDB.compact_table` does that). Live rows keep their order;
        dictionaries are untouched. Host-only: the device copies go stale
        and are uploaded again on their next access. Returns None when
        there is nothing to reclaim.
        """
        if self.live is None or self.n_live == self.n_rows:
            return None
        live = self.live
        n_before = self.n_rows
        remap = np.where(live, np.cumsum(live) - 1, -1).astype(np.int64)
        self._strip_gathered()
        for cname in self.schema.column_names:
            self._set_host(cname, self.host_column(cname)[live])
        self.n_rows = int(live.sum())
        self.live = None
        self._live_count = None
        self._live_device = None
        return TableCompaction(self.schema.name, remap, n_before,
                               n_before - self.n_rows)


def get_or_assign_codes(keys: list, lookup: dict) -> tuple[np.ndarray, list]:
    """Get-or-assign-next-code for every incremental encoding path
    (dictionary extension, stable stratum ids, code alignment across
    dictionaries): keys already in `lookup` keep their code, unseen keys get
    fresh codes past len(lookup) in first-appearance order. Returns (int64
    codes per key, the new keys)."""
    out = np.empty(len(keys), dtype=np.int64)
    new_keys = []
    next_code = len(lookup)
    for j, k in enumerate(keys):
        code = lookup.get(k)
        if code is None:
            code = next_code
            next_code += 1
            lookup[k] = code
            new_keys.append(k)
        out[j] = code
    return out, new_keys


def _encode_against(values: np.ndarray, dictionary: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Encode raw categorical values against an existing dictionary.
    Returns (int32 codes, new values in np.unique order). The dictionary is
    not assumed sorted (appends break the global sort)."""
    uniq, inverse = np.unique(values, return_inverse=True)
    lookup = {v: i for i, v in enumerate(dictionary.tolist())}
    uniq_codes, new_vals = get_or_assign_codes(uniq.tolist(), lookup)
    if new_vals:
        # Same-kind values keep their natural dtype, so the concatenate
        # widens the dictionary's (a forced dictionary.dtype would truncate
        # a string longer than every existing entry).
        new_arr = np.asarray(new_vals)
        if new_arr.dtype.kind != dictionary.dtype.kind:
            new_arr = new_arr.astype(dictionary.dtype)
    else:
        new_arr = np.empty(0, dtype=dictionary.dtype)
    return uniq_codes[inverse.reshape(-1)].astype(np.int32), new_arr


def from_columns(name: str, raw: Mapping[str, np.ndarray],
                 categorical: Sequence[str] | None = None) -> Table:
    """Ingest host columns. Columns with non-float dtypes (or listed in
    `categorical`) are dictionary-encoded; the rest become float32 measures.
    The result lives on the host; `Table.to(device)` uploads it."""
    categorical = set(categorical or ())
    n_rows = None
    schemas, dicts, hosts = [], {}, {}
    for cname, values in raw.items():
        values = np.asarray(values)
        if n_rows is None:
            n_rows = len(values)
        elif len(values) != n_rows:
            raise ValueError(f"column {cname}: length {len(values)} != {n_rows}")
        is_cat = cname in categorical or not np.issubdtype(values.dtype, np.floating)
        if is_cat:
            uniq, codes = np.unique(values, return_inverse=True)
            schemas.append(ColumnSchema(cname, ColumnKind.CATEGORICAL, len(uniq)))
            hosts[cname] = codes.reshape(-1).astype(np.int32)
            dicts[cname] = uniq
        else:
            schemas.append(ColumnSchema(cname, ColumnKind.NUMERIC))
            hosts[cname] = values.astype(np.float32)
    return Table(TableSchema(name, tuple(schemas)), hosts, dicts,
                 int(n_rows or 0))


def unique_rows(cols: Sequence[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """np.unique(np.stack(cols, axis=1), axis=0, return_inverse=True) for
    integer code columns: (unique rows int32 [u, w] in lexicographic order,
    int64 inverse). The codes form one mixed-radix int64 key (radix = each
    column's code range), whose numeric order is the lexicographic row
    order, so a 1-D np.unique gives the same result many times faster; a
    negative code or a key past 2^62 takes the row-wise unique."""
    cols = [np.asarray(c).astype(np.int64) for c in cols]
    n = len(cols[0])
    radix = [int(c.max()) + 1 if c.size else 1 for c in cols]
    if any(int(c.min()) < 0 for c in cols if c.size) or \
            float(np.prod(radix, dtype=np.float64)) >= 2.0 ** 62:
        uniq, inverse = np.unique(np.stack(cols, axis=1), axis=0,
                                  return_inverse=True)
        return uniq.astype(np.int32), inverse.reshape(-1).astype(np.int64)
    key = np.zeros(n, dtype=np.int64)
    for c, r in zip(cols, radix):
        key = key * r + c
    uniq, inverse = np.unique(key, return_inverse=True)
    mat = np.empty((len(uniq), len(cols)), dtype=np.int64)
    rest = uniq.copy()
    for j in range(len(cols) - 1, -1, -1):
        mat[:, j] = rest % radix[j]
        rest //= radix[j]
    return mat.astype(np.int32), inverse.reshape(-1).astype(np.int64)


def combined_codes(table: Table, phi: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
    """Dense group ids for the value-combinations of column set φ.

    Returns (codes[n_rows] int64 dense in [0, n_distinct), key_matrix
    [n_distinct, len(phi)] of per-column dictionary codes): the reference's
    np.unique(axis=0) over the stacked code matrix, through unique_rows.
    """
    phi = sorted(phi)
    if not phi:
        n = table.n_rows
        return np.zeros(n, dtype=np.int64), np.zeros((1, 0), dtype=np.int32)
    uniq, inverse = unique_rows([table.host_column(c) for c in phi])
    return inverse, uniq


def stratum_frequencies(codes: np.ndarray, n_distinct: int) -> np.ndarray:
    """F(φ, T, x): per-stratum row counts."""
    return np.bincount(codes, minlength=n_distinct).astype(np.int64)


def map_codes_stable(mat: np.ndarray, key_matrix: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Map rows to STABLE stratum ids given an existing key matrix.

    `combined_codes` numbers strata in lexicographic order, which renumbers
    everything when a new value combination appears. This maps each row of
    `mat` [d, w] (per-column dictionary codes on φ) through `key_matrix`
    [D, w] (row i = the codes of stratum i): known combinations keep their
    id, unseen ones get fresh ids D, D+1, ... Returns (int64 codes[d], the
    extended key matrix).
    """
    w = key_matrix.shape[1]
    if w == 0:  # φ = ∅: a single stratum
        return np.zeros(len(mat), dtype=np.int64), key_matrix
    if len(mat) == 0:
        return np.zeros(0, dtype=np.int64), key_matrix
    uniq, inverse = unique_rows([mat[:, j] for j in range(w)])
    lookup = {tuple(r): i for i, r in enumerate(key_matrix.tolist())}
    ids, new_rows = get_or_assign_codes([tuple(r) for r in uniq.tolist()],
                                        lookup)
    if new_rows:
        key_matrix = np.concatenate(
            [key_matrix, np.asarray(new_rows, dtype=np.int32).reshape(-1, w)])
    return ids[inverse.reshape(-1)].astype(np.int64), key_matrix


def extend_frequencies(old_freqs: np.ndarray, delta_codes: np.ndarray,
                       n_distinct: int) -> np.ndarray:
    """Incremental F update: the old per-stratum counts (zero for strata
    first seen in the delta) plus the delta's histogram. Frequencies only
    grow, the invariant the merge's re-keying relies on (rows only ever
    leave a prefix)."""
    out = np.zeros(n_distinct, dtype=np.int64)
    out[: len(old_freqs)] = old_freqs
    out += np.bincount(delta_codes, minlength=n_distinct).astype(np.int64)
    return out
