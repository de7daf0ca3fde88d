"""Columnar, dictionary-encoded tables (counterpart of `repro.core.table`).

Host side: value dictionaries and the encoded columns as numpy arrays (the
host mirrors every offline path reads). Device side: the same columns as
torch tensors on the engine's device, uploaded by `Table.to` — only the
exact base-table scan reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.types import ColumnKind, ColumnSchema, TableSchema


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

    @property
    def n_live(self) -> int:
        """Live rows: every row, until deletes come with a later slice."""
        return self.n_rows

    @property
    def device(self) -> torch.device | None:
        if not self.columns:
            return None
        return next(iter(self.columns.values())).device

    def to(self, device) -> "Table":
        """Upload every column to `device` (a no-op when already there)."""
        device = torch.device(device)
        if self.device != device:
            self.columns = {c: torch.from_numpy(a).to(device)
                            for c, a in self.columns_host.items()}
        return self

    def host_column(self, name: str) -> np.ndarray:
        return self.columns_host[name]

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


def combined_codes(table: Table, phi: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
    """Dense group ids for the value-combinations of column set φ.

    Returns (codes[n_rows] int64 dense in [0, n_distinct), key_matrix
    [n_distinct, len(phi)] of per-column dictionary codes). The reference
    runs np.unique(axis=0) over the stacked code matrix; here the per-column
    codes form one mixed-radix int64 key (radix = each column's code range),
    whose numeric order is the same lexicographic row order, so a 1-D
    np.unique gives identical codes many times faster.
    """
    phi = sorted(phi)
    if not phi:
        n = table.n_rows
        return np.zeros(n, dtype=np.int64), np.zeros((1, 0), dtype=np.int32)
    cols = [table.host_column(c).astype(np.int64) for c in phi]
    radix = [int(c.max()) + 1 if c.size else 1 for c in cols]
    if any(int(c.min()) < 0 for c in cols if c.size) or \
            float(np.prod(radix, dtype=np.float64)) >= 2.0 ** 62:
        # Key would not fit (or codes are not dictionary codes): fall back
        # to the reference's row-wise unique.
        mats = np.stack([table.host_column(c) for c in phi], axis=1)
        uniq, inverse = np.unique(mats, axis=0, return_inverse=True)
        return inverse.reshape(-1).astype(np.int64), uniq.astype(np.int32)
    key = np.zeros(table.n_rows, dtype=np.int64)
    for c, r in zip(cols, radix):
        key = key * r + c
    uniq, inverse = np.unique(key, return_inverse=True)
    mat = np.empty((len(uniq), len(phi)), dtype=np.int64)
    rest = uniq.copy()
    for j in range(len(phi) - 1, -1, -1):
        mat[:, j] = rest % radix[j]
        rest //= radix[j]
    return inverse.reshape(-1).astype(np.int64), mat.astype(np.int32)


def stratum_frequencies(codes: np.ndarray, n_distinct: int) -> np.ndarray:
    """F(φ, T, x): per-stratum row counts."""
    return np.bincount(codes, minlength=n_distinct).astype(np.int64)
