"""Joins (paper §2.1, case ii): a sampled fact table joined to unsampled
dimension tables that fit in memory (counterpart of `repro.core.joins`).

The join is a gather, `dim_col[fk_map[fact_fk_codes]]`, over the fact
table's rows (the exact path) and over each family's rows (the sampled
path), so every family answers queries whose predicates or GROUP BY name a
dimension attribute "dim.col": the gathered column is one more column of
the family's striped block, which the scan kernels read like any other.
(Case i, a family stratified on the join key, reduces to the same gather
on that family.) The fk → row map is built on the host once per (fact,
dimension, key) by aligning dictionary values, and cached by the engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import table as table_lib


@dataclasses.dataclass(frozen=True)
class Join:
    dim_table: str   # registered dimension table (fits in memory, §2.1)
    fact_key: str    # categorical fk column on the fact table
    dim_key: str     # matching key column on the dimension table


def build_fk_map(fact: table_lib.Table, dim: table_lib.Table,
                 join: Join) -> np.ndarray:
    """fact fk code -> dim row index (-1 for a dangling key). The first
    LIVE row holding a key value serves it: a deleted dimension row's keys
    dangle, and an updated row's re-inserted version wins over its
    tombstoned original."""
    fact_vals = fact.dictionaries[join.fact_key]
    dim_codes = dim.host_column(join.dim_key)
    dim_vals = dim.dictionaries[join.dim_key]
    val_to_row = {}
    for row, code in enumerate(dim_codes):
        if dim.live is not None and not dim.live[row]:
            continue
        val_to_row.setdefault(dim_vals[code], row)
    out = np.full(len(fact_vals), -1, dtype=np.int32)
    for code, v in enumerate(fact_vals):
        out[code] = val_to_row.get(v, -1)
    return out


def gather_dim_column(fk_map: np.ndarray, dim: table_lib.Table,
                      dim_col: str, fact_fk_codes):
    """The join gather of one dimension attribute over fact rows given by
    their fk codes (a numpy array or a tensor; the result is of the same
    kind, on the same device). A dangling key gathers the sentinel: -1 for
    an int32 (dictionary-coded) column, 0.0 for a float one."""
    is_tensor = isinstance(fact_fk_codes, torch.Tensor)
    codes = torch.as_tensor(fact_fk_codes)
    device = codes.device
    rows = torch.from_numpy(np.asarray(fk_map, np.int32)).to(device)[
        codes.to(torch.int64)]
    col = torch.from_numpy(np.ascontiguousarray(
        dim.host_column(dim_col))).to(device)
    vals = col[torch.clamp_min(rows, 0).to(torch.int64)]
    sentinel = -1 if col.dtype == torch.int32 else 0.0
    out = torch.where(rows >= 0, vals, torch.full_like(vals, sentinel))
    return out if is_tensor else out.numpy()
