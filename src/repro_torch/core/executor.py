"""Query execution over sample families (counterpart of
`repro.core.executor`).

A query executes as ONE fused pass over a striped family block: predicate
evaluation, HT weighting and the grouped reduction of the sufficient
statistics (GroupedMoments). The block's arrays are 1-D: on one device the
whole family, on a mesh (one process per data shard, SPMD) the rank's row
of the reference's [S, n_local] block, slot j of the family at shard
j % S, local position j // S. Every rank launches the same kernels on its
stripe; the partials are all-gathered over the mesh's data group and
summed in shard order 0..S-1 (`merge_partials`), so every rank holds the
same bits.

Memory-lean striped layout: the block stores only the sampling primitives —
per-row `unit` (f32), stratum id `strat` (narrowest int holding the
stratum count), the per-stratum frequency table (f32[D]), a `valid` mask,
and dictionary-encoded data columns at their narrow int8/int16 width. The
derived HT state, freq = freq_table[strat] and entry_key = unit·freq, is
re-derived by every scan. Pad slots carry unit=+inf, so their entry_key is
+inf and they fail every prefix test.

Mutation (docs/MAINTENANCE.md): the block keeps 25% headroom, so an
append's kept rows are scattered into its padding with the refreshed
frequency table (`stripe_append`); a delete ghosts the dead rows' slots
(unit := +inf, valid := False, `stripe_tombstone`); a base compaction
re-keys the host slot_row_ids mirror only. The scatters are plain torch
index assignments on the block's device, into copies of the block's
tensors, so an earlier block object never changes under a reader.

A template wider than the scan kernels' constant block (the reference's
CONST_LANES = 128 lanes: k and 127 atoms for the fused scan; k, lo, hi and
125 atoms for the quantile scan) takes the reference's wide path: the HT
state and the predicate are evaluated with torch ops, and the grouped
reduction runs in the agg_scan kernel (or, for QUANTILE, in one quantile
scan over the selection as a single atom column).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import estimators as est_lib
from repro_torch.core.sampling import SampleFamily
from repro_torch.core.types import QUANTILE_BINS, CmpOp, Predicate, cmp_fns
from repro_torch.fault import inject
from repro_torch.fault.inject import (AllShardsLostError, FaultError,
                                      ShardScanError)
from repro_torch.kernels import ops as kops
from repro_torch.obs import trace as obs_trace

_CMP = cmp_fns()
# The reference kernels' per-query constant block: lane 0 holds k, the
# quantile scan's lanes 1 and 2 hold lo and hi, the rest the atoms' constants
# (kernels/agg_scan.py MAX_ATOMS = 127 is what the port's kernels hold).
_CONST_LANES = 128


@dataclasses.dataclass(frozen=True)
class BoundAtom:
    """Atom with its value encoded to device-comparable form."""
    column: str
    op: CmpOp
    encoded: float


def bind_predicate(pred: Predicate, encode) -> tuple[tuple[BoundAtom, ...], ...]:
    """Encode predicate constants via `encode(column, value) -> float`."""
    return tuple(
        tuple(BoundAtom(a.column, a.op, float(encode(a.column, a.value)))
              for a in conj.atoms)
        for conj in pred.disjuncts)


def predicate_mask(columns: dict[str, torch.Tensor],
                   bound: tuple[tuple[BoundAtom, ...], ...]) -> torch.Tensor:
    """Evaluate a bound DNF predicate over column tensors -> bool[n]; no
    conjunction at all is FALSE, as in the reference."""
    if not bound:
        any_col = next(iter(columns.values()))
        return torch.zeros(any_col.shape, dtype=torch.bool,
                           device=any_col.device)
    struct, vals = pred_structure(bound)
    return eval_pred(struct, columns, vals)


def scan_moments(columns: dict[str, torch.Tensor], freq: torch.Tensor,
                 bound_pred: tuple[tuple[BoundAtom, ...], ...],
                 value_col: str | None, group_col: str | None, n_groups: int,
                 k: float, prefix_mask: torch.Tensor,
                 *, use_pallas: bool = False) -> est_lib.GroupedMoments:
    """One scan over a family prefix from its materialized HT state: the
    predicate within `prefix_mask`, reduced by selection_moments."""
    k = torch.tensor(k, dtype=torch.float32, device=freq.device)
    return selection_moments(predicate_mask(columns, bound_pred) & prefix_mask,
                             freq, k, columns, value_col, group_col, n_groups,
                             use_pallas=use_pallas)


def agg_scan_inputs(sel: torch.Tensor, freq: torch.Tensor, k: torch.Tensor,
                    cols: dict[str, torch.Tensor], value_col: str | None,
                    group_col: str | None) -> tuple:
    """(values, rates, selection, group codes) of one query's selection as
    kops.agg_scan takes them: rates = min(1, k/freq) with k a float32
    scalar tensor; values and codes at their stored widths, None for COUNT
    (every value 1) and for an ungrouped scan (one group)."""
    return (cols[value_col] if value_col is not None else None,
            torch.clamp_max(k / freq, 1.0), sel,
            cols[group_col] if group_col is not None else None)


def selection_moments(sel: torch.Tensor, freq: torch.Tensor, k: torch.Tensor,
                      cols: dict[str, torch.Tensor], value_col: str | None,
                      group_col: str | None, n_groups: int,
                      *, use_pallas: bool = True) -> est_lib.GroupedMoments:
    """Grouped HT moments of a selection. `use_pallas=True` reduces through
    kernels.ops.agg_scan (the CUDA kernel on the card, its plain version on
    the CPU), the reference's drop-in for estimators.grouped_moments, which
    `use_pallas=False` runs."""
    values, rates, sel, gcodes = agg_scan_inputs(sel, freq, k, cols,
                                                 value_col, group_col)
    if use_pallas:
        return kops.agg_scan(values, rates, sel, gcodes, n_groups)
    if values is None:
        values = torch.ones_like(freq)
    if gcodes is None:
        gcodes = torch.zeros(freq.shape, dtype=torch.int8, device=freq.device)
    return est_lib.grouped_moments(values, rates, sel, gcodes, n_groups)


# Shape granularity of the striped layout: rows are padded up to a multiple
# of _STRIPE_BLOCK with _STRIPE_HEADROOM slack (the reference keeps the
# slack for in-place appends; kept so the blocks match it slot for slot).
_STRIPE_BLOCK = 64
_STRIPE_HEADROOM = 0.25
_STRATA_BLOCK = 128     # freq-table length granularity


@dataclasses.dataclass
class StripedFamily:
    """A SampleFamily laid out on the device: row j of the family at slot j,
    padded and ghost slots self-excluding. The reference's block of S
    shards with S = 1."""
    phi: tuple[str, ...]
    ks: tuple[float, ...]
    columns: dict[str, torch.Tensor]   # [n_local]; dict-coded cols int8/int16
    valid: torch.Tensor                # bool[n_local] (padding mask)
    unit: torch.Tensor                 # f32[n_local], +inf on padding/ghosts
    strat: torch.Tensor                # int8/int16/int32[n_local] stratum ids
    freq_table: torch.Tensor           # f32[D_padded] per-stratum F
    n_rows: int                        # occupied slots (ghosts included)
    table_rows: int
    # Host mirror: physical base-row id per occupied slot of the whole
    # family, in linear slot order; -1 marks a slot a tombstone already
    # ghosted. Tombstones find their slots here, without reading the device.
    slot_row_ids: np.ndarray | None = None
    # Self-excluded slots of the whole family: rows a merge pushed past K_1
    # and tombstoned rows. The compaction trigger reads it.
    n_ghosts: int = 0
    # Data shards of the layout and the one whose slots the device arrays
    # hold (slot j of the family <-> shard j % S, local j // S).
    n_shards: int = 1
    shard: int = 0

    @property
    def n_local(self) -> int:
        return int(self.unit.shape[0])

    @property
    def capacity(self) -> int:
        return self.n_shards * self.n_local

    @property
    def ghost_fraction(self) -> float:
        """Share of the occupied slots that are self-excluded ghosts."""
        return self.n_ghosts / max(self.n_rows, 1)

    @property
    def shape_class(self) -> tuple:
        """The reference's program signature of the block: (shards, slots
        per shard, column dtypes, strat dtype, padded table length). A
        change retires the family's ELP decisions and latency model, as the
        reference's recompile does."""
        return (self.n_shards, self.n_local,
                tuple(sorted((c, a.dtype) for c, a in self.columns.items())),
                self.strat.dtype, int(self.freq_table.shape[0]))

    def device_bytes(self) -> int:
        """Bytes the block holds on its device."""
        return sum(t.numel() * t.element_size()
                   for t in (self.valid, self.unit, self.strat,
                             self.freq_table, *self.columns.values()))


def _padded_local(n: int, n_shards: int = 1) -> int:
    """Slots per shard of a family of n rows over n_shards shards."""
    n_local = -(-max(n, 1) // n_shards)
    n_local = int(n_local * (1.0 + _STRIPE_HEADROOM)) + 1
    return -(-n_local // _STRIPE_BLOCK) * _STRIPE_BLOCK


def _fits_dtype(a, dtype: torch.dtype) -> bool:
    """Do the integer values fit a block's narrow storage dtype?"""
    a = np.asarray(a)
    if dtype.is_floating_point or dtype == torch.bool or a.size == 0:
        return True
    info = torch.iinfo(dtype)
    if a.dtype.kind not in "iu":
        a = a.astype(np.int64)
    return bool(a.min() >= info.min and a.max() <= info.max)


def _padded_freq_table(freq_table: np.ndarray) -> np.ndarray:
    want = -(-max(len(freq_table), 1) // _STRATA_BLOCK) * _STRATA_BLOCK
    out = np.ones(want, dtype=np.float32)
    out[: len(freq_table)] = freq_table
    return out


def _narrow_int_dtype(a: np.ndarray) -> np.dtype:
    """Smallest of int8/int16/int32 holding every value — the storage width
    of dictionary-encoded columns and stratum ids (the kernel streams them
    at this width and widens in registers)."""
    if a.size == 0:
        return np.dtype(np.int8)
    lo, hi = int(a.min()), int(a.max())
    for dt in (np.int8, np.int16):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return np.dtype(dt)
    return np.dtype(np.int32)


def _storage_dtype(a: np.ndarray) -> np.dtype:
    """Device storage dtype for a data column: ints narrow per
    _narrow_int_dtype, floats stream as f32, anything else unchanged."""
    if a.dtype.kind in "iu":
        return _narrow_int_dtype(a)
    if a.dtype.kind == "f":
        return np.dtype(np.float32)
    return a.dtype


def stripe_family(fam: SampleFamily, device="cuda", n_shards: int = 1,
                  shard: int = 0,
                  min_local: int | None = None) -> StripedFamily:
    """Pad the family on the host and move row `shard` of the reference's
    [n_shards, n_local] block (a.reshape(n_local, S).T) to `device`: slot j
    of the family lies at shard j % S, local position j // S. With S = 1
    it is the whole family. `min_local` pins the slots per shard to at
    least that value: a compacting restripe passes the old block's, so the
    block keeps its shape class."""
    n = fam.n_rows
    n_local = _padded_local(n, n_shards)
    if min_local is not None:
        n_local = max(n_local, int(min_local))
    pad = n_local * n_shards - n

    def stripe(arr, fill, dtype=None):
        a = np.asarray(arr)
        if dtype is not None:
            a = a.astype(dtype)
        if pad:
            a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
        return torch.from_numpy(np.ascontiguousarray(a[shard::n_shards])).to(
            device)

    strat = fam.row_strata
    cols = {c: stripe(a, 0, _storage_dtype(a))
            for c, a in ((c, np.asarray(fam.host_column(c)))
                         for c in fam.columns_host)}
    return StripedFamily(
        fam.phi, fam.ks, cols,
        valid=stripe(np.ones(n, dtype=bool), False),
        unit=stripe(fam.unit_host.astype(np.float32), np.inf),
        strat=stripe(strat, 0, _narrow_int_dtype(np.asarray(strat))),
        freq_table=torch.from_numpy(_padded_freq_table(
            fam.stratum_freqs.astype(np.float32))).to(device),
        n_rows=n, table_rows=fam.table_rows,
        slot_row_ids=fam.row_ids.astype(np.int64).copy(),
        n_shards=n_shards, shard=shard)


def _scatter(t: torch.Tensor, slots: torch.Tensor, vals) -> torch.Tensor:
    """A copy of t with t[slots] = vals (cast to t's dtype)."""
    out = t.clone()
    out[slots] = torch.as_tensor(vals).to(device=t.device, dtype=t.dtype)
    return out


def _own_slots(striped: StripedFamily, slots: np.ndarray) -> np.ndarray:
    """Which of the family slots `slots` lie on the block's shard."""
    return slots % striped.n_shards == striped.shard


def stripe_append(striped: StripedFamily, fam: SampleFamily,
                  block) -> StripedFamily | None:
    """Incremental restripe: scatter an append's DeltaBlock (the kept delta
    rows, in delta order) into the block's padding at slots n_rows ..
    n_rows + d, and ship the refreshed frequency table. Scans derive freq
    and entry_key from the stored (unit, stratum) against the NEW table, so
    rows the rescale pushed past K_1 turn into self-excluding ghosts. The
    result equals the reference's block slot for slot. Returns None when
    the delta outgrows the capacity or a value or stratum id overflows its
    narrow storage dtype: the caller then restripes in full, which picks
    the dtypes and the shape anew. Both tests read the whole delta, so on a
    mesh every rank decides alike; each rank scatters the delta slots j
    with j % S == its shard, at local positions j // S."""
    d = block.n_rows
    start = striped.n_rows
    if start + d > striped.capacity:
        return None
    device = striped.unit.device
    freq_table = torch.from_numpy(_padded_freq_table(block.freq_table)).to(
        device)
    cols, unit, strat, valid = (striped.columns, striped.unit, striped.strat,
                                striped.valid)
    if d:
        if not _fits_dtype(block.strata, strat.dtype):
            return None
        for c, v in block.columns.items():
            if not _fits_dtype(v, cols[c].dtype):
                return None
        j = np.arange(start, start + d)
        mine = _own_slots(striped, j)
        slots = torch.from_numpy(j[mine] // striped.n_shards).to(device)
        cols = {c: _scatter(cols[c], slots, np.asarray(v)[mine])
                for c, v in block.columns.items()}
        unit = _scatter(unit, slots, block.unit.astype(np.float32)[mine])
        strat = _scatter(strat, slots, block.strata.astype(np.int64)[mine])
        valid = _scatter(valid, slots, True)
    return StripedFamily(
        fam.phi, fam.ks, cols, valid, unit, strat, freq_table, start + d,
        fam.table_rows,
        slot_row_ids=np.concatenate([striped.slot_row_ids,
                                     block.row_ids.astype(np.int64)]),
        # rows the rescale pushed past K_1 stay as ghosts until compaction
        n_ghosts=striped.n_ghosts + block.n_dropped_old,
        n_shards=striped.n_shards, shard=striped.shard)


def stripe_tombstone(striped: StripedFamily, dead_row_ids: np.ndarray,
                     table_rows: int | None = None) -> StripedFamily:
    """Ghost the slots of tombstoned sampled rows: unit := +inf makes every
    derived entry_key +inf (it fails every prefix test), valid := False
    covers the other readers. No column, table or key changes, and the
    block keeps its shape class. Slots are found through the host
    slot_row_ids mirror of the whole family and marked -1 there, so no row
    counts twice; the device arrays take the slots on the block's shard.
    `table_rows` is the post-mutation LIVE table count."""
    if table_rows is None:
        table_rows = striped.table_rows
    ids = striped.slot_row_ids
    if len(dead_row_ids) == 0:
        return dataclasses.replace(striped, table_rows=table_rows)
    dead_row_ids = np.asarray(dead_row_ids, dtype=np.int64)
    slots = np.flatnonzero(np.isin(ids[: striped.n_rows], dead_row_ids))
    if slots.size == 0:
        return dataclasses.replace(striped, table_rows=table_rows)
    idx = torch.from_numpy(slots[_own_slots(striped, slots)]
                           // striped.n_shards).to(striped.unit.device)
    new_ids = ids.copy()
    new_ids[slots] = -1
    return dataclasses.replace(
        striped, unit=_scatter(striped.unit, idx, float("inf")),
        valid=_scatter(striped.valid, idx, False),
        slot_row_ids=new_ids, n_ghosts=striped.n_ghosts + int(slots.size),
        table_rows=table_rows)


def remap_slot_row_ids(striped: StripedFamily,
                       remap: np.ndarray) -> StripedFamily:
    """Re-key the host slot_row_ids mirror through a base-table compaction
    remap (old id -> new id, -1 = dropped). The device arrays name no
    physical id, so nothing moves on the device. Ghosted slots stay -1;
    rescale ghosts still name live rows and remap like occupied slots (a
    later tombstone of such a row must find its slot)."""
    ids = striped.slot_row_ids
    remap = np.asarray(remap, dtype=np.int64)
    new_ids = np.where(ids >= 0, remap[np.maximum(ids, 0)], -1)
    return dataclasses.replace(striped, slot_row_ids=new_ids)


def scan_args(striped: StripedFamily) -> tuple:
    """The positional tail every scan program takes — the primitive layout
    (columns, unit, strat, freq_table, valid)."""
    return (striped.columns, striped.unit, striped.strat,
            striped.freq_table, striped.valid)


def derive_ht(unit: torch.Tensor, strat: torch.Tensor,
              freq_table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(freq, entry_key) derived from the stored sampling primitives, the
    torch mirror of the kernels' derivation: the same float32 gather and
    multiply."""
    freq = freq_table[strat.to(torch.int64)]
    return freq, unit * freq


def query_selection(pred: torch.Tensor, k: torch.Tensor, unit, strat,
                    freq_table, valid) -> tuple[torch.Tensor, torch.Tensor]:
    """(freq, selection) of one query: derive_ht's freq, and the predicate
    mask `pred` within the valid slots of the prefix entry_key < k (k a
    float32 scalar tensor). With selection_moments these are the
    reference's jnp steps of the wide path."""
    freq, ek = derive_ht(unit, strat, freq_table)
    return freq, pred & valid & (ek < k)


# ---------------------------------------------------------------------------
# The data mesh: one process per shard, partials merged in shard order
# ---------------------------------------------------------------------------
#
# The counterpart of the reference's shard_map + psum. Every rank runs the
# same program on its own stripe and launches the same kernels as one
# device; its partial (moments, and a QUANTILE's histogram) goes to the CPU
# and is all-gathered over the data group (gloo), then every rank sums the
# gathered partials in shard order 0..S-1. No all_reduce (its order of
# summation is not fixed) and no float atomics: every rank ends with the
# same bits, run after run. One collective serves a whole batch, as the
# reference's single psum of the stacked [7, Q, G] statistics does.


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """The data axes of a DeviceMesh as one process group: its size S and
    this rank's shard, the rank's position in the group (the order the
    gathered partials arrive in)."""
    group: object
    n_shards: int
    shard: int


def mesh_axes(mesh, data_axes: Sequence[str] = ("data",)) -> MeshAxes:
    """Resolve `mesh` (a torch.distributed DeviceMesh) over `data_axes`;
    raises TypeError for anything else. Several data axes act as one, in
    the mesh's row-major order (their flattened group)."""
    from torch.distributed import get_rank, get_world_size
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh with "
                        f"the data axes {tuple(data_axes)}, not "
                        f"{type(mesh).__name__}")
    data_axes = tuple(data_axes)
    names = mesh.mesh_dim_names or ()
    missing = [a for a in data_axes if a not in names]
    if missing:
        raise ValueError(f"mesh has no axes {missing} (axes: {names})")
    sub = mesh[data_axes] if data_axes != names else mesh
    group = (sub.get_group(0) if sub.ndim == 1
             else sub._flatten().get_group(0))
    return MeshAxes(group, get_world_size(group), get_rank(group))


def _gather(t: torch.Tensor, axes: MeshAxes) -> list[torch.Tensor]:
    """Every rank's copy of `t` (on the CPU), in shard order. A span of the
    active trace ("mesh.gather"): the copy to the host and the collective,
    the wait for the slowest rank included."""
    from torch.distributed import all_gather
    with obs_trace.span("mesh.gather", shards=axes.n_shards,
                        bytes=t.numel() * t.element_size()):
        t = t.detach().cpu().contiguous()
        out = [torch.empty_like(t) for _ in range(axes.n_shards)]
        all_gather(out, t, group=axes.group)
    return out


def merge_partials(parts: Sequence[torch.Tensor],
                   axes: MeshAxes) -> list[torch.Tensor]:
    """Sum each of a rank's float32 partials over the data axes: ONE
    all_gather of them all, flattened into one CPU buffer, then a sum of
    the gathered buffers in shard order 0..S-1. Returns tensors shaped as
    `parts` on their device, equal in every bit on every rank."""
    flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts])
    total = functools.reduce(torch.add, _gather(flat, axes)).to(
        parts[0].device)
    out, off = [], 0
    for p in parts:
        out.append(total[off: off + p.numel()].reshape(p.shape))
        off += p.numel()
    return out


def merge_moments(mom: est_lib.GroupedMoments, axes: MeshAxes | None,
                  *extra: torch.Tensor):
    """merge_partials of a rank's moments (and any `extra` partials, such
    as histograms) in one collective; unchanged without a mesh."""
    if axes is None:
        return (mom, *extra) if extra else mom
    merged = merge_partials((mom.stacked(), *extra), axes)
    mom = est_lib.GroupedMoments.from_stacked(merged[0])
    return (mom, *merged[1:]) if extra else mom


def agree_max(values: Sequence[float], axes: MeshAxes | None) -> list[float]:
    """Each value's maximum over the ranks (host clocks: a latency model
    or a straggler deadline must decide alike on every rank); the values
    themselves without a mesh."""
    if axes is None:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    return torch.stack(_gather(t, axes)).amax(dim=0).tolist()


def _axes_of(mesh, data_axes) -> MeshAxes | None:
    return None if mesh is None else mesh_axes(mesh, data_axes)


def run_query_striped(striped: StripedFamily, bound_pred,
                      value_col: str | None, group_col: str | None,
                      n_groups: int, k: float, mesh=None,
                      data_axes: Sequence[str] = ("data",),
                      use_pallas: bool = False) -> est_lib.GroupedMoments:
    """Un-compiled execution of one query over a striped family (tests and
    one-off scans): the steps of the engine's wide path, with the bound
    predicate's mask. On a mesh, `striped` is the rank's stripe and the
    partials merge in shard order."""
    axes = _axes_of(mesh, data_axes)
    k_t = torch.tensor(k, dtype=torch.float32, device=striped.unit.device)
    freq, sel = query_selection(predicate_mask(striped.columns, bound_pred),
                                k_t, *scan_args(striped)[1:])
    return merge_moments(selection_moments(
        sel, freq, k_t, striped.columns, value_col, group_col, n_groups,
        use_pallas=use_pallas), axes)


def pred_structure(bound: tuple[tuple[BoundAtom, ...], ...]):
    """Split a bound predicate into (static structure, constants):
    structure = ((column, op), ...) per conjunction; constants = matching
    nested tuple of floats. One scan program serves every instantiation of
    a template (paper §2.1)."""
    struct = tuple(tuple((a.column, a.op) for a in conj) for conj in bound)
    vals = tuple(tuple(a.encoded for a in conj) for conj in bound)
    return struct, vals


def flat_atoms(struct) -> tuple[tuple[str, CmpOp], ...]:
    """Flatten a template structure to its atoms in template order."""
    return tuple((col, op) for conj in struct for (col, op) in conj)


def flatten_pred_vals(vals) -> tuple[float, ...]:
    """Nested per-conjunction constants → flat tuple in template order."""
    return tuple(v for conj in vals for v in conj)


def eval_pred(struct, cols: dict[str, torch.Tensor], pred_vals) -> torch.Tensor:
    """Evaluate a template structure with NESTED constants -> bool[n]."""
    return eval_pred_flat(struct, cols, flatten_pred_vals(pred_vals))


def eval_pred_flat(struct, cols: dict[str, torch.Tensor],
                   consts) -> torch.Tensor:
    """Evaluate a template structure with FLAT constants (flat_atoms order)
    over column tensors -> bool[n]. Columns widen to f32 and compare with
    f32 constants, as the kernels do."""
    any_col = next(iter(cols.values()))
    if not struct:
        return torch.ones(any_col.shape, dtype=torch.bool, device=any_col.device)
    consts = torch.as_tensor(consts, dtype=torch.float32, device=any_col.device)
    disj = torch.zeros(any_col.shape, dtype=torch.bool, device=any_col.device)
    ai = 0
    for conj in struct:
        m = torch.ones(any_col.shape, dtype=torch.bool, device=any_col.device)
        for (col, op) in conj:
            m = m & _CMP[op](cols[col].to(torch.float32), consts[ai])
            ai += 1
        disj = disj | m
    return disj


def dedup_atom_slots(atoms) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """Unique atom column names + per-atom slot mapping: the kernel streams
    each column ONCE even when the template compares it several times."""
    names: list[str] = []
    slots: list[int] = []
    for col, _ in atoms:
        if col not in names:
            names.append(col)
        slots.append(names.index(col))
    return tuple(names), tuple(slots)


def _kernel_template(struct):
    """(ops_struct, atom column names, atom slots) of a template as the
    scan kernels take it."""
    atoms = flat_atoms(struct)
    ops_struct = tuple(tuple(op for _, op in conj) for conj in struct)
    return (ops_struct, *dedup_atom_slots(atoms))


def fits_const_block(struct, lanes_taken: int) -> bool:
    """Whether a template's constants fit the reference kernels' constant
    block beside `lanes_taken` per-query lanes (1 for the fused scan: k;
    3 for the quantile scan: k, lo, hi). Wider templates take the wide
    path, as the reference's jnp fallback does."""
    return len(flat_atoms(struct)) + lanes_taken <= _CONST_LANES


def _make_wide_batched_fn(struct, value_col, group_col, n_groups):
    """The batched program of a template over 127 atoms: per query, the
    wide path's torch steps (query_selection over eval_pred_flat), then one
    agg_scan launch for the grouped reduction (selection_moments). Query
    q's moments do not depend on the batch."""

    def fn(ks, pred_consts, cols, unit, strat, freq_table, valid):
        out = []
        for q in range(ks.shape[0]):
            freq, sel = query_selection(
                eval_pred_flat(struct, cols, pred_consts[q]), ks[q], unit,
                strat, freq_table, valid)
            out.append(selection_moments(sel, freq, ks[q], cols, value_col,
                                         group_col, n_groups).stacked())
        return est_lib.GroupedMoments.from_stacked(torch.stack(out))

    return fn


def make_batched_query_fn(struct, value_col: str | None,
                          group_col: str | None, n_groups: int, mesh=None,
                          data_axes: Sequence[str] = ("data",)):
    """The fused multi-query program of one (family × template): returns
    fn(ks, pred_consts, cols, unit, strat, freq_table, valid) ->
    GroupedMoments with leaves [Q, G]; ks is f32[Q] (per-query resolution
    caps), pred_consts f32[Q, A] (per-query constants in flat_atoms order),
    Q at most 64. One launch of the fused kernel (kernels/ops.py: the CUDA
    kernel on the card, its plain version on the CPU); query q of it has
    the bits of the same query launched alone. A template over 127 atoms
    runs the wide path instead: one agg_scan launch per query. On a mesh
    the block is the rank's stripe, and the batch's partials merge in one
    collective."""
    axes = _axes_of(mesh, data_axes)
    if not fits_const_block(struct, 1):
        fn = _make_wide_batched_fn(struct, value_col, group_col, n_groups)
    else:
        ops_struct, acol_names, atom_slots = _kernel_template(struct)

        def fn(ks, pred_consts, cols, unit, strat, freq_table, valid):
            return kops.agg_scan_fused(
                cols[value_col] if value_col is not None else None,
                unit, strat, freq_table, valid,
                tuple(cols[c] for c in acol_names),
                cols[group_col] if group_col is not None else None,
                ks, pred_consts, ops_struct, atom_slots, n_groups)
    if axes is None:
        return fn

    def merged(*args):
        return merge_moments(fn(*args), axes)

    return merged


def _query_consts(k: float, pred_vals, device) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """One query's (ks f32[1], pred_consts f32[1, A]) on `device`."""
    flat = flatten_pred_vals(pred_vals)
    consts = torch.tensor([flat], dtype=torch.float32).reshape(1, len(flat))
    ks = torch.tensor([k], dtype=torch.float32)
    return ks.to(device), consts.to(device)


def make_query_fn(struct, value_col: str | None, group_col: str | None,
                  n_groups: int, mesh=None,
                  data_axes: Sequence[str] = ("data",)):
    """The fused query program of one (family × template): returns
    fn(k, pred_vals, cols, unit, strat, freq_table, valid) -> GroupedMoments
    over the primitive layout. k and the predicate constants are arguments,
    so every instantiation of the template reuses it. The scan is the
    batched program at Q = 1 (for a template over 127 atoms, the wide
    path's agg_scan launch), merged over the mesh when there is one."""
    batched = make_batched_query_fn(struct, value_col, group_col, n_groups,
                                    mesh, data_axes)

    def fn(k, pred_vals, cols, unit, strat, freq_table, valid):
        ks, consts = _query_consts(k, pred_vals, unit.device)
        mom = batched(ks, consts, cols, unit, strat, freq_table, valid)
        return est_lib.moments_slice(mom, 0)

    return fn


# ---------------------------------------------------------------------------
# Grouped weighted quantiles (histogram method, Table 2 variance)
# ---------------------------------------------------------------------------

def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once to float32, as a fused multiply-add. The
    float32 product is exact in float64; the float64 sum s is not, so its
    exact residual (TwoSum) decides the one case where rounding s to
    float32 would round twice: s on a float32 midpoint with a nonzero
    residual goes to the neighbour on the residual's side."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.to(torch.float32)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=r.device)
    below = torch.where(r.double() > s, torch.nextafter(r, -inf), r)
    above = torch.nextafter(below, inf)
    tie = ((below.double() + above.double()) * 0.5 == s) & (err != 0) \
        & torch.isfinite(above)
    return torch.where(tie, torch.where(err > 0, above, below), r)


def _cumsum_bins(hist: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over 256 bins in the reference's order (XLA's CPU
    cumsum, bit for bit): 16 sequential adds inside each block of 16 bins,
    then each block's running total of the earlier blocks added on."""
    g = hist.shape[0]
    blocks = hist.reshape(g, 16, 16)
    inner = torch.empty_like(blocks)
    acc = torch.zeros_like(blocks[:, :, 0])
    for j in range(16):
        acc = acc + blocks[:, :, j]
        inner[:, :, j] = acc
    before = torch.empty_like(acc)
    run = torch.zeros_like(acc[:, 0])
    for b in range(16):
        before[:, b] = run
        run = run + inner[:, b, 15]
    return (inner + before[:, :, None]).reshape(g, 256)


def hist_to_quantile(hist: torch.Tensor, lo, hi, q
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(quantile_value[G], density[G]) from per-group histograms f32[G, 256]
    over the fixed range [lo, hi]: the first bin whose CDF reaches q,
    interpolated linearly inside it. Groups with zero selected mass give
    (0, 0). Rounds as the reference's compiled program does: its cumsum
    order, and the two interpolations `lo + idx·bin_w` and
    `left_edge + frac·bin_w` as fused multiply-adds."""
    if hist.dim() != 2 or hist.shape[1] != QUANTILE_BINS:
        raise ValueError(f"hist has shape {tuple(hist.shape)}; need "
                         f"[G, {QUANTILE_BINS}]")
    f32, dev = torch.float32, hist.device
    n_bins = hist.shape[1]
    lo = torch.as_tensor(lo, dtype=f32, device=dev)
    span = torch.clamp_min(torch.as_tensor(hi, dtype=f32, device=dev) - lo,
                           1e-12)
    q = torch.as_tensor(q, dtype=f32, device=dev)
    cum = _cumsum_bins(hist)
    mass = cum[:, -1]
    total = torch.clamp_min(cum[:, -1:], 1e-12)
    cdf = cum / total
    idx = torch.argmax((cdf >= q).to(torch.int32), dim=1)
    bin_w = span / n_bins
    left_edge = _fma_f32(idx.to(f32), bin_w, lo)
    at = cdf.gather(1, idx[:, None])[:, 0]
    prev = torch.where(idx > 0,
                       cdf.gather(1, torch.clamp_min(idx - 1, 0)[:, None])[:, 0],
                       torch.zeros_like(at))
    bin_mass = at - prev
    frac = torch.where(bin_mass > 1e-12,
                       (q - prev) / torch.clamp_min(bin_mass, 1e-12),
                       torch.full_like(at, 0.5))
    qval = _fma_f32(frac, bin_w, left_edge)
    density = hist.gather(1, idx[:, None])[:, 0] / (total[:, 0] * bin_w)
    empty = mass <= 0.0
    zero = torch.zeros_like(qval)
    return torch.where(empty, zero, qval), torch.where(empty, zero, density)


def _masked_range(v: torch.Tensor, sel: torch.Tensor,
                  axes: MeshAxes | None = None) -> torch.Tensor:
    """f32[2] (min, max) of v where sel, over every rank's stripe on a
    mesh; an empty selection gives the finite range (0, 0), so every group
    then reports (0, 0)."""
    inf = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
    rng = (torch.stack([torch.where(sel, v, inf).min(),
                        torch.where(sel, v, -inf).max()]) if v.numel()
           else torch.stack([inf, -inf]))
    if axes is not None:
        every = torch.stack(_gather(rng, axes))
        rng = torch.stack([every[:, 0].min(), every[:, 1].max()])
    return torch.where(torch.isfinite(rng), rng, torch.zeros_like(rng))


def grouped_quantile(values: torch.Tensor, weights: torch.Tensor,
                     gcodes: torch.Tensor, n_groups: int, q: float,
                     accumulate: torch.dtype = torch.float32
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-group quantile over the range of the rows with
    positive weight (the data's range), via a 256-bin histogram:
    (quantile_value[G], density_at_quantile[G]). `accumulate=torch.float64`
    sums the histogram in double and rounds it to float32 (the exact
    base-table scan, whose bins may pass 2^24 rows). Rows whose code lies
    outside [0, n_groups) count toward the range but land in no group, as
    the reference's segment_sum drops them."""
    f32 = torch.float32
    n_bins = QUANTILE_BINS
    v = values.to(f32)
    lo, hi = _masked_range(v, weights > 0)
    g = gcodes.to(torch.int64)
    keep = (g >= 0) & (g < n_groups)
    if not bool(keep.all()):
        v, weights, g = v[keep], weights[keep], g[keep]
    span = torch.clamp_min(hi - lo, 1e-12)
    # Clipped before the cast: equal to the reference's cast-then-clip on
    # every row with positive weight, and defined on the others.
    bins = torch.clamp((v - lo) / span * n_bins, 0.0, n_bins - 1).to(torch.int64)
    flat = g * n_bins + bins
    hist = torch.zeros(n_groups * n_bins, dtype=accumulate, device=v.device)
    hist.index_add_(0, flat, weights.to(accumulate))
    return hist_to_quantile(hist.to(f32).reshape(n_groups, n_bins), lo, hi, q)


def selected_range(values: torch.Tensor, sel: torch.Tensor,
                   axes: MeshAxes | None = None) -> tuple[float, float]:
    """(min, max) as host floats of the selected values as float32: the
    reference's data range (the rows with positive weight), over every
    rank's stripe on a mesh; (0, 0) when nothing is selected."""
    lo, hi = _masked_range(values.to(torch.float32), sel, axes).tolist()
    return lo, hi


def make_quantile_fn(struct, value_col: str | None, group_col: str | None,
                     n_groups: int, mesh=None,
                     data_axes: Sequence[str] = ("data",)):
    """The one-pass QUANTILE program of one (family × template): returns
    fn(k, pred_vals, level, lo, hi, cols, unit, strat, freq_table, valid)
    -> (GroupedMoments, quantile_value[G], density[G]). One quantile-scan
    launch gives the grouped moments and the HT-weighted histogram over the
    family-global range [lo, hi] (the engine's `_family_range`); the
    quantile is read off that histogram. This is the reference's kernel
    path (`use_pallas=True`) on either device.

    A template of 126 atoms or more does not fit the reference kernel's
    constant block beside k, lo and hi, and takes the reference's jnp path
    instead, which bins over the data's range: the selection (valid, prefix
    and predicate) is evaluated with torch ops, lo and hi are the min and
    max of the selected values (the `lo`, `hi` arguments are unused), and
    one quantile-scan launch takes the selection as its single atom column
    (template ((EQ,),), constant 1). The moments equal agg_scan's over the
    same selection bit for bit, so query_batch stays equal to query().

    On a mesh each rank scans its stripe over the same range (the
    family's, or the selected rows' range over every stripe), its moments
    and histogram merge in one collective, and the quantile is read off
    the merged histogram once: the one QUANTILE semantics of the port,
    where the reference's mesh path bins over the data's range in jnp."""
    axes = _axes_of(mesh, data_axes)
    if not fits_const_block(struct, 3):
        return _make_wide_quantile_fn(struct, value_col, group_col, n_groups,
                                      axes)
    ops_struct, acol_names, atom_slots = _kernel_template(struct)

    def fn(k, pred_vals, level, lo, hi, cols, unit, strat, freq_table, valid):
        ks, consts = _query_consts(k, pred_vals, unit.device)
        mom, hist = kops.quantile_scan(
            cols[value_col] if value_col is not None else None,
            unit, strat, freq_table, valid,
            tuple(cols[c] for c in acol_names),
            cols[group_col] if group_col is not None else None,
            ks, lo, hi, consts, ops_struct, atom_slots, n_groups)
        mom, hist = merge_moments(mom, axes, hist)
        qval, dens = hist_to_quantile(hist, lo, hi, level)
        return mom, qval, dens

    return fn


def _make_wide_quantile_fn(struct, value_col, group_col, n_groups, axes):
    """make_quantile_fn's program for a template of 126 atoms or more."""

    def fn(k, pred_vals, level, lo, hi, cols, unit, strat, freq_table, valid):
        ks, consts = _query_consts(k, pred_vals, unit.device)
        _, sel = query_selection(eval_pred_flat(struct, cols, consts[0]),
                                 ks[0], unit, strat, freq_table, valid)
        values = cols[value_col]
        lo, hi = selected_range(values, sel, axes)
        one = torch.ones((1, 1), dtype=torch.float32, device=unit.device)
        mom, hist = kops.quantile_scan(
            values, unit, strat, freq_table, valid, (sel,),
            cols[group_col] if group_col is not None else None,
            ks, lo, hi, one, ((CmpOp.EQ,),), (0,), n_groups)
        mom, hist = merge_moments(mom, axes, hist)
        qval, dens = hist_to_quantile(hist, lo, hi, level)
        return mom, qval, dens

    return fn


# ---------------------------------------------------------------------------
# Variational-subsampling scans (VerdictDB-style CIs, estimators.py)
# ---------------------------------------------------------------------------
#
# The CI path needs per-(group, subsample) partial moments. They come out of
# the SAME kernels the plain scans launch, over n_groups·B segments: the
# engine hands them an int32 group column gcodes·B + sub (sub the slot's
# subsample id), cached per (table, family, group column, B). Subsample
# membership is a pure function of the slot index, hashed rather than
# idx % B, so it is decorrelated from entry-key order (consecutive slots of
# a stratum hold nearly sorted keys; a modulo would give systematically
# balanced subsamples and bias the replicate spread low). A code of -1 (a
# join's dangling key) becomes -B + sub < 0 and lands in no segment.

_SHARD_HASH_MULT = 2654435761     # Knuth multiplicative hash (fits uint32)
_SUBSAMPLE_HASH_SHIFT = 7         # apart from the shard hash's low bits
_SUB_GROUP = "\0subsample group"  # the group column's name inside a program


def subsample_codes(n_shards: int, n_local: int,
                    n_subsamples: int) -> np.ndarray:
    """int32[S, n_local] deterministic subsample id per slot, hashed from the
    linear slot index (slot j ↔ shard j % S, local j // S); the reference's
    array, element for element. One device is S = 1."""
    lin = (np.arange(n_local, dtype=np.uint32)[None, :] * np.uint32(n_shards)
           + np.arange(n_shards, dtype=np.uint32)[:, None])
    h = (lin * np.uint32(_SHARD_HASH_MULT)) >> np.uint32(_SUBSAMPLE_HASH_SHIFT)
    return (h % np.uint32(n_subsamples)).astype(np.int32)


def subsample_group_column(group_codes: torch.Tensor, sub: torch.Tensor,
                           n_subsamples: int) -> torch.Tensor:
    """The int32 group column g·B + sub of a grouped subsampled scan (an
    ungrouped one takes sub itself)."""
    return group_codes.to(torch.int32) * n_subsamples + sub


def make_batched_subsampled_query_fn(struct, value_col: str | None,
                                     group_col: str | None, n_groups: int,
                                     n_subsamples: int, mesh=None,
                                     data_axes: Sequence[str] = ("data",)):
    """make_batched_query_fn with per-subsample segments: returns
    fn(ks, pred_consts, gsub, cols, unit, strat, freq_table, valid) ->
    GroupedMoments [Q, n_groups·B] (group-major: segment g·B + j), where
    gsub is the int32 column g·B + sub (subsample_group_column; the
    subsample codes alone when ungrouped). It is the fused program
    (or, over 127 atoms, the wide path's agg_scan launches) with gsub as
    its group column and n_groups·B groups, so a query's moments have the
    same bits alone as in a batch, and the streamed bytes are the plain
    scan's plus one int32 column. On a mesh gsub is the rank's row of the
    reference's [S, n_local] codes, and the partials merge as the plain
    scan's do."""
    del group_col   # folded into gsub by the caller
    inner = make_batched_query_fn(struct, value_col, _SUB_GROUP,
                                  n_groups * n_subsamples, mesh, data_axes)

    def fn(ks, pred_consts, gsub, cols, unit, strat, freq_table, valid):
        return inner(ks, pred_consts, {**cols, _SUB_GROUP: gsub}, unit,
                     strat, freq_table, valid)

    return fn


def make_subsampled_query_fn(struct, value_col: str | None,
                             group_col: str | None, n_groups: int,
                             n_subsamples: int, mesh=None,
                             data_axes: Sequence[str] = ("data",)):
    """make_query_fn analogue with per-subsample segments: returns
    fn(k, pred_vals, gsub, cols, unit, strat, freq_table, valid) ->
    GroupedMoments [n_groups·B]; the batched program at Q = 1."""
    batched = make_batched_subsampled_query_fn(struct, value_col, group_col,
                                               n_groups, n_subsamples, mesh,
                                               data_axes)

    def fn(k, pred_vals, gsub, cols, unit, strat, freq_table, valid):
        ks, consts = _query_consts(k, pred_vals, unit.device)
        mom = batched(ks, consts, gsub, cols, unit, strat, freq_table, valid)
        return est_lib.moments_slice(mom, 0)

    return fn


def make_subsampled_quantile_fn(struct, value_col: str,
                                group_col: str | None, n_groups: int,
                                n_subsamples: int, mesh=None,
                                data_axes: Sequence[str] = ("data",)):
    """QUANTILE subsampling program: returns fn(k, pred_vals, level, gsub,
    cols, unit, strat, freq_table, valid) -> (mom_sub [G·B], qval[G],
    dens[G], qsub[G·B]). As the reference's subsampled path, it bins over
    the selected rows' range: the selection (valid, prefix, predicate) is
    evaluated with torch ops, then two quantile-scan launches take it as
    their single atom column (as the wide path does), one over the G
    groups (the point estimate and its density) and one over gsub's G·B
    segments (the per-subsample moments and replicate quantiles). On a
    mesh the range spans every rank's selection, and the two scans'
    partials merge in one collective."""
    b = n_subsamples
    axes = _axes_of(mesh, data_axes)

    def fn(k, pred_vals, level, gsub, cols, unit, strat, freq_table, valid):
        ks, consts = _query_consts(k, pred_vals, unit.device)
        _, sel = query_selection(eval_pred_flat(struct, cols, consts[0]),
                                 ks[0], unit, strat, freq_table, valid)
        values = cols[value_col]
        lo, hi = selected_range(values, sel, axes)
        one = torch.ones((1, 1), dtype=torch.float32, device=unit.device)

        def scan(codes, groups):
            return kops.quantile_scan(values, unit, strat, freq_table, valid,
                                      (sel,), codes, ks, lo, hi, one,
                                      ((CmpOp.EQ,),), (0,), groups)

        _, hist = scan(cols[group_col] if group_col is not None else None,
                       n_groups)
        mom_sub, hist_sub = scan(gsub, n_groups * b)
        mom_sub, hist, hist_sub = merge_moments(mom_sub, axes, hist,
                                                hist_sub)
        qval, dens = hist_to_quantile(hist, lo, hi, level)
        qsub, _ = hist_to_quantile(hist_sub, lo, hi, level)
        return mom_sub, qval, dens, qsub

    return fn


# ---------------------------------------------------------------------------
# Fault-domain sharded scans (replicated logical shards over a striped block)
# ---------------------------------------------------------------------------
#
# Fault domains are a logical partition of the block: each stratum hashes to
# one of `n_logical` shards, so the shards are disjoint row sets whose
# per-shard GroupedMoments partials sum to the full scan's statistics. Every
# scan program takes the block's `valid` mask as an argument, so a per-shard
# scan is the same program, the same kernel launch, with
# `valid & (stratum_hash == s)` in that slot.
#
# This path engages only under an armed non-empty FaultPlan (the engine's
# engagement rule): the shards sum in another order than the single fused
# pass, and the empty-plan bit-identity contract (docs/FAULTS.md) forbids
# that unless faults are possible.
#
# The hash is the reference's uint32 one, (uint32(strat) · 2654435761) mod
# 2^32 mod n_logical. torch has no general uint32 arithmetic on the card,
# and an int64 product of two 32-bit values can pass 2^63, so the low 32
# bits of the product are formed exactly in int64 from the multiplier's
# 16-bit halves: u·M ≡ u·lo + ((u·hi) mod 2^16)·2^16 (mod 2^32), every term
# below 2^48. A negative stratum id hashes as its uint32 cast does in numpy.

_MULT_HI, _MULT_LO = _SHARD_HASH_MULT >> 16, _SHARD_HASH_MULT & 0xFFFF
_LOW16, _LOW32 = 0xFFFF, 0xFFFFFFFF


def _shard_hash(strat: torch.Tensor, n_logical: int) -> torch.Tensor:
    """int64 shard of every stratum id (any integer dtype, any device)."""
    u = strat.to(torch.int64) & _LOW32
    h = (u * _MULT_LO + (((u * _MULT_HI) & _LOW16) << 16)) & _LOW32
    return h % n_logical


def shard_valid_mask(strat: torch.Tensor, valid: torch.Tensor, shard: int,
                     *, n_logical: int) -> torch.Tensor:
    """Validity mask restricted to one logical fault-domain shard: stratum
    ids hash onto [0, n_logical), so shards are disjoint stratum
    partitions. Torch ops on the block's device."""
    return valid & (_shard_hash(strat, n_logical) == shard)


def shard_of_strata(strata, n_logical: int) -> np.ndarray:
    """Host-side view of shard_valid_mask's hash: int32 shard per stratum id
    (numpy or torch integers)."""
    t = torch.as_tensor(np.asarray(strata) if not torch.is_tensor(strata)
                        else strata.cpu())
    return _shard_hash(t, n_logical).numpy().astype(np.int32)


def _poison_moments(mom: est_lib.GroupedMoments) -> est_lib.GroupedMoments:
    """Corrupt a partial with NaNs (what a poison fault turns a shard's
    result into; the detection layer must refuse it)."""
    return est_lib.GroupedMoments.from_stacked(mom.stacked() * float("nan"))


@dataclasses.dataclass(frozen=True)
class ShardScanReport:
    """What the sharded scan survived: the provenance an Answer carries."""
    n_shards: int                 # logical shards scanned
    lost: tuple[int, ...]         # shards with no surviving replica
    rerouted: tuple[int, ...]     # shards served by a replica > 0
    reweight: float               # HT factor S/(S-L) applied (1.0 = none)

    @property
    def degraded(self) -> bool:
        return bool(self.lost)


def merge_shard_reports(reports: Sequence["ShardScanReport | None"]
                        ) -> "ShardScanReport | None":
    """Union the reports of chunked scans over one family (batches past the
    engine's 64 queries a launch): a shard lost in ANY chunk is reported
    lost, the widest reweight wins."""
    reps = [r for r in reports if r is not None]
    if not reps:
        return None
    lost = sorted({s for r in reps for s in r.lost})
    rerouted = sorted({s for r in reps for s in r.rerouted})
    return ShardScanReport(max(r.n_shards for r in reps), tuple(lost),
                           tuple(rerouted), max(r.reweight for r in reps))


def run_sharded_scan(call, striped: StripedFamily, *, n_logical: int,
                     n_replicas: int = 2, site_ctx: dict | None = None,
                     deadline_s: float | None = None, placement=None,
                     axes: MeshAxes | None = None
                     ) -> tuple[est_lib.GroupedMoments, ShardScanReport]:
    """Execute `call(valid_mask) -> GroupedMoments` once per logical shard,
    with replica re-route and HT reweighting of the survivors.

    `call` launches the scan and synchronises the device before it returns,
    so the straggler deadline measures the attempt. Per shard, up to
    `n_replicas` attempts run the SAME deterministic launch under distinct
    (shard, replica) fault-site identities: a replica is a re-execution
    that a fault plan can fail independently. An attempt fails on an
    injected kill, a partial that is not finite (poison detection), or,
    with `deadline_s`, an attempt past the straggler deadline. Shards whose
    every replica fails are LOST: the surviving partials are summed in
    shard order and HT-reweighted by S/(S-L) (estimators.reweight_moments),
    which widens every CI. Raises AllShardsLostError when nothing survives.
    Only FaultErrors fail an attempt: a CUDA error or a failed kernel build
    (a RuntimeError from torch) propagates, with no replica and no retry.

    With a `FamilyPlacement` (sharding/placement.py) each attempt also
    carries the PROCESS it executes on: the chain length overrides
    `n_replicas` (hot families run longer chains) and the fault site gains
    a `process` key, so a FaultSpec matching `(("process", p),)` kills
    every attempt placed on process p, with fail-over to replicas placed
    elsewhere.

    On a mesh (`axes`) the logical shards partition the rank's stripe and
    `call` runs the mesh program, so every attempt is one collective on
    every rank; the fault plan decides alike on each, and the straggler
    deadline reads the slowest rank's time."""
    ctx = dict(site_ctx or {})
    partials: list[est_lib.GroupedMoments] = []
    lost: list[int] = []
    rerouted: list[int] = []
    for s in range(n_logical):
        mask = shard_valid_mask(striped.strat, striped.valid, s,
                                n_logical=n_logical)
        chain = (placement.replicas_for(s) if placement is not None
                 else tuple(None for _ in range(n_replicas)))
        mom = None
        for r, proc in enumerate(chain):
            t0 = time.perf_counter()
            pctx = {} if proc is None else {"process": proc}
            # Each attempt is its own span: the trace of a degraded query
            # shows every replica tried, which ones the plan failed, the
            # process of each, and which one served.
            with obs_trace.span("scan.shard", shard=s, replica=r,
                                **pctx) as sp:
                try:
                    action = inject.site("shard.scan", shard=s, replica=r,
                                         **pctx, **ctx)
                    m = call(mask)
                    if action == "poison":
                        m = _poison_moments(m)
                    if deadline_s is not None and agree_max(
                            [time.perf_counter() - t0], axes)[0] > deadline_s:
                        raise ShardScanError(
                            f"shard {s} replica {r} missed the straggler "
                            f"deadline ({deadline_s:.3f}s)")
                    if not est_lib.moments_finite(m):
                        raise ShardScanError(
                            f"shard {s} replica {r} returned non-finite "
                            "statistics (poisoned partial)")
                    mom = m
                    sp.set(ok=True)
                    break
                except FaultError as e:
                    sp.set(ok=False, error=type(e).__name__)
                    continue    # next replica; other errors propagate
        if mom is None:
            lost.append(s)
        else:
            if r > 0:
                rerouted.append(s)
            partials.append(mom)
    if not partials:
        n_rep = (placement.n_replicas if placement is not None
                 else n_replicas)
        raise AllShardsLostError(
            f"all {n_logical} logical shards lost every one of "
            f"{n_rep} replicas")
    total = est_lib.GroupedMoments.from_stacked(
        functools.reduce(torch.add, [p.stacked() for p in partials]))
    factor = n_logical / (n_logical - len(lost))
    if lost:
        total = est_lib.reweight_moments(total, factor)
    return total, ShardScanReport(n_logical, tuple(lost), tuple(rerouted),
                                  factor)
