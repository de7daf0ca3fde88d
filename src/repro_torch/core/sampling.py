"""Multi-dimensional, multi-resolution stratified sample families (paper
§3.1; counterpart of `repro.core.sampling`).

A family SFam(φ) is ONE table whose rows are sorted by entry_key = u·F(x),
u ~ U[1e-7, 1) a per-row priority and F(x) the row's stratum frequency on
φ. Membership in S(φ, K) is exactly entry_key < K, so resolutions nest, each
resolution is a prefix of the family, and the per-row inclusion probability
min(1, K/F) is exact (Horvitz–Thompson, §4.3). Families live on the host;
the executor stripes them onto the device.

Mutation (docs/MAINTENANCE.md): `merge_family` merges an append's delta,
`apply_tombstones` drops deleted rows, `remap_family_row_ids` follows a
base-table compaction and `decay_strata` resets churned strata. Inclusion
frequencies (`stratum_freqs`) count every row ever inserted and only grow
until a decay resets them; live counts (`stratum_live`) follow deletes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import table as table_lib
from repro_torch.core.types import ColumnKind


@dataclasses.dataclass
class SampleFamily:
    """Materialized SFam(φ): the largest sample + metadata for all
    resolutions, as host arrays sorted by entry_key."""
    phi: tuple[str, ...]              # stratification columns (sorted)
    ks: tuple[float, ...]             # resolutions, descending: K_1 > K_1/c > ...
    prefix_sizes: tuple[int, ...]     # |S(φ, K_i)| for each K_i (row counts)
    n_rows: int                       # rows materialized (= prefix_sizes[0])
    table_rows: int                   # rows in the original table
    n_distinct: int                   # |D(φ)|
    stratum_freqs: np.ndarray         # int64[D] inclusion frequency per stratum
    strata_keys: np.ndarray           # [D, |φ|] per-stratum column codes
    row_strata: np.ndarray            # int64[n] stratum id per row
    entry_key_host: np.ndarray        # f32[n] = u·F, ascending
    columns_host: dict[str, np.ndarray]   # sampled rows, entry_key order
    unit_host: np.ndarray             # f32[n] per-row u
    row_ids: np.ndarray               # int64[n] base-table row per sample row
    # LIVE per-stratum counts (drift, optimizer statistics): decremented by
    # tombstones while the inclusion frequencies are not. None: equal to
    # stratum_freqs.
    stratum_live: np.ndarray | None = None

    def host_column(self, name: str) -> np.ndarray:
        return self.columns_host[name]

    @property
    def live_freqs(self) -> np.ndarray:
        """LIVE per-stratum counts; the inclusion frequencies until a
        tombstone decrements them."""
        return (self.stratum_live if self.stratum_live is not None
                else self.stratum_freqs)

    def prefix_for_k(self, k: float) -> int:
        """Rows to scan for resolution cap k (host binary search)."""
        return int(np.searchsorted(self.entry_key_host, k, side="left"))

    def storage_bytes(self, row_bytes: int) -> int:
        # +8: the f32 freq and entry_key bookkeeping columns.
        return self.n_rows * (row_bytes + 8)


@dataclasses.dataclass
class DeltaBlock:
    """The rows a merge ADDED to a family, in delta order, and the updated
    per-stratum frequency table: what the executor's incremental restripe
    scatters into the striped block."""
    columns: dict[str, np.ndarray]    # host, encoded; kept delta rows only
    unit: np.ndarray                  # f32[d_kept]
    strata: np.ndarray                # int32[d_kept] stable stratum ids
    freq: np.ndarray                  # f32[d_kept] F_new per row
    entry_key: np.ndarray             # f32[d_kept] = unit · F_new
    freq_table: np.ndarray            # f32[D_new] updated per-stratum F
    n_dropped_old: int                # old rows pushed past K_1 by the rescale
    row_ids: np.ndarray | None = None # int64[d_kept] physical base-row ids

    @property
    def n_rows(self) -> int:
        return int(self.unit.size)


def resolution_caps(k1: float, c: float, m: int) -> tuple[float, ...]:
    """K_i = K_1 / c^i, i in [0, m) (paper §3.1)."""
    return tuple(k1 / (c ** i) for i in range(m))


def expected_sample_rows(stratum_freqs: np.ndarray, k: float) -> float:
    """E[|S(φ,K)|] = Σ_x min(F(x), K) — exact for Poisson stratification."""
    return float(np.minimum(stratum_freqs, k).sum())


def base_units(n: int, seed: int, *, uniform: bool = False) -> np.ndarray:
    """Per-row random priorities u ~ U[1e-7, 1) for a table's rows, drawn
    from an explicit torch.Generator. The uniform family salts the seed so
    R(p) and SFam(φ) draw independently. (The reference draws from
    jax.random, so the two packages give different units for one seed:
    `repro_torch.state` carries the reference's units across instead.)"""
    gen = torch.Generator(device="cpu")
    gen.manual_seed((seed ^ 0x5EED) if uniform else seed)
    u = torch.rand(n, generator=gen, dtype=torch.float32).numpy()
    lo = np.float32(1e-7)
    return np.maximum(u * (np.float32(1.0) - lo) + lo, lo)


def delta_units(n: int, seed: int, epoch: int, *,
                uniform: bool = False) -> np.ndarray:
    """Per-row priorities of the rows of append epoch `epoch` (1-based),
    deterministic in (seed, epoch) and independent across epochs, from
    numpy's generator: the reference's draw, number for number, so a
    rebuild fed the base units ++ delta_units(…, 1) ++ … is the exact
    oracle of the incremental merge."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFFFFFFFFFF, epoch, 1 if uniform else 0]))
    return np.maximum(rng.random(n, dtype=np.float32), np.float32(1e-7))


def decay_units(n: int, seed: int, epoch: int) -> np.ndarray:
    """Per-row priorities of inclusion-frequency decay epoch `epoch`
    (1-based): one full-table draw indexed by physical row id, of which a
    decay reads the rows of the strata it resets. Deterministic in (seed,
    epoch), salted away from the append streams; the reference's numbers."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFFFFFFFFFF, epoch, 2]))
    return np.maximum(rng.random(n, dtype=np.float32), np.float32(1e-7))


def _assemble_family(phi: tuple[str, ...], ks: tuple[float, ...],
                     host_cols: Mapping[str, np.ndarray], units: np.ndarray,
                     codes: np.ndarray, freqs: np.ndarray,
                     key_matrix: np.ndarray, table_rows: int, *,
                     live: np.ndarray | None = None,
                     incl_freqs: np.ndarray | None = None) -> SampleFamily:
    """Materialize a family from per-row (unit, stratum) assignments: keep
    entry_key = u·F < K_1 (live rows only), sort ascending, cut prefixes.
    `freqs` are the LIVE per-stratum counts; `incl_freqs` (default: freqs)
    the inclusion frequencies the keys and rates use (the mutation oracle
    passes the cumulative physical histogram)."""
    k1 = ks[0]
    if incl_freqs is None:
        incl_freqs = freqs
    row_freq = incl_freqs.astype(np.float32)[codes] if len(codes) \
        else np.zeros(0, np.float32)
    entry_key = units.astype(np.float32) * row_freq
    keep = entry_key < k1
    if live is not None:
        keep &= live
    order = np.argsort(entry_key[keep], kind="stable")
    idx = np.nonzero(keep)[0][order]
    ek = entry_key[idx]
    prefixes = tuple(int(np.searchsorted(ek, k, side="left")) for k in ks)
    cols_host = {name: np.asarray(arr)[idx] for name, arr in host_cols.items()}
    unit_host = units.astype(np.float32)[idx]
    return SampleFamily(
        phi=phi, ks=ks, prefix_sizes=prefixes, n_rows=int(idx.size),
        table_rows=table_rows, n_distinct=len(incl_freqs),
        stratum_freqs=incl_freqs, strata_keys=key_matrix,
        row_strata=codes[idx], entry_key_host=ek, columns_host=cols_host,
        unit_host=unit_host, row_ids=idx.astype(np.int64),
        stratum_live=freqs)


def _n_resolutions(k1: float, c: float, m: int | None) -> int:
    if m is None:
        m = max(1, int(math.floor(math.log(max(k1, 2.0), c))))
    return m


def build_family(tbl: table_lib.Table, phi: Sequence[str], k1: float,
                 c: float = 2.0, m: int | None = None, *,
                 seed: int = 0, units: np.ndarray | None = None,
                 cumulative_inclusion: bool = False,
                 incl_freqs: np.ndarray | None = None) -> SampleFamily:
    """Construct SFam(φ) from a table (offline sample creation, §2.2.1).
    `units` overrides the seeded per-row priorities.

    On a table with tombstones only LIVE rows are sampled, keyed under the
    live frequencies; `cumulative_inclusion=True` keys them under the
    cumulative physical histogram instead (the oracle of the incremental
    mutation path), and `incl_freqs` overrides the inclusion histogram
    outright, aligned to combined_codes' numbering (the oracle of decay).
    """
    phi = tuple(sorted(phi))
    for col in phi:
        if tbl.schema.column(col).kind is not ColumnKind.CATEGORICAL:
            raise ValueError(f"stratification column {col!r} must be categorical")
    codes, key_matrix = table_lib.combined_codes(tbl, phi)
    n_distinct = int(codes.max()) + 1 if len(codes) else 0
    live = tbl.live
    live_freqs = table_lib.stratum_frequencies(
        codes if live is None else codes[live], n_distinct)
    if incl_freqs is not None:
        incl = np.asarray(incl_freqs, dtype=np.int64)
    else:
        incl = (table_lib.stratum_frequencies(codes, n_distinct)
                if cumulative_inclusion else None)
    ks = resolution_caps(k1, c, _n_resolutions(k1, c, m))
    if units is None:
        units = base_units(tbl.n_rows, seed)
    host_cols = {c: tbl.host_column(c) for c in tbl.columns_host}
    return _assemble_family(phi, ks, host_cols, units, codes, live_freqs,
                            key_matrix[:n_distinct], tbl.n_live,
                            live=live, incl_freqs=incl)


def build_uniform_family(tbl: table_lib.Table, fraction: float, c: float = 2.0,
                         m: int | None = None, *, seed: int = 0,
                         units: np.ndarray | None = None,
                         k1: float | None = None,
                         cumulative_inclusion: bool = False) -> SampleFamily:
    """Uniform family R(p): stratification on φ=∅ — one stratum of size N
    (live rows), K_1 = p·N. rate = K/N = sampling fraction; entry_key =
    u·N. `k1` overrides p·N exactly; `cumulative_inclusion=True` keys under
    the physical row count (the mutation oracle)."""
    n = tbl.n_rows
    n_live = tbl.n_live
    if k1 is None:
        k1 = fraction * n_live
    ks = resolution_caps(k1, c, _n_resolutions(k1, c, m))
    if units is None:
        units = base_units(n, seed, uniform=True)
    host_cols = {c: tbl.host_column(c) for c in tbl.columns_host}
    return _assemble_family((), ks, host_cols, units,
                            np.zeros(n, dtype=np.int64),
                            np.array([n_live], dtype=np.int64),
                            np.zeros((1, 0), dtype=np.int32), n_live,
                            live=tbl.live,
                            incl_freqs=(np.array([n], dtype=np.int64)
                                        if cumulative_inclusion else None))


def _merge_rows(order: np.ndarray, keep_old: np.ndarray):
    """The merge of a family's kept old rows with new ones, in `order`."""
    def merge(old_arr, new_arr):
        old_h = np.asarray(old_arr)[keep_old]
        return np.concatenate([old_h, np.asarray(new_arr,
                                                 dtype=old_h.dtype)])[order]
    return merge


def merge_family(fam: SampleFamily, delta_columns: Mapping[str, np.ndarray],
                 units: np.ndarray, *, new_k1: float | None = None,
                 c: float = 2.0,
                 start_row: int | None = None) -> tuple[SampleFamily, DeltaBlock]:
    """Merge an append-only delta into a materialized family (§3.2.3/§4.5).

    The delta's rows are keyed entry_key = u·F under the UPDATED stratum
    frequencies, and existing rows are re-keyed u·F_new from their stored
    unit, so the HT rates min(1, K/F_new) stay exact and the prefixes stay
    nested. Appends only grow F, so re-keying only pushes rows OUT of the
    K_1 prefix: no unsampled base row is needed. The result equals
    `build_family(appended_table, units=all_units)`.

    `new_k1` resizes the largest cap (the uniform family keeps K_1 = p·N as
    N grows); stratified families keep theirs (None). Raises KeyError if
    the family holds columns the delta lacks (gathered join attributes: the
    engine strips those before merging).
    """
    phi = fam.phi
    missing = [name for name in fam.columns_host if name not in delta_columns]
    if missing:
        raise KeyError(
            f"delta lacks columns {missing} present on family {phi!r} — "
            "strip gathered join columns before merging")
    live_old = fam.live_freqs
    if start_row is None:
        # The inclusion total counts every physical row tracked since the
        # build: exact unless the family was built on a tombstoned table
        # (the engine passes the table's delta.start_row).
        start_row = int(fam.stratum_freqs.sum())
    if phi:
        mat = np.stack([np.asarray(delta_columns[col], dtype=np.int32)
                        for col in phi], axis=1)
        dcodes, key_matrix = table_lib.map_codes_stable(mat, fam.strata_keys)
        new_freqs = table_lib.extend_frequencies(fam.stratum_freqs, dcodes,
                                                 len(key_matrix))
        new_live = table_lib.extend_frequencies(live_old, dcodes,
                                                len(key_matrix))
        ks = fam.ks
    else:
        d = len(next(iter(delta_columns.values())))
        dcodes = np.zeros(d, dtype=np.int64)
        key_matrix = fam.strata_keys
        # The family's OWN inclusion base grows (a family built on a
        # tombstoned table has a live base), as the stratified branch's.
        new_freqs = np.array([int(fam.stratum_freqs[0]) + d], dtype=np.int64)
        new_live = np.array([int(live_old[0]) + d], dtype=np.int64)
        ks = (resolution_caps(new_k1, c, len(fam.ks))
              if new_k1 is not None else fam.ks)
    k1 = ks[0]
    freqs_f32 = new_freqs.astype(np.float32)

    old_units = fam.unit_host
    old_strata = fam.row_strata
    old_ek = old_units * freqs_f32[old_strata]
    keep_old = old_ek < k1

    units = np.asarray(units, dtype=np.float32)
    d_freq = freqs_f32[dcodes]
    d_ek = units * d_freq
    keep_d = d_ek < k1

    d_row_ids = start_row + np.arange(len(dcodes), dtype=np.int64)
    block = DeltaBlock(
        columns={name: np.asarray(delta_columns[name])[keep_d]
                 for name in fam.columns_host},
        unit=units[keep_d], strata=dcodes[keep_d].astype(np.int32),
        freq=d_freq[keep_d], entry_key=d_ek[keep_d],
        freq_table=freqs_f32, n_dropped_old=int((~keep_old).sum()),
        row_ids=d_row_ids[keep_d])

    ek_m = np.concatenate([old_ek[keep_old], block.entry_key])
    order = np.argsort(ek_m, kind="stable")
    ek_sorted = ek_m[order]
    prefixes = tuple(int(np.searchsorted(ek_sorted, k, side="left"))
                     for k in ks)
    merge = _merge_rows(order, keep_old)
    merged = SampleFamily(
        phi=phi, ks=ks, prefix_sizes=prefixes, n_rows=int(ek_sorted.size),
        table_rows=fam.table_rows + len(dcodes),
        n_distinct=len(new_freqs), stratum_freqs=new_freqs,
        strata_keys=key_matrix,
        row_strata=merge(old_strata, block.strata.astype(np.int64)),
        entry_key_host=ek_sorted,
        columns_host={name: merge(fam.host_column(name), block.columns[name])
                      for name in fam.columns_host},
        unit_host=merge(old_units, block.unit),
        row_ids=merge(fam.row_ids, block.row_ids),
        stratum_live=new_live)
    return merged, block


@dataclasses.dataclass
class TombstoneBlock:
    """What one apply_tombstones pass removed from a family: what the
    executor's `stripe_tombstone` ghosts in the striped block."""
    row_ids: np.ndarray            # int64: dead rows that WERE in the sample
    n_tombstoned: int              # total dead rows (sampled or not)

    @property
    def n_sampled(self) -> int:
        return int(self.row_ids.size)


def apply_tombstones(fam: SampleFamily, row_ids: np.ndarray,
                     row_columns: Mapping[str, np.ndarray]
                     ) -> tuple[SampleFamily, TombstoneBlock]:
    """Apply a TableMutation's tombstones to a materialized family.

    Dead rows that were sampled leave the host family (their striped slots
    become self-excluding ghosts through stripe_tombstone); the LIVE
    per-stratum counts drop by every dead row, sampled or not. The
    inclusion frequencies, and with them every surviving row's entry_key
    and HT rate, are untouched: a row's inclusion probability was fixed by
    the frequencies it was keyed under, so estimates over the live rows
    stay unbiased without re-keying (docs/MAINTENANCE.md).

    `row_ids` are the tombstoned physical rows; `row_columns` their encoded
    columns as of death (TableMutation.tombstoned_columns), which give each
    dead row's stratum without reading the base table.
    """
    row_ids = np.asarray(row_ids, dtype=np.int64)
    n_dead = int(row_ids.size)
    live_old = fam.live_freqs
    if fam.phi:
        mat = np.stack([np.asarray(row_columns[col], dtype=np.int32)
                        for col in fam.phi], axis=1)
        dcodes, keys = table_lib.map_codes_stable(mat, fam.strata_keys)
        if len(keys) != len(fam.strata_keys):
            raise ValueError(
                "tombstoned rows reference strata this family has never "
                "seen — the mutation does not belong to its table")
    else:
        dcodes = np.zeros(n_dead, dtype=np.int64)
    dec = np.bincount(dcodes, minlength=len(live_old)).astype(np.int64)
    new_live = live_old - dec
    if (new_live < 0).any():
        raise ValueError("tombstones exceed live stratum counts — rows "
                         "deleted twice?")
    dead = np.isin(fam.row_ids, row_ids)
    block = TombstoneBlock(row_ids=fam.row_ids[dead], n_tombstoned=n_dead)
    table_rows = fam.table_rows - n_dead
    if not dead.any():
        return dataclasses.replace(fam, stratum_live=new_live,
                                   table_rows=table_rows), block
    keep = ~dead
    ek = fam.entry_key_host[keep]         # keys unchanged: still sorted
    out = SampleFamily(
        phi=fam.phi, ks=fam.ks,
        prefix_sizes=tuple(int(np.searchsorted(ek, k, side="left"))
                           for k in fam.ks),
        n_rows=int(ek.size), table_rows=table_rows,
        n_distinct=fam.n_distinct, stratum_freqs=fam.stratum_freqs,
        strata_keys=fam.strata_keys, row_strata=fam.row_strata[keep],
        entry_key_host=ek,
        columns_host={name: fam.host_column(name)[keep]
                      for name in fam.columns_host},
        unit_host=fam.unit_host[keep], row_ids=fam.row_ids[keep],
        stratum_live=new_live)
    return out, block


def remap_family_row_ids(fam: SampleFamily,
                         remap: np.ndarray) -> SampleFamily:
    """Re-key a family's physical row ids through a base-table compaction
    remap (types.TableCompaction). The sample's content is untouched:
    compaction only relabels the positions of live rows, and every family
    row is live (tombstone passes drop dead sampled rows)."""
    if (fam.row_ids < 0).any():
        raise ValueError("family has sentinel row_ids — rebuild it to "
                         "enable base compaction")
    new_ids = np.asarray(remap, dtype=np.int64)[fam.row_ids]
    if (new_ids < 0).any():
        raise ValueError("family holds rows the compaction dropped — "
                         "tombstones were not applied before compacting")
    return dataclasses.replace(fam, row_ids=new_ids)


@dataclasses.dataclass
class DecayBlock:
    """What one inclusion-frequency decay pass did to a family: the strata
    it reset and the row churn. Decay both removes and ADMITS rows, so its
    striped-block consequence is a full restripe."""
    strata: np.ndarray             # int64: stable stratum ids reset
    n_dropped: int                 # old sampled rows removed (their strata)
    n_admitted: int                # fresh rows admitted under the reset freqs
    epoch: int = 0                 # decay epoch that drew the fresh units


def decay_strata(fam: SampleFamily, tbl: table_lib.Table,
                 strata: np.ndarray, units_full: np.ndarray
                 ) -> tuple[SampleFamily, DecayBlock]:
    """Inclusion-frequency decay (docs/MAINTENANCE.md): reset the inclusion
    frequencies of `strata` to their LIVE counts and resample those strata
    from the base table under fresh entry keys.

    Churn inflates the cumulative inclusion counts while live rows dwindle,
    so a churned stratum's sample thins to live·K/F_cum. This pass drops
    the family's rows of the decayed strata, draws fresh units for every
    LIVE base row of them from `units_full` (decay_units, indexed by
    physical row id), keys them u·F_live and admits entry_key < K_1; every
    other stratum's rows, keys and rates stay as they were.
    """
    if not fam.phi:
        raise ValueError("decay needs a stratified family")
    strata = np.unique(np.asarray(strata, dtype=np.int64))
    new_freqs = fam.stratum_freqs.copy()
    new_freqs[strata] = fam.live_freqs[strata]

    # Every base row's STABLE stratum id.
    mat = np.stack([tbl.host_column(c).astype(np.int32) for c in fam.phi],
                   axis=1)
    codes, keys = table_lib.map_codes_stable(mat, fam.strata_keys)
    if len(keys) != len(fam.strata_keys):
        raise ValueError("table holds strata this family has never seen — "
                         "merge the pending delta before decaying")
    sel = np.isin(codes, strata)
    if tbl.live is not None:
        sel &= tbl.live
    idx = np.flatnonzero(sel).astype(np.int64)

    freqs_f32 = new_freqs.astype(np.float32)
    u = np.asarray(units_full, dtype=np.float32)[idx]
    ek_new = u * freqs_f32[codes[idx]]
    keep_new = ek_new < fam.ks[0]

    keep_old = ~np.isin(fam.row_strata, strata)
    ek_m = np.concatenate([fam.entry_key_host[keep_old], ek_new[keep_new]])
    order = np.argsort(ek_m, kind="stable")
    ek_sorted = ek_m[order]
    merge = _merge_rows(order, keep_old)
    out = SampleFamily(
        phi=fam.phi, ks=fam.ks,
        prefix_sizes=tuple(int(np.searchsorted(ek_sorted, k, side="left"))
                           for k in fam.ks),
        n_rows=int(ek_sorted.size), table_rows=fam.table_rows,
        n_distinct=len(new_freqs), stratum_freqs=new_freqs,
        strata_keys=fam.strata_keys,
        row_strata=merge(fam.row_strata, codes[idx][keep_new]),
        entry_key_host=ek_sorted,
        columns_host={name: merge(fam.host_column(name),
                                  tbl.host_column(name)[idx][keep_new])
                      for name in fam.columns_host},
        unit_host=merge(fam.unit_host, u[keep_new]),
        row_ids=merge(fam.row_ids, idx[keep_new]),
        stratum_live=fam.stratum_live)
    block = DecayBlock(strata=strata, n_dropped=int((~keep_old).sum()),
                       n_admitted=int(keep_new.sum()))
    return out, block


def stratified_exact_k(tbl: table_lib.Table, phi: Sequence[str], k: int, *,
                       seed: int = 0) -> dict[str, np.ndarray]:
    """Paper-faithful exact-K stratified sample (host reference): for every
    distinct x of φ keep all rows if F(x) <= K else exactly K uniform rows.
    Returns host columns plus `_rate` (per-row sampling rate, §4.3)."""
    codes, _ = table_lib.combined_codes(tbl, phi)
    n_distinct = int(codes.max()) + 1 if len(codes) else 0
    freqs = table_lib.stratum_frequencies(codes, n_distinct)
    rng = np.random.default_rng(seed)
    prio = rng.random(tbl.n_rows)
    # Rank within stratum by random priority; keep rank < K.
    order = np.lexsort((prio, codes))
    ranks = np.empty(tbl.n_rows, dtype=np.int64)
    sorted_codes = codes[order]
    # vectorized rank-within-group over the sorted array
    boundaries = np.flatnonzero(np.diff(sorted_codes)) + 1
    starts = np.concatenate([[0], boundaries])
    group_start = np.repeat(starts, np.diff(np.concatenate([starts, [len(codes)]])))
    ranks[order] = np.arange(tbl.n_rows) - group_start
    keep = ranks < k
    rate = np.minimum(1.0, k / freqs[codes])
    out = {name: arr[keep] for name, arr in tbl.columns_host.items()}
    out["_rate"] = rate[keep].astype(np.float32)
    return out


def _power_sum(s: float, m: int) -> float:
    """Σ_{r=1..m} r^{-s}: exact partial sum + Euler–Maclaurin tail (supports
    m up to 1e9+ without materializing ranks)."""
    cut = min(m, 1_000_000)
    r = np.arange(1, cut + 1, dtype=np.float64)
    total = float((r ** -s).sum())
    if m > cut:
        a, b = float(cut + 1), float(m)
        if abs(s - 1.0) < 1e-12:
            integral = math.log(b / a)
        else:
            integral = (a ** (1 - s) - b ** (1 - s)) / (s - 1)
        total += integral + 0.5 * (a ** -s + b ** -s) \
            + s / 12.0 * (a ** (-s - 1) - b ** (-s - 1))
    return total


def zipf_storage_fraction(s: float, k: float, m_values: int) -> float:
    """Appendix A / Table 5: storage of S(φ,K) as a fraction of the table when
    φ ~ Zipf(s) with M distinct values and F(x) = M / rank(x)^s.

    (The paper sets the *highest frequency* to M; total table rows are then
    Σ_r M/r^s.)  Σ min(F(r), K) = K·r* + M·Σ_{r>r*} r^{-s} with
    r* = #ranks where F ≥ K = floor((M/K)^{1/s})."""
    m = float(m_values)
    r_star = int(min(m, math.floor((m / k) ** (1.0 / s))))
    head = k * r_star
    tail = m * (_power_sum(s, m_values) - _power_sum(s, r_star)) if r_star < m_values else 0.0
    total = m * _power_sum(s, m_values)
    return float((head + tail) / total)
