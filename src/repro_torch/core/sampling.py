"""Multi-dimensional, multi-resolution stratified sample families (paper
§3.1; counterpart of `repro.core.sampling`).

A family SFam(φ) is ONE table whose rows are sorted by entry_key = u·F(x),
u ~ U[1e-7, 1) a per-row priority and F(x) the row's stratum frequency on
φ. Membership in S(φ, K) is exactly entry_key < K, so resolutions nest, each
resolution is a prefix of the family, and the per-row inclusion probability
min(1, K/F) is exact (Horvitz–Thompson, §4.3). Families live on the host;
the executor stripes them onto the device.
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

    def host_column(self, name: str) -> np.ndarray:
        return self.columns_host[name]

    def prefix_for_k(self, k: float) -> int:
        """Rows to scan for resolution cap k (host binary search)."""
        return int(np.searchsorted(self.entry_key_host, k, side="left"))


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


def _assemble_family(phi: tuple[str, ...], ks: tuple[float, ...],
                     host_cols: Mapping[str, np.ndarray], units: np.ndarray,
                     codes: np.ndarray, freqs: np.ndarray,
                     key_matrix: np.ndarray, table_rows: int) -> SampleFamily:
    """Materialize a family from per-row (unit, stratum) assignments: keep
    entry_key = u·F < K_1, sort ascending, cut prefixes."""
    k1 = ks[0]
    row_freq = freqs.astype(np.float32)[codes] if len(codes) \
        else np.zeros(0, np.float32)
    entry_key = units.astype(np.float32) * row_freq
    keep = entry_key < k1
    order = np.argsort(entry_key[keep], kind="stable")
    idx = np.nonzero(keep)[0][order]
    ek = entry_key[idx]
    prefixes = tuple(int(np.searchsorted(ek, k, side="left")) for k in ks)
    cols_host = {name: np.asarray(arr)[idx] for name, arr in host_cols.items()}
    unit_host = units.astype(np.float32)[idx]
    return SampleFamily(
        phi=phi, ks=ks, prefix_sizes=prefixes, n_rows=int(idx.size),
        table_rows=table_rows, n_distinct=len(freqs), stratum_freqs=freqs,
        strata_keys=key_matrix, row_strata=codes[idx], entry_key_host=ek,
        columns_host=cols_host, unit_host=unit_host,
        row_ids=idx.astype(np.int64))


def _n_resolutions(k1: float, c: float, m: int | None) -> int:
    if m is None:
        m = max(1, int(math.floor(math.log(max(k1, 2.0), c))))
    return m


def build_family(tbl: table_lib.Table, phi: Sequence[str], k1: float,
                 c: float = 2.0, m: int | None = None, *,
                 seed: int = 0, units: np.ndarray | None = None) -> SampleFamily:
    """Construct SFam(φ) from a table (offline sample creation, §2.2.1).
    `units` overrides the seeded per-row priorities."""
    phi = tuple(sorted(phi))
    for col in phi:
        if tbl.schema.column(col).kind is not ColumnKind.CATEGORICAL:
            raise ValueError(f"stratification column {col!r} must be categorical")
    codes, key_matrix = table_lib.combined_codes(tbl, phi)
    n_distinct = int(codes.max()) + 1 if len(codes) else 0
    freqs = table_lib.stratum_frequencies(codes, n_distinct)
    ks = resolution_caps(k1, c, _n_resolutions(k1, c, m))
    if units is None:
        units = base_units(tbl.n_rows, seed)
    host_cols = {c: tbl.host_column(c) for c in tbl.columns_host}
    return _assemble_family(phi, ks, host_cols, units, codes, freqs,
                            key_matrix[:n_distinct], tbl.n_live)


def build_uniform_family(tbl: table_lib.Table, fraction: float, c: float = 2.0,
                         m: int | None = None, *, seed: int = 0,
                         units: np.ndarray | None = None,
                         k1: float | None = None) -> SampleFamily:
    """Uniform family R(p): stratification on φ=∅ — one stratum of size N,
    K_1 = p·N. rate = K/N = sampling fraction; entry_key = u·N."""
    n = tbl.n_rows
    if k1 is None:
        k1 = fraction * tbl.n_live
    ks = resolution_caps(k1, c, _n_resolutions(k1, c, m))
    if units is None:
        units = base_units(n, seed, uniform=True)
    host_cols = {c: tbl.host_column(c) for c in tbl.columns_host}
    return _assemble_family((), ks, host_cols, units,
                            np.zeros(n, dtype=np.int64),
                            np.array([tbl.n_live], dtype=np.int64),
                            np.zeros((1, 0), dtype=np.int32), tbl.n_live)
