"""Plain PyTorch versions of the scan kernels (counterpart of
`repro.kernels.ref`).

They define the semantics. On the CPU the dispatch in kernels/ops.py runs
them; on the card chip_smoke.py holds the CUDA kernel against them. Nothing
on the main path calls them when a card is present.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import QUANTILE_BINS, cmp_fns

_CMP = cmp_fns()


def agg_scan_ref(values: torch.Tensor | None, rates: torch.Tensor,
                 mask: torch.Tensor, group_codes: torch.Tensor | None,
                 n_groups: int,
                 accumulate: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused predicate + HT-weighted grouped moments: f32[7, n_groups] in
    GroupedMoments field order (n, wsum, wxsum, wx2sum, var_count, var_sum,
    var_sum2). Per-row terms are float32; `accumulate` is the dtype the
    index_add_ sums run in (float64 gives an order-independent yardstick
    for the kernel's float32 sums at full size). Rows whose code lies
    outside [0, n_groups) land in no group, as the reference's one-hot and
    segment_sum drop them. values None reads every value as 1 (COUNT);
    group_codes None puts every row in group 0."""
    if values is None:
        values = torch.ones_like(rates)
    if group_codes is None:
        group_codes = torch.zeros(rates.shape, dtype=torch.int32,
                                  device=rates.device)
    g = group_codes.to(torch.int64)
    keep = (g >= 0) & (g < n_groups)
    if not bool(keep.all()):
        values, rates, mask, g = values[keep], rates[keep], mask[keep], g[keep]
    m = mask.to(torch.float32)
    r = rates.to(torch.float32)
    x = values.to(torch.float32)
    w = m / r
    vfac = m * (1.0 - r) / (r * r)

    def seg(v):
        out = torch.zeros(n_groups, dtype=accumulate, device=v.device)
        return out.index_add_(0, g, v.to(accumulate))

    return torch.stack([seg(m), seg(w), seg(w * x), seg(w * x * x),
                        seg(vfac), seg(vfac * x), seg(vfac * x * x)]
                       ).to(torch.float32)


def weighted_sum_ref(values: torch.Tensor, weights: torch.Tensor,
                     mask: torch.Tensor, accumulate: torch.dtype = torch.float32
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked HT-weighted reductions: (Σ w·m, Σ w·m·x, Σ w·m·x²), float32
    scalars (the reference's `weighted_sum_ref`). Per-row terms are
    float32; `accumulate` is the dtype the sums run in."""
    m = mask.to(torch.float32)
    w = weights.to(torch.float32) * m
    x = values.to(torch.float32)
    return tuple(t.to(accumulate).sum().to(torch.float32)
                 for t in (w, w * x, w * x * x))


def dnf_mask(atom_cols, ops_struct, consts: torch.Tensor, shape,
             device) -> torch.Tensor:
    """DNF of a template over atom columns (flattened template order) with
    one query's f32 constants; no conjunctions = TRUE."""
    if not ops_struct:
        return torch.ones(shape, dtype=torch.bool, device=device)
    disj = torch.zeros(shape, dtype=torch.bool, device=device)
    ai = 0
    for conj in ops_struct:
        m = torch.ones(shape, dtype=torch.bool, device=device)
        for op in conj:
            m = m & _CMP[op](atom_cols[ai].to(torch.float32), consts[ai])
            ai += 1
        disj = disj | m
    return disj


def agg_scan_batched_ref(values: torch.Tensor, freq: torch.Tensor,
                         entry_key: torch.Tensor, atom_cols: torch.Tensor,
                         group_codes: torch.Tensor, ks: torch.Tensor,
                         pred_consts: torch.Tensor, ops_struct, n_groups: int,
                         accumulate: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Q queries over ONE family block. Per query q:
      prefix_q = entry_key < ks[q]
      mask_q   = prefix_q & DNF(ops_struct, atom_cols, pred_consts[q])
      rates_q  = min(1, ks[q] / freq)
    then the 7-statistic grouped reduction of agg_scan_ref. Atom i
    (flattened template order) compares atom_cols[i] against
    pred_consts[q, i]; codes outside [0, n_groups) land in no group.
    Returns f32[Q, 7, n_groups]."""
    ks = ks.to(torch.float32)
    pred_consts = pred_consts.to(torch.float32)
    freq = freq.to(torch.float32)
    out = []
    for q in range(ks.shape[0]):
        k = ks[q]
        mask = (entry_key < k) & dnf_mask(atom_cols, ops_struct,
                                          pred_consts[q], values.shape,
                                          values.device)
        rates = torch.clamp_max(k / freq, 1.0)
        out.append(agg_scan_ref(values, rates, mask, group_codes, n_groups,
                                accumulate))
    return torch.stack(out)


def agg_scan_fused_ref(values: torch.Tensor | None, unit: torch.Tensor,
                       strat: torch.Tensor, freq_table: torch.Tensor,
                       valid: torch.Tensor, atom_cols,
                       group_codes: torch.Tensor | None, ks: torch.Tensor,
                       pred_consts: torch.Tensor, ops_struct,
                       atom_slots=None, n_groups: int = 1,
                       accumulate: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Plain version of the fused memory-lean scan: derive the HT state
    from the primitives — freq = freq_table[strat], entry_key = unit·freq,
    invalid slots forced out of every prefix — then reduce via
    agg_scan_batched_ref. `atom_cols` is a tuple of deduplicated columns at
    their stored width; `atom_slots[i]` names the column of flattened atom
    i. `values=None` means all ones (COUNT), `group_codes=None` one group.
    Returns f32[Q, 7, n_groups]."""
    n_atoms = sum(len(c) for c in ops_struct)
    if atom_slots is None:
        atom_slots = tuple(range(n_atoms))
    if values is None:
        values = torch.ones(unit.shape, dtype=torch.float32, device=unit.device)
    if group_codes is None:
        group_codes = torch.zeros(unit.shape, dtype=torch.int32,
                                  device=unit.device)
    freq = freq_table.to(torch.float32)[strat.to(torch.int64)]
    ek = torch.where(valid, unit.to(torch.float32) * freq,
                     torch.full_like(freq, float("inf")))
    atoms = [atom_cols[s] for s in atom_slots]
    return agg_scan_batched_ref(values, freq, ek, atoms, group_codes, ks,
                                pred_consts, ops_struct, n_groups, accumulate)


def histogram_terms(values: torch.Tensor | None, unit: torch.Tensor,
                    strat: torch.Tensor, freq_table: torch.Tensor,
                    valid: torch.Tensor, atom_cols,
                    group_codes: torch.Tensor | None, k: torch.Tensor,
                    lo: float, hi: float, pred_consts: torch.Tensor,
                    ops_struct, atom_slots, n_groups: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat index g·256 + bin, weight) of every row for the quantile
    scan's histogram: the weight is w = m / r (0 off the query's prefix and
    predicate, and for codes outside [0, n_groups)), the bin
    int(clip((v - lo) / max(hi - lo, 1e-12) · 256, 0, 255)), clipped in
    float32 before the cast."""
    device = unit.device
    v = (values.to(torch.float32) if values is not None else
         torch.ones(unit.shape, dtype=torch.float32, device=device))
    g = (group_codes.to(torch.int64) if group_codes is not None else
         torch.zeros(unit.shape, dtype=torch.int64, device=device))
    k = k.to(torch.float32)[0]
    freq = freq_table.to(torch.float32)[strat.to(torch.int64)]
    ek = torch.where(valid, unit.to(torch.float32) * freq,
                     torch.full_like(freq, float("inf")))
    mask = (ek < k) & dnf_mask([atom_cols[s] for s in atom_slots], ops_struct,
                               pred_consts.to(torch.float32)[0], unit.shape,
                               device)
    w = mask.to(torch.float32) / torch.clamp_max(k / freq, 1.0)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    span = torch.clamp_min(torch.tensor(hi, dtype=torch.float32,
                                        device=device) - lo_t, 1e-12)
    bins = torch.clamp((v - lo_t) / span * QUANTILE_BINS, 0.0,
                       QUANTILE_BINS - 1).to(torch.int64)
    # A code outside [0, G) lands in no group: weight 0 at index 0.
    keep = (g >= 0) & (g < n_groups)
    w = torch.where(keep, w, torch.zeros_like(w))
    return torch.where(keep, g * QUANTILE_BINS + bins, torch.zeros_like(g)), w


def quantile_scan_ref(values: torch.Tensor | None, unit: torch.Tensor,
                      strat: torch.Tensor, freq_table: torch.Tensor,
                      valid: torch.Tensor, atom_cols,
                      group_codes: torch.Tensor | None, k: torch.Tensor,
                      lo: float, hi: float, pred_consts: torch.Tensor,
                      ops_struct, atom_slots=None, n_groups: int = 1,
                      accumulate: torch.dtype = torch.float32
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the one-query QUANTILE scan: (moments f32[7, G],
    histogram f32[G, 256]). The moments are agg_scan_fused_ref's at
    Q = 1 (k f32[1], pred_consts f32[1, n_atoms]). The histogram is the
    reference's `quantile_hist_ref` over the fixed range [lo, hi]
    (histogram_terms summed with index_add_; the reference's kernel
    returns it transposed, [256, G])."""
    n_atoms = sum(len(c) for c in ops_struct)
    if atom_slots is None:
        atom_slots = tuple(range(n_atoms))
    mom = agg_scan_fused_ref(values, unit, strat, freq_table, valid,
                             atom_cols, group_codes, k, pred_consts,
                             ops_struct, atom_slots, n_groups, accumulate)[0]
    flat, w = histogram_terms(values, unit, strat, freq_table, valid,
                              atom_cols, group_codes, k, lo, hi, pred_consts,
                              ops_struct, atom_slots, n_groups)
    hist = torch.zeros(n_groups * QUANTILE_BINS, dtype=accumulate,
                       device=unit.device)
    hist.index_add_(0, flat, w.to(accumulate))
    return mom, hist.to(torch.float32).reshape(n_groups, QUANTILE_BINS)
