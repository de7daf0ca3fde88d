"""Public wrappers of the scan kernels (counterpart of `repro.kernels.ops`).

Dispatch is by the device of the tensors: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor runs the plain PyTorch
version. There is no third mode and no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.core.estimators import GroupedMoments
from repro_torch.kernels import agg_scan as scans
from repro_torch.kernels import ref
from repro_torch.kernels import weighted_sum as ws


def agg_scan(values: torch.Tensor | None, rates: torch.Tensor,
             mask: torch.Tensor, group_codes: torch.Tensor | None,
             n_groups: int) -> GroupedMoments:
    """Predicate + HT grouped moments from precomputed rates: the drop-in
    for estimators.grouped_moments (the executor's use_pallas path and its
    programs for templates wider than the fused kernel). values None reads
    every value as 1 (COUNT), group_codes None puts every row in group 0.
    Leaves are [G]."""
    if rates.is_cuda:
        out = scans.agg_scan_cuda(values, rates, mask, group_codes,
                                     n_groups)
    elif rates.device.type == "cpu":
        scans.check_agg_scan_args(values, rates, mask, group_codes,
                                     n_groups)
        out = ref.agg_scan_ref(values, rates, mask, group_codes, n_groups)
    else:
        raise ValueError(f"agg_scan: no kernel for device {rates.device}")
    return GroupedMoments.from_stacked(out)


def agg_scan_batched(values: torch.Tensor, freq: torch.Tensor,
                     entry_key: torch.Tensor, atom_cols: torch.Tensor,
                     group_codes: torch.Tensor, ks: torch.Tensor,
                     pred_consts: torch.Tensor, ops_struct,
                     n_groups: int) -> GroupedMoments:
    """Q-query shared scan over materialized freq/entry_key (atom_cols
    [A, n], one row per flattened template atom): one pass over the family
    block serves all Q same-template queries. Leaves are [Q, G]."""
    if freq.is_cuda:
        out = scans.agg_scan_batched_cuda(values, freq, entry_key,
                                             atom_cols, group_codes, ks,
                                             pred_consts, ops_struct,
                                             n_groups)
    elif freq.device.type == "cpu":
        scans.check_batched_args(values, freq, entry_key, atom_cols,
                                    group_codes, ks, pred_consts, ops_struct,
                                    n_groups)
        out = ref.agg_scan_batched_ref(values, freq, entry_key, atom_cols,
                                       group_codes, ks, pred_consts,
                                       ops_struct, n_groups)
    else:
        raise ValueError(f"agg_scan_batched: no kernel for device "
                         f"{freq.device}")
    return GroupedMoments.from_stacked(out)


def agg_scan_fused(values: torch.Tensor | None, unit: torch.Tensor,
                   strat: torch.Tensor, freq_table: torch.Tensor,
                   valid: torch.Tensor, atom_cols,
                   group_codes: torch.Tensor | None, ks: torch.Tensor,
                   pred_consts: torch.Tensor, ops_struct, atom_slots,
                   n_groups: int) -> GroupedMoments:
    """Memory-lean Q-query shared scan over the primitive striped layout
    (unit/strat/valid + narrow-dtype columns); HT state is derived from the
    frequency table in the scan. Leaves are [Q, G]."""
    if unit.is_cuda:
        out = scans.agg_scan_fused_cuda(
            values, unit, strat, freq_table, valid, atom_cols, group_codes,
            ks, pred_consts, ops_struct, atom_slots, n_groups)
    elif unit.device.type == "cpu":
        atom_slots = scans.check_fused_args(
            values, unit, strat, freq_table, valid, atom_cols, group_codes,
            ks, pred_consts, ops_struct, atom_slots, n_groups)
        out = ref.agg_scan_fused_ref(
            values, unit, strat, freq_table, valid, atom_cols, group_codes,
            ks, pred_consts, ops_struct, atom_slots, n_groups)
    else:
        raise ValueError(f"agg_scan_fused: no kernel for device {unit.device}")
    return GroupedMoments.from_stacked(out)


def quantile_scan(values: torch.Tensor | None, unit: torch.Tensor,
                  strat: torch.Tensor, freq_table: torch.Tensor,
                  valid: torch.Tensor, atom_cols,
                  group_codes: torch.Tensor | None, k: torch.Tensor,
                  lo: float, hi: float, pred_consts: torch.Tensor,
                  ops_struct, atom_slots, n_groups: int
                  ) -> tuple[GroupedMoments, torch.Tensor]:
    """One-query QUANTILE scan: (GroupedMoments [G], HT-weighted value
    histogram f32[G, 256] over the fixed range [lo, hi])."""
    if unit.is_cuda:
        mom, hist = scans.quantile_scan_cuda(
            values, unit, strat, freq_table, valid, atom_cols, group_codes,
            k, lo, hi, pred_consts, ops_struct, atom_slots, n_groups)
    elif unit.device.type == "cpu":
        atom_slots = scans.check_quantile_args(
            values, unit, strat, freq_table, valid, atom_cols, group_codes,
            k, lo, hi, pred_consts, ops_struct, atom_slots, n_groups)
        mom, hist = ref.quantile_scan_ref(
            values, unit, strat, freq_table, valid, atom_cols, group_codes,
            k, lo, hi, pred_consts, ops_struct, atom_slots, n_groups)
    else:
        raise ValueError(f"quantile_scan: no kernel for device {unit.device}")
    return GroupedMoments.from_stacked(mom), hist


def weighted_sum(values: torch.Tensor, weights: torch.Tensor,
                 mask: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Non-grouped masked HT reduction: (Σ w·m, Σ w·m·x, Σ w·m·x²)."""
    if weights.is_cuda:
        return ws.weighted_sum_cuda(values, weights, mask)
    if weights.device.type == "cpu":
        ws.check_weighted_sum_args(values, weights, mask)
        return ref.weighted_sum_ref(values, weights, mask)
    raise ValueError(f"weighted_sum: no kernel for device {weights.device}")
