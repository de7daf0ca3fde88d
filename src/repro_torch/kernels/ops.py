"""Public wrappers of the scan kernels (counterpart of `repro.kernels.ops`).

Dispatch is by the device of the tensors: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor runs the plain PyTorch
version. There is no third mode and no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.core.estimators import GroupedMoments
from repro_torch.kernels import agg_scan, ref


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
        out = agg_scan.agg_scan_fused_cuda(
            values, unit, strat, freq_table, valid, atom_cols, group_codes,
            ks, pred_consts, ops_struct, atom_slots, n_groups)
    elif unit.device.type == "cpu":
        atom_slots = agg_scan.check_fused_args(
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
        mom, hist = agg_scan.quantile_scan_cuda(
            values, unit, strat, freq_table, valid, atom_cols, group_codes,
            k, lo, hi, pred_consts, ops_struct, atom_slots, n_groups)
    elif unit.device.type == "cpu":
        atom_slots = agg_scan.check_quantile_args(
            values, unit, strat, freq_table, valid, atom_cols, group_codes,
            k, lo, hi, pred_consts, ops_struct, atom_slots, n_groups)
        mom, hist = ref.quantile_scan_ref(
            values, unit, strat, freq_table, valid, atom_cols, group_codes,
            k, lo, hi, pred_consts, ops_struct, atom_slots, n_groups)
    else:
        raise ValueError(f"quantile_scan: no kernel for device {unit.device}")
    return GroupedMoments.from_stacked(mom), hist
