"""HT-weighted masked reduction for Hopper (counterpart of
`repro.kernels.weighted_sum`): (Σ w·m, Σ w·m·x, Σ w·m·x²) over one pass.

The kernel is csrc/weighted_sum.cu, built and loaded by agg_scan.build with
the other kernel libraries. `weighted_sum_cuda` checks its arguments,
allocates the per-chunk partials and the result with torch.empty, launches
on the current stream and raises if the launch failed; its `launches`
attribute counts the launches. The plain version is ref.weighted_sum_ref.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import agg_scan

_BYTES_PER_CHUNK = 4 * 3     # the three partial sums of a chunk


def check_weighted_sum_args(values, weights, mask) -> None:
    """Validate a weighted_sum call (both devices take the same arguments):
    values at a stored width of the scan kernels, weights float32, mask
    bool, all [n] on one device."""
    n = weights.shape[0] if weights.dim() else -1
    agg_scan._check_rows(n, weights.device, values=values, weights=weights,
                         mask=mask)
    if values.dtype not in agg_scan._VALUE_TAGS:
        raise ValueError(f"values dtype {values.dtype} not in "
                         f"{list(agg_scan._VALUE_TAGS)}")
    if weights.dtype != torch.float32:
        raise ValueError(f"weights must be float32, got {weights.dtype}")
    if mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool, got {mask.dtype}")


def weighted_sum_cuda(values, weights, mask
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the reduction on CUDA tensors: three float32 scalars (0-d
    tensors on the card). Same arguments and semantics as
    ref.weighted_sum_ref; the chunk partials are added in a fixed order,
    so repeat launches give the same bits."""
    check_weighted_sum_args(values, weights, mask)
    device = weights.device
    agg_scan._check_cuda("weighted_sum_cuda", [values, weights, mask], device)
    lib = agg_scan.build("weighted_sum")
    n = weights.shape[0]
    with torch.cuda.device(device):
        rows, chunks = agg_scan._chunks(n, agg_scan._n_sms(device),
                                        _BYTES_PER_CHUNK)
        out = torch.empty(3, dtype=torch.float32, device=device)
        partial = torch.empty((chunks, 3), dtype=torch.float32, device=device)
        rc = lib.weighted_sum_launch(
            values.data_ptr(), agg_scan._VALUE_TAGS[values.dtype],
            weights.data_ptr(), mask.data_ptr(), n, rows, chunks,
            partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    agg_scan._raise_on(rc, "weighted_sum")
    agg_scan.count_launch(weighted_sum_cuda)
    return out[0], out[1], out[2]


weighted_sum_cuda.launches = 0
