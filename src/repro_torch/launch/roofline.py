"""Scan byte accounting of the port (counterpart of the one function of
`repro.launch.roofline` a sample scan needs). The reference module's device
constants and time projections describe its TPU and are not carried over:
the card's own bound comes from a chip run (chip_smoke.py's bound_ms)."""
from __future__ import annotations


def scan_bytes_per_row(streamed_dtypes) -> int:
    """Bytes/row a sample-family scan streams from device memory: the sum of
    the per-row itemsizes (`torch.dtype.itemsize`) of its streamed block
    tensors. Dtype-exact and
    machine-independent. Constant blocks (the frequency table, the query
    constants) amortize to ~0 bytes/row and are excluded; pass ONLY the
    per-row streams.

    The fused layout on a 1-atom dict-encoded template: f32 values + f32
    unit + int8 strat + bool valid + int8 atom + int8 codes = 12 B/row."""
    return int(sum(d.itemsize for d in streamed_dtypes))
