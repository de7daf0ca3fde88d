"""SwiGLU MLP, the dense channel mixer (counterpart of `repro.models.mlp`)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import ParamFactory, einsum


class MLP(nn.Module):
    """wi, wg [d, f] and wo [f, d], each stacked over `repeats` layers."""

    def __init__(self, pf: ParamFactory, d_model: int, d_ff: int,
                 repeats: int | None = None):
        super().__init__()
        self.wi = pf.dense((d_model, d_ff), ("embed", "mlp"), repeats)
        self.wg = pf.dense((d_model, d_ff), ("embed", "mlp"), repeats)
        self.wo = pf.dense((d_ff, d_model), ("mlp", "embed"), repeats)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x · 1/(1 + exp(-x)), each step rounded to x's dtype: what
    `jax.nn.silu` lowers to (XLA expands the logistic so). torch's fused
    silu rounds once, and in bfloat16 lands one ulp away in about a third
    of the elements."""
    return x * (1 / (1 + torch.exp(-x)))


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """silu(x·wg) * (x·wi), then ·wo; `p` holds one layer's weights in x's
    dtype."""
    h = einsum("bsd,df->bsf", x, p["wi"])
    g = einsum("bsd,df->bsf", x, p["wg"])
    h = silu(g) * h
    return einsum("bsf,fd->bsd", h, p["wo"])
