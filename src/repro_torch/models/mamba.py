"""Mamba (S6) selective state-space mixer (counterpart of
`repro.models.mamba`).

Train/prefill: the chunked parallel form, a loop over sequence chunks
carrying the SSM state and, within a chunk, the reference's associative
scan (`_associative_scan`: its own odd/even combine tree, so the products
round as the reference's do). Decode: the O(1) recurrent step on
(conv_state, ssm_state). The reference's sharding constraints are layout
hints with no effect on one device and are left out.

Discretization (zero-order hold, as in the paper):
  h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t ;  y_t = C_t h_t + D x_t
with A diagonal (d_inner × d_state), Δ_t = softplus(dt_proj(x) + dt_bias).

`a_log` and `dt_bias` are read in float32 from the stored weight (the
reference's `.astype(jnp.float32)` of its master), the other weights in
the compute dtype (`model.AS_STORED`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models.common import (ParamFactory, causal_conv, einsum,
                                       softplus)
from repro_torch.models.mlp import silu

# Leaves read at their stored dtype, not cast to the compute dtype.
AS_STORED = frozenset({"a_log", "dt_bias"})


@dataclasses.dataclass(frozen=True)
class MambaDims:
    d_model: int
    expand: int = 2
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int | None = None   # default ceil(d_model/16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        if self.dt_rank is not None:
            return self.dt_rank
        return -(-self.d_model // 16)


class Mamba(nn.Module):
    """in_proj [d, 2·di], conv_w [d_conv, di] (scale 0.5), conv_b, x_proj
    [di, rank + 2·n], dt_proj [rank, di], dt_bias = log(expm1(0.01)),
    a_log [di, n] = log(1..n) a row, d_skip = 1, out_proj [di, d]; each
    stacked over `repeats` layers."""

    def __init__(self, pf: ParamFactory, dims: MambaDims,
                 repeats: int | None = None):
        super().__init__()
        d, di, n, r = dims.d_model, dims.d_inner, dims.d_state, dims.rank
        self.in_proj = pf.dense((d, 2 * di), ("embed", "mlp"), repeats)
        self.conv_w = pf.dense((dims.d_conv, di), ("conv", "mlp"), repeats,
                               scale=0.5)
        self.conv_b = pf.zeros((di,), ("mlp",), repeats)
        self.x_proj = pf.dense((di, r + 2 * n), ("mlp", "ssm_in"), repeats)
        self.dt_proj = pf.dense((r, di), ("ssm_rank", "mlp"), repeats)
        self.dt_bias = pf.constant((di,), ("mlp",), torch.log(torch.expm1(
            torch.tensor(0.01, dtype=torch.float32))), repeats)
        self.a_log = pf.constant((di, n), ("mlp", "ssm_state"), torch.log(
            torch.arange(1, n + 1, dtype=torch.float32)), repeats)
        self.d_skip = pf.ones((di,), ("mlp",), repeats)
        self.out_proj = pf.dense((di, d), ("mlp", "embed"), repeats)


class MambaState(NamedTuple):
    conv: torch.Tensor   # [B, d_conv-1, d_inner] rolling conv inputs
    ssm: torch.Tensor    # [B, d_inner, d_state]


def init_mamba_state(batch: int, dims: MambaDims, device=None,
                     repeats: int | None = None) -> MambaState:
    """float32 zeros, stacked [R, ...] over `repeats` layers."""
    lead = (repeats,) if repeats else ()
    return MambaState(
        torch.zeros(lead + (batch, dims.d_conv - 1, dims.d_inner),
                    dtype=torch.float32, device=device),
        torch.zeros(lead + (batch, dims.d_inner, dims.d_state),
                    dtype=torch.float32, device=device))


def mamba_state_axes() -> MambaState:
    """Logical axes of a (one layer's) MambaState."""
    return MambaState(("batch", None, "mlp"), ("batch", "mlp", "ssm_state"))


def _ssm_params(p, xz, dims: MambaDims):
    """xz [B,L,di] (post-conv, post-silu) -> Δ [B,L,di], B̃/C̃ [B,L,n],
    all float32."""
    n, r = dims.d_state, dims.rank
    proj = einsum("bld,dk->blk", xz, p["x_proj"])
    dt, b_, c_ = torch.split(proj, [r, n, n], dim=-1)
    dt = einsum("blr,rd->bld", dt, p["dt_proj"])
    dt = softplus(dt.float() + p["dt_bias"].float())
    return dt, b_.float(), c_.float()


def _combine(left, right):
    """The selective scan's associative operator on (decay, input) pairs."""
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def _slice(t: torch.Tensor, dim: int, start, stop=None, step=None):
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along `dim`; a is as long as b or one
    longer."""
    if a.shape[dim] == b.shape[dim]:
        return torch.stack([a, b], dim + 1).flatten(dim, dim + 1)
    head = torch.stack([_slice(a, dim, 0, -1), b], dim + 1)
    return torch.cat([head.flatten(dim, dim + 1), _slice(a, dim, -1)], dim)


def _associative_scan(elems: list, dim: int) -> list:
    """Inclusive scan of `_combine` over `dim`, with the combine tree of
    `jax.lax.associative_scan`: combine adjacent pairs, scan the half
    recursively (the odd outputs), combine each odd output with the next
    even input (the even outputs, after the first element), interleave.
    A sequential loop or cumprod/cumsum of logs computes the same
    recurrence but rounds otherwise."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = _combine([_slice(e, dim, 0, n - 1, 2) for e in elems],
                       [_slice(e, dim, 1, None, 2) for e in elems])
    odd = _associative_scan(list(reduced), dim)
    evens_in = [_slice(e, dim, 2, None, 2) for e in elems]
    if n % 2 == 0:
        even = _combine([_slice(o, dim, 0, -1) for o in odd], evens_in)
    else:
        even = _combine(odd, evens_in)
    even = [torch.cat([_slice(e, dim, 0, 1), r], dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _chunk_scan(h0, dt, b_, c_, x, a):
    """One chunk: h0 [B,di,n]; dt/x [B,L,di]; b_/c_ [B,L,n]; a [di,n], all
    float32. Returns (y [B,L,di], h_last)."""
    da = torch.exp(dt[..., None] * a[None, None])              # [B,L,di,n]
    dbx = dt[..., None] * b_[:, :, None, :] * x[..., None]     # [B,L,di,n]
    acc_a, acc_b = _associative_scan([da, dbx], dim=1)
    h = acc_a * h0[:, None] + acc_b                            # [B,L,di,n]
    y = einsum("bldn,bln->bld", h, c_)
    return y, h[:, -1]


def mamba_forward(p, x: torch.Tensor, dims: MambaDims, chunk: int = 256):
    """Train/prefill parallel form. x [B,S,D] -> (y [B,S,D], final
    MambaState: the last d_conv-1 pre-conv inputs and h_last, float32).
    The sequence runs in chunks of min(chunk, S), which must divide S."""
    b, s, _ = x.shape
    di = dims.d_inner
    xz = einsum("bsd,de->bse", x, p["in_proj"])
    xs, z = torch.split(xz, di, dim=-1)

    xc, tail = causal_conv(xs, p["conv_w"])
    xc = silu(xc + p["conv_b"])

    dt, b_, c_ = _ssm_params(p, xc, dims)
    a = -torch.exp(p["a_log"].float())
    xcf = xc.float()

    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the Mamba "
                         f"chunk {chunk}")
    h = torch.zeros((b, di, dims.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        y, h = _chunk_scan(h, dt[:, sl], b_[:, sl], c_[:, sl], xcf[:, sl], a)
        ys.append(y)
    y = torch.cat(ys, dim=1).to(x.dtype)
    y = y + xcf.to(x.dtype) * p["d_skip"][None, None]
    y = y * silu(z)
    out = einsum("bse,ed->bsd", y, p["out_proj"])
    return out, MambaState(tail.float(), h)


def mamba_decode(p, x: torch.Tensor, dims: MambaDims, state: MambaState):
    """Single-token recurrent step. x [B,1,D] -> (y [B,1,D], new state);
    the state given is read, not written."""
    di = dims.d_inner
    xz = einsum("bsd,de->bse", x, p["in_proj"])
    xs, z = torch.split(xz, di, dim=-1)                        # [B,1,di]

    window = torch.cat([state.conv.to(x.dtype), xs], dim=1)    # [B,d_conv,di]
    xc = einsum("bkd,kd->bd", window, p["conv_w"])
    xc = silu(xc + p["conv_b"])[:, None]                       # [B,1,di]

    dt, b_, c_ = _ssm_params(p, xc, dims)
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt[:, 0, :, None] * a[None])                # [B,di,n]
    dbx = (dt[:, 0, :, None] * b_[:, 0, None, :]
           * xc.float()[:, 0, :, None])
    h = state.ssm * da + dbx
    y = einsum("bdn,bn->bd", h, c_[:, 0])[:, None]             # [B,1,di]
    y = y.to(x.dtype) + xc * p["d_skip"][None, None]
    y = y * silu(z)
    out = einsum("bse,ed->bsd", y, p["out_proj"])
    return out, MambaState(window[:, 1:].float(), h)

