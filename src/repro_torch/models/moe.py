"""Top-k routed Mixture-of-Experts with capacity-bounded, sort-based
dispatch (counterpart of `repro.models.moe`).

Expert weights are stacked [E, ...] (and over the repeats, [R, E, ...]).
Each token's top-k experts come from a float32 softmax over the router's
logits. Each (token, k) assignment takes the next free slot of its
expert's buffer [E, C, D], C a static capacity; an assignment past C is
dropped. The slot is the count of earlier assignments to the same expert,
found by a stable sort, so no [T, E, C] one-hot is formed. The reference's
sharding constraints are layout hints with no effect on one device and are
left out: the mesh step computes on plain tensors (sharding/lm.py), and
the aux's token means then span every rank's rows (`token_mean`).

The dispatch and the combine are plain torch ops with no atomics, so a
forward gives the same bits on every run on the card: the dispatch writes
each kept assignment into its own slot (the dropped ones into one spare
row that is then cut off, never onto a kept slot), and the combine folds
the k weighted slots of a token left to right in x's dtype, rounding after
each add, as the reference's `.at[token].add` does.

Load-balancing auxiliary loss follows Switch/Mixtral: E · Σ_e f_e · p_e.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models.common import ParamFactory, einsum, token_mean
from repro_torch.models.mlp import silu


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    d_ff: int          # per-expert hidden dim
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # "grouped": per-sequence dispatch (the reference's default);
    # "global": one buffer over all of the batch's tokens (its baseline).
    dispatch: str = "grouped"


class MoE(nn.Module):
    """router [D, E] at scale 0.02; wi, wg [E, D, F] and wo [E, F, D] at
    the factory's default scale (1/√fan_in with fan_in = shape[0] = E, as
    the reference draws them); each stacked over `repeats` layers."""

    def __init__(self, pf: ParamFactory, dims: MoEDims,
                 repeats: int | None = None):
        super().__init__()
        d, f, e = dims.d_model, dims.d_ff, dims.n_experts
        self.router = pf.dense((d, e), ("embed", "experts"), repeats,
                               scale=0.02)
        self.wi = pf.dense((e, d, f), ("experts", "embed", "mlp"), repeats)
        self.wg = pf.dense((e, d, f), ("experts", "embed", "mlp"), repeats)
        self.wo = pf.dense((e, f, d), ("experts", "mlp", "embed"), repeats)


def apply_moe(p, x: torch.Tensor, dims: MoEDims):
    """x [B,S,D] -> (y [B,S,D], aux float32 scalar); `p` holds one layer's
    weights (cast to x's dtype here if they are not)."""
    if dims.dispatch == "grouped":
        return apply_moe_grouped(p, x, dims)
    return apply_moe_global(p, x, dims)


class BF16Grad(torch.autograd.Function):
    """The identity, whose cotangent is rounded through bfloat16 (the
    reference's gradient-compression hook; nothing applies it by
    default)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


bf16_grad = BF16Grad.apply


def _route(p, xt: torch.Tensor, dims: MoEDims):
    """xt [T,D] -> (gate_w float32 [T,k], gate_idx int64 [T,k], aux).

    The logits in x's dtype, the softmax in float32; the top k by a stable
    descending sort, so that among equal probabilities the lower expert
    comes first, as `lax.top_k` orders them. The gradient reaches the
    probabilities through the gathered weights, not through the indices."""
    e, k = dims.n_experts, dims.top_k
    logits = einsum("td,de->te", xt, p["router"].to(xt.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate_idx = torch.sort(probs.detach(), dim=-1, descending=True,
                          stable=True)[1][:, :k]
    gate_w = torch.gather(probs, 1, gate_idx)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    ones = torch.zeros_like(probs.detach()).scatter_(1, gate_idx, 1.0)
    frac = token_mean(ones)
    aux = e * torch.sum(frac * token_mean(probs))
    return gate_w, gate_idx, aux


def _rank_in_expert(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """flat_e int [..., n] (each row one dispatch group's assignments) ->
    int32 [..., n]: each assignment's slot within its expert's buffer, the
    count of earlier assignments in its row routed to the same expert."""
    n = flat_e.shape[-1]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    experts = torch.arange(e, dtype=sorted_e.dtype, device=sorted_e.device)
    first_pos = torch.searchsorted(
        sorted_e, experts.expand(*sorted_e.shape[:-1], e).contiguous())
    rank_sorted = (torch.arange(n, device=flat_e.device)
                   - torch.gather(first_pos, -1, sorted_e))
    return torch.empty_like(order).scatter_(-1, order, rank_sorted).to(
        torch.int32)


def _dispatch(x: torch.Tensor, gate_idx: torch.Tensor, capacity: int,
              e: int):
    """x [G,N,D]: G dispatch groups of N tokens; gate_idx [G,N,k]. Each
    group fills its own buffer [E,C,D] with the kept assignments, each in
    its own slot. Returns (buf [G,E,C,D], slot int64 [G,N·k], keep bool
    [G,N·k]); a dropped assignment's slot is the reference's safe one,
    C - 1 of its expert, which the combine reads and zeroes."""
    g, n, d = x.shape
    k = gate_idx.shape[-1]
    flat_e = gate_idx.reshape(g, n * k)
    rank = _rank_in_expert(flat_e, e)
    keep = rank < capacity
    base = torch.arange(g, device=x.device)[:, None] * e
    slot = (base + flat_e) * capacity + torch.clamp(rank, max=capacity - 1)
    spare = g * e * capacity
    dest = torch.where(keep, slot, spare).reshape(-1)
    tokens = x[:, :, None, :].expand(g, n, k, d).reshape(g * n * k, d)
    buf = x.new_zeros((spare + 1, d)).index_put((dest,), tokens)
    return buf[:spare].reshape(g, e, capacity, d), slot, keep


def _experts(p, buf: torch.Tensor) -> torch.Tensor:
    """buf [G,E,C,D] -> [G,E,C,D]: each expert's SwiGLU over its slots,
    in buf's dtype."""
    dt = buf.dtype
    h = einsum("becd,edf->becf", buf, p["wi"].to(dt))
    g = einsum("becd,edf->becf", buf, p["wg"].to(dt))
    return einsum("becf,efd->becd", silu(g) * h, p["wo"].to(dt))


def _combine(o: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gate_w: torch.Tensor) -> torch.Tensor:
    """o [G,E,C,D]; slot, keep [G,N·k]; gate_w float32 [G,N,k] -> y
    [G,N,D]: each kept slot gathered, the dropped zeroed, weighted by
    gate_w in o's dtype, and the k slots of a token added left to right,
    rounding after each add."""
    g, n, k = gate_w.shape
    d = o.shape[-1]
    gathered = o.reshape(-1, d)[slot.reshape(-1)].reshape(g, n, k, d)
    gathered = torch.where(keep.reshape(g, n, k, 1), gathered, 0.0)
    parts = gathered * gate_w.to(o.dtype)[..., None]
    y = parts[:, :, 0]
    for j in range(1, k):
        y = y + parts[:, :, j]
    return y


def apply_moe_grouped(p, x: torch.Tensor, dims: MoEDims):
    """Per-sequence dispatch: ranking, capacity and buffer are each
    sequence's own ([B,E,C,D]); C = min(int(cf·S·k/E) + 1, S·k), so a
    one-token decode step (S = 1) never drops."""
    b, s, d = x.shape
    e, k = dims.n_experts, dims.top_k
    capacity = min(int(dims.capacity_factor * s * k / e) + 1, s * k)
    gate_w, gate_idx, aux = _route(p, x.reshape(b * s, d), dims)
    buf, slot, keep = _dispatch(x, gate_idx.reshape(b, s, k), capacity, e)
    y = _combine(_experts(p, buf), slot, keep, gate_w.reshape(b, s, k))
    return y, aux


def apply_moe_global(p, x: torch.Tensor, dims: MoEDims):
    """One buffer over all B·S tokens (the reference's baseline), its
    capacity min(int(cf·T·k/E) + 1, T) with T = B·S."""
    b, s, d = x.shape
    t = b * s
    e, k = dims.n_experts, dims.top_k
    capacity = min(int(dims.capacity_factor * t * k / e) + 1, t)
    gate_w, gate_idx, aux = _route(p, x.reshape(t, d), dims)
    buf, slot, keep = _dispatch(x.reshape(1, t, d), gate_idx[None], capacity,
                                e)
    y = _combine(_experts(p, buf), slot, keep, gate_w[None])
    return y.reshape(b, s, d), aux
