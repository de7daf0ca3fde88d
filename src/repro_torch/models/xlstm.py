"""xLSTM mixers: mLSTM (matrix memory, exponentially gated) and sLSTM
(scalar memory with block-diagonal recurrence), per arXiv:2405.04517
(counterpart of `repro.models.xlstm`).

Both use exponential gating with the max-state stabilizer m_t, which starts
at the finite -1e30 (with -inf, exp(log_f + m - m_new) would be inf - inf)
and whose gradient is not stopped, as in the reference. Train/prefill runs
a Python loop over time where the reference `lax.scan`s (the hidden state
is O(1) a step); decode is one step of the same cell. The cells compute in
float32 whatever the compute dtype. The reference's sharding constraints
are layout hints with no effect on one device and are left out.

Weights read at their stored dtype (`MLSTM_AS_STORED`, `SLSTM_AS_STORED`,
used by `model.AS_STORED`): mLSTM's gate biases, which the reference adds
to the compute-dtype gate inputs uncast (float32 promotes), and its
`ln_scale`, cast to the float32 cell output; sLSTM's recurrent matrices,
which the reference casts to float32 from its master. The rest come in
the compute dtype.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models.common import (ParamFactory, causal_conv, einsum,
                                       softplus)
from repro_torch.models.mlp import silu

MLSTM_AS_STORED = frozenset({"b_i", "b_f", "ln_scale"})
SLSTM_AS_STORED = frozenset({"r_i", "r_f", "r_z", "r_o"})
GATES = ("i", "f", "z", "o")
M_INIT = -1e30


@dataclasses.dataclass(frozen=True)
class XLSTMDims:
    d_model: int
    n_heads: int
    proj_factor: float = 2.0     # mLSTM up-projection factor
    conv_kernel: int = 4

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def d_head(self) -> int:
        return self.d_inner // self.n_heads


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1/(1 + exp(-x)), what `jax.nn.sigmoid` lowers to (see mlp.silu)."""
    return 1 / (1 + torch.exp(-x))


# ------------------------------------------------------------------ mLSTM

class MLSTM(nn.Module):
    """up_proj [d, 2·di], conv_w [k, di] (scale 0.5), conv_b, wq/wk/wv
    [di, H, dh], w_i/w_f [di, H] (scale 0.02), b_i = 0, b_f = 3 (long
    memory), ln_scale [H, dh] = 1, down_proj [di, d]; each stacked over
    `repeats` layers."""

    def __init__(self, pf: ParamFactory, dims: XLSTMDims,
                 repeats: int | None = None):
        super().__init__()
        d, di, h, dh = dims.d_model, dims.d_inner, dims.n_heads, dims.d_head
        qkv = ("mlp", "q_heads", "head")
        self.up_proj = pf.dense((d, 2 * di), ("embed", "mlp"), repeats)
        self.conv_w = pf.dense((dims.conv_kernel, di), ("conv", "mlp"),
                               repeats, scale=0.5)
        self.conv_b = pf.zeros((di,), ("mlp",), repeats)
        self.wq = pf.dense((di, h, dh), qkv, repeats)
        self.wk = pf.dense((di, h, dh), qkv, repeats)
        self.wv = pf.dense((di, h, dh), qkv, repeats)
        self.w_i = pf.dense((di, h), ("mlp", "q_heads"), repeats, scale=0.02)
        self.w_f = pf.dense((di, h), ("mlp", "q_heads"), repeats, scale=0.02)
        self.b_i = pf.zeros((h,), ("q_heads",), repeats)
        self.b_f = pf.constant((h,), ("q_heads",), 3.0, repeats)
        self.ln_scale = pf.ones((h, dh), ("q_heads", "head"), repeats)
        self.down_proj = pf.dense((di, d), ("mlp", "embed"), repeats)


class MLSTMState(NamedTuple):
    c: torch.Tensor     # [B, H, dh, dh] matrix memory
    n: torch.Tensor     # [B, H, dh]    normalizer
    m: torch.Tensor     # [B, H]        stabilizer (log-space max)
    conv: torch.Tensor  # [B, k-1, di]


def init_mlstm_state(batch: int, dims: XLSTMDims, device=None,
                     repeats: int | None = None) -> MLSTMState:
    """float32 zeros, m at -1e30, stacked [R, ...] over `repeats` layers."""
    lead = ((repeats,) if repeats else ()) + (batch,)
    h, dh = dims.n_heads, dims.d_head
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        torch.zeros(lead + (h, dh, dh), **f32),
        torch.zeros(lead + (h, dh), **f32),
        torch.full(lead + (h,), M_INIT, **f32),
        torch.zeros(lead + (dims.conv_kernel - 1, dims.d_inner), **f32))


def mlstm_state_axes() -> MLSTMState:
    """Logical axes of a (one layer's) MLSTMState."""
    return MLSTMState(("batch", "q_heads", "head", None),
                      ("batch", "q_heads", "head"),
                      ("batch", "q_heads"),
                      ("batch", None, "mlp"))


def _mlstm_cell(state: MLSTMState, qkvif):
    """One timestep. q/k/v [B,H,dh]; i/f pre-activations [B,H]; float32.
    Returns (new state, its conv passed through; h [B,H,dh])."""
    q, k, v, ig, fg = qkvif
    c, n, m, conv = state
    dh = q.shape[-1]
    log_f = -softplus(-fg)                    # log sigmoid(f)
    m_new = torch.maximum(log_f + m, ig)
    i_ = torch.exp(ig - m_new)
    f_ = torch.exp(log_f + m - m_new)
    kn = k * (dh ** -0.5)
    c_new = f_[..., None, None] * c + i_[..., None, None] * (
        kn[..., :, None] * v[..., None, :])
    n_new = f_[..., None] * n + i_[..., None] * kn
    denom = torch.maximum(torch.abs(einsum("bhd,bhd->bh", n_new, q)),
                          torch.exp(-m_new))
    hval = einsum("bhde,bhd->bhe", c_new, q) / denom[..., None]
    return MLSTMState(c_new, n_new, m_new, conv), hval


def _mlstm_qkvif(p, xc, xs):
    """q, k from the conv output xc, v from the pre-conv input xs
    ([B,S,H,dh]); the gates' pre-activations [B,S,H]; all float32."""
    q = einsum("bsd,dhk->bshk", xc, p["wq"])
    k = einsum("bsd,dhk->bshk", xc, p["wk"])
    v = einsum("bsd,dhk->bshk", xs, p["wv"])
    ig = einsum("bsd,dh->bsh", xc, p["w_i"]) + p["b_i"]
    fg = einsum("bsd,dh->bsh", xc, p["w_f"]) + p["b_f"]
    return q.float(), k.float(), v.float(), ig.float(), fg.float()


def _mlstm_out(p, x, hs, z, dims: XLSTMDims):
    """hs [B,S,H,dh] float32 -> the block's output [B,S,D] in x's dtype."""
    b, s = hs.shape[:2]
    hs = hs * p["ln_scale"].float()[None, None]
    hs = hs.reshape(b, s, dims.d_inner).to(x.dtype)
    return einsum("bse,ed->bsd", hs * silu(z), p["down_proj"])


def mlstm_forward(p, x: torch.Tensor, dims: XLSTMDims):
    """x [B,S,D] -> (y, final state). Sequential loop over time."""
    b, s, _ = x.shape
    up = einsum("bsd,de->bse", x, p["up_proj"])
    xs, z = torch.split(up, dims.d_inner, dim=-1)
    xc, conv_tail = causal_conv(xs, p["conv_w"])
    xc = silu(xc + p["conv_b"])
    q, k, v, ig, fg = _mlstm_qkvif(p, xc, xs)

    state = init_mlstm_state(b, dims, x.device)
    hs = []
    for t in range(s):
        state, h = _mlstm_cell(state, (q[:, t], k[:, t], v[:, t], ig[:, t],
                                       fg[:, t]))
        hs.append(h)
    out = _mlstm_out(p, x, torch.stack(hs, dim=1), z, dims)
    return out, state._replace(conv=conv_tail.float())


def mlstm_decode(p, x: torch.Tensor, dims: XLSTMDims, state: MLSTMState):
    """One step: x [B,1,D] -> (y [B,1,D], new state); the state given is
    read, not written."""
    up = einsum("bsd,de->bse", x, p["up_proj"])
    xs, z = torch.split(up, dims.d_inner, dim=-1)
    xc, conv_tail = causal_conv(xs, p["conv_w"], state.conv)
    xc = silu(xc + p["conv_b"])
    q, k, v, ig, fg = _mlstm_qkvif(p, xc, xs)
    new_state, h = _mlstm_cell(state, (q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                       fg[:, 0]))
    out = _mlstm_out(p, x, h[:, None], z, dims)
    return out, new_state._replace(conv=conv_tail.float())


# ------------------------------------------------------------------ sLSTM

class SLSTM(nn.Module):
    """Per gate g in (i, f, z, o): w_g [d, H, dh], r_g [H, dh, dh]
    (block-diagonal recurrence, scale 0.02) and b_g [H, dh] (1 for f, else
    0), dh = d/H; out_proj [d, d]; each stacked over `repeats` layers."""

    def __init__(self, pf: ParamFactory, dims: XLSTMDims,
                 repeats: int | None = None):
        super().__init__()
        d, h = dims.d_model, dims.n_heads
        dh = d // h
        for g in GATES:
            setattr(self, f"w_{g}", pf.dense(
                (d, h, dh), ("embed", "q_heads", "head"), repeats))
            setattr(self, f"r_{g}", pf.dense(
                (h, dh, dh), ("q_heads", "head", None), repeats, scale=0.02))
            setattr(self, f"b_{g}", pf.constant(
                (h, dh), ("q_heads", "head"), 1.0 if g == "f" else 0.0,
                repeats))
        self.out_proj = pf.dense((d, d), ("embed", "embed2"), repeats)


class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, H, dh]
    n: torch.Tensor   # [B, H, dh]
    h: torch.Tensor   # [B, H, dh]
    m: torch.Tensor   # [B, H, dh]


def init_slstm_state(batch: int, dims: XLSTMDims, device=None,
                     repeats: int | None = None) -> SLSTMState:
    """float32 zeros, m at -1e30, stacked [R, ...] over `repeats` layers."""
    shape = (((repeats,) if repeats else ())
             + (batch, dims.n_heads, dims.d_model // dims.n_heads))
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    return SLSTMState(z(), z(), z(), torch.full(shape, M_INIT,
                                                 dtype=torch.float32,
                                                 device=device))


def slstm_state_axes() -> SLSTMState:
    """Logical axes of a (one layer's) SLSTMState."""
    ax = ("batch", "q_heads", "head")
    return SLSTMState(ax, ax, ax, ax)


def _slstm_cell(p, state: SLSTMState, xg: dict):
    """xg: per-gate inputs [B,H,dh] (pre-recurrent), float32."""
    c, n, hprev, m = state
    rec = lambda g: einsum("bhd,hde->bhe", hprev, p[f"r_{g}"].float())
    i_pre = xg["i"] + rec("i")
    f_pre = xg["f"] + rec("f")
    z_ = torch.tanh(xg["z"] + rec("z"))
    o_ = sigmoid(xg["o"] + rec("o"))
    log_f = -softplus(-f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_ = torch.exp(i_pre - m_new)
    f_ = torch.exp(log_f + m - m_new)
    c_new = f_ * c + i_ * z_
    n_new = f_ * n + i_
    h_new = o_ * c_new / torch.clamp_min(n_new, 1e-6)
    return SLSTMState(c_new, n_new, h_new, m_new), h_new


def _slstm_gate_inputs(p, x: torch.Tensor) -> dict:
    """x [B,S,D] -> {gate: x·w_g + b_g [B,S,H,dh]}, formed in x's dtype,
    then float32."""
    return {g: (einsum("bsd,dhk->bshk", x, p[f"w_{g}"])
                + p[f"b_{g}"][None, None]).float() for g in GATES}


def slstm_forward(p, x: torch.Tensor, dims: XLSTMDims):
    b, s, d = x.shape
    xg = _slstm_gate_inputs(p, x)
    state = init_slstm_state(b, dims, x.device)
    hs = []
    for t in range(s):
        state, h = _slstm_cell(p, state, {g: v[:, t] for g, v in xg.items()})
        hs.append(h)
    hs = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return einsum("bsd,de->bse", hs, p["out_proj"]), state


def slstm_decode(p, x: torch.Tensor, dims: XLSTMDims, state: SLSTMState):
    b = x.shape[0]
    xg = _slstm_gate_inputs(p, x)
    new_state, h = _slstm_cell(p, state, {g: v[:, 0] for g, v in xg.items()})
    hs = h.reshape(b, 1, -1).to(x.dtype)
    return einsum("bsd,de->bse", hs, p["out_proj"]), new_state
