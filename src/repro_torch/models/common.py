"""Shared model building blocks (counterpart of `repro.models.common`): the
parameter factory, RMSNorm, rotary embeddings, the cross-entropy loss, and
what the recurrent mixers share (softplus as the reference lowers it, the
depthwise causal convolution).

Parameters are `nn.Parameter`s of the reference's shapes. A layer's weights
are stacked over the pattern's repeats (a leading [R] axis), as the
reference stacks them for `lax.scan`; the port loops over R in Python.
The factory records each parameter's logical axes beside it (the
reference's axes tree, `("layers",) + axes` for a stacked leaf), which
`sharding/rules.py` maps onto a mesh.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


class ParamFactory:
    """Creates parameters with the reference's shapes and scales from one
    explicit `torch.Generator`, on its device. Without a generator the
    parameters are left uninitialised on `device`, to be loaded (on the
    "meta" device nothing is allocated). Every parameter carries its
    logical axes as `logical_axes`, led by "layers" when it is stacked
    over `repeats`."""

    def __init__(self, generator: torch.Generator | None,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        self.generator = generator
        self.dtype = dtype
        self.device = generator.device if generator is not None else device

    def _new(self, shape, repeats: int | None) -> torch.Tensor:
        full = ((repeats,) if repeats else ()) + tuple(shape)
        return torch.empty(full, dtype=self.dtype, device=self.device)

    @staticmethod
    def _param(w: torch.Tensor, axes: tuple, repeats: int | None
               ) -> nn.Parameter:
        if len(axes) != w.dim() - (1 if repeats else 0) and axes != (None,):
            raise ValueError(f"axes {axes} for a weight of shape "
                             f"{tuple(w.shape)}")
        p = nn.Parameter(w)
        p.logical_axes = (("layers",) if repeats else ()) + tuple(axes)
        return p

    def dense(self, shape: tuple[int, ...], axes: tuple,
              repeats: int | None = None,
              scale: float | None = None) -> nn.Parameter:
        """normal × scale, by default 1/√fan_in with fan_in = shape[0] of
        one layer's weight (`ParamFactory.dense`)."""
        w = self._new(shape, repeats)
        if self.generator is not None:
            s = scale if scale is not None else \
                1.0 / math.sqrt(max(shape[0], 1))
            w.normal_(generator=self.generator).mul_(s)
        return self._param(w, axes, repeats)

    def zeros(self, shape, axes: tuple,
              repeats: int | None = None) -> nn.Parameter:
        w = self._new(shape, repeats)
        if self.generator is not None:
            w.zero_()
        return self._param(w, axes, repeats)

    def ones(self, shape, axes: tuple,
             repeats: int | None = None) -> nn.Parameter:
        w = self._new(shape, repeats)
        if self.generator is not None:
            w.fill_(1.0)
        return self._param(w, axes, repeats)

    def embedding(self, vocab: int, d: int) -> nn.Parameter:
        return self.dense((vocab, d), ("vocab", "embed"), scale=0.02)

    def constant(self, shape, axes: tuple, value,
                 repeats: int | None = None) -> nn.Parameter:
        """One layer's weight of `shape` holding `value` (a float, or a
        tensor broadcast to `shape`), computed in float32 and rounded to
        the factory's dtype, as the reference's `jnp.full`, `log(tile(..))`
        and `zeros + log(expm1(0.01))` initialisers are."""
        w = self._new(shape, repeats)
        if self.generator is not None:
            w.copy_(torch.as_tensor(value, dtype=torch.float32).expand(
                w.shape))
        return self._param(w, axes, repeats)


# The mesh train step (sharding/lm.py) splits a batch over ranks; a
# statistic over all of the batch's tokens (the MoE's load-balancing terms)
# then sums over the ranks. A process-wide setting, not a thread's: the
# backward pass, and the recomputation of a checkpointed repeat, run on
# autograd's own threads.
_ALL_SUM: Callable | None = None


@contextlib.contextmanager
def split_batch(all_sum: Callable):
    """While active, `token_mean` is over the whole batch of every rank:
    all_sum(x) returns the sum of x over the ranks (differentiable)."""
    global _ALL_SUM
    prev, _ALL_SUM = _ALL_SUM, all_sum
    try:
        yield
    finally:
        _ALL_SUM = prev


def phase_boundary(kind: str) -> None:
    """Called where a step's phase begins: a repeat of the pattern
    ("repeat": its forward, and its recompute under remat) or one leaf of
    a loop over the parameters ("leaf"). An active dispatch mode with a
    `phase_boundary` method (launch/roofline.py's counter, which takes a
    step's peak memory phase by phase) is told; nothing happens
    otherwise."""
    for mode in _get_current_dispatch_mode_stack():
        hook = getattr(mode, "phase_boundary", None)
        if hook is not None:
            hook(kind)


def token_mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean(0); under `split_batch`, the mean over every rank's rows."""
    if _ALL_SUM is None:
        return x.mean(0)
    total = _ALL_SUM(torch.stack([x.sum(0), x.new_full(x.shape[1:],
                                                         x.shape[0])]))
    return total[0] / total[1]


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.einsum of two operands in one dtype. On the CPU a 16-bit
    product is formed in float32 and rounded once, as XLA's CPU dot forms
    the reference's (torch's CPU bfloat16 GEMM sums in another order and
    lands one ulp away in ~1e-4 of the elements, which a few layers then
    spread); on the card cuBLAS sums a bfloat16 product in float32."""
    if a.device.type == "cpu" and a.dtype in (torch.bfloat16, torch.float16):
        return torch.einsum(eq, a.float(), b.float()).to(a.dtype)
    return torch.einsum(eq, a, b)


class _Softplus(torch.autograd.Function):
    """log(1 + exp(x)) as `jax.nn.softplus` lowers it, `logaddexp(x, 0)`:
    max(x, 0) + log1p(exp(-|x|)); its gradient exp(x - softplus(x)), as
    logaddexp's custom JVP forms it. (`F.softplus` computes log1p(exp(x))
    below a threshold of 20, another rounding.)"""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


softplus = _Softplus.apply


def causal_conv(xs: torch.Tensor, w: torch.Tensor,
                state: torch.Tensor | None = None):
    """Depthwise causal convolution over time, as the reference writes it:
    xs [B,S,C] left-padded with k-1 zeros (or with `state`, the k-1 inputs
    before it, cast to xs's dtype), the k shifted products by w [k, C] (in
    xs's dtype) added left to right. Returns (the sum [B,S,C], the padded
    input's last k-1 rows: the next call's `state`)."""
    k, s = w.shape[0], xs.shape[1]
    if state is None:
        xp = torch.nn.functional.pad(xs, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(xs.dtype), xs], dim=1)
    out = sum(xp[:, i:i + s, :] * w[i][None, None] for i in range(k))
    return out, xp[:, xp.shape[1] - (k - 1):, :]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """float32 inside, cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def rope_cos_sin(positions: torch.Tensor, d_head: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...,] -> cos/sin [..., d_head//2] (f32)."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=positions.device) / d_head
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, D]; cos/sin broadcastable [..., S, D/2] (half-split
    rotary), cos and sin cast to x's dtype before the multiply."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean CE over all positions (float32 logsumexp), plus z_loss times
    the mean squared logsumexp (logit drift control at scale)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * (lse ** 2).mean()
    return loss
