"""AdamW with optional int8 block-quantized moments + cosine schedule
(counterpart of `repro.train.optim`), plain functions on tensors.

The int8 moment store (per-128-block absmax scales) cuts the optimizer
state to a quarter of float32's. Quantization error is re-absorbed every
step because moments are dequantized, updated with the fresh gradient, and
re-quantized (block absmax keeps relative error ~1/254 per block).

The state keeps the reference's tree, {"m", "v", "step"}, the moments
shaped as the parameter tree (int8 leaves {"q", "scale"}, `v` stored in
sqrt-space), so checkpoints cross packages. `adamw_update` writes the
parameters and the moments in place, leaf by leaf: a model holds no second
copy of either. The last bits follow the reference: the schedule and the
bias corrections in float32 tensors, `torch.round` half to even as
`jnp.round`, and `global_norm` summed over the leaves in the reference's
leaf order (`checkpoint.ckpt.flatten_with_paths`).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.checkpoint.ckpt import SEP, flatten_with_paths, map_leaves
from repro_torch.models.common import phase_boundary


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 200
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    update_clip: float = 3.0     # per-element |m̂/√v̂| trust bound (Adafactor-style)
    moments_dtype: str = "f32"   # "f32" | "int8"
    quant_block: int = 128


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to min_lr_ratio; float32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


# ----------------------------------------------------- int8 block quant

def _pad_to(x: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    n = x.shape[-1]
    pad = (-n) % block
    if pad:
        x = F.pad(x, (0, pad))
    return x, n


def quantize_i8(x: torch.Tensor, block: int) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(q int8 of x's shape, scale float32 [..., blocks]): the last axis
    padded with zeros to whole blocks, each block's absmax / 127."""
    xp, n = _pad_to(x, block)
    xb = xp.reshape(*xp.shape[:-1], -1, block)
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0
    q = torch.round(xb / torch.clamp(scale, min=1e-20)).to(torch.int8)
    return q.reshape(xp.shape)[..., :n], scale[..., 0]


def dequantize_i8(q: torch.Tensor, scale: torch.Tensor,
                  block: int) -> torch.Tensor:
    qp, n = _pad_to(q, block)
    qb = qp.reshape(*qp.shape[:-1], -1, block).float()
    x = qb * scale[..., None]
    return x.reshape(qp.shape)[..., :n]


# ----------------------------------------------------- state containers

def init_opt_state(params, cfg: OptConfig) -> dict:
    """Zero moments shaped as the parameter tree (`DecoderLM.param_tree()`),
    on each parameter's device, and step 0 (int32)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if cfg.moments_dtype == "int8":
        def mk(p):
            q, s = quantize_i8(zeros(p), cfg.quant_block)
            return {"q": q, "scale": s}
        # v is stored in sqrt-space (see adamw_update): linear-absmax int8 of
        # raw v collapses small second moments to zero inside a block, which
        # explodes m/√v.
        moments = (map_leaves(mk, params), map_leaves(mk, params))
    else:
        moments = (map_leaves(zeros, params), map_leaves(zeros, params))
    device = flatten_with_paths(params)[0][1].device
    return {"m": moments[0], "v": moments[1],
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_axes(axes_tree, cfg: OptConfig):
    """Logical axes of the optimizer state: the moments mirror the
    parameters (an int8 leaf's `scale` drops the last axis, replicated over
    the blocks), `step` a scalar marker."""
    from repro_torch.sharding.rules import map_axes

    def leaf(a):
        if cfg.moments_dtype == "int8":
            return {"q": a, "scale": a[:-1] + (None,)}
        return a
    moments = map_axes(leaf, axes_tree)
    return {"m": moments, "v": moments, "step": (None,)}


def global_norm(tree) -> torch.Tensor:
    """√(Σ x²) over the leaves in the reference's order, float32."""
    total = 0
    for _, x in flatten_with_paths(tree):
        phase_boundary("leaf")
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def loss_is_finite(loss: torch.Tensor) -> bool:
    """The steps' NaN guard: whether the loss is finite (read from the
    device). A "meta" loss holds no data to guard (a dry count of the
    step, launch/roofline.py) and passes, after the same test's ops."""
    finite = torch.isfinite(loss)
    return loss.is_meta or bool(finite)


def _at(tree, path: str):
    """The subtree of `tree` at a `flatten_with_paths` path."""
    for key in path.split(SEP):
        tree = tree[int(key)] if isinstance(tree, (tuple, list)) else tree[key]
    return tree


class Rows:
    """Where an int8 moment's blocks lie. On one device every leaf holds
    whole rows; on a mesh (sharding/lm.py) a leaf whose last axis is
    sharded gathers its rows for the update and keeps its own part."""

    def gather(self, path: str, x: torch.Tensor) -> torch.Tensor:
        return x

    def own(self, path: str, x: torch.Tensor) -> torch.Tensor:
        return x


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptConfig,
                 gnorm: torch.Tensor | None = None, rows: Rows = Rows()):
    """Returns (params, opt_state, {"lr", "grad_norm"}): `params` (a tree
    of tensors, e.g. `DecoderLM.param_tree()`) and the moments of
    `opt_state` updated in place, and the state's step advanced. `gnorm`
    (default: `global_norm(grads)`) and `rows` (int8 moments over whole
    rows) are the mesh step's: a rank's leaves are its shards."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    # A true division: torch computes `float / tensor` as reciprocal · float.
    scale_clip = torch.clamp(
        gnorm.new_tensor(cfg.clip_norm) / torch.clamp(gnorm, min=1e-9),
        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    int8 = cfg.moments_dtype == "int8"

    def load(path, leaf, sqrt_space=False):
        if int8:
            x = dequantize_i8(rows.gather(path, leaf["q"]), leaf["scale"],
                              cfg.quant_block)
            return x * x if sqrt_space else x
        return leaf

    def store(path, leaf, x, sqrt_space=False):
        if int8:
            x = torch.sqrt(x) if sqrt_space else x
            q, s = quantize_i8(x, cfg.quant_block)
            leaf["q"].copy_(rows.own(path, q))
            leaf["scale"].copy_(s)
        else:
            leaf.copy_(x)

    for path, p in flatten_with_paths(params):
        phase_boundary("leaf")
        g = (rows.gather(path, _at(grads, path)) if int8
             else _at(grads, path)).float() * scale_clip
        m_leaf, v_leaf = _at(opt_state["m"], path), _at(opt_state["v"], path)
        m = b1 * load(path, m_leaf) + (1 - b1) * g
        v = b2 * load(path, v_leaf, sqrt_space=True) + (1 - b2) * g * g
        del g
        store(path, m_leaf, m)
        store(path, v_leaf, v, sqrt_space=True)
        if int8:
            m, v = rows.own(path, m), rows.own(path, v)
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        del m, v
        # Per-element trust bound: quantized v can undershoot for tiny
        # entries; bounding |update| keeps those elements signSGD-like.
        update = torch.clamp(update, -cfg.update_clip, cfg.update_clip)
        update = update + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * update).to(p.dtype))
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
