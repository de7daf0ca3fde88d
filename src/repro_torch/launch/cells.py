"""Dry-run cell construction (counterpart of `repro.launch.cells`): per
(arch × shape × mesh) the step function, its arguments as meta tensors and
their placements, allocating nothing.

`input_specs(cfg, shape)` gives the meta stand-ins of every model input of
a shape: tokens and labels for train; the request batch (and `pos` for
decode) for serving; the vision source of a vision arch.

A `Cell` keeps the reference's fields. The dry run reads `args_sds`,
`in_shardings`, `cfg`, `policy`, `mesh` and `rules`; `fn`, `out_shardings`
and `donate` are kept for parity with the reference's Cell (which
compiles `fn` with them) and no path of the port reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models import model as model_lib
from repro_torch.sharding import rules as rules_lib
from repro_torch.train import optim as optim_lib
from repro_torch.train import step as step_lib


def auto_policy(cfg: ModelConfig) -> str:
    """Dtype policy: models over 200B params train with bfloat16 params
    and int8 moments."""
    return "lowmem" if cfg.param_count() > 2e11 else "f32"


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for every model input of this shape."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        tok_shape = (b, cfg.n_codebooks, s) if cfg.n_codebooks else (b, s)
        specs = {"tokens": _meta(tok_shape, i32),
                 "labels": _meta(tok_shape, i32)}
    elif shape.kind == "prefill":
        tok_shape = (b, cfg.n_codebooks, s) if cfg.n_codebooks else (b, s)
        specs = {"tokens": _meta(tok_shape, i32)}
    else:  # decode: one new token against a seq_len cache
        tok_shape = (b, cfg.n_codebooks, 1) if cfg.n_codebooks else (b, 1)
        specs = {"tokens": _meta(tok_shape, i32), "pos": _meta((), i32)}
    if cfg.n_vision_tokens:
        specs["vision"] = _meta((b, cfg.n_vision_tokens, cfg.d_vision),
                                torch.bfloat16)
    return specs


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    fn: Any                   # the step function
    args_sds: tuple           # its arguments as meta tensors
    in_shardings: tuple
    out_shardings: Any
    donate: tuple[int, ...]
    cfg: ModelConfig
    policy: str
    mesh: Any = None
    rules: Any = None


def batch_shardings(specs: dict, mesh, rules: rules_lib.ShardingRules):
    """Each input's placement: its leading dim over the batch axes."""
    out = {}
    for k, v in specs.items():
        axes = ("batch",) + (None,) * (v.dim() - 1)
        spec = (rules_lib.logical_to_pspec(axes, tuple(v.shape), rules, mesh)
                if v.dim() else ())
        out[k] = rules_lib.NamedSharding(mesh, spec)
    return out


def cell_rules(cfg: ModelConfig, mesh, multi_pod: bool
               ) -> rules_lib.ShardingRules:
    """The reference's choice: batch-parallel attention where the q heads
    do not divide the model axis, experts over it where they divide it."""
    model_extent = rules_lib.mesh_extents(mesh).get("model", 1)
    attn_dp = cfg.n_heads % model_extent != 0
    moe_ep = bool(cfg.n_experts) and cfg.n_experts % model_extent == 0
    return rules_lib.default_rules(multi_pod=multi_pod, attn_dp=attn_dp,
                                   moe_ep=moe_ep)


def build_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
               policy: str | None = None) -> Cell:
    """`mesh`: a DeviceMesh or {name: extent}."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rules = cell_rules(cfg, mesh, multi_pod)
    policy = policy or auto_policy(cfg)
    step_cfg = step_lib.StepConfig(policy=policy)
    opt_cfg = optim_lib.OptConfig()

    sh = step_lib.build_shardings(cfg, mesh, rules, step_cfg, opt_cfg)
    specs = input_specs(cfg, shape)
    batch_sh = batch_shardings(specs, mesh, rules)
    vis = ("vision",) if "vision" in specs else ()

    if shape.kind == "train":
        fn = step_lib.make_train_step(cfg, opt_cfg, step_cfg)
        args = (sh["params_sds"], sh["opt_sds"], specs)
        in_sh = (sh["params_sharding"], sh["opt_sharding"], batch_sh)
        out_sh = (sh["params_sharding"], sh["opt_sharding"], None)
        donate = (0, 1)
    else:
        cache_sds = model_lib.init_cache(cfg, shape.global_batch,
                                         shape.seq_len, torch.bfloat16,
                                         "meta")
        cache_sh = rules_lib.tree_shardings(
            mesh, rules, model_lib.cache_axes(cfg), cache_sds)
        if shape.kind == "prefill":
            fn = step_lib.make_prefill_step(cfg, step_cfg)
            args = (sh["params_sds"], specs["tokens"], cache_sds) + tuple(
                specs[k] for k in vis)
            in_sh = (sh["params_sharding"], batch_sh["tokens"],
                     cache_sh) + tuple(batch_sh[k] for k in vis)
            out_sh = (None, cache_sh)
        else:
            fn = step_lib.make_decode_step(cfg, step_cfg)
            args = (sh["params_sds"], specs["tokens"], cache_sds,
                    specs["pos"]) + tuple(specs[k] for k in vis)
            in_sh = (sh["params_sharding"], batch_sh["tokens"], cache_sh,
                     rules_lib.NamedSharding(mesh, ())) + tuple(
                batch_sh[k] for k in vis)
            out_sh = (batch_sh["tokens"], cache_sh)
        donate = (2,)
    return Cell(arch, shape, fn, args, in_sh, out_sh, donate, cfg, policy,
                mesh, rules)
