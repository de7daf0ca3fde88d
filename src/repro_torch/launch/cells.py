"""Dry-run cell construction (counterpart of `repro.launch.cells`): per
(arch × shape × mesh) the step function, its arguments as meta tensors and
their placements, allocating nothing.

`input_specs(cfg, shape)` gives the meta stand-ins of every model input of
a shape: tokens and labels for train; the request batch (and `pos` for
decode) for serving; the vision source of a vision arch.

A `Cell` keeps the reference's fields. `fn(*args_sds)` runs the mesh's
step (sharding/lm.py) for rank 0 of the mesh on "meta": `place` cuts the
rank's blocks out of the placed trees as fresh meta tensors (a ShardedLM
over a `DryComm`, the optimizer state's or the caches' blocks) and `step`
runs on them, so a dry count (launch/roofline.py `step_flops`) sees the
rank's own arguments, and `comm` counts its collectives. `out_shardings`
and `donate` are kept for parity with the reference's Cell (which
compiles `fn` with them); no path of the port reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.checkpoint.ckpt import flatten_with_paths, map_leaves
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models import model as model_lib
from repro_torch.sharding import lm as mesh_lm
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
    comm: Any = None          # the rank's DryComm
    place: Any = None         # args_sds -> the rank's arguments
    step: Any = None          # the step on those arguments


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


def rank_blocks(comm, shardings, sds):
    """This rank's block of each leaf of a tree of meta tensors placed by
    a NamedSharding tree of the same structure: fresh meta tensors (not
    views of the full leaves), so that their bytes are the rank's own."""
    specs = dict((p, sh.spec) for p, sh in flatten_with_paths(shardings))
    blocks = iter([torch.empty(
        rules_lib.shard_shape(specs[p], tuple(t.shape), comm.extents),
        dtype=t.dtype, device="meta") for p, t in flatten_with_paths(sds)])
    return map_leaves(lambda _: next(blocks), sds)


def rank_params(cfg: ModelConfig, comm, rules, shardings, sds,
                requires_grad: bool) -> mesh_lm.ShardedLM:
    """A ShardedLM of this rank's blocks (`rank_blocks`) of a placed
    parameter tree."""
    blocks = rank_blocks(comm, shardings, sds)
    local, spec, shape = {}, {}, {}
    for (path, t), (_, sh), (_, full) in zip(
            flatten_with_paths(blocks), flatten_with_paths(shardings),
            flatten_with_paths(sds)):
        local[path] = t.requires_grad_(requires_grad)
        spec[path], shape[path] = sh.spec, tuple(full.shape)
    return mesh_lm.ShardedLM(cfg, comm, local, spec, shape, rules)


def dry_train_step(cfg: ModelConfig, mesh, rules, step_cfg, opt_cfg, batch,
                   rank: int = 0) -> mesh_lm.DryComm:
    """`rank`'s mesh train step of `cfg` on "meta" over a DryComm, the
    parameters and the optimizer state placed by build_shardings and the
    batch of `batch`'s shapes and dtypes; returns the DryComm, whose
    `bytes` are those the rank's MeshComm sends in the same step."""
    comm = mesh_lm.DryComm(rules_lib.mesh_extents(mesh), rank)
    sh = step_lib.build_shardings(cfg, comm.extents, rules, step_cfg,
                                  opt_cfg)
    params = rank_params(cfg, comm, rules, sh["params_sharding"],
                         sh["params_sds"], True)
    opt = rank_blocks(comm, sh["opt_sharding"], sh["opt_sds"])
    step_lib.make_train_step(cfg, opt_cfg, step_cfg)(
        params, opt, {k: torch.empty(tuple(v.shape), dtype=v.dtype,
                                     device="meta")
                      for k, v in batch.items()})
    return comm


def build_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
               policy: str | None = None, repeats: int | None = None,
               seq_len: int | None = None) -> Cell:
    """`mesh`: a DeviceMesh or {name: extent}; `fn` runs rank 0's step;
    `repeats`: the config cut to that many pattern periods, and `seq_len`
    the shape's sequence cut to that length (the dry run's cost count; the
    policy stays the full config's)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if seq_len is not None:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    rules = cell_rules(cfg, mesh, multi_pod)
    policy = policy or auto_policy(cfg)
    if repeats is not None:
        cfg = dataclasses.replace(cfg, n_layers=repeats * len(cfg.pattern))
    step_cfg = step_lib.StepConfig(policy=policy)
    opt_cfg = optim_lib.OptConfig()
    comm = mesh_lm.DryComm(rules_lib.mesh_extents(mesh))

    sh = step_lib.build_shardings(cfg, mesh, rules, step_cfg, opt_cfg)
    specs = input_specs(cfg, shape)
    batch_sh = batch_shardings(specs, mesh, rules)
    vis = ("vision",) if "vision" in specs else ()

    if shape.kind == "train":
        step = step_lib.make_train_step(cfg, opt_cfg, step_cfg)
        args = (sh["params_sds"], sh["opt_sds"], specs)
        in_sh = (sh["params_sharding"], sh["opt_sharding"], batch_sh)
        out_sh = (sh["params_sharding"], sh["opt_sharding"], None)
        donate = (0, 1)

        def place(params, opt_state, batch):
            return (rank_params(cfg, comm, rules, sh["params_sharding"],
                                params, True),
                    rank_blocks(comm, sh["opt_sharding"], opt_state), batch)
    else:
        cache_sds = model_lib.init_cache(cfg, shape.global_batch,
                                         shape.seq_len, torch.bfloat16,
                                         "meta")
        cache_axes = model_lib.cache_axes(cfg)
        cache_sh = rules_lib.tree_shardings(mesh, rules, cache_axes,
                                            cache_sds)

        def rank_caches(caches):
            specs_ = rules_lib.tree_pspecs(comm.extents, rules, cache_axes,
                                           caches)
            return mesh_lm.MeshCaches(
                rank_blocks(comm, cache_sh, caches), specs_)
        if shape.kind == "prefill":
            step = step_lib.make_prefill_step(cfg, step_cfg)
            args = (sh["params_sds"], specs["tokens"], cache_sds) + tuple(
                specs[k] for k in vis)
            in_sh = (sh["params_sharding"], batch_sh["tokens"],
                     cache_sh) + tuple(batch_sh[k] for k in vis)
            out_sh = (None, cache_sh)

            def place(params, tokens, caches, *vision):
                return (rank_params(cfg, comm, rules, sh["params_sharding"],
                                    params, False), tokens,
                        rank_caches(caches), *vision)
        else:
            step = step_lib.make_decode_step(cfg, step_cfg)
            args = (sh["params_sds"], specs["tokens"], cache_sds,
                    specs["pos"]) + tuple(specs[k] for k in vis)
            in_sh = (sh["params_sharding"], batch_sh["tokens"], cache_sh,
                     rules_lib.NamedSharding(mesh, ())) + tuple(
                batch_sh[k] for k in vis)
            out_sh = (batch_sh["tokens"], cache_sh)

            def place(params, tokens, caches, pos, *vision):
                # a meta `pos` holds no position: the new token's is the
                # cache's last (the decode reads the whole cache anyway)
                return (rank_params(cfg, comm, rules, sh["params_sharding"],
                                    params, False), tokens,
                        rank_caches(caches), shape.seq_len - 1, *vision)
        donate = (2,)

    def fn(*args_sds):
        return step(*place(*args_sds))
    return Cell(arch, shape, fn, args, in_sh, out_sh, donate, cfg, policy,
                mesh, rules, comm, place, step)
