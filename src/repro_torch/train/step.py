"""Train / serve step factories (counterpart of `repro.train.step`).

`make_train_step` closes over (cfg, opt_cfg, step_cfg) and returns
  step(params, opt_state, batch) -> (params, opt_state, metrics)
where `params` is the `DecoderLM`, updated in place with its optimizer
state. Dtype policy:
  * "f32"    — params f32, compute bf16, moments f32 (default)
  * "lowmem" — params bf16, compute bf16, moments int8

On a (data, model) mesh the same factories take a `sharding.lm.ShardedLM`
(each rank's blocks of the parameters) and run `sharding.lm`'s mesh step,
prefill and decode; `build_shardings` gives the placements of the
parameters and the optimizer state by the sharding rules (meta tensors for
the shapes, as the reference's ShapeDtypeStructs), `place_state` a full
state's blocks on this rank.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint.ckpt import flatten_with_paths, map_leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.sharding import rules as rules_lib
from repro_torch.train import optim as optim_lib


@dataclasses.dataclass(frozen=True)
class StepConfig:
    policy: str = "f32"          # f32 | lowmem
    remat: bool = True
    aux_weight: float = 0.01

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.policy == "lowmem" else torch.float32

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16

    def opt_config(self, base: optim_lib.OptConfig) -> optim_lib.OptConfig:
        if self.policy == "lowmem":
            return dataclasses.replace(base, moments_dtype="int8")
        return base


def make_train_step(cfg: ModelConfig, opt_cfg: optim_lib.OptConfig,
                    step_cfg: StepConfig = StepConfig()):
    """A step of `loss_fn`'s gradients and AdamW over a batch of "tokens"
    and "labels" (and "vision", float32, for a vision model). A step whose
    loss is not finite leaves the parameters and the optimizer state as
    they were and returns its metrics, so that the loop's NaN guard
    retries from the same state (as over the reference's functional
    step)."""
    from repro_torch.sharding import lm as mesh_lm
    mesh_step = mesh_lm.train_step(cfg, opt_cfg, step_cfg)
    opt_cfg = step_cfg.opt_config(opt_cfg)

    def train_step(params, opt_state, batch):
        if isinstance(params, mesh_lm.ShardedLM):
            return mesh_step(params, opt_state, batch)
        batch = {k: v.to(params.device) for k, v in batch.items()}
        tree = params.param_tree()
        leaves = [p for _, p in flatten_with_paths(tree)]
        with torch.enable_grad():
            loss, parts = model_lib.loss_fn(
                params, cfg, batch, compute_dtype=step_cfg.compute_dtype,
                remat=step_cfg.remat, aux_weight=step_cfg.aux_weight)
            grads = iter(torch.autograd.grad(loss, leaves))
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}}
        if not optim_lib.loss_is_finite(metrics["loss"]):
            return params, opt_state, metrics
        grads = map_leaves(lambda _: next(grads), tree)
        _, opt_state, om = optim_lib.adamw_update(grads, opt_state, tree,
                                                  opt_cfg)
        return params, opt_state, {**metrics, **om}

    return train_step


def make_decode_step(cfg: ModelConfig, step_cfg: StepConfig = StepConfig()):
    """serve_step(params, tokens, caches, pos, vision) -> (next tokens of
    the whole batch, caches); over a ShardedLM and
    `sharding.lm.MeshCaches`, the mesh's."""
    from repro_torch.sharding import lm as mesh_lm
    mesh_step = mesh_lm.serve_step(cfg, step_cfg, "decode")

    def serve_step(params, tokens, caches, pos, vision=None):
        if isinstance(params, mesh_lm.ShardedLM):
            return mesh_step(params, tokens, caches, pos, vision)
        return model_lib.decode_step(params, cfg, tokens, caches, pos,
                                     compute_dtype=step_cfg.compute_dtype,
                                     vision=vision)
    return serve_step


def make_prefill_step(cfg: ModelConfig, step_cfg: StepConfig = StepConfig()):
    """prefill_step(params, tokens, caches, vision) -> (logits, caches):
    the logits of the whole batch [B, S, V] ([B, K, S, V] audio) on one
    device; over a ShardedLM and `sharding.lm.MeshCaches`, the mesh's
    step, whose logits are this rank's block of them: its rows by the
    batch's placement (`sharding.lm.batch_rows`), every position, the
    whole vocabulary (`sharding.lm.gather_rows` gathers the batch)."""
    from repro_torch.sharding import lm as mesh_lm
    mesh_step = mesh_lm.serve_step(cfg, step_cfg, "prefill")

    def prefill_step(params, tokens, caches, vision=None):
        if isinstance(params, mesh_lm.ShardedLM):
            return mesh_step(params, tokens, caches, vision)
        return model_lib.prefill(params, cfg, tokens, caches,
                                 compute_dtype=step_cfg.compute_dtype,
                                 vision=vision)
    return prefill_step


# --------------------------------------------------------------- shardings

def build_shardings(cfg: ModelConfig, mesh, rules: rules_lib.ShardingRules,
                    step_cfg: StepConfig, opt_cfg: optim_lib.OptConfig):
    """{"params_sds", "params_sharding", "axes", "opt_sds",
    "opt_sharding"}: the parameter and optimizer-state trees as meta
    tensors, their logical axes and their NamedShardings on `mesh` (a
    DeviceMesh or {name: extent}); the dry run and a real placement share
    it."""
    opt_cfg = step_cfg.opt_config(opt_cfg)
    params_sds, axes = model_lib.abstract_params(cfg, step_cfg.param_dtype)
    param_sh = rules_lib.tree_shardings(mesh, rules, axes, params_sds)
    opt_sds = optim_lib.init_opt_state(params_sds, opt_cfg)
    opt_axes = optim_lib.opt_state_axes(axes, opt_cfg)
    opt_sh = rules_lib.tree_shardings(mesh, rules, opt_axes, opt_sds)
    return {"params_sds": params_sds, "params_sharding": param_sh,
            "axes": axes, "opt_sds": opt_sds, "opt_sharding": opt_sh}


def tree_bytes(shardings, sds) -> int:
    """Bytes one rank holds of a tree of meta tensors placed by a
    NamedSharding tree of the same structure."""
    held = dict(flatten_with_paths(shardings))
    return sum(rules_lib.placed_bytes(held[path].mesh, held[path].spec,
                                      tuple(t.shape), t.element_size())
               for path, t in flatten_with_paths(sds))


def place_state(model, opt_state, mesh, rules: rules_lib.ShardingRules,
                opt_cfg: optim_lib.OptConfig | None = None):
    """A full state (the same DecoderLM and optimizer state on every rank)
    placed on `mesh` (a DeviceMesh over the default process group): (the
    ShardedLM of the parameters, this rank's blocks of the optimizer
    state). With opt_state None the moments start at zero in the blocks
    alone (`opt_cfg`'s), no full state formed."""
    from repro_torch.sharding import lm as mesh_lm
    comm = mesh_lm.MeshComm(mesh)
    params = mesh_lm.ShardedLM.place(model, comm, rules)
    if opt_state is None:
        return params, mesh_lm.init_opt_state(params, opt_cfg)
    opt_sh = mesh_lm.state_shardings(params, opt_state)["opt"]
    return params, mesh_lm.place_tree(comm, opt_state, opt_sh)
