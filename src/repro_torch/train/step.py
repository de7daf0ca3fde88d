"""Train / serve step factories (counterpart of `repro.train.step`).

`make_train_step` closes over (cfg, opt_cfg, step_cfg) and returns
  step(params, opt_state, batch) -> (params, opt_state, metrics)
where `params` is the `DecoderLM`, updated in place with its optimizer
state. Dtype policy:
  * "f32"    — params f32, compute bf16, moments f32 (default)
  * "lowmem" — params bf16, compute bf16, moments int8

`build_shardings` waits for the LM mesh slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint.ckpt import flatten_with_paths, map_leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
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
    opt_cfg = step_cfg.opt_config(opt_cfg)

    def train_step(params, opt_state, batch):
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
        if not bool(torch.isfinite(metrics["loss"])):
            return params, opt_state, metrics
        grads = map_leaves(lambda _: next(grads), tree)
        _, opt_state, om = optim_lib.adamw_update(grads, opt_state, tree,
                                                  opt_cfg)
        return params, opt_state, {**metrics, **om}

    return train_step


def make_decode_step(cfg: ModelConfig, step_cfg: StepConfig = StepConfig()):
    def serve_step(params, tokens, caches, pos, vision=None):
        return model_lib.decode_step(params, cfg, tokens, caches, pos,
                                     compute_dtype=step_cfg.compute_dtype,
                                     vision=vision)
    return serve_step


def make_prefill_step(cfg: ModelConfig, step_cfg: StepConfig = StepConfig()):
    def prefill_step(params, tokens, caches, vision=None):
        return model_lib.prefill(params, cfg, tokens, caches,
                                 compute_dtype=step_cfg.compute_dtype,
                                 vision=vision)
    return prefill_step
