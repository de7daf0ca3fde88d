"""Serve step factories (counterpart of `repro.train.step`'s
`make_decode_step` and `make_prefill_step`). Dtype policy:
  * "f32"    — params f32, compute bf16 (default)
  * "lowmem" — params bf16, compute bf16

`make_train_step`, the optimizer and `build_shardings` wait for the
training slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib


@dataclasses.dataclass(frozen=True)
class StepConfig:
    policy: str = "f32"          # f32 | lowmem

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.policy == "lowmem" else torch.float32

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16


def make_decode_step(cfg: ModelConfig, step_cfg: StepConfig = StepConfig()):
    def serve_step(params, tokens, caches, pos):
        return model_lib.decode_step(params, cfg, tokens, caches, pos,
                                     compute_dtype=step_cfg.compute_dtype)
    return serve_step


def make_prefill_step(cfg: ModelConfig, step_cfg: StepConfig = StepConfig()):
    def prefill_step(params, tokens, caches):
        return model_lib.prefill(params, cfg, tokens, caches,
                                 compute_dtype=step_cfg.compute_dtype)
    return prefill_step
