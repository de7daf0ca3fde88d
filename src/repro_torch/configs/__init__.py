"""Architecture registry: `--arch <id>` -> ModelConfig (the reference's
registry, resolving `repro_torch.configs.<id>`). All ten architectures are
data here; the LM in `repro_torch.models` builds the dense and MoE ones."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, shapes_for

ARCHS: dict[str, str] = {
    "qwen2-1.5b": "qwen2_1_5b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "mistral-large-123b": "mistral_large_123b",
    "llama3-405b": "llama3_405b",
    "xlstm-125m": "xlstm_125m",
    "musicgen-large": "musicgen_large",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.config()


def all_archs() -> list[str]:
    return list(ARCHS)


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config",
           "all_archs", "shapes_for"]
