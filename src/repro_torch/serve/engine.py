"""Batched serving engine: prefill + greedy decode with KV caches
(counterpart of `repro.serve.engine`).

A request batch is prefilled in one pass, then decoded step-synchronously
on the model's device. Eager PyTorch stands in for the reference's
`jax.jit`; the caches are written in place. Over a `sharding.lm.ShardedLM`
the engine serves on its mesh: each rank holds its blocks of the caches
(placed by `cache_axes`), every rank gets the whole batch's tokens.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.train.step import (StepConfig, make_decode_step,
                                    make_prefill_step)


@dataclasses.dataclass
class ServeConfig:
    batch: int = 8
    max_len: int = 256
    eos_token: int = -1       # -1: never stops early
    cache_dtype: str = "float32"


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: model_lib.DecoderLM,
                 serve_cfg: ServeConfig,
                 step_cfg: StepConfig = StepConfig()):
        self.cfg = cfg
        self.params = params
        self.serve_cfg = serve_cfg
        self._cache_dtype = (torch.bfloat16
                             if serve_cfg.cache_dtype == "bfloat16"
                             else torch.float32)
        self._decode = make_decode_step(cfg, step_cfg)
        self._prefill = make_prefill_step(cfg, step_cfg)

    def generate(self, prompts: np.ndarray, n_new: int,
                 vision: np.ndarray | None = None) -> np.ndarray:
        """prompts int32 [B, P] ([B, K, P] audio). Greedy decode n_new
        tokens; returns int32 [B, P + n_new] ([B, K, P + n_new]) as numpy.
        `vision` [B, T, d_vision] (float32) goes to prefill and to every
        decode step."""
        cfg = self.cfg
        device = self.params.device
        b, plen = prompts.shape[0], prompts.shape[-1]
        from repro_torch.sharding import lm as mesh_lm
        if isinstance(self.params, mesh_lm.ShardedLM):
            caches = mesh_lm.init_local_cache(self.params, b, plen + n_new,
                                              self._cache_dtype)
        else:
            caches = model_lib.init_cache(cfg, b, plen + n_new,
                                          dtype=self._cache_dtype,
                                          device=device)
        toks = torch.from_numpy(prompts.astype(np.int32)).to(device)
        vis = (None if vision is None else
               torch.from_numpy(np.asarray(vision, np.float32)).to(device))

        logits, caches = self._prefill(self.params, toks, caches, vis)
        # First new token comes from the last prefill position's logits.
        cur = torch.argmax(logits[..., plen - 1, :], dim=-1)[..., None]
        cur = cur.to(torch.int32)
        out = [toks, cur]
        for t in range(n_new - 1):
            cur, caches = self._decode(self.params, cur, caches, plen + t,
                                       vis)
            out.append(cur)
        return torch.cat(out, dim=toks.dim() - 1).cpu().numpy()


def throughput_probe(engine: ServeEngine, prompts: np.ndarray, n_new: int
                     ) -> dict:
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_new)
    dt = time.perf_counter() - t0
    n_tok = prompts.shape[0] * n_new
    return {"tokens": n_tok, "seconds": dt, "tok_per_s": n_tok / dt,
            "output_shape": out.shape}
