"""LM token data pipeline: deterministic, sharded, resumable (counterpart of
`repro.data.tokens`, numpy only, so its batches equal the reference's bit
for bit).

Synthetic corpus generation (seeded n-gram-ish stream over an arbitrary vocab)
plus a production-shaped loader:
  * global-batch iteration with per-data-shard slicing,
  * deterministic from (seed, step) — no stored RNG state needed,
  * `state()`/`restore()` so checkpoints capture the exact stream position,
  * per-example domain labels feeding the BlinkDB telemetry tables.

`batch_specs` gives a global batch's shapes as meta tensors (the dry run's
stand-ins, as the reference's ShapeDtypeStructs).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_domains: int = 8
    seed: int = 0


class SyntheticTokenStream:
    """Deterministic synthetic corpus: every (step, index) maps to a unique
    PRNG stream, so any shard can regenerate any example (elastic restarts
    re-slice without replaying)."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0, n_shards: int = 1,
                 start_step: int = 0):
        if cfg.global_batch % n_shards:
            raise ValueError(f"global_batch {cfg.global_batch} not divisible "
                             f"by n_shards {n_shards}")
        self.cfg = cfg
        self.shard_index = shard_index
        self.n_shards = n_shards
        self.step = start_step
        self._local = cfg.global_batch // n_shards

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: DataConfig, state: dict, shard_index: int = 0,
                n_shards: int = 1) -> "SyntheticTokenStream":
        if state["seed"] != cfg.seed:
            raise ValueError("checkpoint seed mismatch")
        return cls(cfg, shard_index, n_shards, start_step=int(state["step"]))

    def _example(self, rng: np.random.Generator) -> tuple[np.ndarray, int]:
        """Markov-ish stream: domain picks a base offset; token t+1 depends on
        token t so there is learnable structure (loss must fall in training)."""
        cfg = self.cfg
        domain = int(rng.integers(0, cfg.n_domains))
        span = max(cfg.vocab_size // cfg.n_domains, 16)
        lo = domain * (cfg.vocab_size // cfg.n_domains)
        toks = np.empty(cfg.seq_len + 1, dtype=np.int32)
        toks[0] = lo + rng.integers(0, span)
        steps = rng.integers(1, 4, size=cfg.seq_len)
        noise = rng.random(cfg.seq_len) < 0.1
        rand = lo + rng.integers(0, span, size=cfg.seq_len)
        for t in range(cfg.seq_len):
            nxt = lo + (toks[t] - lo + steps[t]) % span
            toks[t + 1] = rand[t] if noise[t] else nxt
        return toks, domain

    def next_batch(self) -> dict[str, np.ndarray]:
        cfg = self.cfg
        b = self._local
        tokens = np.empty((b, cfg.seq_len + 1), dtype=np.int32)
        domains = np.empty((b,), dtype=np.int32)
        for i in range(b):
            gidx = self.shard_index * b + i
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + self.step) * 65_537 + gidx)
            tokens[i], domains[i] = self._example(rng)
        self.step += 1
        return {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
            "domain": domains,
        }


def batch_specs(cfg: DataConfig) -> dict:
    """Meta-tensor stand-ins (int32) for a global batch (the dry run's
    input specs)."""
    import torch
    shape = (cfg.global_batch, cfg.seq_len)
    return {"tokens": torch.empty(shape, dtype=torch.int32, device="meta"),
            "labels": torch.empty(shape, dtype=torch.int32, device="meta")}
