"""Fault-tolerant training loop: checkpoint/restart, NaN guard, telemetry
(counterpart of `repro.train.loop`).

Telemetry: every step appends a record (step, domain-wise token counts, loss)
to an in-memory telemetry table which BlinkDB can query with error bounds
(examples/torch_telemetry_queries.py --train-steps N) — the paper's
technique applied to the training framework's own data plane.

A checkpoint holds {"params", "opt", "data": {"step", "seed"}} under the
reference's leaf names, so a run of either package resumes in the other;
a restore loads into the model's parameters and the optimizer's tensors in
place, on their device. Over a mesh (`sharding.lm.ShardedLM`) a save
gathers the full arrays and rank 0 writes them; a restore cuts each
leaf to this rank's block (the files hold no topology).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (CheckpointManager, flatten_with_paths,
                                        load_into)
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.fault.supervisor import RetryLoop


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 2


@dataclasses.dataclass
class Telemetry:
    records: list[dict] = dataclasses.field(default_factory=list)

    def log(self, step: int, loss: float, domains: np.ndarray, extras: dict):
        for d in np.unique(domains):
            self.records.append({
                "step": step, "domain": int(d),
                "n_seqs": int((domains == d).sum()),
                "loss": float(loss), **{k: float(v) for k, v in extras.items()},
            })

    def as_columns(self) -> dict[str, np.ndarray]:
        if not self.records:
            return {}
        keys = self.records[0].keys()
        return {k: np.asarray([r[k] for r in self.records]) for k in keys}


def _checkpoint_state(params, opt_state, data) -> dict:
    return {"params": params.param_tree(), "opt": opt_state, "data": data}


def train(step_fn: Callable, params, opt_state, stream: SyntheticTokenStream,
          loop_cfg: LoopConfig, resume: bool = True,
          put_batch: Callable | None = None) -> tuple[Any, Any, Telemetry]:
    """Generic loop: step_fn(params, opt, batch) -> (params, opt, metrics),
    `params` a `DecoderLM`, the batch {"tokens", "labels"} as CPU tensors
    (the step moves them; `put_batch` may first)."""
    from repro_torch.sharding import lm as mesh_lm
    mesh = (mesh_lm.state_shardings(params, opt_state)
            if isinstance(params, mesh_lm.ShardedLM) else None)
    mgr = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep,
                            async_save=mesh is None)
    telemetry = Telemetry()
    start = 0
    if resume and mgr.latest_step() is not None:
        like = _checkpoint_state(params, opt_state,
                                 {"step": np.zeros((), np.int64),
                                  "seed": np.zeros((), np.int64)})
        step0, state = mgr.restore(like, shardings=mesh and {
            **mesh, "data": {"step": None, "seed": None}})
        with torch.no_grad():
            for (_, dst), (_, arr) in zip(
                    flatten_with_paths({"params": like["params"],
                                        "opt": like["opt"]}),
                    flatten_with_paths({"params": state["params"],
                                        "opt": state["opt"]})):
                load_into(dst, arr)
        stream.step = int(state["data"]["step"])
        start = step0
        print(f"[loop] resumed from step {start}")

    # Only a non-finite loss is retried: a CUDA error or an out-of-memory
    # (RuntimeErrors) propagates at once.
    retry = RetryLoop(max_retries=2, retry_on=(FloatingPointError,))
    t_last = time.perf_counter()
    for step in range(start, loop_cfg.total_steps):
        batch_np = stream.next_batch()
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()
                 if k in ("tokens", "labels")}
        if put_batch:
            batch = put_batch(batch)

        def one_step():
            p2, o2, m = step_fn(params, opt_state, batch)
            loss = float(m["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"NaN loss at step {step}")
            return p2, o2, m

        params, opt_state, metrics = retry.run(one_step)
        telemetry.log(step, float(metrics["loss"]), batch_np["domain"],
                      {"grad_norm": metrics.get("grad_norm", 0.0)})

        if step % loop_cfg.log_every == 0:
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            print(f"[loop] step {step} loss {float(metrics['loss']):.4f} "
                  f"({dt:.2f}s)")
        if loop_cfg.ckpt_every and (step + 1) % loop_cfg.ckpt_every == 0:
            state = _checkpoint_state(
                params, opt_state, {"step": np.int64(stream.step),
                                    "seed": np.int64(stream.cfg.seed)})
            if mesh is not None:
                state = {**mesh_lm.gather_tree(
                    params.comm, {"params": state["params"],
                                  "opt": state["opt"]}, mesh),
                         "data": state["data"]}
            if mesh is None or params.comm.rank == 0:
                mgr.save(step + 1, state)
            if mesh is not None:
                params.comm.barrier()
    mgr.wait()
    return params, opt_state, telemetry
