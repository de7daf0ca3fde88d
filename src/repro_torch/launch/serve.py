"""Serving launcher: batched greedy decoding against a (random-init or
checkpointed) decoder LM (dense, MoE, recurrent or hybrid), on the card
unless --device cpu (counterpart of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --reduced --batch 4 --prompt-len 16 --new-tokens 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large

An audio arch (musicgen-large) is prompted with [B, K, P] codebook tokens.
A vision arch (llama-3.2-vision-90b) exits with the ValueError of its
cross-attention layers: the launcher, like the reference's, passes no
vision source (it raises before building the weights).

--ckpt-dir restores {"params": ...} from a checkpoint of either package's
CheckpointManager (the same layout).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.serve.engine import ServeConfig, ServeEngine, throughput_probe
from repro_torch.state import lm_params_from_reference


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, q_chunk=min(cfg.q_chunk, args.prompt_len),
                              k_chunk=min(cfg.k_chunk, args.prompt_len),
                              mamba_chunk=min(cfg.mamba_chunk, args.prompt_len))

    model_lib.require_source(cfg, None)
    device = resolve_device(args.device)
    params = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        _, state = mgr.restore({"params": params.param_tree()})
        params.load_state_dict(
            lm_params_from_reference(cfg, state["params"], device),
            assign=True)

    engine = ServeEngine(cfg, params, ServeConfig(batch=args.batch))
    rng = np.random.default_rng(args.seed)
    shape = ((args.batch, cfg.n_codebooks, args.prompt_len)
             if cfg.n_codebooks else (args.batch, args.prompt_len))
    prompts = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    stats = throughput_probe(engine, prompts, args.new_tokens)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[serve] {stats['tokens']} tokens in {stats['seconds']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s), output {stats['output_shape']}"
          f" on {name}", flush=True)


if __name__ == "__main__":
    main()
