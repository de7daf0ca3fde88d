"""Batched serving example on the port: prefill + greedy decode with KV
and recurrent-state caches across four architecture families (attention,
SSM, hybrid, audio: musicgen-large is prompted with [B, K, P] codebook
tokens, as examples/serve_lm.py shapes them), each reduced (counterpart of
examples/serve_lm.py). Runs on the card unless --device cpu.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.serve.engine import ServeConfig, ServeEngine, throughput_probe

ARCHS = ("qwen2-1.5b", "codeqwen1.5-7b", "xlstm-125m", "jamba-v0.1-52b",
         "musicgen-large")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        cfg = dataclasses.replace(cfg, q_chunk=16, k_chunk=16, mamba_chunk=16)
        params = model_lib.init_params(
            cfg, torch.Generator(device=device).manual_seed(1))
        engine = ServeEngine(cfg, params, ServeConfig(batch=4))
        shape = (4, cfg.n_codebooks, 16) if cfg.n_codebooks else (4, 16)
        prompts = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        stats = throughput_probe(engine, prompts, n_new=24)
        print(f"{arch:18s} ({cfg.family:6s}): {stats['tok_per_s']:8.1f} tok/s"
              f"  out={stats['output_shape']}  on {device.type}")


if __name__ == "__main__":
    main()
