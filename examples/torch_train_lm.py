"""End-to-end training on the port: a ~25M-param qwen2-family model for a
few hundred steps on the synthetic corpus, with checkpoint/restart fault
tolerance (counterpart of examples/train_lm.py). Runs on the card unless
--device cpu.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --steps 5 --device cpu
    # kill it mid-run, re-run the same command: it resumes from the last
    # checkpoint (the data stream position is part of the checkpoint).
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.tokens import DataConfig, SyntheticTokenStream
from repro_torch.models import model as model_lib
from repro_torch.train import optim as optim_lib
from repro_torch.train import step as step_lib
from repro_torch.train.loop import LoopConfig, train


def small_config():
    """~25M params: a real (if small) qwen2-shaped model."""
    cfg = get_config("qwen2-1.5b")
    return dataclasses.replace(
        cfg, name="qwen2-25m", n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=2, d_head=32, d_ff=1024, vocab_size=32_000,
        q_chunk=128, k_chunk=128)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = small_config()
    cfg = dataclasses.replace(cfg, q_chunk=min(cfg.q_chunk, args.seq),
                              k_chunk=min(cfg.k_chunk, args.seq))
    params = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train_lm] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps of batch {args.batch} x seq {args.seq} "
          f"on {device.type}")

    opt_cfg = optim_lib.OptConfig(lr=3e-3, warmup_steps=30,
                                  decay_steps=args.steps)
    step_cfg = step_lib.StepConfig(policy="f32", remat=False)
    opt_state = optim_lib.init_opt_state(params.param_tree(), opt_cfg)
    step_fn = step_lib.make_train_step(cfg, opt_cfg, step_cfg)

    stream = SyntheticTokenStream(
        DataConfig(cfg.vocab_size, args.seq, args.batch, seed=0))
    loop = LoopConfig(total_steps=args.steps, ckpt_every=100, log_every=20,
                      ckpt_dir=args.ckpt_dir)
    params, opt_state, telemetry = train(step_fn, params, opt_state, stream,
                                         loop)
    losses = [r["loss"] for r in telemetry.records]
    if not losses:
        print(f"[train_lm] the checkpoint in {args.ckpt_dir} is already at "
              f"step {args.steps}")
        return
    print(f"[train_lm] loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'FELL' if losses[-1] < losses[0] else 'DID NOT FALL'})")


if __name__ == "__main__":
    main()
