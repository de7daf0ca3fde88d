"""Training launcher: a decoder LM (dense, MoE, recurrent or hybrid)
trained on the synthetic corpus with checkpoint/restart, on the card
unless --device cpu (counterpart of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 200 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --policy lowmem --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --steps 3 --device cpu

The synthetic corpus holds [B, S] token streams, as the reference's
launcher trains on, so an audio (codebook) or vision arch is refused: its
batches would need codebook streams or a vision source.

--ckpt-dir holds {"params", "opt", "data"} in the layout of either
package's CheckpointManager; a run resumes from its latest checkpoint.

Started inside a process group of several ranks (torchrun's environment,
or a group this process already joined), it trains on the mesh step over
`make_host_mesh()` of that world (gloo; each rank computes on the card
unless --device cpu, the ranks sharing a card when there is one), saving
and restoring full arrays (elastic); started alone it runs in a world of
1. --production-mesh asks for the reference's 16x16 mesh and exits with
its error on any world but 256 ranks:

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen2-1.5b --steps 3 --ckpt-every 0
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.tokens import DataConfig, SyntheticTokenStream
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.sharding import rules as rules_lib
from repro_torch.train import optim as optim_lib
from repro_torch.train import step as step_lib
from repro_torch.train.loop import LoopConfig, train


@contextlib.contextmanager
def process_group():
    """The default process group this run trains in: the one already
    joined, or gloo over torchrun's environment (WORLD_SIZE > 1, left at
    exit), or none (a world of 1). Yields the world size."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        yield dist.get_world_size()
        return
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        yield 1
        return
    dist.init_process_group("gloo")
    try:
        yield dist.get_world_size()
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--policy", default="f32", choices=["f32", "lowmem"])
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 (data, model) mesh over 256 ranks; "
                         "default: the host mesh over the process group")
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.n_codebooks or cfg.n_vision_tokens:
        needs = ("codebook streams [B, K, S]" if cfg.n_codebooks
                 else "a vision source")
        ap.error(f"--arch {args.arch}: its batches need {needs}; the "
                 f"synthetic corpus has [B, S] token streams only")
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, q_chunk=min(cfg.q_chunk, args.seq),
                              k_chunk=min(cfg.k_chunk, args.seq),
                              mamba_chunk=min(cfg.mamba_chunk, args.seq))

    with process_group() as world:
        try:
            mesh = (make_production_mesh() if args.production_mesh
                    else make_host_mesh() if world > 1 else None)
        except ValueError as e:
            raise SystemExit(f"launch.train: {e}") from None
        _train(args, cfg, mesh)


def _train(args, cfg, mesh) -> None:
    if mesh is not None and args.device.startswith("cuda") and \
            torch.cuda.is_available():
        # a rank per card, round robin (ranks share a one-card machine's)
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    device = resolve_device(args.device)
    step_cfg = step_lib.StepConfig(policy=args.policy)
    opt_cfg = optim_lib.OptConfig(lr=args.lr, warmup_steps=20,
                                  decay_steps=max(args.steps, 100))

    params = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        step_cfg.param_dtype)
    if mesh is None:
        opt_state = optim_lib.init_opt_state(params.param_tree(),
                                             step_cfg.opt_config(opt_cfg))
    else:
        extents = rules_lib.mesh_extents(mesh)
        rules = rules_lib.default_rules(
            attn_dp=cfg.n_heads % extents.get("model", 1) != 0)
        params, opt_state = step_lib.place_state(
            params, None, mesh, rules, step_cfg.opt_config(opt_cfg))
    step_fn = step_lib.make_train_step(cfg, opt_cfg, step_cfg)

    data_cfg = DataConfig(cfg.vocab_size, args.seq, args.batch,
                          seed=args.seed)
    stream = SyntheticTokenStream(data_cfg)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir)
    params, opt_state, telemetry = train(step_fn, params, opt_state, stream,
                                         loop_cfg, resume=args.resume)

    losses = [r["loss"] for r in telemetry.records]
    if mesh is not None:
        print(f"[train] mesh {rules_lib.mesh_extents(mesh)}, rank "
              f"{params.comm.rank} of {params.comm.world}: "
              f"{params.placed_bytes()} bytes of parameters placed",
              flush=True)
    if not losses:
        print(f"[train] done: the checkpoint in {args.ckpt_dir} is already "
              f"at step {args.steps}", flush=True)
        return
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}",
          flush=True)


if __name__ == "__main__":
    main()
