"""Production-mesh dry run: every (architecture × shape) cell placed on the
single-pod 16×16 mesh and the two-pod 2×16×16 mesh on the "meta" device —
no allocation, no compile, no device. Each cell states what one rank holds
by the sharding rules (parameters, optimizer state for a train shape,
caches for a serving shape) against one 80 GB card, beside the step's
model FLOPs, the reference's analytic memory-traffic model (its TPU fusion
assumptions) and the parameter counts, and writes a JSON under
build/dryrun/<mesh>/<arch>__<shape>.json.

The bytes are the placements at rest, what the rules give a rank to
store. They are the port's training footprint's stored part (the mesh
step gathers one layer at a time). For a serving shape they are not the
port's serving footprint: its serving step gathers the whole model onto
every rank (sharding/lm.py `serve_step`), so `fits_one_80gb_card` says
only whether the placements fit.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
        --shape train_4k --mesh pod,multipod

Exits 1, listing them, if any cell fails.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

from repro_torch.configs import all_archs, get_config, shapes_for
from repro_torch.launch import roofline as roof_lib
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.train import step as step_lib

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
CARD_BYTES = 80e9     # one H100's device memory


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             policy: str | None = None, artifacts: bool = True) -> dict:
    multi_pod = mesh_kind == "multipod"
    t0 = time.perf_counter()
    mesh = production_mesh_shape(multi_pod)
    cell = build_cell(arch, shape_name, mesh, multi_pod, policy=policy)
    cfg, shape = cell.cfg, cell.shape
    ranks = 1
    for extent in mesh.values():
        ranks *= extent
    params = step_lib.tree_bytes(cell.in_shardings[0], cell.args_sds[0])
    held = {"params": params}
    if shape.kind == "train":
        held["opt_state"] = step_lib.tree_bytes(cell.in_shardings[1],
                                                cell.args_sds[1])
    else:
        held["caches"] = step_lib.tree_bytes(cell.in_shardings[2],
                                             cell.args_sds[2])
    per_rank = sum(held.values())
    model_extent = mesh.get("model", 1)
    art = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": mesh, "ranks": ranks, "policy": cell.policy,
        "attn_dp": cfg.n_heads % model_extent != 0,
        "per_rank_bytes": {**held, "total": per_rank},
        "per_rank_bytes_are": (
            "the placements at rest" if shape.kind == "train" else
            "the placements at rest only: the port's serving step gathers "
            "the whole model onto every rank"),
        "fits_one_80gb_card": per_rank <= CARD_BYTES,
        "model_flops": roof_lib.model_flops_for(
            cfg, shape.kind, shape.seq_len, shape.global_batch),
        "reference_tpu_fusion_model_hbm_bytes_per_device":
            roof_lib.analytic_memory_bytes(
                cfg, shape.kind, shape.seq_len, shape.global_batch,
                cell.policy, dict(mesh),
                attn_dp=cfg.n_heads % model_extent != 0),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "seconds": time.perf_counter() - t0,
    }
    print(f"[{arch} × {shape_name} @ {mesh_kind}] {cell.policy}: per rank "
          + ("placed " if shape.kind == "train" else "placed (at rest) ")
          + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in held.items())
          + f" (of one 80 GB card: {per_rank / CARD_BYTES:.1%}); "
          f"model flops {art['model_flops']:.3e}", flush=True)
    if artifacts:
        out = ART_DIR / mesh_kind / f"{arch}__{shape_name}.json"
        os.makedirs(out.parent, exist_ok=True)
        with open(out, "w") as f:
            json.dump(art, f, indent=1)
    return art


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod,multipod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--policy", default=None)
    args = ap.parse_args(argv)

    meshes = args.mesh.split(",")
    if args.all:
        cells = [(a, s) for a in all_archs() for s in shapes_for(get_config(a))]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --all, or --arch and --shape")

    failures = []
    for mesh_kind in meshes:
        for arch, shape in cells:
            try:
                run_cell(arch, shape, mesh_kind, policy=args.policy)
            except Exception as e:  # noqa: BLE001 — report all failures at end
                traceback.print_exc()
                failures.append((mesh_kind, arch, shape, repr(e)[:200]))
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nAll {len(cells) * len(meshes)} dry-run cells placed OK.")


if __name__ == "__main__":
    main()
