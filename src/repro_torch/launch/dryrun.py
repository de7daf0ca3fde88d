"""Production-mesh dry run: every (architecture × shape) cell placed on the
single-pod 16×16 mesh and the two-pod 2×16×16 mesh on the "meta" device —
no allocation, no compile, no device. Each cell states what one rank holds
by the sharding rules (parameters, optimizer state for a train shape,
caches for a serving shape) against one 80 GB card, beside the step's
model FLOPs, the reference's analytic memory-traffic model (its TPU fusion
assumptions) and the parameter counts, and writes a JSON under
build/dryrun/<mesh>/<arch>__<shape>.json.

The bytes are the placements at rest, what the rules give a rank to
store: the stored part of the port's footprint in training and serving
alike. Both steps hold the placements plus the one layer that runs (its
weights gathered where it runs; a serving step also that layer's cache
for the rank's rows, and a prefill the rank's rows of the logits;
sharding/lm.py `train_step`, `serve_step`), so `fits_one_80gb_card`
says whether the placements fit and `--costs`' traced peak whether the
step does.

With `--costs`, each cell also runs rank 0's step on "meta" under
launch/roofline.py's counter (the cell's `fn`, over a `DryComm`) and adds
the step's counted FLOPs (`global_flops`: the rank's × ranks), the rank's
op-boundary bytes, its collective bytes with their detail, its memory
(argument, output, temp and peak bytes of the traced step), the
`Roofline` with the H100's peaks, and `fits_one_80gb_card_traced` from
the traced peak. The step is counted at two pattern periods and at three
and extrapolated over the repeats (`roofline.over_repeats`, exact: each
kind of phase's peak apart);
xlstm-125m's train and prefill steps (a loop over time) also at three cut
sequences, extrapolated to the shape's.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--costs]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
        --shape train_4k --mesh pod,multipod --costs

Exits 1, listing them, if any cell fails.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

from repro_torch.configs import SHAPES, all_archs, get_config, shapes_for
from repro_torch.launch import roofline as roof_lib
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.train import step as step_lib

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
CARD_BYTES = 80e9     # one H100's device memory


# The xLSTM mixers run a fixed set of ops a position (a Python loop over
# time): a pattern of them alone is counted at SEQ_CUT, 2·SEQ_CUT and
# 3·SEQ_CUT positions. The forward is linear in the sequence, the backward
# quadratic: autograd sums each position's gradient into the whole
# sequence's.
SEQ_CUT = 16


def cut_seq(cfg, shape) -> bool:
    """Whether a cell's step is counted at cut sequences: a train or
    prefill shape over a pattern of mLSTM and sLSTM mixers alone (~250 µs
    an op on meta: xlstm-125m's loop over time would take ~20 minutes a
    cell at T = 4096)."""
    return (shape.kind != "decode" and shape.seq_len % SEQ_CUT == 0
            and {spec.mixer for spec in cfg.pattern} <= {"mlstm", "slstm"})


def step_costs(arch: str, shape_name: str, mesh_kind: str,
               policy: str | None = None) -> roof_lib.StepCost:
    """Rank 0's step at full depth: counted at two pattern periods and at
    three, extrapolated over the config's repeats (`roofline.
    over_repeats`); a `cut_seq` cell at three cut sequences too,
    extrapolated to the shape's (`roofline.extrapolate`). Both exact."""
    multi_pod = mesh_kind == "multipod"
    mesh = production_mesh_shape(multi_pod)
    cfg, shape = get_config(arch), SHAPES[shape_name]
    seqs = [k * SEQ_CUT for k in (1, 2, 3)] if cut_seq(cfg, shape) \
        else [None]

    def count(repeats, seq):
        cell = build_cell(arch, shape_name, mesh, multi_pod, policy=policy,
                          repeats=repeats, seq_len=seq)
        return roof_lib.step_flops(cell.step, *cell.place(*cell.args_sds),
                                   comm=cell.comm)
    if cfg.n_repeats <= 3:
        by_seq = [count(cfg.n_repeats, seq) for seq in seqs]
    else:
        by_seq = [roof_lib.over_repeats(count(2, seq), count(3, seq),
                                        cfg.n_repeats) for seq in seqs]
    if len(by_seq) == 1:
        return by_seq[0]
    return roof_lib.extrapolate(by_seq, shape.seq_len // SEQ_CUT)


def cost_fields(cell, mesh_kind: str, ranks: int, model_flops: float,
                cost: roof_lib.StepCost) -> dict:
    """--costs' fields of a cell's JSON."""
    roof = roof_lib.Roofline(
        cell.arch, cell.shape.name, mesh_kind, ranks,
        global_flops=cost.flops * ranks,
        hlo_flops_raw=cost.dot_flops * ranks,
        per_device_hbm_bytes=cost.bytes,
        collective_bytes=roof_lib.link_bytes(cost.collective_detail),
        model_flops=model_flops)
    return {"global_flops": cost.flops * ranks,
            "per_rank_flops": cost.flops,
            "per_rank_dot_flops": cost.dot_flops,
            "per_rank_op_bytes": cost.bytes,
            "per_rank_ops": cost.ops,
            "collective_bytes": cost.collective_bytes,
            "collective_detail": cost.collective_detail,
            "memory": cost.memory,
            "roofline": roof.to_dict(),
            "fits_one_80gb_card_traced":
                cost.memory["peak_bytes"] <= CARD_BYTES,
            "costs_counted": "rank 0 on meta at 2 and 3 pattern periods"
                             + (f" and {SEQ_CUT}, {2 * SEQ_CUT} and "
                                f"{3 * SEQ_CUT} positions"
                                if cut_seq(get_config(cell.arch), cell.shape)
                                else "") + ", extrapolated"}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             policy: str | None = None, artifacts: bool = True,
             costs: bool = False) -> dict:
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
            "the placements at rest; the step holds them plus the one "
            "layer that runs" + ("" if shape.kind == "train" else
                                 " and its cache for the rank's rows")),
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
    if costs:
        art.update(cost_fields(cell, mesh_kind, ranks, art["model_flops"],
                               step_costs(arch, shape_name, mesh_kind,
                                          policy)))
        art["seconds"] = time.perf_counter() - t0
    print(f"[{arch} × {shape_name} @ {mesh_kind}] {cell.policy}: per rank "
          + "placed "
          + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in held.items())
          + f" (of one 80 GB card: {per_rank / CARD_BYTES:.1%}); "
          f"model flops {art['model_flops']:.3e}", flush=True)
    if costs:
        r, mem = art["roofline"], art["memory"]
        print(f"  costs: flops {art['global_flops']:.4e} (rank "
              f"{art['per_rank_flops']:.4e}), op bytes "
              f"{art['per_rank_op_bytes'] / 1e9:.2f} GB, collectives "
              + ", ".join(f"{k} {v / 1e9:.3f} GB"
                          for k, v in art["collective_bytes"].items())
              + f"; traced peak {mem['peak_bytes'] / 1e9:.2f} GB a rank; "
              f"{r['bottleneck']}-bound: compute {r['t_compute_s']:.4g} s, "
              f"memory {r['t_memory_s']:.4g} s, collective "
              f"{r['t_collective_s']:.4g} s (H100 data-sheet peaks); "
              f"{art['seconds']:.1f}s", flush=True)
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
    ap.add_argument("--costs", action="store_true",
                    help="count each cell's step on meta: FLOPs, bytes, "
                         "collectives, traced memory, roofline")
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
                run_cell(arch, shape, mesh_kind, policy=args.policy,
                         costs=args.costs)
            except Exception as e:  # noqa: BLE001 — report all failures at end
                traceback.print_exc()
                failures.append((mesh_kind, arch, shape, repr(e)[:200]))
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nAll {len(cells) * len(meshes)} dry-run cells placed OK"
          + (", their steps counted." if args.costs else "."))


if __name__ == "__main__":
    main()
