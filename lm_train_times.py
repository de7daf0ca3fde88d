#!/usr/bin/env python3
"""Times the LM training step on one card: chip_smoke.py phase 3j (a)'s
run (`chip_smoke.lm_train_run`: qwen2-1.5b at full width and depth, the
f32 policy, remat, bfloat16 compute, B = 8, T = 128, six steps of
make_train_step), with another checkout's `repro_torch` in turns.

    python3 lm_train_times.py                   # this checkout, twice
    python3 lm_train_times.py --baseline DIR    # and DIR's, in turns

DIR is another checkout of this repository (for example a `git archive`
of an earlier commit unpacked under build/). Each run is a process of its
own that imports its checkout's `repro_torch` and this checkout's
measurement, in the order baseline, this, this, baseline, so that two
versions are compared on one card. Each prints one JSON line: the
measurement of `lm_train_run` and the checkout it ran. Without a CUDA
device it exits 2.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STEPS = 6


def one_run(tree: Path) -> dict:
    """The measurement, with `tree`'s repro_torch."""
    import torch
    import chip_smoke   # puts this checkout's src first: put tree's before
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.train.step import StepConfig
    out, _ = chip_smoke.lm_train_run(torch, StepConfig(), STEPS)
    return {"tree": str(tree), **out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another checkout, run in turns with this one")
    ap.add_argument("--one", type=Path, default=None,
                    help=argparse.SUPPRESS)   # a child process: one run
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(one_run(args.one)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("lm_train_times: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    trees = ([args.baseline, ROOT, ROOT, args.baseline]
             if args.baseline is not None else [ROOT, ROOT])
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--one",
                               str(tree.resolve())], timeout=900)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
