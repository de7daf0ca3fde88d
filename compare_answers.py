#!/usr/bin/env python3
"""This tree's answers against another checkout's, on one card.

    python3 compare_answers.py --baseline DIR [--rows N]

Each tree runs in a process of its own, with its own `src/repro_torch`
and its own kernel builds: chip_smoke.py's sessions engine (20M base rows
by default, families City, URL and uniform), its phase 3 queries through
BlinkDB.query and its phase 3b batch through BlinkDB.query_batch on a
fresh engine over the same blocks. Every answer's family, K, rows,
contract fields and groups (keys, estimates, stderr, CI bounds, selected
rows) must be equal bit for bit, except those of WITHIN SECONDS queries,
whose K follows a latency model fitted on timed probes: for them the
script prints whether the K and the bits agreed. DIR is typically `git
archive` of a parent commit unpacked under build/. Exits 1 on a
difference, 2 without a card. Each tree's output also holds its host
times (clock around the calls, device synchronised): the phase 3 pass,
the batch, and the batch's queries through query() on the same engine;
`--tree DIR --out FILE` writes one tree's, so runs of two trees can be
taken in turns.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def dump(tree: Path, rows: int, out: Path, device: str = "cuda") -> None:
    """Run `tree`'s engine on its own sessions table and write each
    answer's bits, as reprs, to `out`."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs
    from repro_torch.core import (AggOp, Atom, BlinkDB, CmpOp, Conjunction,
                                  EngineConfig, ErrorBound, Predicate,
                                  Query, TimeBound)
    db, *_ = cs.sessions_engine(BlinkDB, rows, device)
    ms = {}

    def timed(name, fn):
        db._sync()
        t0 = time.perf_counter()
        result = fn()
        db._sync()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        return result
    main = cs.main_path_queries(Query, AggOp, Atom, CmpOp, Conjunction,
                                Predicate, ErrorBound, TimeBound)
    single = timed("query_16", lambda: [
        (label, isinstance(q.bound, TimeBound),
         repr(cs.answer_bits(db.query(q)))) for label, q in main])
    fresh = BlinkDB(EngineConfig(), device=db.device)
    fresh.register_table("sessions", db.tables["sessions"])
    fresh.families["sessions"] = dict(db.families["sessions"])
    fresh._generations.update(db._generations)
    fresh._striped.update(db._striped)
    queries = cs.batch_queries(Query, AggOp, Atom, CmpOp, Predicate,
                               ErrorBound)
    answers = timed("query_batch_36", lambda: fresh.query_batch(queries))
    batch = [(f"batch {i}", False, repr(cs.answer_bits(a)))
             for i, a in enumerate(answers)]
    timed("query_36_same_engine", lambda: [fresh.query(q) for q in queries])
    out.write_text(json.dumps({"answers": single + batch, "ms": ms}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--rows", type=int, default=20_000_000)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:
        dump(args.tree.resolve(), args.rows, args.out)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_answers: needs a CUDA device", file=sys.stderr)
        return 2
    got = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name, tree in (("baseline", args.baseline), ("this", ROOT)):
            out = Path(tmp) / f"{name}.json"
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--tree", str(tree), "--rows", str(args.rows),
                            "--out", str(out)], check=True)
            got[name] = json.loads(out.read_text())
    for name, dumped in got.items():
        print(f"  {name} host ms: " + " ".join(
            f"{k}={v:.3f}" for k, v in dumped["ms"].items()))
        got[name] = dumped["answers"]
    same = timed_same = differ = 0
    for (label, timed, a), (_, _, b) in zip(got["baseline"], got["this"]):
        if timed:
            timed_same += a == b
            print(f"  {label} (WITHIN SECONDS): "
                  f"{'bit-identical' if a == b else 'differs (K refitted)'}")
        elif a == b:
            same += 1
        else:
            differ += 1
            print(f"  {label}: DIFFERS\n    baseline {a[:300]}\n"
                  f"    this     {b[:300]}")
    n_timed = sum(t for _, t, _ in got["this"])
    print(f"compare_answers: {same}/{len(got['this']) - n_timed} answers "
          f"bit-identical to the baseline; WITHIN SECONDS {timed_same}/"
          f"{n_timed}; {torch.cuda.get_device_name(0)}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
