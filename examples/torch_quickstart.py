"""Quickstart on the PyTorch/CUDA port: the paper's §2 example on a
synthetic media-sessions table. Runs on the card; `--device cpu` runs it
on the CPU.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (AggOp, Atom, BlinkDB, CmpOp, EngineConfig,
                              ErrorBound, Predicate, Query, QueryTemplate,
                              TimeBound)
from repro_torch.core import table as table_lib
from repro_torch.data import synth


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=300_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. Ingest a fact table (columnar, dictionary-encoded).
    tbl = table_lib.from_columns("sessions", synth.sessions_table(args.rows))
    db = BlinkDB(EngineConfig(k1=2000.0, c=2.0, m=5), device=args.device)
    db.register_table("sessions", tbl)

    # 2. Offline sample creation from the workload's query templates (§3.2).
    templates = [
        QueryTemplate(frozenset({"City"}), 0.3),
        QueryTemplate(frozenset({"Genre", "City"}), 0.25),
        QueryTemplate(frozenset({"OS", "URL"}), 0.25),
        QueryTemplate(frozenset({"Genre"}), 0.2),
    ]
    sol = db.build_samples("sessions", templates, storage_budget_fraction=0.5)
    print("chosen families:", [tuple(sorted(c.phi)) for c in sol.chosen],
          f"(storage {sol.storage_used/tbl.nbytes:.1%} of table)")

    # 3. SELECT COUNT(*) WHERE Genre='genre03' GROUP BY OS
    #    ERROR WITHIN 10% AT CONFIDENCE 95%          (paper §2)
    q1 = Query("sessions", AggOp.COUNT,
               predicate=Predicate.where(Atom("Genre", CmpOp.EQ, "genre03")),
               group_by=("OS",), bound=ErrorBound(0.10, 0.95))
    ans = db.query(q1)
    print(f"\nQ1 COUNT by OS (err<=10%@95%):  scanned {ans.rows_read:,}/"
          f"{ans.rows_total:,} rows on SFam{ans.sample_phi} "
          f"in {ans.elapsed_s*1e3:.1f}ms")
    for g in sorted(ans.groups, key=lambda g: -g.estimate)[:4]:
        print(f"   {g.key[0]:>4}: {g.estimate:10.0f} ± {1.96*g.stderr:8.0f}"
              f"  (95% CI)")

    # 4. ...WITHIN 5 "SECONDS" — a time-bounded query (§2), here 5ms.
    q2 = Query("sessions", AggOp.AVG, value_column="SessionTime",
               group_by=("OS",), bound=TimeBound(0.005))
    ans2 = db.query(q2)
    print(f"\nQ2 AVG(SessionTime) WITHIN 5ms: took {ans2.elapsed_s*1e3:.1f}ms,"
          f" scanned {ans2.rows_read:,} rows")
    for g in ans2.groups[:3]:
        print(f"   {g.key[0]:>4}: {g.estimate:7.2f} ± {1.96*g.stderr:5.2f}")

    # 5. Ground truth comparison.
    exact = db.exact_query(q1)
    ex = {g.key: g.estimate for g in exact.groups}
    errs = [abs(g.estimate - ex[g.key]) / ex[g.key]
            for g in ans.groups if g.key in ex and ex[g.key]]
    print(f"\nQ1 true relative errors: median {np.median(errs):.3%}, "
          f"max {max(errs):.3%} (bound was 10%)")


if __name__ == "__main__":
    main()
