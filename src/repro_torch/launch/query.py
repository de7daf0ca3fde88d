"""BlinkDB query driver of the port (counterpart of `repro.launch.query`):
build samples over a synthetic warehouse and run a batch of bounded
queries. It runs on the card; `--device cpu` runs it on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.query --rows 400000 \\
        --budget 0.5 --eps 0.05
"""
from __future__ import annotations

import argparse

from repro_torch.core import (AggOp, Atom, BlinkDB, CmpOp, EngineConfig,
                              ErrorBound, Predicate, Query, QueryTemplate,
                              TimeBound)
from repro_torch.core import table as table_lib
from repro_torch.data import synth
from repro_torch.obs.clock import now_s

TEMPLATES = (
    QueryTemplate(frozenset({"City"}), 0.3),
    QueryTemplate(frozenset({"Genre", "City"}), 0.25),
    QueryTemplate(frozenset({"OS", "URL"}), 0.25),
    QueryTemplate(frozenset({"Genre"}), 0.2),
)


def queries(bound) -> list[tuple[str, Query]]:
    """The driver's four queries under one bound."""
    return [
        ("count genre", Query("sessions", AggOp.COUNT,
                              predicate=Predicate.where(
                                  Atom("Genre", CmpOp.EQ, "genre03")),
                              bound=bound)),
        ("avg by os", Query("sessions", AggOp.AVG, "SessionTime",
                            group_by=("OS",), bound=bound)),
        ("sum by city", Query("sessions", AggOp.SUM, "SessionTime",
                              predicate=Predicate.where(
                                  Atom("dt", CmpOp.LT, 10.0)),
                              group_by=("City",), bound=bound)),
        ("p50 latency", Query("sessions", AggOp.QUANTILE, "SessionTime",
                              quantile=0.5, bound=bound)),
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=400_000)
    ap.add_argument("--budget", type=float, default=0.5)
    ap.add_argument("--k1", type=float, default=2000.0)
    ap.add_argument("--eps", type=float, default=0.05)
    ap.add_argument("--time-bound-ms", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where tables, samples and scans live (default: "
                         "the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    t0 = now_s()
    tbl = table_lib.from_columns("sessions", synth.sessions_table(args.rows))
    db = BlinkDB(EngineConfig(k1=args.k1, m=5), device=args.device)
    db.register_table("sessions", tbl)
    sol = db.build_samples("sessions", TEMPLATES,
                           storage_budget_fraction=args.budget)
    print(f"[offline {now_s()-t0:.1f}s] families: "
          f"{[tuple(sorted(c.phi)) for c in sol.chosen]} "
          f"({sol.storage_used/tbl.nbytes:.1%} of table)")

    bound = (TimeBound(args.time_bound_ms / 1e3) if args.time_bound_ms
             else ErrorBound(args.eps, 0.95))
    for name, q in queries(bound):
        ans = db.query(q)
        top = max(ans.groups, key=lambda g: g.estimate) if ans.groups else None
        print(f"  {name:14s} rows={ans.rows_read:>8,}/{ans.rows_total:,} "
              f"t={ans.elapsed_s*1e3:6.1f}ms groups={len(ans.groups):>3} "
              + (f"top={top.estimate:,.1f}±{1.96*top.stderr:,.1f}" if top else ""))


if __name__ == "__main__":
    main()
