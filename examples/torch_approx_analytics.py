"""Exploratory analytics session on the PyTorch/CUDA port: progressive
bound tightening (§2's "progressively tweak the query bounds"),
disjunctions, quantiles, and the error-latency tradeoff table. Runs on the
card; `--device cpu` runs it on the CPU.

    PYTHONPATH=src python examples/torch_approx_analytics.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (AggOp, Atom, BlinkDB, CmpOp, Conjunction,
                              EngineConfig, ErrorBound, Predicate, Query,
                              QueryTemplate)
from repro_torch.core import table as table_lib
from repro_torch.data import synth


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=400_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    tbl = table_lib.from_columns("sessions", synth.sessions_table(args.rows))
    db = BlinkDB(EngineConfig(k1=2000.0, m=5), device=args.device)
    db.register_table("sessions", tbl)
    db.build_samples("sessions", [
        QueryTemplate(frozenset({"City"}), 0.5),
        QueryTemplate(frozenset({"OS"}), 0.5),
    ], storage_budget_fraction=0.5)

    # -- progressive tightening: same query, shrinking error bounds ---------
    print("error bound -> rows scanned / latency (the paper's ELP tradeoff)")
    for eps in (0.32, 0.16, 0.08, 0.04, 0.02):
        q = Query("sessions", AggOp.AVG, "SessionTime", group_by=("OS",),
                  bound=ErrorBound(eps, 0.95))
        ans = db.query(q)
        print(f"  eps={eps:5.2f}: {ans.rows_read:8,} rows, "
              f"{ans.elapsed_s*1e3:6.1f}ms, K={ans.sample_k:g}")

    # -- disjunctive WHERE (§4.1.2 rewrite) ----------------------------------
    pred = Predicate((
        Conjunction((Atom("OS", CmpOp.EQ, "os0"),)),
        Conjunction((Atom("OS", CmpOp.EQ, "os5"),)),
    ))
    q = Query("sessions", AggOp.COUNT, predicate=pred,
              bound=ErrorBound(0.05, 0.95))
    ans = db.query(q)
    print(f"\nCOUNT(os0 OR os5) = {ans.groups[0].estimate:,.0f} "
          f"± {1.96*ans.groups[0].stderr:,.0f}")

    # -- quantiles (Table 2's 4th operator) ----------------------------------
    q = Query("sessions", AggOp.QUANTILE, "SessionTime", quantile=0.95,
              bound=ErrorBound(0.10, 0.95))
    ans = db.query(q)
    exact = db.exact_query(q)
    print(f"p95(SessionTime) ~= {ans.groups[0].estimate:.1f} "
          f"(exact {exact.groups[0].estimate:.1f})")

    # -- missing-subgroup demo (§3.1): rare city present under stratification
    codes = tbl.host_column("City")
    counts = np.bincount(codes, minlength=tbl.cardinality("City"))
    present = np.nonzero(counts > 0)[0]
    rarest = int(present[np.argmin(counts[present])])
    rare = tbl.decode_value("City", rarest)
    q = Query("sessions", AggOp.COUNT,
              predicate=Predicate.where(Atom("City", CmpOp.EQ, rare)),
              bound=ErrorBound(0.1, 0.95))
    ans = db.query(q)
    print(f"\nrare city {rare!r}: true freq {counts[rarest]}, "
          f"estimate {ans.groups[0].estimate:.0f} "
          f"(exact={'yes' if ans.groups[0].exact else 'no'}; a uniform sample "
          f"would likely miss it entirely)")


if __name__ == "__main__":
    main()
