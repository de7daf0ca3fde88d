#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py              # the full run: 20M-row sessions table
    python3 chip_smoke.py --rows 200000

Phases, each reported on its own lines:
  1. card and build: torch version, the card's name and power limit, the
     nvcc build of the fused-scan kernel (seconds, ptxas resources);
  2. kernel vs plain: agg_scan_fused on the card against its plain PyTorch
     version over a sweep of queries, groups, strata, dtypes and templates
     (rtol 2e-5, atol 1e-3), bit-identical repeat launches, and the
     wrapper's refusal of a 128-atom template;
  3. main path: the Conviva-like sessions workload (paper §6.1) through
     BlinkDB.query — COUNT/SUM/AVG, grouped and not, predicates, a
     disjunction, ERROR WITHIN and WITHIN SECONDS — every scan's moments
     held against the plain version on the same tensors, every answer
     against exact_query, the kernel's launch count read around the run;
  4. times: the kernel at the main path's shapes (Q=1, each family's whole
     block) against its memory bound and the plain version.
The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero and prints no result. Without a CUDA device it exits 2.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

RTOL, ATOL = 2e-5, 1e-3      # the reference's kernel tolerance
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def tol_ratio(torch, got, want) -> float:
    """max |got - want| / (atol + rtol·|want|): at most 1 where allclose."""
    return ((got - want).abs() / (ATOL + RTOL * want.abs())).max().item()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- phase 2

def sweep_cases(torch, np, device):
    """Kernel inputs over the sweep: (label, args, ops_struct, atom_slots,
    n_groups). Pad rows (unit=+inf), ghost rows (valid=False) and a row
    count that is no multiple of any block are in every case."""
    from repro_torch.core.types import CmpOp
    rng = np.random.default_rng(7)

    def case(n, g, q, n_cols, n_atoms, strata, sdt, cdt, adt, ghost=0.1,
             values=True, codes=True):
        u = rng.random(n).astype(np.float32)
        u[-max(1, n // 50):] = np.inf
        t = {
            "v": rng.normal(5, 2, n).astype(np.float32),
            "u": u,
            "s": rng.integers(0, strata, n).astype(sdt),
            "ft": rng.integers(1, 500, strata).astype(np.float32),
            "va": rng.random(n) >= ghost,
            "c": rng.integers(0, g, n).astype(cdt),
            "ks": rng.uniform(20, 400, q).astype(np.float32),
            "consts": rng.integers(0, 8, (q, n_atoms)).astype(np.float32),
        }
        t = {k: torch.from_numpy(a).to(device) for k, a in t.items()}
        cols = tuple(torch.from_numpy(rng.integers(0, 8, n).astype(adt)
                                      ).to(device) for _ in range(n_cols))
        return (t["v"] if values else None, t["u"], t["s"], t["ft"], t["va"],
                cols, t["c"] if codes else None, t["ks"], t["consts"])

    eq, gt, le, ge, ne = CmpOp.EQ, CmpOp.GT, CmpOp.LE, CmpOp.GE, CmpOp.NE
    n = 100_003
    out = []
    for q in (1, 7, 64):
        for g in (1, 6, 500):
            cdt = np.int16 if g > 127 else np.int8
            out.append((f"Q={q} G={g} dnf2(dup col)",
                        case(n, g, q, 1, 2, 37, np.int8, cdt, np.int8),
                        ((eq,), (gt,)), (0, 0), g))
    for strata, sdt in ((1, np.int8), (300, np.int16), (4096, np.int32)):
        out.append((f"strata={strata} {np.dtype(sdt).name}",
                    case(n, 6, 3, 2, 2, strata, sdt, np.int32, np.int16),
                    ((le, ne),), (0, 1), 6))
    for adt in (np.int8, np.int16, np.int32, np.float32):
        out.append((f"atoms {np.dtype(adt).name}",
                    case(n, 12, 4, 1, 2, 37, np.int16, np.int16, adt),
                    ((ge, CmpOp.LT),), (0, 0), 12))
    out.append(("0 atoms, COUNT, ungrouped",
                case(n, 1, 2, 0, 0, 37, np.int8, np.int8, np.int8,
                     values=False, codes=False), (), (), 1))
    out.append(("1 atom", case(n, 6, 1, 1, 1, 37, np.int8, np.int8, np.int8),
                ((gt,),), (0,), 6))
    out.append(("127 atoms", case(20_011, 2, 1, 1, 127, 37, np.int8, np.int8,
                                  np.int8), ((ge,) * 127,), (0,) * 127, 2))
    out.append(("all ghosts", case(n, 4, 2, 1, 1, 37, np.int8, np.int8,
                                   np.int8, ghost=1.1), ((gt,),), (0,), 4))
    return out


def phase_kernel_vs_plain(torch, np, device) -> tuple[float, float]:
    from repro_torch.core.types import CmpOp
    from repro_torch.kernels import agg_scan, ref
    worst = (0.0, 0.0)     # (max |diff|, max tolerance ratio)
    for label, args, struct, slots, g in sweep_cases(torch, np, device):
        got = agg_scan.agg_scan_fused_cuda(*args, struct, slots, g)
        again = agg_scan.agg_scan_fused_cuda(*args, struct, slots, g)
        torch.cuda.synchronize()
        # The plain version sums its float32 per-row terms in float64: an
        # order-free yardstick for the kernel's float32 sums.
        want = ref.agg_scan_fused_ref(*args, struct, slots, g,
                                      accumulate=torch.float64)
        diff = (got - want).abs().max().item()
        ratio = tol_ratio(torch, got, want)
        worst = (max(worst[0], diff), max(worst[1], ratio))
        ok = torch.allclose(got, want, rtol=RTOL, atol=ATOL)
        same = torch.equal(got, again)
        log(f"  {label:28s} shape={tuple(got.shape)} max_abs_diff={diff:.3e} "
            f"tol_ratio={ratio:.3f} allclose={ok} bit_identical_repeat={same}")
        if not (ok and same and torch.isfinite(got).all()):
            raise AssertionError(f"kernel vs plain failed: {label}")
        if len(slots) == agg_scan.MAX_ATOMS:
            widest = (args, g)
    # The 127-atom case with one atom more: the wrapper must refuse it.
    args, g = widest
    consts = args[-1].new_zeros((args[-1].shape[0], 128))
    before = agg_scan.agg_scan_fused_cuda.launches
    try:
        agg_scan.agg_scan_fused_cuda(*args[:-1], consts, ((CmpOp.GE,) * 128,),
                                     (0,) * 128, g)
    except ValueError as e:
        log(f"  128 atoms refused: {e}")
    else:
        raise AssertionError("the kernel wrapper took a 128-atom template")
    if agg_scan.agg_scan_fused_cuda.launches != before:
        raise AssertionError("a refused call counted a launch")
    log(f"phase 2 ok: max_abs_diff={worst[0]:.6e} max tol_ratio="
        f"{worst[1]:.4f} (rtol={RTOL}, atol={ATOL})")
    return worst


# ----------------------------------------------------------------- phase 3

def checked_engine(torch, record):
    """A BlinkDB whose every scan is also run through the plain version on
    the same striped tensors and compared (outside the timed region)."""
    from repro_torch.core import BlinkDB
    from repro_torch.core import executor as exec_lib
    from repro_torch.kernels import agg_scan, ref

    class CheckedDB(BlinkDB):
        check = True     # False: record scans only (the latency pass)

        def _run_at_k(self, table_name, q, phi, k):
            before = agg_scan.agg_scan_fused_cuda.launches
            mom, rows, dt = super()._run_at_k(table_name, q, phi, k)
            launched = agg_scan.agg_scan_fused_cuda.launches - before
            if self.check and self.device.type == "cuda":
                striped = self._striped_for(table_name, phi)
                bound = exec_lib.bind_predicate(q.predicate,
                                                self._encode(table_name))
                struct, vals = exec_lib.pred_structure(bound)
                names, slots = exec_lib.dedup_atom_slots(
                    exec_lib.flat_atoms(struct))
                cols = striped.columns
                g = q.group_by[0] if q.group_by else None
                n_groups = self._column_card(table_name, g) if g else 1
                want = ref.agg_scan_fused_ref(
                    cols[q.value_column] if q.value_column else None,
                    striped.unit, striped.strat, striped.freq_table,
                    striped.valid, tuple(cols[c] for c in names),
                    cols[g] if g else None,
                    torch.tensor([k], dtype=torch.float32, device=self.device),
                    torch.tensor([exec_lib.flatten_pred_vals(vals)],
                                 dtype=torch.float32,
                                 device=self.device).reshape(1, len(slots)),
                    tuple(tuple(op for _, op in c) for c in struct), slots,
                    n_groups, accumulate=torch.float64)[0]
                got = mom.stacked()
                diff = (got - want).abs().max().item()
                if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                    raise AssertionError(
                        f"scan moments disagree with the plain version: "
                        f"{phi} k={k} max_abs_diff={diff}")
                record["max_abs_diff"] = max(record["max_abs_diff"], diff)
                record["tol_ratio"] = max(record["tol_ratio"],
                                          tol_ratio(torch, got, want))
            record["scans"].append((phi, k, rows, dt, launched))
            return mom, rows, dt
    return CheckedDB


def main_path_queries(Q, AggOp, Atom, CmpOp, Conjunction, Predicate,
                      ErrorBound, TimeBound):
    t = "sessions"
    genre = Predicate.where(Atom("Genre", CmpOp.EQ, "genre03"))
    return [
        ("COUNT(*) ERROR 10%", Q(t, AggOp.COUNT, bound=ErrorBound(0.10))),
        ("SUM(SessionTime) GROUP BY OS ERROR 5%",
         Q(t, AggOp.SUM, "SessionTime", group_by=("OS",),
           bound=ErrorBound(0.05))),
        ("AVG(SessionTime) GROUP BY City ERROR 10%",
         Q(t, AggOp.AVG, "SessionTime", group_by=("City",),
           bound=ErrorBound(0.10))),
        ("COUNT WHERE Genre=genre03 GROUP BY OS ERROR 10%",
         Q(t, AggOp.COUNT, predicate=genre, group_by=("OS",),
           bound=ErrorBound(0.10))),
        ("SUM(Bitrate) WHERE dt<15 ERROR 5%",
         Q(t, AggOp.SUM, "Bitrate",
           predicate=Predicate.where(Atom("dt", CmpOp.LT, 15)),
           bound=ErrorBound(0.05))),
        ("AVG(SessionTime) WHERE City=city007 ERROR 5%",
         Q(t, AggOp.AVG, "SessionTime",
           predicate=Predicate.where(Atom("City", CmpOp.EQ, "city007")),
           bound=ErrorBound(0.05))),
        ("COUNT WHERE URL=url001 OR URL=url002 ERROR 10%",
         Q(t, AggOp.COUNT, predicate=Predicate((
             Conjunction((Atom("URL", CmpOp.EQ, "url001"),)),
             Conjunction((Atom("URL", CmpOp.EQ, "url002"),)))),
           bound=ErrorBound(0.10))),
        ("AVG(Bitrate) GROUP BY URL WITHIN 0.05 SECONDS",
         Q(t, AggOp.AVG, "Bitrate", group_by=("URL",),
           bound=TimeBound(0.05))),
    ]


def phase_main_path(torch, np, n_rows: int, record, device="cuda") -> dict:
    from repro_torch.core import (AggOp, Atom, CmpOp, Conjunction,
                                  EngineConfig, ErrorBound, Predicate, Query,
                                  TimeBound)
    from repro_torch.core import table as table_lib
    from repro_torch.data import synth
    from repro_torch.kernels import agg_scan

    t0 = time.perf_counter()
    raw = synth.sessions_table(n_rows, seed=0)
    t1 = time.perf_counter()
    tbl = table_lib.from_columns("sessions", raw)
    del raw
    t2 = time.perf_counter()
    db = checked_engine(torch, record)(EngineConfig(), device=device)
    db.register_table("sessions", tbl)
    for phi in (("City",), ("URL",), ()):
        db.add_family("sessions", phi)
    t3 = time.perf_counter()
    blocks = {phi: db._striped_for("sessions", phi) for phi in db.families["sessions"]}
    db._sync()
    t4 = time.perf_counter()
    base_bytes = sum(c.numel() * c.element_size() for c in tbl.columns.values())
    block_bytes = {phi: b.device_bytes() for phi, b in blocks.items()}
    log(f"  data: {n_rows} base rows; synth {t1 - t0:.1f}s, encode "
        f"{t2 - t1:.1f}s, families {t3 - t2:.1f}s, stripe+upload {t4 - t3:.1f}s")
    for phi, fam in db.families["sessions"].items():
        log(f"  family {phi!s:10s} rows={fam.n_rows} slots={blocks[phi].n_local} "
            f"K1={fam.ks[0]:.0f} resolutions={len(fam.ks)} "
            f"device_bytes={block_bytes[phi]}")
    log(f"  device bytes resident: base table {base_bytes}, sample blocks "
        f"{sum(block_bytes.values())}")

    queries = main_path_queries(Query, AggOp, Atom, CmpOp, Conjunction,
                                Predicate, ErrorBound, TimeBound)
    agg_scan.agg_scan_fused_cuda.launches = 0
    results, covered, total = [], 0, 0
    for label, q in queries:
        n_scans = len(record["scans"])
        before = agg_scan.agg_scan_fused_cuda.launches
        ans = db.query(q)
        launched = agg_scan.agg_scan_fused_cuda.launches - before
        scans = record["scans"][n_scans:]
        exact = {g.key: g.estimate for g in db.exact_query(q).groups}
        if not ans.groups or not np.isfinite(
                [[g.estimate, g.ci_low, g.ci_high] for g in ans.groups]).all():
            raise AssertionError(f"{label}: empty or non-finite answer")
        rel, in_ci = [], 0
        for g in ans.groups:
            truth = exact[g.key]
            rel.append(abs(g.estimate - truth) / max(abs(truth), 1e-12))
            half = max(g.ci_high - g.estimate, g.estimate - g.ci_low)
            in_ci += abs(g.estimate - truth) <= 2.0 * half + 1e-4 * abs(truth)
        covered += in_ci
        total += len(ans.groups)
        ci_rel = max(((g.ci_high - g.ci_low) / 2.0 / max(abs(g.estimate), 1e-12))
                     for g in ans.groups)
        main_ms = 1e3 * ans.elapsed_s
        log(f"  {label}: family={ans.sample_phi} K={ans.sample_k:.6g} "
            f"rows_read={ans.rows_read} scan_ms={main_ms:.3f} "
            f"bound_met={ans.bound_met} certified={ans.certified} "
            f"scans={len(scans)} launches={launched} groups={len(ans.groups)} "
            f"max_realized_rel_err={max(rel):.3e} max_ci_rel_half={ci_rel:.3e} "
            f"groups_within_2ci={in_ci}/{len(ans.groups)}")
        results.append((label, q, ans))
    launches = agg_scan.agg_scan_fused_cuda.launches
    if device == "cuda" and launches == 0:
        raise AssertionError("the main path launched the kernel no time")
    if covered < 0.9 * total:
        raise AssertionError(f"only {covered}/{total} groups within 2 CI "
                             f"half-widths of exact_query")
    log("  latency (host clock, device synchronised; cold = ELP decision and "
        "latency model cleared, warm = replayed decision; blocks resident):")
    db.check = False
    for label, q in queries:
        for run in ("cold", "warm"):
            if run == "cold":
                db._elp_cache.clear()
                db._latency.clear()
            n_scans = len(record["scans"])
            db._sync()
            t0 = time.perf_counter()
            db.query(q)
            db._sync()
            wall = time.perf_counter() - t0
            scans = record["scans"][n_scans:]
            scan_s = sum(s[3] for s in scans)
            log(f"    {label} [{run}]: query_ms={1e3 * wall:.3f} "
                f"scans={len(scans)} scan_ms_sum={1e3 * scan_s:.3f} "
                f"scan_share={scan_s / wall:.3f}")
    log(f"phase 3 ok: {len(queries)} queries, kernel launches={launches}, "
        f"{covered}/{total} groups within 2 CI half-widths of exact, scan "
        f"moments vs plain max_abs_diff={record['max_abs_diff']:.6e} "
        f"max tol_ratio={record['tol_ratio']:.4f}")
    return {"db": db, "launches": launches, "results": results}


# ----------------------------------------------------------------- phase 4

def time_cuda(torch, fn, warmup: int, reps: int) -> float:
    """Median ms of fn() over reps launches, each timed by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def scan_inputs(torch, db, q):
    from repro_torch.core import executor as exec_lib
    phi = db._select_phi("sessions", q)
    striped = db._striped_for("sessions", phi)
    bound = exec_lib.bind_predicate(q.predicate, db._encode("sessions"))
    struct, vals = exec_lib.pred_structure(bound)
    names, slots = exec_lib.dedup_atom_slots(exec_lib.flat_atoms(struct))
    g = q.group_by[0] if q.group_by else None
    cols = striped.columns
    k = striped.ks[0]
    args = (cols[q.value_column] if q.value_column else None,
            striped.unit, striped.strat, striped.freq_table, striped.valid,
            tuple(cols[c] for c in names), cols[g] if g else None,
            torch.tensor([k], dtype=torch.float32, device="cuda"),
            torch.tensor([exec_lib.flatten_pred_vals(vals)], dtype=torch.float32,
                         device="cuda").reshape(1, len(slots)))
    n_groups = db._column_card("sessions", g) if g else 1
    return phi, striped, args, tuple(tuple(op for _, op in c) for c in struct), \
        slots, n_groups


def bound_for(torch, args, ops_struct, n_groups, out) -> tuple[float, str]:
    """Least time for one call: bytes (each input read once, the output
    written once) over 3.35 TB/s against float32 operations over 67
    TFLOP/s, counting this run's selected rows."""
    (values, unit, strat, ftab, valid, acols, codes, ks, consts) = args
    n = unit.shape[0]
    streams = [t for t in (values, unit, strat, valid, codes, *acols)
               if t is not None]
    nbytes = sum(n * t.element_size() for t in streams) + \
        4 * (ftab.numel() + ks.numel() + consts.numel() + out.numel())
    n_atoms = sum(len(c) for c in ops_struct)
    selected = float(out[:, 0, :].sum())
    ops = n * (2 + n_atoms) + 20.0 * selected
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(torch, db, card: str) -> list[dict]:
    from repro_torch.core import AggOp, Atom, CmpOp, Predicate, Query
    from repro_torch.kernels import agg_scan, ref
    t = "sessions"
    shapes = [
        ("SUM(SessionTime) WHERE Genre=genre03 GROUP BY OS",
         Query(t, AggOp.SUM, "SessionTime",
               predicate=Predicate.where(Atom("Genre", CmpOp.EQ, "genre03")),
               group_by=("OS",))),
        ("AVG(SessionTime) GROUP BY City",
         Query(t, AggOp.AVG, "SessionTime", group_by=("City",))),
        ("AVG(Bitrate) GROUP BY URL",
         Query(t, AggOp.AVG, "Bitrate", group_by=("URL",))),
        ("COUNT(*) WHERE dt<15", Query(
            t, AggOp.COUNT,
            predicate=Predicate.where(Atom("dt", CmpOp.LT, 15)))),
    ]
    rows = []
    for label, q in shapes:
        phi, striped, args, struct, slots, g = scan_inputs(torch, db, q)
        before = agg_scan.agg_scan_fused_cuda.launches
        out = agg_scan.agg_scan_fused_cuda(*args, struct, slots, g)
        ms = time_cuda(torch, lambda: agg_scan.agg_scan_fused_cuda(
            *args, struct, slots, g), warmup=3, reps=20)
        plain_ms = time_cuda(torch, lambda: ref.agg_scan_fused_ref(
            *args, struct, slots, g), warmup=1, reps=5)
        agg_scan.agg_scan_fused_cuda.launches = before   # not main-path work
        bound_ms, bound_by = bound_for(torch, args, struct, g, out)
        log(f"  {label}: family={phi} slots={striped.n_local} Q=1 G={g} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) "
            f"bound_share={bound_ms / ms:.3f} library_ms=None (no single "
            f"PyTorch call computes this function) card={card}")
        rows.append({"label": label, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=20_000_000,
                    help="base rows of the sessions table (default 20M)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import agg_scan

    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    log(card)
    t0 = time.perf_counter()
    agg_scan.build()
    built = agg_scan._Library.build_seconds
    log(f"  built {agg_scan._Library.path.name} in "
        f"{(built if built is not None else time.perf_counter() - t0):.2f}s")
    for line in agg_scan._Library.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    log("phase 2: agg_scan_fused vs its plain version")
    worst = phase_kernel_vs_plain(torch, np, "cuda")

    log("phase 3: main path")
    record = {"max_abs_diff": 0.0, "tol_ratio": 0.0, "scans": []}
    main = phase_main_path(torch, np, args.rows, record)

    log(f"phase 4: times at the main path's shapes ({card})")
    times = phase_times(torch, main["db"], card)
    rep = times[0]
    kernels = [{
        "name": "agg_scan_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/agg_scan_fused.cu",
        "replaces": "src/repro/kernels/agg_scan.py:411",
        "launches": main["launches"],
        "max_abs_err": max(worst[0], record["max_abs_diff"]),
        "max_abs_diff": max(worst[0], record["max_abs_diff"]),
        "max_tol_ratio": max(worst[1], record["tol_ratio"]),
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": None, "shape": rep["label"], "card": card,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
