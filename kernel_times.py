#!/usr/bin/env python3
"""Times the port's scan kernels on one card at the smoke workload's shapes
and splits each call into the device kernels it launches.

    python3 kernel_times.py                      # this checkout's kernels
    python3 kernel_times.py --baseline DIR       # and DIR's, in turns
    python3 kernel_times.py --json out.json --sass DIR

DIR is another checkout of this repository (for example a `git archive` of
an earlier commit unpacked under build/). Its kernel wrappers are loaded
from its own sources and its kernels are built into DIR/build/kernels; both
versions run on the same tensors in one process, in the order baseline,
this, this, baseline, so that two versions are compared on one card. The
workload is chip_smoke.py's at 20M rows (sessions table, families City,
URL and uniform); the shapes are its phase-4 shapes, a fused scan of a
100-atom NOT IN template at the URL family's smallest and largest K, and
agg_scan at the shapes the main path launches it (the 200-URL NOT IN at
the URL family's largest and smallest K, the 130-city AVG NOT IN on the
City family), and agg_scan_batched at phase 3c's inputs for Q = 1, 7, 32
and 64 queries at K1 and 32 queries at 32 distinct K (batched_shapes),
with each call's device time a query, and the fused and quantile kernels
over synthetic columns of the URL block's size whose frequency table has
4096 strata (the most shared memory holds: both versions) or 4097 and
12,000 (read through L2: this checkout only, as an earlier checkout
refuses such a table). For each (kernel, shape, version):
the median ms of 20 launches by CUDA events, the device time of each
kernel the call launches (torch.profiler, mean over the profiled calls),
their sum (device) and the host share of the call (the event median of
the turns less device: the wrapper's host work). Also prints ptxas's resource lines of every
build, and with --sass writes each library's SASS (cuobjdump) into the
given directory. Without a CUDA device it exits 2.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (the workload and its shapes)

log = smoke.log
ROWS = 20_000_000     # base rows of chip_smoke.py's workload
REPS = 20             # timed launches per turn
STRATA_ROWS = 10_195_008   # the URL block's slots at ROWS
STRATA = (4096, 4097, 12_000)
SHARED_TABLE = 4096   # strata an earlier checkout's kernels take


def load_version(root: Path, name: str):
    """(agg_scan module, weighted_sum module) of the checkout at root,
    loaded under private module names; their builds go to
    root/build/kernels."""
    kdir = root / "src" / "repro_torch" / "kernels"

    def load(stem):
        spec = importlib.util.spec_from_file_location(f"{name}_{stem}",
                                                      kdir / f"{stem}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod     # dataclasses look their module up
        spec.loader.exec_module(mod)
        return mod
    scans = load("agg_scan")
    ws = load("weighted_sum")
    ws.agg_scan = scans          # its wrapper builds from its own sources
    return scans, ws


def ptxas_lines(lib) -> list[str]:
    keep = ("entry function", "Used", "spill")
    return [ln.strip() for ln in lib.build_log.splitlines()
            if any(k in ln for k in keep)]


def profile_split(torch, fn, calls: int) -> dict:
    """Device ms per call of each kernel that fn() launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0:
            out[ev.key] = us / 1e3 / calls
    return out


def batched_shapes(ladder):
    """(Q, ks or None for every query at K1, label) of the agg_scan_batched
    calls: phase 3c's Q = 1 and 32 at K1, Q = 7 (no power of two), Q = 64
    (the largest launch) and Q = 32 with 32 distinct K spanning the URL
    family's ladder (its 16 rungs K1/2^i and the 16 geometric midpoints
    K1/2^(i + 1/2)), so that the prefix differs per query as in
    query_batch's final pass."""
    spread = [ladder[0] / 2.0 ** (i / 2.0) for i in range(32)]
    return [(1, None, "K1"), (7, None, "K1"), (32, None, "K1"),
            (32, spread, f"32 K from {spread[0]:g} to {spread[-1]:.4g}"),
            (64, None, "K1")]


@functools.lru_cache(maxsize=None)
def strata_case(n_strata: int):
    """Fused-scan inputs at STRATA_ROWS rows, G = 6, one int8 atom column
    and a table of n_strata strata (ids int16), shared by the versions."""
    import numpy as np
    import torch
    return smoke.make_case(torch, np, np.random.default_rng(n_strata),
                           "cuda", STRATA_ROWS, 6, 1, 1, 1, n_strata,
                           np.int16, np.int8, np.int8)


def cases(torch, db, v, this: bool = True):
    """(kernel, label, G, fn) of every timed call for the version v =
    (agg_scan module, weighted_sum module); fn is None for a call that an
    earlier checkout (this=False) does not take."""
    from repro_torch.core import AggOp, Atom, CmpOp, Predicate, Query
    from repro_torch.core.types import CmpOp as Op
    scans, ws = v
    fused_shapes, quantile_shapes = smoke.timed_queries()
    out = []
    for label, q in fused_shapes:
        _, _, args, struct, slots, g = smoke.scan_inputs(torch, db, q)
        out.append(("agg_scan_fused", label, g,
                    lambda a=args, s=struct, sl=slots, g=g:
                    scans.agg_scan_fused_cuda(*a, s, sl, g)))
    for label, q in quantile_shapes:
        _, _, _, qargs, struct, slots, g = smoke.quantile_inputs(torch, db,
                                                                 q)
        out.append(("quantile_scan", label, g,
                    lambda a=qargs, s=struct, sl=slots, g=g:
                    torch.cat([t.flatten() for t in
                               scans.quantile_scan_cuda(*a, s, sl, g)])))
    url = db.families["sessions"][("URL",)]
    not_in_100 = Query("sessions", AggOp.COUNT, group_by=("OS",),
                       predicate=smoke.not_in(Atom, CmpOp, Predicate, "URL",
                                              "url", 500, 100))
    for which, k in (("smallest", url.ks[-1]), ("largest", url.ks[0])):
        args, struct, slots, g = smoke.kernel_args(torch, db, not_in_100,
                                                   ("URL",), k)
        out.append(("agg_scan_fused", f"COUNT(*) WHERE URL NOT IN (100 URLs) "
                    f"GROUP BY OS, {which} K={k:g}", g,
                    lambda a=args, s=struct, sl=slots, g=g:
                    scans.agg_scan_fused_cuda(*a, s, sl, g)))
    # agg_scan at the shapes the main path launches it: the wide templates
    # of chip_smoke.py phase 3 on the family each scans.
    url_wide = Query("sessions", AggOp.COUNT, group_by=("OS",),
                     predicate=smoke.not_in(Atom, CmpOp, Predicate, "URL",
                                            "url", 500, 200))
    city_wide = Query("sessions", AggOp.AVG, "SessionTime",
                      predicate=smoke.not_in(Atom, CmpOp, Predicate, "City",
                                             "city", 200, 130))
    city = db.families["sessions"][("City",)]
    for label, q, phi, k in (
            ("COUNT(*) WHERE URL NOT IN (200 URLs) GROUP BY OS, largest "
             f"K={url.ks[0]:g}", url_wide, ("URL",), url.ks[0]),
            ("COUNT(*) WHERE URL NOT IN (200 URLs) GROUP BY OS, smallest "
             f"K={url.ks[-1]:g}", url_wide, ("URL",), url.ks[-1]),
            ("AVG(SessionTime) WHERE City NOT IN (130 cities), City family, "
             f"largest K={city.ks[0]:g}", city_wide, ("City",), city.ks[0])):
        inputs, g, _ = smoke.wide_args(torch, db, q, phi, k)
        out.append(("agg_scan", label, g,
                    lambda a=inputs, g=g: scans.agg_scan_cuda(*a, g)))
    for n_q, ks, which in batched_shapes(url.ks):
        args, _, g, _ = smoke.batched_path_inputs(torch, db, n_q, ks)
        out.append(("agg_scan_batched", f"Q={n_q} SUM(SessionTime) WHERE "
                    f"URL=u GROUP BY OS, {which}", g,
                    lambda a=args, g=g: scans.agg_scan_batched_cuda(
                        *a, ((Op.EQ,),), g)))
    args, _, _ = smoke.weighted_sum_path_inputs(torch, db)
    out.append(("weighted_sum", "HT SUM(SessionTime), uniform block", 1,
                lambda a=args: torch.stack(ws.weighted_sum_cuda(*a))))
    eq = ((Op.EQ,),)
    for n_strata in STRATA:
        args = strata_case(n_strata)
        takes = this or n_strata <= SHARED_TABLE
        where = "shared memory" if n_strata <= SHARED_TABLE else "L2"
        out.append(("agg_scan_fused", f"synthetic, {n_strata} strata "
                    f"(table in {where})", 6,
                    (lambda a=args: scans.agg_scan_fused_cuda(
                        *a, eq, (0,), 6)) if takes else None))
        qargs = smoke.quantile_args(args)
        out.append(("quantile_scan", f"synthetic, {n_strata} strata "
                    f"(table in {where})", 6,
                    (lambda a=qargs: torch.cat([t.flatten() for t in
                                                scans.quantile_scan_cuda(
                                                    *a, eq, (0,), 6)]))
                    if takes else None))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another checkout whose kernels run in turns")
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--sass", type=Path, default=None,
                    help="directory for each library's SASS")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import BlinkDB
    from repro_torch.kernels import agg_scan, weighted_sum

    card = smoke.card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    versions = {"this": (agg_scan, weighted_sum)}
    if args.baseline is not None:
        versions["baseline"] = load_version(args.baseline.resolve(),
                                            "baseline")
    order = (["baseline", "this", "this", "baseline"]
             if args.baseline is not None else ["this", "this"])
    for name, (scans, _) in versions.items():
        scans.build_all()
        for lname, lib in scans.LIBRARIES.items():
            for ln in ptxas_lines(lib):
                log(f"  ptxas [{name}] {lname}: {ln}")
            if args.sass is not None:
                args.sass.mkdir(parents=True, exist_ok=True)
                cuobjdump = Path(scans._nvcc()).with_name("cuobjdump")
                sass = subprocess.run([str(cuobjdump), "-sass", str(lib.path)],
                                      capture_output=True, text=True)
                (args.sass / f"{name}_{lname}.sass").write_text(sass.stdout)

    db, _, blocks, _ = smoke.sessions_engine(BlinkDB, ROWS, "cuda")
    for phi, b in blocks.items():
        log(f"  family {phi!s:10s} slots={b.n_local}")
    per_version = {name: cases(torch, db, v, this=name == "this")
                   for name, v in versions.items()}
    records = []
    for i, (kname, label, g, _) in enumerate(per_version["this"]):
        fns = {name: c[i][3] for name, c in per_version.items()
               if c[i][3] is not None}
        outs = {name: fn() for name, fn in fns.items()}
        torch.cuda.synchronize()
        diff = ((outs["this"] - outs["baseline"]).abs().max().item()
                if "baseline" in outs else None)
        ms = {name: [] for name in fns}
        for name in order:
            if name in fns:
                ms[name].append(smoke.time_cuda(torch, fns[name], warmup=3,
                                                reps=REPS))
        split = {name: profile_split(torch, fn, 10)
                 for name, fn in fns.items()}
        host = {}
        for name in fns:
            parts = " ".join(f"[{k}]={v:.4f}" for k, v in
                             sorted(split[name].items(), key=lambda kv: -kv[1]))
            device = sum(split[name].values())
            host[name] = sorted(ms[name])[len(ms[name]) // 2] - device
            per_q = ""
            if kname == "agg_scan_batched":
                n_q = int(label.split()[0].removeprefix("Q="))
                per_q = f" device/query={device / n_q:.5f}"
            log(f"  {kname} {label} G={g} [{name}] ms="
                + "/".join(f"{t:.4f}" for t in ms[name])
                + f" device={device:.4f} host={host[name]:.4f}{per_q} "
                f"split: {parts}")
        if diff is not None:
            log(f"  {kname} {label} G={g} max |this - baseline| = {diff!r}")
        records.append({"kernel": kname, "shape": label, "G": g, "ms": ms,
                        "split_ms": split, "host_ms": host,
                        "max_abs_diff_vs_baseline": diff})
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "rows": ROWS,
                                         "order": order,
                                         "records": records}, indent=1))
    log(f"kernel_times ok ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
