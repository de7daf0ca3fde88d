#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py              # the full run: 20M-row sessions table
    python3 chip_smoke.py --rows 200000

Phases, each reported on its own lines:
  1. card and build: torch version, the card's name and power limit, the
     nvcc builds of the five kernel libraries (agg_scan, agg_scan_batched,
     weighted_sum, agg_scan_fused, quantile_scan), started together
     (seconds, ptxas resources);
  2. kernels vs plain: each kernel on the card against its plain PyTorch
     version (rtol 2e-5, atol 1e-3; weighted_sum rtol 1e-4, atol 1e-2)
     over a sweep of rows, queries, groups (the main path's 1, 6, 200 and
     500, and the edges of the kernels' modes: 8/9, 32/33, 128/129,
     256/257), strata, dtypes, templates, ghosts and group codes outside
     [0, G); bit-identical repeat launches;
     each query of a Q = 7 or 64 launch bit-identical to the same query
     launched alone; the quantile kernel's moments bit-identical to
     agg_scan_fused at Q = 1 and to agg_scan over a selection given as one
     atom column; agg_scan_batched equal to agg_scan_fused (max |diff| 0.0)
     across its sweep (Q = 1, 7, 9, 64 and 65, 0, 1 and 127 atoms, n off
     16-byte alignment and a ragged last chunk); the wrappers refuse a
     128-atom template; agg_scan
     at its edges: its branch-free divisions over every rate in [2^-60, 1],
     a mask false everywhere or true in one row at a chunk's or a warp's
     edge, a selection at a small K of rows in entry-key order
     (against quantile_scan bit for bit), the same rows through its shared
     pass (columns off 16-byte alignment) bit for bit, and two calls in a
     row with separate outputs;
  3. main path: the Conviva-like sessions workload (paper §6.1) through
     BlinkDB.query — COUNT/SUM/AVG/QUANTILE, grouped and not, predicates, a
     disjunction, ERROR WITHIN and WITHIN SECONDS, and three templates
     wider than the fused kernel's constant block (NOT IN lists of 200 URLs,
     130 cities and, for QUANTILE, 126 URLs) — every scan held against its
     plain version on the same tensors, every answer against exact_query,
     the launch counts of agg_scan_fused, quantile_scan and agg_scan read
     around the run, those of the first two also by group count;
  3b. batch: 36 queries of five templates (QUANTILE and a 130-atom template
     among them) through BlinkDB.query_batch on a fresh engine, then
     through query() on that engine: every answer bit-identical (launches
     by group count as in phase 3, and agg_scan_fused's by query count);
  3c. the kernels' own entry points, kernels.ops.agg_scan_batched (32
     instantiations of SUM(SessionTime) WHERE URL = u GROUP BY OS on the
     URL family's materialized HT state) and kernels.ops.weighted_sum (the
     HT sums of SUM(SessionTime) on the uniform family), each with its
     launch count read around it: held against agg_scan_fused (bit for
     bit; rtol 1e-4 for weighted_sum's ungrouped sums), the plain version
     and exact_query;
  3d. sample creation: BlinkDB.build_samples (the §3.2 optimizer) on a
     fresh engine over phase 3's table with conviva_templates, and on a
     5M-row lineitem table with tpch_templates (K1 at the same ratio of
     rows to K1), budget 0.5, each with its host seconds (statistics,
     solver, family builds); the forced family (City, URL) of tens of
     thousands of strata, whose frequency table the fused and quantile
     kernels read through L2; 16 ERROR WITHIN queries through query()
     (each scan against its plain version, each answer against
     exact_query under phase 3's rule), then query_batch on fresh engines
     equal to query() bit for bit; launches by group count and by where
     the table sits;
  4. times: each kernel at the main path's shapes (agg_scan_fused and
     quantile_scan at G = 1, 6, 200 and 500) against its bound and its
     plain version, quantile_scan beside the yardstick agg_scan_fused +
     torch.bincount; agg_scan_fused and agg_scan_batched at Q = 32; the
     fused and quantile kernels on the (City, URL) family of phase 3d.
The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero and prints no result. Without a CUDA device it exits 2.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
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


WS_RTOL, WS_ATOL = 1e-4, 1e-2  # the reference's weighted_sum tolerance


def tol_ratio(torch, got, want, rtol=RTOL, atol=ATOL) -> float:
    """max |got - want| / (atol + rtol·|want|): at most 1 where allclose."""
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- phase 2

def make_case(torch, np, rng, device, n, g, q, n_cols, n_atoms, strata, sdt,
              cdt, adt, ghost=0.1, values=True, codes=True, small_k=False):
    """Scan-kernel inputs on the card: (values, unit, strat, freq_table,
    valid, atom_cols, group_codes, ks, pred_consts). Pad rows (unit=+inf)
    and ghost rows (valid=False) are in every case. small_k orders the rows
    by entry key, as a sample block is, and puts each query's K at 1-5% of
    the rows, so most warps of the block hold no prefix row."""
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
    cols = [rng.integers(0, 8, n).astype(adt) for _ in range(n_cols)]
    if small_k:
        ek = np.where(t["va"], t["u"] * t["ft"][t["s"]], np.inf)
        order = np.argsort(ek, kind="stable")
        for k in ("v", "u", "s", "va", "c"):
            t[k] = t[k][order]
        cols = [c[order] for c in cols]
        t["ks"] = np.quantile(ek[order][:n // 2],
                              rng.uniform(0.02, 0.1, q)).astype(np.float32)
    t = {k: torch.from_numpy(a).to(device) for k, a in t.items()}
    cols = tuple(torch.from_numpy(c).to(device) for c in cols)
    return (t["v"] if values else None, t["u"], t["s"], t["ft"], t["va"],
            cols, t["c"] if codes else None, t["ks"], t["consts"])


def sweep_cases(torch, np, device, quantile=False):
    """Kernel inputs over the sweep: (label, args, ops_struct, atom_slots,
    n_groups). The quantile sweep takes one query per case (Q = 1) and
    always a value column; a row count that is no multiple of any block is
    in every case."""
    from repro_torch.core.types import CmpOp
    rng = np.random.default_rng(8 if quantile else 7)

    def case(*a, **kw):
        return make_case(torch, np, rng, device, *a, **kw)

    eq, gt, le, ge, ne = CmpOp.EQ, CmpOp.GT, CmpOp.LE, CmpOp.GE, CmpOp.NE
    n = 100_003
    out = []
    # G edges at Q = 1: the quantile kernel's one-pass limit (32/33), the
    # moments' register/shared mode (8/9), the first kernel's group tiles
    # (128/129, 256/257); the main path's 1, 6, 200 and 500 at every Q.
    edges = (1, 6, 32, 33, 200, 500) if quantile else \
        (1, 6, 8, 9, 128, 129, 200, 256, 257, 500)
    for q in ((1,) if quantile else (1, 7, 64)):
        for g in (edges if q == 1 else (1, 6, 200, 500)):
            cdt = np.int16 if g > 127 else np.int8
            out.append((f"Q={q} G={g} dnf2(dup col)",
                        case(n, g, q, 1, 2, 37, np.int8, cdt, np.int8),
                        ((eq,), (gt,)), (0, 0), g))
    q = 1 if quantile else 3
    for strata, sdt in ((1, np.int8), (300, np.int16), (4096, np.int32)):
        out.append((f"strata={strata} {np.dtype(sdt).name}",
                    case(n, 6, q, 2, 2, strata, sdt, np.int32, np.int16),
                    ((le, ne),), (0, 1), 6))
    q = 1 if quantile else 4
    for adt in (np.int8, np.int16, np.int32, np.float32):
        out.append((f"atoms {np.dtype(adt).name}",
                    case(n, 12, q, 1, 2, 37, np.int16, np.int16, adt),
                    ((ge, CmpOp.LT),), (0, 0), 12))
    out.append(("0 atoms, ungrouped" if quantile else
                "0 atoms, COUNT, ungrouped",
                case(n, 1, 1 if quantile else 2, 0, 0, 37, np.int8, np.int8,
                     np.int8, values=quantile, codes=False), (), (), 1))
    out.append(("1 atom", case(n, 6, 1, 1, 1, 37, np.int8, np.int8, np.int8),
                ((gt,),), (0,), 6))
    out.append(("127 atoms", case(20_011, 2, 1, 1, 127, 37, np.int8, np.int8,
                                  np.int8), ((ge,) * 127,), (0,) * 127, 2))
    out.append(("all ghosts", case(n, 4, 1 if quantile else 2, 1, 1, 37,
                                   np.int8, np.int8, np.int8, ghost=1.1),
                ((gt,),), (0,), 4))
    out.append(("100 atoms, rows in entry-key order, small K",
                case(n, 6, 1 if quantile else 3, 1, 100, 37, np.int8,
                     np.int8, np.int8, small_k=True),
                ((ge,) * 100,), (0,) * 100, 6))
    # More strata than shared memory holds: the table is read through L2.
    for strata, sdt in ((4097, np.int16), (12_000, np.int16),
                        (70_000, np.int32)):
        out.append((f"strata={strata} {np.dtype(sdt).name} (L2 table)",
                    case(n, 6, 1 if quantile else 3, 2, 2, strata, sdt,
                         np.int8, np.int16), ((le, ne),), (0, 1), 6))
    return out


def check_close(torch, label, got, want, worst, rtol=RTOL, atol=ATOL,
                **flags) -> tuple:
    """Hold got against want at the kernel tolerance; log and raise on any
    failed flag. Returns the updated (max |diff|, max tolerance ratio)."""
    diff = (got - want).abs().max().item() if got.numel() else 0.0
    ratio = tol_ratio(torch, got, want, rtol, atol) if got.numel() else 0.0
    ok = torch.allclose(got, want, rtol=rtol, atol=atol)
    flags = dict(allclose=ok, finite=bool(torch.isfinite(got).all()),
                 **flags)
    log(f"  {label:30s} shape={tuple(got.shape)} max_abs_diff={diff:.3e} "
        f"tol_ratio={ratio:.3f} " +
        " ".join(f"{k}={v}" for k, v in flags.items()))
    if not all(flags.values()):
        raise AssertionError(f"kernel vs plain failed: {label} {flags}")
    return max(worst[0], diff), max(worst[1], ratio)


def refuse_128_atoms(fn, args, g) -> None:
    """A 127-atom case with one atom more: the wrapper `fn` must refuse it
    before counting a launch. args end with pred_consts."""
    from repro_torch.core.types import CmpOp
    consts = args[-1].new_zeros((args[-1].shape[0], 128))
    before = fn.launches
    try:
        fn(*args[:-1], consts, ((CmpOp.GE,) * 128,), (0,) * 128, g)
    except ValueError as e:
        log(f"  128 atoms refused: {e}")
    else:
        raise AssertionError(f"{fn.__name__} took a 128-atom template")
    if fn.launches != before:
        raise AssertionError("a refused call counted a launch")


def phase_kernel_vs_plain(torch, np, device) -> tuple[float, float]:
    from repro_torch.kernels import agg_scan, ref
    worst = (0.0, 0.0)     # (max |diff|, max tolerance ratio)
    fused = agg_scan.agg_scan_fused_cuda
    for label, args, struct, slots, g in sweep_cases(torch, np, device):
        got = fused(*args, struct, slots, g)
        again = fused(*args, struct, slots, g)
        # Each query alone: its slice of the batch must be bit-identical.
        ks, consts = args[-2], args[-1]
        alone = torch.cat([fused(*args[:-2], ks[i:i + 1], consts[i:i + 1],
                                 struct, slots, g)
                           for i in range(ks.shape[0])])
        torch.cuda.synchronize()
        # The plain version sums its float32 per-row terms in float64: an
        # order-free yardstick for the kernel's float32 sums.
        want = ref.agg_scan_fused_ref(*args, struct, slots, g,
                                      accumulate=torch.float64)
        worst = check_close(torch, label, got, want, worst,
                            bit_identical_repeat=torch.equal(got, again),
                            slices_equal_alone=torch.equal(got, alone))
        if len(slots) == agg_scan.MAX_ATOMS:
            widest = (args, g)
    refuse_128_atoms(fused, *widest)
    log(f"phase 2 agg_scan_fused ok: max_abs_diff={worst[0]:.6e} max "
        f"tol_ratio={worst[1]:.4f} (rtol={RTOL}, atol={ATOL})")
    return worst


def quantile_args(args) -> tuple:
    """Fused-scan args of one query → quantile-scan args over the values'
    own range (lo, hi as host floats)."""
    v = args[0]
    return (*args[:-1], v.min().item(), v.max().item(), args[-1])


def phase_quantile_vs_plain(torch, np, device) -> tuple[float, float]:
    from repro_torch.kernels import agg_scan, ref
    worst = (0.0, 0.0)
    quant = agg_scan.quantile_scan_cuda
    cases = sweep_cases(torch, np, device, quantile=True)
    # A range narrower than the data: out-of-range values clip into the
    # end bins.
    label, args, struct, slots, g = cases[1]
    cases.append(("narrow range " + label, args, struct, slots, g, 4.0, 6.0))
    for label, args, struct, slots, g, *rng in cases:
        qargs = quantile_args(args)
        if rng:
            qargs = (*qargs[:-3], *rng, qargs[-1])
        mom, hist = quant(*qargs, struct, slots, g)
        mom2, hist2 = quant(*qargs, struct, slots, g)
        fused = agg_scan.agg_scan_fused_cuda(*args, struct, slots, g)[0]
        torch.cuda.synchronize()
        want_mom, want_hist = ref.quantile_scan_ref(
            *qargs, struct, slots, g, accumulate=torch.float64)
        worst = check_close(torch, label + " moments", mom, want_mom, worst,
                            bit_identical_repeat=torch.equal(mom, mom2),
                            equals_fused_q1=torch.equal(mom, fused))
        worst = check_close(torch, label + " histogram", hist, want_hist,
                            worst,
                            bit_identical_repeat=torch.equal(hist, hist2))
        if len(slots) == agg_scan.MAX_ATOMS:
            widest = (args, g)
    args, g = widest
    refuse_128_atoms(quant, quantile_args(args), g)
    log(f"phase 2 quantile_scan ok: max_abs_diff={worst[0]:.6e} max "
        f"tol_ratio={worst[1]:.4f} (rtol={RTOL}, atol={ATOL})")
    return worst


def rate_case(torch, np, rng, device, n, g, dtype):
    """agg_scan inputs on the card: values at `dtype`, rates = min(1,
    100/freq), a random mask, and int32 codes in [-2, g + 2): the codes
    outside [0, g) must land in no group."""
    values = (rng.integers(0, 100, n) if dtype == np.int32
              else rng.normal(5, 2, n)).astype(dtype)
    freq = rng.integers(1, 500, n).astype(np.float32)
    host = (values, np.minimum(1.0, 100.0 / freq).astype(np.float32),
            rng.random(n) < 0.5, rng.integers(-2, g + 2, n).astype(np.int32))
    return tuple(torch.from_numpy(a).to(device) for a in host)


def phase_agg_scan_vs_plain(torch, np, device) -> tuple[float, float]:
    from repro_torch.core.types import CmpOp
    from repro_torch.kernels import agg_scan, ref
    worst = (0.0, 0.0)
    fn = agg_scan.agg_scan_cuda
    rng = np.random.default_rng(9)
    cases = [(n, g, np.float32) for n in (1, 4099, 1_000_000)
             for g in (1, 6, 600)]
    cases += [(n, 6, dt) for n in (4099, 1_000_000)
              for dt in (np.float16, np.int32)]
    for n, g, dt in cases:
        args = rate_case(torch, np, rng, device, n, g, dt)
        got = fn(*args, g)
        again = fn(*args, g)
        torch.cuda.synchronize()
        want = ref.agg_scan_ref(*args, g, accumulate=torch.float64)
        worst = check_close(torch, f"n={n} G={g} {np.dtype(dt).name}", got,
                            want, worst,
                            bit_identical_repeat=torch.equal(got, again))
    # A wide QUANTILE's promise: quantile_scan over a selection given as
    # one atom column has agg_scan's moments over it, bit for bit.
    for label, args, struct, slots, g in sweep_cases(torch, np, device,
                                                     quantile=True)[:3]:
        values, unit, strat, ftab, valid, cols, codes, ks, consts = args
        k = ks[:1]
        freq = ftab[strat.long()]
        sel = valid & (unit * freq < k[0]) & (cols[0] > 3)
        rates = torch.clamp_max(k[0] / freq, 1.0)
        mom = fn(values, rates, sel, codes, g)
        qmom, _ = agg_scan.quantile_scan_cuda(
            values, unit, strat, ftab, valid, (sel,), codes, k,
            values.min().item(), values.max().item(),
            torch.ones((1, 1), device=device), ((CmpOp.EQ,),), (0,), g)
        torch.cuda.synchronize()
        log(f"  {label:30s} quantile_scan moments over a selection == "
            f"agg_scan: {torch.equal(mom, qmom)}")
        if not torch.equal(mom, qmom):
            raise AssertionError(f"quantile_scan and agg_scan differ: {label}")
    worst = agg_scan_edge_cases(torch, np, device, worst)
    log(f"phase 2 agg_scan ok: max_abs_diff={worst[0]:.6e} max "
        f"tol_ratio={worst[1]:.4f} (rtol={RTOL}, atol={ATOL})")
    return worst


def misaligned(torch, t):
    """A copy of t whose data starts one element past a 16-byte boundary
    (agg_scan then takes the shared pass instead of its one-launch
    kernel)."""
    if t is None:
        return None
    view = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)[1:]
    view = view[:t.numel()]
    view.copy_(t)
    return view


def agg_scan_edge_cases(torch, np, device, worst) -> tuple:
    """agg_scan's one-launch kernel at its edges: its branch-free
    divisions against the correctly rounded ones over every rate in
    [2^-60, 1]; a mask false everywhere (zeros) or true in one row at a
    chunk's or a warp's edge (that row's float32 terms, bit for bit); rows
    in entry-key order with K at 2-10% of them (the warps past the prefix
    skip their divisions), against the plain version and bit for bit
    against quantile_scan's moments; the same inputs through the shared
    pass (columns off 16-byte alignment), bit for bit; two calls in a row
    return separate outputs."""
    from repro_torch.core.types import CmpOp
    from repro_torch.kernels import agg_scan, ref
    fn = agg_scan.agg_scan_cuda
    bad = agg_scan.agg_scan_rounding_mismatches(device)
    log(f"  branch-free divisions vs the correctly rounded ones over "
        f"[2^-60, 1]: {bad} floats differ")
    if bad:
        raise AssertionError("agg_scan's fast divisions differ in bits")
    rng = np.random.default_rng(12)
    n = 100_003
    for g in (1, 6):
        values, rates, _, codes = rate_case(torch, np, rng, device, n, g,
                                            np.float32)
        codes = codes.clamp(0, g - 1)
        rows = agg_scan.agg_scan_plan(n, g, agg_scan._n_sms(rates.device))[0]
        for where, at in (("nowhere", None), ("last row of chunk 0", rows - 1),
                          ("first row past a warp boundary", 32),
                          ("first row of chunk 1", rows),
                          ("last row", n - 1)):
            mask = torch.zeros(n, dtype=torch.bool, device=device)
            if at is not None:
                mask[at] = True
            for vals in (values, None):
                got = fn(vals, rates, mask, codes, g)
                want = ref.agg_scan_ref(vals, rates, mask, codes, g)
                torch.cuda.synchronize()
                worst = check_close(
                    torch, f"G={g} mask {where}"
                    f"{' COUNT' if vals is None else ''}", got, want, worst,
                    bitwise_plain=torch.equal(got, want),
                    zero_iff_empty=(got[0].sum().item() == 0) == (at is None))
    for g in (1, 6):
        args = make_case(torch, np, rng, device, n, g, 1, 1, 2, 37, np.int8,
                         np.int8, np.int8, small_k=True)
        values, unit, strat, ftab, valid, cols, codes, ks, consts = args
        k = ks[:1]
        freq = ftab[strat.long()]
        sel = valid & (unit * freq < k[0]) & (cols[0] > 3)
        rates = torch.clamp_max(k[0] / freq, 1.0)
        got = fn(values, rates, sel, codes, g)
        qmom, _ = agg_scan.quantile_scan_cuda(
            values, unit, strat, ftab, valid, (sel,), codes, k,
            values.min().item(), values.max().item(),
            torch.ones((1, 1), device=device), ((CmpOp.EQ,),), (0,), g)
        shifted = fn(*(misaligned(torch, t) for t in (values, rates, sel,
                                                      codes)), g)
        torch.cuda.synchronize()
        want = ref.agg_scan_ref(values, rates, sel, codes, g,
                                accumulate=torch.float64)
        worst = check_close(torch, f"G={g} small K, rows in key order", got,
                            want, worst, equals_quantile=torch.equal(got, qmom),
                            shared_pass_equal=torch.equal(got, shifted))
    a = rate_case(torch, np, rng, device, n, 6, np.float32)
    b = rate_case(torch, np, rng, device, 2 * n, 6, np.float32)
    first, second = fn(*a, 6), fn(*b, 6)
    again_a, again_b = fn(*a, 6), fn(*b, 6)
    torch.cuda.synchronize()
    if first.data_ptr() == second.data_ptr() or not (
            torch.equal(first, again_a) and torch.equal(second, again_b)):
        raise AssertionError("agg_scan: two calls in a row share an output")
    log("  two calls in a row: separate outputs, each its own answer")
    return worst


def materialized(torch, args, n_atoms):
    """agg_scan_batched inputs from fused-scan inputs: freq =
    freq_table[strat], entry_key = where(valid, unit·freq, inf), and one
    float32 row per atom (every atom reads atom column 0)."""
    values, unit, strat, ftab, valid, cols, codes, ks, consts = args
    freq = ftab[strat.long()]
    ek = torch.where(valid, unit * freq, torch.full_like(freq, float("inf")))
    atoms = (cols[0].float()[None, :].repeat(n_atoms, 1) if n_atoms
             else torch.zeros((0, freq.shape[0]), device=freq.device))
    return values, freq, ek, atoms, codes


def phase_batched_vs_plain(torch, np, device) -> tuple[float, float, float]:
    """Returns (max |diff| to the plain version, max tolerance ratio, max
    |diff| to agg_scan_fused, which must be 0)."""
    from repro_torch.core.types import CmpOp
    from repro_torch.kernels import agg_scan, ref
    worst, fused_diff = (0.0, 0.0), 0.0
    fn, fused = agg_scan.agg_scan_batched_cuda, agg_scan.agg_scan_fused_cuda
    rng = np.random.default_rng(10)
    # n = 100,003 and 2,049,003: atom rows off 16-byte alignment (n % 4 =
    # 3), and a ragged last chunk (2,048-row chunks at 2,049,003).
    cases = [(q, a, 6, 100_003) for q in (1, 7, 64, 65) for a in (0, 1, 127)]
    cases += [(64, 1, 500, 100_003), (7, 1, 1, 2_049_003),
              (7, 1, 6, 2_049_003), (9, 127, 6, 2_049_003)]
    for q, a, g, n in cases:
        args = make_case(torch, np, rng, device, n, g, q, 1, a, 37,
                         np.int8, np.int16 if g > 127 else np.int8, np.int8)
        struct = ((CmpOp.GE,) * a,) if a else ()
        mat = materialized(torch, args, a)
        ks, consts = args[-2], args[-1]
        got = fn(*mat, ks, consts, struct, g)
        again = fn(*mat, ks, consts, struct, g)
        same = torch.cat([fused(*args[:-2], ks[i:i + 64], consts[i:i + 64],
                                struct, (0,) * a, g)
                          for i in range(0, q, 64)])
        torch.cuda.synchronize()
        want = ref.agg_scan_batched_ref(*mat, ks, consts, struct, g,
                                        accumulate=torch.float64)
        diff = (got - same).abs().max().item()
        fused_diff = max(fused_diff, diff)
        worst = check_close(torch, f"Q={q} A={a} G={g} n={n}", got, want,
                            worst,
                            bit_identical_repeat=torch.equal(got, again),
                            equals_fused=diff == 0.0)
        if a == agg_scan.MAX_ATOMS:
            widest = (args, mat)
    args, mat = widest
    before = fn.launches
    try:
        fn(*mat[:3], mat[3][:1].repeat(128, 1), mat[4], args[-2],
           args[-1].new_zeros((args[-1].shape[0], 128)), ((CmpOp.GE,) * 128,),
           6)
    except ValueError as e:
        log(f"  128 atoms refused: {e}")
    else:
        raise AssertionError("agg_scan_batched_cuda took a 128-atom template")
    if fn.launches != before:
        raise AssertionError("a refused call counted a launch")
    log(f"phase 2 agg_scan_batched ok: max_abs_diff={worst[0]:.6e} max "
        f"tol_ratio={worst[1]:.4f}; max |diff| to agg_scan_fused "
        f"{fused_diff!r} over {len(cases)} cases")
    return worst + (fused_diff,)


def phase_weighted_sum_vs_plain(torch, np, device) -> tuple[float, float]:
    from repro_torch.kernels import ref, weighted_sum
    worst = (0.0, 0.0)
    fn = weighted_sum.weighted_sum_cuda
    rng = np.random.default_rng(11)
    for n in (1, 127, 9999, 10_000_000):
        host = (rng.normal(0, 3, n).astype(np.float32),
                (rng.random(n) + 0.5).astype(np.float32), rng.random(n) < 0.6)
        args = tuple(torch.from_numpy(a).to(device) for a in host)
        got = torch.stack(fn(*args))
        again = torch.stack(fn(*args))
        torch.cuda.synchronize()
        want = torch.stack(ref.weighted_sum_ref(*args,
                                                accumulate=torch.float64))
        worst = check_close(torch, f"n={n}", got, want, worst, rtol=WS_RTOL,
                            atol=WS_ATOL,
                            bit_identical_repeat=torch.equal(got, again))
    log(f"phase 2 weighted_sum ok: max_abs_diff={worst[0]:.6e} max "
        f"tol_ratio={worst[1]:.4f} (rtol={WS_RTOL}, atol={WS_ATOL})")
    return worst


# ----------------------------------------------------------------- phase 3

KERNELS = ("agg_scan", "agg_scan_batched", "weighted_sum", "agg_scan_fused",
           "quantile_scan")
MAIN_PATH_KERNELS = ("agg_scan_fused", "quantile_scan", "agg_scan")


def wrappers() -> dict:
    """Each kernel's wrapper, whose `launches` counts its launches."""
    from repro_torch.kernels import agg_scan, weighted_sum
    return {"agg_scan": agg_scan.agg_scan_cuda,
            "agg_scan_batched": agg_scan.agg_scan_batched_cuda,
            "weighted_sum": weighted_sum.weighted_sum_cuda,
            "agg_scan_fused": agg_scan.agg_scan_fused_cuda,
            "quantile_scan": agg_scan.quantile_scan_cuda}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


BY_GROUPS = ("agg_scan_fused", "quantile_scan")


@contextlib.contextmanager
def launches_by_groups(counts: dict, by_queries=None, by_table=None):
    """While active, counts the launches of the fused and quantile wrappers
    by their n_groups into counts[name][G], with `by_queries` the fused
    wrapper's launches by their query count Q into by_queries[Q], and with
    `by_table` both wrappers' launches by where their frequency table sits
    into by_table[name]["shared" or "L2"] (more than SHARED_STRATA strata
    are read through L2). Each
    wrapper is replaced by a counting one for the phase: a wrapper adds
    one to the `launches` of the
    module-level name it is bound to, which is then the counting wrapper
    (functools.wraps starts it at the wrapper's count), so launch_counts()
    reads it there during the phase, and the wrapper gets the count back
    when it is restored."""
    from repro_torch.kernels import agg_scan

    def counted(name, fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            before = call.launches
            out = fn(*args, **kw)
            g = kw.get("n_groups", args[-1] if args else 1)
            per = counts.setdefault(name, {})
            per[g] = per.get(g, 0) + call.launches - before
            if by_queries is not None and name == "agg_scan_fused":
                q = (kw["ks"] if "ks" in kw else args[7]).shape[0]
                by_queries[q] = by_queries.get(q, 0) + call.launches - before
            if by_table is not None:
                where = ("L2" if args[3].shape[0] > agg_scan.SHARED_STRATA
                         else "shared")
                per = by_table.setdefault(name, {})
                per[where] = per.get(where, 0) + call.launches - before
            return out
        return call
    saved = {name: getattr(agg_scan, f"{name}_cuda") for name in BY_GROUPS}
    for name, fn in saved.items():
        setattr(agg_scan, f"{name}_cuda", counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            fn.launches = getattr(agg_scan, f"{name}_cuda").launches
            setattr(agg_scan, f"{name}_cuda", fn)


def reset_launches(counts=None) -> None:
    for name, fn in wrappers().items():
        fn.launches = counts[name] if counts else 0


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def kernel_args(torch, db, q, phi, k):
    """The fused-scan kernel's inputs for query q on family phi at k, as the
    engine passes them: (args, ops_struct, atom_slots, n_groups)."""
    from repro_torch.core import executor as exec_lib
    striped = db._striped_for(q.table, phi)
    key, vals = db._scan_key(q.table, q, phi)
    _, _, struct, value_col, group_col, n_groups = key
    names, slots = exec_lib.dedup_atom_slots(exec_lib.flat_atoms(struct))
    cols = striped.columns
    args = (cols[value_col] if value_col else None,
            striped.unit, striped.strat, striped.freq_table, striped.valid,
            tuple(cols[c] for c in names),
            cols[group_col] if group_col else None,
            torch.tensor([k], dtype=torch.float32, device=db.device),
            torch.tensor([exec_lib.flatten_pred_vals(vals)],
                         dtype=torch.float32,
                         device=db.device).reshape(1, len(slots)))
    return args, tuple(tuple(op for _, op in c) for c in struct), slots, \
        n_groups


def wide_args(torch, db, q, phi, k):
    """The wide path's inputs for query q on family phi at k, as the engine
    builds them: (values, rates, selection, group codes), n_groups, and
    whether the template is wide for (fused scan, quantile scan)."""
    from repro_torch.core import executor as exec_lib
    striped = db._striped_for(q.table, phi)
    key, vals = db._scan_key(q.table, q, phi)
    _, _, struct, value_col, group_col, n_groups = key
    k = torch.tensor(k, dtype=torch.float32, device=db.device)
    pred = exec_lib.eval_pred_flat(
        struct, striped.columns,
        torch.tensor(exec_lib.flatten_pred_vals(vals), dtype=torch.float32,
                     device=db.device))
    freq, sel = exec_lib.query_selection(pred, k,
                                         *exec_lib.scan_args(striped)[1:])
    inputs = exec_lib.agg_scan_inputs(sel, freq, k, striped.columns,
                                      value_col, group_col)
    return inputs, n_groups, (not exec_lib.fits_const_block(struct, 1),
                              not exec_lib.fits_const_block(struct, 3))


def is_wide(torch, db, q, phi, lanes: int) -> bool:
    from repro_torch.core import executor as exec_lib
    key, _ = db._scan_key(q.table, q, phi)
    return not exec_lib.fits_const_block(key[2], lanes)


def checked_engine(torch, record):
    """A BlinkDB whose every scan is also run through the plain version on
    the same tensors and compared (outside the timed region)."""
    from repro_torch.core import BlinkDB
    from repro_torch.core import executor as exec_lib
    from repro_torch.core.types import CmpOp
    from repro_torch.kernels import ref

    class CheckedDB(BlinkDB):
        check = True     # False: record scans only (the latency pass)

        def _hold(self, name, got, want, phi, k):
            diff = (got - want).abs().max().item()
            if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                raise AssertionError(
                    f"{name} moments disagree with the plain version: "
                    f"{phi} k={k} max_abs_diff={diff}")
            rec = record[name]
            rec["max_abs_diff"] = max(rec["max_abs_diff"], diff)
            rec["tol_ratio"] = max(rec["tol_ratio"],
                                   tol_ratio(torch, got, want))

        def _run_at_k(self, table_name, q, phi, k):
            before = launch_counts()
            mom, rows, dt = super()._run_at_k(table_name, q, phi, k)
            launched = sum(launches_since(before).values())
            if self.check and is_wide(torch, self, q, phi, 1):
                inputs, g, _ = wide_args(torch, self, q, phi, k)
                want = ref.agg_scan_ref(*inputs, g, accumulate=torch.float64)
                self._hold("agg_scan", mom.stacked(), want, phi, k)
            elif self.check:
                args, struct, slots, g = kernel_args(torch, self, q, phi, k)
                want = ref.agg_scan_fused_ref(*args, struct, slots, g,
                                              accumulate=torch.float64)[0]
                self._hold("agg_scan_fused", mom.stacked(), want, phi, k)
            record["scans"].append((phi, k, rows, dt, launched))
            return mom, rows, dt

        def _run_quantile_at_k(self, table_name, q, phi, k):
            before = launch_counts()
            mom, rows, dt, qpair = super()._run_quantile_at_k(table_name, q,
                                                              phi, k)
            launched = sum(launches_since(before).values())
            if self.check:
                args, struct, slots, g = kernel_args(torch, self, q, phi, k)
                if is_wide(torch, self, q, phi, 3):
                    # The wide path: the selection as one atom column, over
                    # the selected values' range.
                    (values, _, sel, _), g, _ = wide_args(torch, self, q,
                                                          phi, k)
                    lo, hi = exec_lib.selected_range(values, sel)
                    one = torch.ones((1, 1), device=self.device)
                    qargs = (values, *args[1:5], (sel,), args[6], args[7],
                             lo, hi, one)
                    struct, slots = ((CmpOp.EQ,),), (0,)
                else:
                    lo, hi = self._family_range(table_name, phi,
                                                q.value_column)
                    qargs = (*args[:-1], lo, hi, args[-1])
                want, hist = ref.quantile_scan_ref(
                    *qargs, struct, slots, g, accumulate=torch.float64)
                self._hold("quantile_scan", mom.stacked(), want, phi, k)
                # The quantile read off the plain histogram lies within one
                # bin of the kernel's.
                qv, _ = exec_lib.hist_to_quantile(hist, lo, hi, q.quantile)
                bin_w = max(hi - lo, 1e-12) / 256.0
                gap = (qpair[0] - qv).abs().max().item() / bin_w
                if gap > 1.0:
                    raise AssertionError(
                        f"quantile off the plain histogram by {gap} bins: "
                        f"{phi} k={k}")
                rec = record["quantile_scan"]
                rec["max_bin_gap"] = max(rec["max_bin_gap"], gap)
            record["scans"].append((phi, k, rows, dt, launched))
            return mom, rows, dt, qpair
    return CheckedDB


def not_in(Atom, CmpOp, Predicate, col, prefix, total, n):
    """col NOT IN its n least popular values (prefix000 is the most
    popular): one conjunctive template of n NE atoms. An IN list would be
    a disjunction, which §4.1.2 splits into one-atom subqueries."""
    return Predicate.where(*[Atom(col, CmpOp.NE, f"{prefix}{total - 1 - i:03d}")
                             for i in range(n)])


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
        ("QUANTILE(SessionTime, 0.5) ERROR 10%",
         Q(t, AggOp.QUANTILE, "SessionTime", quantile=0.5,
           bound=ErrorBound(0.10))),
        ("QUANTILE(SessionTime, 0.9) GROUP BY OS ERROR 5%",
         Q(t, AggOp.QUANTILE, "SessionTime", quantile=0.9, group_by=("OS",),
           bound=ErrorBound(0.05))),
        ("QUANTILE(Bitrate, 0.5) GROUP BY City ERROR 10%",
         Q(t, AggOp.QUANTILE, "Bitrate", quantile=0.5, group_by=("City",),
           bound=ErrorBound(0.10))),
        ("QUANTILE(SessionTime, 0.99) WHERE Genre=genre03 ERROR 10%",
         Q(t, AggOp.QUANTILE, "SessionTime", quantile=0.99, predicate=genre,
           bound=ErrorBound(0.10))),
        ("QUANTILE(Bitrate, 0.9) GROUP BY URL WITHIN 0.05 SECONDS",
         Q(t, AggOp.QUANTILE, "Bitrate", quantile=0.9, group_by=("URL",),
           bound=TimeBound(0.05))),
        ("COUNT(*) WHERE URL NOT IN (200 URLs) GROUP BY OS ERROR 10%",
         Q(t, AggOp.COUNT, group_by=("OS",),
           predicate=not_in(Atom, CmpOp, Predicate, "URL", "url", 500, 200),
           bound=ErrorBound(0.10))),
        ("AVG(SessionTime) WHERE City NOT IN (130 cities) ERROR 5%",
         Q(t, AggOp.AVG, "SessionTime",
           predicate=not_in(Atom, CmpOp, Predicate, "City", "city", 200, 130),
           bound=ErrorBound(0.05))),
        ("QUANTILE(SessionTime, 0.9) WHERE URL NOT IN (126 URLs) ERROR 10%",
         Q(t, AggOp.QUANTILE, "SessionTime", quantile=0.9,
           predicate=not_in(Atom, CmpOp, Predicate, "URL", "url", 500, 126),
           bound=ErrorBound(0.10))),
    ]


def exact_bin_width(torch, db, q) -> float:
    """Bin width of exact_query's QUANTILE histogram: its range is that of
    the rows the predicate selects."""
    from repro_torch.core import executor as exec_lib
    tbl = db.tables[q.table]
    struct, vals = exec_lib.pred_structure(
        exec_lib.bind_predicate(q.predicate, db._encode(q.table)))
    v = tbl.columns[q.value_column][exec_lib.eval_pred(struct, tbl.columns,
                                                       vals)]
    return (v.max().item() - v.min().item()) / 256.0


def sample_bin_width(torch, db, q, ans) -> float:
    """Bin width of the sample's QUANTILE histogram: the family's range on
    the kernel path, the selected rows' range on the wide path."""
    from repro_torch.core import executor as exec_lib
    if is_wide(torch, db, q, ans.sample_phi, 3):
        (values, _, sel, _), _, _ = wide_args(torch, db, q, ans.sample_phi,
                                              ans.sample_k)
        lo, hi = exec_lib.selected_range(values, sel)
    else:
        lo, hi = db._family_range(q.table, ans.sample_phi, q.value_column)
    return (hi - lo) / 256.0


def hold_to_exact(torch, np, db, label, q, ans, scans, launched) -> int:
    """Phase 3's rule for one answer against exact_query: raises for an
    empty or non-finite answer, or for a QUANTILE group outside 2 CI
    half-widths plus one bin width of each side's histogram; logs the
    answer. Returns how many of its groups lie within 2 CI half-widths
    (the caller holds COUNT, SUM and AVG to 90% of all groups)."""
    from repro_torch.core import AggOp
    exact = {g.key: g.estimate for g in db.exact_query(q).groups}
    if not ans.groups or not np.isfinite(
            [[g.estimate, g.ci_low, g.ci_high] for g in ans.groups]).all():
        raise AssertionError(f"{label}: empty or non-finite answer")
    slack = 0.0
    if q.agg is AggOp.QUANTILE:
        exact_w = exact_bin_width(torch, db, q)
        if ans.sample_phi == ("<exact>",):
            slack = 2.0 * exact_w
        else:
            slack = sample_bin_width(torch, db, q, ans) + exact_w
    rel, in_ci, outside = [], 0, []
    for g in ans.groups:
        truth = exact[g.key]
        rel.append(abs(g.estimate - truth) / max(abs(truth), 1e-12))
        half = max(g.ci_high - g.estimate, g.estimate - g.ci_low)
        inside = abs(g.estimate - truth) <= \
            2.0 * half + 1e-4 * abs(truth) + slack
        in_ci += inside
        if not inside:
            outside.append((g.key, g.estimate, truth, half, g.n_selected))
    for key, est, truth, half, n_sel in outside[:10]:
        log(f"    outside: {label} group={key} estimate={est!r} "
            f"exact={truth!r} ci_half={half!r} slack={slack!r} "
            f"n_selected={n_sel} family={ans.sample_phi} "
            f"K={ans.sample_k!r}")
    if q.agg is AggOp.QUANTILE and in_ci < len(ans.groups):
        raise AssertionError(
            f"{label}: {len(ans.groups) - in_ci} groups farther than 2 CI "
            f"half-widths plus one bin width per side from exact_query")
    ci_rel = max(((g.ci_high - g.ci_low) / 2.0 / max(abs(g.estimate), 1e-12))
                 for g in ans.groups)
    log(f"  {label}: family={ans.sample_phi} K={ans.sample_k:.6g} "
        f"rows_read={ans.rows_read} scan_ms={1e3 * ans.elapsed_s:.3f} "
        f"bound_met={ans.bound_met} certified={ans.certified} "
        f"scans={len(scans)} launches "
        + " ".join(f"{k}={launched[k]}" for k in MAIN_PATH_KERNELS)
        + f" groups={len(ans.groups)} "
        f"max_realized_rel_err={max(rel):.3e} max_ci_rel_half={ci_rel:.3e} "
        f"groups_within={in_ci}/{len(ans.groups)}"
        + (f" bin_slack={slack:.6g}" if slack else ""))
    return in_ci


def sessions_engine(engine_cls, n_rows: int, device):
    """The smoke's workload: the sessions table of n_rows base rows (seed
    0), an engine of engine_cls with EngineConfig() defaults, the families
    City, URL and uniform, their striped blocks resident on the device.
    Returns (db, table, blocks, host clock at each step)."""
    from repro_torch.core import EngineConfig
    from repro_torch.core import table as table_lib
    from repro_torch.data import synth
    t0 = time.perf_counter()
    raw = synth.sessions_table(n_rows, seed=0)
    t1 = time.perf_counter()
    tbl = table_lib.from_columns("sessions", raw)
    del raw
    t2 = time.perf_counter()
    db = engine_cls(EngineConfig(), device=device)
    db.register_table("sessions", tbl)
    for phi in (("City",), ("URL",), ()):
        db.add_family("sessions", phi)
    t3 = time.perf_counter()
    blocks = {phi: db._striped_for("sessions", phi)
              for phi in db.families["sessions"]}
    db._sync()
    return db, tbl, blocks, (t0, t1, t2, t3, time.perf_counter())


def phase_main_path(torch, np, n_rows: int, record, device="cuda") -> dict:
    """The rule for every answer, fixed before the first chip run: COUNT,
    SUM and AVG need 90% of all their groups within 2 CI half-widths of
    exact_query; every QUANTILE group must lie within 2 CI half-widths
    plus one bin width of each side's histogram range (the sample's
    range, and exact_query's range of the selected rows)."""
    from repro_torch.core import (AggOp, Atom, CmpOp, Conjunction,
                                  ErrorBound, Predicate, Query, TimeBound)

    db, tbl, blocks, (t0, t1, t2, t3, t4) = sessions_engine(
        checked_engine(torch, record), n_rows, device)
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
    reset_launches()
    by_g = {}
    results, covered, total = [], 0, 0
    with launches_by_groups(by_g):
        for label, q in queries:
            n_scans = len(record["scans"])
            before = launch_counts()
            ans = db.query(q)
            launched = launches_since(before)
            scans = record["scans"][n_scans:]
            in_ci = hold_to_exact(torch, np, db, label, q, ans, scans,
                                  launched)
            covered += in_ci
            total += len(ans.groups)
            results.append((label, q, ans))
    launches = launch_counts()
    if device == "cuda" and min(launches[k] for k in MAIN_PATH_KERNELS) == 0:
        raise AssertionError(f"a kernel of the main path was launched no "
                             f"time: {launches}")
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
    fr, qr, ar = (record["agg_scan_fused"], record["quantile_scan"],
                  record["agg_scan"])
    log("  launches by G: " + "; ".join(
        f"{k} " + " ".join(f"G={g}:{c}" for g, c in sorted(by_g.get(k, {}).items()))
        for k in BY_GROUPS))
    log(f"phase 3 ok: {len(queries)} queries, launches "
        + " ".join(f"{k}={launches[k]}" for k in MAIN_PATH_KERNELS)
        + f", {covered}/{total} groups within the rule; "
        f"scans vs plain: fused max_abs_diff={fr['max_abs_diff']:.6e} "
        f"tol_ratio={fr['tol_ratio']:.4f}, agg_scan max_abs_diff="
        f"{ar['max_abs_diff']:.6e} tol_ratio={ar['tol_ratio']:.4f}, "
        f"quantile moments max_abs_diff={qr['max_abs_diff']:.6e} "
        f"tol_ratio={qr['tol_ratio']:.4f} "
        f"quantile gap {qr['max_bin_gap']:.4f} bins")
    return {"db": db, "launches": launches, "by_groups": by_g,
            "results": results}


# ---------------------------------------------------------------- phase 3b

def batch_queries(Q, AggOp, Atom, CmpOp, Predicate, ErrorBound):
    """32 instantiations of four templates, interleaved, then 4 of one
    130-atom template (City NOT IN 130 cities, a different window of
    cities each)."""
    t = "sessions"
    out = []
    for i in range(8):
        city = Predicate.where(Atom("City", CmpOp.EQ, f"city{i:03d}"))
        out += [
            Q(t, AggOp.COUNT, predicate=city, bound=ErrorBound(0.10)),
            Q(t, AggOp.AVG, "SessionTime", group_by=("OS",),
              predicate=Predicate.where(Atom("Genre", CmpOp.EQ,
                                             f"genre{i:02d}")),
              bound=ErrorBound(0.10)),
            Q(t, AggOp.SUM, "Bitrate",
              predicate=Predicate.where(Atom("URL", CmpOp.EQ, f"url{i:03d}")),
              bound=ErrorBound(0.10)),
            Q(t, AggOp.QUANTILE, "SessionTime", quantile=0.5, predicate=city,
              bound=ErrorBound(0.10)),
        ]
    for i in range(4):
        out.append(Q(t, AggOp.AVG, "SessionTime", bound=ErrorBound(0.05),
                     predicate=Predicate.where(*[
                         Atom("City", CmpOp.NE, f"city{199 - i - j:03d}")
                         for j in range(130)])))
    return out


def answer_bits(ans) -> tuple:
    return (ans.sample_phi, ans.sample_k, ans.rows_read, ans.bound_met,
            ans.certified, ans.predicted_half_width,
            [(g.key, g.estimate, g.stderr, g.ci_low, g.ci_high, g.n_selected,
              g.exact) for g in ans.groups])


def phase_batch(torch, np, main_db) -> dict:
    """query_batch on a fresh engine (the main engine's families and
    blocks, no cached decisions), then query() on that engine: every
    answer bit-identical."""
    from repro_torch.core import (AggOp, Atom, BlinkDB, CmpOp, EngineConfig,
                                  ErrorBound, Predicate, Query)
    db = BlinkDB(EngineConfig(), device=main_db.device)
    db.register_table("sessions", main_db.tables["sessions"])
    db.families["sessions"] = dict(main_db.families["sessions"])
    db._generations.update(main_db._generations)
    db._striped.update(main_db._striped)
    queries = batch_queries(Query, AggOp, Atom, CmpOp, Predicate, ErrorBound)
    reset_launches()
    by_g, by_q = {}, {}
    db._sync()
    t0 = time.perf_counter()
    with launches_by_groups(by_g, by_q):
        batched = db.query_batch(queries)
        db._sync()
    batch_s = time.perf_counter() - t0
    batch_launches = launch_counts()
    reset_launches()
    t0 = time.perf_counter()
    single = [db.query(q) for q in queries]
    db._sync()
    single_s = time.perf_counter() - t0
    single_launches = launch_counts()
    if db.device.type == "cuda" and min(
            batch_launches[k] for k in MAIN_PATH_KERNELS) == 0:
        raise AssertionError(f"query_batch launched a kernel no time: "
                             f"{batch_launches}")
    same = 0
    for q, a, b in zip(queries, batched, single):
        if not a.groups or not np.isfinite([g.estimate for g in a.groups]).all():
            raise AssertionError(f"batched answer empty or non-finite: {q}")
        if answer_bits(a) != answer_bits(b):
            raise AssertionError(f"query_batch and query() differ: {q}\n"
                                 f"{answer_bits(a)}\n{answer_bits(b)}")
        same += 1
    log(f"  query_batch: {len(queries)} queries in {1e3 * batch_s:.3f} ms, "
        "launches " + " ".join(f"{k}={batch_launches[k]}"
                               for k in MAIN_PATH_KERNELS))
    log("  batch launches by G: " + "; ".join(
        f"{k} " + " ".join(f"G={g}:{c}" for g, c in sorted(by_g.get(k, {}).items()))
        for k in BY_GROUPS))
    bands = {"Q=1": [1], "Q=2-7": range(2, 8), "Q>=8": range(8, 65)}
    log("  batch agg_scan_fused launches by Q: " + ", ".join(
        f"{name}: {sum(by_q.get(q, 0) for q in qs)}"
        for name, qs in bands.items()) + " (" + " ".join(
        f"Q={q}:{c}" for q, c in sorted(by_q.items())) + ")")
    log(f"  query() on the same engine: {1e3 * single_s:.3f} ms, launches "
        + " ".join(f"{k}={single_launches[k]}" for k in MAIN_PATH_KERNELS))
    log(f"phase 3b ok: {same}/{len(queries)} answers bit-identical")
    return {"launches": batch_launches, "by_groups": by_g,
            "fused_by_queries": by_q, "single_launches": single_launches}


# ---------------------------------------------------------------- phase 3c

def batched_path_inputs(torch, db, n_queries: int, ks=None):
    """kernels.ops.agg_scan_batched's inputs for n_queries instantiations of
    SUM(SessionTime) WHERE URL = u GROUP BY OS (query i: u = url{i:03d})
    over the URL family's whole block: the materialized HT state (pads and
    ghosts at entry_key inf), the URL column as one float32 atom row, and
    each query's K from `ks` (default: every query at K1). Also the fused
    scan's inputs for the same queries."""
    from repro_torch.core import executor as exec_lib
    phi = ("URL",)
    striped = db._striped_for("sessions", phi)
    k1 = db.families["sessions"][phi].ks[0]
    freq, ek = exec_lib.derive_ht(striped.unit, striped.strat,
                                  striped.freq_table)
    ek = torch.where(striped.valid, ek, torch.full_like(ek, float("inf")))
    cols = striped.columns
    enc = db._encode("sessions")
    ks = torch.tensor([k1] * n_queries if ks is None else list(ks),
                      dtype=torch.float32, device=db.device)
    consts = torch.tensor([[float(enc("URL", f"url{i:03d}"))]
                           for i in range(n_queries)], dtype=torch.float32,
                          device=db.device)
    g = db._column_card("sessions", "OS")
    values, codes = cols["SessionTime"], cols["OS"]
    batched = (values, freq, ek, cols["URL"].to(torch.float32)[None, :],
               codes, ks, consts)
    fused = (values, striped.unit, striped.strat, striped.freq_table,
             striped.valid, (cols["URL"],), codes, ks, consts)
    return batched, fused, g, striped


def weighted_sum_path_inputs(torch, db):
    """kernels.ops.weighted_sum's inputs for the HT sums of SUM(SessionTime)
    over the uniform family's whole block (k = K1): values, weights
    w = 1/min(1, k/freq), mask = valid & entry_key < k."""
    from repro_torch.core import executor as exec_lib
    striped = db._striped_for("sessions", ())
    k = torch.tensor(db.families["sessions"][()].ks[0], dtype=torch.float32,
                     device=db.device)
    freq, ek = exec_lib.derive_ht(striped.unit, striped.strat,
                                  striped.freq_table)
    weights = 1.0 / torch.clamp_max(k / freq, 1.0)
    return (striped.columns["SessionTime"], weights,
            striped.valid & (ek < k)), k, striped


def phase_ops_path(torch, np, db) -> dict:
    """The two kernels that no engine program reaches yet, driven through
    their entry points (kernels.ops) at the main path's data, each with its
    launch count set to 0 just before and read just after."""
    from repro_torch.core import AggOp, Query
    from repro_torch.core import estimators as est_lib
    from repro_torch.core.types import CmpOp
    from repro_torch.kernels import agg_scan, ops, ref
    out = {}
    batched, fused, g, striped = batched_path_inputs(torch, db, 32)
    reset_launches()
    mom = ops.agg_scan_batched(*batched, ((CmpOp.EQ,),), g)
    db._sync()
    out["agg_scan_batched"] = launch_counts()["agg_scan_batched"]
    got = mom.stacked()
    same = agg_scan.agg_scan_fused_cuda(*fused, ((CmpOp.EQ,),), (0,), g)
    want = ref.agg_scan_batched_ref(*batched, ((CmpOp.EQ,),), g,
                                    accumulate=torch.float64)
    diff_fused = (got - same).abs().max().item()
    b_worst = check_close(torch, "agg_scan_batched 32 x SUM WHERE URL=u "
                          "GROUP BY OS", got, want, (0.0, 0.0),
                          equals_fused=diff_fused == 0.0,
                          launched=out["agg_scan_batched"] > 0)
    # The answers: HT SUM per (URL, OS) against the exact sums.
    tbl = db.tables["sessions"]
    est = est_lib.estimate(AggOp.SUM, mom)
    stderr, _, _ = est_lib.ci(est, 0.95)
    half = est_lib.z_value(0.95) * stderr
    n_url = db._column_card("sessions", "URL")
    url, os_ = tbl.columns["URL"].long(), tbl.columns["OS"].long()
    exact = torch.zeros(n_url * g, dtype=torch.float64, device=db.device)
    exact.index_add_(0, url * g + os_, tbl.columns["SessionTime"].double())
    exact = exact.view(n_url, g)[batched[-1][:, 0].long()].float()
    err = (est.value - exact).abs()
    inside = (err <= 2.0 * half + 1e-4 * exact.abs()).float().mean()
    log(f"  agg_scan_batched: launches={out['agg_scan_batched']} "
        f"max |diff| to agg_scan_fused {diff_fused!r}; "
        f"{inside.item():.4f} of 32 x {g} HT sums within 2 CI half-widths "
        f"of the exact sums")
    if diff_fused != 0.0 or inside.item() < 0.9:
        raise AssertionError("agg_scan_batched path failed")

    args, k, ustriped = weighted_sum_path_inputs(torch, db)
    reset_launches()
    sums = torch.stack(ops.weighted_sum(*args))
    db._sync()
    out["weighted_sum"] = launch_counts()["weighted_sum"]
    want = torch.stack(ref.weighted_sum_ref(*args, accumulate=torch.float64))
    w_worst = check_close(torch, "weighted_sum HT SUM(SessionTime)", sums,
                          want, (0.0, 0.0), rtol=WS_RTOL, atol=WS_ATOL,
                          launched=out["weighted_sum"] > 0)
    q = Query("sessions", AggOp.SUM, "SessionTime")
    mom = db._run_batched(db._scan_key("sessions", q, ())[0], [k.item()],
                          [()])[0]
    moments = torch.stack([mom.wsum[0, 0], mom.wxsum[0, 0],
                           mom.wx2sum[0, 0]])
    ratio = tol_ratio(torch, sums, moments, WS_RTOL, WS_ATOL)
    est = est_lib.estimate(AggOp.SUM, est_lib.moments_slice(mom, 0))
    stderr, _, _ = est_lib.ci(est, 0.95)
    half = est_lib.z_value(0.95) * stderr[0].item()
    truth = db.exact_query(q).groups[0].estimate
    gap = abs(sums[1].item() - truth)
    log(f"  weighted_sum: launches={out['weighted_sum']} sums={sums.tolist()} "
        f"vs the fused scan's (wsum, wxsum, wx2sum) tol_ratio={ratio:.4f}; "
        f"HT SUM {sums[1].item()!r} exact {truth!r} gap {gap!r} "
        f"(2 CI half-widths {2 * half!r})")
    if ratio > 1.0 or gap > 2.0 * half + 1e-4 * abs(truth):
        raise AssertionError("weighted_sum path failed")
    log("phase 3c ok")
    return {"launches": out, "agg_scan_batched": b_worst + (diff_fused,),
            "weighted_sum": w_worst}


# ---------------------------------------------------------------- phase 3d

LINEITEM_ROWS = 5_000_000    # cut for the smoke's time limit
ROWS_PER_K1 = 200            # the smoke's ratio: 20M sessions rows, K1 = 1e5


def conviva_templates(QueryTemplate):
    """benchmarks/common.py conviva_templates: §2.3's workload, the
    headline templates with the paper's weights."""
    return [QueryTemplate(frozenset(c), w) for c, w in (
        ({"City"}, 0.30), ({"Genre", "City"}, 0.25), ({"OS", "URL"}, 0.25),
        ({"Genre"}, 0.10), ({"URL"}, 0.10))]


def tpch_templates(QueryTemplate):
    """benchmarks/common.py tpch_templates: TPC-H's 22 queries as 6
    templates (paper §6.1)."""
    return [QueryTemplate(frozenset(c), w) for c, w in (
        ({"l_returnflag", "l_linestatus"}, 0.25), ({"l_suppkey"}, 0.20),
        ({"l_partkey"}, 0.20), ({"l_shipmode"}, 0.15),
        ({"l_partkey", "l_suppkey"}, 0.10), ({"l_returnflag"}, 0.10))]


def sample_creation_queries(tbl, line):
    """(table, label, Query) of phase 3d, all ERROR WITHIN:
    benchmarks/common.py conviva_queries at 10%, the port's
    launch/query.py four at its 5%, three on the forced (City, URL)
    family, and four lineitem queries."""
    from repro_torch.core import AggOp, Atom, CmpOp, ErrorBound, Predicate
    from repro_torch.core import Query as Q
    from repro_torch.launch import query as query_launch
    t, b = "sessions", ErrorBound(0.10)
    city, url = tbl.dictionaries["City"], tbl.dictionaries["URL"]
    out = [(t, "AVG(SessionTime) GROUP BY City", Q(
                t, AggOp.AVG, "SessionTime", group_by=("City",), bound=b)),
           (t, f"COUNT WHERE City={city[0]}", Q(
                t, AggOp.COUNT, bound=b,
                predicate=Predicate.where(Atom("City", CmpOp.EQ, city[0])))),
           (t, "SUM(SessionTime) WHERE Genre=genre03 GROUP BY City", Q(
                t, AggOp.SUM, "SessionTime", group_by=("City",), bound=b,
                predicate=Predicate.where(Atom("Genre", CmpOp.EQ,
                                               "genre03")))),
           (t, f"COUNT WHERE OS=os1 AND URL={url[1]}", Q(
                t, AggOp.COUNT, bound=b, predicate=Predicate.where(
                    Atom("OS", CmpOp.EQ, "os1"),
                    Atom("URL", CmpOp.EQ, url[1])))),
           (t, "AVG(Bitrate) GROUP BY OS", Q(
                t, AggOp.AVG, "Bitrate", group_by=("OS",), bound=b))]
    out += [(t, f"launch/query.py {name}", q)
            for name, q in query_launch.queries(ErrorBound(0.05, 0.95))]
    both = Predicate.where(Atom("City", CmpOp.EQ, "city001"),
                           Atom("URL", CmpOp.EQ, "url001"))
    out += [(t, "(City, URL) COUNT WHERE City=city001 AND URL=url001",
             Q(t, AggOp.COUNT, predicate=both, bound=b)),
            (t, "(City, URL) AVG(SessionTime) WHERE City=city000 AND "
             "URL=url002", Q(t, AggOp.AVG, "SessionTime", bound=b,
                             predicate=Predicate.where(
                                 Atom("City", CmpOp.EQ, "city000"),
                                 Atom("URL", CmpOp.EQ, "url002")))),
            (t, "(City, URL) QUANTILE(SessionTime, 0.5) WHERE City=city001 "
             "AND URL=url001", Q(t, AggOp.QUANTILE, "SessionTime",
                                 quantile=0.5, predicate=both, bound=b))]
    t = "lineitem"
    supp, part = line.dictionaries["l_suppkey"], line.dictionaries["l_partkey"]
    out += [(t, f"SUM(l_extendedprice) WHERE l_suppkey={supp[0]} GROUP BY "
             "l_shipmode", Q(t, AggOp.SUM, "l_extendedprice", bound=b,
                             group_by=("l_shipmode",),
                             predicate=Predicate.where(
                                 Atom("l_suppkey", CmpOp.EQ, supp[0])))),
            (t, f"COUNT WHERE l_partkey={part[0]}", Q(
                t, AggOp.COUNT, bound=b, predicate=Predicate.where(
                    Atom("l_partkey", CmpOp.EQ, part[0])))),
            (t, f"AVG(l_quantity) WHERE l_partkey={part[1]} AND "
             f"l_suppkey={supp[1]}", Q(
                t, AggOp.AVG, "l_quantity", bound=b,
                predicate=Predicate.where(
                    Atom("l_partkey", CmpOp.EQ, part[1]),
                    Atom("l_suppkey", CmpOp.EQ, supp[1])))),
            (t, "QUANTILE(l_extendedprice, 0.5) GROUP BY l_returnflag", Q(
                t, AggOp.QUANTILE, "l_extendedprice", quantile=0.5,
                group_by=("l_returnflag",), bound=ErrorBound(0.05)))]
    return out


FORCED = ("City", "URL")     # a family of tens of thousands of strata


def timed_engine(engine_cls):
    """engine_cls whose candidate statistics and family builds log their
    host seconds into .timing["stats"] and .timing["builds"] as (φ, s)."""

    class TimedDB(engine_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.timing = {"stats": [], "builds": []}

        def candidate_stats(self, table_name):
            timing = self.timing
            stats = super().candidate_stats(table_name)

            def timed(phi):
                t0 = time.perf_counter()
                out = stats(phi)
                timing["stats"].append((tuple(sorted(phi)),
                                        time.perf_counter() - t0))
                return out
            return timed

        def add_family(self, table_name, phi, seed=None, units=None):
            t0 = time.perf_counter()
            super().add_family(table_name, phi, seed=seed, units=units)
            self.timing["builds"].append((tuple(sorted(phi)),
                                          time.perf_counter() - t0))
    return TimedDB


def build_samples_logged(db, table, templates, budget) -> dict:
    """db.build_samples with its host seconds logged: each φ's statistics,
    the solver and each family build, and the striping of the blocks."""
    from repro_torch.core import optimizer as opt_lib
    timing = db.timing
    timing.update(stats=[], builds=[])
    solve = opt_lib.solve_greedy

    def timed_solve(*a, **kw):
        t0 = time.perf_counter()
        out = solve(*a, **kw)
        timing["solver"] = time.perf_counter() - t0
        return out
    opt_lib.solve_greedy = timed_solve
    try:
        t0 = time.perf_counter()
        sol = db.build_samples(table, templates, budget)
        total = time.perf_counter() - t0
    finally:
        opt_lib.solve_greedy = solve
    tbl = db.tables[table]
    t0 = time.perf_counter()
    blocks = {phi: db._striped_for(table, phi) for phi in db.families[table]}
    db._sync()
    stripe = time.perf_counter() - t0
    chosen = [tuple(sorted(c.phi)) for c in sol.chosen]
    log(f"  {table}: {tbl.n_rows} rows, K1={db.config.k1:g}, budget "
        f"{budget}: chosen {chosen}, storage_used {sol.storage_used:.6g} B = "
        f"{sol.storage_used / tbl.nbytes:.4f} of the table "
        f"({tbl.nbytes} B), objective {sol.objective:.6g}")
    log(f"  {table} build_samples {total:.3f}s: candidate_stats "
        f"{sum(t for _, t in timing['stats']):.3f}s ("
        + " ".join(f"{p}={t:.3f}" for p, t in timing["stats"])
        + f"), solver {timing['solver']:.4f}s, family builds "
        + " ".join(f"{p}={t:.3f}s" for p, t in timing["builds"])
        + f"; stripe+upload {stripe:.3f}s")
    for phi, fam in db.families[table].items():
        log(f"  {table} family {phi!s:24s} rows={fam.n_rows} "
            f"slots={blocks[phi].n_local} strata={fam.n_distinct} "
            f"freq_table={blocks[phi].freq_table.shape[0]} "
            f"strat={blocks[phi].strat.dtype}")
    return {"chosen": chosen, "share": sol.storage_used / tbl.nbytes,
            "seconds": total}


def phase_sample_creation(torch, np, main_db, record, device="cuda") -> dict:
    """build_samples on fresh engines: the sessions table of phase 3 (its
    encoded Table reused) under EngineConfig() and conviva_templates, and
    lineitem_table at LINEITEM_ROWS rows with K1 at the same ratio of rows
    to K1 and tpch_templates, both at budget 0.5; then the forced (City,
    URL) family. The queries through query() on the chosen families, each
    scan held against its plain version and each answer against
    exact_query under phase 3's rule; then query_batch on fresh engines
    over the same families, equal to query() there bit for bit."""
    from repro_torch.core import BlinkDB, EngineConfig, QueryTemplate
    from repro_torch.core import table as table_lib
    from repro_torch.data import synth
    t_phase = time.perf_counter()
    checked = checked_engine(torch, record)
    dbs = {}
    db = timed_engine(checked)(EngineConfig(), device=device)
    db.register_table("sessions", main_db.tables["sessions"])
    dbs["sessions"] = db
    built = {"sessions": build_samples_logged(
        db, "sessions", conviva_templates(QueryTemplate), 0.5)}
    t0 = time.perf_counter()
    db.add_family("sessions", FORCED)
    fblock = db._striped_for("sessions", FORCED)
    db._sync()
    log(f"  sessions forced family {FORCED}: "
        f"strata={db.families['sessions'][FORCED].n_distinct} "
        f"rows={db.families['sessions'][FORCED].n_rows} "
        f"slots={fblock.n_local} strat={fblock.strat.dtype}; build+stripe "
        f"{time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    line = table_lib.from_columns("lineitem",
                                  synth.lineitem_table(LINEITEM_ROWS))
    log(f"  lineitem: synth+encode {time.perf_counter() - t0:.3f}s")
    ldb = timed_engine(checked)(
        EngineConfig(k1=LINEITEM_ROWS / ROWS_PER_K1), device=device)
    ldb.register_table("lineitem", line)
    dbs["lineitem"] = ldb
    built["lineitem"] = build_samples_logged(
        ldb, "lineitem", tpch_templates(QueryTemplate), 0.5)

    queries = sample_creation_queries(db.tables["sessions"], line)
    reset_launches()
    by_g, by_table = {}, {}
    covered = total = 0
    answers = []
    with launches_by_groups(by_g, by_table=by_table):
        for table, label, q in queries:
            n_scans = len(record["scans"])
            before = launch_counts()
            ans = dbs[table].query(q)
            launched = launches_since(before)
            if label.startswith("(City, URL)") and ans.sample_phi != FORCED:
                raise AssertionError(f"{label} answered on {ans.sample_phi}")
            covered += hold_to_exact(torch, np, dbs[table], label, q, ans,
                                     record["scans"][n_scans:], launched)
            total += len(ans.groups)
            answers.append(ans)
    launches = launch_counts()
    l2 = {k: v.get("L2", 0) for k, v in by_table.items()}
    log("  launches by G: " + "; ".join(
        f"{k} " + " ".join(f"G={g}:{c}" for g, c in sorted(by_g.get(k, {}).items()))
        for k in BY_GROUPS) + "; by table: " + "; ".join(
        f"{k} " + " ".join(f"{w}:{c}" for w, c in sorted(v.items()))
        for k, v in sorted(by_table.items())))
    if device == "cuda" and (min(launches[k] for k in BY_GROUPS) == 0 or
                             min(l2.get(k, 0) for k in BY_GROUPS) == 0):
        raise AssertionError(f"phase 3d launched a kernel no time (or none "
                             f"with its table in L2): {launches} {by_table}")
    if covered < 0.9 * total:
        raise AssertionError(f"only {covered}/{total} groups within 2 CI "
                             f"half-widths of exact_query")

    # query_batch on fresh engines over the same families, then query()
    # on those engines: every answer bit-identical.
    reset_launches()
    batch_by_g, batch_by_table = {}, {}
    fresh = {}
    for table, src in dbs.items():
        f = BlinkDB(EngineConfig(k1=src.config.k1), device=device)
        f.register_table(table, src.tables[table])
        f.families[table] = dict(src.families[table])
        f._generations.update(src._generations)
        f._striped.update(src._striped)
        fresh[table] = f
    t0 = time.perf_counter()
    batched = []
    with launches_by_groups(batch_by_g, by_table=batch_by_table):
        for table, f in fresh.items():
            batched += f.query_batch([q for t, _, q in queries if t == table])
        main_db._sync()
    batch_s = time.perf_counter() - t0
    batch_launches = launch_counts()
    order = [(t, label, q) for table in fresh
             for t, label, q in queries if t == table]
    single, walls = [], []
    for t, _, q in order:
        t0 = time.perf_counter()
        single.append(fresh[t].query(q))
        fresh[t]._sync()
        walls.append(time.perf_counter() - t0)
    single_s = sum(walls)
    for (t, label, q), a, b, wall in zip(order, batched, single, walls):
        if answer_bits(a) != answer_bits(b):
            raise AssertionError(f"query_batch and query() differ: {label}\n"
                                 f"{answer_bits(a)}\n{answer_bits(b)}")
        log(f"    {label} [query() after the batch]: "
            f"query_ms={1e3 * wall:.3f} family={b.sample_phi} "
            f"K={b.sample_k:.6g} scan_ms={1e3 * b.elapsed_s:.3f}")
    log(f"  query_batch: {len(order)} queries in {1e3 * batch_s:.3f} ms "
        f"(launches " + " ".join(f"{k}={batch_launches[k]}" for k in BY_GROUPS)
        + "; by G " + "; ".join(
            f"{k} " + " ".join(f"G={g}:{c}" for g, c in
                               sorted(batch_by_g.get(k, {}).items()))
            for k in BY_GROUPS)
        + f"); query() on the same engines {1e3 * single_s:.3f} ms; "
        f"{len(order)}/{len(order)} answers bit-identical")
    seconds = time.perf_counter() - t_phase
    log(f"phase 3d ok: {len(queries)} queries, {covered}/{total} groups "
        f"within the rule; launches "
        + " ".join(f"{k}={launches[k]} (L2 table {l2.get(k, 0)})"
                   for k in BY_GROUPS) + f"; {seconds:.1f}s")
    return {"db": db, "launches": launches, "l2": l2, "by_groups": by_g,
            "batch_l2": {k: v.get("L2", 0) for k, v in batch_by_table.items()},
            "built": built, "seconds": seconds}


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
    """Kernel inputs of q at its selected family's largest K (the whole
    block): (phi, striped block, args, ops_struct, atom_slots, n_groups)."""
    phi = db._select_phi(q.table, q)
    args, struct, slots, g = kernel_args(torch, db, q, phi,
                                         db.families[q.table][phi].ks[0])
    return phi, db._striped_for(q.table, phi), args, struct, slots, g


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for one call: bytes (each input read once, each output
    written once) over 3.35 TB/s against float32 operations over 67
    TFLOP/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound_for(args, ops_struct, mom, out_bytes) -> tuple[float, str]:
    """The fused and quantile scans' bound, counting this run's selected
    rows (mom is [..., 7, G])."""
    (values, unit, strat, ftab, valid, acols, codes, ks, consts) = args
    n = unit.shape[0]
    n_atoms = sum(len(c) for c in ops_struct)
    selected = float(mom[..., 0, :].sum())
    return bound(nbytes(values, unit, strat, valid, codes, *acols, ftab, ks,
                        consts) + out_bytes,
                 n * (2 + n_atoms) * ks.numel() + 20.0 * selected)


def log_time(name, label, striped, g, ms, plain_ms, bnd, card, extra=""):
    log(f"  {name} {label}: slots={striped.n_local} G={g} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]}) "
        f"bound_share={bnd[0] / ms:.3f} library_ms=None (no single PyTorch "
        f"call computes this function){extra} card={card}")


def timed_queries():
    """The queries whose kernel inputs phase 4 times: (fused shapes,
    quantile shapes), each a list of (label, Query); G = 6, 200, 500 and 1
    for the fused scan, 6, 1, 1, 200 and 500 for the quantile scan."""
    from repro_torch.core import AggOp, Atom, CmpOp, Predicate, Query
    t = "sessions"
    genre = Predicate.where(Atom("Genre", CmpOp.EQ, "genre03"))
    fused_shapes = [
        ("SUM(SessionTime) WHERE Genre=genre03 GROUP BY OS",
         Query(t, AggOp.SUM, "SessionTime", predicate=genre,
               group_by=("OS",))),
        ("AVG(SessionTime) GROUP BY City",
         Query(t, AggOp.AVG, "SessionTime", group_by=("City",))),
        ("AVG(Bitrate) GROUP BY URL",
         Query(t, AggOp.AVG, "Bitrate", group_by=("URL",))),
        ("COUNT(*) WHERE dt<15", Query(
            t, AggOp.COUNT,
            predicate=Predicate.where(Atom("dt", CmpOp.LT, 15)))),
    ]
    quantile_shapes = [
        ("QUANTILE(SessionTime) GROUP BY OS",
         Query(t, AggOp.QUANTILE, "SessionTime", quantile=0.9,
               group_by=("OS",))),
        ("QUANTILE(SessionTime)",
         Query(t, AggOp.QUANTILE, "SessionTime", quantile=0.5)),
        ("QUANTILE(SessionTime) WHERE Genre=genre03",
         Query(t, AggOp.QUANTILE, "SessionTime", quantile=0.99,
               predicate=genre)),
        ("QUANTILE(Bitrate) GROUP BY City",
         Query(t, AggOp.QUANTILE, "Bitrate", group_by=("City",))),
        ("QUANTILE(Bitrate) GROUP BY URL",
         Query(t, AggOp.QUANTILE, "Bitrate", quantile=0.9,
               group_by=("URL",))),
    ]
    return fused_shapes, quantile_shapes


def quantile_inputs(torch, db, q):
    """scan_inputs of a QUANTILE query, its arguments with the family's
    histogram range: (phi, striped, args, qargs, ops_struct, atom_slots,
    n_groups)."""
    phi, striped, args, struct, slots, g = scan_inputs(torch, db, q)
    lo, hi = db._family_range("sessions", phi, q.value_column)
    return phi, striped, args, (*args[:-1], lo, hi, args[-1]), struct, \
        slots, g


def phase_times(torch, db, card: str) -> dict:
    from repro_torch.core import AggOp, Atom, CmpOp, Predicate, Query
    from repro_torch.core.types import CmpOp as Op
    from repro_torch.kernels import agg_scan, ref, weighted_sum
    t = "sessions"
    fused_shapes, quantile_shapes = timed_queries()
    fused, quant = agg_scan.agg_scan_fused_cuda, agg_scan.quantile_scan_cuda
    before = launch_counts()
    rows = {name: [] for name in KERNELS}
    for label, q in fused_shapes:
        phi, striped, args, struct, slots, g = scan_inputs(torch, db, q)
        out = fused(*args, struct, slots, g)
        ms = time_cuda(torch, lambda: fused(*args, struct, slots, g),
                       warmup=3, reps=20)
        plain_ms = time_cuda(torch, lambda: ref.agg_scan_fused_ref(
            *args, struct, slots, g), warmup=1, reps=5)
        bnd = bound_for(args, struct, out, 4 * out.numel())
        log_time("agg_scan_fused", f"{label} family={phi} Q=1", striped, g,
                 ms, plain_ms, bnd, card)
        rows["agg_scan_fused"].append(
            {"label": label, "G": g, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bnd[0], "bound_by": bnd[1]})
    for label, q in quantile_shapes:
        phi, striped, args, qargs, struct, slots, g = quantile_inputs(
            torch, db, q)
        mom, hist = quant(*qargs, struct, slots, g)
        ms = time_cuda(torch, lambda: quant(*qargs, struct, slots, g),
                       warmup=3, reps=20)
        plain_ms = time_cuda(torch, lambda: ref.quantile_scan_ref(
            *qargs, struct, slots, g), warmup=1, reps=5)
        # The histogram half alone as one library call: bincount of the
        # flat (group, bin) index weighted by w (inputs made outside).
        flat, w = ref.histogram_terms(*qargs, struct, slots, g)
        lib_ms = time_cuda(torch, lambda: torch.bincount(
            flat, weights=w, minlength=g * 256), warmup=2, reps=10)
        # The yardstick: the fused scan's moments plus bincount's histogram.
        fused_ms = time_cuda(torch, lambda: fused(*args, struct, slots, g),
                             warmup=3, reps=20)
        bnd = bound_for(args, struct, mom, 4 * (mom.numel() + hist.numel()))
        log_time("quantile_scan", f"{label} family={phi}", striped, g, ms,
                 plain_ms, bnd, card,
                 f" hist_bincount_ms={lib_ms:.4f} fused_ms={fused_ms:.4f} "
                 f"fused+bincount_ms={fused_ms + lib_ms:.4f}")
        rows["quantile_scan"].append(
            {"label": label, "G": g, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bnd[0], "bound_by": bnd[1],
             "hist_bincount_ms": lib_ms, "fused_ms": fused_ms})
    # Q = 32 in one launch against 32 launches at Q = 1 (one template, the
    # City family's whole block, 32 constants).
    phi, striped, args, struct, slots, g = scan_inputs(torch, db, Query(
        t, AggOp.COUNT,
        predicate=Predicate.where(Atom("City", CmpOp.EQ, "city000"))))
    ks = args[-2].repeat(32)
    consts = torch.arange(32, dtype=torch.float32, device=db.device)[:, None]
    batch = (*args[:-2], ks, consts)
    q32_ms = time_cuda(torch, lambda: fused(*batch, struct, slots, g),
                       warmup=3, reps=20)
    singles = [(*args[:-2], ks[i:i + 1], consts[i:i + 1]) for i in range(32)]

    def thirty_two():
        for a in singles:
            fused(*a, struct, slots, g)
    q1x32_ms = time_cuda(torch, thirty_two, warmup=1, reps=10)
    log(f"  agg_scan_fused Q=32 one launch: {q32_ms:.4f} ms; 32 launches at "
        f"Q=1: {q1x32_ms:.4f} ms (family={phi} slots={striped.n_local}, "
        f"COUNT WHERE City=c) card={card}")
    rows["q32_ms"], rows["q1x32_ms"] = q32_ms, q1x32_ms

    # agg_scan: the wide COUNT template's inputs on the URL block at K1.
    wide = Query(t, AggOp.COUNT, group_by=("OS",), predicate=not_in(
        Atom, CmpOp, Predicate, "URL", "url", 500, 200))
    phi = ("URL",)
    striped = db._striped_for(t, phi)
    inputs, g, _ = wide_args(torch, db, wide, phi, db.families[t][phi].ks[0])
    out = agg_scan.agg_scan_cuda(*inputs, g)
    ms = time_cuda(torch, lambda: agg_scan.agg_scan_cuda(*inputs, g),
                   warmup=3, reps=20)
    plain_ms = time_cuda(torch, lambda: ref.agg_scan_ref(*inputs, g),
                         warmup=1, reps=5)
    bnd = bound(nbytes(*inputs, out), 20.0 * float(out[0].sum()))
    log_time("agg_scan", "COUNT(*) WHERE URL NOT IN (200 URLs) GROUP BY OS "
             "(URL family)", striped, g, ms, plain_ms, bnd, card)
    rows["agg_scan"].append({"label": "COUNT(*) WHERE URL NOT IN (200 URLs) "
                             "GROUP BY OS, URL block", "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bnd[0],
                             "bound_by": bnd[1]})

    # agg_scan_batched: phase 3c's inputs at Q = 1 and Q = 32 (A = 1).
    for n_q in (1, 32):
        args, _, g, striped = batched_path_inputs(torch, db, n_q)
        eq = ((Op.EQ,),)
        out = agg_scan.agg_scan_batched_cuda(*args, eq, g)
        ms = time_cuda(torch, lambda: agg_scan.agg_scan_batched_cuda(
            *args, eq, g), warmup=3, reps=20)
        plain_ms = time_cuda(torch, lambda: ref.agg_scan_batched_ref(
            *args, eq, g), warmup=1, reps=3)
        n = args[1].shape[0]
        bnd = bound(nbytes(*args, out),
                    n * 3.0 * n_q + 20.0 * float(out[:, 0].sum()))
        label = f"Q={n_q} SUM(SessionTime) WHERE URL=u GROUP BY OS"
        log_time("agg_scan_batched", label + " (URL family)", striped, g, ms,
                 plain_ms, bnd, card)
        rows["agg_scan_batched"].append(
            {"label": label + ", URL block", "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bnd[0], "bound_by": bnd[1]})

    # weighted_sum: phase 3c's inputs on the uniform block.
    args, _, striped = weighted_sum_path_inputs(torch, db)
    fn = weighted_sum.weighted_sum_cuda
    sums = fn(*args)
    ms = time_cuda(torch, lambda: fn(*args), warmup=3, reps=20)
    plain_ms = time_cuda(torch, lambda: ref.weighted_sum_ref(*args),
                         warmup=1, reps=5)
    bnd = bound(nbytes(*args) + 12, 5.0 * float(args[2].sum()))
    log_time("weighted_sum", "HT SUM(SessionTime) (uniform family)", striped,
             1, ms, plain_ms, bnd, card)
    rows["weighted_sum"].append(
        {"label": "HT SUM(SessionTime), uniform block", "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1]})
    del sums
    reset_launches(before)      # timing launches are not main-path work
    return rows


def l2_queries():
    """(label, Query) of the fused and quantile scans timed on the forced
    (City, URL) family, whose table sits in L2."""
    from repro_torch.core import AggOp, Atom, CmpOp, Predicate, Query
    t = "sessions"
    both = Predicate.where(Atom("City", CmpOp.EQ, "city001"),
                           Atom("URL", CmpOp.EQ, "url001"))
    return [
        ("agg_scan_fused", "COUNT WHERE City=city001 AND URL=url001",
         Query(t, AggOp.COUNT, predicate=both)),
        ("agg_scan_fused", "AVG(SessionTime) WHERE City=city001 AND "
         "URL=url001 GROUP BY OS",
         Query(t, AggOp.AVG, "SessionTime", predicate=both,
               group_by=("OS",))),
        ("quantile_scan", "QUANTILE(SessionTime) WHERE City=city001 AND "
         "URL=url001", Query(t, AggOp.QUANTILE, "SessionTime",
                             predicate=both)),
    ]


def phase_times_l2(torch, db, card: str) -> dict:
    """The fused and quantile kernels on the forced (City, URL) family's
    whole block (its table read through L2): ms, plain ms, bound, and the
    disagreement with the plain version summed in float64."""
    from repro_torch.kernels import agg_scan, ref
    before = launch_counts()
    rows = {}
    for kname, label, q in l2_queries():
        k = db.families["sessions"][FORCED].ks[0]
        args, struct, slots, g = kernel_args(torch, db, q, FORCED, k)
        striped = db._striped_for("sessions", FORCED)
        if kname == "agg_scan_fused":
            fn = agg_scan.agg_scan_fused_cuda
            call = (*args, struct, slots, g)
            got = fn(*call)
            want = ref.agg_scan_fused_ref(*call, accumulate=torch.float64)
            plain = ref.agg_scan_fused_ref
            out_bytes = 4 * got.numel()
            mom = got
        else:
            fn = agg_scan.quantile_scan_cuda
            lo, hi = db._family_range("sessions", FORCED, q.value_column)
            call = (*args[:-1], lo, hi, args[-1], struct, slots, g)
            got = torch.cat([t.flatten() for t in fn(*call)])
            want = torch.cat([t.flatten() for t in ref.quantile_scan_ref(
                *call, accumulate=torch.float64)])
            plain = ref.quantile_scan_ref
            mom = fn(*call)[0]
            out_bytes = 4 * got.numel()
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{kname} with its table in L2 disagrees "
                                 f"with the plain version: {label} {diff}")
        ms = time_cuda(torch, lambda: fn(*call), warmup=3, reps=20)
        plain_ms = time_cuda(torch, lambda: plain(*call), warmup=1, reps=3)
        bnd = bound_for(args, struct, mom, out_bytes)
        log_time(kname, f"{label} family={FORCED} (table in L2, "
                 f"{args[3].shape[0]} strata)", striped, g, ms, plain_ms,
                 bnd, card, f" max_abs_diff={diff:.3e}")
        rows.setdefault(kname, []).append(
            {"label": label, "G": g, "n_strata": args[3].shape[0], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
             "max_abs_err": diff})
    reset_launches(before)      # timing launches are not main-path work
    return rows


def kernels_record(worst, record, main, batch, ops_path, times, sample,
                   l2_times, card: str) -> list[dict]:
    """The kernels' JSON record: one entry per kernel, its launches on its
    path, its worst disagreement with its plain version over every phase,
    and its times at the main path's shapes; the fused and quantile
    kernels also at the forced (City, URL) family's shapes, whose table
    sits in L2 ("l2_table", with phase 3d's launches of that route)."""
    sources = {
        "agg_scan": ("agg_scan.cu", "agg_scan.py:128"),
        "agg_scan_batched": ("agg_scan_batched.cu", "agg_scan.py:220"),
        "weighted_sum": ("weighted_sum.cu", "weighted_sum.py:42"),
        "agg_scan_fused": ("agg_scan_fused.cu", "agg_scan.py:411"),
        "quantile_scan": ("quantile_scan.cu", "agg_scan.py:557")}
    kernels = []
    for kname, (src, line) in sources.items():
        rep = times[kname][0]
        errs = [worst[kname]]
        if kname in record:
            errs.append((record[kname]["max_abs_diff"],
                         record[kname]["tol_ratio"]))
        if kname in ops_path:
            errs.append(ops_path[kname])
        entry = {
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{line}",
            "launches": (main["launches"][kname]
                         if kname in MAIN_PATH_KERNELS
                         else ops_path["launches"][kname]),
            "path": ("BlinkDB.query" if kname in MAIN_PATH_KERNELS
                     else f"kernels.ops.{kname}"),
            "max_abs_err": max(e[0] for e in errs),
            "max_abs_diff": max(e[0] for e in errs),
            "max_tol_ratio": max(e[1] for e in errs),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": None, "shape": rep["label"], "card": card,
        }
        if kname in MAIN_PATH_KERNELS:
            entry["batch_launches"] = batch["launches"][kname]
        if kname in BY_GROUPS:
            entry["by_G"] = [
                {**{k: row[k] for k in ("G", "label", "ms", "plain_ms",
                                        "bound_ms")},
                 "launches": main["by_groups"].get(kname, {}).get(row["G"], 0),
                 "batch_launches": batch["by_groups"].get(kname, {}).get(
                     row["G"], 0)}
                for row in times[kname]]
            entry["launches_by_G"] = main["by_groups"].get(kname, {})
            entry["batch_launches_by_G"] = batch["by_groups"].get(kname, {})
        if kname == "agg_scan_fused":
            entry.update(q32_ms=times["q32_ms"], q1x32_ms=times["q1x32_ms"],
                         batch_launches_by_Q=batch["fused_by_queries"])
        elif kname == "quantile_scan":
            entry["hist_bincount_ms"] = rep["hist_bincount_ms"]
            entry["fused_plus_bincount_ms"] = (rep["fused_ms"]
                                               + rep["hist_bincount_ms"])
        if kname in l2_times:
            entry["l2_table"] = [
                {**row, "route": "cuda", "library_ms": None,
                 "launches": sample["l2"].get(kname, 0),
                 "batch_launches": sample["batch_l2"].get(kname, 0),
                 "path": "BlinkDB.query (phase 3d)"}
                for row in l2_times[kname]]
            entry["sample_creation_launches"] = sample["launches"][kname]
        if kname == "agg_scan_batched":
            entry.update(q32_ms=times[kname][1]["ms"],
                         max_abs_diff_vs_fused=max(worst[kname][2],
                                                   ops_path[kname][2]))
        kernels.append(entry)
    return kernels


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

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    log(card)
    t0 = time.perf_counter()
    agg_scan.build_all()
    log(f"  built {len(agg_scan.LIBRARIES)} libraries in parallel in "
        f"{time.perf_counter() - t0:.2f}s")
    for lib in agg_scan.LIBRARIES.values():
        built = lib.build_seconds
        log(f"  {lib.path.name}: nvcc "
            f"{'%.2fs' % built if built is not None else 'earlier build'}")
        for line in lib.build_log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "smem", "spill")):
                log(f"  ptxas: {line.strip()}")

    log("phase 2: kernels vs their plain versions")
    worst = {"agg_scan_fused": phase_kernel_vs_plain(torch, np, "cuda"),
             "quantile_scan": phase_quantile_vs_plain(torch, np, "cuda"),
             "agg_scan": phase_agg_scan_vs_plain(torch, np, "cuda"),
             "agg_scan_batched": phase_batched_vs_plain(torch, np, "cuda"),
             "weighted_sum": phase_weighted_sum_vs_plain(torch, np, "cuda")}

    log("phase 3: main path, BlinkDB.query")
    record = {"scans": [],
              "agg_scan_fused": {"max_abs_diff": 0.0, "tol_ratio": 0.0},
              "agg_scan": {"max_abs_diff": 0.0, "tol_ratio": 0.0},
              "quantile_scan": {"max_abs_diff": 0.0, "tol_ratio": 0.0,
                                "max_bin_gap": 0.0}}
    main = phase_main_path(torch, np, args.rows, record)

    log("phase 3b: main path, BlinkDB.query_batch")
    batch = phase_batch(torch, np, main["db"])

    log("phase 3c: kernels.ops.agg_scan_batched and kernels.ops.weighted_sum")
    ops_path = phase_ops_path(torch, np, main["db"])

    log("phase 3d: sample creation, BlinkDB.build_samples")
    sample = phase_sample_creation(torch, np, main["db"], record)

    log(f"phase 4: times at the main path's shapes ({card})")
    times = phase_times(torch, main["db"], card)
    l2_times = phase_times_l2(torch, sample["db"], card)
    kernels = kernels_record(worst, record, main, batch, ops_path, times,
                             sample, l2_times, card)
    log(f"smoke total {time.perf_counter() - t_start:.1f}s (phase 3d "
        f"{sample['seconds']:.1f}s)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
