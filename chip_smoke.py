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
  3e. subsampling CIs and joins on phase 3's table and engine settings: a
     fresh engine with ci_method="subsampling" answers six ERROR WITHIN
     queries (COUNT, SUM BY OS, AVG BY City, AVG BY URL, QUANTILE WHERE
     Genre, QUANTILE BY OS), every launch (G·B = 32·G groups) held against its plain
     version, every answer against exact_query under phase 3's rule and
     against the closed form at its family and K (estimates within rtol
     1e-4, QUANTILE one bin; stderr ratios within the reference's
     [0.45, 2.2], QUANTILE [0.3, 3.0]), query_batch of the COUNT/SUM/AVG
     ones equal to query() bit for bit; then a media dimension of one row
     per URL (5% of the URLs left out, so keys dangle) joined through
     three queries that the URL family must serve, held the same way;
     launches by group count;
  3f. mutation and maintenance on a copy of phase 3's table (its own
     engine, phase 3's City, URL and uniform families and blocks): (a)
     append_rows of 1M rows, (b) 50,000 rows of a new City (one stratum
     under K1, held whole), (c) delete_rows WHERE dt < 6, (d) update_rows
     WHERE Genre = genre03 SET Bitrate = 1000, (e) SampleMaintainer
     .reclaim() past its thresholds (compact_table, decay, compact_family);
     after each step seven ERROR WITHIN queries through query(), every
     launch of the fused, quantile and agg_scan kernels held against its
     plain version, every answer against exact_query under phase 3's rule
     (the new city's COUNT exact within 1e-3), query_batch equal to query()
     bit for bit, each block's prefix naming its family's rows; after (d)
     each answer again on a fresh stripe of its family (rtol 1e-4); host
     seconds of each step and merge or scatter, restripes, ghost fractions,
     launches by G and table route, and the fused kernel's device ms on the
     URL and uniform blocks before and after (e);
  3g. tracing, faults and the BlinkQL service on phase 3's engine and
     blocks: phase 3's 16 queries traced cold and warm, each traced answer
     bit-identical to an untraced query() beside it, their stages logged
     (plan, scan, estimate, the host share of plan and the rest); five
     queries under six fault plans on 4 logical shards x 2 replicas (the
     clean sharded scan within rtol 1e-4 of the fused one, replica-0 kills
     and a process kill bit-identical to it, one shard lost on every
     replica degraded with reweight 4/3 and no CI narrower, a poison
     caught, all shards lost raising AllShardsLostError, an empty plan
     bit-identical to the clean path), every per-shard launch held against
     its plain version; phase 3b's 36 queries as BlinkQL text from 8
     session threads through BlinkQLService.submit and submit_many, each
     answer bit-identical to query() on the same engine, the repeats from
     the cache, EXPLAIN and SHOW METRICS; qps, submit latency p50/p99,
     batches and fused launches by Q;
  3h. the multi-device path (between 3g and 4): BlinkDB(mesh=DeviceMesh)
     in spawned worlds of 2 and 4 ranks on the one card (gloo carries the
     partials), on a sessions table cut to 5M rows (K1 25,000): phase 3's
     16 queries, a QUANTILE GROUP BY, 12 of phase 3b's batch, a
     subsampled CI, and an append followed by two queries, twice from
     scratch; every rank's launches of the fused, quantile and agg_scan
     kernels held against their plain versions, the answers equal in bits
     across ranks and runs and held to the same session on one device
     (family, K and keys; rtol 1e-4, a QUANTILE within one bin); each
     kernel's times on a rank's stripe of phase 3's families;
  3i. the LM substrate's serving path (between 3h and 4), qwen2-1.5b at
     full width and depth (28 layers, 1.54B parameters, float32 weights
     from a seeded generator on the card): float32 compute with TF32 off,
     prefill 64 + decode 64 against the teacher-forced forward over 128
     (rtol/atol 2e-2); the same widths cut to 2 layers, float32 logits on
     the card against the CPU's (rtol/atol 1e-3) and greedy tokens equal;
     ServeEngine.generate in the bfloat16 default at B = 8, P = 128, 64
     new tokens, twice, bit-equal and in range (prefill ms, decode ms a
     step, tok/s, the device's busy share by torch.profiler, the share of
     tokens equal to float32 compute's); the 2-layer cut through
     CheckpointManager and back, equal tokens; python -m
     repro_torch.launch.serve --arch qwen2-1.5b as a subprocess, exit 0
     and its [serve] line. No TPU kernel lies on this path (the products
     are torch.einsum), so the kernels' record is unchanged;
  3j. the LM substrate's training path (between 3i and 4), qwen2-1.5b at
     full width and depth: six steps of make_train_step (f32 policy,
     remat, bfloat16 compute, B = 8, T = 128 from SyntheticTokenStream)
     through train.loop.train, every loss finite and the last below the
     first (step ms split into forward+backward and optimizer, tokens/s,
     the device's busy share, a seventh step's device time by
     torch.profiler over the median step, and its top kernels, peak
     memory); a 2-layer cut's float32 loss, grad norm
     and every gradient leaf on the card against the CPU (rtol 1e-3, atol
     1e-3 of the leaf's largest magnitude, TF32 off); the lowmem policy
     (bfloat16 params, int8 moments) for 3 finite steps under (a)'s peak;
     the 2-layer cut stopped after 2 steps at a checkpoint and resumed,
     against 4 straight (rtol 1e-5); python -m repro_torch.launch.train
     --arch qwen2-1.5b as a subprocess, exit 0 and its [train] line; and
     the run's Telemetry as a BlinkDB table, the reference example's
     BlinkQL through BlinkQLService, every agg_scan_fused launch held to
     its plain version ("telemetry_launches" in the kernels' record),
     answers equal to query()'s bit for bit;
  3k. the LM substrate's MoE (between 3j and 4), granite-moe-3b-a800m at
     full width and depth (32 layers, 40 experts top 8, 3.30B parameters
     from a seeded generator on the card): ServeEngine.generate in
     bfloat16 at B = 8, P = 128, 64 new tokens, twice, bit-equal (prefill
     ms, decode ms a step, tok/s, busy share, top kernels, peak memory); a
     2-layer cut in float32 with TF32 off: every layer's routing (gate_idx,
     keep) equal on card and CPU, logits and aux within rtol/atol 1e-3,
     prefill + decode against its own forward at capacity factor 40; the
     lowmem policy at full width for 5 steps at B = 8, T = 128 (losses and
     aux finite, the first batch's loss lower after the five steps; step
     ms, tokens/s, busy share, peak memory); the cut's f32 gradients, card
     against CPU; launch.serve and launch.train --policy lowmem as
     subprocesses; the run's Telemetry through BlinkQLService
     ("moe_telemetry_launches" in the kernels' record);
  3l. the LM substrate's recurrent mixers (between 3k and 4): xlstm-125m
     at full width and depth (12 layers, 6 x [mLSTM, sLSTM], 0.162B
     parameters from a seeded generator): ServeEngine.generate in bfloat16
     at B = 8, P = 128, 64 new, twice, bit-equal (prefill ms, decode ms a
     step, tok/s, busy share, top kernels, peak memory); a 2-layer cut in
     float32 with TF32 off: logits card against CPU (rtol/atol 1e-3) and
     prefill 64 + decode 32 against its own forward over 96; the f32
     policy at full width for 2 steps at B = 8, T = 128 (losses finite,
     the first batch's loss lower after the two); the cut's gradients,
     card against CPU; jamba-v0.1-52b cut to one period (8 layers: 7
     Mamba, 1 attention, 4 MoE channels) at full width in bfloat16
     parameters, generate at B = 2, P = 512, 16 new, twice, bit-equal, and
     one Mamba mixer at full width in float32, card against CPU and decode
     against its forward; launch.serve and launch.train for xlstm-125m as
     subprocesses; the run's Telemetry through BlinkQLService
     ("xlstm_telemetry_launches" in the kernels' record);
  3m. the LM substrate's audio codebooks and cross-attention (between 3l
     and 4): musicgen-large at full width and depth (48 layers, 4
     codebooks of 2048, 3.255B parameters from a seeded generator):
     ServeEngine.generate in bfloat16 at B = 8, prompts [8, 4, 128], 64
     new, twice, bit-equal, output (8, 4, 192) (prefill ms, decode ms a
     step, tok/s, busy share, top kernels, peak memory); a 2-layer cut in
     float32 with TF32 off: logits [B, K, S, V] card against CPU
     (rtol/atol 1e-3), greedy tokens equal, prefill 64 + decode 32 against
     its own forward over 96; the lowmem policy at full width for 5 steps
     at B = 8, T = 128 of [8, 4, 129] codebook streams (losses finite, the
     first batch's loss lower after the five; step ms, tokens/s, busy
     share, peak memory); the cut's gradients, card against CPU;
     llama-3.2-vision-90b cut to one period (5 layers: 4 attention, 1
     cross-attention) at full width in bfloat16 parameters, generate at B
     = 2, P = 128, 16 new with a [2, 1601, 1280] vision source, twice,
     bit-equal, and one cross_attention at full width in float32 (gate
     0.5), output and gradients card against CPU, a reduced period's
     prefill + decode against its forward; launch.serve --arch
     musicgen-large as a subprocess (exit 0, output (4, 4, 48)) and
     --arch llama-3.2-vision-90b (its ValueError); the run's Telemetry
     through BlinkQLService ("musicgen_telemetry_launches" in the
     kernels' record);
  3n. the LM mesh (between 3m and 4): qwen2-1.5b at full width cut to 2
     of its 28 layers, float32 compute with TF32 off, on a (2, 2) (data,
     model) mesh of 4 spawned ranks sharing the card (gloo; every
     collective staged through host buffers): (a) three mesh train steps
     at B = 8, T = 128 (the batch split over the 4 ranks, each layer's
     weights gathered where it runs, gradients summed in rank order back
     into each leaf's block), step 0's loss and grad norm against the
     single-device port's (rtol 1e-4), losses finite and step 0's batch's
     lower after them, each rank's placed bytes equal to build_shardings'
     prediction, its peak GB and step ms, and its bytes sent in step 0
     equal to a DryComm's count of the same step on "meta" (launch/
     cells.py `dry_train_step`); (b) sharded-cache serving of B = 4, P =
     64 on the fresh weights, one layer's weights and cache gathered at a
     time: each rank's prefill logits, its own rows alone, against those
     rows of one device's (rtol 1e-4), its serving peak (the card's, the
     step's arguments counted as count_flops counts them) within 10% of a
     DryComm's traced count of the same prefill on "meta" (launch/
     cells.py `dry_serve_step`), and 8 greedy tokens against one device's;
     then qwen2-1.5b at full width and depth in lowmem (bfloat16) on the
     same mesh: one prefill and one decode step, each rank's peak within
     10% of meta's and below one whole copy of the parameters, with the
     step ms and the bytes sent into all-gathers; (c) the parameters
     saved from the world of 4, restored onto a world of 2 and onto one
     device, every leaf's sha1 equal; (d) launch.train --arch xlstm-125m
     in the world of 2 (full width and depth, one step), and python -m
     repro_torch.launch.dryrun --all; (e) rank 0's Telemetry through
     BlinkQLService ("mesh_telemetry_launches" of agg_scan_fused in the
     kernels' record);
  3o. the step's cost accounting (between 3n and 4): qwen2-1.5b at full
     width and depth, B = 8, T = 128, one f32 train step, one lowmem train
     step and one decode step at P = 128, each run on the card under
     launch/roofline.py's `count_flops` and torch's FlopCounterMode and on
     "meta" under `count_flops`: the FLOPs equal, the products equal to
     FlopCounterMode's, the traced peak within 10% of
     torch.cuda.max_memory_allocated (after reset_peak_memory_stats, less
     what was allocated before the phase); then each step timed alone
     against the `Roofline`'s bound with the card's peaks;
  4. times: each kernel at the main path's shapes (agg_scan_fused and
     quantile_scan at G = 1, 6, 200 and 500) against its bound and its
     plain version, quantile_scan beside the yardstick agg_scan_fused +
     torch.bincount; agg_scan_fused and agg_scan_batched at Q = 32; the
     fused and quantile kernels on the (City, URL) family of phase 3d;
     the subsampled launches: fused at G·B = 192, 6,400 and 16,000,
     quantile at G·B = 32 and 192.
The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero and prints no result. Without a CUDA device it exits 2.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import threading
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
# The counting and checking wrappers below run a launch and count it as one
# step under this lock: phase 3g launches from the service's dispatcher and
# session threads.
_WRAP_LOCK = threading.RLock()


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
            with _WRAP_LOCK:
                before = call.launches
                out = fn(*args, **kw)
                g = kw.get("n_groups", args[-1] if args else 1)
                per = counts.setdefault(name, {})
                per[g] = per.get(g, 0) + call.launches - before
                if by_queries is not None and name == "agg_scan_fused":
                    q = (kw["ks"] if "ks" in kw else args[7]).shape[0]
                    by_queries[q] = (by_queries.get(q, 0) + call.launches
                                     - before)
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


def kernel_args(torch, db, q, phi, k, striped=None):
    """The fused-scan kernel's inputs for query q on family phi at k, as the
    engine passes them (over `striped`, by default the family's block):
    (args, ops_struct, atom_slots, n_groups)."""
    from repro_torch.core import executor as exec_lib
    if striped is None:
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
            mom, rows, dt, report = super()._run_at_k(table_name, q, phi, k)
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
            return mom, rows, dt, report

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
    the live rows the predicate selects."""
    from repro_torch.core import executor as exec_lib
    tbl = db.tables[q.table]
    struct, vals = exec_lib.pred_structure(
        exec_lib.bind_predicate(q.predicate, db._encode(q.table)))
    sel = exec_lib.eval_pred(struct, tbl.columns, vals) & \
        tbl.live_mask_device()
    v = tbl.columns[q.value_column][sel]
    return (v.max().item() - v.min().item()) / 256.0


def sample_bin_width(torch, db, q, ans) -> float:
    """Bin width of the sample's QUANTILE histogram: the family's range on
    the kernel path, the selected rows' range on the wide path and under
    subsampling CIs."""
    from repro_torch.core import executor as exec_lib
    if is_wide(torch, db, q, ans.sample_phi, 3) or \
            db.config.ci_method == "subsampling":
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
SYNTHETIC_ROWS = 10_195_008  # kernel_times.py's L2 shapes: the URL block


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


# ---------------------------------------------------------------- phase 3e

N_SUBSAMPLES = 32            # EngineConfig().n_subsamples


@contextlib.contextmanager
def checked_launches(torch, worst: dict, names=BY_GROUPS):
    """While active, every launch of the wrappers `names` (by default the
    fused and quantile ones; "agg_scan" may join them) is also run through
    its plain version on the same tensors (sums in float64) and held to it
    (rtol 2e-5, atol 1e-3; the quantile scan's moments and histogram); the
    worst disagreement goes into worst[name][G] as [max_abs_diff,
    tol_ratio, launches]. The wrappers are swapped as in
    launches_by_groups, and their counts carried back."""
    from repro_torch.kernels import agg_scan, ref
    plain = {"agg_scan_fused": ref.agg_scan_fused_ref,
             "quantile_scan": ref.quantile_scan_ref,
             "agg_scan": ref.agg_scan_ref}

    def flat(out):
        return (torch.cat([t.flatten() for t in out])
                if isinstance(out, tuple) else out)

    def check(name, fn, args, kw):
        out = fn(*args, **kw)
        got = flat(out)
        want = flat(plain[name](*args, **kw, accumulate=torch.float64))
        g = kw.get("n_groups", args[-1])
        diff = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{name} at G={g} disagrees with its "
                                 f"plain version: max_abs_diff={diff}")
        per = worst.setdefault(name, {}).setdefault(g, [0.0, 0.0, 0])
        per[0] = max(per[0], diff)
        per[1] = max(per[1], tol_ratio(torch, got, want))
        per[2] += 1
        return out

    def checked(name, fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with _WRAP_LOCK:
                return check(name, fn, args, kw)
        return call
    saved = {name: getattr(agg_scan, f"{name}_cuda") for name in names}
    for name, fn in saved.items():
        setattr(agg_scan, f"{name}_cuda", checked(name, fn))
    try:
        yield worst
    finally:
        for name, fn in saved.items():
            fn.launches = getattr(agg_scan, f"{name}_cuda").launches
            setattr(agg_scan, f"{name}_cuda", fn)


def subsampling_queries():
    """(label, Query) of phase 3e's subsampled answers, all ERROR WITHIN."""
    from repro_torch.core import AggOp, Atom, CmpOp, ErrorBound, Predicate
    from repro_torch.core import Query as Q
    t = "sessions"
    return [
        ("COUNT(*) ERROR 10%", Q(t, AggOp.COUNT, bound=ErrorBound(0.10))),
        ("SUM(SessionTime) GROUP BY OS ERROR 5%",
         Q(t, AggOp.SUM, "SessionTime", group_by=("OS",),
           bound=ErrorBound(0.05))),
        ("AVG(SessionTime) GROUP BY City ERROR 10%",
         Q(t, AggOp.AVG, "SessionTime", group_by=("City",),
           bound=ErrorBound(0.10))),
        ("AVG(Bitrate) GROUP BY URL ERROR 10%",
         Q(t, AggOp.AVG, "Bitrate", group_by=("URL",),
           bound=ErrorBound(0.10))),
        ("QUANTILE(SessionTime, 0.5) WHERE Genre=genre03 ERROR 10%",
         Q(t, AggOp.QUANTILE, "SessionTime", quantile=0.5,
           predicate=Predicate.where(Atom("Genre", CmpOp.EQ, "genre03")),
           bound=ErrorBound(0.10))),
        ("QUANTILE(SessionTime, 0.5) GROUP BY OS ERROR 10%",
         Q(t, AggOp.QUANTILE, "SessionTime", quantile=0.5,
           group_by=("OS",), bound=ErrorBound(0.10))),
    ]


def join_dimension(np, tbl) -> dict:
    """The media dimension: one row per URL of the fact table except every
    20th (5% of the URLs, so their keys dangle), an owner of 12 values and
    a paid flag, drawn from seed 0."""
    rng = np.random.default_rng(0)
    urls = tbl.dictionaries["URL"]
    urls = urls[np.arange(len(urls)) % 20 != 7]
    return {"url": urls,
            "owner": np.array([f"own{i:02d}"
                               for i in rng.integers(0, 12, len(urls))]),
            "paid": rng.integers(0, 2, len(urls)).astype(np.int32)}


def join_queries():
    """(label, Query) of phase 3e's joined answers, all ERROR WITHIN."""
    from repro_torch.core import AggOp, Atom, CmpOp, ErrorBound, Predicate
    from repro_torch.core import Query as Q
    from repro_torch.core.joins import Join
    t, j = "sessions", (Join("media", "URL", "url"),)
    return [
        ("COUNT WHERE media.owner=own03 ERROR 10%",
         Q(t, AggOp.COUNT, joins=j, bound=ErrorBound(0.10),
           predicate=Predicate.where(Atom("media.owner", CmpOp.EQ,
                                          "own03")))),
        ("AVG(SessionTime) GROUP BY media.owner ERROR 10%",
         Q(t, AggOp.AVG, "SessionTime", group_by=("media.owner",), joins=j,
           bound=ErrorBound(0.10))),
        ("COUNT WHERE media.paid=1 ERROR 10%",
         Q(t, AggOp.COUNT, joins=j, bound=ErrorBound(0.10),
           predicate=Predicate.where(Atom("media.paid", CmpOp.EQ, 1)))),
    ]


def engine_over(src, config, dims=()):
    """A fresh BlinkDB over src's sessions table, families and striped
    blocks (no cached decisions), with the dimension tables `dims`."""
    from repro_torch.core import BlinkDB
    db = BlinkDB(config, device=src.device)
    db.register_table("sessions", src.tables["sessions"])
    for dim in dims:
        db.register_table(dim.schema.name, dim)
    db.families["sessions"] = dict(src.families["sessions"])
    db._generations.update(src._generations)
    db._striped.update(src._striped)
    return db


def run_held(torch, np, db, queries, by_g, worst) -> tuple:
    """query() of each (label, Query) with every launch held against its
    plain version and every answer against exact_query under phase 3's
    rule: (answers, groups within the rule, groups)."""
    answers, covered, total = [], 0, 0
    # The checking wrappers go inside the counting ones, so the counts
    # land on the module-level (counting) wrapper.
    with checked_launches(torch, worst), launches_by_groups(by_g):
        for label, q in queries:
            before = launch_counts()
            ans = db.query(q)
            launched = launches_since(before)
            covered += hold_to_exact(torch, np, db, label, q, ans, [],
                                     launched)
            total += len(ans.groups)
            answers.append(ans)
    return answers, covered, total


def batch_equals_single(db, queries, label) -> int:
    """query_batch of the queries on db, then query() on db: every answer
    bit-identical (raises otherwise); returns the count."""
    batched = db.query_batch([q for _, q in queries])
    for (name, q), a in zip(queries, batched):
        b = db.query(q)
        if not a.groups or answer_bits(a) != answer_bits(b):
            raise AssertionError(f"{label}: query_batch and query() differ: "
                                 f"{name}\n{answer_bits(a)}\n{answer_bits(b)}")
    return len(batched)


def hold_to_closed_form(torch, np, main_db, sub_db, label, q, ans) -> list:
    """The subsampled answer against the closed form at its family and K
    (phase 3's engine): the point estimates within rtol 1e-4 (QUANTILE:
    one histogram bin, the wider of the two), and the stderr ratio within
    the reference's bounds (tests/test_contracts.py: [0.45, 2.2]; QUANTILE
    [0.3, 3.0]) for every group sampled at a mean inclusion rate n/Σw of
    at most 1/2. Nearer rate 1 the closed form's finite-population factor
    (1 - r) takes its variance toward 0 while the replicates' spread does
    not (the expected ratio is 1/sqrt(1 - r): 1.41 at r = 1/2, 3.2 at
    0.9), so there the ratio measures that factor, not the CI; those
    groups are logged. Returns the checked ratios."""
    from repro_torch.core import AggOp
    closed = main_db._scan_and_answer(q, "sessions", ans.sample_phi,
                                      ans.sample_k, ans.confidence)
    mom, _, _, _ = main_db._run_at_k("sessions", q, ans.sample_phi,
                                     ans.sample_k)
    n, wsum = mom.n.cpu().numpy(), mom.wsum.cpu().numpy()
    codes = [g for g in range(len(n)) if not (n[g] == 0 and wsum[g] == 0)]
    c_by = {g.key: (g, n[c] / wsum[c]) for g, c in zip(closed.groups, codes)}
    if set(c_by) != {g.key for g in ans.groups}:
        raise AssertionError(f"{label}: groups differ from the closed form")
    quantile = q.agg is AggOp.QUANTILE
    lo_r, hi_r = (0.3, 3.0) if quantile else (0.45, 2.2)
    bin_w = (max(sample_bin_width(torch, sub_db, q, ans),
                 sample_bin_width(torch, main_db, q, closed))
             if quantile else 0.0)
    ratios, near_one, gap = [], [], 0.0
    for g in ans.groups:
        c, rate = c_by[g.key]
        err = abs(g.estimate - c.estimate)
        gap = max(gap, err / bin_w if quantile
                  else err / max(abs(c.estimate), 1e-30))
        if err > (bin_w if quantile else 1e-4 * abs(c.estimate)):
            raise AssertionError(f"{label}: group {g.key} estimate "
                                 f"{g.estimate!r}, closed form "
                                 f"{c.estimate!r}")
        if not (g.exact or c.exact) and c.stderr > 0:
            (ratios if rate <= 0.5 else near_one).append(g.stderr / c.stderr)
    outside = [r for r in ratios if not lo_r <= r <= hi_r]

    def span(rs):
        return (f"min {min(rs):.4f} median {float(np.median(rs)):.4f} "
                f"max {max(rs):.4f}" if rs else "(none)")
    log(f"    {label} vs closed form at family={ans.sample_phi} "
        f"K={ans.sample_k:.6g}: max estimate gap {gap:.3e} "
        f"({'bins' if quantile else 'relative'}); stderr ratio over "
        f"{len(ratios)} groups at rate <= 1/2 {span(ratios)} (bounds "
        f"[{lo_r}, {hi_r}]); over {len(near_one)} groups at rate > 1/2 "
        f"{span(near_one)}")
    if outside:
        raise AssertionError(f"{label}: {len(outside)} stderr ratios outside "
                             f"[{lo_r}, {hi_r}]: {outside[:5]}")
    return ratios


def phase_subsampling_and_joins(torch, np, main_db, device="cuda") -> dict:
    """Subsampling CIs and joins on phase 3's table and engine settings.
    Subsampling: a fresh engine with ci_method="subsampling" answers
    subsampling_queries(); each launch is held against its plain version,
    each answer against exact_query under phase 3's rule and against the
    closed form at its family and K; then query_batch of the COUNT/SUM/AVG
    ones on a fresh engine equals query() there bit for bit. Joins: the
    media dimension (5% of its keys dangle) on a fresh engine; the URL
    family must serve join_queries(), held as above, and query_batch on a
    fresh engine equals query(). Launches by group count, G·B included."""
    from repro_torch.core import AggOp, EngineConfig
    from repro_torch.core import table as table_lib
    t_phase = time.perf_counter()
    worst, out = {}, {}
    sub_db = engine_over(main_db, EngineConfig(ci_method="subsampling"))
    queries = subsampling_queries()
    reset_launches()
    by_g = {}
    answers, covered, total = run_held(torch, np, sub_db, queries, by_g,
                                       worst)
    out["sub_launches"] = launch_counts()
    out["sub_by_groups"] = by_g
    log("  subsampling launches by G: " + "; ".join(
        f"{k} " + " ".join(f"G={g}:{c}" for g, c in sorted(by_g.get(k, {}).items()))
        for k in BY_GROUPS))
    if device == "cuda" and min(out["sub_launches"][k]
                                for k in BY_GROUPS) == 0:
        raise AssertionError(f"subsampling launched a kernel no time: "
                             f"{out['sub_launches']}")
    for g_b in (N_SUBSAMPLES, 6 * N_SUBSAMPLES, 200 * N_SUBSAMPLES,
                500 * N_SUBSAMPLES):
        if not by_g.get("agg_scan_fused", {}).get(g_b) and \
                not by_g.get("quantile_scan", {}).get(g_b):
            raise AssertionError(f"no subsampled launch at G·B = {g_b}")
    for (label, q), ans in zip(queries, answers):
        if ans.sample_phi == ("<exact>",):
            log(f"    {label}: exact fallback, no sampled CI to compare")
            continue
        hold_to_closed_form(torch, np, main_db, sub_db, label, q, ans)
    plain_qs = [(label, q) for label, q in queries
                if q.agg is not AggOp.QUANTILE]
    reset_launches()
    n_same = batch_equals_single(
        engine_over(main_db, EngineConfig(ci_method="subsampling")),
        plain_qs, "subsampling")
    out["sub_batch_launches"] = launch_counts()
    log(f"  subsampling: {len(queries)} queries, {covered}/{total} groups "
        f"within the rule; query_batch = query() for {n_same}/"
        f"{len(plain_qs)}; launches " + " ".join(
            f"{k}={out['sub_launches'][k]}" for k in MAIN_PATH_KERNELS))

    tbl = main_db.tables["sessions"]
    dim = table_lib.from_columns("media", join_dimension(np, tbl))
    jdb = engine_over(main_db, EngineConfig(), dims=(dim,))
    queries = join_queries()
    reset_launches()
    by_g = {}
    t0 = time.perf_counter()
    answers, j_cov, j_tot = run_held(torch, np, jdb, queries, by_g, worst)
    out["join_seconds"] = time.perf_counter() - t0
    out["join_launches"] = launch_counts()
    out["join_by_groups"] = by_g
    for (label, _), ans in zip(queries, answers):
        if ans.sample_phi != ("URL",):
            raise AssertionError(f"{label} answered on {ans.sample_phi}, "
                                 f"not the join key's family")
    fk = jdb._fk_maps[("sessions", "media", "URL")]
    if device == "cuda" and out["join_launches"]["agg_scan_fused"] == 0:
        raise AssertionError(f"joins launched agg_scan_fused no time: "
                             f"{out['join_launches']}")
    reset_launches()
    n_same = batch_equals_single(engine_over(jdb, EngineConfig(), (dim,)),
                                 queries, "joins")
    out["join_batch_launches"] = launch_counts()
    log("  join launches by G: " + "; ".join(
        f"{k} " + " ".join(f"G={g}:{c}" for g, c in sorted(by_g.get(k, {}).items()))
        for k in BY_GROUPS))
    log(f"  joins: {len(queries)} queries in {out['join_seconds']:.3f}s "
        f"(gathers included), {int((fk < 0).sum())} of {len(fk)} URL keys "
        f"dangle, {j_cov}/{j_tot} groups within the rule; query_batch = "
        f"query() for {n_same}/{len(queries)}; launches " + " ".join(
            f"{k}={out['join_launches'][k]}" for k in MAIN_PATH_KERNELS))
    if covered + j_cov < 0.9 * (total + j_tot):
        raise AssertionError(f"only {covered + j_cov}/{total + j_tot} groups "
                             f"within 2 CI half-widths of exact_query")
    out["worst"] = worst
    out["sub_db"] = sub_db
    out["seconds"] = time.perf_counter() - t_phase
    fr = max((w[0] for w in worst.get("agg_scan_fused", {}).values()),
             default=0.0)
    qr = max((w[0] for w in worst.get("quantile_scan", {}).values()),
             default=0.0)
    log(f"phase 3e ok: launches vs plain max_abs_diff fused {fr:.6e}, "
        f"quantile {qr:.6e}; {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------- phase 3f

NEW_CITY = "city-new"          # phase 3f's step (b): a City value of its own
MUTATION_KERNELS = ("agg_scan_fused", "quantile_scan", "agg_scan")


def mutation_queries():
    """(label, Query) of phase 3f, all ERROR WITHIN, asked after each step."""
    from repro_torch.core import AggOp, Atom, CmpOp, ErrorBound, Predicate
    from repro_torch.core import Query as Q
    t = "sessions"
    return [
        ("COUNT GROUP BY OS ERROR 10%",
         Q(t, AggOp.COUNT, group_by=("OS",), bound=ErrorBound(0.10))),
        ("AVG(SessionTime) GROUP BY City ERROR 10%",
         Q(t, AggOp.AVG, "SessionTime", group_by=("City",),
           bound=ErrorBound(0.10))),
        ("SUM(Bitrate) WHERE Genre=genre03 ERROR 5%",
         Q(t, AggOp.SUM, "Bitrate", bound=ErrorBound(0.05),
           predicate=Predicate.where(Atom("Genre", CmpOp.EQ, "genre03")))),
        ("QUANTILE(SessionTime, 0.5) ERROR 10%",
         Q(t, AggOp.QUANTILE, "SessionTime", quantile=0.5,
           bound=ErrorBound(0.10))),
        ("COUNT WHERE URL NOT IN (200 URLs) GROUP BY OS ERROR 10%",
         Q(t, AggOp.COUNT, group_by=("OS",), bound=ErrorBound(0.10),
           predicate=not_in(Atom, CmpOp, Predicate, "URL", "url", 500, 200))),
        # 0.1% cannot be certified short of the whole stratum (rate 1):
        # the answer is the exact live count
        (f"COUNT WHERE City={NEW_CITY} ERROR 0.1%",
         Q(t, AggOp.COUNT, bound=ErrorBound(0.001),
           predicate=Predicate.where(Atom("City", CmpOp.EQ, NEW_CITY)))),
        ("COUNT WHERE dt<6 ERROR 10%",
         Q(t, AggOp.COUNT, bound=ErrorBound(0.10),
           predicate=Predicate.where(Atom("dt", CmpOp.LT, 6)))),
    ]


@contextlib.contextmanager
def host_seconds(torch, device, seconds: dict):
    """While active, the host seconds of every family merge, tombstone
    pass, decay and row-id remap (sampling) and of every block scatter or
    restripe (executor, the device synchronised around it) add up in
    seconds[name], one entry per call: the functions are swapped on their
    modules, which the engine reads them from at each call."""
    from repro_torch.core import executor as exec_lib
    from repro_torch.core import sampling as samp_lib
    names = {samp_lib: ("merge_family", "apply_tombstones", "decay_strata",
                        "remap_family_row_ids"),
             exec_lib: ("stripe_append", "stripe_tombstone", "stripe_family",
                        "remap_slot_row_ids")}
    saved = []

    def timed(name, fn):
        def call(*args, **kw):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call
    for mod, fns in names.items():
        for name in fns:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, timed(name, getattr(mod, name)))
    try:
        yield seconds
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def mutation_engine(main_db):
    """A fresh engine over a host copy of phase 3's sessions table (its
    schema columns, not the join columns phase 3e gathered), with phase
    3's City, URL and uniform families and their striped blocks, which the
    mutations replace and never write into."""
    from repro_torch.core import BlinkDB, EngineConfig
    from repro_torch.core import table as table_lib
    src = main_db.tables["sessions"]
    cols = src.schema.column_names
    tbl = table_lib.Table(src.schema, {c: src.host_column(c).copy()
                                       for c in cols},
                          {c: d.copy() for c, d in src.dictionaries.items()},
                          src.n_rows)
    db = BlinkDB(EngineConfig(), device=main_db.device)
    db.register_table("sessions", tbl)
    for phi in (("City",), ("URL",), ()):
        fam = main_db.families["sessions"][phi]
        db.families["sessions"][phi] = dataclasses.replace(
            fam, columns_host={c: fam.host_column(c) for c in cols})
        db._striped[("sessions", phi)] = main_db._striped_for("sessions", phi)
    return db


def device_ms(torch, fn, calls: int) -> float:
    """Device ms per call of the kernels fn() launches (torch.profiler,
    summed over them, mean over `calls` calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        total += us if us is not None else getattr(ev, "cuda_time_total", 0.0)
    return total / 1e3 / calls


def compaction_times(torch, np, db, q, blocks: dict, turns: int = 5) -> dict:
    """The fused kernel for q at each family's K1 over its block before the
    reclaim (blocks[phi], kept alive: patches never write into a block) and
    over its block now, in alternating turns: per family and side the
    median over turns of the event ms (median of 20 launches, the
    wrapper's host work included) and the device ms (torch.profiler, 20
    launches), the occupied slots, the bound and the plain version's ms."""
    from repro_torch.kernels import agg_scan, ref
    out = {}
    for phi, before in blocks.items():
        k = db.families["sessions"][phi].ks[0]
        sides = {"before": before, "after": db._striped_for("sessions", phi)}
        calls = {}
        for side, block in sides.items():
            args, struct, slots, g = kernel_args(torch, db, q, phi, k, block)
            calls[side] = (functools.partial(agg_scan.agg_scan_fused_cuda,
                                             *args, struct, slots, g),
                           args, struct, slots, g)
        ev, dev = {"before": [], "after": []}, {"before": [], "after": []}
        for _ in range(turns):
            for side, (fn, *_rest) in calls.items():
                ev[side].append(time_cuda(torch, fn, warmup=3, reps=20))
                dev[side].append(device_ms(torch, fn, 20))
        out[phi] = {}
        for side, (fn, args, struct, slots, g) in calls.items():
            mom = fn()
            bnd = bound_for(args, struct, mom, nbytes(mom))
            out[phi][side] = {
                "ms": float(np.median(ev[side])),
                "device_ms": float(np.median(dev[side])),
                "plain_ms": time_cuda(torch, lambda: ref.agg_scan_fused_ref(
                    *args, struct, slots, g), warmup=1, reps=3),
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "occupied": sides[side].n_rows,
                "ghosts": sides[side].n_ghosts}
    return out


def hold_prefix_ids(torch, np, db, label) -> None:
    """Each block's valid slots with entry_key < K1 name exactly its
    family's row ids (rescale ghosts fail the prefix, tombstoned slots the
    valid mask)."""
    for phi, fam in db.families["sessions"].items():
        b = db._striped_for("sessions", phi)
        ek = b.unit * b.freq_table[b.strat.long()]
        sel = (b.valid & (ek < fam.ks[0])).cpu().numpy()[: b.n_rows]
        got = np.sort(b.slot_row_ids[: b.n_rows][sel])
        if not np.array_equal(got, np.sort(fam.row_ids)):
            raise AssertionError(f"{label}: block {phi} prefix names "
                                 f"{got.size} rows, family {fam.n_rows}")


def hold_fresh_stripe(torch, np, db, answers) -> int:
    """Each sampled answer recomputed at its family and K on a fresh
    stripe_family of the same host family: estimates within rtol 1e-4 of
    the incremental block's. Returns the answers compared."""
    from repro_torch.core import AggOp
    from repro_torch.core import executor as exec_lib
    n = 0
    for (label, q), ans in answers:
        if ans.sample_phi == ("<exact>",) or not ans.groups:
            continue
        phi, k = ans.sample_phi, ans.sample_k
        fam = db.families["sessions"][phi]
        key, vals = db._scan_key("sessions", q, phi)
        ests = []
        for block in (db._striped_for("sessions", phi),
                      exec_lib.stripe_family(fam, db.device)):
            if q.agg is AggOp.QUANTILE:
                lo, hi = db._family_range("sessions", phi, q.value_column)
                mom, qv, dens = exec_lib.make_quantile_fn(*key[2:])(
                    k, vals, q.quantile, lo, hi, *exec_lib.scan_args(block))
                qpair = (qv, dens)
            else:
                mom = exec_lib.make_query_fn(*key[2:])(
                    k, vals, *exec_lib.scan_args(block))
                qpair = None
            ests.append(db._answer_from_moments(
                q, "sessions", phi, k, mom, 0, 0.0, ans.confidence,
                qpair=qpair))
        inc, fresh = ests
        if [g.key for g in inc.groups] != [g.key for g in fresh.groups]:
            raise AssertionError(f"{label}: the incremental block and a "
                                 f"fresh stripe answer other groups")
        a = np.array([g.estimate for g in inc.groups])
        f = np.array([g.estimate for g in fresh.groups])
        gap = float(np.max(np.abs(f - a) / np.maximum(np.abs(a), 1e-30)))
        log(f"    {label}: fresh stripe of {phi} at K={k:.6g}: max relative "
            f"estimate gap {gap:.3e} over {len(a)} groups")
        if gap > 1e-4:
            raise AssertionError(f"{label}: the incremental block and a "
                                 f"fresh stripe disagree at K={k}: {gap}")
        n += 1
    return n


def phase_mutation(torch, np, main_db, device="cuda") -> dict:
    """The mutation lifecycle and sample maintenance on phase 3's table:
    (a) append_rows of 1M new rows, (b) 50,000 rows of one new City (a
    stratum smaller than K1, held whole), (c) delete_rows WHERE dt < 6,
    (d) update_rows WHERE Genre = genre03 SET Bitrate = 1000, (e)
    SampleMaintainer.reclaim() past its thresholds (compact_table, decay,
    compact_family). After each step mutation_queries() through query():
    every launch against its plain version, every answer against
    exact_query under phase 3's rule, the new city's COUNT equal to the
    exact live count within 1e-3, query_batch equal to query() bit for bit,
    and each block's prefix naming its family's rows; after (d), each
    answer again on a fresh stripe of its family (rtol 1e-4). Logs the
    host seconds of every step and of each merge or scatter, restripes,
    ghost fractions, block bytes, launches by G and by table route, and
    the fused kernel's time on the URL and uniform blocks before and after
    (e) at the same K, in alternating turns (compaction_times)."""
    from repro_torch.core import QueryTemplate
    from repro_torch.core.maintenance import MaintenanceConfig, SampleMaintainer
    from repro_torch.data import synth
    t_phase = time.perf_counter()
    db = mutation_engine(main_db)
    queries = mutation_queries()
    tbl = db.tables["sessions"]

    def delta_new_city():
        raw = synth.sessions_table(50_000, seed=12)
        raw["City"] = np.full(50_000, NEW_CITY)
        return raw

    from repro_torch.core import Atom, CmpOp, Predicate
    maint = SampleMaintainer(
        db, "sessions", conviva_templates(QueryTemplate),
        MaintenanceConfig(base_compact_threshold=0.1, decay_ratio=1.2,
                          compact_threshold=0.05))
    steps = [
        ("(a) append 1M rows",
         lambda: db.append_rows("sessions",
                                synth.sessions_table(1_000_000, seed=11))),
        (f"(b) append 50000 rows of City={NEW_CITY}",
         lambda: db.append_rows("sessions", delta_new_city())),
        ("(c) delete WHERE dt<6",
         lambda: db.delete_rows("sessions", Predicate.where(
             Atom("dt", CmpOp.LT, 6)))),
        ("(d) update WHERE Genre=genre03 SET Bitrate=1000",
         lambda: db.update_rows("sessions", Predicate.where(
             Atom("Genre", CmpOp.EQ, "genre03")), {"Bitrate": 1000.0})),
        ("(e) SampleMaintainer.reclaim()", maint.reclaim),
    ]
    worst, by_g, by_t, out = {}, {}, {}, {"steps": []}
    covered = total = n_batch = n_fresh = 0
    reset_launches()
    for label, step in steps:
        if label.startswith("(e)"):
            before_reclaim = {phi: db._striped_for("sessions", phi)
                              for phi in (("URL",), ())}
        seconds = {}
        db._sync()
        t0 = time.perf_counter()
        with host_seconds(torch, db.device, seconds):
            rep = step()
        db._sync()
        step_s = time.perf_counter() - t0
        blocks = {phi: db._striped_for("sessions", phi)
                  for phi in db.families["sessions"]}
        restriped = getattr(rep, "restriped", None)
        log(f"  {label}: host {step_s:.3f}s; rows {tbl.n_rows} live "
            f"{tbl.n_live}; " + "; ".join(
                f"{k} " + "+".join(f"{v:.3f}" for v in vs) + "s"
                for k, vs in seconds.items())
            + (f"; restriped {restriped}" if restriped is not None else "")
            + (f"; base rows dropped {rep['base_compacted']}, strata decayed "
               + str({p: len(v) for p, v in rep["decayed"].items()})
               + f", families compacted {rep['compacted']}"
               if isinstance(rep, dict) else ""))
        log("    blocks: " + "; ".join(
            f"{phi} rows={b.n_rows} slots={b.n_local} ghosts={b.n_ghosts} "
            f"ghost_fraction={b.ghost_fraction:.4f} strata="
            f"{db.families['sessions'][phi].n_distinct} bytes="
            f"{b.device_bytes()}" for phi, b in blocks.items()))
        hold_prefix_ids(torch, np, db, label)
        answers = []
        with checked_launches(torch, worst, MUTATION_KERNELS), \
                launches_by_groups(by_g, by_table=by_t):
            for qlabel, q in queries:
                before = launch_counts()
                ans = db.query(q)
                launched = launches_since(before)
                exact = db.exact_query(q)
                if not exact.groups:
                    if ans.groups:
                        raise AssertionError(f"{qlabel}: groups where no "
                                             f"live row matches")
                    log(f"  {qlabel}: no live row matches; the answer has "
                        f"no group (family={ans.sample_phi})")
                else:
                    covered += hold_to_exact(torch, np, db, qlabel, q, ans,
                                             [], launched)
                    total += len(ans.groups)
                if NEW_CITY in qlabel and exact.groups:
                    truth = float(np.sum(
                        (tbl.host_column("City") == tbl.encode_value(
                            "City", NEW_CITY)) & (tbl.live if tbl.live
                                                  is not None else True)))
                    if abs(ans.groups[0].estimate - truth) > 1e-3 or \
                            exact.groups[0].estimate != truth:
                        raise AssertionError(
                            f"{qlabel}: {ans.groups[0].estimate!r}, exact "
                            f"{exact.groups[0].estimate!r}, live {truth}")
                answers.append(((qlabel, q), ans))
            batched = db.query_batch([q for (_, q), _ in answers])
            for ((qlabel, q), _), a in zip(answers, batched):
                if answer_bits(a) != answer_bits(db.query(q)):
                    raise AssertionError(f"{label} {qlabel}: query_batch "
                                         f"and query() differ")
                n_batch += 1
        if label.startswith("(d)"):
            saved = launch_counts()   # comparison launches stay out
            n_fresh = hold_fresh_stripe(torch, np, db, answers)
            reset_launches(saved)
        out["steps"].append({"label": label, "seconds": step_s,
                             "host": seconds, "restriped": restriped})
    launches = launch_counts()
    # COUNT GROUP BY OS (G = 6) over the blocks before and after (e); the
    # timing launches stay out of the counts
    compaction = compaction_times(torch, np, db, queries[0][1],
                                  before_reclaim)
    reset_launches(launches)
    if device == "cuda" and min(launches[k] for k in MUTATION_KERNELS) == 0:
        raise AssertionError(f"phase 3f launched a kernel no time: "
                             f"{launches}")
    if covered < 0.9 * total:
        raise AssertionError(f"only {covered}/{total} groups within 2 CI "
                             f"half-widths of exact_query")
    log("  launches by G: " + "; ".join(
        f"{k} " + " ".join(f"G={g}:{c}" for g, c in sorted(by_g.get(k, {}).items()))
        for k in BY_GROUPS))
    log("  launches by table route: " + "; ".join(
        f"{k} " + " ".join(f"{w}:{c}" for w, c in sorted(v.items()))
        for k, v in by_t.items()))
    for phi, sides in compaction.items():
        log(f"  fused kernel on family {phi} (COUNT GROUP BY OS at K1, "
            f"{db._striped_for('sessions', phi).n_local} slots), medians of "
            f"5 alternating turns: " + "; ".join(
                f"{side} (e) {t['ms']:.4f} ms event, {t['device_ms']:.4f} ms "
                f"device, {t['occupied']} occupied slots, {t['ghosts']} "
                f"ghosts, plain {t['plain_ms']:.4f}, bound {t['bound_ms']:.4f}"
                for side, t in sides.items())
            + f"; device ratio after/before "
            f"{sides['after']['device_ms'] / sides['before']['device_ms']:.4f}")
    out.update(launches=launches, by_groups=by_g, by_table=by_t,
               worst=worst, compaction=compaction,
               seconds=time.perf_counter() - t_phase)
    fr = max((w[0] for w in worst.get("agg_scan_fused", {}).values()),
             default=0.0)
    log(f"phase 3f ok: {len(steps)} steps, {len(steps) * len(queries)} "
        f"queries, {covered}/{total} groups within the rule, query_batch = "
        f"query() for {n_batch}, {n_fresh} answers equal on a fresh stripe; "
        f"launches " + " ".join(f"{k}={launches[k]}" for k in MUTATION_KERNELS)
        + f"; fused vs plain max_abs_diff {fr:.6e}; "
        f"{out['seconds']:.1f}s")
    del db
    torch.cuda.empty_cache() if device == "cuda" else None
    return out


# ---------------------------------------------------------------- phase 3g

SERVING_KERNELS = ("agg_scan_fused", "quantile_scan", "agg_scan")
_OPS_TEXT = {"EQ": "=", "NE": "!=", "LT": "<", "LE": "<=", "GT": ">",
             "GE": ">="}


def blinkql_text(q) -> str:
    """A Query as a BlinkQL statement (the parser's grammar)."""
    from repro_torch.core import AggOp, ErrorBound, TimeBound
    col = q.value_column
    agg = {AggOp.COUNT: "COUNT(*)", AggOp.SUM: f"SUM({col})",
           AggOp.AVG: f"AVG({col})",
           AggOp.QUANTILE: f"QUANTILE({col}, {q.quantile:g})"}[q.agg]
    text = f"SELECT {agg} FROM {q.table}"
    disj = [" AND ".join(
        f"{a.column} {_OPS_TEXT[a.op.name]} "
        + (f"'{a.value}'" if isinstance(a.value, str) else f"{a.value:g}")
        for a in conj.atoms) for conj in q.predicate.disjuncts if conj.atoms]
    if disj:
        text += " WHERE " + " OR ".join(disj)
    if q.group_by:
        text += f" GROUP BY {q.group_by[0]}"
    b = q.bound
    if isinstance(b, ErrorBound):
        eps = f"{b.eps * 100:g}%" if b.relative else f"{b.eps:g}"
        text += f" ERROR WITHIN {eps} CONFIDENCE {b.confidence * 100:g}%"
    elif isinstance(b, TimeBound):
        text += (f" WITHIN {b.seconds:g} SECONDS CONFIDENCE "
                 f"{b.confidence * 100:g}%")
    return text


def stage_seconds(tr) -> dict:
    """A trace's stages (QueryTrace.timings: outermost spans per stage, so a
    plan's pilot scans count in both plan and scan), with plan_host (plan
    less the scans inside it), scan_host (scan spans less the launches'
    synchronised time, which the spans' elapsed_s measure) and untraced
    (total less plan, the scans outside plan and estimate)."""
    t = dict(tr.timings())
    stage_of = [s.name.split(".", 1)[0] for s in tr.spans]

    def inside(s, stage):
        p = s.parent
        while p >= 0:
            if stage_of[p] == stage:
                return True
            p = tr.spans[p].parent
        return False
    outer_scans = [s for s in tr.spans if stage_of[s.index] == "scan"
                   and not inside(s, "scan")]
    in_plan = sum(s.dur_s for s in outer_scans if inside(s, "plan"))
    t["plan_host"] = t.get("plan", 0.0) - in_plan
    t["scan_elapsed"] = sum(s.attrs.get("elapsed_s", 0.0)
                            for s in outer_scans)
    t["untraced"] = t["total"] - t.get("plan", 0.0) - (
        t.get("scan", 0.0) - in_plan) - t.get("estimate", 0.0)
    t["scans"] = len(outer_scans)
    return t


def trace_phase3(torch, np, db, queries) -> dict:
    """Phase 3's queries traced, cold (ELP decision and latency model
    cleared) and warm: each traced answer bit-identical to an untraced
    query() on the same engine right beside it (after the cold trace it
    replays the decision the trace made). Logs each run's stages."""
    from repro_torch.obs.trace import QueryTrace, activate
    out = {"same": 0, "stages": {}}
    for label, q in queries:
        for run in ("cold", "warm"):
            if run == "cold":
                db._elp_cache.clear()
                db._latency.clear()
            else:
                plain = db.query(q)
            tr = QueryTrace(label, "forced")
            db._sync()
            with activate(tr):
                traced = db.query(q)
            db._sync()
            tr.finish()
            if run == "cold":
                plain = db.query(q)
            if answer_bits(traced) != answer_bits(plain):
                raise AssertionError(f"{label} [{run}]: traced and untraced "
                                     f"answers differ")
            out["same"] += 1
            st = stage_seconds(tr)
            out["stages"][f"{label} [{run}]"] = st
            log(f"    {label} [{run}]: " + " ".join(
                f"{k}_ms={1e3 * st[k]:.3f}" for k in
                ("total", "plan", "plan_host", "scan", "scan_elapsed",
                 "estimate", "untraced") if k in st)
                + f" scans={st['scans']}")
    return out


def fault_queries():
    """(label, Query) of phase 3g's fault plans: grouped and ungrouped
    sums, a predicate on the City family, a QUANTILE (moments per shard,
    the histogram unsharded) and the 130-city NOT IN template (agg_scan
    per shard)."""
    from repro_torch.core import (AggOp, Atom, CmpOp, ErrorBound, Predicate,
                                  Query)
    t = "sessions"
    return [
        ("COUNT(*) ERROR 10%", Query(t, AggOp.COUNT,
                                     bound=ErrorBound(0.10))),
        ("SUM(SessionTime) GROUP BY OS ERROR 5%",
         Query(t, AggOp.SUM, "SessionTime", group_by=("OS",),
               bound=ErrorBound(0.05))),
        ("AVG(SessionTime) GROUP BY City ERROR 10%",
         Query(t, AggOp.AVG, "SessionTime", group_by=("City",),
               bound=ErrorBound(0.10))),
        ("QUANTILE(SessionTime, 0.9) GROUP BY OS ERROR 5%",
         Query(t, AggOp.QUANTILE, "SessionTime", quantile=0.9,
               group_by=("OS",), bound=ErrorBound(0.05))),
        ("AVG(SessionTime) WHERE City NOT IN (130 cities) ERROR 5%",
         Query(t, AggOp.AVG, "SessionTime",
               predicate=not_in(Atom, CmpOp, Predicate, "City", "city", 200,
                                130),
               bound=ErrorBound(0.05))),
    ]


def fault_plans():
    """(label, FaultPlan factory) of phase 3g, each on the engine's 4
    logical shards of 2 replicas over 2 processes."""
    from repro_torch.fault.inject import FaultPlan, FaultSpec

    def plan(*specs):
        return lambda: FaultPlan(list(specs), seed=0)
    return {
        "clean": plan(FaultSpec(site="shard.scan", kind="kill",
                                match=(("shard", 99),))),
        "replica0": plan(FaultSpec(site="shard.scan", kind="kill",
                                   match=(("replica", 0),))),
        "shard1_lost": plan(FaultSpec(site="shard.scan", kind="kill",
                                      match=(("shard", 1),))),
        "poison2": plan(FaultSpec(site="shard.scan", kind="poison",
                                  match=(("shard", 2),))),
        "process0": plan(FaultSpec(site="shard.scan", kind="kill",
                                   match=(("process", 0),))),
        "all_lost": plan(FaultSpec(site="shard.scan", kind="kill")),
    }


def run_faults(torch, np, db, worst) -> dict:
    """Phase 3g's fault plans on phase 3's engine and blocks (decisions
    replayed from a clean run, so every plan scans at the same K): the
    clean sharded scan within the reference's tolerance of the fused one,
    replica-0 kills and a process kill bit-identical to the clean sharded
    scan, one shard lost on every replica degraded with reweight 4/3 and
    (COUNT, SUM, AVG) no CI narrower than the clean sharded one, a poison
    detected, all
    shards lost raising AllShardsLostError, and an empty plan bit-identical
    to the clean path. Every launch is held against its plain version."""
    from repro_torch.core import AggOp
    from repro_torch.fault.inject import AllShardsLostError, FaultPlan, arm
    from repro_torch.obs.trace import QueryTrace, activate
    plans = fault_plans()
    out = {"per_shard": {}, "checks": 0}
    for label, q in fault_queries():
        clean = db.query(q)
        with arm(FaultPlan()):
            empty = db.query(q)
        if answer_bits(empty) != answer_bits(clean):
            raise AssertionError(f"{label}: the empty plan changed bits")
        if clean.sample_phi == ("<exact>",):
            log(f"    {label}: exact fallback (no sample scan to shard); "
                f"empty plan bit-identical")
            continue
        got, traces = {}, {}
        with checked_launches(torch, worst, names=SERVING_KERNELS):
            for name, make in plans.items():
                tr = QueryTrace(f"{label} {name}", "fault")
                with arm(make()), activate(tr):
                    try:
                        got[name] = db.query(q)
                    except AllShardsLostError:
                        got[name] = "AllShardsLostError"
                tr.finish()
                traces[name] = tr
        sharded = got["clean"]
        if sharded.shards_total != 4 or sharded.degraded:
            raise AssertionError(f"{label}: the clean plan did not shard")
        rel = max(abs(a.estimate - b.estimate) / max(abs(b.estimate), 1e-12)
                  for a, b in zip(sharded.groups, clean.groups))
        if [g.key for g in sharded.groups] != \
                [g.key for g in clean.groups] or rel > 1e-4:
            raise AssertionError(f"{label}: clean sharded scan off the "
                                 f"fused one by rtol {rel}")
        for name in ("replica0", "process0"):
            if answer_bits(got[name]) != answer_bits(sharded):
                raise AssertionError(f"{label}: {name} fail-over changed "
                                     f"bits")
        lost = got["shard1_lost"]
        reweights = {s.attrs.get("reweight") for s in
                     traces["shard1_lost"].find("scan")
                     if "reweight" in s.attrs}
        if lost.shards_lost != 1 or not lost.degraded \
                or reweights != {4 / 3}:
            raise AssertionError(f"{label}: shard loss gave lost="
                                 f"{lost.shards_lost} reweights={reweights}")
        # COUNT, SUM and AVG: the reweight grows every variance leaf, so no
        # CI narrows. A QUANTILE's CI is read off the survivors' Kish
        # effective size, which a lost shard of heavy-weight rows can
        # raise: logged, not held.
        ref_se = {g.key: g.stderr for g in sharded.groups}
        ratios = [g.stderr / ref_se[g.key] for g in lost.groups
                  if g.key in ref_se and ref_se[g.key] > 0]
        narrower = [g.key for g in lost.groups
                    if g.key in ref_se and g.stderr < ref_se[g.key]]
        if narrower and q.agg is not AggOp.QUANTILE:
            raise AssertionError(f"{label}: shard loss narrowed the CI of "
                                 f"{narrower[:5]}")
        poison = got["poison2"]
        caught = [s for s in traces["poison2"].find("scan.shard")
                  if s.attrs.get("error") == "ShardScanError"]
        if not poison.degraded or not caught or not all(
                np.isfinite([g.estimate, g.stderr]).all()
                for g in poison.groups):
            raise AssertionError(f"{label}: the poison was not contained")
        if got["all_lost"] != "AllShardsLostError":
            raise AssertionError(f"{label}: all shards lost did not raise")
        per = out["per_shard"].setdefault(label, {})
        for name, tr in traces.items():
            for s in tr.find("scan.shard"):
                if s.attrs.get("error") != "InjectedFault":
                    per[s.attrs["shard"]] = per.get(s.attrs["shard"], 0) + 1
        out["checks"] += 1
        out["rel"] = max(out.get("rel", 0.0), rel)
        # Host ms of the query on the fused path and under three plans,
        # medians of 3, outside the plain-version checks; these launches
        # stay out of the counts.
        saved = launch_counts()
        ms = {}
        for name in ("fused", "clean", "replica0", "shard1_lost"):
            runs = []
            for _ in range(3):
                db._sync()
                t0 = time.perf_counter()
                if name == "fused":
                    db.query(q)
                else:
                    with arm(plans[name]()):
                        db.query(q)
                db._sync()
                runs.append(1e3 * (time.perf_counter() - t0))
            ms[name] = float(np.median(runs))
        reset_launches(saved)
        out.setdefault("ms", {})[label] = ms
        log(f"    {label}: family={clean.sample_phi} K={clean.sample_k:.6g} "
            f"clean sharded within rtol {rel:.3e}; replica0/process0 "
            f"bit-identical; "
            f"shard1 lost={lost.shards_lost} degraded={lost.degraded} "
            f"groups={len(lost.groups)}/{len(sharded.groups)} stderr ratio "
            f"{min(ratios, default=1.0):.4f}-{max(ratios, default=1.0):.4f}"
            f" ({len(narrower)} narrower); poison "
            f"caught={len(caught)} lost={poison.shards_lost}; all lost "
            f"raised; launches by shard {dict(sorted(per.items()))}; query "
            f"ms " + " ".join(f"{k}={v:.3f}" for k, v in ms.items()))
    totals: dict = {}
    for per in out["per_shard"].values():
        for s, n in per.items():
            totals[s] = totals.get(s, 0) + n
    out["attempts_by_shard"] = dict(sorted(totals.items()))
    return out


def run_service(torch, np, db, texts, card: str) -> dict:
    """Phase 3b's queries as BlinkQL text from 8 session threads through
    submit (threads 0, 2, 4, 6: their queries one at a time) and
    submit_many (threads 1, 3, 5, 7: their slice at once), each answer
    bit-identical to query() of its parsed statement on the same engine;
    then every text again through submit_many, all from the cache; EXPLAIN
    and SHOW METRICS. Returns latencies, batches and launches."""
    from repro_torch.service import BlinkQLService, ServiceConfig, \
        parse_blinkql
    slices = [texts[i::8] for i in range(8)]
    lat: list[float] = []
    answers: dict[str, object] = {}
    errors: list = []
    lock = threading.Lock()
    with BlinkQLService(db, config=ServiceConfig(batch_window_s=0.005)) as svc:
        barrier = threading.Barrier(8)

        def session(i):
            try:
                barrier.wait()
                if i % 2:
                    t0 = time.perf_counter()
                    got = svc.submit_many(slices[i], timeout=600)
                    dt = time.perf_counter() - t0
                    with lock:
                        lat.extend([dt] * len(got))
                        answers.update(zip(slices[i], got))
                else:
                    for text in slices[i]:
                        t0 = time.perf_counter()
                        a = svc.submit(text, timeout=600)
                        with lock:
                            lat.append(time.perf_counter() - t0)
                            answers[text] = a
            except BaseException as e:   # noqa: BLE001 — re-raised below
                errors.append(e)
        threads = [threading.Thread(target=session, args=(i,),
                                    name=f"session-{i}") for i in range(8)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"a session failed or hung: {errors[:1]}")
        stats = svc.stats()
        hits0 = svc.cache.stats.hits
        again = svc.submit_many(texts, timeout=600)
        hits = svc.cache.stats.hits - hits0
        rep = svc.execute("EXPLAIN " + texts[0])
        snap = svc.execute("SHOW METRICS")
        prom = svc.execute("SHOW METRICS FORMAT PROMETHEUS")
    same = 0
    for text in texts:
        want = db.query(parse_blinkql(text, db).normalized())
        for a in (answers[text], again[texts.index(text)]):
            if answer_bits(a) != answer_bits(want):
                raise AssertionError(f"service answer differs from "
                                     f"query(): {text[:120]}")
        same += 1
    if hits != len(texts):
        raise AssertionError(f"repeats: {hits}/{len(texts)} cache hits")
    if not rep["plan"].get("cached") or snap.get("schema_version") != 1 \
            or "service_queries_total" not in prom:
        raise AssertionError("EXPLAIN or SHOW METRICS did not answer")
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    # Each statement carries a contract (ERROR WITHIN), so each is traced:
    # its stages from parse to estimate, the median and the largest.
    stages = {}
    for text in texts:
        for k, v in (answers[text].timings or {}).items():
            stages.setdefault(k, []).append(1e3 * v)
    out = {"same": same, "wall_s": wall, "qps": len(texts) / wall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)), "stats": stats,
           "cache_hits": hits,
           "stages_ms": {k: (float(np.median(v)), float(np.max(v)))
                         for k, v in stages.items()}}
    log("  service stages (ms, median / max over the statements): " + " ".join(
        f"{k}={m:.3f}/{x:.3f}" for k, (m, x) in out["stages_ms"].items()))
    log(f"  service: {len(texts)} BlinkQL statements from 8 sessions in "
        f"{1e3 * wall:.3f} ms ({out['qps']:.3f} qps), submit latency p50 "
        f"{out['p50_ms']:.3f} ms p99 {out['p99_ms']:.3f} ms, batches "
        f"{stats['batches']} (coalescing {stats['coalescing']:.3f}), "
        f"{same}/{len(texts)} answers bit-identical to query(), repeats "
        f"{hits}/{len(texts)} from the cache; EXPLAIN plan {rep['plan']}; "
        f"SHOW METRICS {len(snap['counters'])} counters ({card})")
    return out


def phase_serving(torch, np, main, card: str, device="cuda") -> dict:
    """Tracing, fault plans and the BlinkQL service on phase 3's engine and
    blocks. Each part runs with the launch counts set to 0 just before it
    and read just after: (a) phase 3's 16 queries traced cold and warm
    (trace_phase3), (b) the fault plans (run_faults), every launch held
    against its plain version, (c) phase 3b's 36 queries through
    BlinkQLService (run_service), launches by G and by Q."""
    from repro_torch.core import (AggOp, Atom, CmpOp, Conjunction,
                                  ErrorBound, Predicate, Query, TimeBound)
    t_phase = time.perf_counter()
    db = main["db"]
    db.check = False
    out = {}
    queries = main_path_queries(Query, AggOp, Atom, CmpOp, Conjunction,
                                Predicate, ErrorBound, TimeBound)
    log(f"  (a) phase 3's {len(queries)} queries traced, cold and warm "
        f"(stages in ms, host clock, device synchronised; {card}):")
    reset_launches()
    traced = trace_phase3(torch, np, db, queries)
    out["traced_launches"] = launch_counts()
    # The host search behind each scan's rows_read, per family.
    prefix_ms = {}
    for phi, fam in db.families["sessions"].items():
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            fam.prefix_for_k(fam.ks[0])
            runs.append(1e3 * (time.perf_counter() - t0))
        prefix_ms[phi] = float(np.median(runs))
        log(f"  SampleFamily.prefix_for_k on {phi} ({fam.n_rows} keys): "
            f"{prefix_ms[phi]:.3f} ms (host, median of 5)")
    out["prefix_for_k_ms"] = {str(phi): ms for phi, ms in prefix_ms.items()}

    log("  (b) fault plans, 4 logical shards x 2 replicas over 2 processes:")
    worst = {}
    reset_launches()
    faults = run_faults(torch, np, db, worst)
    out["fault_launches"] = launch_counts()

    texts = [blinkql_text(q) for q in batch_queries(
        Query, AggOp, Atom, CmpOp, Predicate, ErrorBound)]
    reset_launches()
    by_g, by_q = {}, {}
    with launches_by_groups(by_g, by_q):
        service = run_service(torch, np, db, texts, card)
    out["service_launches"] = launch_counts()
    for part in ("traced_launches", "fault_launches", "service_launches"):
        if device == "cuda" and min(out[part][k]
                                    for k in SERVING_KERNELS) == 0:
            raise AssertionError(f"phase 3g {part}: a kernel was launched "
                                 f"no time: {out[part]}")
    log("  service launches by G: " + "; ".join(
        f"{k} " + " ".join(f"G={g}:{c}" for g, c in sorted(by_g.get(k, {}).items()))
        for k in BY_GROUPS) + "; agg_scan_fused by Q: " + " ".join(
        f"Q={q}:{c}" for q, c in sorted(by_q.items())))
    out.update(traced=traced, faults=faults, service=service, worst=worst,
               service_by_groups=by_g, service_by_queries=by_q,
               seconds=time.perf_counter() - t_phase)
    fr = max((w[0] for w in worst.get("agg_scan_fused", {}).values()),
             default=0.0)
    log(f"phase 3g ok: {traced['same']} traced answers bit-identical, "
        f"{faults['checks']} queries under {len(fault_plans())} plans, "
        f"{service['same']} service answers bit-identical; launches traced "
        + " ".join(f"{k}={out['traced_launches'][k]}"
                   for k in SERVING_KERNELS)
        + ", faults " + " ".join(f"{k}={out['fault_launches'][k]}"
                                 for k in SERVING_KERNELS)
        + ", service " + " ".join(f"{k}={out['service_launches'][k]}"
                                  for k in SERVING_KERNELS)
        + f"; per-shard fused vs plain max_abs_diff {fr:.6e}; "
        f"{out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------- phase 3h

MESH_WORLDS = (2, 4)
MESH_KERNELS = ("agg_scan_fused", "quantile_scan", "agg_scan")
# The mesh's own table: phase 3's table and families (20M rows) made the
# phase take 167.3 s (two worlds, two runs each, every launch held to
# plain), past its ~120 s; cut to a quarter, K1 at phase 3's ratio.
MESH_ROWS, MESH_K1 = 5_000_000, 25_000.0


def mesh_source(db, path: str) -> None:
    """Pickle db's sessions table (its host columns) and families for the
    ranks."""
    import pickle
    from repro_torch.core import table as table_lib
    tbl = db.tables["sessions"]
    host = table_lib.Table(tbl.schema, tbl.columns_host, tbl.dictionaries,
                           tbl.n_rows, live=tbl.live)
    with open(path, "wb") as f:
        pickle.dump((host, dict(db.families["sessions"])), f,
                    protocol=pickle.HIGHEST_PROTOCOL)


def mesh_session(main, path: str, device: str, runs: int):
    """Phase 3h's workload, the same on every rank, `runs` times from
    scratch: phase 3's 16 queries, one QUANTILE GROUP BY, 12 of phase 3b's
    batch through query_batch, one subsampled CI, and an append of 50,000
    rows followed by two queries; every launch held against its plain
    version."""
    from repro_torch.core import (AggOp, Atom, CmpOp, ErrorBound, Predicate,
                                  Query)
    from repro_torch.data import synth
    from repro_torch.launch import mesh as mesh_lib
    t = "sessions"
    step = mesh_lib.Step
    return mesh_lib.Session(t, {"k1": MESH_K1}, (
        step("main", "query", tuple(q for _, q, _ in main["results"])),
        step("quantile", "query", (Query(
            t, AggOp.QUANTILE, "SessionTime", quantile=0.5,
            group_by=("City",), bound=ErrorBound(0.10)),)),
        step("batch", "batch", tuple(batch_queries(
            Query, AggOp, Atom, CmpOp, Predicate, ErrorBound)[:12])),
        step("subsampled", "subsampled", (Query(
            t, AggOp.AVG, "SessionTime", group_by=("OS",),
            bound=ErrorBound(0.10)),)),
        step("append", "append", (
            Query(t, AggOp.COUNT, group_by=("OS",), bound=ErrorBound(0.10)),
            Query(t, AggOp.AVG, "SessionTime", bound=ErrorBound(0.05),
                  predicate=Predicate.where(
                      Atom("City", CmpOp.EQ, "city007")))),
             rows=synth.sessions_table(50_000, seed=11))),
        source=path, device=device, runs=runs, check_plain=True)


def hold_mesh_to_one(np, db, session, one, run) -> dict:
    """A mesh run's answers against one device's on the same session:
    family always, K and group keys except under WITHIN SECONDS (which
    refits its latency model); estimates within rtol 1e-4, a QUANTILE also
    within one bin of its family's histogram range. Counts what held how."""
    from repro_torch.core import AggOp, TimeBound
    out = {"rtol": 0, "bin": 0, "time_bound": 0}
    for step, (label, want), (_, got) in zip(session.steps, one, run,
                                             strict=True):
        for q, w, g in zip(step.queries, want, got, strict=True):
            if g[0] != w[0]:
                raise AssertionError(f"mesh {label} {q}: family {g[0]} != "
                                     f"{w[0]}")
            if isinstance(q.bound, TimeBound):
                out["time_bound"] += 1
                continue
            if g[1] != w[1] or [x[0] for x in g[7]] != [x[0] for x in w[7]]:
                raise AssertionError(f"mesh {label} {q}: K {g[1]} vs {w[1]} "
                                     f"or group keys differ")
            bin_w = 0.0
            if q.agg is AggOp.QUANTILE and w[0] != ("<exact>",):
                lo, hi = db._family_range("sessions", w[0], q.value_column)
                bin_w = (hi - lo) / 256.0
            for gx, wx in zip(g[7], w[7]):
                if np.isclose(gx[1], wx[1], rtol=1e-4, atol=0.0):
                    out["rtol"] += 1
                elif abs(gx[1] - wx[1]) <= bin_w:
                    out["bin"] += 1
                else:
                    raise AssertionError(
                        f"mesh {label} {q} group {gx[0]}: {gx[1]!r} vs one "
                        f"device's {wx[1]!r}")
    return out


def stripe_times(torch, db, card: str) -> dict:
    """Each engine-path kernel on a rank's stripe (shard 0 of S = 2 and 4)
    of phase 3's 20M-row families beside the whole block (S = 1), at one
    main-path shape each: ms by CUDA events over 20 launches (the
    wrapper's host work included), device ms by torch.profiler, the plain
    version, the bound."""
    from repro_torch.core import AggOp, Atom, CmpOp, Predicate, Query
    from repro_torch.core import executor as exec_lib
    from repro_torch.kernels import agg_scan, ref
    t = "sessions"
    fused_q = timed_queries()[0][0]
    quant_q = timed_queries()[1][0]
    wide_q = ("COUNT(*) WHERE URL NOT IN (200 URLs) GROUP BY OS",
              Query(t, AggOp.COUNT, group_by=("OS",), predicate=not_in(
                  Atom, CmpOp, Predicate, "URL", "url", 500, 200)))
    out = {name: [] for name in MESH_KERNELS}
    for n_shards in (1,) + MESH_WORLDS:
        for name, (label, q) in (("agg_scan_fused", fused_q),
                                 ("quantile_scan", quant_q),
                                 ("agg_scan", wide_q)):
            phi = ("URL",) if name == "agg_scan" else db._select_phi(t, q)
            k = db.families[t][phi].ks[0]
            striped = exec_lib.stripe_family(db.families[t][phi], db.device,
                                             n_shards=n_shards, shard=0)
            args, struct, slots, g = kernel_args(torch, db, q, phi, k,
                                                 striped)
            if name == "agg_scan_fused":
                fn = functools.partial(agg_scan.agg_scan_fused_cuda, *args,
                                       struct, slots, g)
                plain = functools.partial(ref.agg_scan_fused_ref, *args,
                                          struct, slots, g)
                out_t = fn()
                bnd = bound_for(args, struct, out_t, 4 * out_t.numel())
            elif name == "quantile_scan":
                lo, hi = db._family_range(t, phi, q.value_column)
                qargs = (*args[:-1], lo, hi, args[-1])
                fn = functools.partial(agg_scan.quantile_scan_cuda, *qargs,
                                       struct, slots, g)
                plain = functools.partial(ref.quantile_scan_ref, *qargs,
                                          struct, slots, g)
                mom, hist = fn()
                bnd = bound_for(args, struct, mom,
                                4 * (mom.numel() + hist.numel()))
            else:
                key, vals = db._scan_key(t, q, phi)
                k_t = torch.tensor(k, dtype=torch.float32, device=db.device)
                pred = exec_lib.eval_pred_flat(
                    key[2], striped.columns, torch.tensor(
                        exec_lib.flatten_pred_vals(vals),
                        dtype=torch.float32, device=db.device))
                freq, sel = exec_lib.query_selection(
                    pred, k_t, *exec_lib.scan_args(striped)[1:])
                inputs = exec_lib.agg_scan_inputs(sel, freq, k_t,
                                                  striped.columns, None,
                                                  "OS")
                fn = functools.partial(agg_scan.agg_scan_cuda, *inputs, g)
                plain = functools.partial(ref.agg_scan_ref, *inputs, g)
                out_t = fn()
                bnd = bound(nbytes(*inputs, out_t),
                            20.0 * float(out_t[0].sum()))
            ms = time_cuda(torch, fn, warmup=3, reps=20)
            dev = device_ms(torch, fn, 20)
            plain_ms = time_cuda(torch, plain, warmup=1, reps=3)
            log_time(name, f"{label} family={phi} S={n_shards} shard 0",
                     striped, g, ms, plain_ms, bnd, card,
                     extra=f" device_ms={dev:.4f}")
            out[name].append({"S": n_shards, "label": label,
                              "slots": striped.n_local, "G": g, "ms": ms,
                              "device_ms": dev, "plain_ms": plain_ms,
                              "bound_ms": bnd[0], "bound_by": bnd[1],
                              "library_ms": None})
    return out


def log_steps(who: str, seconds) -> None:
    """A session run's seconds by step (host clock, device synchronised;
    the scan spans hold the launches, their plain versions and the
    gathers)."""
    for label, sec in seconds:
        log(f"    {who}, step {label}: wall_ms={1e3 * sec['wall_s']:.3f} "
            f"scan_ms={1e3 * sec['scan_s']:.3f} gather_ms="
            f"{1e3 * sec['gather_s']:.3f} gathers={sec['gathers']} "
            f"host_ms={1e3 * (sec['wall_s'] - sec['scan_s']):.3f}")


def phase_mesh(torch, np, main, card: str, device="cuda") -> dict:
    """BlinkDB(mesh=) over torch.distributed on the one card. Its table
    (MESH_ROWS rows, K1 = MESH_K1; families City, URL, uniform) is built
    here and pickled for the ranks; mesh_session runs once on one device
    here, then in spawned worlds of 2 and 4 ranks (every rank on cuda:0,
    gloo carrying the partials), twice from scratch, each rank's launch
    counts at 0 from its start. Checks: every rank launched the fused,
    quantile and agg_scan kernels and held every launch to its plain
    version; the ranks' answers are equal in bits, and so are a world's
    two runs (WITHIN SECONDS aside); they hold to one device's
    (hold_mesh_to_one); every answer is finite. Then each kernel's times
    on a rank's stripe of phase 3's families (stripe_times)."""
    import tempfile
    from repro_torch.core import BlinkDB, TimeBound
    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.perf_counter()
    out = {"worlds": {}}
    time_bound = [isinstance(q.bound, TimeBound)
                  for _, q, _ in main["results"]]

    def steady(run):
        """A run without its WITHIN SECONDS answers."""
        return [(label, [a for a, tb in zip(recs, time_bound) if not tb]
                 if label == "main" else recs) for label, recs in run]

    with tempfile.TemporaryDirectory(prefix="phase3h-") as tmp:
        path = f"{tmp}/sessions.pkl"
        t0 = time.perf_counter()
        db, _, _, _ = sessions_engine(
            lambda config, device: BlinkDB(
                dataclasses.replace(config, k1=MESH_K1), device=device),
            MESH_ROWS, device)
        mesh_source(db, path)
        log(f"  cut: {MESH_ROWS} base rows, K1 = {MESH_K1:.0f} (phase 3's "
            f"20M rows took this phase past ~120 s); table and families "
            f"built and pickled for the ranks in "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        one = mesh_lib.run_session(mesh_session(main, path, device, 1))
        one_run = one["runs"][0]
        log(f"  one device: the session in {time.perf_counter() - t0:.1f}s, "
            "launches " + " ".join(f"{k}={one['launches'][k]}"
                                   for k in MESH_KERNELS))
        log_steps("one device", one["seconds"][0])
        session = mesh_session(main, path, device, 2)
        for world in MESH_WORLDS:
            t0 = time.perf_counter()
            ranks = mesh_lib.run_ranks(mesh_lib.session_rank, world, session,
                                       timeout=400.0)
            wall = time.perf_counter() - t0
            for r, res in enumerate(ranks):
                for name in MESH_KERNELS:
                    n = res["launches"][name]
                    held = res["held"].get(name, [0.0, 0])
                    if (device == "cuda" and n == 0) or held[1] != n:
                        raise AssertionError(
                            f"world {world} rank {r}: {name} launched {n} "
                            f"times, {held[1]} held to its plain version")
                if res["runs"] != ranks[0]["runs"]:
                    raise AssertionError(f"world {world}: rank {r}'s "
                                         f"answers differ from rank 0's")
                for label, recs in res["runs"][0]:
                    for a in recs:
                        if not a[7] or not np.isfinite(
                                [g[1:5] for g in a[7]]).all():
                            raise AssertionError(
                                f"world {world} {label}: empty or "
                                f"non-finite answer")
            runs = ranks[0]["runs"]
            if steady(runs[0]) != steady(runs[1]):
                raise AssertionError(f"world {world}: the session's two "
                                     f"runs differ")
            held1 = hold_mesh_to_one(np, db, session, one_run, runs[0])
            n_answers = sum(len(recs) for _, recs in runs[0])
            log_steps(f"world {world} rank 0 second run",
                      ranks[0]["seconds"][1])
            worst = {name: max(res["held"].get(name, [0.0])[0]
                               for res in ranks) for name in MESH_KERNELS}
            log(f"  world {world}: {world} ranks on one card over gloo in "
                f"{wall:.1f}s; {n_answers} answers a run, equal bits on "
                f"every rank and in both runs; against one device: "
                f"{held1['rtol']} groups within rtol 1e-4, {held1['bin']} "
                f"within one bin, {held1['time_bound']} WITHIN SECONDS "
                f"by family; launches by rank "
                + " ".join(f"{k}={[res['launches'][k] for res in ranks]}"
                           for k in MESH_KERNELS)
                + "; held to plain, max |diff| "
                + " ".join(f"{k}={v:.6e}" for k, v in worst.items()))
            out["worlds"][world] = {
                "seconds": wall, "held": held1, "worst": worst,
                "launches": [res["launches"] for res in ranks],
                "steps": ranks[0]["seconds"]}
        del db
    out["stripe_times"] = stripe_times(torch, main["db"], card)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 3h ok: worlds {list(MESH_WORLDS)} on one card, every "
        f"rank's launches held to plain, answers equal across ranks and "
        f"runs and held to one device's; {out['seconds']:.1f}s")
    return out


# ----------------------------------------------------------------- phase 3i

LM_ARCH = "qwen2-1.5b"        # full width and depth: 28 layers, 1.54B params
LM_SERVE_ARGS = ["--arch", LM_ARCH, "--batch", "4", "--prompt-len", "16",
                 "--new-tokens", "32"]
LM_CUT_LAYERS = 2             # (c) and (e): the same widths, 2 layers
LM_BATCH, LM_PROMPT, LM_NEW = 8, 128, 64     # (d), the serving run


def hold_close(torch, label, got, want, rtol, atol) -> float:
    """Raise unless got is allclose to want; log the worst ratio."""
    ratio = tol_ratio(torch, got.float().cpu(), want.float().cpu(), rtol,
                      atol)
    log(f"  {label}: max |diff| "
        f"{(got.float().cpu() - want.float().cpu()).abs().max().item():.3e},"
        f" worst ratio {ratio:.3f} of rtol {rtol:g} / atol {atol:g}")
    if not ratio <= 1.0:
        raise AssertionError(f"{label}: outside rtol {rtol} / atol {atol} "
                             f"(ratio {ratio})")
    return ratio


@contextlib.contextmanager
def no_tf32(torch):
    """float32 products in float32 (TF32 off), the setting restored."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def lm_prompts(np, cfg, batch: int, length: int, seed: int):
    """Prompts [batch, length], or [batch, K, length] for K codebooks."""
    rng = np.random.default_rng(seed)
    shape = ((batch, cfg.n_codebooks, length) if cfg.n_codebooks
             else (batch, length))
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def timed_generate(torch, engine, prompts, n_new: int, vision=None):
    """(tokens, host seconds) of one ServeEngine.generate, device
    synchronised on both sides (generate ends in a device-to-host copy)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, n_new, vision)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve_twice(torch, np, engine, prompts, n_new: int, vocab: int,
                label: str, vision=None) -> dict:
    """(tokens, stats) of the LM phases' serving measurement: a first call
    (2 new), prefill as the median of three 1-new generates, then two
    n_new generates that must be bit-equal and in range; decode ms a step
    from the faster of them. tok/s counts B·n_new positions (with K
    codebooks, a position's K tokens as one)."""
    _, first_s = timed_generate(torch, engine, prompts, 2, vision)
    prefill_s = sorted(timed_generate(torch, engine, prompts, 1, vision)[1]
                       for _ in range(3))[1]
    run1, s1 = timed_generate(torch, engine, prompts, n_new, vision)
    run2, s2 = timed_generate(torch, engine, prompts, n_new, vision)
    if not np.array_equal(run1, run2):
        raise AssertionError(f"{label}: two bfloat16 runs differ")
    b, p = prompts.shape[0], prompts.shape[-1]
    if run1.shape != prompts.shape[:-1] + (p + n_new,) or run1.min() < 0 \
            or run1.max() >= vocab:
        raise AssertionError(f"{label}: tokens {run1.shape} out of range")
    gen_s = min(s1, s2)
    return run1, {"first_call_s": first_s, "prefill_ms": 1e3 * prefill_s,
            "decode_ms_per_step": 1e3 * (gen_s - prefill_s) / (n_new - 1),
            "generate_s": gen_s, "generate_runs_s": [s1, s2],
            "tok_per_s": b * n_new / gen_s}


def profiled_ms(torch, fn) -> tuple:
    """(device ms, wall ms, top kernels) of fn() under torch.profiler: the
    sum of the kernels' device time, the host clock around the call,
    device synchronised on both sides, and the eight kernels of most
    device time as (name, ms, launches). It traces the device only: the
    host's event bookkeeping of a CPU trace cost 12-25 s a call in the
    LM phases (PR 33), and ~10^5 launches minutes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and "CUDA" in str(e.device_type)]
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return dev_us / 1e3, 1e3 * wall, [
        (e.key, e.self_device_time_total / 1e3, e.count) for e in top]


def device_busy_share(torch, engine, prompts, n_new: int) -> tuple:
    """(device ms, wall ms) of one generate under torch.profiler."""
    return profiled_ms(torch, lambda: engine.generate(prompts, n_new))[:2]


def busy_text(dev_ms: float, wall_ms: float) -> str:
    return (f"{dev_ms:.3f} of {wall_ms:.3f} ms "
            f"({100 * dev_ms / wall_ms:.1f}%)" if dev_ms > 0
            else "not measured (the profiler saw no device time)")


def phase_lm_serving(torch, np, card: str, device="cuda") -> dict:
    """The LM substrate's serving path (repro_torch.models, .serve,
    .checkpoint, .launch.serve) on qwen2-1.5b at full width: (a) the model
    from a seeded generator on the card in float32; (b) float32 compute,
    TF32 off: prefill 64 + decode 64 against the teacher-forced forward
    over 128 (rtol/atol 2e-2); (c) the same widths cut to 2 layers, its
    float32 logits on the card against the CPU's (rtol/atol 1e-3) and
    greedy tokens equal; (d) ServeEngine.generate in the bfloat16 default
    at B = 8, P = 128, 64 new tokens, twice, bit-equal, every token in
    range: prefill ms, decode ms a step, tok/s, the device's busy share,
    and the share of tokens equal to float32 compute's; (e) the 2-layer
    cut through CheckpointManager and back, equal tokens; (f) python -m
    repro_torch.launch.serve as a user runs it."""
    import copy
    import os
    import tempfile
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.state import lm_params_from_reference
    from repro_torch.train.step import StepConfig

    @dataclasses.dataclass(frozen=True)
    class F32Step(StepConfig):
        @property
        def compute_dtype(self):
            return torch.float32

    t_phase = time.perf_counter()
    out = {}
    cfg = get_config(LM_ARCH)
    # (a) the model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    bias = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * cfg.qkv_bias
    extra = cfg.n_layers * (2 * cfg.d_model + bias) + cfg.d_model
    if n_params != cfg.param_count() + extra:   # + norms and QKV biases
        raise AssertionError(f"{n_params} parameters, not "
                             f"{cfg.param_count()} + {extra}")
    out["model"] = {"params": n_params, "bytes": n_bytes,
                    "build_s": time.perf_counter() - t0,
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"  (a) {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads (kv {cfg.n_kv_heads}, d_head {cfg.head_dim}), "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n_params} parameters, "
        f"{n_bytes} bytes float32, built in {out['model']['build_s']:.2f}s; "
        f"torch.cuda.max_memory_allocated "
        f"{out['model']['max_memory_allocated']}")

    # (b) the float32 path held to itself
    toks = torch.from_numpy(lm_prompts(np, cfg, 2, 128, 1)).to(device)
    t0 = time.perf_counter()
    with no_tf32(torch), torch.no_grad():
        full, _, _ = model_lib.forward(model, cfg, toks, "train",
                                       compute_dtype=torch.float32)
        caches = model_lib.init_cache(cfg, 2, 128, dtype=torch.float32,
                                      device=device)
        logits, caches = model_lib.prefill(model, cfg, toks[:, :64], caches,
                                           compute_dtype=torch.float32)
        steps = [logits]
        for t in range(64, 128):
            lg, caches, _ = model_lib.forward(model, cfg, toks[:, t:t + 1],
                                              "decode", caches, t,
                                              torch.float32)
            steps.append(lg)
        got = torch.cat(steps, dim=1)
    if not (torch.isfinite(full).all() and torch.isfinite(got).all()):
        raise AssertionError("(b): non-finite logits")
    out["f32_ratio"] = hold_close(
        torch, "(b) float32, TF32 off: prefill 64 + decode 64 against the "
        "forward over 128", got, full, 2e-2, 2e-2)
    del full, got, steps, caches, logits
    log(f"  (b) took {time.perf_counter() - t0:.2f}s")

    # (c) a 2-layer cut at full width: the card against the CPU
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS)
    cut_cpu = model_lib.init_params(cut, torch.Generator().manual_seed(1))
    cut_card = copy.deepcopy(cut_cpu).to(device)
    ctoks = lm_prompts(np, cut, 2, 32, 2)
    with no_tf32(torch), torch.no_grad():
        want, _, _ = model_lib.forward(cut_cpu, cut, torch.from_numpy(ctoks),
                                       compute_dtype=torch.float32)
        got, _, _ = model_lib.forward(cut_card, cut,
                                      torch.from_numpy(ctoks).to(device),
                                      compute_dtype=torch.float32)
        out["card_vs_cpu_ratio"] = hold_close(
            torch, f"(c) {LM_CUT_LAYERS}-layer cut, float32 logits, card "
            f"against CPU", got, want, 1e-3, 1e-3)
        cut_prompts = ctoks[:, :16]
        tok_cpu = ServeEngine(cut, cut_cpu, ServeConfig(), F32Step()
                              ).generate(cut_prompts, 8)
        tok_card = ServeEngine(cut, cut_card, ServeConfig(), F32Step()
                               ).generate(cut_prompts, 8)
    if not np.array_equal(tok_card, tok_cpu):
        raise AssertionError(f"(c): greedy tokens differ\n{tok_card}\n"
                             f"{tok_cpu}")
    log(f"  (c) greedy tokens equal on card and CPU ({tok_card.shape}); "
        f"{time.perf_counter() - t0:.2f}s")
    del cut_cpu, want, got

    # (d) the serving path: bfloat16 default, B = 8, P = 128, 64 new
    t0 = time.perf_counter()
    prompts = lm_prompts(np, cfg, LM_BATCH, LM_PROMPT, 3)
    engine = ServeEngine(cfg, model, ServeConfig(batch=LM_BATCH))
    run1, d = serve_twice(torch, np, engine, prompts, LM_NEW,
                          cfg.vocab_size, "(d)")
    dev_ms, wall_ms = device_busy_share(torch, engine, prompts, 8)
    f32_tokens = ServeEngine(cfg, model, ServeConfig(batch=LM_BATCH),
                             F32Step()).generate(prompts, LM_NEW)
    share = float((f32_tokens[:, LM_PROMPT:] == run1[:, LM_PROMPT:]).mean())
    d.update(device_ms_8_new=dev_ms, wall_ms_8_new=wall_ms,
             bf16_equals_f32=share,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    out["serve"] = d
    log(f"  (d) ServeEngine.generate, bfloat16 compute, B = {LM_BATCH}, "
        f"P = {LM_PROMPT}, {LM_NEW} new ({card}): first call (2 new) "
        f"{d['first_call_s']:.3f}s; prefill {d['prefill_ms']:.3f} ms "
        f"(generate of 1 new, median of 3); generate {d['generate_s']:.3f}s "
        f"({', '.join(f'{s:.3f}' for s in d['generate_runs_s'])}), decode "
        f"{d['decode_ms_per_step']:.3f} ms a step, {d['tok_per_s']:.1f} "
        f"tok/s; two runs bit-equal; device busy over an 8-new generate: "
        f"{busy_text(dev_ms, wall_ms)}")
    log(f"  (d) bfloat16 greedy tokens equal to float32 compute's at "
        f"{100 * share:.1f}% of the {LM_BATCH * LM_NEW} new positions "
        f"(not gated); torch.cuda.max_memory_allocated "
        f"{out['serve']['max_memory_allocated']}; "
        f"{time.perf_counter() - t0:.2f}s")
    del engine

    # (e) checkpoint round trip of the 2-layer cut
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="lm_ckpt_") as tmp:
        mgr = CheckpointManager(tmp, keep=1)
        mgr.save(1, {"params": cut_card.param_tree()})
        mgr.wait()
        back = model_lib.empty(cut, device)
        _, state = mgr.restore({"params": back.param_tree()})
        back.load_state_dict(lm_params_from_reference(cut, state["params"],
                                                      device), assign=True)
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(tmp) for f in fs)
    for (name, a), (_, b) in zip(cut_card.named_parameters(),
                                 back.named_parameters()):
        if not torch.equal(a, b):
            raise AssertionError(f"(e): {name} changed through the checkpoint")
    with no_tf32(torch):
        tok_back = ServeEngine(cut, back, ServeConfig(), F32Step()
                               ).generate(cut_prompts, 8)
    if not np.array_equal(tok_back, tok_card):
        raise AssertionError("(e): restored model generates other tokens")
    log(f"  (e) CheckpointManager: {size} bytes saved and restored, weights "
        f"and tokens equal; {time.perf_counter() - t0:.2f}s")
    del cut_card, back, state, model
    torch.cuda.empty_cache()

    # (f) the normal entry point
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *LM_SERVE_ARGS], env=env, capture_output=True,
                          text=True, timeout=600)
    line = [s for s in proc.stdout.splitlines() if s.startswith("[serve]")]
    if proc.returncode != 0 or not line:
        raise AssertionError(f"(f): launch.serve exited {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    out["launch_line"] = line[0]
    log(f"  (f) python -m repro_torch.launch.serve {' '.join(LM_SERVE_ARGS)}"
        f": {line[0]} ({time.perf_counter() - t0:.2f}s with start-up)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 3i ok: {cfg.name} at full width served, float32 path held "
        f"to itself, card to CPU, bfloat16 runs bit-equal, checkpoint round "
        f"trip, launch.serve exit 0; {out['seconds']:.1f}s")
    return out


# ----------------------------------------------------------------- phase 3j

LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128   # (a) and (c)
LM_TRAIN_STEPS, LM_LOWMEM_STEPS = 6, 3
LM_TRAIN_ARGS = ["--arch", LM_ARCH, "--steps", "4", "--ckpt-every", "0"]
# A short warm-up, so that six steps move the loss past the noise between
# batches (launch.train warms up over 20 steps).
LM_OPT = dict(lr=1e-3, warmup_steps=5, decay_steps=100)


def telemetry_questions(n_steps: int) -> list[str]:
    """The reference example's BlinkQL over its trainer's telemetry
    (examples/telemetry_queries.py), the late phase from half the run;
    the first repeated (the answer cache)."""
    q1 = ("SELECT AVG(loss) FROM telemetry GROUP BY domain "
          "ERROR WITHIN 10% AT CONFIDENCE 95%")
    return [q1, f"SELECT COUNT(*) FROM telemetry WHERE step >= "
                f"{n_steps // 2} AND grad_norm > 1.0 ERROR WITHIN 20% "
                f"CONFIDENCE 95%", q1]


@contextlib.contextmanager
def timed_optimizer(torch, seconds: list):
    """While active, each `train.optim.adamw_update` (as make_train_step
    calls it) is timed on the host clock, device synchronised on both
    sides, into `seconds`."""
    from repro_torch.train import optim as optim_lib
    update = optim_lib.adamw_update

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(*args, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    optim_lib.adamw_update = timed
    try:
        yield seconds
    finally:
        optim_lib.adamw_update = update


def timed_steps(torch, step_fn, seconds: list):
    """step_fn timed on the host clock, device synchronised on both sides."""
    def call(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    return call


def step_losses(telemetry) -> list:
    """One loss a step (Telemetry keeps a record per step and domain)."""
    by_step = {}
    for r in telemetry.records:
        by_step.setdefault(r["step"], r["loss"])
    return [by_step[k] for k in sorted(by_step)]


def lm_batch(torch, stream) -> dict:
    return {k: torch.from_numpy(v) for k, v in stream.next_batch().items()
            if k in ("tokens", "labels")}


def loss_and_grads(torch, model, cfg, batch, optim_lib, model_lib):
    """(loss, grad norm, [(path, grad)], aux) of one float32 loss_fn."""
    from repro_torch.checkpoint.ckpt import flatten_with_paths
    leaves = flatten_with_paths(model.param_tree())
    batch = {k: v.to(model.device) for k, v in batch.items()}
    loss, parts = model_lib.loss_fn(model, cfg, batch,
                                    compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    tree = dict(zip([p for p, _ in leaves], grads))
    return (loss.detach(), optim_lib.global_norm(tree), list(tree.items()),
            parts["aux"].detach())


def hold_telemetry(np, cols, answers) -> float:
    """Every answer finite; each per-domain AVG(loss) a weighted mean of
    that domain's records, so within their range (a tiny sample may miss
    the exact mean by more than its closed-form CI: ROADMAP §3's
    small-sample fault); the COUNT non-negative. Returns the worst
    |estimate - exact mean| (not gated)."""
    worst = 0.0
    for ans in answers:
        if not all(np.isfinite(g.estimate) and np.isfinite(g.stderr)
                   for g in ans.groups):
            raise AssertionError(f"(f): non-finite answer {ans}")
    for g in answers[0].groups:
        vals = cols["loss"][cols["domain"] == g.key[0]].astype(np.float64)
        if not len(vals) or not (vals.min() * (1 - 1e-6) <= g.estimate
                                 <= vals.max() * (1 + 1e-6)):
            raise AssertionError(f"(f): AVG(loss) of domain {g.key[0]} "
                                 f"{g.estimate} outside its records' "
                                 f"range")
        worst = max(worst, abs(g.estimate - vals.mean()))
    if any(g.estimate < 0 for g in answers[1].groups):
        raise AssertionError(f"(f): a negative COUNT {answers[1]}")
    return worst


def lm_train_run(torch, step_cfg, n_steps: int, device="cuda",
                 cfg=None, profile_seq: int | None = None,
                 make_stream=None) -> tuple:
    """Phase 3j (a)'s and 3k (c)'s measured run (lm_train_times.py runs it
    too): `cfg` (default qwen2-1.5b) at full width and depth from a seeded
    generator on `device`, n_steps of make_train_step(step_cfg) through
    train.loop.train, B = LM_TRAIN_BATCH and T = LM_TRAIN_SEQ from
    SyntheticTokenStream; each step and its adamw_update timed on the host
    clock, device synchronised on both sides; then one more step under
    torch.profiler. Returns (the measurement, the run's Telemetry); the
    device busy share is the profiled step's device time over the median
    unprofiled step (medians over steps 2 to n_steps), or with
    `profile_seq` that of one more step over its first profile_seq tokens
    (device trace only) over such a step timed unprofiled: a profile of
    ~10^5 launches costs the host minutes of bookkeeping; "aux" holds each
    step's MoE aux loss (0 for a dense model), "first_batch_after" the
    first step's batch evaluated again after the n_steps (loss_fn under
    no_grad), free of the noise between batches. `make_stream(cfg)` gives
    the batches (default: SyntheticTokenStream at B = LM_TRAIN_BATCH, T =
    LM_TRAIN_SEQ, seed 0); tokens/s counts B·T a step."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, SyntheticTokenStream
    from repro_torch.models import model as model_lib
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optim as optim_lib
    from repro_torch.train import step as step_lib

    cfg = cfg or get_config(LM_ARCH)
    opt_cfg = optim_lib.OptConfig(**LM_OPT)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(0),
        step_cfg.param_dtype)
    opt = optim_lib.init_opt_state(model.param_tree(),
                                   step_cfg.opt_config(opt_cfg))
    make_stream = make_stream or (lambda cfg: SyntheticTokenStream(
        DataConfig(cfg.vocab_size, LM_TRAIN_SEQ, LM_TRAIN_BATCH, seed=0)))
    stream = make_stream(cfg)
    step_s, opt_s, aux = [], [], []
    step = step_lib.make_train_step(cfg, opt_cfg, step_cfg)

    def step_aux(*args):
        out = step(*args)
        aux.append(out[2]["aux"].item())
        return out
    with timed_optimizer(torch, opt_s), \
            tempfile.TemporaryDirectory(prefix="lm_train_") as tmp:
        _, opt, telemetry = loop_lib.train(
            timed_steps(torch, step_aux, step_s), model, opt, stream,
            loop_lib.LoopConfig(total_steps=n_steps, ckpt_every=0,
                                log_every=n_steps, ckpt_dir=tmp),
            resume=False)
    first = lm_batch(torch, make_stream(cfg))
    with torch.no_grad():
        again, _ = model_lib.loss_fn(
            model, cfg, {k: v.to(model.device) for k, v in first.items()},
            compute_dtype=step_cfg.compute_dtype)
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    if profile_seq is None:
        dev_ms, wall_ms, top = profiled_ms(
            torch, lambda: step(model, opt, lm_batch(torch, stream)))
        busy_of_ms = 1e3 * med
    else:   # a shorter step, its device trace over its unprofiled time
        def short():
            batch = lm_batch(torch, stream)
            return step(model, opt, {k: v[:, :profile_seq]
                                     for k, v in batch.items()})
        seconds = []
        timed_steps(torch, short, seconds)()
        busy_of_ms = 1e3 * seconds[0]
        dev_ms, wall_ms, top = profiled_ms(torch, short)
    med_opt = sorted(opt_s[1:])[len(opt_s[1:]) // 2]
    return {"params": sum(p.numel() for p in model.parameters()),
            "losses": step_losses(telemetry), "aux": aux,
            "first_batch_after": again.item(),
            "step_ms": [1e3 * x for x in step_s],
            "optimizer_ms": [1e3 * x for x in opt_s],
            "median_step_ms": 1e3 * med,
            "median_optimizer_ms": 1e3 * med_opt,
            "median_fwd_bwd_ms": 1e3 * (med - med_opt),
            "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / med,
            "device_ms_one_step": dev_ms,
            "profiled_wall_ms_one_step": wall_ms,
            "device_busy_share": dev_ms / busy_of_ms,
            "busy_of_ms": busy_of_ms, "profiled_seq": profile_seq,
            "top_kernels": top,
            "max_memory_allocated": torch.cuda.max_memory_allocated()
            }, telemetry


def telemetry_blinkql(torch, np, telemetry, n_steps: int,
                      device="cuda", tag="(f)") -> dict:
    """Phases 3j (f) and 3k (f): a training run's Telemetry as a BlinkDB
    table, the reference example's BlinkQL (`telemetry_questions`) through
    BlinkQLService, every agg_scan_fused launch held to its plain version,
    each answer equal to query()'s bit for bit and each AVG within its
    domain's records' range (`hold_telemetry`); the repeated question
    from the cache. Then the fused kernel is timed at the first question's
    shape (the telemetry family's block) beside its plain version and its
    bound, after the launch counts are read."""
    from repro_torch.core import BlinkDB, EngineConfig, QueryTemplate
    from repro_torch.core import table as table_lib
    from repro_torch.service import BlinkQLService, ServiceConfig, \
        parse_blinkql

    t0 = time.perf_counter()
    cols = telemetry.as_columns()
    cols = {"step": cols["step"].astype(np.int32),
            "domain": cols["domain"].astype(np.int32),
            "loss": cols["loss"].astype(np.float32),
            "grad_norm": cols["grad_norm"].astype(np.float32)}
    db = BlinkDB(EngineConfig(k1=50.0, m=3, uniform_fraction=0.5),
                 device=device)
    db.register_table("telemetry", table_lib.from_columns(
        "telemetry", cols, categorical=["domain"]))
    db.build_samples("telemetry", [QueryTemplate(frozenset({"domain"}), 1.0)],
                     storage_budget_fraction=0.5)
    worst = {}
    texts = telemetry_questions(n_steps)
    reset_launches()
    with checked_launches(torch, worst), \
            BlinkQLService(db, config=ServiceConfig(batch_window_s=0.002)) \
            as svc:
        answers = [svc.submit(q) for q in texts]
        stats = svc.stats()
    launched = launch_counts()
    if launched["agg_scan_fused"] == 0:
        raise AssertionError(f"{tag}: no fused launch answered the telemetry")
    if stats["cache"]["hits"] < 1:
        raise AssertionError(f"{tag}: the repeated question missed the cache "
                             f"{stats}")
    with checked_launches(torch, worst):
        for text, ans in zip(texts, answers):
            if answer_bits(db.query(parse_blinkql(text, db))) != \
                    answer_bits(ans):
                raise AssertionError(f"{tag}: {text!r} through the service "
                                     f"differs from query()")
    gap = hold_telemetry(np, cols, answers)
    from repro_torch.kernels import agg_scan, ref
    phi, striped, args, struct, slots, g = scan_inputs(
        torch, db, parse_blinkql(texts[0], db))
    fused = agg_scan.agg_scan_fused_cuda
    out = fused(*args, struct, slots, g)
    times = {"label": f"AVG(loss) GROUP BY domain, family {phi}, "
                      f"{striped.n_local} slots", "G": g,
             "ms": time_cuda(torch, lambda: fused(*args, struct, slots, g),
                             warmup=3, reps=20),
             "plain_ms": time_cuda(torch, lambda: ref.agg_scan_fused_ref(
                 *args, struct, slots, g), warmup=1, reps=5)}
    times["bound_ms"], times["bound_by"] = bound_for(args, struct, out,
                                                     4 * out.numel())
    log(f"  {tag} agg_scan_fused at the telemetry's shape ({times['label']}, "
        f"G = {g}): {times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, "
        f"bound {times['bound_ms']:.3e} ms ({times['bound_by']})")
    log(f"  {tag} {len(cols['step'])} telemetry records, {len(texts)} "
        f"BlinkQL questions through BlinkQLService: launches {launched}, "
        f"each fused launch held to its plain version (worst "
        f"{worst.get('agg_scan_fused')}); answers equal to query()'s bit "
        f"for bit; AVG(loss) BY domain within each domain's range (worst "
        f"|gap| to the exact mean {gap:.3e}); cache hits "
        f"{stats['cache']['hits']}; {time.perf_counter() - t0:.2f}s")
    return {"records": int(len(cols["step"])), "launches": launched,
            "worst": worst, "max_avg_gap": gap, "times": times}


def phase_lm_training(torch, np, card: str, device="cuda") -> dict:
    """The LM substrate's training path (repro_torch.train, .data.tokens,
    .launch.train) on qwen2-1.5b: (a) full width and depth, float32 weights
    from a seeded generator on the card, StepConfig() (f32, remat on,
    bfloat16 compute), B = 8, T = 128 from SyntheticTokenStream, six steps
    through train.loop.train: every loss finite, the last below the first;
    step ms (median after the first) split into forward+backward and
    optimizer, tokens/s, the device's busy share (a seventh step's device
    time under torch.profiler over the median step), peak memory
    (`lm_train_run`); (b) the same widths cut to 2 layers, float32 compute with TF32
    off: one step's loss, grad norm and every gradient leaf on the card
    against the CPU (rtol 1e-3, atol 1e-3 of the leaf's largest magnitude);
    (c) the lowmem policy (bfloat16 params, int8 moments) at full width, 3
    finite steps, peak memory below (a)'s; (d) the 2-layer cut through the
    loop: 4 steps straight against 2, a CheckpointManager save and restore,
    then 2 more (losses rtol 1e-5; the card's embedding backward sums with
    atomics); (e) python -m repro_torch.launch.train as a subprocess, exit 0
    and its [train] line; (f) (a)'s Telemetry as a BlinkDB table, the
    reference example's BlinkQL through BlinkQLService, every fused launch
    held to its plain version, each answer equal to query()'s bit for bit
    and each AVG within its domain's records' range."""
    import copy
    import os
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, SyntheticTokenStream
    from repro_torch.models import model as model_lib
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optim as optim_lib
    from repro_torch.train import step as step_lib

    t_phase = time.perf_counter()
    out = {}
    cfg = get_config(LM_ARCH)
    opt_cfg = optim_lib.OptConfig(**LM_OPT)

    # (a) full width and depth, the f32 policy
    t0 = time.perf_counter()
    a, telemetry = lm_train_run(torch, step_lib.StepConfig(), LM_TRAIN_STEPS,
                                device)
    out["f32"] = a
    losses = a["losses"]
    if len(losses) != LM_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"(a): losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(a): the loss did not fall: {losses}")
    dev_ms = a["device_ms_one_step"]
    log(f"  (a) {cfg.name} at full width and depth ({cfg.n_layers} layers, "
        f"{a['params']} float32 parameters), StepConfig() f32 policy, "
        f"remat, bfloat16 compute, B = {LM_TRAIN_BATCH}, T = "
        f"{LM_TRAIN_SEQ}: losses {', '.join(f'{x:.4f}' for x in losses)} "
        f"(finite, fell)")
    log(f"  (a) step {a['median_step_ms']:.3f} ms (median of steps 2-"
        f"{LM_TRAIN_STEPS}; first {a['step_ms'][0]:.3f}): forward+backward "
        f"{a['median_fwd_bwd_ms']:.3f} ms, optimizer "
        f"{a['median_optimizer_ms']:.3f} ms; {a['tokens_per_s']:.1f} "
        f"tokens/s; device busy: a profiled step's device time over the "
        f"median step {busy_text(dev_ms, a['median_step_ms'])} (over the "
        f"profiled step's own wall, profiler included: "
        f"{busy_text(dev_ms, a['profiled_wall_ms_one_step'])}); "
        f"torch.cuda.max_memory_allocated {a['max_memory_allocated']} "
        f"({card}); {time.perf_counter() - t0:.2f}s")
    log("  (a) the profiled step's kernels of most device time: " + "; ".join(
        f"{name[:60]} {ms:.3f} ms x{n}" for name, ms, n in a["top_kernels"]))
    torch.cuda.empty_cache()

    # (b) a 2-layer cut at full width: loss and gradients, card against CPU
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS)
    cut_cpu = model_lib.init_params(cut, torch.Generator().manual_seed(1))
    cut_card = copy.deepcopy(cut_cpu).to(device)
    batch = lm_batch(torch, SyntheticTokenStream(
        DataConfig(cut.vocab_size, 32, 2, seed=2)))
    with no_tf32(torch):
        want = loss_and_grads(torch, cut_cpu, cut, batch, optim_lib,
                              model_lib)
        got = loss_and_grads(torch, cut_card, cut, batch, optim_lib,
                             model_lib)
    ratios = [hold_close(torch, "(b) loss, card against CPU", got[0],
                         want[0], 1e-3, 1e-3),
              hold_close(torch, "(b) grad norm, card against CPU", got[1],
                         want[1], 1e-3, 1e-3)]
    worst = (0.0, "")
    for (path, g), (_, w) in zip(got[2], want[2]):
        w = w.float()
        scale = w.abs().max().item()
        diff = (g.float().cpu() - w).abs().max().item()
        ratio = tol_ratio(torch, g.float().cpu(), w, 1e-3,
                          1e-3 * scale if scale > 0 else 1e-30)
        if not ratio <= 1.0:
            raise AssertionError(f"(b): gradient {path} off by {diff} "
                                 f"(ratio {ratio})")
        worst = max(worst, (ratio, path))
    out["card_vs_cpu"] = {"loss": want[0].item(), "ratios": ratios,
                          "worst_grad_ratio": worst[0],
                          "worst_grad_leaf": worst[1]}
    log(f"  (b) {len(got[2])} gradient leaves within rtol 1e-3 / atol 1e-3 "
        f"of their largest magnitude, worst ratio {worst[0]:.3f} "
        f"({worst[1]}); {time.perf_counter() - t0:.2f}s")
    del cut_cpu, cut_card, want, got

    # (c) the lowmem policy at full width
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    low_cfg = step_lib.StepConfig(policy="lowmem")
    model = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(0),
        low_cfg.param_dtype)
    opt = optim_lib.init_opt_state(model.param_tree(),
                                   low_cfg.opt_config(opt_cfg))
    step = step_lib.make_train_step(cfg, opt_cfg, low_cfg)
    stream = SyntheticTokenStream(DataConfig(cfg.vocab_size, LM_TRAIN_SEQ,
                                             LM_TRAIN_BATCH, seed=0))
    low_s, low_losses = [], []
    for _ in range(LM_LOWMEM_STEPS):
        _, opt, m = timed_steps(torch, step, low_s)(model, opt,
                                                    lm_batch(torch, stream))
        low_losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(low_losses).all():
        raise AssertionError(f"(c): losses {low_losses}")
    if opt["m"]["embed"]["q"].dtype != torch.int8 or \
            model.embed.dtype != torch.bfloat16:
        raise AssertionError("(c): not bfloat16 params and int8 moments")
    if not peak < a["max_memory_allocated"]:
        raise AssertionError(f"(c): peak {peak} not below (a)'s "
                             f"{a['max_memory_allocated']}")
    out["lowmem"] = {"losses": low_losses,
                     "step_ms": [1e3 * x for x in low_s],
                     "max_memory_allocated": peak}
    log(f"  (c) lowmem (bfloat16 params, int8 moments): losses "
        f"{', '.join(f'{x:.4f}' for x in low_losses)}; steps "
        f"{', '.join(f'{1e3 * x:.3f}' for x in low_s)} ms; "
        f"torch.cuda.max_memory_allocated {peak}, below (a)'s ({card}); "
        f"{time.perf_counter() - t0:.2f}s")
    del model, opt, step
    torch.cuda.empty_cache()

    # (d) the 2-layer cut through the loop, stopped and resumed
    t0 = time.perf_counter()

    def cut_run(total: int, ckpt_dir: str, ckpt_every: int):
        m = model_lib.init_params(
            cut, torch.Generator(device=device).manual_seed(3))
        o = optim_lib.init_opt_state(m.param_tree(), opt_cfg)
        st = step_lib.make_train_step(cut, opt_cfg, step_lib.StepConfig())
        _, _, tel = loop_lib.train(
            st, m, o, SyntheticTokenStream(DataConfig(cut.vocab_size, 64, 4,
                                                      seed=4)),
            loop_lib.LoopConfig(total_steps=total, ckpt_every=ckpt_every,
                                log_every=100, ckpt_dir=ckpt_dir))
        return step_losses(tel)
    with tempfile.TemporaryDirectory(prefix="lm_resume_") as tmp:
        straight = cut_run(4, os.path.join(tmp, "a"), 0)
        t1 = time.perf_counter()
        first = cut_run(2, os.path.join(tmp, "b"), 2)
        save_s = time.perf_counter() - t1
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(os.path.join(tmp, "b"))
                   for f in fs)
        t1 = time.perf_counter()
        resumed = cut_run(4, os.path.join(tmp, "b"), 0)
        resume_s = time.perf_counter() - t1
    both = np.array(first + resumed)
    if len(resumed) != 2 or not np.allclose(both, straight, rtol=1e-5,
                                            atol=0):
        raise AssertionError(f"(d): stopped and resumed {first} + {resumed}"
                             f" against straight {straight}")
    out["resume"] = {"straight": straight, "stopped": first,
                     "resumed": resumed, "checkpoint_bytes": size,
                     "max_rel_diff": float(np.max(np.abs(both - straight)
                                                  / np.abs(straight)))}
    log(f"  (d) {LM_CUT_LAYERS}-layer cut: 4 straight "
        f"{', '.join(f'{x:.6f}' for x in straight)}; 2 + checkpoint "
        f"({size} bytes; run with save {save_s:.2f}s) + 2 resumed "
        f"({resume_s:.2f}s): max relative difference "
        f"{out['resume']['max_rel_diff']:.3e} (rtol 1e-5); "
        f"{time.perf_counter() - t0:.2f}s")

    # (e) the normal entry point
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory(prefix="lm_launch_") as tmp:
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                               *LM_TRAIN_ARGS, "--ckpt-dir", tmp], env=env,
                              capture_output=True, text=True, timeout=600)
    line = [x for x in proc.stdout.splitlines() if x.startswith("[train]")]
    if proc.returncode != 0 or not line:
        raise AssertionError(f"(e): launch.train exited {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    out["launch_line"] = line[-1]
    log(f"  (e) python -m repro_torch.launch.train {' '.join(LM_TRAIN_ARGS)}"
        f": {line[-1]} ({time.perf_counter() - t0:.2f}s with start-up)")

    # (f) (a)'s telemetry through BlinkQL, every fused launch held to plain
    out["telemetry"] = telemetry_blinkql(torch, np, telemetry,
                                         LM_TRAIN_STEPS, device)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 3j ok: {cfg.name} trained at full width (f32 and lowmem), "
        f"card held to CPU, stopped and resumed equal to straight, "
        f"launch.train exit 0, its telemetry answered by BlinkQL through "
        f"the fused kernel; {out['seconds']:.1f}s")
    return out


# ----------------------------------------------------------------- phase 3k

MOE_ARCH = "granite-moe-3b-a800m"   # 32 layers, 40 experts top 8, 3.30B
MOE_TRAIN_STEPS = 5
MOE_SERVE_ARGS = ["--arch", MOE_ARCH]
MOE_TRAIN_ARGS = ["--arch", MOE_ARCH, "--policy", "lowmem", "--steps", "3",
                  "--ckpt-every", "0"]


@contextlib.contextmanager
def recorded_moe(torch):
    """While active, each MoE layer's routing is recorded on the host, one
    entry a call: the float32 probabilities (recomputed from the router's
    inputs), gate_idx (`moe._route`) and keep (`moe._dispatch`)."""
    from repro_torch.models import moe as moe_lib
    route, dispatch = moe_lib._route, moe_lib._dispatch
    calls = []

    def recorded_route(p, xt, dims):
        out = route(p, xt, dims)
        with torch.no_grad():
            logits = moe_lib.einsum("td,de->te", xt,
                                    p["router"].to(xt.dtype))
            probs = torch.softmax(logits.float(), dim=-1)
        calls.append({"probs": probs.cpu(), "gate_idx": out[1].cpu()})
        return out

    def recorded_dispatch(x, gate_idx, capacity, e):
        out = dispatch(x, gate_idx, capacity, e)
        calls[-1]["keep"] = out[2].cpu()
        return out
    moe_lib._route, moe_lib._dispatch = recorded_route, recorded_dispatch
    try:
        yield calls
    finally:
        moe_lib._route, moe_lib._dispatch = route, dispatch


def hold_routing(torch, want: list, got: list) -> int:
    """Raise unless each layer sent each token to the same experts and kept
    the same assignments on both sides; a flip logs the token and the two
    experts' probabilities. Returns the routed tokens compared."""
    if len(want) != len(got) or not want:
        raise AssertionError(f"(b): {len(got)} routed layers, not "
                             f"{len(want)}")
    n = 0
    for layer, (w, g) in enumerate(zip(want, got)):
        flips = (w["gate_idx"] != g["gate_idx"]).any(-1).nonzero().flatten()
        for t in flips[:8].tolist():
            j = int((w["gate_idx"][t] != g["gate_idx"][t]).nonzero()[0])
            a, b = int(w["gate_idx"][t, j]), int(g["gate_idx"][t, j])
            log(f"  (b) layer {layer} token {t}, rank {j}: CPU expert {a} "
                f"(p {w['probs'][t, a].item():.9g} CPU, "
                f"{g['probs'][t, a].item():.9g} card), card expert {b} "
                f"(p {w['probs'][t, b].item():.9g} CPU, "
                f"{g['probs'][t, b].item():.9g} card)")
        if len(flips) or not torch.equal(w["keep"], g["keep"]):
            raise AssertionError(f"(b): layer {layer} routes {len(flips)} "
                                 f"tokens otherwise on the card")
        n += w["gate_idx"].shape[0]
    return n


def hold_gradients(torch, label, got, want, zero_gradient=()) -> dict:
    """Each gradient leaf on the card against the CPU: rtol 1e-3 / atol
    1e-5, except the elements whose CPU gradient is at most 1e-4 of the
    largest in their leaf (float32 rounding ~1e-6 of it decides their
    sign), held to atol 1e-3 of that largest. A leaf whose gradient is zero
    (`zero_gradient`, path suffixes) is all rounding: held as at most 1e-6
    of the largest gradient of any leaf, on both devices. Returns the
    exempt counts by leaf and the worst ratio."""
    exempt, worst = {}, (0.0, "")
    top = max(w.float().abs().max().item() for _, w in want)
    for (path, g), (_, w) in zip(got, want):
        g, w = g.float().cpu(), w.float()
        if path.endswith(tuple(zero_gradient)):
            size = max(g.abs().max().item(), w.abs().max().item())
            exempt[path] = f"zero gradient: |g| <= {size:.3e}"
            if not size <= 1e-6 * top:
                raise AssertionError(f"{label}: gradient {path} is not zero "
                                     f"({size} of the largest {top})")
            continue
        scale = w.abs().max().item()
        tie = w.abs() <= 1e-4 * scale
        exempt[path] = f"{int(tie.sum())}/{w.numel()}"
        ratio = max(tol_ratio(torch, g[~tie], w[~tie], 1e-3, 1e-5)
                    if (~tie).any() else 0.0,
                    tol_ratio(torch, g[tie], w[tie], 0.0, 1e-3 * scale)
                    if tie.any() and scale > 0 else 0.0)
        if not ratio <= 1.0:
            raise AssertionError(f"{label}: gradient {path} off (ratio "
                                 f"{ratio}, max |diff| "
                                 f"{(g - w).abs().max().item()})")
        worst = max(worst, (ratio, path))
    return {"exempt": exempt, "worst_ratio": worst[0], "worst_leaf": worst[1]}


def phase_lm_moe(torch, np, card: str, device="cuda") -> dict:
    """The LM substrate's MoE (repro_torch.models.moe through DecoderLM,
    ServeEngine, make_train_step, launch.serve, launch.train) on
    granite-moe-3b-a800m at full width and depth (32 layers, 40 experts
    top 8, 3.30B parameters; weights from a seeded generator): (a)
    ServeEngine.generate in bfloat16 at B = 8, P = 128, 64 new tokens,
    twice, bit-equal (prefill ms, decode ms a step, tok/s, the device's
    busy share and top kernels, peak memory); (b) a 2-layer cut at full
    width, float32 compute with TF32 off: the routing (gate_idx, keep) of
    every layer equal on the card and the CPU, the logits and aux within
    rtol/atol 1e-3, and prefill 32 + decode 32 against its own forward
    over 64 at capacity factor 40 (rtol/atol 2e-2); (c) the lowmem policy
    at full width, 5 steps at B = 8, T = 128 (`lm_train_run`): every loss
    and aux finite, the first step's batch evaluated again after the five
    below its loss at the first step (a step's loss moves with its batch
    by more than five lowmem steps move it; step ms split into
    forward+backward and optimizer, tokens/s, busy share, top kernels,
    peak memory); (d) the 2-layer cut under the f32 policy: one step's
    loss, aux and grad norm (rtol 1e-3) and every gradient leaf
    (`hold_gradients`), card against CPU; (e) python -m
    repro_torch.launch.serve and launch.train --policy lowmem as
    subprocesses, exit 0 and their last lines; (f) (c)'s Telemetry
    through BlinkQLService (`telemetry_blinkql`)."""
    import copy
    import gc
    import os
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, SyntheticTokenStream
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.train import optim as optim_lib
    from repro_torch.train import step as step_lib

    t_phase = time.perf_counter()
    out = {}
    cfg = get_config(MOE_ARCH)

    # (a) serving at full width and depth
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    extra = cfg.n_layers * 2 * cfg.d_model + cfg.d_model   # the norms
    if n_params != cfg.param_count() + extra:
        raise AssertionError(f"{n_params} parameters, not "
                             f"{cfg.param_count()} + {extra}")
    prompts = lm_prompts(np, cfg, LM_BATCH, LM_PROMPT, 3)
    engine = ServeEngine(cfg, model, ServeConfig(batch=LM_BATCH))
    _, a = serve_twice(torch, np, engine, prompts, LM_NEW, cfg.vocab_size,
                       "(a)")
    dev_ms, wall_ms, top = profiled_ms(
        torch, lambda: engine.generate(prompts, 8))
    a.update(params=n_params, device_ms_8_new=dev_ms, wall_ms_8_new=wall_ms,
             top_kernels=top,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    out["serve"] = a
    log(f"  (a) {cfg.name} at full width and depth ({cfg.n_layers} layers, "
        f"{cfg.n_experts} experts top {cfg.top_k}, {n_params} float32 "
        f"parameters), ServeEngine.generate, bfloat16 compute, B = "
        f"{LM_BATCH}, P = {LM_PROMPT}, {LM_NEW} new ({card}): first call "
        f"(2 new) {a['first_call_s']:.3f}s; prefill {a['prefill_ms']:.3f} ms "
        f"(generate of 1 new, median of 3); generate {a['generate_s']:.3f}s "
        f"({', '.join(f'{s:.3f}' for s in a['generate_runs_s'])}), decode "
        f"{a['decode_ms_per_step']:.3f} ms a step, "
        f"{a['tok_per_s']:.1f} tok/s; two runs bit-equal; device busy over "
        f"an 8-new generate: {busy_text(dev_ms, wall_ms)}; "
        f"torch.cuda.max_memory_allocated {a['max_memory_allocated']}; "
        f"{time.perf_counter() - t0:.2f}s")
    log("  (a) kernels of most device time over the 8-new generate: " +
        "; ".join(f"{name[:60]} {ms:.3f} ms x{n}" for name, ms, n in top))
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) a 2-layer cut at full width: routing and logits, card against CPU
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS)
    cut_cpu = model_lib.init_params(cut, torch.Generator().manual_seed(1))
    cut_card = copy.deepcopy(cut_cpu).to(device)
    ctoks = torch.from_numpy(lm_prompts(np, cut, 2, 32, 2))
    with no_tf32(torch), torch.no_grad():
        with recorded_moe(torch) as want_r:
            want, _, want_aux = model_lib.forward(
                cut_cpu, cut, ctoks, compute_dtype=torch.float32)
        with recorded_moe(torch) as got_r:
            got, _, got_aux = model_lib.forward(
                cut_card, cut, ctoks.to(device), compute_dtype=torch.float32)
    routed = hold_routing(torch, want_r, got_r)
    out["card_vs_cpu"] = {
        "routed_tokens": routed,
        "logits_ratio": hold_close(torch, f"(b) {LM_CUT_LAYERS}-layer cut, "
                                   f"float32 logits, card against CPU", got,
                                   want, 1e-3, 1e-3),
        "aux_ratio": hold_close(torch, "(b) aux, card against CPU", got_aux,
                                want_aux, 1e-3, 1e-3)}
    ample = dataclasses.replace(cut, capacity_factor=float(cut.n_experts))
    amp = model_lib.empty(ample, device)
    amp.load_state_dict(cut_card.state_dict(), assign=True)
    ptoks = torch.from_numpy(lm_prompts(np, cut, 2, 64, 4)).to(device)
    with no_tf32(torch), torch.no_grad():
        full, _, _ = model_lib.forward(amp, ample, ptoks, "train",
                                       compute_dtype=torch.float32)
        caches = model_lib.init_cache(ample, 2, 64, dtype=torch.float32,
                                      device=device)
        logits, caches = model_lib.prefill(amp, ample, ptoks[:, :32], caches,
                                           compute_dtype=torch.float32)
        steps = [logits]
        for t in range(32, 64):
            lg, caches, _ = model_lib.forward(amp, ample, ptoks[:, t:t + 1],
                                              "decode", caches, t,
                                              torch.float32)
            steps.append(lg)
    out["card_vs_cpu"]["own_forward_ratio"] = hold_close(
        torch, "(b) capacity factor 40: prefill 32 + decode 32 against the "
        "forward over 64", torch.cat(steps, dim=1), full, 2e-2, 2e-2)
    log(f"  (b) {routed} routed tokens over {len(want_r)} layers: the same "
        f"experts and kept assignments on card and CPU; "
        f"{time.perf_counter() - t0:.2f}s")
    del amp, full, steps, caches, want, got

    # (d) the cut under the f32 policy: one step's gradients, card vs CPU
    t0 = time.perf_counter()
    batch = lm_batch(torch, SyntheticTokenStream(
        DataConfig(cut.vocab_size, 32, 2, seed=2)))
    with no_tf32(torch):
        want = loss_and_grads(torch, cut_cpu, cut, batch, optim_lib,
                              model_lib)
        got = loss_and_grads(torch, cut_card, cut, batch, optim_lib,
                             model_lib)
    ratios = [hold_close(torch, f"(d) {name}, card against CPU", g, w, 1e-3,
                         1e-3)
              for name, g, w in (("loss", got[0], want[0]),
                                 ("grad norm", got[1], want[1]),
                                 ("aux", got[3], want[3]))]
    held = hold_gradients(torch, "(d)", got[2], want[2])
    out["gradients"] = {"loss": want[0].item(), "aux": want[3].item(),
                        "ratios": ratios, **held}
    log(f"  (d) {len(got[2])} gradient leaves within rtol 1e-3 / atol 1e-5 "
        f"(exempt, |g| <= 1e-4 of the leaf's largest, within 1e-3 of it: "
        f"{held['exempt']}), worst ratio {held['worst_ratio']:.3f} "
        f"({held['worst_leaf']}); {time.perf_counter() - t0:.2f}s")
    del cut_cpu, cut_card, want, got
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the lowmem policy at full width and depth
    t0 = time.perf_counter()
    c, telemetry = lm_train_run(torch, step_lib.StepConfig(policy="lowmem"),
                                MOE_TRAIN_STEPS, device, cfg)
    out["lowmem"] = c
    losses, aux = c["losses"], c["aux"]
    if len(losses) != MOE_TRAIN_STEPS or not np.isfinite(losses).all() \
            or not np.isfinite(aux).all():
        raise AssertionError(f"(c): losses {losses}, aux {aux}")
    if not c["first_batch_after"] < losses[0]:
        raise AssertionError(f"(c): the first batch's loss did not fall: "
                             f"{losses[0]} -> {c['first_batch_after']}")
    log(f"  (c) {cfg.name} at full width and depth, lowmem (bfloat16 "
        f"parameters, int8 moments), remat, bfloat16 compute, B = "
        f"{LM_TRAIN_BATCH}, T = {LM_TRAIN_SEQ}: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)} (finite; each step its "
        f"own batch); the first batch again after {MOE_TRAIN_STEPS} steps "
        f"{c['first_batch_after']:.4f}, below its {losses[0]:.4f}; aux "
        f"{', '.join(f'{x:.4f}' for x in aux)}")
    log(f"  (c) step {c['median_step_ms']:.3f} ms (median of steps 2-"
        f"{MOE_TRAIN_STEPS}; first {c['step_ms'][0]:.3f}): forward+backward "
        f"{c['median_fwd_bwd_ms']:.3f} ms, optimizer "
        f"{c['median_optimizer_ms']:.3f} ms; {c['tokens_per_s']:.1f} "
        f"tokens/s; device busy: a profiled step's device time over the "
        f"median step {busy_text(c['device_ms_one_step'], c['median_step_ms'])}"
        f"; torch.cuda.max_memory_allocated {c['max_memory_allocated']} "
        f"({card}); {time.perf_counter() - t0:.2f}s")
    log("  (c) the profiled step's kernels of most device time: " + "; ".join(
        f"{name[:60]} {ms:.3f} ms x{n}" for name, ms, n in c["top_kernels"]))
    gc.collect()
    torch.cuda.empty_cache()

    # (f) (c)'s telemetry through BlinkQL, every fused launch held to plain
    out["telemetry"] = telemetry_blinkql(torch, np, telemetry,
                                         MOE_TRAIN_STEPS, device)

    # (e) the entry points as a user runs them
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out["launch_lines"] = []
    with tempfile.TemporaryDirectory(prefix="moe_launch_") as tmp:
        for module, args, tag in (
                ("repro_torch.launch.serve", MOE_SERVE_ARGS, "[serve]"),
                ("repro_torch.launch.train",
                 MOE_TRAIN_ARGS + ["--ckpt-dir", tmp], "[train]")):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", module, *args],
                                  env=env, capture_output=True, text=True,
                                  timeout=600)
            line = [x for x in proc.stdout.splitlines() if x.startswith(tag)]
            if proc.returncode != 0 or not line:
                raise AssertionError(
                    f"(e): {module} exited {proc.returncode}\n"
                    f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            out["launch_lines"].append(line[-1])
            log(f"  (e) python -m {module} {' '.join(args)}: {line[-1]} "
                f"({time.perf_counter() - t0:.2f}s with start-up)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 3k ok: {cfg.name} at full width served (bit-equal runs) "
        f"and trained (lowmem), routing and logits and gradients of a cut "
        f"held to the CPU, launch.serve and launch.train exit 0, the "
        f"telemetry answered through the fused kernel; "
        f"{out['seconds']:.1f}s")
    return out


XLSTM_ARCH = "xlstm-125m"          # 12 layers, 6 x [mLSTM, sLSTM], 0.162B
# A training step of xlstm-125m takes ~11 s of host launches (PERF.md §6,
# PR 32): (c) takes 2 steps and profiles a step of 32 tokens, launch.train
# takes 1 at B = 4, T = 32, so that the smoke keeps to its time with
# phase 3m after it (PR 33).
XLSTM_TRAIN_STEPS = 2
XLSTM_PROFILED_SEQ = 32
XLSTM_SERVE_ARGS = ["--arch", XLSTM_ARCH]
XLSTM_TRAIN_ARGS = ["--arch", XLSTM_ARCH, "--steps", "1", "--batch", "4",
                    "--seq", "32", "--ckpt-every", "0"]
XLSTM_PROFILED_PROMPT = 16         # (a)'s busy share: a 16-token prompt
JAMBA_ARCH = "jamba-v0.1-52b"      # cut to one period: 8 layers, 13.30B
# sLSTM's input-gate bias has no gradient: a constant added to i_t at every
# step scales c and n alike, and h = o·c/n keeps it out.
ZERO_GRADIENT = ("slstm/b_i",)
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_NEW = 2, 512, 16


def phase_lm_recurrent(torch, np, card: str, device="cuda") -> dict:
    """The LM substrate's recurrent mixers (repro_torch.models.mamba and
    .xlstm through DecoderLM, ServeEngine, make_train_step, launch.serve,
    launch.train): (a) xlstm-125m at full width and depth (12 layers as 6
    x [mLSTM, sLSTM], 0.162B parameters from a seeded generator),
    ServeEngine.generate in bfloat16 at B = 8, P = 128, 64 new, twice,
    bit-equal (prefill ms, decode ms a step, tok/s, peak memory; the busy
    share and top kernels over 8 new from a 16-token prompt); (b) its
    2-layer cut [mLSTM, sLSTM] at full
    width, float32 with TF32 off: logits on the card against the CPU
    (rtol/atol 1e-3), prefill 64 + decode 32 against its own forward over
    96 (1e-3); (c) the f32 policy (remat, bfloat16 compute) at full width,
    2 steps at B = 8, T = 128 (`lm_train_run`): every loss finite, the
    first step's batch evaluated again after the two below its first
    loss (step ms split, tokens/s, peak memory; the busy share and top
    kernels of a step over 32 tokens); (d)
    the cut's float32 loss, grad norm (rtol 1e-3) and every gradient leaf
    (`hold_gradients`), card against CPU; (e) jamba-v0.1-52b cut to one
    period of its pattern (8 layers: 7 Mamba, 1 attention, 4 MoE channels
    of 16 experts top 2) at full width with bfloat16 parameters, generate
    at B = 2, P = 512 (two Mamba chunks), 16 new, twice, bit-equal
    (prefill ms, decode ms a step, peak memory); then one of its Mamba
    mixers alone at full width in float32, TF32 off: mamba_forward over
    512, output and state, card against CPU (rtol/atol 1e-3), and prefill
    256 + 16 mamba_decode steps against that forward's positions 256-271
    (1e-3); (f) python -m repro_torch.launch.serve and launch.train (1
    step at B = 4, T = 32) for xlstm-125m as subprocesses, exit 0 and
    their last lines; (g) (c)'s
    Telemetry through BlinkQLService (`telemetry_blinkql`)."""
    import copy
    import gc
    import os
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, SyntheticTokenStream
    from repro_torch.models import mamba as mamba_lib
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import ParamFactory
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.train import optim as optim_lib
    from repro_torch.train import step as step_lib

    t_phase = time.perf_counter()
    out = {}
    cfg = get_config(XLSTM_ARCH)

    # (a) serving at full width and depth
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    prompts = lm_prompts(np, cfg, LM_BATCH, LM_PROMPT, 3)
    engine = ServeEngine(cfg, model, ServeConfig(batch=LM_BATCH))
    _, a = serve_twice(torch, np, engine, prompts, LM_NEW, cfg.vocab_size,
                       "(a)")
    dev_ms, wall_ms, top = profiled_ms(
        torch, lambda: engine.generate(prompts[:, :XLSTM_PROFILED_PROMPT], 8))
    a.update(params=n_params, device_ms_8_new=dev_ms, wall_ms_8_new=wall_ms,
             top_kernels=top,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    out["serve"] = a
    log(f"  (a) {cfg.name} at full width and depth ({cfg.n_layers} layers, "
        f"{n_params} float32 parameters), ServeEngine.generate, bfloat16 "
        f"compute, float32 states, B = {LM_BATCH}, P = {LM_PROMPT}, "
        f"{LM_NEW} new ({card}): first call (2 new) "
        f"{a['first_call_s']:.3f}s; prefill {a['prefill_ms']:.3f} ms "
        f"(generate of 1 new, median of 3); generate {a['generate_s']:.3f}s "
        f"({', '.join(f'{s:.3f}' for s in a['generate_runs_s'])}), decode "
        f"{a['decode_ms_per_step']:.3f} ms a step, {a['tok_per_s']:.1f} "
        f"tok/s; two runs bit-equal; device busy over an 8-new generate "
        f"from a {XLSTM_PROFILED_PROMPT}-token prompt: "
        f"{busy_text(dev_ms, wall_ms)}; torch.cuda.max_memory_allocated "
        f"{a['max_memory_allocated']}; {time.perf_counter() - t0:.2f}s")
    log("  (a) kernels of most device time over that generate: " +
        "; ".join(f"{name[:60]} {ms:.3f} ms x{n}" for name, ms, n in top))
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) a 2-layer cut at full width: logits, card against CPU
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS)
    cut_cpu = model_lib.init_params(cut, torch.Generator().manual_seed(1))
    cut_card = copy.deepcopy(cut_cpu).to(device)
    ctoks = torch.from_numpy(lm_prompts(np, cut, 2, 32, 2))
    with no_tf32(torch), torch.no_grad():
        want, _, _ = model_lib.forward(cut_cpu, cut, ctoks,
                                       compute_dtype=torch.float32)
        got, _, _ = model_lib.forward(cut_card, cut, ctoks.to(device),
                                      compute_dtype=torch.float32)
    out["card_vs_cpu"] = {"logits_ratio": hold_close(
        torch, f"(b) {LM_CUT_LAYERS}-layer cut [mLSTM, sLSTM], float32 "
        f"logits, card against CPU", got, want, 1e-3, 1e-3)}
    ptoks = torch.from_numpy(lm_prompts(np, cut, 2, 96, 4)).to(device)
    with no_tf32(torch), torch.no_grad():
        full, _, _ = model_lib.forward(cut_card, cut, ptoks, "train",
                                       compute_dtype=torch.float32)
        caches = model_lib.init_cache(cut, 2, 96, dtype=torch.float32,
                                      device=device)
        logits, caches = model_lib.prefill(cut_card, cut, ptoks[:, :64],
                                           caches,
                                           compute_dtype=torch.float32)
        steps = [logits]
        for t in range(64, 96):
            lg, caches, _ = model_lib.forward(cut_card, cut,
                                              ptoks[:, t:t + 1], "decode",
                                              caches, t, torch.float32)
            steps.append(lg)
    out["card_vs_cpu"]["own_forward_ratio"] = hold_close(
        torch, "(b) prefill 64 + decode 32 against the forward over 96",
        torch.cat(steps, dim=1), full, 1e-3, 1e-3)
    log(f"  (b) {time.perf_counter() - t0:.2f}s")
    del full, steps, caches, want, got

    # (d) the cut under the f32 policy: one step's gradients, card vs CPU
    t0 = time.perf_counter()
    batch = lm_batch(torch, SyntheticTokenStream(
        DataConfig(cut.vocab_size, 32, 2, seed=2)))
    with no_tf32(torch):
        want = loss_and_grads(torch, cut_cpu, cut, batch, optim_lib,
                              model_lib)
        got = loss_and_grads(torch, cut_card, cut, batch, optim_lib,
                             model_lib)
    ratios = [hold_close(torch, f"(d) {name}, card against CPU", g, w, 1e-3,
                         1e-3)
              for name, g, w in (("loss", got[0], want[0]),
                                 ("grad norm", got[1], want[1]))]
    held = hold_gradients(torch, "(d)", got[2], want[2], ZERO_GRADIENT)
    out["gradients"] = {"loss": want[0].item(), "ratios": ratios, **held}
    log(f"  (d) {len(got[2])} gradient leaves within rtol 1e-3 / atol 1e-5 "
        f"(exempt, |g| <= 1e-4 of the leaf's largest, within 1e-3 of it: "
        f"{held['exempt']}), worst ratio {held['worst_ratio']:.3f} "
        f"({held['worst_leaf']}); {time.perf_counter() - t0:.2f}s")
    del cut_cpu, cut_card, want, got
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the f32 policy at full width and depth
    t0 = time.perf_counter()
    c, telemetry = lm_train_run(torch, step_lib.StepConfig(),
                                XLSTM_TRAIN_STEPS, device, cfg,
                                profile_seq=XLSTM_PROFILED_SEQ)
    out["train"] = c
    losses = c["losses"]
    if len(losses) != XLSTM_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"(c): losses {losses}")
    if not c["first_batch_after"] < losses[0]:
        raise AssertionError(f"(c): the first batch's loss did not fall: "
                             f"{losses[0]} -> {c['first_batch_after']}")
    log(f"  (c) {cfg.name} at full width and depth, f32 policy, remat, "
        f"bfloat16 compute, B = {LM_TRAIN_BATCH}, T = {LM_TRAIN_SEQ}: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)} (finite; each step its "
        f"own batch); the first batch again after {XLSTM_TRAIN_STEPS} steps "
        f"{c['first_batch_after']:.4f}, below its {losses[0]:.4f}")
    log(f"  (c) step {c['median_step_ms']:.3f} ms (median of steps 2-"
        f"{XLSTM_TRAIN_STEPS}; first {c['step_ms'][0]:.3f}): forward+backward "
        f"{c['median_fwd_bwd_ms']:.3f} ms, optimizer "
        f"{c['median_optimizer_ms']:.3f} ms; {c['tokens_per_s']:.1f} "
        f"tokens/s; device busy: a step over the batch's first "
        f"{XLSTM_PROFILED_SEQ} tokens, its device time (device trace only) "
        f"over its unprofiled time "
        f"{busy_text(c['device_ms_one_step'], c['busy_of_ms'])}"
        f"; torch.cuda.max_memory_allocated {c['max_memory_allocated']} "
        f"({card}); {time.perf_counter() - t0:.2f}s")
    log("  (c) the profiled step's kernels of most device time: " + "; ".join(
        f"{name[:60]} {ms:.3f} ms x{n}" for name, ms, n in c["top_kernels"]))
    gc.collect()
    torch.cuda.empty_cache()

    # (e) jamba's one period at full width, bfloat16 parameters
    t0 = time.perf_counter()
    jcfg = dataclasses.replace(get_config(JAMBA_ARCH),
                               n_layers=len(get_config(JAMBA_ARCH).pattern))
    torch.cuda.reset_peak_memory_stats()
    jamba = model_lib.init_params(
        jcfg, torch.Generator(device=device).manual_seed(0), torch.bfloat16)
    n_jamba = sum(p.numel() for p in jamba.parameters())
    prompts = lm_prompts(np, jcfg, JAMBA_BATCH, JAMBA_PROMPT, 5)
    engine = ServeEngine(jcfg, jamba, ServeConfig(batch=JAMBA_BATCH))
    _, e = serve_twice(torch, np, engine, prompts, JAMBA_NEW,
                       jcfg.vocab_size, "(e)")
    e.update(params=n_jamba,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    out["jamba"] = e
    log(f"  (e) {jcfg.name} cut to {jcfg.n_layers} layers (one period: "
        f"{sum(s.mixer == 'mamba' for s in jcfg.pattern)} Mamba, "
        f"{sum(s.mixer == 'attn' for s in jcfg.pattern)} attention, "
        f"{sum(s.channel == 'moe' for s in jcfg.pattern)} MoE channels of "
        f"{jcfg.n_experts} experts top {jcfg.top_k}) at full width, "
        f"{n_jamba} bfloat16 parameters, ServeEngine.generate, B = "
        f"{JAMBA_BATCH}, P = {JAMBA_PROMPT} (Mamba chunk {jcfg.mamba_chunk})"
        f", {JAMBA_NEW} new ({card}): first call {e['first_call_s']:.3f}s; "
        f"prefill {e['prefill_ms']:.3f} ms; decode "
        f"{e['decode_ms_per_step']:.3f} ms a step, {e['tok_per_s']:.1f} "
        f"tok/s; two runs bit-equal; torch.cuda.max_memory_allocated "
        f"{e['max_memory_allocated']} (3k's models freed, phase 3's tables "
        f"held); {time.perf_counter() - t0:.2f}s")
    del engine, jamba
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dims = model_lib.mamba_dims(jcfg)
    mixer = mamba_lib.Mamba(ParamFactory(torch.Generator().manual_seed(5)),
                            dims)
    p_cpu = {k: v.detach() for k, v in mixer.named_parameters()}
    p_card = {k: v.to(device) for k, v in p_cpu.items()}
    xs = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (1, JAMBA_PROMPT, jcfg.d_model)).astype(np.float32))
    chunk = jcfg.mamba_chunk
    with no_tf32(torch), torch.no_grad():
        want, want_st = mamba_lib.mamba_forward(p_cpu, xs, dims, chunk)
        got, got_st = mamba_lib.mamba_forward(p_card, xs.to(device), dims,
                                              chunk)
        half = JAMBA_PROMPT // 2
        _, st = mamba_lib.mamba_forward(p_card, xs[:, :half].to(device),
                                        dims, chunk)
        steps = []
        for t in range(half, half + JAMBA_NEW):
            y, st = mamba_lib.mamba_decode(p_card, xs[:, t:t + 1].to(device),
                                           dims, st)
            steps.append(y)
    out["jamba_mixer"] = {
        "output_ratio": hold_close(
            torch, f"(e) Mamba mixer at full width (d_inner {dims.d_inner}, "
            f"d_state {dims.d_state}), mamba_forward over {JAMBA_PROMPT} in "
            f"chunks of {chunk}, float32, card against CPU", got, want,
            1e-3, 1e-3),
        "h_last_ratio": hold_close(torch, "(e) its h_last, card against CPU",
                                   got_st.ssm, want_st.ssm, 1e-3, 1e-3),
        "conv_ratio": hold_close(torch, "(e) its conv state, card against "
                                 "CPU", got_st.conv, want_st.conv, 1e-3,
                                 1e-3),
        "decode_ratio": hold_close(
            torch, f"(e) prefill {half} + {JAMBA_NEW} mamba_decode steps "
            f"against the forward's positions {half}-"
            f"{half + JAMBA_NEW - 1}", torch.cat(steps, dim=1),
            got[:, half:half + JAMBA_NEW], 1e-3, 1e-3)}
    log(f"  (e) the Mamba mixer held; {time.perf_counter() - t0:.2f}s")
    del mixer, p_cpu, p_card, want, got, steps

    # (g) (c)'s telemetry through BlinkQL, every fused launch held to plain
    out["telemetry"] = telemetry_blinkql(torch, np, telemetry,
                                         XLSTM_TRAIN_STEPS, device, "(g)")

    # (f) the entry points as a user runs them
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out["launch_lines"] = []
    with tempfile.TemporaryDirectory(prefix="xlstm_launch_") as tmp:
        for module, args, tag in (
                ("repro_torch.launch.serve", XLSTM_SERVE_ARGS, "[serve]"),
                ("repro_torch.launch.train",
                 XLSTM_TRAIN_ARGS + ["--ckpt-dir", tmp], "[train]")):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", module, *args],
                                  env=env, capture_output=True, text=True,
                                  timeout=600)
            line = [x for x in proc.stdout.splitlines() if x.startswith(tag)]
            if proc.returncode != 0 or not line:
                raise AssertionError(
                    f"(f): {module} exited {proc.returncode}\n"
                    f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            out["launch_lines"].append(line[-1])
            log(f"  (f) python -m {module} {' '.join(args)}: {line[-1]} "
                f"({time.perf_counter() - t0:.2f}s with start-up)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 3l ok: {cfg.name} at full width served (bit-equal runs) "
        f"and trained, a cut's logits and gradients held to the CPU, "
        f"{jcfg.name}'s period served at full width and its Mamba mixer "
        f"held to the CPU, launch.serve and launch.train exit 0, the "
        f"telemetry answered through the fused kernel; "
        f"{out['seconds']:.1f}s")
    return out


# ----------------------------------------------------------------- phase 3m

MUSICGEN_ARCH = "musicgen-large"   # 48 layers, 4 codebooks x 2048, 3.255B
MUSICGEN_TRAIN_STEPS = 5
MUSICGEN_SERVE_ARGS = ["--arch", MUSICGEN_ARCH]   # B 4, P 16, 32 new
VISION_ARCH = "llama-3.2-vision-90b"   # cut to one period: 5 of 100 layers
VISION_BATCH, VISION_PROMPT, VISION_NEW = 2, 128, 16
VISION_SERVE_ARGS = ["--arch", VISION_ARCH]
XATTN_GATE = 0.5   # a nonzero gate: at the init's 0 the layer adds nothing


class CodebookStream:
    """Phase 3m (c)'s batches: K codebook streams of the synthetic corpus,
    tokens and labels [B, K, T], one SyntheticTokenStream row (numpy from
    its seed) per (example, codebook), each example's domain that of its
    first codebook; the loop reads `next_batch` as SyntheticTokenStream's."""

    def __init__(self, data_cfg, k: int):
        from repro_torch.data.tokens import SyntheticTokenStream
        self.cfg, self.k = data_cfg, k
        self.rows = SyntheticTokenStream(dataclasses.replace(
            data_cfg, global_batch=data_cfg.global_batch * k))

    def next_batch(self) -> dict:
        b = self.rows.next_batch()
        shape = (self.cfg.global_batch, self.k, self.cfg.seq_len)
        return {"tokens": b["tokens"].reshape(shape),
                "labels": b["labels"].reshape(shape),
                "domain": b["domain"][::self.k]}


def set_gates(torch, model, value: float) -> int:
    """Every xattn layer's gate set to `value`; returns their count."""
    n = 0
    with torch.no_grad():
        for layer in model.layers:
            if hasattr(layer, "xattn"):
                layer.xattn.gate.fill_(value)
                n += layer.xattn.gate.numel()
    return n


def vision_source(np, cfg, batch: int, seed: int):
    """The stub vision tower's output: [batch, n_vision_tokens, d_vision]
    normal draws (float32) from a seed."""
    return np.random.default_rng(seed).normal(
        0, 1, (batch, cfg.n_vision_tokens, cfg.d_vision)).astype(np.float32)


def phase_lm_xattn_codebooks(torch, np, card: str, device="cuda") -> dict:
    """The LM substrate's audio codebooks and cross-attention
    (DecoderLM's [K, V, D] embedding and [K, D, V] head, the xattn layers
    and vision_proj, through ServeEngine, make_train_step, launch.serve):
    (a) musicgen-large at full width and depth (48 layers, 4 codebooks of
    2048, 3.255B parameters from a seeded generator), ServeEngine.generate
    in bfloat16 at B = 8, P = 128, 64 new, prompts [8, 4, 128], twice,
    bit-equal, output (8, 4, 192) (prefill ms, decode ms a step, tok/s
    counting a position's 4 codebook tokens as one, busy share, top
    kernels, peak memory); (b) its 2-layer cut in float32, TF32 off:
    logits [B, K, S, V] card against CPU (rtol/atol 1e-3), greedy tokens
    equal, prefill 64 + decode 32 against its own forward over 96 (1e-3);
    (c) the lowmem policy at full width, 5 steps at B = 8, T = 128 of
    [8, 4, 129] codebook streams (`CodebookStream`) through lm_train_run:
    the losses finite, the first batch's loss lower after the five (step
    ms, tokens/s counting B·T, busy share, peak memory), and the cut's
    float32 gradients, card against CPU (`hold_gradients`); (d)
    llama-3.2-vision-90b cut to one period (5 layers: 4 attention, 1
    cross-attention, each with its MLP) at full width in bfloat16
    parameters, its gate at 0.5, generate at B = 2, P = 128, 16 new with
    a [2, 1601, 1280] vision source, twice, bit-equal (prefill ms, decode
    ms a step, peak memory); one cross_attention at full width in float32
    (x [2, 128, 8192], a projected source [2, 1601, 8192], gate 0.5): its
    output and the gradients of wq, wk, wv, wo and the gate, card against
    CPU; the period reduced in width, prefill 16 + decode 16 against its
    forward (1e-3); (e) python -m repro_torch.launch.serve --arch
    musicgen-large as a subprocess, exit 0 and output (4, 4, 48), and
    --arch llama-3.2-vision-90b, a non-zero exit with the xattn layers'
    ValueError (the launcher passes no source, as the reference's); (f)
    (c)'s Telemetry through BlinkQLService (`telemetry_blinkql`)."""
    import copy
    import gc
    import os
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import ParamFactory
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.train import optim as optim_lib
    from repro_torch.train import step as step_lib

    @dataclasses.dataclass(frozen=True)
    class F32Step(step_lib.StepConfig):
        @property
        def compute_dtype(self):
            return torch.float32

    t_phase = time.perf_counter()
    out = {}
    cfg = get_config(MUSICGEN_ARCH)

    # (a) musicgen served at full width and depth
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    extra = cfg.n_layers * 2 * cfg.d_model + cfg.d_model   # the norms
    if n_params != cfg.param_count() + extra:
        raise AssertionError(f"{n_params} parameters, not "
                             f"{cfg.param_count()} + {extra}")
    prompts = lm_prompts(np, cfg, LM_BATCH, LM_PROMPT, 3)
    engine = ServeEngine(cfg, model, ServeConfig(batch=LM_BATCH))
    run1, a = serve_twice(torch, np, engine, prompts, LM_NEW, cfg.vocab_size,
                          "(a)")
    if run1.shape != (LM_BATCH, cfg.n_codebooks, LM_PROMPT + LM_NEW) or \
            not np.array_equal(run1[..., :LM_PROMPT], prompts):
        raise AssertionError(f"(a): output {run1.shape}, prompts not kept")
    dev_ms, wall_ms, top = profiled_ms(
        torch, lambda: engine.generate(prompts, 8))
    a.update(params=n_params, output_shape=list(run1.shape),
             device_ms_8_new=dev_ms, wall_ms_8_new=wall_ms,
             device_busy_share=dev_ms / wall_ms, top_kernels=top,
             max_memory_allocated=torch.cuda.max_memory_allocated())
    out["serve"] = a
    log(f"  (a) {cfg.name} at full width and depth ({cfg.n_layers} layers, "
        f"{cfg.n_codebooks} codebooks of {cfg.vocab_size}, {n_params} "
        f"float32 parameters), ServeEngine.generate, bfloat16 compute, B = "
        f"{LM_BATCH}, prompts {prompts.shape}, {LM_NEW} new ({card}): first "
        f"call (2 new) {a['first_call_s']:.3f}s; prefill "
        f"{a['prefill_ms']:.3f} ms (generate of 1 new, median of 3); "
        f"generate {a['generate_s']:.3f}s "
        f"({', '.join(f'{s:.3f}' for s in a['generate_runs_s'])}), decode "
        f"{a['decode_ms_per_step']:.3f} ms a step, {a['tok_per_s']:.1f} "
        f"tok/s (a position's {cfg.n_codebooks} codebook tokens counted as "
        f"one); output {run1.shape}, two runs bit-equal; device busy over "
        f"an 8-new generate: {busy_text(dev_ms, wall_ms)}; "
        f"torch.cuda.max_memory_allocated {a['max_memory_allocated']}; "
        f"{time.perf_counter() - t0:.2f}s")
    log("  (a) kernels of most device time over the 8-new generate: " +
        "; ".join(f"{name[:60]} {ms:.3f} ms x{n}" for name, ms, n in top))
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) a 2-layer cut at full width: logits and tokens, card against CPU
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS)
    cut_cpu = model_lib.init_params(cut, torch.Generator().manual_seed(1))
    cut_card = copy.deepcopy(cut_cpu).to(device)
    ctoks = torch.from_numpy(lm_prompts(np, cut, 2, 32, 2))
    with no_tf32(torch), torch.no_grad():
        want, _, _ = model_lib.forward(cut_cpu, cut, ctoks,
                                       compute_dtype=torch.float32)
        got, _, _ = model_lib.forward(cut_card, cut, ctoks.to(device),
                                      compute_dtype=torch.float32)
        if got.shape != (2, cut.n_codebooks, 32, cut.vocab_size):
            raise AssertionError(f"(b): logits {tuple(got.shape)}")
        out["card_vs_cpu"] = {"logits_ratio": hold_close(
            torch, f"(b) {LM_CUT_LAYERS}-layer cut, float32 logits [B, K, S, "
            f"V], card against CPU", got, want, 1e-3, 1e-3)}
        cut_prompts = ctoks[..., :16].numpy()
        tok_cpu = ServeEngine(cut, cut_cpu, ServeConfig(), F32Step()
                              ).generate(cut_prompts, 8)
        tok_card = ServeEngine(cut, cut_card, ServeConfig(), F32Step()
                               ).generate(cut_prompts, 8)
    if not np.array_equal(tok_card, tok_cpu):
        raise AssertionError(f"(b): greedy tokens differ\n{tok_card}\n"
                             f"{tok_cpu}")
    ptoks = torch.from_numpy(lm_prompts(np, cut, 2, 96, 4)).to(device)
    with no_tf32(torch), torch.no_grad():
        full, _, _ = model_lib.forward(cut_card, cut, ptoks, "train",
                                       compute_dtype=torch.float32)
        caches = model_lib.init_cache(cut, 2, 96, dtype=torch.float32,
                                      device=device)
        logits, caches = model_lib.prefill(cut_card, cut, ptoks[..., :64],
                                           caches,
                                           compute_dtype=torch.float32)
        steps = [logits]
        for t in range(64, 96):
            lg, caches, _ = model_lib.forward(cut_card, cut,
                                              ptoks[..., t:t + 1], "decode",
                                              caches, t, torch.float32)
            steps.append(lg)
    out["card_vs_cpu"]["own_forward_ratio"] = hold_close(
        torch, "(b) prefill 64 + decode 32 against the forward over 96",
        torch.cat(steps, dim=2), full, 1e-3, 1e-3)
    log(f"  (b) greedy tokens {tok_card.shape} equal on card and CPU; "
        f"{time.perf_counter() - t0:.2f}s")
    del full, steps, caches, want, got

    # (c) the cut under the f32 policy: one step's gradients, card vs CPU
    t0 = time.perf_counter()
    batch = lm_batch(torch, CodebookStream(
        DataConfig(cut.vocab_size, 32, 2, seed=2), cut.n_codebooks))
    with no_tf32(torch):
        want = loss_and_grads(torch, cut_cpu, cut, batch, optim_lib,
                              model_lib)
        got = loss_and_grads(torch, cut_card, cut, batch, optim_lib,
                             model_lib)
    ratios = [hold_close(torch, f"(c) {name}, card against CPU", g, w, 1e-3,
                         1e-3)
              for name, g, w in (("loss", got[0], want[0]),
                                 ("grad norm", got[1], want[1]))]
    held = hold_gradients(torch, "(c)", got[2], want[2])
    out["gradients"] = {"loss": want[0].item(), "ratios": ratios, **held}
    log(f"  (c) {len(got[2])} gradient leaves (the [K, V, D] embed and "
        f"[K, D, V] head among them) within rtol 1e-3 / atol 1e-5 (exempt, "
        f"|g| <= 1e-4 of the leaf's largest, within 1e-3 of it: "
        f"{held['exempt']}), worst ratio {held['worst_ratio']:.3f} "
        f"({held['worst_leaf']}); {time.perf_counter() - t0:.2f}s")
    del cut_cpu, cut_card, want, got
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the lowmem policy at full width and depth, codebook batches
    t0 = time.perf_counter()
    c, telemetry = lm_train_run(
        torch, step_lib.StepConfig(policy="lowmem"), MUSICGEN_TRAIN_STEPS,
        device, cfg, make_stream=lambda cfg: CodebookStream(
            DataConfig(cfg.vocab_size, LM_TRAIN_SEQ, LM_TRAIN_BATCH, seed=0),
            cfg.n_codebooks))
    out["lowmem"] = c
    losses = c["losses"]
    if len(losses) != MUSICGEN_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"(c): losses {losses}")
    if not c["first_batch_after"] < losses[0]:
        raise AssertionError(f"(c): the first batch's loss did not fall: "
                             f"{losses[0]} -> {c['first_batch_after']}")
    log(f"  (c) {cfg.name} at full width and depth, lowmem (bfloat16 "
        f"parameters, int8 moments), remat, bfloat16 compute, B = "
        f"{LM_TRAIN_BATCH}, T = {LM_TRAIN_SEQ}, tokens [{LM_TRAIN_BATCH}, "
        f"{cfg.n_codebooks}, {LM_TRAIN_SEQ + 1}] a step: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)} (finite; each step its "
        f"own batch); the first batch again after {MUSICGEN_TRAIN_STEPS} "
        f"steps {c['first_batch_after']:.4f}, below its {losses[0]:.4f}")
    log(f"  (c) step {c['median_step_ms']:.3f} ms (median of steps 2-"
        f"{MUSICGEN_TRAIN_STEPS}; first {c['step_ms'][0]:.3f}): "
        f"forward+backward {c['median_fwd_bwd_ms']:.3f} ms, optimizer "
        f"{c['median_optimizer_ms']:.3f} ms; {c['tokens_per_s']:.1f} "
        f"tokens/s (B·T a step; the {cfg.n_codebooks} codebook tokens of a "
        f"position counted as one); device busy: a profiled step's device "
        f"time over the median step "
        f"{busy_text(c['device_ms_one_step'], c['median_step_ms'])}; "
        f"torch.cuda.max_memory_allocated {c['max_memory_allocated']} "
        f"({card}); {time.perf_counter() - t0:.2f}s")
    log("  (c) the profiled step's kernels of most device time: " + "; ".join(
        f"{name[:60]} {ms:.3f} ms x{n}" for name, ms, n in c["top_kernels"]))
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the vision period at full width, bfloat16 parameters
    t0 = time.perf_counter()
    vcfg = dataclasses.replace(get_config(VISION_ARCH),
                               n_layers=len(get_config(VISION_ARCH).pattern))
    torch.cuda.reset_peak_memory_stats()
    vlm = model_lib.init_params(
        vcfg, torch.Generator(device=device).manual_seed(0), torch.bfloat16)
    gates = set_gates(torch, vlm, XATTN_GATE)
    n_vlm = sum(p.numel() for p in vlm.parameters())
    vprompts = lm_prompts(np, vcfg, VISION_BATCH, VISION_PROMPT, 5)
    vision = vision_source(np, vcfg, VISION_BATCH, 6)
    engine = ServeEngine(vcfg, vlm, ServeConfig(batch=VISION_BATCH))
    _, e = serve_twice(torch, np, engine, vprompts, VISION_NEW,
                       vcfg.vocab_size, "(d)", vision)
    e.update(params=n_vlm, param_count=vcfg.param_count(),
             max_memory_allocated=torch.cuda.max_memory_allocated())
    out["vision"] = e
    log(f"  (d) {vcfg.name} cut to {vcfg.n_layers} layers (one period: "
        f"{sum(s.mixer == 'attn' for s in vcfg.pattern)} attention, "
        f"{sum(s.mixer == 'xattn' for s in vcfg.pattern)} cross-attention, "
        f"each with its MLP) at full width, {n_vlm} bfloat16 parameters "
        f"(param_count {vcfg.param_count()}: it counts xattn's wk/wv at "
        f"d_vision), {gates} gate(s) at {XATTN_GATE}, "
        f"ServeEngine.generate, B = {VISION_BATCH}, P = {VISION_PROMPT}, "
        f"vision {vision.shape}, {VISION_NEW} new ({card}): first call "
        f"{e['first_call_s']:.3f}s; prefill {e['prefill_ms']:.3f} ms; "
        f"decode {e['decode_ms_per_step']:.3f} ms a step, "
        f"{e['tok_per_s']:.1f} tok/s; two runs bit-equal; "
        f"torch.cuda.max_memory_allocated {e['max_memory_allocated']}; "
        f"{time.perf_counter() - t0:.2f}s")
    del engine, vlm
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dims = model_lib.attn_dims(vcfg)
    layer = attn_lib.CrossAttention(
        ParamFactory(torch.Generator().manual_seed(5)), dims, vcfg.d_model)
    with torch.no_grad():
        layer.gate.fill_(XATTN_GATE)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(0, 1, (VISION_BATCH, VISION_PROMPT,
                                           vcfg.d_model)).astype(np.float32))
    src = torch.from_numpy(rng.normal(0, 1, (
        VISION_BATCH, vcfg.n_vision_tokens, vcfg.d_model)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(0, 1, tuple(x.shape)).astype(
        np.float32))

    def xattn_grads(dev):
        p = {k: v.detach().to(dev).requires_grad_()
             for k, v in layer.named_parameters()}
        y = attn_lib.cross_attention(p, x.to(dev), src.to(dev), dims)
        grads = torch.autograd.grad((y * cot.to(dev)).sum(), list(p.values()))
        return y.detach(), list(zip(p, grads))
    want_y, want_g = xattn_grads("cpu")
    with no_tf32(torch):
        got_y, got_g = xattn_grads(device)
    held = hold_gradients(torch, "(d) full-width cross_attention", got_g,
                          want_g)
    out["xattn"] = {
        "output_ratio": hold_close(
            torch, f"(d) cross_attention at full width (d {vcfg.d_model}, "
            f"{vcfg.n_heads} heads, {vcfg.n_kv_heads} KV heads, dh "
            f"{vcfg.head_dim}), x {tuple(x.shape)}, source "
            f"{tuple(src.shape)}, gate {XATTN_GATE}, float32, card against "
            f"CPU", got_y, want_y, 1e-3, 1e-3), **held}
    log(f"  (d) its gradients ({', '.join(n for n, _ in got_g)}) within "
        f"rtol 1e-3 / atol 1e-5 (exempt: {held['exempt']}), worst ratio "
        f"{held['worst_ratio']:.3f} ({held['worst_leaf']}); "
        f"{time.perf_counter() - t0:.2f}s")
    del layer, want_g, got_g
    small = dataclasses.replace(get_config(VISION_ARCH).reduced(),
                                n_layers=len(vcfg.pattern))
    sm = model_lib.init_params(small, torch.Generator().manual_seed(8)
                               ).to(device)
    set_gates(torch, sm, XATTN_GATE)
    stoks = torch.from_numpy(lm_prompts(np, small, 2, 32, 9)).to(device)
    svis = torch.from_numpy(vision_source(np, small, 2, 10)).to(device)
    with no_tf32(torch), torch.no_grad():
        full, _, _ = model_lib.forward(sm, small, stoks, "train",
                                       compute_dtype=torch.float32,
                                       vision=svis)
        caches = model_lib.init_cache(small, 2, 32, dtype=torch.float32,
                                      device=device)
        logits, caches = model_lib.prefill(sm, small, stoks[:, :16], caches,
                                           compute_dtype=torch.float32,
                                           vision=svis)
        steps = [logits]
        for t in range(16, 32):
            lg, caches, _ = model_lib.forward(sm, small, stoks[:, t:t + 1],
                                              "decode", caches, t,
                                              torch.float32, vision=svis)
            steps.append(lg)
    out["xattn"]["own_forward_ratio"] = hold_close(
        torch, f"(d) {small.name} ({small.n_layers} layers, d "
        f"{small.d_model}), prefill 16 + decode 16 against its forward over "
        f"32", torch.cat(steps, dim=1), full, 1e-3, 1e-3)
    del sm, full, steps, caches

    # (f) (c)'s telemetry through BlinkQL, every fused launch held to plain
    out["telemetry"] = telemetry_blinkql(torch, np, telemetry,
                                         MUSICGEN_TRAIN_STEPS, device,
                                         "(f) musicgen")

    # (e) the entry point as a user runs it, for both archs
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out["launch_lines"] = []
    for args, ok in ((MUSICGEN_SERVE_ARGS, True), (VISION_SERVE_ARGS, False)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.serve", *args], env=env,
                              capture_output=True, text=True, timeout=600)
        line = [x for x in proc.stdout.splitlines() if x.startswith("[serve]")]
        if ok and (proc.returncode != 0 or not line
                   or "output (4, 4, 48)" not in line[-1]):
            raise AssertionError(f"(e): launch.serve {' '.join(args)} exited "
                                 f"{proc.returncode}\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        if not ok and (proc.returncode == 0 or line or
                       "ValueError" not in proc.stderr
                       or "vision source" not in proc.stderr):
            raise AssertionError(f"(e): launch.serve {' '.join(args)} did not "
                                 f"refuse with the ValueError (exit "
                                 f"{proc.returncode})\n{proc.stderr[-4000:]}")
        said = line[-1] if ok else proc.stderr.strip().splitlines()[-1]
        out["launch_lines"].append(said)
        log(f"  (e) python -m repro_torch.launch.serve {' '.join(args)}: "
            f"exit {proc.returncode}, {said} ({time.perf_counter() - t0:.2f}s "
            f"with start-up)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 3m ok: {cfg.name} at full width served (bit-equal runs) and "
        f"trained (lowmem), a cut's logits, tokens and gradients held to the "
        f"CPU, {vcfg.name}'s period served at full width and its "
        f"cross-attention held to the CPU, launch.serve exit 0 and the "
        f"vision arch's refusal, the telemetry answered through the fused "
        f"kernel; {out['seconds']:.1f}s")
    return out


# ----------------------------------------------------------------- phase 3n

MESH_LM_LAYERS = 2        # qwen2-1.5b's widths, 2 of its 28 layers (PERF.md §4)
MESH_LM_MODEL_AXIS = 2    # a (2, 2) (data, model) mesh of 4 ranks on one card
MESH_LM_WORLD = 4
MESH_LM_STEPS = 3         # (a): step 0, then two more
MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_NEW = 4, 64, 8   # (b)
MESH_RTOL = 1e-4
MESH_PEAK_RTOL = 0.10     # (b): a serving rank's peak against meta's
# (d): the launcher in a world of 2 on xlstm-125m at full width and depth
# (its 0.16B parameters keep the gathers short; qwen2's 28 layers took
# 44.5 s there; a recurrent pattern through the mesh step on the card)
MESH_LAUNCH_ARGS = ["--arch", "xlstm-125m", "--steps", "1", "--batch", "2",
                    "--seq", "16", "--ckpt-every", "0"]


def mesh_lm_config():
    """qwen2-1.5b at full width, its depth cut to MESH_LM_LAYERS."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_ARCH), n_layers=MESH_LM_LAYERS)


def f32_step_config(policy: str = "f32"):
    """StepConfig(policy) with float32 compute (the holds' precision)."""
    import torch
    from repro_torch.train import step as step_lib

    class F32Compute(step_lib.StepConfig):
        @property
        def compute_dtype(self):
            return torch.float32
    return F32Compute(policy=policy)


def mesh_stream(cfg):
    from repro_torch.data.tokens import DataConfig, SyntheticTokenStream
    return SyntheticTokenStream(DataConfig(cfg.vocab_size, LM_TRAIN_SEQ,
                                           LM_TRAIN_BATCH, seed=0))


def mesh_prompts(np, cfg):
    return lm_prompts(np, cfg, MESH_SERVE_BATCH, MESH_SERVE_PROMPT, seed=7)


def leaf_digests(tree) -> dict:
    """sha1 of each leaf's bytes, by path (bfloat16 as its bits)."""
    import hashlib
    import torch
    from repro_torch.checkpoint.ckpt import flatten_with_paths
    out = {}
    for path, t in flatten_with_paths(tree):
        t = t.detach().contiguous().cpu()
        out[path] = hashlib.sha1(t.reshape(-1).view(
            torch.uint8).numpy().tobytes()).hexdigest()
    return out


def mesh_one_device(torch, np, cfg, device) -> dict:
    """The single-device port at the phase's depth, before the ranks
    start: (b)'s prefill logits (float32 numpy) and greedy tokens from the
    fresh weights, then (a)'s step 0 (loss, grad norm) on them."""
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.train import optim as optim_lib
    from repro_torch.train import step as step_lib
    step_cfg = f32_step_config()
    opt_cfg = optim_lib.OptConfig(**LM_OPT)
    with no_tf32(torch):
        model = model_lib.init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            torch.float32)
        prompts = mesh_prompts(np, cfg)
        caches = model_lib.init_cache(cfg, MESH_SERVE_BATCH,
                                      MESH_SERVE_PROMPT + MESH_SERVE_NEW,
                                      torch.float32, device)
        logits, _ = step_lib.make_prefill_step(cfg, step_cfg)(
            model, torch.from_numpy(prompts).to(device), caches)
        logits = logits.float().cpu().numpy()
        del caches
        engine = ServeEngine(cfg, model, ServeConfig(
            batch=MESH_SERVE_BATCH), step_cfg)
        tokens = engine.generate(prompts, MESH_SERVE_NEW)
        opt = optim_lib.init_opt_state(model.param_tree(),
                                       step_cfg.opt_config(opt_cfg))
        batch = lm_batch(torch, mesh_stream(cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step_lib.make_train_step(cfg, opt_cfg, step_cfg)(
            model, opt, batch)
        torch.cuda.synchronize()
        out = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
               "step_ms": 1e3 * (time.perf_counter() - t0),
               "logits": logits, "tokens": tokens}
    del model, opt, engine
    torch.cuda.empty_cache()
    return out


def lm_mesh_rank(job) -> dict:
    """Phase 3n's rank target in the world of 4: qwen2's cut on the (2, 2)
    mesh, every rank on the one card. (b) first, on the fresh placement:
    prefill (rank 0 writes the whole batch's logits to job["tmp"]) and
    ServeEngine.generate over sharded caches; then (a): MESH_LM_STEPS mesh
    steps (ms each, host clock, device synchronised), step 0's batch's loss
    again after them, the run's Telemetry, the rank's placed bytes against
    build_shardings' and its peak memory; then (c): the parameters
    gathered and saved by rank 0 (sha1 of every leaf)."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.ckpt import (CheckpointManager,
                                            flatten_with_paths)
    from repro_torch.launch import cells
    from repro_torch.launch.cells import cell_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.sharding import lm as mesh_lm
    from repro_torch.sharding import rules as rules_lib
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optim as optim_lib
    from repro_torch.train import step as step_lib
    device = job["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
    cfg = mesh_lm_config()
    step_cfg = f32_step_config()
    opt_cfg = optim_lib.OptConfig(**LM_OPT)
    mesh = make_host_mesh(MESH_LM_MODEL_AXIS)
    comm = mesh_lm.MeshComm(mesh)
    rules = cell_rules(cfg, mesh, False)
    out = {"rank": comm.rank, "mesh": rules_lib.mesh_extents(mesh)}
    with no_tf32(torch):
        t0 = time.perf_counter()
        model = model_lib.init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            torch.float32)
        params = mesh_lm.ShardedLM.place(model, comm, rules)
        del model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sh = step_lib.build_shardings(cfg, rules_lib.mesh_extents(mesh),
                                      rules, step_cfg, opt_cfg)
        out["placed_bytes"] = params.placed_bytes()
        out["predicted_bytes"] = step_lib.tree_bytes(sh["params_sharding"],
                                                     sh["params_sds"])
        out["place_s"] = time.perf_counter() - t0

        # (b) sharded-cache serving on the fresh weights: this rank's rows
        # of the prefill logits, and its peak against meta's count
        prompts = mesh_prompts(np, cfg)
        t0 = time.perf_counter()
        caches = mesh_lm.init_local_cache(
            params, MESH_SERVE_BATCH, MESH_SERVE_PROMPT + MESH_SERVE_NEW)
        out["cache_bytes"] = local_bytes(caches)
        (logits, _), out["serve_peak"], out["prefill_ms"] = serving_peak(
            torch, lambda: step_lib.make_prefill_step(cfg, step_cfg)(
                params, torch.from_numpy(prompts), caches),
            params.placed_bytes() + out["cache_bytes"])
        out["serve_peak_meta"] = cells.dry_serve_step(
            cfg, mesh, rules, step_cfg, torch.from_numpy(prompts),
            MESH_SERVE_PROMPT + MESH_SERVE_NEW,
            rank=comm.rank).memory["peak_bytes"]
        _, rows = mesh_lm.batch_rows(params, MESH_SERVE_BATCH)
        out["rows"] = (rows.start, rows.stop)
        np.save(f"{job['tmp']}/mesh_logits_{comm.rank}.npy",
                logits.float().cpu().numpy())
        del logits, caches
        engine = ServeEngine(cfg, params, ServeConfig(
            batch=MESH_SERVE_BATCH), step_cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["tokens"] = engine.generate(prompts, MESH_SERVE_NEW)
        torch.cuda.synchronize()
        out["generate_s"] = time.perf_counter() - t1
        out["serve_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

        # (a) the mesh train step
        opt = mesh_lm.init_opt_state(params, step_cfg.opt_config(opt_cfg))
        out["opt_bytes"] = sum(t.numel() * t.element_size()
                               for _, t in flatten_with_paths(opt))
        out["predicted_opt_bytes"] = step_lib.tree_bytes(sh["opt_sharding"],
                                                         sh["opt_sds"])
        stream = mesh_stream(cfg)
        step = step_lib.make_train_step(cfg, opt_cfg, step_cfg)
        telemetry = loop_lib.Telemetry()
        out["losses"], out["grad_norms"], out["step_ms"] = [], [], []
        out["collective_ms"] = []
        sent = dict(comm.bytes)
        first = None
        for i in range(MESH_LM_STEPS):
            raw = stream.next_batch()
            batch = {k: torch.from_numpy(v) for k, v in raw.items()
                     if k in ("tokens", "labels")}
            if first is None:
                first = batch
            before = sum(comm.seconds.values())
            sent_before = dict(comm.bytes)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            if i == 0:
                out["step0_bytes"] = {k: comm.bytes[k] - sent_before[k]
                                      for k in sent_before}
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
            out["collective_ms"].append(
                1e3 * (sum(comm.seconds.values()) - before))
            out["losses"].append(m["loss"].item())
            out["grad_norms"].append(m["grad_norm"].item())
            telemetry.log(i, m["loss"].item(), raw["domain"],
                          {"grad_norm": m["grad_norm"].item()})
        out["sent_bytes_a_step"] = {
            k: (comm.bytes[k] - sent[k]) / MESH_LM_STEPS for k in sent}
        # the same step counted on "meta" by a DryComm (launch/roofline.py)
        out["dry_bytes"] = cells.dry_train_step(
            cfg, mesh, rules, step_cfg, opt_cfg, first, comm.rank).bytes
        again, _ = mesh_lm.loss_and_grads(params, cfg, first, step_cfg,
                                          grads=False)
        out["first_batch_after"] = again["loss"].item()
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        if comm.rank == 0:
            out["telemetry"] = telemetry

        # (c) save from the world of 4: full arrays, rank 0 writes
        t0 = time.perf_counter()
        full = mesh_lm.gather_tree(comm, params.param_tree(),
                                   params.sharding_tree())
        out["digests"] = leaf_digests(full) if comm.rank == 0 else None
        if comm.rank == 0:
            CheckpointManager(f"{job['tmp']}/ckpt", async_save=False).save(
                1, {"params": full})
        del full
        comm.barrier()
        out["save_s"] = time.perf_counter() - t0
        del params, opt
        torch.cuda.empty_cache()
    # (b) qwen2-1.5b at full width and depth, lowmem, on the same mesh
    out["full_depth"] = mesh_full_depth_serving(torch, np, comm, mesh,
                                                device)
    return out


def local_bytes(caches) -> int:
    """Bytes of a rank's cache blocks (sharding/lm.py `MeshCaches`)."""
    from repro_torch.checkpoint.ckpt import flatten_with_paths
    return sum(t.numel() * t.element_size()
               for _, t in flatten_with_paths(caches.local))


def serving_peak(torch, fn, held: int) -> tuple:
    """(fn(), the card's peak during it, its host ms): the peak is
    max_memory_allocated after reset_peak_memory_stats, less what was
    allocated before the call other than its arguments' `held` bytes (the
    rank's placed parameters and cache blocks), as count_flops counts a
    step's peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return got, torch.cuda.max_memory_allocated() - base, ms


def mesh_full_depth_serving(torch, np, comm, mesh, device) -> dict:
    """(b)'s second part in a rank of the world of 4: qwen2-1.5b at full
    width and depth under lowmem (bfloat16 parameters and compute,
    bfloat16 caches), placed from one seed, then one prefill of B = 4, P
    = 64 and one decode step: each step's peak on the card
    (`serving_peak`) and on "meta" (`dry_serve_step`), host ms and the
    bytes sent into all-gathers; the whole parameters' bytes."""
    from repro_torch.configs import get_config
    from repro_torch.launch import cells
    from repro_torch.launch.cells import cell_rules
    from repro_torch.models import model as model_lib
    from repro_torch.sharding import lm as mesh_lm
    from repro_torch.train import step as step_lib
    cfg = get_config(LM_ARCH)
    step_cfg = step_lib.StepConfig(policy="lowmem")
    rules = cell_rules(cfg, mesh, False)
    model = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), torch.bfloat16)
    whole = sum(p.numel() * p.element_size() for p in model.parameters())
    params = mesh_lm.ShardedLM.place(model, comm, rules,
                                     requires_grad=False)
    del model
    torch.cuda.empty_cache()
    prompts = torch.from_numpy(mesh_prompts(np, cfg))
    max_len = MESH_SERVE_PROMPT + MESH_SERVE_NEW
    caches = mesh_lm.init_local_cache(params, MESH_SERVE_BATCH, max_len,
                                      torch.bfloat16)
    held = params.placed_bytes() + local_bytes(caches)
    out = {"whole_bytes": whole, "placed_bytes": params.placed_bytes(),
           "cache_bytes": local_bytes(caches)}
    steps = (("prefill", None, prompts,
              step_lib.make_prefill_step(cfg, step_cfg)),
             ("decode", MESH_SERVE_PROMPT, prompts[:, -1:],
              step_lib.make_decode_step(cfg, step_cfg)))
    for name, pos, toks, step in steps:
        sent = comm.bytes["all_gather"]
        args = (params, toks, caches) + (() if pos is None else (pos,))
        got, peak, ms = serving_peak(torch, lambda: step(*args), held)
        if name == "decode" and not (got[0].shape == (
                MESH_SERVE_BATCH, 1) and bool(
                ((got[0] >= 0) & (got[0] < cfg.vocab_size)).all())):
            raise AssertionError(f"(b) full depth: decode tokens "
                                 f"{got[0]}")
        if name == "prefill" and not bool(torch.isfinite(got[0]).all()):
            raise AssertionError("(b) full depth: prefill logits not "
                                 "finite")
        del got
        out[name] = {
            "peak": peak, "ms": ms,
            "sent_bytes": comm.bytes["all_gather"] - sent,
            "meta_peak": cells.dry_serve_step(
                cfg, mesh, rules, step_cfg, toks, max_len, pos,
                torch.bfloat16, comm.rank).memory["peak_bytes"]}
    del params, caches
    torch.cuda.empty_cache()
    return out


def hold_serving_peaks(ranks) -> None:
    """(b)'s memory gates on every rank: the 2-layer prefill's peak and
    the full-depth lowmem prefill's and decode's within MESH_PEAK_RTOL of
    meta's traced count, and each full-depth peak below one whole copy of
    the parameters (the rank holds its blocks and one layer)."""
    for r in ranks:
        fd = r["full_depth"]
        pairs = [("2-layer prefill", r["serve_peak"], r["serve_peak_meta"])]
        pairs += [(f"full-depth {k}", fd[k]["peak"], fd[k]["meta_peak"])
                  for k in ("prefill", "decode")]
        for label, card, meta in pairs:
            if not abs(card - meta) <= MESH_PEAK_RTOL * meta:
                raise AssertionError(f"(b): rank {r['rank']}'s {label} peak "
                                     f"{card} bytes on the card, {meta} "
                                     f"traced on meta")
        for k in ("prefill", "decode"):
            if not fd[k]["peak"] < fd["whole_bytes"]:
                raise AssertionError(f"(b): rank {r['rank']}'s full-depth "
                                     f"{k} peak {fd[k]['peak']} bytes, the "
                                     f"whole parameters {fd['whole_bytes']}")


def lm_mesh_world2(job) -> dict:
    """Phase 3n's rank target in the world of 2 (a (1, 2) mesh): (c) the
    world of 4's checkpoint restored onto this mesh by its placements
    (`restore(shardings=)`), gathered back (rank 0: sha1 of every leaf);
    (d) launch.train's main in this process group (the mesh step, at
    MESH_LAUNCH_ARGS): its printed lines."""
    import contextlib as ctx
    import io
    import torch
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.cells import cell_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.sharding import lm as mesh_lm
    from repro_torch.sharding import rules as rules_lib
    if job["device"] == "cuda":
        torch.cuda.set_device(0)
    cfg = mesh_lm_config()
    mesh = make_host_mesh(2)
    comm = mesh_lm.MeshComm(mesh)
    rules = cell_rules(cfg, mesh, False)
    meta, axes = model_lib.abstract_params(cfg)
    sh = {"params": rules_lib.tree_shardings(mesh, rules, axes, meta)}
    t0 = time.perf_counter()
    step, blocks = CheckpointManager(f"{job['tmp']}/ckpt").restore(
        {"params": meta}, shardings=sh)
    full = mesh_lm.gather_tree(comm, blocks["params"], sh["params"])
    out = {"rank": comm.rank, "step": step,
           "digests": leaf_digests(full) if comm.rank == 0 else None,
           "restore_s": time.perf_counter() - t0}
    del full
    del blocks
    t0 = time.perf_counter()
    buf = io.StringIO()
    with ctx.redirect_stdout(buf):
        # a checkpoint directory of this run's own: the default one under
        # $TMPDIR may hold another run's checkpoint, which would resume
        train_lib.main(list(job["launch_args"])
                       + ["--ckpt-dir", f"{job['tmp']}/launch"])
    out["launch"] = buf.getvalue()
    out["launch_s"] = time.perf_counter() - t0
    return out


def phase_lm_mesh(torch, np, card: str, device="cuda") -> dict:
    """The LM mesh (repro_torch.sharding, launch.cells, launch.dryrun):
    qwen2-1.5b at full width, MESH_LM_LAYERS layers, float32 compute with
    TF32 off, on a (2, 2) mesh of 4 spawned ranks sharing the card (gloo,
    collectives staged through host buffers). (a) MESH_LM_STEPS mesh
    steps at B = 8, T = 128: step 0's loss and grad norm against the
    single-device port's step on the same seed (run here first, rtol
    1e-4), every loss finite, step 0's batch's loss lower after the steps;
    per rank its placed bytes equal to build_shardings' prediction, its
    peak GB and its step ms. (b) sharded-cache serving on the same mesh
    and the fresh weights: each rank's prefill logits of B = 4, P = 64,
    its own rows alone, against those rows of the single device's (rtol
    1e-4), its serving peak within 10% of meta's traced count
    (`dry_serve_step`), 8 greedy tokens equal; then qwen2-1.5b at full
    width and depth in lowmem, one prefill and one decode step, each
    rank's peak within 10% of meta's and below the whole parameters'
    bytes (`hold_serving_peaks`). (c) the parameters saved
    from the world of 4, restored onto a world of 2 and onto one device,
    bit-equal (sha1 of every leaf). (d) launch.train in the world of 2
    (MESH_LAUNCH_ARGS: xlstm-125m at full width and depth, one step, a
    checkpoint directory of its own): a [train] mesh line and a
    [train] done: first loss line on each rank;
    python -m repro_torch.launch.dryrun --all: exit 0 and the llama3-405b
    train_4k pod line. (e) rank 0's Telemetry through BlinkQLService,
    every agg_scan_fused launch held to its plain version."""
    import os
    import tempfile
    from repro_torch.checkpoint.ckpt import (CheckpointManager,
                                            flatten_with_paths, map_leaves,
                                            to_tensor)
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib
    t_phase = time.perf_counter()
    cfg = mesh_lm_config()
    out = {"layers": MESH_LM_LAYERS, "card": card}
    # (d)'s dry run (host only) runs beside the ranks
    dryrun = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    one = mesh_one_device(torch, np, cfg, device)
    log(f"  one device ({cfg.name} cut to {MESH_LM_LAYERS} layers, float32 "
        f"compute, TF32 off): step 0 loss {one['loss']:.6f}, grad norm "
        f"{one['grad_norm']:.6f} ({one['step_ms']:.1f} ms); prefill + "
        f"{MESH_SERVE_NEW} tokens; {time.perf_counter() - t0:.1f}s")
    with tempfile.TemporaryDirectory(prefix="phase3n-") as tmp:
        job = {"device": device, "tmp": tmp}
        t0 = time.perf_counter()
        ranks = mesh_lib.run_ranks(lm_mesh_rank, MESH_LM_WORLD, job,
                                   timeout=600.0)
        out["world4_s"] = time.perf_counter() - t0
        r0 = ranks[0]
        # (a)
        for r in ranks:
            if (r["losses"], r["grad_norms"]) != (r0["losses"],
                                                  r0["grad_norms"]):
                raise AssertionError(f"(a): rank {r['rank']}'s metrics "
                                     f"differ from rank 0's")
            if r["placed_bytes"] != r["predicted_bytes"] or \
                    r["opt_bytes"] != r["predicted_opt_bytes"]:
                raise AssertionError(f"(a): rank {r['rank']} holds "
                                     f"{r['placed_bytes']} + "
                                     f"{r['opt_bytes']} bytes, "
                                     f"build_shardings predicts "
                                     f"{r['predicted_bytes']} + "
                                     f"{r['predicted_opt_bytes']}")
        for name, got, want in (("loss", r0["losses"][0], one["loss"]),
                                ("grad norm", r0["grad_norms"][0],
                                 one["grad_norm"])):
            if not abs(got - want) <= MESH_RTOL * abs(want):
                raise AssertionError(f"(a): step 0's {name} {got} vs one "
                                     f"device's {want}")
        if not (np.isfinite(r0["losses"]).all()
                and r0["first_batch_after"] < r0["losses"][0]):
            raise AssertionError(f"(a): losses {r0['losses']}, step 0's "
                                 f"batch after them "
                                 f"{r0['first_batch_after']}")
        for r in ranks:
            if r["step0_bytes"] != r["dry_bytes"]:
                raise AssertionError(f"(a): rank {r['rank']} sent "
                                     f"{r['step0_bytes']} in step 0, a "
                                     f"DryComm counts {r['dry_bytes']}")
        log(f"  (a) step 0's bytes sent by each rank's MeshComm (gloo) equal "
            f"a DryComm's count of the same step on meta: "
            + "; ".join(f"rank {r['rank']} all_gather "
                        f"{r['step0_bytes']['all_gather']}, all_to_all "
                        f"{r['step0_bytes']['all_to_all']}" for r in ranks))
        full_bytes = sum(p.numel() * 4 for _, p in flatten_with_paths(
            model_lib.abstract_params(cfg)[0]))
        out["a"] = {
            "loss0": r0["losses"][0], "one_device_loss0": one["loss"],
            "grad_norm0": r0["grad_norms"][0],
            "one_device_grad_norm0": one["grad_norm"],
            "losses": r0["losses"], "first_batch_after":
                r0["first_batch_after"], "full_param_bytes": full_bytes,
            "one_device_step_ms": one["step_ms"],
            "ranks": [{k: r[k] for k in ("rank", "placed_bytes",
                                         "predicted_bytes", "opt_bytes",
                                         "peak_bytes", "step_ms", "place_s",
                                         "collective_ms",
                                         "sent_bytes_a_step", "step0_bytes",
                                         "dry_bytes")}
                      for r in ranks]}
        log(f"  (a) (2, 2) mesh, 4 ranks: step 0 loss {r0['losses'][0]:.6f} "
            f"(one device {one['loss']:.6f}, rel "
            f"{abs(r0['losses'][0] - one['loss']) / one['loss']:.2e}), grad "
            f"norm {r0['grad_norms'][0]:.6f} (one device "
            f"{one['grad_norm']:.6f}); losses "
            f"{', '.join(f'{x:.4f}' for x in r0['losses'])}, step 0's batch "
            f"after them {r0['first_batch_after']:.4f}; world of 4 in "
            f"{out['world4_s']:.1f}s")
        for r in ranks:
            log(f"    rank {r['rank']}: placed {r['placed_bytes'] / 1e9:.4f} "
                f"GB of parameters (= build_shardings'; the full model "
                f"{full_bytes / 1e9:.4f} GB) + {r['opt_bytes'] / 1e9:.4f} "
                f"GB of moments, peak {r['peak_bytes'] / 1e9:.2f} GB, step "
                f"ms {', '.join(f'{x:.0f}' for x in r['step_ms'])}, of "
                f"them in collectives "
                f"{', '.join(f'{x:.0f}' for x in r['collective_ms'])}; sent "
                f"a step: all_gather "
                f"{r['sent_bytes_a_step']['all_gather'] / 1e9:.3f} GB, "
                f"all_to_all {r['sent_bytes_a_step']['all_to_all'] / 1e9:.3f}"
                f" GB ({card}; 4 ranks share the card and the host: "
                f"correctness, not scaling)")
        # (b)
        ratio = 0.0
        for r in ranks:
            lo, hi = r["rows"]
            got = np.load(f"{tmp}/mesh_logits_{r['rank']}.npy")
            want = one["logits"][lo:hi]
            if got.shape != want.shape or hi - lo >= MESH_SERVE_BATCH:
                raise AssertionError(f"(b): rank {r['rank']}'s prefill "
                                     f"logits {got.shape}, its rows "
                                     f"{lo}:{hi} of one device's "
                                     f"{one['logits'].shape}")
            ratio = max(ratio, float(np.max(np.abs(got - want) / (
                MESH_RTOL * np.abs(want) + MESH_RTOL))))
        if not ratio <= 1.0:
            raise AssertionError(f"(b): prefill logits off, worst ratio "
                                 f"{ratio} of rtol/atol {MESH_RTOL}")
        for r in ranks:
            if not np.array_equal(r["tokens"], one["tokens"]):
                raise AssertionError(f"(b): rank {r['rank']}'s tokens "
                                     f"differ from one device's")
        hold_serving_peaks(ranks)
        out["b"] = {"logits_worst_ratio": ratio,
                    "generate_s": r0["generate_s"],
                    "cache_bytes": [r["cache_bytes"] for r in ranks],
                    "ranks": [{k: r[k] for k in (
                        "rank", "rows", "serve_peak", "serve_peak_meta",
                        "prefill_ms", "full_depth")} for r in ranks]}
        log(f"  (b) sharded-cache serving: each rank's prefill logits, its "
            f"own rows of [{MESH_SERVE_BATCH}, {MESH_SERVE_PROMPT}, "
            f"{cfg.vocab_size}] ({', '.join(str(r['rows']) for r in ranks)}"
            f"), worst ratio {ratio:.3f} of rtol/atol {MESH_RTOL} against "
            f"one device's rows; {MESH_SERVE_NEW} greedy tokens equal to "
            f"one device's on every rank; cache blocks "
            f"{[r['cache_bytes'] for r in ranks]} bytes a rank; generate "
            f"{r0['generate_s']:.2f}s")
        for r in ranks:
            fd = r["full_depth"]
            log(f"    rank {r['rank']}: {MESH_LM_LAYERS}-layer f32 prefill "
                f"peak {r['serve_peak'] / 1e9:.4f} GB (meta "
                f"{r['serve_peak_meta'] / 1e9:.4f}), {r['prefill_ms']:.0f} "
                f"ms; {LM_ARCH} full depth lowmem: placed "
                f"{fd['placed_bytes'] / 1e9:.4f} GB + caches "
                f"{fd['cache_bytes'] / 1e9:.4f} GB of a whole "
                f"{fd['whole_bytes'] / 1e9:.4f} GB; "
                + "; ".join(
                    f"{k} peak {fd[k]['peak'] / 1e9:.4f} GB (meta "
                    f"{fd[k]['meta_peak'] / 1e9:.4f}), {fd[k]['ms']:.0f} ms, "
                    f"sent into all-gathers "
                    f"{fd[k]['sent_bytes'] / 1e9:.4f} GB"
                    for k in ("prefill", "decode"))
                + f" ({card}; 4 ranks share the card and the host)")
        # (c) and (d): the world of 2
        t0 = time.perf_counter()
        two = mesh_lib.run_ranks(lm_mesh_world2, 2, {
            **job, "launch_args": MESH_LAUNCH_ARGS}, timeout=600.0)
        out["world2_s"] = time.perf_counter() - t0
        meta, _ = model_lib.abstract_params(cfg)
        step, whole = CheckpointManager(f"{tmp}/ckpt").restore(
            {"params": meta})
        one_digests = leaf_digests(map_leaves(to_tensor, whole["params"]))
        if two[0]["digests"] != r0["digests"]:
            raise AssertionError("(c): the world of 2's leaves differ from "
                                 "the saved ones")
        if one_digests != r0["digests"] or step != 1:
            raise AssertionError("(c): the checkpoint restored onto one "
                                 "device differs from the world of 4's")
        out["c"] = {"leaves": len(r0["digests"]),
                    "save_s": r0["save_s"],
                    "restore_s": [r["restore_s"] for r in two]}
        log(f"  (c) {len(r0['digests'])} parameter leaves saved from the "
            f"world of 4 ({r0['save_s']:.2f}s), restored onto a world of 2 "
            f"((1, 2) mesh, {max(r['restore_s'] for r in two):.2f}s) and "
            f"onto one device: every leaf's sha1 equal")
        for r in two:
            lines = r["launch"].splitlines()
            if not (any(x.startswith("[train] mesh") for x in lines)
                    and any(x.startswith("[train] done: first loss")
                            for x in lines)):
                raise AssertionError(f"(d): launch.train rank {r['rank']} "
                                     f"printed no [train] mesh and [train] "
                                     f"done: first loss lines (no mesh step "
                                     f"ran):\n{r['launch'][-2000:]}")
        done = [x for x in two[0]["launch"].splitlines()
                if x.startswith("[train]")]
        out["d"] = {"launch_lines": done,
                    "launch_s": [r["launch_s"] for r in two]}
        log(f"  (d) launch.train {' '.join(MESH_LAUNCH_ARGS)} in a world of "
            f"2 ranks: {' | '.join(done)} "
            f"({max(r['launch_s'] for r in two):.1f}s); world of 2 in "
            f"{out['world2_s']:.1f}s")
    t0 = time.perf_counter()
    stdout, stderr = dryrun.communicate(timeout=300)
    line = [x for x in stdout.splitlines()
            if x.startswith("[llama3-405b × train_4k @ pod]")]
    if dryrun.returncode != 0 or not line:
        raise AssertionError(f"(d): launch.dryrun exited "
                             f"{dryrun.returncode}\n{stdout[-2000:]}\n"
                             f"{stderr[-4000:]}")
    out["d"]["dryrun_line"] = line[0]
    log(f"  (d) python -m repro_torch.launch.dryrun --all (beside the "
        f"ranks): exit 0, {stdout.strip().splitlines()[-1]} (waited "
        f"{time.perf_counter() - t0:.1f}s after the ranks); {line[0]}")
    # (e) rank 0's telemetry through BlinkQL, every fused launch held
    out["telemetry"] = telemetry_blinkql(torch, np, r0["telemetry"],
                                         MESH_LM_STEPS, device, tag="(e)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 3n ok: {cfg.name}'s widths on a (2, 2) mesh of 4 ranks "
        f"({MESH_LM_LAYERS} layers): the mesh step held to one device's, "
        f"sharded-cache serving equal, its peaks held to meta's at full "
        f"depth, elastic restore bit-equal, "
        f"launch.train in a world of 2 and the dry run exit 0, the "
        f"telemetry through the fused kernel; {out['seconds']:.1f}s")
    return out


# ----------------------------------------------------------------- phase 3o

COST_DECODE_POS = LM_PROMPT          # (c): the token after a P = 128 prompt
COST_PEAK_RTOL = 0.10                # traced peak against the card's
# phase 3j's peaks as PERF.md §6 records them, each read over a run from
# the model's init: (a) six f32 steps, (c) three lowmem steps
PHASE_3J_PEAK_GB = {"f32": 36.59, "lowmem": 21.27}


def meta_like(torch, tree):
    """Meta tensors of the shapes and dtypes of a batch dict."""
    return {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
            for k, v in tree.items()}


def counted_on_card(torch, roof, step, args, base: int) -> dict:
    """One call of step(*args) on the card under roofline.count_flops and
    torch.utils.flop_counter.FlopCounterMode together, the peak memory
    reset just before it: the StepCost, FlopCounterMode's count, the
    card's peak less `base` (what was allocated before the phase)."""
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        cost = roof.step_flops(step, *args)
    torch.cuda.synchronize()
    return {"cost": cost, "flop_counter": fc.get_total_flops(),
            "peak": torch.cuda.max_memory_allocated() - base}


def timed_call(torch, fn) -> float:
    """Host ms of fn() (`timed_steps`)."""
    seconds = []
    timed_steps(torch, fn, seconds)()
    return 1e3 * seconds[0]


def hold_costs(label: str, meta_cost, card: dict) -> dict:
    """(a)-(c)'s gates: the FLOPs counted on the card equal those counted
    on meta; the products equal FlopCounterMode's; the traced peak within
    COST_PEAK_RTOL of the card's; the step ran on the device."""
    got = card["cost"]
    if got.memory["argument_bytes"] <= 0:
        raise AssertionError(f"{label}: no argument on the device")
    if (got.flops, got.dot_flops) != (meta_cost.flops, meta_cost.dot_flops):
        raise AssertionError(f"{label}: FLOPs on the card {got.flops} "
                             f"(products {got.dot_flops}), on meta "
                             f"{meta_cost.flops} ({meta_cost.dot_flops})")
    if got.dot_flops != card["flop_counter"]:
        raise AssertionError(f"{label}: products {got.dot_flops}, "
                             f"FlopCounterMode {card['flop_counter']}")
    traced = meta_cost.memory["peak_bytes"]
    gap = traced / card["peak"] - 1.0
    if not abs(gap) <= COST_PEAK_RTOL:
        raise AssertionError(f"{label}: traced peak {traced} against the "
                             f"card's {card['peak']} ({gap:+.1%})")
    return {"flops": got.flops, "dot_flops": got.dot_flops,
            "flop_counter": card["flop_counter"], "op_bytes": got.bytes,
            "meta_op_bytes": meta_cost.bytes, "ops": got.ops,
            "traced_peak": traced, "card_peak": card["peak"],
            "peak_gap": gap, "meta_memory": meta_cost.memory,
            "card_argument_bytes": got.memory["argument_bytes"]}


def cost_line(label: str, held: dict, roof_line, ms: float,
              card: str) -> str:
    mem = held["meta_memory"]
    top = ", ".join(f"{k} {v / 1e9:.2f}" for k, v in
                    list(mem["peak_by_op"].items())[:5])
    return (f"  {label}: FLOPs {held['flops']:.6e} on the card = on meta "
            f"(products {held['dot_flops']:.6e} = FlopCounterMode's "
            f"{held['flop_counter']:.6e}); op bytes "
            f"{held['op_bytes'] / 1e9:.2f} GB (meta "
            f"{held['meta_op_bytes'] / 1e9:.2f}), {held['ops']} ops;"
            f" traced peak {held['traced_peak'] / 1e9:.2f} GB against the "
            f"card's {held['card_peak'] / 1e9:.2f} GB "
            f"({held['peak_gap']:+.1%}; at the peak by op, GB: {top}); "
            f"step {ms:.1f} ms against the roofline's {roof_line.bottleneck}"
            f" bound {1e3 * roof_line.t_bound:.3f} ms (compute "
            f"{1e3 * roof_line.t_compute:.3f}, memory "
            f"{1e3 * roof_line.t_memory:.3f}), the bound "
            f"{1e3 * roof_line.t_bound / ms:.2%} of the step, "
            f"roofline_fraction at the step "
            f"{roof_line.fraction_at(ms / 1e3):.2%} ({card}; H100 data-sheet "
            f"peaks)")


def phase_lm_costs(torch, np, card: str, device="cuda") -> dict:
    """The step's cost accounting (repro_torch.launch.roofline) on
    qwen2-1.5b at full width and depth, B = 8, T = 128 (phase 3j's shape):
    (a) one f32-policy train step, (b) one lowmem train step, (c) one
    decode step at pos = P = 128 over a cache of P + 64, each run on the
    card under `count_flops` and FlopCounterMode and on "meta" under
    `count_flops` (`step_flops`): the FLOPs equal, the products equal to
    FlopCounterMode's, the traced peak within 10% of
    torch.cuda.max_memory_allocated after reset_peak_memory_stats (less
    what was allocated before the phase); then the step timed alone
    against the Roofline's bound with the card's peaks."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, SyntheticTokenStream
    from repro_torch.launch import roofline as roof
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import ParamFactory
    from repro_torch.train import optim as optim_lib
    from repro_torch.train import step as step_lib
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    opt_cfg = optim_lib.OptConfig(**LM_OPT)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    stream = SyntheticTokenStream(DataConfig(cfg.vocab_size, LM_TRAIN_SEQ,
                                             LM_TRAIN_BATCH, seed=0))
    out = {"base_bytes": base, "card": card}

    def meta_model(dtype):
        return model_lib.DecoderLM(cfg, ParamFactory(None, dtype,
                                                     torch.device("meta")))

    def train(policy: str):
        step_cfg = step_lib.StepConfig(policy=policy)
        step = step_lib.make_train_step(cfg, opt_cfg, step_cfg)
        model = model_lib.init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            step_cfg.param_dtype)
        opt = optim_lib.init_opt_state(model.param_tree(),
                                       step_cfg.opt_config(opt_cfg))
        batch = lm_batch(torch, stream)
        meta = meta_model(step_cfg.param_dtype)
        meta_cost = roof.step_flops(
            step, meta, optim_lib.init_opt_state(
                meta.param_tree(), step_cfg.opt_config(opt_cfg)),
            meta_like(torch, batch))
        on_card = counted_on_card(torch, roof, step, (model, opt, batch),
                                  base)
        held = hold_costs(f"({policy})", meta_cost, on_card)
        nxt = lm_batch(torch, stream)
        held["step_ms"] = timed_call(torch, lambda: step(model, opt, nxt))
        r = roof.Roofline(cfg.name, f"train B={LM_TRAIN_BATCH} "
                          f"T={LM_TRAIN_SEQ}", "one card", 1,
                          meta_cost.flops, meta_cost.dot_flops,
                          meta_cost.bytes, {}, roof.model_flops_for(
                              cfg, "train", LM_TRAIN_SEQ, LM_TRAIN_BATCH))
        held["roofline"] = r.to_dict()
        held["fraction_at_step"] = r.fraction_at(held["step_ms"] / 1e3)
        log(cost_line(f"({'a' if policy == 'f32' else 'b'}) {policy} "
                      f"train step", held, r, held["step_ms"], card)
            + f"; phase 3j's peak over its run "
            f"{PHASE_3J_PEAK_GB[policy]:.2f} GB")
        return held, model, opt

    # (a) f32, then (c) decode on its model, then (b) lowmem
    t0 = time.perf_counter()
    out["f32"], model, opt = train("f32")
    out["f32"]["seconds"] = time.perf_counter() - t0
    del opt
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    step_cfg = step_lib.StepConfig()
    decode = step_lib.make_decode_step(cfg, step_cfg)
    max_len = LM_PROMPT + LM_NEW
    tokens = torch.from_numpy(lm_prompts(np, cfg, LM_BATCH, 1, seed=3))
    caches = model_lib.init_cache(cfg, LM_BATCH, max_len, torch.bfloat16,
                                  device)
    meta_cost = roof.step_flops(
        decode, meta_model(torch.float32),
        torch.empty(tuple(tokens.shape), dtype=tokens.dtype, device="meta"),
        model_lib.init_cache(cfg, LM_BATCH, max_len, torch.bfloat16, "meta"),
        COST_DECODE_POS)
    on_card = counted_on_card(torch, roof, decode,
                              (model, tokens.to(device), caches,
                               COST_DECODE_POS), base)
    held = hold_costs("(c) decode", meta_cost, on_card)
    model._compute = None      # the step below casts anew, as (c) did
    held["step_ms"] = timed_call(torch, lambda: decode(
        model, tokens.to(device), caches, COST_DECODE_POS))
    warm_ms = timed_call(torch, lambda: decode(
        model, tokens.to(device), caches, COST_DECODE_POS))
    r = roof.Roofline(cfg.name, f"decode B={LM_BATCH} P={LM_PROMPT}",
                      "one card", 1, meta_cost.flops, meta_cost.dot_flops,
                      meta_cost.bytes, {}, roof.model_flops_for(
                          cfg, "decode", max_len, LM_BATCH))
    held["roofline"] = r.to_dict()
    held["fraction_at_step"] = r.fraction_at(held["step_ms"] / 1e3)
    held["warm_ms"] = warm_ms
    log(cost_line("(c) decode step (the weights cast within it)", held, r,
                  held["step_ms"], card)
        + f"; with the cast kept (the serving engine's steady state) "
        f"{warm_ms:.1f} ms")
    held["seconds"] = time.perf_counter() - t0
    out["decode"] = held
    del model, caches
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out["lowmem"], model, opt = train("lowmem")
    out["lowmem"]["seconds"] = time.perf_counter() - t0
    del model, opt
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 3o ok: {cfg.name} at full width and depth, the f32, lowmem "
        f"and decode steps counted on the card and on meta alike, the "
        f"traced peaks within {COST_PEAK_RTOL:.0%} of the card's; "
        f"{out['seconds']:.1f}s")
    return out


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
    # kernel_times.py's synthetic shapes of the L2 route (the URL block's
    # rows, G = 6, one int8 atom, int16 stratum ids): kernel, plain, bound.
    import numpy as np
    from repro_torch.core.types import CmpOp
    eq = ((CmpOp.EQ,),)
    for n_strata in (4097, 12_000):
        args = make_case(torch, np, np.random.default_rng(n_strata), "cuda",
                         SYNTHETIC_ROWS, 6, 1, 1, 1, n_strata, np.int16,
                         np.int8, np.int8)
        for kname in BY_GROUPS:
            if kname == "agg_scan_fused":
                fn, plain = agg_scan.agg_scan_fused_cuda, ref.agg_scan_fused_ref
                call = (*args, eq, (0,), 6)
                mom = fn(*call)
                out_bytes = 4 * mom.numel()
            else:
                fn, plain = agg_scan.quantile_scan_cuda, ref.quantile_scan_ref
                call = (*quantile_args(args), eq, (0,), 6)
                mom, hist = fn(*call)
                out_bytes = 4 * (mom.numel() + hist.numel())
            ms = time_cuda(torch, lambda: fn(*call), warmup=3, reps=20)
            plain_ms = time_cuda(torch, lambda: plain(*call), warmup=1,
                                 reps=3)
            bnd = bound_for(args, eq, mom, out_bytes)
            label = f"synthetic, {n_strata} strata (table in L2)"
            log(f"  {kname} {label}: rows={SYNTHETIC_ROWS} G=6 "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]}) bound_share="
                f"{bnd[0] / ms:.3f} card={card}")
            rows[kname].append(
                {"label": label, "G": 6, "n_strata": n_strata, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bnd[0],
                 "bound_by": bnd[1]})
    reset_launches(before)      # timing launches are not main-path work
    return rows


def subsampled_inputs(torch, db, q, quantile: bool):
    """The subsampled launch's inputs of q on the family db selects, at its
    largest K: (phi, striped, args, ops_struct, atom_slots, G·B, extra),
    args in the fused scan's order with the G·B group column; for the
    quantile scan the selection is the one atom column and extra its
    histogram range (lo, hi)."""
    from repro_torch.core import executor as exec_lib
    from repro_torch.core.types import CmpOp
    phi = db._select_phi(q.table, q)
    k = db.families[q.table][phi].ks[0]
    striped = db._striped_for(q.table, phi)
    args, struct, slots, g = kernel_args(torch, db, q, phi, k)
    gsub = db._subsample_codes_for(q.table, phi, striped,
                                   q.group_by[0] if q.group_by else None)
    args = (*args[:6], gsub, *args[7:])
    if not quantile:
        return phi, striped, args, struct, slots, g * N_SUBSAMPLES, None
    (values, _, sel, _), _, _ = wide_args(torch, db, q, phi, k)
    one = torch.ones((1, 1), dtype=torch.float32, device=db.device)
    args = (values, *args[1:5], (sel,), gsub, args[7], one)
    return (phi, striped, args, ((CmpOp.EQ,),), (0,), g * N_SUBSAMPLES,
            exec_lib.selected_range(values, sel))


def phase_times_subsampled(torch, sub_db, card: str) -> dict:
    """The fused kernel at G·B = 192, 6,400 and 16,000 and the quantile
    kernel at G·B = 32 and 192: the subsampled launches of phase 3e's
    queries (and QUANTILE GROUP BY OS) on their families' whole blocks,
    each against its bound and its plain version."""
    from repro_torch.core import AggOp, Atom, CmpOp, Predicate, Query
    from repro_torch.kernels import agg_scan, ref
    t = "sessions"
    before = launch_counts()
    rows = {"agg_scan_fused": [], "quantile_scan": []}
    shapes = [
        ("agg_scan_fused", "SUM(SessionTime) GROUP BY OS",
         Query(t, AggOp.SUM, "SessionTime", group_by=("OS",))),
        ("agg_scan_fused", "AVG(SessionTime) GROUP BY City",
         Query(t, AggOp.AVG, "SessionTime", group_by=("City",))),
        ("agg_scan_fused", "AVG(Bitrate) GROUP BY URL",
         Query(t, AggOp.AVG, "Bitrate", group_by=("URL",))),
        ("quantile_scan", "QUANTILE(SessionTime) WHERE Genre=genre03",
         Query(t, AggOp.QUANTILE, "SessionTime", quantile=0.5,
               predicate=Predicate.where(Atom("Genre", CmpOp.EQ,
                                              "genre03")))),
        ("quantile_scan", "QUANTILE(SessionTime) GROUP BY OS",
         Query(t, AggOp.QUANTILE, "SessionTime", quantile=0.5,
               group_by=("OS",))),
    ]
    for kname, label, q in shapes:
        quantile = kname == "quantile_scan"
        phi, striped, args, struct, slots, g, rng = subsampled_inputs(
            torch, sub_db, q, quantile)
        if quantile:
            fn, plain = agg_scan.quantile_scan_cuda, ref.quantile_scan_ref
            call = (*args[:-1], *rng, args[-1], struct, slots, g)
            mom, hist = fn(*call)
            out_bytes = 4 * (mom.numel() + hist.numel())
        else:
            fn, plain = agg_scan.agg_scan_fused_cuda, ref.agg_scan_fused_ref
            call = (*args, struct, slots, g)
            mom = fn(*call)
            out_bytes = 4 * mom.numel()
        ms = time_cuda(torch, lambda: fn(*call), warmup=3, reps=20)
        plain_ms = time_cuda(torch, lambda: plain(*call), warmup=1, reps=3)
        bnd = bound_for(args, struct, mom, out_bytes)
        log_time(kname, f"subsampled {label} family={phi} (G·B, int32 "
                 f"group column)", striped, g, ms, plain_ms, bnd, card)
        rows[kname].append({"label": f"subsampled {label}", "G": g, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bnd[0],
                            "bound_by": bnd[1]})
    reset_launches(before)      # timing launches are not main-path work
    return rows


def kernels_record(worst, record, main, batch, ops_path, times, sample,
                   l2_times, subj, sub_times, mut, serving, mesh, lm_train,
                   lm_moe, lm_rec, lm_xc, lm_mesh, card: str) -> list[dict]:
    """The kernels' JSON record: one entry per kernel, its launches on its
    path, its worst disagreement with its plain version over every phase,
    and its times at the main path's shapes; the fused and quantile
    kernels also at the forced (City, URL) family's shapes, whose table
    sits in L2 ("l2_table", with phase 3d's launches of that route), and
    at phase 3e's subsampled shapes ("subsampled", G·B groups, with phase
    3e's launches at that G·B)."""
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
        for checked in (subj["worst"].get(kname, {}),
                        mut["worst"].get(kname, {}),
                        serving["worst"].get(kname, {})):
            if checked:  # phase 3e's and 3f's launches, each against plain
                errs.append((max(w[0] for w in checked.values()),
                             max(w[1] for w in checked.values())))
        for run in (lm_train, lm_moe, lm_rec, lm_xc, lm_mesh):
            telemetry = run["telemetry"]["worst"].get(kname, {})
            if telemetry:  # 3j (f), 3k (f), 3l (g), 3m (f), 3n (e): plain
                errs.append((max(w[0] for w in telemetry.values()),
                             max(w[1] for w in telemetry.values())))
        if kname in MESH_KERNELS:  # phase 3h's ranks, each against plain
            errs.append((max(w["worst"][kname]
                             for w in mesh["worlds"].values()), 0.0))
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
                if not row["label"].startswith("synthetic") else
                {**row, "route": "cuda", "library_ms": None, "launches": 0,
                 "path": "synthetic inputs (kernel_times.py's shape)"}
                for row in l2_times[kname]]
            entry["sample_creation_launches"] = sample["launches"][kname]
        if kname in sub_times:
            sub_by_g = subj["sub_by_groups"].get(kname, {})
            entry["subsampled"] = [
                {**row, "route": "cuda", "library_ms": None,
                 "launches": sub_by_g.get(row["G"], 0),
                 "path": "BlinkDB.query, ci_method='subsampling' (phase 3e)"}
                for row in sub_times[kname]]
            entry["subsampling_launches"] = subj["sub_launches"][kname]
            entry["subsampling_launches_by_G"] = sub_by_g
            entry["join_launches"] = subj["join_launches"][kname]
            entry["join_launches_by_G"] = subj["join_by_groups"].get(kname,
                                                                     {})
        if kname in SERVING_KERNELS:
            entry.update(
                traced_launches=serving["traced_launches"][kname],
                fault_launches=serving["fault_launches"][kname],
                fault_launches_by_G={g: w[2] for g, w in
                                     serving["worst"].get(kname, {}).items()},
                fault_attempts_by_shard=serving["faults"][
                    "attempts_by_shard"],
                service_launches=serving["service_launches"][kname],
                serving_path=("BlinkDB.query traced; BlinkDB.query under "
                              "fault plans, one launch per (shard, "
                              "replica) attempt; BlinkQLService.submit "
                              "and submit_many (phase 3g)"))
        if kname in MUTATION_KERNELS:
            entry["mutation_launches"] = mut["launches"][kname]
            entry["mutation_path"] = ("BlinkDB.query after append_rows, "
                                      "delete_rows, update_rows and "
                                      "SampleMaintainer.reclaim (phase 3f)")
        if kname in BY_GROUPS:
            entry["mutation_launches_by_G"] = mut["by_groups"].get(kname, {})
            entry["mutation_launches_by_table"] = mut["by_table"].get(kname,
                                                                      {})
        if kname in MESH_KERNELS:
            entry.update(
                mesh_launches_by_world={
                    str(w): [r[kname] for r in v["launches"]]
                    for w, v in mesh["worlds"].items()},
                mesh_stripe_times=mesh["stripe_times"][kname],
                mesh_path=("BlinkDB(mesh=DeviceMesh).query, query_batch, a "
                           "subsampled CI and an append, each rank's "
                           "launches over its stripe (phase 3h)"))
        if kname == "agg_scan_fused":
            entry.update(
                telemetry_launches=lm_train["telemetry"]["launches"][kname],
                telemetry_times=lm_train["telemetry"]["times"],
                moe_telemetry_times=lm_moe["telemetry"]["times"],
                telemetry_path=("BlinkQLService.submit over the trainer's "
                                "Telemetry of phase 3j (a), each launch held "
                                "to its plain version (phase 3j (f))"),
                moe_telemetry_launches=lm_moe["telemetry"]["launches"][kname],
                moe_telemetry_path=("BlinkQLService.submit over the MoE "
                                    "trainer's Telemetry of phase 3k (c), "
                                    "each launch held to its plain version "
                                    "(phase 3k (f))"),
                xlstm_telemetry_launches=lm_rec["telemetry"]["launches"][
                    kname],
                xlstm_telemetry_times=lm_rec["telemetry"]["times"],
                xlstm_telemetry_path=("BlinkQLService.submit over the xLSTM "
                                      "trainer's Telemetry of phase 3l (c), "
                                      "each launch held to its plain version "
                                      "(phase 3l (g))"),
                musicgen_telemetry_launches=lm_xc["telemetry"]["launches"][
                    kname],
                musicgen_telemetry_times=lm_xc["telemetry"]["times"],
                musicgen_telemetry_path=("BlinkQLService.submit over the "
                                         "musicgen trainer's Telemetry of "
                                         "phase 3m (c), each launch held to "
                                         "its plain version (phase 3m (f))"),
                mesh_telemetry_launches=lm_mesh["telemetry"]["launches"][
                    kname],
                mesh_telemetry_times=lm_mesh["telemetry"]["times"],
                mesh_telemetry_path=("BlinkQLService.submit over rank 0's "
                                     "Telemetry of the mesh train step, "
                                     "phase 3n (a), each launch held to its "
                                     "plain version (phase 3n (e))"))
            entry["mutation_compaction"] = {
                str(phi): sides for phi, sides in mut["compaction"].items()}
        if kname == "agg_scan_batched":
            entry.update(q32_ms=times[kname][1]["ms"],
                         q32_bound_ms=times[kname][1]["bound_ms"],
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

    log("phase 3e: subsampling CIs and joins, BlinkDB.query and query_batch")
    subj = phase_subsampling_and_joins(torch, np, main["db"])

    log("phase 3f: mutation and maintenance, append_rows, delete_rows, "
        "update_rows and SampleMaintainer.reclaim, then BlinkDB.query")
    mut = phase_mutation(torch, np, main["db"])

    log("phase 3g: tracing, fault plans and the BlinkQL service, "
        "BlinkDB.query and BlinkQLService")
    serving = phase_serving(torch, np, main, card)

    log("phase 3h: the multi-device path, BlinkDB(mesh=DeviceMesh) over "
        "torch.distributed, worlds of 2 and 4 ranks on one card")
    mesh = phase_mesh(torch, np, main, card)

    log("phase 3i: the LM substrate's serving path, qwen2-1.5b at full "
        "width: models.DecoderLM, ServeEngine, CheckpointManager, "
        "launch.serve")
    lm = phase_lm_serving(torch, np, card)

    log("phase 3j: the LM substrate's training path, qwen2-1.5b at full "
        "width: loss_fn, make_train_step, AdamW (f32 and int8 moments), "
        "train.loop, launch.train; its telemetry through BlinkQLService")
    lm_train = phase_lm_training(torch, np, card)

    log("phase 3k: the LM substrate's MoE, granite-moe-3b-a800m at full "
        "width: models.moe through DecoderLM, ServeEngine, make_train_step "
        "(lowmem), launch.serve, launch.train; its telemetry through "
        "BlinkQLService")
    lm_moe = phase_lm_moe(torch, np, card)

    log("phase 3l: the LM substrate's recurrent mixers, xlstm-125m at full "
        "width (mLSTM and sLSTM) and jamba-v0.1-52b's period at full width "
        "(Mamba): models.mamba and models.xlstm through DecoderLM, "
        "ServeEngine, make_train_step, launch.serve, launch.train; its "
        "telemetry through BlinkQLService")
    lm_rec = phase_lm_recurrent(torch, np, card)

    log("phase 3m: the LM substrate's audio codebooks and cross-attention, "
        "musicgen-large at full width and llama-3.2-vision-90b's period at "
        "full width: the codebook embedding and heads, the xattn layers and "
        "vision_proj through DecoderLM, ServeEngine, make_train_step "
        "(lowmem), launch.serve; its telemetry through BlinkQLService")
    lm_xc = phase_lm_xattn_codebooks(torch, np, card)

    log("phase 3n: the LM mesh, qwen2-1.5b's widths on a (2, 2) mesh of 4 "
        "ranks on the card: sharding.rules placements, the mesh train step, "
        "sharded-cache decode, elastic restore, launch.train in a world of "
        "2, launch.dryrun; its telemetry through BlinkQLService")
    lm_mesh = phase_lm_mesh(torch, np, card)

    log("phase 3o: the step's cost accounting, qwen2-1.5b at full width: "
        "launch.roofline's counted FLOPs, op bytes and traced peak of the "
        "f32, lowmem and decode steps on the card and on meta, against "
        "FlopCounterMode, torch.cuda.max_memory_allocated and the roofline "
        "with the card's peaks")
    lm_costs = phase_lm_costs(torch, np, card)

    log(f"phase 4: times at the main path's shapes ({card})")
    times = phase_times(torch, main["db"], card)
    l2_times = phase_times_l2(torch, sample["db"], card)
    sub_times = phase_times_subsampled(torch, subj["sub_db"], card)
    kernels = kernels_record(worst, record, main, batch, ops_path, times,
                             sample, l2_times, subj, sub_times, mut, serving,
                             mesh, lm_train, lm_moe, lm_rec, lm_xc, lm_mesh,
                             card)
    log(f"smoke total {time.perf_counter() - t_start:.1f}s (phase 3d "
        f"{sample['seconds']:.1f}s, phase 3e {subj['seconds']:.1f}s, phase "
        f"3f {mut['seconds']:.1f}s, phase 3g {serving['seconds']:.1f}s, "
        f"phase 3h {mesh['seconds']:.1f}s, phase 3i {lm['seconds']:.1f}s, "
        f"phase 3j {lm_train['seconds']:.1f}s, phase 3k "
        f"{lm_moe['seconds']:.1f}s, phase 3l {lm_rec['seconds']:.1f}s, "
        f"phase 3m {lm_xc['seconds']:.1f}s, phase 3n "
        f"{lm_mesh['seconds']:.1f}s, phase 3o {lm_costs['seconds']:.1f}s)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
