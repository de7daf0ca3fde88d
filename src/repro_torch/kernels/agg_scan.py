"""Sample-scan kernels for Hopper: build, bind and launch (counterparts of
`repro.kernels.agg_scan`: `agg_scan_pallas`, `agg_scan_batched_pallas`,
`agg_scan_fused_pallas` and `quantile_scan_pallas`).

The kernels are CUDA C++ in csrc/ with a plain C interface, one library per
source: agg_scan.cu, agg_scan_batched.cu, agg_scan_fused.cu,
quantile_scan.cu and weighted_sum.cu (its wrapper is in weighted_sum.py),
which all include csrc/scan_common.cuh. `nvcc` compiles each for sm_90a
into build/kernels/ at its first use (never at import: the CPU tests import
this module), and ctypes loads it. `build_all()` starts one nvcc per source
at once. Each wrapper (`agg_scan_cuda`, `agg_scan_batched_cuda`,
`agg_scan_fused_cuda`, `quantile_scan_cuda`) checks its arguments,
allocates outputs and per-chunk scratch with torch.empty (agg_scan up to 8
groups and agg_scan_batched: a scratch buffer kept per stream), launches
on the current stream and raises if the launch failed. Its `launches`
attribute counts the kernel's launches; nothing else touches it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.core.types import CMP_CODES, QUANTILE_BINS

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
HEADER = CSRC_DIR / "scan_common.cuh"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_ATOMS = 127          # template atoms the kernels' descriptor holds
MAX_CONJUNCTIONS = 128
SHARED_STRATA = 4096     # up to here the freq table sits in shared memory
MAX_STRATA = 2**31 - 1   # stratum ids are int32; above SHARED_STRATA
                         # each row reads the table through L2
MAX_QUERIES = 64         # queries per launch (the scratch grows with Q)
_STAGE = 1024            # rows a block takes per step (csrc kStep)
_REG_GROUPS = 8          # register-mode group tiles up to here (kRegGroups)
_MAX_TILE = 1024         # groups per shared-mode tile (kMaxTile)
_ONE_PASS_GROUPS = 32    # quantile: histogram in the moments pass (kOnePassGroups)
_BLOCKS_PER_SM = 8       # pass-1 blocks per SM (the chunk count)
_SCRATCH_BYTES = 64 << 20   # per query and launch
MAX_SHARED = 232_448     # dynamic shared bytes a block may have (H100)

# Column dtype tags of the kernels (csrc enum).
_VALUE_TAGS = {torch.float32: 0, torch.int8: 1, torch.int16: 2,
               torch.int32: 3, torch.uint8: 4, torch.bool: 4,
               torch.float16: 5}
_INT_TAGS = {torch.int8: 1, torch.int16: 2, torch.int32: 3, torch.uint8: 4}


@dataclasses.dataclass
class Library:
    """One compiled kernel library, built and loaded at first use."""
    source: Path
    symbol: str
    argtypes: list
    handle: ctypes.CDLL | None = None
    path: Path | None = None
    build_seconds: float | None = None   # None: loaded an earlier build
    build_log: str = ""


_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
# Pointers as c_void_p, so ctypes never truncates them.
_DNF_ARGS = [
    _P, _P, _I32,                  # col_ptrs, col_tags, n_cols (host)
    _P, _P, _I32,                  # atom_slot, atom_op, n_atoms (host)
    _P, _I32,                      # conj_end, n_conj (host)
]
_SCAN_ARGS = [
    _P, _I32, _P,                  # values, values_tag, unit
    _P, _I32, _P, _I32,            # strat, strat_tag, ftab, n_strata
    _P, _P, _I32,                  # valid, codes, codes_tag
    *_DNF_ARGS,
]
LIBRARIES = {
    "agg_scan": Library(
        CSRC_DIR / "agg_scan.cu", "agg_scan_launch",
        [_P, _I32, _P, _P,                # values, values_tag, rates, mask
         _P, _I32, _I32, _I64,            # codes, codes_tag, G, n
         _I64, _I32, _I32,                # rows_per_chunk, n_chunks, gt
         _P, _P, _P, _P]),                # partial, ticket, out, stream
    "agg_scan_batched": Library(
        CSRC_DIR / "agg_scan_batched.cu", "agg_scan_batched_launch",
        [_P, _I32, _P, _P,                # values, values_tag, freq, ek
         _P, _I32, *_DNF_ARGS,            # codes, codes_tag, template
         _P, _P, _I32, _I32, _I64,        # ks, consts, Q, G, n
         _I64, _I32, _I32,                # rows_per_chunk, n_chunks, gt
         _P, _P, _P, _P]),                # bits, partial, out, stream
    "weighted_sum": Library(
        CSRC_DIR / "weighted_sum.cu", "weighted_sum_launch",
        [_P, _I32, _P, _P,                # values, values_tag, weights, mask
         _I64, _I64, _I32,                # n, rows_per_chunk, n_chunks
         _P, _P, _P]),                    # partial, out, stream
    "agg_scan_fused": Library(
        CSRC_DIR / "agg_scan_fused.cu", "agg_scan_fused_launch",
        _SCAN_ARGS + [_P, _P, _I32, _I32, _I64,   # ks, consts, Q, G, n
                      _I64, _I32, _I32,           # rows_per_chunk, n_chunks, gt
                      _P, _P, _P]),               # partial, out, stream
    "quantile_scan": Library(
        CSRC_DIR / "quantile_scan.cu", "quantile_scan_launch",
        _SCAN_ARGS + [_P, _P, _I32, _I64,         # k, consts, G, n
                      _I64, _I32, _I32,           # rows_per_chunk, n_chunks, gt
                      _P, _P,                     # partial, out
                      _F32, _F32, _I64, _I32,     # lo, hi, hist rows, chunks
                      _P, _P, _P]),               # hist partial, hist out, stream
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _library_path(lib: Library) -> Path:
    """The build's file name carries a hash of the sources and flags, so an
    edited source never loads a stale build."""
    src = lib.source.read_bytes() + HEADER.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{lib.source.stem}_{tag}.so"


def _load(lib: Library, path: Path) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(path))
    fn = getattr(handle, lib.symbol)
    fn.argtypes = lib.argtypes
    fn.restype = ctypes.c_int
    lib.handle, lib.path = handle, path
    return handle


def build_all(names=None) -> dict[str, ctypes.CDLL]:
    """Compile the named libraries (default: all) that are not built yet,
    one nvcc per source, all started together, and load them. Each build
    writes to a temporary file and renames it, so concurrent builders
    cannot load a half-written library."""
    names = list(LIBRARIES) if names is None else list(names)
    pending = []
    for name in names:
        lib = LIBRARIES[name]
        if lib.handle is not None:
            continue
        path = _library_path(lib)
        if path.exists():
            _load(lib, path)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(lib.source)]
        pending.append((lib, path, tmp, time.perf_counter(),
                        subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True)))
    failed = []
    for lib, path, tmp, t0, proc in pending:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc {lib.source.name} failed "
                          f"({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        lib.build_seconds = time.perf_counter() - t0
        lib.build_log = log
        _load(lib, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: LIBRARIES[name].handle for name in names}


def build(name: str) -> ctypes.CDLL:
    """The named library, built and loaded at its first use."""
    return build_all([name])[name]


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _chunks(n: int, n_sms: int, bytes_per_chunk: int) -> tuple[int, int]:
    """(rows_per_chunk, n_chunks): about one wave of blocks, fewer when
    the per-chunk scratch would pass 64 MiB; rows a multiple of the stage."""
    chunks = max(1, min(-(-n // _STAGE), n_sms * _BLOCKS_PER_SM,
                        _SCRATCH_BYTES // bytes_per_chunk))
    rows = -(-max(n, 1) // chunks)
    rows = -(-rows // _STAGE) * _STAGE
    return rows, max(1, -(-n // rows))


def launch_plan(n: int, q: int, g: int,
                n_sms: int) -> tuple[int, int, int, int]:
    """(rows_per_chunk, n_chunks, group tile, blocks per chunk) of a Q-query
    launch on a card with `n_sms` multiprocessors. A block takes one query
    and a tile of groups: 1, 2, 4 or 8 (register mode: each thread sums its
    own rows) or up to 1024 (shared mode: one sum per group in shared
    memory, added by the group's owner warp). The chunking and the group tile fix the order of the
    float sums and depend on (n, G) and the card only: a query sums in the
    same order alone as in a batch, and repeat launches on one card are
    bit-identical (cards with other SM counts sum in another order). Only
    the number of blocks per chunk, Q × group tiles, grows with Q."""
    gt = _pow2_ceil(g) if g <= _REG_GROUPS else min(g, _MAX_TILE)
    rows, chunks = _chunks(n, n_sms, 4 * 7 * g)
    return rows, chunks, gt, q * -(-g // gt)


def hist_plan(n: int, g: int, n_sms: int) -> tuple[int, int]:
    """(rows_per_chunk, n_chunks) of the quantile kernel's histogram: up to
    32 groups it rides the moments pass and takes its plan; above, its own
    pass's per-chunk scratch is G × 256 floats, capped as the moments'."""
    if g <= _ONE_PASS_GROUPS:
        return launch_plan(n, 1, g, n_sms)[:2]
    return _chunks(n, n_sms, 4 * QUANTILE_BINS * g)


def _check_rows(n, device, **rows) -> None:
    """Each named tensor is 1-D of length n on `device`."""
    for name, t in rows.items():
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; need ({n},)")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; need {device}")


def check_fused_args(values, unit, strat, freq_table, valid, atom_cols,
                     group_codes, ks, pred_consts, ops_struct, atom_slots,
                     n_groups) -> tuple:
    """Validate a fused-scan call (both devices take the same arguments) and
    return the resolved atom_slots."""
    n_atoms = sum(len(c) for c in ops_struct)
    if atom_slots is None:
        atom_slots = tuple(range(n_atoms))
    atom_slots = tuple(atom_slots)
    if n_atoms > MAX_ATOMS:
        raise ValueError(f"predicate has {n_atoms} atoms; max {MAX_ATOMS}")
    if len(ops_struct) > MAX_CONJUNCTIONS:
        raise ValueError(f"predicate has {len(ops_struct)} conjunctions; "
                         f"max {MAX_CONJUNCTIONS}")
    if len(atom_slots) != n_atoms:
        raise ValueError(f"atom_slots has {len(atom_slots)} entries; "
                         f"template has {n_atoms} atoms")
    if n_atoms and (min(atom_slots) < 0 or max(atom_slots) >= len(atom_cols)):
        raise ValueError("atom_slots references a missing atom column")
    if freq_table.dim() != 1 or not 1 <= freq_table.shape[0] <= MAX_STRATA:
        raise ValueError(f"freq table has shape {tuple(freq_table.shape)}; "
                         f"need 1..{MAX_STRATA} strata (an empty table "
                         f"has no stratum to read)")
    if ks.dim() != 1 or not 1 <= ks.shape[0] <= MAX_QUERIES:
        raise ValueError(f"{tuple(ks.shape)} queries; need 1..{MAX_QUERIES}")
    if tuple(pred_consts.shape) != (ks.shape[0], n_atoms):
        raise ValueError(f"pred_consts has shape {tuple(pred_consts.shape)}; "
                         f"need {(ks.shape[0], n_atoms)}")
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    device = unit.device
    rows = {"unit": unit, "strat": strat, "valid": valid}
    if values is not None:
        rows["values"] = values
    if group_codes is not None:
        rows["group_codes"] = group_codes
    rows.update({f"atom_cols[{i}]": a for i, a in enumerate(atom_cols)})
    _check_rows(unit.shape[0], device, **rows)
    for name, t in (("freq_table", freq_table), ("ks", ks),
                    ("pred_consts", pred_consts)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; unit is on {device}")
    if unit.dtype != torch.float32 or freq_table.dtype != torch.float32:
        raise ValueError("unit and freq_table must be float32")
    if valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool, got {valid.dtype}")
    if strat.dtype not in _INT_TAGS:
        raise ValueError(f"strat dtype {strat.dtype} not in {list(_INT_TAGS)}")
    if group_codes is not None and group_codes.dtype not in _INT_TAGS:
        raise ValueError(f"group codes dtype {group_codes.dtype} not in "
                         f"{list(_INT_TAGS)}")
    for t in ([values] if values is not None else []) + list(atom_cols):
        if t.dtype not in _VALUE_TAGS:
            raise ValueError(f"column dtype {t.dtype} not in "
                             f"{list(_VALUE_TAGS)}")
    return atom_slots


def check_quantile_args(values, unit, strat, freq_table, valid, atom_cols,
                        group_codes, k, lo, hi, pred_consts, ops_struct,
                        atom_slots, n_groups) -> tuple:
    """Validate a quantile-scan call: one query (k f32[1], pred_consts
    f32[1, n_atoms]) and a finite histogram range. Returns the resolved
    atom_slots."""
    if k.shape != (1,):
        raise ValueError(f"k has shape {tuple(k.shape)}; need (1,)")
    if not torch.isfinite(torch.tensor([lo, hi], dtype=torch.float32)).all():
        raise ValueError(f"histogram range [{lo}, {hi}] is not finite")
    return check_fused_args(values, unit, strat, freq_table, valid,
                            atom_cols, group_codes, k, pred_consts,
                            ops_struct, atom_slots, n_groups)


def check_agg_scan_args(values, rates, mask, group_codes, n_groups) -> None:
    """Validate an agg_scan call (both devices take the same arguments):
    values at a stored width of _VALUE_TAGS (None: every value is 1),
    rates float32, mask bool, integer group codes (None: every row in
    group 0), all [n] on one device."""
    rows = dict(rates=rates, mask=mask)
    if values is not None:
        rows["values"] = values
        if values.dtype not in _VALUE_TAGS:
            raise ValueError(f"values dtype {values.dtype} not in "
                             f"{list(_VALUE_TAGS)}")
    if group_codes is not None:
        rows["group_codes"] = group_codes
        if group_codes.dtype not in _INT_TAGS:
            raise ValueError(f"group codes dtype {group_codes.dtype} not in "
                             f"{list(_INT_TAGS)}")
    _check_rows(rates.shape[0] if rates.dim() else -1, rates.device, **rows)
    if rates.dtype != torch.float32:
        raise ValueError(f"rates must be float32, got {rates.dtype}")
    if mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool, got {mask.dtype}")
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")


def check_batched_args(values, freq, entry_key, atom_cols, group_codes, ks,
                       pred_consts, ops_struct, n_groups) -> None:
    """Validate an agg_scan_batched call: values, freq, entry_key and group
    codes [n], atom_cols [A, n] (one row per flattened template atom), ks
    [Q] (any Q >= 1), pred_consts [Q, A]; A + 1 <= 128, as the reference's
    constant block holds k and 127 atoms."""
    n_atoms = sum(len(c) for c in ops_struct)
    if n_atoms > MAX_ATOMS:
        raise ValueError(f"predicate has {n_atoms} atoms; max {MAX_ATOMS}")
    if len(ops_struct) > MAX_CONJUNCTIONS:
        raise ValueError(f"predicate has {len(ops_struct)} conjunctions; "
                         f"max {MAX_CONJUNCTIONS}")
    n, device = freq.shape[0] if freq.dim() else -1, freq.device
    _check_rows(n, device, values=values, freq=freq, entry_key=entry_key,
                group_codes=group_codes)
    if tuple(atom_cols.shape) != (n_atoms, n):
        raise ValueError(f"atom_cols has shape {tuple(atom_cols.shape)}; "
                         f"need {(n_atoms, n)}")
    if ks.dim() != 1 or ks.shape[0] < 1:
        raise ValueError(f"ks has shape {tuple(ks.shape)}; need (Q,), Q >= 1")
    if tuple(pred_consts.shape) != (ks.shape[0], n_atoms):
        raise ValueError(f"pred_consts has shape {tuple(pred_consts.shape)}; "
                         f"need {(ks.shape[0], n_atoms)}")
    for name, t in (("atom_cols", atom_cols), ("ks", ks),
                    ("pred_consts", pred_consts)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; need {device}")
    if freq.dtype != torch.float32 or entry_key.dtype != torch.float32:
        raise ValueError("freq and entry_key must be float32")
    if values.dtype not in _VALUE_TAGS:
        raise ValueError(f"values dtype {values.dtype} not in "
                         f"{list(_VALUE_TAGS)}")
    if group_codes.dtype not in _INT_TAGS:
        raise ValueError(f"group codes dtype {group_codes.dtype} not in "
                         f"{list(_INT_TAGS)}")
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")


def _check_cuda(name, tensors, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {device}")
    if not all(t is None or t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _dnf_head(col_ptrs, col_tags, ops_struct, atom_slots) -> tuple:
    """The C arguments of a template (column pointers and tags, and the
    packed DNF descriptor), with the host arrays they point into: the
    caller keeps the tuple alive across the call."""
    n_cols = len(col_ptrs)
    ptr_arr = (ctypes.c_uint64 * max(n_cols, 1))(*col_ptrs)
    tag_arr = (ctypes.c_int * max(n_cols, 1))(*col_tags)
    ops = [op for conj in ops_struct for op in conj]
    slot_arr = (ctypes.c_int * max(len(ops), 1))(*atom_slots)
    op_arr = (ctypes.c_int * max(len(ops), 1))(*[CMP_CODES[o] for o in ops])
    ends, a = [], 0
    for conj in ops_struct:
        a += len(conj)
        ends.append(a)
    end_arr = (ctypes.c_int * max(len(ends), 1))(*ends)
    head = (ctypes.addressof(ptr_arr), ctypes.addressof(tag_arr), n_cols,
            ctypes.addressof(slot_arr), ctypes.addressof(op_arr), len(ops),
            ctypes.addressof(end_arr), len(ends))
    return head, (ptr_arr, tag_arr, slot_arr, op_arr, end_arr)


def _scan_head(values, unit, strat, freq_table, valid, atom_cols,
               group_codes, ops_struct, atom_slots) -> tuple:
    """The leading C arguments of the fused and quantile launchers, with
    the host arrays they point into (see _dnf_head)."""
    dnf, keep = _dnf_head([a.data_ptr() for a in atom_cols],
                          [_VALUE_TAGS[a.dtype] for a in atom_cols],
                          ops_struct, atom_slots)
    head = (values.data_ptr() if values is not None else None,
            _VALUE_TAGS[values.dtype] if values is not None else 0,
            unit.data_ptr(), strat.data_ptr(), _INT_TAGS[strat.dtype],
            freq_table.data_ptr(), freq_table.shape[0], valid.data_ptr(),
            group_codes.data_ptr() if group_codes is not None else None,
            _INT_TAGS[group_codes.dtype] if group_codes is not None else 0,
            *dnf)
    return head, keep


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}"
                           if rc > 0 else f"{name}: arguments refused")


_SMS: dict[int, int] = {}
# The current stream's handle without building a torch.cuda.Stream object
# on every call; the public call where torch lacks it.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream_handle(device) -> int:
    """The caller's current CUDA stream on `device`, as the kernels take it."""
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _n_sms(device) -> int:
    """The multiprocessor count of a tensor's card, read once per card."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def agg_scan_fused_cuda(values, unit, strat, freq_table, valid, atom_cols,
                        group_codes, ks, pred_consts, ops_struct,
                        atom_slots=None, n_groups: int = 1) -> torch.Tensor:
    """Launch the fused scan on CUDA tensors: returns f32[Q, 7, n_groups].
    Same arguments and semantics as ref.agg_scan_fused_ref; `values=None`
    streams no value column (COUNT), `group_codes=None` no group column."""
    atom_slots = check_fused_args(values, unit, strat, freq_table, valid,
                                  atom_cols, group_codes, ks, pred_consts,
                                  ops_struct, atom_slots, n_groups)
    device = unit.device
    _check_cuda("agg_scan_fused_cuda", [values, unit, strat, freq_table,
                                        valid, group_codes, *atom_cols],
                device)
    lib = build("agg_scan_fused")
    n, q = unit.shape[0], ks.shape[0]
    with torch.cuda.device(device):
        ks = ks.to(torch.float32).contiguous()
        consts = pred_consts.to(torch.float32).contiguous()
        rows, chunks, gt, _ = launch_plan(n, q, n_groups, _n_sms(device))
        out = torch.empty((q, 7, n_groups), dtype=torch.float32, device=device)
        partial = torch.empty((chunks, q, 7, n_groups), dtype=torch.float32,
                              device=device)
        head, keep = _scan_head(values, unit, strat, freq_table, valid,
                                atom_cols, group_codes, ops_struct,
                                atom_slots)
        rc = lib.agg_scan_fused_launch(
            *head, ks.data_ptr(), consts.data_ptr(), q, n_groups, n,
            rows, chunks, gt, partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
        del keep
    _raise_on(rc, "agg_scan_fused")
    agg_scan_fused_cuda.launches += 1
    return out


agg_scan_fused_cuda.launches = 0


def quantile_scan_cuda(values, unit, strat, freq_table, valid, atom_cols,
                       group_codes, k, lo: float, hi: float, pred_consts,
                       ops_struct, atom_slots=None, n_groups: int = 1
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the quantile scan on CUDA tensors: returns (moments
    f32[7, n_groups], histogram f32[n_groups, 256]). Same arguments and
    semantics as ref.quantile_scan_ref: k f32[1], pred_consts
    f32[1, n_atoms], lo and hi host floats (rounded to float32)."""
    atom_slots = check_quantile_args(values, unit, strat, freq_table, valid,
                                     atom_cols, group_codes, k, lo, hi,
                                     pred_consts, ops_struct, atom_slots,
                                     n_groups)
    device = unit.device
    _check_cuda("quantile_scan_cuda", [values, unit, strat, freq_table,
                                       valid, group_codes, *atom_cols],
                device)
    lib = build("quantile_scan")
    n = unit.shape[0]
    with torch.cuda.device(device):
        k = k.to(torch.float32).contiguous()
        consts = pred_consts.to(torch.float32).contiguous()
        n_sms = _n_sms(device)
        rows, chunks, gt, _ = launch_plan(n, 1, n_groups, n_sms)
        h_rows, h_chunks = hist_plan(n, n_groups, n_sms)
        mom = torch.empty((7, n_groups), dtype=torch.float32, device=device)
        partial = torch.empty((chunks, 7, n_groups), dtype=torch.float32,
                              device=device)
        hist = torch.empty((n_groups, QUANTILE_BINS), dtype=torch.float32,
                           device=device)
        h_partial = torch.empty((h_chunks, n_groups, QUANTILE_BINS),
                                dtype=torch.float32, device=device)
        head, keep = _scan_head(values, unit, strat, freq_table, valid,
                                atom_cols, group_codes, ops_struct,
                                atom_slots)
        rc = lib.quantile_scan_launch(
            *head, k.data_ptr(), consts.data_ptr(), n_groups, n,
            rows, chunks, gt, partial.data_ptr(), mom.data_ptr(),
            float(lo), float(hi), h_rows, h_chunks, h_partial.data_ptr(),
            hist.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
        del keep
    _raise_on(rc, "quantile_scan")
    quantile_scan_cuda.launches += 1
    return mom, hist


quantile_scan_cuda.launches = 0


_STAGED_GROUPS = 8       # agg_scan.cu's one-launch kernel takes G <= 8
_TICKET_BYTES = 16       # agg_scan scratch: the ticket word, then partials


@functools.lru_cache(maxsize=1024)
def agg_scan_plan(n: int, g: int, n_sms: int) -> tuple[int, int, int]:
    """(rows_per_chunk, n_chunks, group tile) of an agg_scan launch:
    launch_plan at Q = 1, kept per (n, G, card) so that a repeat call
    does not plan again."""
    return launch_plan(n, 1, g, n_sms)[:3]


# One scratch buffer per (device, stream): agg_scan's ticket word (zero
# between launches: the kernel's last block resets it) and its chunk
# partials. Launches on one stream run in order, so they may share it;
# another stream gets its own.
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _stream_scratch(cache: dict, device, stream: int,
                    nbytes: int) -> torch.Tensor:
    """The cache's zeroed buffer for (device, stream), grown to nbytes."""
    key = (device.index, stream)
    buf = cache.get(key)
    if buf is None or buf.numel() * 4 < nbytes:
        buf = torch.zeros(-(-nbytes // 4), dtype=torch.int32, device=device)
        cache[key] = buf
    return buf


def _agg_scan_scratch(device, stream: int, nbytes: int) -> torch.Tensor:
    return _stream_scratch(_SCRATCH, device, stream, nbytes)


# The rates agg_scan.cu's row loop divides by without the compiler's range
# checks: float bit patterns of [2^-60, 1] (its kFastMin and 1).
FAST_RATE_BITS = (0x21800000, 0x3F800000)


def agg_scan_rounding_mismatches(device) -> int:
    """How many floats r in [2^-60, 1] give agg_scan.cu's branch-free
    w = 1/r or vfac = (1 - r)/r² other bits than the correctly rounded
    divisions of the shared pass (0: the kernel may use them). One launch
    over all 503,316,481 of them."""
    fn = build("agg_scan").agg_scan_check_rounding
    fn.argtypes = [ctypes.c_uint, ctypes.c_uint, _P, _P]
    fn.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = fn(*FAST_RATE_BITS, bad.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "agg_scan_check_rounding")
    return int(bad.item())


def agg_scan_cuda(values, rates, mask, group_codes,
                  n_groups: int) -> torch.Tensor:
    """Launch the grouped-moments kernel on CUDA tensors: returns a fresh
    f32[7, n_groups]. Same arguments and semantics as ref.agg_scan_ref
    (codes outside [0, n_groups) land in no group; values None reads 1,
    group_codes None is group 0). Up to 8 groups: one launch, with the
    scratch of _agg_scan_scratch (a column that is not 16-byte aligned
    takes the shared pass instead, in two launches, same bits); above, the
    shared pass and its chunk reduction, with scratch from torch.empty."""
    check_agg_scan_args(values, rates, mask, group_codes, n_groups)
    device = rates.device
    _check_cuda("agg_scan_cuda", [values, rates, mask, group_codes], device)
    lib = LIBRARIES["agg_scan"].handle or build("agg_scan")
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return agg_scan_cuda(values, rates, mask, group_codes, n_groups)
    n = rates.shape[0]
    rows, chunks, gt = agg_scan_plan(n, n_groups, _n_sms(device))
    stream = _stream_handle(device)
    out = torch.empty((7, n_groups), dtype=torch.float32, device=device)
    if n_groups <= _STAGED_GROUPS:
        scratch = _agg_scan_scratch(device, stream,
                                    _TICKET_BYTES + 4 * chunks * 7 * n_groups)
        ticket = scratch.data_ptr()
        partial = ticket + _TICKET_BYTES
    else:
        scratch = torch.empty((chunks, 1, 7, n_groups), dtype=torch.float32,
                              device=device)
        ticket, partial = None, scratch.data_ptr()
    rc = lib.agg_scan_launch(
        values.data_ptr() if values is not None else None,
        _VALUE_TAGS[values.dtype] if values is not None else 0,
        rates.data_ptr(), mask.data_ptr(),
        group_codes.data_ptr() if group_codes is not None else None,
        _INT_TAGS[group_codes.dtype] if group_codes is not None else 0,
        n_groups, n, rows, chunks, gt, partial, ticket, out.data_ptr(),
        stream)
    _raise_on(rc, "agg_scan")
    agg_scan_cuda.launches += 1
    return out


agg_scan_cuda.launches = 0


_SEL_GROUPS = 8          # agg_scan_batched.cu selects, then adds, up to here

# agg_scan_batched's scratch per (device, stream): the selection bits, then
# the chunk partials. Launches on one stream run in order and may share it.
_BATCHED_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def batched_launches(q_all: int) -> list[tuple[int, int]]:
    """(first query, queries) of each launch of a Q-query agg_scan_batched
    call: at most 64 a launch, tiling [0, Q) in order. Every launch takes
    the plan agg_scan_plan(n, G, card), whatever its query count."""
    return [(q0, min(MAX_QUERIES, q_all - q0))
            for q0 in range(0, q_all, MAX_QUERIES)]


def batched_scratch(q: int, g: int, rows: int, chunks: int) -> tuple[int, int]:
    """(bits, partial) bytes of a launch of q queries: up to 8 groups, the
    selection, one 32-bit word per (query, chunk, thread of 256, window of
    32 of the thread's rows_per_chunk / 256 rows), none above; and the
    chunk partials [chunks, q, 7, G]."""
    windows = -(-rows // (256 * 32))
    return (q * chunks * 256 * windows * 4 if g <= _SEL_GROUPS else 0,
            4 * chunks * q * 7 * g)


@functools.lru_cache(maxsize=256)
def batched_template(ops_struct: tuple) -> tuple:
    """(C arguments after col_ptrs, the host arrays they point into) of a
    template whose flattened atom a reads atom row a: column tags, atom
    slots and compares, conjunction ends. Kept per template, so a repeat
    call packs nothing; two templates of one shape get their own."""
    n_atoms = sum(len(c) for c in ops_struct)
    dnf, keep = _dnf_head([0] * n_atoms, [_VALUE_TAGS[torch.float32]] * n_atoms,
                          ops_struct, range(n_atoms))
    return dnf[1:], keep


def agg_scan_batched_cuda(values, freq, entry_key, atom_cols, group_codes,
                          ks, pred_consts, ops_struct,
                          n_groups: int) -> torch.Tensor:
    """Launch the Q-query shared scan over materialized freq/entry_key on
    CUDA tensors: returns a fresh f32[Q, 7, n_groups]. Same arguments and
    semantics as ref.agg_scan_batched_ref; atom_cols [A, n] is read as
    float32 rows. Q may pass 64: the queries go in launches of at most 64
    (batched_launches), each with the plan of agg_scan_plan, so a query's
    bits do not depend on how many share its launch. Scratch (selection
    bits and chunk partials) is kept per stream."""
    check_batched_args(values, freq, entry_key, atom_cols, group_codes, ks,
                       pred_consts, ops_struct, n_groups)
    device = freq.device
    _check_cuda("agg_scan_batched_cuda", [values, freq, entry_key, atom_cols,
                                          group_codes], device)
    lib = LIBRARIES["agg_scan_batched"].handle or build("agg_scan_batched")
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return agg_scan_batched_cuda(values, freq, entry_key, atom_cols,
                                         group_codes, ks, pred_consts,
                                         ops_struct, n_groups)
    n, q_all = freq.shape[0], ks.shape[0]
    n_atoms = atom_cols.shape[0]
    atoms = atom_cols.to(torch.float32)
    ks = ks.to(torch.float32).contiguous()
    consts = pred_consts.to(torch.float32).contiguous()
    rows, chunks, gt = agg_scan_plan(n, n_groups, _n_sms(device))
    template, keep = batched_template(tuple(map(tuple, ops_struct)))
    ptrs = (ctypes.c_uint64 * max(n_atoms, 1))(
        *[atoms.data_ptr() + 4 * n * a for a in range(n_atoms)])
    stream = _stream_handle(device)
    out = torch.empty((q_all, 7, n_groups), dtype=torch.float32,
                      device=device)
    bits, partial = batched_scratch(min(q_all, MAX_QUERIES), n_groups, rows,
                                    chunks)
    scratch = _stream_scratch(_BATCHED_SCRATCH, device, stream,
                              bits + partial).data_ptr()
    for q0, q in batched_launches(q_all):
        rc = lib.agg_scan_batched_launch(
            values.data_ptr(), _VALUE_TAGS[values.dtype], freq.data_ptr(),
            entry_key.data_ptr(), group_codes.data_ptr(),
            _INT_TAGS[group_codes.dtype], ctypes.addressof(ptrs), *template,
            ks.data_ptr() + 4 * q0, consts.data_ptr() + 4 * q0 * n_atoms, q,
            n_groups, n, rows, chunks, gt,
            scratch if bits else None, scratch + bits,
            out.data_ptr() + 4 * q0 * 7 * n_groups, stream)
        _raise_on(rc, "agg_scan_batched")
        agg_scan_batched_cuda.launches += 1
    del keep
    return out


agg_scan_batched_cuda.launches = 0
