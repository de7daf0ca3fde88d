"""Fused memory-lean scan kernel for Hopper: build, bind and launch
(counterpart of `repro.kernels.agg_scan.agg_scan_fused_pallas`).

The kernel is CUDA C++ in csrc/agg_scan_fused.cu with a plain C interface.
`nvcc` compiles it for sm_90a into build/kernels/ at its first use (never at
import: the CPU tests import this module), and ctypes loads the library.
`agg_scan_fused_cuda` checks its arguments, allocates the output and the
per-chunk scratch with torch.empty, launches both passes on the current
stream and raises if the launch failed. Its `launches` attribute counts the
launches; nothing else touches it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.core.types import CMP_CODES

CSRC = Path(__file__).resolve().parent / "csrc" / "agg_scan_fused.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_ATOMS = 127          # template atoms the kernel's descriptor holds
MAX_CONJUNCTIONS = 128
MAX_STRATA = 4096        # frequency table held in shared memory
MAX_QUERIES = 64         # one 64-bit prefix mask per row and query tile
_THREADS = 256           # pass-1 block size (csrc kThreads)
_STAGE = 256             # rows staged per step (csrc kStage)
_BLOCKS_PER_SM = 8       # pass-1 blocks resident per SM (one wave)
_SCRATCH_BYTES = 64 << 20

# Column dtype tags of the kernel (csrc enum).
_VALUE_TAGS = {torch.float32: 0, torch.int8: 1, torch.int16: 2,
               torch.int32: 3, torch.uint8: 4, torch.bool: 4}
_INT_TAGS = {torch.int8: 1, torch.int16: 2, torch.int32: 3, torch.uint8: 4}


class _Library:
    """The compiled kernel library, built and loaded at first use."""
    handle: ctypes.CDLL | None = None
    path: Path | None = None
    build_seconds: float | None = None   # None: loaded an earlier build
    build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build() -> ctypes.CDLL:
    """Compile csrc/agg_scan_fused.cu (once per source version) and load it.
    The library name carries a hash of the source and flags, so an edited
    source never loads a stale build; the build writes to a temporary file
    and renames it, so concurrent builders cannot load a half-written one."""
    if _Library.handle is not None:
        return _Library.handle
    src = CSRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libagg_scan_fused_{tag}.so"
    if not path.exists():
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
        _Library.build_seconds = time.perf_counter() - t0
        _Library.build_log = proc.stdout + proc.stderr
    lib = bind(ctypes.CDLL(str(path)))
    _Library.handle, _Library.path = lib, path
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of agg_scan_fused_launch on a loaded
    library (pointers as c_void_p, so ctypes never truncates them)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.agg_scan_fused_launch.argtypes = [
        ptr, i32, ptr,                 # values, values_tag, unit
        ptr, i32, ptr, i32,            # strat, strat_tag, ftab, n_strata
        ptr, ptr, i32,                 # valid, codes, codes_tag
        ptr, ptr, i32,                 # col_ptrs, col_tags, n_cols (host)
        ptr, ptr, i32,                 # atom_slot, atom_op, n_atoms (host)
        ptr, i32,                      # conj_end, n_conj (host)
        ptr, ptr, i32, i32, i64,       # ks, consts, Q, G, n
        i64, i32, i32, i32,            # rows_per_chunk, n_chunks, qt, gt
        ptr, ptr, ptr,                 # partial, out, stream
    ]
    lib.agg_scan_fused_launch.restype = ctypes.c_int
    return lib


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def launch_plan(n: int, q: int, g: int,
                n_sms: int) -> tuple[int, int, int, int]:
    """(rows_per_chunk, n_chunks, query tile, group tile) for one launch on
    a card with `n_sms` multiprocessors. Tiles split the 256 threads of a
    block over (query, group, lane); chunks are sized to about one wave of
    blocks, fewer when the per-chunk scratch [Q, 7, G] would pass 64 MiB.
    The chunking fixes the order of the float sums, so repeat launches on
    one card are bit-identical; cards with other SM counts sum in another
    order."""
    gt = min(_pow2_ceil(g), _THREADS)
    qt = min(_pow2_ceil(q), _THREADS // gt, MAX_QUERIES)
    chunks = max(1, min(-(-n // _STAGE), n_sms * _BLOCKS_PER_SM,
                        _SCRATCH_BYTES // (4 * q * 7 * g)))
    rows = -(-max(n, 1) // chunks)
    rows = -(-rows // _STAGE) * _STAGE
    return rows, max(1, -(-n // rows)), qt, gt


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
        raise ValueError(f"freq table has {tuple(freq_table.shape)} strata; "
                         f"need 1..{MAX_STRATA}")
    if ks.dim() != 1 or not 1 <= ks.shape[0] <= MAX_QUERIES:
        raise ValueError(f"{tuple(ks.shape)} queries; need 1..{MAX_QUERIES}")
    if tuple(pred_consts.shape) != (ks.shape[0], n_atoms):
        raise ValueError(f"pred_consts has shape {tuple(pred_consts.shape)}; "
                         f"need {(ks.shape[0], n_atoms)}")
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    n = unit.shape[0]
    device = unit.device
    rows = {"unit": unit, "strat": strat, "valid": valid}
    if values is not None:
        rows["values"] = values
    if group_codes is not None:
        rows["group_codes"] = group_codes
    rows.update({f"atom_cols[{i}]": a for i, a in enumerate(atom_cols)})
    for name, t in rows.items():
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; need ({n},)")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; unit is on {device}")
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


def launch(lib: ctypes.CDLL, values, unit, strat, freq_table, valid,
           atom_cols, group_codes, ks, pred_consts, ops_struct, atom_slots,
           n_groups: int, stream) -> torch.Tensor:
    """Pack the descriptors, allocate output and scratch, and call the C
    launcher once (both passes, enqueued on `stream`). Arguments are
    already checked."""
    n, q = unit.shape[0], ks.shape[0]
    ks = ks.to(torch.float32).contiguous()
    consts = pred_consts.to(torch.float32).contiguous()
    n_sms = torch.cuda.get_device_properties(unit.device).multi_processor_count
    rows, chunks, qt, gt = launch_plan(n, q, n_groups, n_sms)
    out = torch.empty((q, 7, n_groups), dtype=torch.float32, device=unit.device)
    partial = torch.empty((chunks, q, 7, n_groups), dtype=torch.float32,
                          device=unit.device)
    n_cols = len(atom_cols)
    col_ptrs = (ctypes.c_uint64 * max(n_cols, 1))(
        *[a.data_ptr() for a in atom_cols])
    col_tags = (ctypes.c_int * max(n_cols, 1))(
        *[_VALUE_TAGS[a.dtype] for a in atom_cols])
    ops = [op for conj in ops_struct for op in conj]
    slot_arr = (ctypes.c_int * max(len(ops), 1))(*atom_slots)
    op_arr = (ctypes.c_int * max(len(ops), 1))(*[CMP_CODES[o] for o in ops])
    ends, a = [], 0
    for conj in ops_struct:
        a += len(conj)
        ends.append(a)
    end_arr = (ctypes.c_int * max(len(ends), 1))(*ends)
    rc = lib.agg_scan_fused_launch(
        values.data_ptr() if values is not None else None,
        _VALUE_TAGS[values.dtype] if values is not None else 0,
        unit.data_ptr(), strat.data_ptr(), _INT_TAGS[strat.dtype],
        freq_table.data_ptr(), freq_table.shape[0], valid.data_ptr(),
        group_codes.data_ptr() if group_codes is not None else None,
        _INT_TAGS[group_codes.dtype] if group_codes is not None else 0,
        ctypes.addressof(col_ptrs), ctypes.addressof(col_tags), n_cols,
        ctypes.addressof(slot_arr), ctypes.addressof(op_arr), len(ops),
        ctypes.addressof(end_arr), len(ends),
        ks.data_ptr(), consts.data_ptr(), q, n_groups, n,
        rows, chunks, qt, gt, partial.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"agg_scan_fused launch failed: CUDA error {rc}"
                           if rc > 0 else "agg_scan_fused: arguments refused")
    return out


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
    if device.type != "cuda":
        raise ValueError(f"agg_scan_fused_cuda takes CUDA tensors, got {device}")
    cols = [values, unit, strat, freq_table, valid, group_codes, *atom_cols]
    if not all(t is None or t.is_contiguous() for t in cols):
        raise ValueError("agg_scan_fused_cuda takes contiguous tensors")
    lib = build()
    with torch.cuda.device(device):
        out = launch(lib, values, unit, strat, freq_table, valid, atom_cols,
                     group_codes, ks, pred_consts, ops_struct, atom_slots,
                     n_groups, torch.cuda.current_stream(device).cuda_stream)
    agg_scan_fused_cuda.launches += 1
    return out


agg_scan_fused_cuda.launches = 0
