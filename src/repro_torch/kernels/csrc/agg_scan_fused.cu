// Fused memory-lean sample scan for Hopper (sm_90a): Q queries of one
// template over ONE striped sample-family block -> f32[Q, 7, G] grouped
// moments (n, Σw, Σwx, Σwx², Σvfac, Σvfac·x, Σvfac·x²).
//
// Replaces the TPU kernel `agg_scan_fused_pallas`
// (src/repro/kernels/agg_scan.py:411, body `_fused_scan_kernel` :340 with
// `_derive_freq` :293 and `_eval_dnf` :317). The row semantics, the
// moments pass and the chunk reduction live in scan_common.cuh, which every
// kernel of the port includes (Params is this kernel's row producer).
//
// What bounds it: device-memory bytes. The scan streams each row's
// primitives once (values, unit, strat, valid, group code, each distinct
// atom column at its stored width: the count of
// repro.launch.roofline.scan_bytes_per_row) and does O(1) arithmetic per
// byte, far below the card's ~20 float operations per byte at 3.35 TB/s.
// The design answers that by reading every column at its stored width
// (int8/int16 codes are widened in registers, never in memory), deriving
// freq and entry_key on chip instead of streaming them, and reading each
// distinct column once however many template atoms compare it. The TPU
// kernel's one-hot matmuls were a workaround for a chip without gather or
// scatter; here the frequency table is gathered from shared memory and the
// grouped sum is predicated adds.
//
// The first kernel reached 1-8% of that bound: each thread staged one row
// per step through a chain of dependent, branch-guarded loads, and above
// 128 groups every thread tested every staged row (PERF.md §6). The
// moments pass of scan_common.cuh now issues the column loads of four rows
// a thread together (the value and atom columns only in warps that hold a
// prefix row), selects rows without branches, has each
// thread sum its own rows for G <= 8 (in registers, or in its own
// shared-memory column) with no barrier in the row loop, hands G > 8
// groups to one owner warp each (one tile of up to 1024 groups), and
// reduces the chunk partials with a fixed 32-lane tree instead of a
// 1056-long chain.
//
// Determinism: no float atomics (scan_common.cuh). Each block takes one
// query, so a query's sum order does not depend on Q: query q of a
// Q-query launch gives the bits of the same query launched alone. The
// blocks of one chunk sit next to each other in the grid and share the
// chunk's rows through L2.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libagg_scan_fused.so agg_scan_fused.cu
// -fmad=false keeps every product and sum rounded as IEEE float32 does in
// the reference (no contraction into fused multiply-adds); no fast math, so
// divisions are correctly rounded.

#include "scan_common.cuh"

// Launches both passes on `stream`; returns cudaGetLastError() after them
// (0 = success), or -1 for arguments the kernel does not take. Pointers to
// column data, ks, consts, partial and out are device pointers; the
// descriptor arrays (col_ptrs ... conj_end) are host arrays copied into the
// kernel's parameters.
extern "C" int agg_scan_fused_launch(
    const void* values, int values_tag, const float* unit,
    const void* strat, int strat_tag, const float* ftab, int n_strata,
    const uint8_t* valid, const void* codes, int codes_tag,
    const unsigned long long* col_ptrs, const int* col_tags, int n_cols,
    const int* atom_slot, const int* atom_op, int n_atoms,
    const int* conj_end, int n_conj,
    const float* ks, const float* consts, int Q, int G, long long n,
    long long rows_per_chunk, int n_chunks, int gt,
    float* partial, float* out, void* stream) {
  scan::Params p;
  if (!scan::fill_params(p, values, values_tag, unit, strat, strat_tag, ftab,
                         n_strata, valid, codes, codes_tag, col_ptrs, col_tags,
                         n_cols, atom_slot, atom_op, n_atoms, conj_end, n_conj,
                         ks, consts, Q, G, n, rows_per_chunk, n_chunks, gt,
                         partial))
    return -1;
  const int rc = scan::launch_moments(p, n_chunks, out,
                                      static_cast<cudaStream_t>(stream));
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
