// Q-query shared scan over materialized HT state for Hopper (sm_90a):
// values, freq and entry_key f32[n], one f32 row per template atom, group
// codes, ks f32[Q] and consts f32[Q, A] -> f32[Q, 7, G]. For query q a row
// counts when entry_key < ks[q] and the DNF holds on consts[q]; its rate
// is min(1, ks[q] / freq).
//
// Replaces the TPU kernel `agg_scan_batched_pallas`
// (src/repro/kernels/agg_scan.py:220, body `_agg_scan_batched_kernel`
// :166), reached through kernels/ops.py agg_scan_batched. It is the fused
// scan's pass (scan_common.cuh) with the derivation swapped for reads:
// BatchedRows reads freq and entry_key where Params gathers the frequency
// table and multiplies, and its DNF reads one f32 row per atom. Given
// freq = freq_table[strat] and entry_key = where(valid, unit·freq, inf), a
// row is selected, and its rate computed, by the same float32 operations
// as in the fused scan, and the plan and summation order are shared: the
// two kernels agree at max |diff| 0.0, which is the reference's promise.
//
// What bounds it: device-memory bytes (values, freq, entry_key and every
// atom row, 4 B each, and the codes, read once per (query, group tile)
// block; blocks of one chunk share them through L2). A first kernel: the
// per-query blocks re-evaluate the DNF on every row.
//
// The wrapper launches at most 64 queries at a time (scan::kMaxQ); a
// query's bits do not depend on how many share its launch.
//
// Build as agg_scan_fused.cu (-fmad=false, no fast math).

#include "scan_common.cuh"

namespace {

struct BatchedRows : scan::Plan, scan::Dnf {
  const void* values; int values_tag;
  const float* freq;
  const float* ek;
  const void* codes; int codes_tag;
  const float* ks;                          // [Q]

  static constexpr int kShared = 1;
  __device__ void load_shared(float*) const {}
  __device__ int stage(const float*, int q, long long i, int g0, int g_hi,
                       float* val, float* rate) const {
    const int c = scan::load_i32(codes, codes_tag, i);
    if (c < g0 || c >= g_hi || !(ek[i] < ks[q]) || !scan::eval_dnf(*this, q, i))
      return -1;
    *val = scan::load_f32(values, values_tag, i);
    *rate = fminf(1.0f, ks[q] / freq[i]);
    return c;
  }
};

}  // namespace

// Launches both passes on `stream`; returns cudaGetLastError() after them
// (0 = success), or -1 for arguments the kernel does not take. Data
// pointers are device pointers; col_ptrs (the atom rows, each f32[n]) ...
// conj_end are host arrays copied into the kernel's parameters. partial is
// [n_chunks, Q, 7, G], out [Q, 7, G].
extern "C" int agg_scan_batched_launch(
    const void* values, int values_tag, const float* freq, const float* ek,
    const void* codes, int codes_tag,
    const unsigned long long* col_ptrs, const int* col_tags, int n_cols,
    const int* atom_slot, const int* atom_op, int n_atoms,
    const int* conj_end, int n_conj,
    const float* ks, const float* consts, int Q, int G, long long n,
    long long rows_per_chunk, int n_chunks, int gt,
    float* partial, float* out, void* stream) {
  BatchedRows p;
  if (!scan::fill_plan(p, Q, G, n, rows_per_chunk, n_chunks, gt, partial) ||
      !scan::fill_dnf(p, col_ptrs, col_tags, n_cols, atom_slot, atom_op,
                      n_atoms, conj_end, n_conj, consts) ||
      values_tag < scan::kF32 || values_tag > scan::kF16 ||
      codes_tag < scan::kI8 || codes_tag > scan::kU8)
    return -1;
  p.values = values; p.values_tag = values_tag;
  p.freq = freq;
  p.ek = ek;
  p.codes = codes; p.codes_tag = codes_tag;
  p.ks = ks;
  scan::launch_moments(p, n_chunks, out, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
