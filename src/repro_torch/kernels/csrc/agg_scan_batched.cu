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
// block; blocks of one chunk share them through L2). The per-query blocks
// re-read the chunk and re-evaluate the DNF on every row; sharing one
// staged step across a chunk's queries is later work.
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

  __host__ __device__ int n_tab() const { return 0; }
  __device__ void load_shared(float*) const {}
  template <int R>
  __device__ __forceinline__ void rows(const float*, int q,
                                       const long long (&i)[R], int (&code)[R],
                                       float (&val)[R], float (&rate)[R]) const {
    int c[R];
    float e[R], f[R];
    bool m[R];
    scan::load_i32<R>(codes, codes_tag, i, c);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      e[j] = __ldg(ek + i[j]);
      f[j] = __ldg(freq + i[j]);
    }
    const float k = __ldg(ks + q);
    bool live = false;
#pragma unroll
    for (int j = 0; j < R; ++j) live |= e[j] < k;
    scan::prefix_rows<R>(*this, q, i, live, values, values_tag, val, m);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      code[j] = ((e[j] < k) & m[j]) ? c[j] : -1;
      rate[j] = fminf(1.0f, k / f[j]);
    }
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
  const int rc = scan::launch_moments(p, n_chunks, out,
                                      static_cast<cudaStream_t>(stream));
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
