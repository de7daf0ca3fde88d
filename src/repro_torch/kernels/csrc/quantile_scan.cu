// One-query QUANTILE scan for Hopper (sm_90a) over ONE striped sample-family
// block -> (f32[7, G] grouped moments, f32[G, 256] HT-weighted value
// histogram over a fixed [lo, hi]).
//
// Replaces the TPU kernel `quantile_scan_pallas`
// (src/repro/kernels/agg_scan.py:557, body `_fused_quantile_kernel` :494).
// Per selected row (the fused scan's row semantics, scan_common.cuh):
//   bin = int(clip((v - lo) / max(hi - lo, 1e-12) * 256, 0, 255))
// clipped in float32 before the cast, and the row adds w = 1/r to
// hist[group, bin]. The TPU kernel bins through a [bins, rows] one-hot
// times the [rows, groups] one-hot on the MXU; here each bin is a thread.
//
// The moment half is the fused scan's moments pass at Q = 1, launched from
// the same code with the same chunk plan (kernels/agg_scan.py launch_plan),
// so its bits equal agg_scan_fused's for the same query.
//
// The histogram half is a second pass over the block with its own group
// tile and chunking: a tile of 16 groups x 256 bins (16 KB) sits in shared
// memory, and the per-chunk scratch [chunks, G, 256] is capped like the
// moments' (64 MiB), where the moments' chunk plan would need
// chunks x G x 1 KB (540 MB at G = 500). Each block stages 256 rows,
// compacts the selected rows of its tile in row order (warp ballots), and
// thread t adds the weights of bin t in that order; a second pass adds the
// chunk partials in index order. No float atomics: repeat launches give
// the same bits.
//
// What bounds it: device-memory bytes, as the fused scan, plus the
// 256 x G x 4 B histogram written. The design reads the block twice (once
// per half; the histogram's group tiles of one chunk run side by side and
// share its rows through L2). Folding both halves into one pass is later
// performance work.
//
// Build as agg_scan_fused.cu: -fmad=false and no fast math, so the bin
// index is computed with the reference's correctly rounded float32 ops.

#include "scan_common.cuh"

namespace {

constexpr int kBins = 256;
constexpr int kHistGroups = 16;   // groups per histogram tile
static_assert(kBins == scan::kThreads, "thread t owns bin t");

struct HistParams {
  scan::Params p;                 // the query's scan at Q = 1
  float lo, hi;
  long long rows_per_chunk;
  float* partial;                 // [n_chunks, G, kBins]
};

// Histogram pass 1. Grid (group tiles, chunks).
__global__ void __launch_bounds__(scan::kThreads)
hist_partials(const __grid_constant__ HistParams h) {
  constexpr int kWarps = scan::kThreads / 32;
  const scan::Params& p = h.p;
  __shared__ float s_ftab[scan::kMaxStrata];
  __shared__ float s_hist[kHistGroups][kBins];
  __shared__ int s_key[scan::kStage];      // (group - g0) * kBins + bin
  __shared__ float s_w[scan::kStage];
  __shared__ int s_warp[kWarps + 1];       // warp offsets, then the total

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g0 = blockIdx.x * kHistGroups;
  const int g_hi = min(g0 + kHistGroups, p.G);
  const long long chunk = blockIdx.y;
  p.load_shared(s_ftab);
  for (int j = 0; j < kHistGroups; ++j) s_hist[j][tid] = 0.0f;
  const float k = p.ks[0];
  const float span = fmaxf(h.hi - h.lo, 1e-12f);
  const long long row0 = chunk * h.rows_per_chunk;
  const long long row_end = min(row0 + h.rows_per_chunk, p.n);
  __syncthreads();

  for (long long base = row0; base < row_end; base += scan::kStage) {
    const long long i = base + tid;
    bool take = false;
    int key = 0;
    float w = 0.0f;
    if (i < row_end) {
      const int c = p.codes ? scan::load_i32(p.codes, p.codes_tag, i) : 0;
      float freq;
      if (c >= g0 && c < g_hi && scan::row_selected(p, s_ftab, 0, i, &freq)) {
        const float v = p.values ? scan::load_f32(p.values, p.values_tag, i) : 1.0f;
        const float rate = fminf(1.0f, k / freq);
        w = 1.0f / rate;
        const float x = (v - h.lo) / span * static_cast<float>(kBins);
        const float b = fminf(fmaxf(x, 0.0f), static_cast<float>(kBins - 1));
        key = (c - g0) * kBins + static_cast<int>(b);
        take = true;
      }
    }
    // Compact the taken rows, keeping row order.
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int j = 0; j < kWarps; ++j) {
        const int c = s_warp[j];
        s_warp[j] = run;
        run += c;
      }
      s_warp[kWarps] = run;
    }
    __syncthreads();
    if (take) {
      const int pos = s_warp[warp] + __popc(ballot & ((1u << lane) - 1u));
      s_key[pos] = key;
      s_w[pos] = w;
    }
    __syncthreads();
    // Thread t adds the weights of bin t in row order.
    const int taken = s_warp[kWarps];
    for (int r = 0; r < taken; ++r) {
      const int kk = s_key[r];
      if (kk % kBins == tid) s_hist[kk / kBins][tid] += s_w[r];
    }
    __syncthreads();
  }

  float* out = h.partial + (chunk * p.G + g0) * kBins;
  for (int j = 0; j < g_hi - g0; ++j) out[j * kBins + tid] = s_hist[j][tid];
}

}  // namespace

// Launches the moments passes (Q = 1, chunk plan rows_per_chunk/n_chunks/gt)
// and the histogram passes (hist_rows_per_chunk/hist_chunks) on `stream`;
// returns cudaGetLastError() after them (0 = success), or -1 for arguments
// the kernel does not take. Pointer conventions as agg_scan_fused_launch;
// k and consts hold one query ([1], [1, n_atoms]).
extern "C" int quantile_scan_launch(
    const void* values, int values_tag, const float* unit,
    const void* strat, int strat_tag, const float* ftab, int n_strata,
    const uint8_t* valid, const void* codes, int codes_tag,
    const unsigned long long* col_ptrs, const int* col_tags, int n_cols,
    const int* atom_slot, const int* atom_op, int n_atoms,
    const int* conj_end, int n_conj,
    const float* k, const float* consts, int G, long long n,
    long long rows_per_chunk, int n_chunks, int gt,
    float* partial, float* out,
    float lo, float hi, long long hist_rows_per_chunk, int hist_chunks,
    float* hist_partial, float* hist_out, void* stream) {
  HistParams h;
  if (!scan::fill_params(h.p, values, values_tag, unit, strat, strat_tag,
                         ftab, n_strata, valid, codes, codes_tag, col_ptrs,
                         col_tags, n_cols, atom_slot, atom_op, n_atoms,
                         conj_end, n_conj, k, consts, 1, G, n, rows_per_chunk,
                         n_chunks, gt, partial) ||
      hist_chunks < 1 || hist_chunks > 65535 || hist_rows_per_chunk < 1)
    return -1;
  h.lo = lo;
  h.hi = hi;
  h.rows_per_chunk = hist_rows_per_chunk;
  h.partial = hist_partial;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  scan::launch_moments(h.p, n_chunks, out, s);
  const unsigned tiles = static_cast<unsigned>((G + kHistGroups - 1) / kHistGroups);
  hist_partials<<<dim3(tiles, hist_chunks), scan::kThreads, 0, s>>>(h);
  const long long per_chunk = static_cast<long long>(G) * kBins;
  const long long blocks = (per_chunk + scan::kThreads - 1) / scan::kThreads;
  scan::reduce_chunks<<<static_cast<unsigned>(blocks), scan::kThreads, 0, s>>>(
      hist_partial, hist_out, hist_chunks, per_chunk);
  return static_cast<int>(cudaGetLastError());
}
