// Non-grouped HT-weighted masked reduction for Hopper (sm_90a): values,
// weights f32[n] and mask bool[n] -> f32[3] = (Σ w·m, Σ w·m·x, Σ w·m·x²).
//
// Replaces the TPU kernel `weighted_sum_pallas`
// (src/repro/kernels/weighted_sum.py:42, body `_weighted_sum_kernel` :21),
// reached through kernels/ops.py weighted_sum. The TPU kernel folds its
// rows into an [8, 128] lane accumulator carried across the sequential
// grid; blocks on this card run in no order, so each block reduces one
// contiguous chunk of rows (thread t takes rows t, t + 256, ... in order,
// then a fixed tree over the 256 threads) into per-chunk partials, and
// scan_common.cuh's reduce_chunks adds the chunks in index order. No float
// atomics: repeat launches give the same bits. Rows whose mask is false
// add nothing (the reference adds w·0 = 0 for them).
//
// What bounds it: device-memory bytes (4 + 4 + 1 per row, read once); five
// float operations per row are far below the card's operations per byte.
//
// Build as agg_scan_fused.cu (-fmad=false, no fast math: w·x·x rounds as
// (w·x)·x in float32, as the reference does).

#include "scan_common.cuh"

namespace {

constexpr int kSums = 3;

struct SumParams {
  const void* values; int values_tag;
  const float* weights;
  const uint8_t* mask;
  long long n, rows_per_chunk;
  float* partial;                           // [n_chunks, 3]
};

__global__ void __launch_bounds__(scan::kThreads)
sum_partials(const __grid_constant__ SumParams p) {
  __shared__ float s_red[kSums][scan::kThreads];
  const int tid = threadIdx.x;
  const long long chunk = blockIdx.x;
  const long long row0 = chunk * p.rows_per_chunk;
  const long long row_end = min(row0 + p.rows_per_chunk, p.n);
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (long long i = row0 + tid; i < row_end; i += scan::kThreads) {
    if (p.mask[i]) {
      const long long at[1] = {i};
      float xs[1];
      scan::load_f32<1>(p.values, p.values_tag, at, xs);
      const float x = xs[0];
      const float w = p.weights[i];
      const float wx = w * x;
      s0 += w;
      s1 += wx;
      s2 += wx * x;
    }
  }
  s_red[0][tid] = s0;
  s_red[1][tid] = s1;
  s_red[2][tid] = s2;
  __syncthreads();
  for (int stride = scan::kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int s = 0; s < kSums; ++s) s_red[s][tid] += s_red[s][tid + stride];
    }
    __syncthreads();
  }
  if (tid < kSums) p.partial[chunk * kSums + tid] = s_red[tid][0];
}

}  // namespace

// Launches both passes on `stream`; returns cudaGetLastError() after them
// (0 = success), or -1 for arguments the kernel does not take. Every
// pointer is a device pointer; partial is [n_chunks, 3], out [3].
extern "C" int weighted_sum_launch(
    const void* values, int values_tag, const float* weights,
    const uint8_t* mask, long long n, long long rows_per_chunk, int n_chunks,
    float* partial, float* out, void* stream) {
  if (n < 0 || rows_per_chunk < 1 || n_chunks < 1 ||
      values_tag < scan::kF32 || values_tag > scan::kF16)
    return -1;
  SumParams p{values, values_tag, weights, mask, n, rows_per_chunk, partial};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sum_partials<<<static_cast<unsigned>(n_chunks), scan::kThreads, 0, s>>>(p);
  scan::launch_reduce(s, partial, out, n_chunks, kSums);
  return static_cast<int>(cudaGetLastError());
}
