// Shared pieces of the sample-scan kernels for Hopper (sm_90a): the scan
// descriptor, narrow-column reads, the DNF predicate, the per-row HT
// derivation, the moments pass and the chunk reduction. agg_scan_fused.cu
// and quantile_scan.cu each include it, so the quantile kernel's moment
// half runs the very code of the fused scan at Q = 1 and gives its bits.
//
// Row semantics (the reference's `_derive_freq`, `_eval_dnf` and
// `_fused_scan_kernel`, src/repro/kernels/agg_scan.py:293-391), per row i
// and query q:
//   freq   = freq_table[strat]        (the table sits in shared memory)
//   ek     = unit * freq              prefix = (ek < k_q) & valid
//   mask   = prefix & DNF(atoms, consts[q])
//   r      = min(1, k_q / freq)       w = 1/r      vfac = (1 - r) / r²
// Pad rows carry unit = +inf and fail every prefix; valid = false rows too;
// group codes outside [0, G) land in no group.
//
// Summation order (no float atomics anywhere): a block takes a contiguous
// chunk of rows, one query and one tile of groups; its threads own
// (group, lane) outputs and add their rows in row order; lanes merge by a
// fixed tree; partials go to scratch [n_chunks, ...]; a second pass adds
// the chunks in index order. The chunking and the lanes depend on the row
// count, the group count and the card only, never on how many queries
// share the launch, so query q of a Q-query launch has the bits of the
// same query launched alone.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr int kThreads = 256;     // threads per block
constexpr int kStage = 256;       // rows staged in shared memory per step
constexpr int kStats = 7;
constexpr int kMaxQ = 64;         // queries per launch (scratch grows with Q)
constexpr int kMaxAtoms = 127;
constexpr int kMaxConj = 128;
constexpr int kMaxStrata = 4096;

// Column dtype tags (kernels/agg_scan.py _VALUE_TAGS, _INT_TAGS).
enum : int { kF32 = 0, kI8 = 1, kI16 = 2, kI32 = 3, kU8 = 4 };

struct Params {
  const void* values; int values_tag;       // nullptr: every value is 1
  const float* unit;
  const void* strat; int strat_tag;
  const float* ftab; int n_strata;
  const uint8_t* valid;
  const void* codes; int codes_tag;         // nullptr: every row in group 0
  const float* ks;                          // [Q]
  const float* consts;                      // [Q, n_atoms]
  int Q, G;
  long long n, rows_per_chunk;
  int gt, n_gtiles;                         // group tile and tile count
  int n_atoms, n_conj, n_cols;
  float* partial;                           // [n_chunks, Q, 7, G]
  const void* cols[kMaxAtoms];              // distinct atom columns
  int8_t col_tag[kMaxAtoms];
  uint8_t atom_slot[kMaxAtoms];
  uint8_t atom_op[kMaxAtoms];
  uint8_t conj_end[kMaxConj];               // exclusive end atom of conj c
};

__device__ __forceinline__ float load_f32(const void* p, int tag, long long i) {
  switch (tag) {
    case kF32: return static_cast<const float*>(p)[i];
    case kI8: return static_cast<float>(static_cast<const int8_t*>(p)[i]);
    case kI16: return static_cast<float>(static_cast<const int16_t*>(p)[i]);
    case kI32: return static_cast<float>(static_cast<const int32_t*>(p)[i]);
    default: return static_cast<float>(static_cast<const uint8_t*>(p)[i]);
  }
}

__device__ __forceinline__ int load_i32(const void* p, int tag, long long i) {
  switch (tag) {
    case kI8: return static_cast<const int8_t*>(p)[i];
    case kI16: return static_cast<const int16_t*>(p)[i];
    case kI32: return static_cast<const int32_t*>(p)[i];
    default: return static_cast<const uint8_t*>(p)[i];
  }
}

__device__ __forceinline__ bool compare(int op, float x, float c) {
  switch (op) {
    case 0: return x == c;
    case 1: return x != c;
    case 2: return x < c;
    case 3: return x <= c;
    case 4: return x > c;
    default: return x >= c;
  }
}

// DNF of the template for query q on row i; no conjunctions = TRUE, an
// empty conjunction = TRUE (as the reference's eval_pred_flat).
__device__ bool eval_dnf(const Params& p, int q, long long i) {
  if (p.n_conj == 0) return true;
  const float* c = p.consts + static_cast<long long>(q) * p.n_atoms;
  int a = 0;
  for (int j = 0; j < p.n_conj; ++j) {
    const int end = p.conj_end[j];
    bool m = true;
    for (; a < end; ++a) {
      if (m) {
        const int s = p.atom_slot[a];
        m = compare(p.atom_op[a], load_f32(p.cols[s], p.col_tag[s], i), c[a]);
      }
    }
    if (m) return true;
  }
  return false;
}

// Whether row i is in query q's prefix and passes its predicate; on true,
// *freq is the row's stratum frequency.
__device__ __forceinline__ bool row_selected(const Params& p,
                                             const float* s_ftab, int q,
                                             long long i, float* freq) {
  if (!p.valid[i]) return false;
  const float f = s_ftab[load_i32(p.strat, p.strat_tag, i)];
  if (!(p.unit[i] * f < p.ks[q]) || !eval_dnf(p, q, i)) return false;
  *freq = f;
  return true;
}

__device__ __forceinline__ void load_ftab(const Params& p, float* s_ftab) {
  for (int i = threadIdx.x; i < p.n_strata; i += kThreads) s_ftab[i] = p.ftab[i];
}

// Moments pass 1. Grid (Q * n_gtiles, n_chunks): x picks the query and the
// group tile, so the blocks that read one chunk run side by side and share
// it through L2. A thread owns group g0 + tid / lanes and walks every
// lanes-th staged row of that group.
__global__ void __launch_bounds__(kThreads)
moments_partials(const __grid_constant__ Params p) {
  __shared__ float s_ftab[kMaxStrata];
  __shared__ int s_code[kStage];
  __shared__ float s_val[kStage];
  __shared__ float s_freq[kStage];
  __shared__ float s_red[kStats][kThreads];

  const int tid = threadIdx.x;
  const int q = blockIdx.x / p.n_gtiles;
  const int g0 = (blockIdx.x % p.n_gtiles) * p.gt;
  const long long chunk = blockIdx.y;
  load_ftab(p, s_ftab);

  const int lanes = kThreads / p.gt;
  const int lane = tid % lanes;
  const int g = g0 + tid / lanes;
  const bool owner = g < p.G;
  const float k = p.ks[q];
  const int g_hi = min(g0 + p.gt, p.G);

  float acc[kStats];
#pragma unroll
  for (int s = 0; s < kStats; ++s) acc[s] = 0.0f;

  const long long row0 = chunk * p.rows_per_chunk;
  const long long row_end = min(row0 + p.rows_per_chunk, p.n);
  __syncthreads();

  for (long long base = row0; base < row_end; base += kStage) {
    // Stage: one row per thread, coalesced loads at stored widths. A row
    // outside the tile or the query's selection stages as code -1.
    const long long i = base + tid;
    int code = -1;
    float val = 0.0f, freq = 1.0f;
    if (i < row_end) {
      const int c = p.codes ? load_i32(p.codes, p.codes_tag, i) : 0;
      if (c >= g0 && c < g_hi && row_selected(p, s_ftab, q, i, &freq)) {
        code = c;
        val = p.values ? load_f32(p.values, p.values_tag, i) : 1.0f;
      }
    }
    s_code[tid] = code;
    s_val[tid] = val;
    s_freq[tid] = freq;
    __syncthreads();

    if (owner) {
      const int rows = static_cast<int>(min(static_cast<long long>(kStage),
                                            row_end - base));
      for (int r = lane; r < rows; r += lanes) {
        if (s_code[r] == g) {
          const float v = s_val[r];
          const float rate = fminf(1.0f, k / s_freq[r]);
          const float w = 1.0f / rate;
          const float wx = w * v;
          const float vfac = (1.0f - rate) / (rate * rate);
          const float vx = vfac * v;
          acc[0] += 1.0f;
          acc[1] += w;
          acc[2] += wx;
          acc[3] += wx * v;
          acc[4] += vfac;
          acc[5] += vx;
          acc[6] += vx * v;
        }
      }
    }
    __syncthreads();
  }

  // Fixed-order tree over the lanes of each group.
#pragma unroll
  for (int s = 0; s < kStats; ++s) s_red[s][tid] = acc[s];
  __syncthreads();
  for (int stride = lanes / 2; stride > 0; stride >>= 1) {
    if (lane < stride) {
#pragma unroll
      for (int s = 0; s < kStats; ++s) s_red[s][tid] += s_red[s][tid + stride];
    }
    __syncthreads();
  }
  if (owner && lane == 0) {
    float* out = p.partial + ((chunk * p.Q + q) * kStats) * p.G + g;
#pragma unroll
    for (int s = 0; s < kStats; ++s) out[static_cast<long long>(s) * p.G] = s_red[s][tid];
  }
}

// Pass 2: out[j] = Σ_c partial[c, j] in chunk order.
__global__ void reduce_chunks(const float* __restrict__ partial,
                              float* __restrict__ out, int n_chunks,
                              long long per_chunk) {
  const long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (j >= per_chunk) return;
  float acc = 0.0f;
  for (int c = 0; c < n_chunks; ++c) acc += partial[c * per_chunk + j];
  out[j] = acc;
}

// Fills p from the launcher's arguments; false for arguments the kernels
// do not take.
inline bool fill_params(Params& p, const void* values, int values_tag,
                        const float* unit, const void* strat, int strat_tag,
                        const float* ftab, int n_strata, const uint8_t* valid,
                        const void* codes, int codes_tag,
                        const unsigned long long* col_ptrs, const int* col_tags,
                        int n_cols, const int* atom_slot, const int* atom_op,
                        int n_atoms, const int* conj_end, int n_conj,
                        const float* ks, const float* consts, int Q, int G,
                        long long n, long long rows_per_chunk, int n_chunks,
                        int gt, float* partial) {
  if (Q < 1 || Q > kMaxQ || G < 1 || n_strata < 1 || n_strata > kMaxStrata ||
      n_atoms < 0 || n_atoms > kMaxAtoms || n_cols < 0 || n_cols > kMaxAtoms ||
      n_conj < 0 || n_conj > kMaxConj || gt < 1 || gt > kThreads ||
      kThreads % gt != 0 || n_chunks < 1 || n_chunks > 65535 ||
      rows_per_chunk < 1)
    return false;
  p.values = values; p.values_tag = values_tag;
  p.unit = unit;
  p.strat = strat; p.strat_tag = strat_tag;
  p.ftab = ftab; p.n_strata = n_strata;
  p.valid = valid;
  p.codes = codes; p.codes_tag = codes_tag;
  p.ks = ks; p.consts = consts;
  p.Q = Q; p.G = G;
  p.n = n; p.rows_per_chunk = rows_per_chunk;
  p.gt = gt;
  p.n_gtiles = (G + gt - 1) / gt;
  p.n_atoms = n_atoms; p.n_conj = n_conj; p.n_cols = n_cols;
  p.partial = partial;
  for (int c = 0; c < n_cols; ++c) {
    p.cols[c] = reinterpret_cast<const void*>(col_ptrs[c]);
    p.col_tag[c] = static_cast<int8_t>(col_tags[c]);
  }
  for (int a = 0; a < n_atoms; ++a) {
    if (atom_slot[a] < 0 || atom_slot[a] >= n_cols || atom_op[a] < 0 || atom_op[a] > 5)
      return false;
    p.atom_slot[a] = static_cast<uint8_t>(atom_slot[a]);
    p.atom_op[a] = static_cast<uint8_t>(atom_op[a]);
  }
  for (int c = 0; c < n_conj; ++c) {
    if (conj_end[c] < 0 || conj_end[c] > n_atoms) return false;
    p.conj_end[c] = static_cast<uint8_t>(conj_end[c]);
  }
  return true;
}

// Enqueues both moments passes for p on stream s.
inline void launch_moments(const Params& p, int n_chunks, float* out,
                           cudaStream_t s) {
  const unsigned tiles = static_cast<unsigned>(p.Q) * p.n_gtiles;
  moments_partials<<<dim3(tiles, n_chunks), kThreads, 0, s>>>(p);
  const long long per_chunk = static_cast<long long>(p.Q) * kStats * p.G;
  const long long blocks = (per_chunk + kThreads - 1) / kThreads;
  reduce_chunks<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      p.partial, out, n_chunks, per_chunk);
}

}  // namespace scan
