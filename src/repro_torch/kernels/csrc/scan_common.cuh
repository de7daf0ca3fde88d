// Shared pieces of the sample-scan kernels for Hopper (sm_90a): the launch
// plan, narrow-column reads, the DNF predicate, the fused scan's row
// selection, the moments pass and the chunk reduction. Every kernel source
// includes it: the moments pass is one template over a row-term producer, so
// agg_scan.cu (precomputed rates), agg_scan_batched.cu (materialized freq
// and entry_key), agg_scan_fused.cu and quantile_scan.cu (HT state derived
// from the frequency table) all add their rows in one order and give the
// same bits for the same selected rows; weighted_sum.cu reuses the chunk
// reduction.
//
// Row semantics of the fused scan (the reference's `_derive_freq`,
// `_eval_dnf` and `_fused_scan_kernel`, src/repro/kernels/agg_scan.py:293-391),
// per row i and query q:
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

#include <cuda_fp16.h>
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
enum : int { kF32 = 0, kI8 = 1, kI16 = 2, kI32 = 3, kU8 = 4, kF16 = 5 };

// The moments pass's launch plan (kernels/agg_scan.py launch_plan).
struct Plan {
  int Q, G;
  long long n, rows_per_chunk;
  int gt, n_gtiles;                         // group tile and tile count
  float* partial;                           // [n_chunks, Q, 7, G]
};

// A template's DNF over atom columns, with per-query constants.
struct Dnf {
  const float* consts;                      // [Q, n_atoms]
  int n_atoms, n_conj, n_cols;
  const void* cols[kMaxAtoms];              // distinct atom columns
  int8_t col_tag[kMaxAtoms];
  uint8_t atom_slot[kMaxAtoms];
  uint8_t atom_op[kMaxAtoms];
  uint8_t conj_end[kMaxConj];               // exclusive end atom of conj c
};

// The fused scan's descriptor (agg_scan_fused.cu, quantile_scan.cu).
struct Params : Plan, Dnf {
  const void* values; int values_tag;       // nullptr: every value is 1
  const float* unit;
  const void* strat; int strat_tag;
  const float* ftab; int n_strata;
  const uint8_t* valid;
  const void* codes; int codes_tag;         // nullptr: every row in group 0
  const float* ks;                          // [Q]

  // Shared memory the moments pass gives the row producer: the table.
  static constexpr int kShared = kMaxStrata;
  __device__ void load_shared(float* s_ftab) const;
  // Row i for query q and the group tile [g0, g_hi): its group code, or -1
  // when it is outside the tile or the query's selection; on a code, its
  // value and HT rate.
  __device__ int stage(const float* s_ftab, int q, long long i, int g0,
                       int g_hi, float* val, float* rate) const;
};

__device__ __forceinline__ float load_f32(const void* p, int tag, long long i) {
  switch (tag) {
    case kF32: return static_cast<const float*>(p)[i];
    case kI8: return static_cast<float>(static_cast<const int8_t*>(p)[i]);
    case kI16: return static_cast<float>(static_cast<const int16_t*>(p)[i]);
    case kI32: return static_cast<float>(static_cast<const int32_t*>(p)[i]);
    case kF16: return __half2float(static_cast<const __half*>(p)[i]);
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
__device__ bool eval_dnf(const Dnf& p, int q, long long i) {
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

__device__ inline void Params::load_shared(float* s_ftab) const {
  for (int i = threadIdx.x; i < n_strata; i += kThreads) s_ftab[i] = ftab[i];
}

__device__ inline int Params::stage(const float* s_ftab, int q,
                                    long long i, int g0, int g_hi,
                                    float* val, float* rate) const {
  const int c = codes ? load_i32(codes, codes_tag, i) : 0;
  float freq;
  if (c < g0 || c >= g_hi || !row_selected(*this, s_ftab, q, i, &freq))
    return -1;
  *val = values ? load_f32(values, values_tag, i) : 1.0f;
  *rate = fminf(1.0f, ks[q] / freq);
  return c;
}

// Moments pass 1, over any row producer R (a Plan with load_shared,
// stage and kShared; Params above, RateRows in agg_scan.cu, BatchedRows in
// agg_scan_batched.cu). Grid (Q * n_gtiles, n_chunks): x picks the query
// and the group tile, so the blocks that read one chunk run side by side
// and share it through L2. A thread owns group g0 + tid / lanes and walks
// every lanes-th staged row of that group.
template <class R>
__global__ void __launch_bounds__(kThreads)
moments_partials(const __grid_constant__ R p) {
  __shared__ float s_tab[R::kShared];
  __shared__ int s_code[kStage];
  __shared__ float s_val[kStage];
  __shared__ float s_rate[kStage];
  __shared__ float s_red[kStats][kThreads];

  const int tid = threadIdx.x;
  const int q = blockIdx.x / p.n_gtiles;
  const int g0 = (blockIdx.x % p.n_gtiles) * p.gt;
  const long long chunk = blockIdx.y;
  p.load_shared(s_tab);

  const int lanes = kThreads / p.gt;
  const int lane = tid % lanes;
  const int g = g0 + tid / lanes;
  const bool owner = g < p.G;
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
    float val = 0.0f, rate = 1.0f;
    if (i < row_end) code = p.stage(s_tab, q, i, g0, g_hi, &val, &rate);
    s_code[tid] = code;
    s_val[tid] = val;
    s_rate[tid] = rate;
    __syncthreads();

    if (owner) {
      const int rows = static_cast<int>(min(static_cast<long long>(kStage),
                                            row_end - base));
      for (int r = lane; r < rows; r += lanes) {
        if (s_code[r] == g) {
          const float v = s_val[r];
          const float rate_r = s_rate[r];
          const float w = 1.0f / rate_r;
          const float wx = w * v;
          const float vfac = (1.0f - rate_r) / (rate_r * rate_r);
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

// Fills the plan; false for a plan the moments pass does not take.
inline bool fill_plan(Plan& p, int Q, int G, long long n,
                      long long rows_per_chunk, int n_chunks, int gt,
                      float* partial) {
  if (Q < 1 || Q > kMaxQ || G < 1 || gt < 1 || gt > kThreads ||
      kThreads % gt != 0 || n_chunks < 1 || n_chunks > 65535 ||
      rows_per_chunk < 1 || n < 0)
    return false;
  p.Q = Q; p.G = G;
  p.n = n; p.rows_per_chunk = rows_per_chunk;
  p.gt = gt;
  p.n_gtiles = (G + gt - 1) / gt;
  p.partial = partial;
  return true;
}

// Fills the DNF descriptor from host arrays; false for a template the
// kernels do not take.
inline bool fill_dnf(Dnf& d, const unsigned long long* col_ptrs,
                     const int* col_tags, int n_cols, const int* atom_slot,
                     const int* atom_op, int n_atoms, const int* conj_end,
                     int n_conj, const float* consts) {
  if (n_atoms < 0 || n_atoms > kMaxAtoms || n_cols < 0 || n_cols > kMaxAtoms ||
      n_conj < 0 || n_conj > kMaxConj)
    return false;
  d.consts = consts;
  d.n_atoms = n_atoms; d.n_conj = n_conj; d.n_cols = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    if (col_tags[c] < kF32 || col_tags[c] > kF16) return false;
    d.cols[c] = reinterpret_cast<const void*>(col_ptrs[c]);
    d.col_tag[c] = static_cast<int8_t>(col_tags[c]);
  }
  for (int a = 0; a < n_atoms; ++a) {
    if (atom_slot[a] < 0 || atom_slot[a] >= n_cols || atom_op[a] < 0 || atom_op[a] > 5)
      return false;
    d.atom_slot[a] = static_cast<uint8_t>(atom_slot[a]);
    d.atom_op[a] = static_cast<uint8_t>(atom_op[a]);
  }
  for (int c = 0; c < n_conj; ++c) {
    if (conj_end[c] < 0 || conj_end[c] > n_atoms) return false;
    d.conj_end[c] = static_cast<uint8_t>(conj_end[c]);
  }
  return true;
}

// Fills the fused descriptor from the launcher's arguments; false for
// arguments the kernels do not take.
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
  if (n_strata < 1 || n_strata > kMaxStrata ||
      !fill_plan(p, Q, G, n, rows_per_chunk, n_chunks, gt, partial) ||
      !fill_dnf(p, col_ptrs, col_tags, n_cols, atom_slot, atom_op, n_atoms,
                conj_end, n_conj, consts))
    return false;
  p.values = values; p.values_tag = values_tag;
  p.unit = unit;
  p.strat = strat; p.strat_tag = strat_tag;
  p.ftab = ftab; p.n_strata = n_strata;
  p.valid = valid;
  p.codes = codes; p.codes_tag = codes_tag;
  p.ks = ks;
  return true;
}

// Enqueues both moments passes for producer p on stream s.
template <class R>
inline void launch_moments(const R& p, int n_chunks, float* out,
                           cudaStream_t s) {
  const unsigned tiles = static_cast<unsigned>(p.Q) * p.n_gtiles;
  moments_partials<R><<<dim3(tiles, n_chunks), kThreads, 0, s>>>(p);
  const long long per_chunk = static_cast<long long>(p.Q) * kStats * p.G;
  const long long blocks = (per_chunk + kThreads - 1) / kThreads;
  reduce_chunks<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      p.partial, out, n_chunks, per_chunk);
}

}  // namespace scan
