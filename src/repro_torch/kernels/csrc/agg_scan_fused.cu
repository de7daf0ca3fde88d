// Fused memory-lean sample scan for Hopper (sm_90a): Q queries of one
// template over ONE striped sample-family block -> f32[Q, 7, G] grouped
// moments (n, Σw, Σwx, Σwx², Σvfac, Σvfac·x, Σvfac·x²).
//
// Replaces the TPU kernel `agg_scan_fused_pallas`
// (src/repro/kernels/agg_scan.py:411, body `_fused_scan_kernel` :340 with
// `_derive_freq` :293 and `_eval_dnf` :317). Per row and query q:
//   freq   = freq_table[strat]        (the table sits in shared memory)
//   ek     = unit * freq              prefix = (ek < k_q) & valid
//   mask   = prefix & DNF(atoms, consts[q])
//   r      = min(1, k_q / freq)       w = 1/r      vfac = (1 - r) / r²
// and the seven grouped sums of (1, w, w·x, w·x·x, vfac, vfac·x, vfac·x·x).
// Pad rows carry unit = +inf and fail every prefix; valid = false rows too;
// group codes outside [0, G) land in no group.
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
// Determinism: no float atomics. Pass 1 gives each block a contiguous row
// chunk and one (query tile, group tile); threads own (q, g, lane) outputs
// and add their rows in row order, lanes combine by a fixed tree, and each
// block writes its partials to scratch [n_chunks, Q, 7, G]. Pass 2 adds the
// chunks in index order. Two launches on the same inputs give the same bits.
//
// A first kernel, right before fast: a G-wide group tile makes each thread
// walk every staged row (rows x groups predicated work, as the TPU kernel's
// one-hot did), and the block re-reads its chunk for each (q, g) tile.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libagg_scan_fused.so agg_scan_fused.cu
// -fmad=false keeps every product and sum rounded as IEEE float32 does in
// the reference (no contraction into fused multiply-adds); no fast math, so
// divisions are correctly rounded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads per block of pass 1
constexpr int kStage = 256;       // rows staged in shared memory per step
constexpr int kStats = 7;
constexpr int kMaxQ = 64;         // query tile mask is one 64-bit word
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
  int qt, gt, n_gtiles;
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

__global__ void __launch_bounds__(kThreads)
fused_scan_partials(const __grid_constant__ Params p) {
  __shared__ float s_ftab[kMaxStrata];
  __shared__ int s_code[kStage];
  __shared__ float s_val[kStage];
  __shared__ float s_freq[kStage];
  __shared__ unsigned long long s_mask[kStage];
  __shared__ float s_red[kStats][kThreads];

  const int tid = threadIdx.x;
  const long long chunk = blockIdx.x;
  const int q0 = (blockIdx.y / p.n_gtiles) * p.qt;
  const int g0 = (blockIdx.y % p.n_gtiles) * p.gt;
  for (int i = tid; i < p.n_strata; i += kThreads) s_ftab[i] = p.ftab[i];

  // Thread -> (query, group, lane) of this tile.
  const int lanes = kThreads / (p.qt * p.gt);
  const int lane = tid % lanes;
  const int gl = (tid / lanes) % p.gt;
  const int ql = tid / lanes / p.gt;
  const int q = q0 + ql, g = g0 + gl;
  const bool owner = q < p.Q && g < p.G;
  const float k = owner ? p.ks[q] : 1.0f;
  const int g_hi = min(g0 + p.gt, p.G);

  float acc[kStats];
#pragma unroll
  for (int s = 0; s < kStats; ++s) acc[s] = 0.0f;

  const long long row0 = chunk * p.rows_per_chunk;
  const long long row_end = min(row0 + p.rows_per_chunk, p.n);
  __syncthreads();

  for (long long base = row0; base < row_end; base += kStage) {
    // Stage: one row per thread, coalesced loads at stored widths.
    const long long i = base + tid;
    int code = -1;
    float val = 0.0f, freq = 1.0f;
    unsigned long long bits = 0ull;
    if (i < row_end) {
      code = p.codes ? load_i32(p.codes, p.codes_tag, i) : 0;
      if (code >= g0 && code < g_hi && p.valid[i]) {
        freq = s_ftab[load_i32(p.strat, p.strat_tag, i)];
        const float ek = p.unit[i] * freq;
        val = p.values ? load_f32(p.values, p.values_tag, i) : 1.0f;
        const int qn = min(p.qt, p.Q - q0);
        for (int j = 0; j < qn; ++j) {
          if (ek < p.ks[q0 + j] && eval_dnf(p, q0 + j, i)) bits |= 1ull << j;
        }
      }
    }
    s_code[tid] = code;
    s_val[tid] = val;
    s_freq[tid] = freq;
    s_mask[tid] = bits;
    __syncthreads();

    if (owner) {
      const int rows = static_cast<int>(min(static_cast<long long>(kStage),
                                            row_end - base));
      for (int r = lane; r < rows; r += lanes) {
        if (s_code[r] == g && ((s_mask[r] >> ql) & 1ull)) {
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

  // Fixed-order tree over the lanes of each (q, g).
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

}  // namespace

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
    long long rows_per_chunk, int n_chunks, int qt, int gt,
    float* partial, float* out, void* stream) {
  if (Q < 1 || Q > kMaxQ || G < 1 || n_strata < 1 || n_strata > kMaxStrata ||
      n_atoms < 0 || n_atoms > kMaxAtoms || n_cols < 0 || n_cols > kMaxAtoms ||
      n_conj < 0 || n_conj > kMaxConj || qt < 1 || gt < 1 ||
      qt * gt > kThreads || kThreads % (qt * gt) != 0 || n_chunks < 1 ||
      rows_per_chunk < 1)
    return -1;
  Params p;
  p.values = values; p.values_tag = values_tag;
  p.unit = unit;
  p.strat = strat; p.strat_tag = strat_tag;
  p.ftab = ftab; p.n_strata = n_strata;
  p.valid = valid;
  p.codes = codes; p.codes_tag = codes_tag;
  p.ks = ks; p.consts = consts;
  p.Q = Q; p.G = G;
  p.n = n; p.rows_per_chunk = rows_per_chunk;
  p.qt = qt; p.gt = gt;
  const int n_qtiles = (Q + qt - 1) / qt;
  p.n_gtiles = (G + gt - 1) / gt;
  p.n_atoms = n_atoms; p.n_conj = n_conj; p.n_cols = n_cols;
  p.partial = partial;
  for (int c = 0; c < n_cols; ++c) {
    p.cols[c] = reinterpret_cast<const void*>(col_ptrs[c]);
    p.col_tag[c] = static_cast<int8_t>(col_tags[c]);
  }
  for (int a = 0; a < n_atoms; ++a) {
    if (atom_slot[a] < 0 || atom_slot[a] >= n_cols || atom_op[a] < 0 || atom_op[a] > 5)
      return -1;
    p.atom_slot[a] = static_cast<uint8_t>(atom_slot[a]);
    p.atom_op[a] = static_cast<uint8_t>(atom_op[a]);
  }
  for (int c = 0; c < n_conj; ++c) {
    if (conj_end[c] < 0 || conj_end[c] > n_atoms) return -1;
    p.conj_end[c] = static_cast<uint8_t>(conj_end[c]);
  }
  const long long tiles = static_cast<long long>(n_qtiles) * p.n_gtiles;
  if (tiles > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_scan_partials<<<dim3(n_chunks, static_cast<unsigned>(tiles)), kThreads, 0, s>>>(p);
  const long long per_chunk = static_cast<long long>(Q) * kStats * G;
  const int threads = 256;
  const long long blocks = (per_chunk + threads - 1) / threads;
  reduce_chunks<<<static_cast<unsigned>(blocks), threads, 0, s>>>(partial, out, n_chunks, per_chunk);
  return static_cast<int>(cudaGetLastError());
}
