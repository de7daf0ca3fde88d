// Q-query shared scan over materialized HT state for Hopper (sm_90a):
// values, freq and entry_key f32[n], one f32 row per template atom, group
// codes, ks f32[Q] and consts f32[Q, A] -> f32[Q, 7, G]. For query q a row
// counts when entry_key < ks[q] and the DNF holds on consts[q]; its rate
// is min(1, ks[q] / freq).
//
// Replaces the TPU kernel `agg_scan_batched_pallas`
// (src/repro/kernels/agg_scan.py:220, body `_agg_scan_batched_kernel`
// :166), reached through kernels/ops.py agg_scan_batched.
//
// What bounds it: device-memory bytes, 17 B a row on the main path (values,
// freq, entry_key and one atom row f32, int8 codes), and per (row, query)
// a few float operations: the selection is two compares, the HT terms
// (three correctly rounded divisions) are needed only for selected rows.
// The first kernel gave each query its own blocks, which re-read the whole
// chunk through L2 and divided on every row: at 32 queries 32 reads of the
// chunk and 32 × n rows of divisions, where phase 3c's queries (URL = u
// at K1) select at most 1 row in 100 each: a URL stratum holds at most
// K1 = 100,000 of the block's 10,195,008 slots.
//
// Up to 8 groups (kSelGroups) a launch is select, then add:
//   - select_bits reads entry_key and the atom rows once for all the
//     launch's queries (one block a chunk, each thread holding a window of
//     32 of its rows in registers) and writes one bit per (query, row),
//     kept per thread of the next kernel: two compares and an or a (row,
//     query), no vote;
//   - masked_moments gives each (query, chunk) one block, as the shared
//     pass does; a thread reads its own words and loads the value, freq
//     and code of its selected rows only, and computes their rate, w and
//     vfac, nowhere else. A warp that selects nothing in the chunk skips
//     its tree;
//   - the chunk reduction of scan_common.cuh (reduce_chunks).
// Above 8 groups the launch takes the shared pass of scan_common.cuh
// (shared mode) with the row producer BatchedRows, and its chunk
// reduction. Bulk copies are not used: no path needs 16-byte-aligned
// columns, so unaligned atom rows and a ragged last chunk take the same
// kernels.
//
// Same bits in both: the plan (kernels/agg_scan.py launch_plan) depends on
// (n, G, card) only; thread t of a (query, chunk) block adds rows t,
// t + 256, ... of its chunk in row order, with the shared pass's float32
// expressions (-fmad=false); a warp's 32 sums are added by the shuffle
// tree's pairing (x_l + x_{l^16}, then ^8, ^4, ^2, ^1: the sum lane 0
// ends with), computed by one thread per sum from the warp's shared-memory
// columns, and the 8 warps by the pass's fixed tree; the chunks by
// reduce_chunks. A row outside the selection adds nothing, and a warp with
// no selected row gives +0, the tree's sum of 32 zeros. So
// agg_scan_batched equals agg_scan_fused at max |diff| 0.0 (given freq =
// freq_table[strat] and entry_key = where(valid, unit·freq, inf)), and a
// query's bits do not depend on how many queries share its launch.
//
// The wrapper launches at most 64 queries at a time (scan::kMaxQ).
//
// Build as agg_scan_fused.cu (-fmad=false, no fast math).

#include <math.h>

#include "scan_common.cuh"

namespace {

constexpr int kSelGroups = 8;               // select, then add: G <= 8
constexpr int kAddBatch = 4;                // selected slots loaded together
constexpr int kColStride = scan::kThreads + 1;  // floats between sum columns
constexpr int kAnyDnf = -1;                 // select_bits: any template
constexpr int kNoDnf = 6;                   // select_bits: the prefix alone

// The shared pass's row producer (G > 8).
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

// A chunk's rows by slot: slot s of thread t (lane t mod 32 of warp t / 32)
// is row row0 + 256 s + t, the rows thread t of a (query, chunk) block
// adds in order. The selection is kept per thread in windows of 32 slots:
// bit i of word bits[q * plane + c * chunk_words + (w * windows + v) * 32
// + lane] is slot 32 v + i of that thread, windows = ceil(slots / 32),
// slots = rows_per_chunk / 256, chunk_words = 256 * windows.
struct Select : scan::Dnf {
  const float* ek;
  const float* ks;                          // [Q]
  long long n, rows_per_chunk, plane, chunk_words;
  int Q, slots, windows;
  unsigned* bits;
};

template <int kOp>
__device__ __forceinline__ bool holds(float x, float c) {
  if constexpr (kOp == 0) return x == c;
  else if constexpr (kOp == 1) return x != c;
  else if constexpr (kOp == 2) return x < c;
  else if constexpr (kOp == 3) return x <= c;
  else if constexpr (kOp == 4) return x > c;
  else return x >= c;
}

// The words of one window for every query: the first `valid` of its 32
// slots are rows of the plan's chunk (all 32 but in a chunk's last
// window); e and x hold their entry keys and atoms (+inf and 0 past the
// table's rows).
template <int kOp, bool kFull>
__device__ __forceinline__ void select_window(
    const Select& p, const float* s_k, const float* s_c, long long row0,
    int s0, int valid, const float (&e)[32], const float (&x)[32],
    unsigned* out) {
  constexpr bool kOneAtom = kOp >= 0 && kOp < kNoDnf;
  const int tid = threadIdx.x;
  for (int q = 0; q < p.Q; ++q) {
    const float k = s_k[q];
    unsigned mine = 0u;
    if constexpr (kOneAtom) {
      const float c = s_c[q];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (!kFull && i >= valid) break;
        if ((e[i] < k) & holds<kOp>(x[i], c)) mine |= 1u << i;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (!kFull && i >= valid) break;
        bool sel = e[i] < k;
        if constexpr (kOp == kAnyDnf) {
          if (__any_sync(0xffffffffu, sel)) {
            const long long at[1] = {
                row0 + (sel ? (s0 + i) * scan::kThreads + tid : 0)};
            bool m[1];
            scan::eval_dnf<1>(p, q, at, m);
            sel &= m[0];
          }
        }
        if (sel) mine |= 1u << i;
      }
    }
    out[q * p.plane] = mine;
  }
}

// One block a chunk; each thread takes its slots a window of 32 at a time
// (the entry keys, and with a one-atom template the atom, in registers,
// all loads issued before any is used) and, for each query of the launch,
// sets bit i of its word where slot i's row is selected: two compares and
// an or a (row, query), the window's words of a warp one 128-byte store.
// kOp: the one atom's compare (0..5, the CmpOp codes), kNoDnf for a
// template that is TRUE, kAnyDnf for any other (its atoms read per query
// through L1, only by warps holding a prefix row).
template <int kOp>
__global__ void __launch_bounds__(scan::kThreads)
select_bits(const __grid_constant__ Select p) {
  constexpr bool kOneAtom = kOp >= 0 && kOp < kNoDnf;
  __shared__ float s_k[scan::kMaxQ], s_c[scan::kMaxQ];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long chunk = blockIdx.x;
  const long long row0 = chunk * p.rows_per_chunk;
  const int lim = static_cast<int>(min(p.rows_per_chunk, p.n - row0));
  const float* ek = p.ek + row0;
  const float* atom =
      kOneAtom ? static_cast<const float*>(p.cols[p.atom_slot[0]]) + row0
               : nullptr;
  unsigned* out = p.bits + chunk * p.chunk_words +
                  warp * p.windows * 32 + lane;
  if (tid < p.Q) {
    s_k[tid] = p.ks[tid];
    if (kOneAtom) s_c[tid] = p.consts[tid];
  }
  __syncthreads();
  for (int v = 0; v < p.windows; ++v) {
    const int s0 = 32 * v, valid = min(32, p.slots - s0);
    float e[32], x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int off = (s0 + i) * scan::kThreads + tid;
      const bool in = (i < valid) & (off < lim);
      e[i] = in ? __ldg(ek + off) : INFINITY;   // fails every prefix
      x[i] = kOneAtom && in ? __ldg(atom + off) : 0.0f;
    }
    if (valid == 32)
      select_window<kOp, true>(p, s_k, s_c, row0, s0, valid, e, x,
                               out + v * 32);
    else
      select_window<kOp, false>(p, s_k, s_c, row0, s0, valid, e, x,
                                out + v * 32);
  }
}

struct Moments {
  const void* values; int values_tag;
  const float* freq;
  const void* codes; int codes_tag;
  const float* ks;                          // [Q]
  const unsigned* bits;                     // select_bits' words
  long long rows_per_chunk, plane, chunk_words;
  int Q, windows;
  float* partial;                           // [n_chunks, Q, 7, G]
};

// Block (q, chunk): thread t's sums are its own column of shared memory,
// [7 × G][kColStride] (statistic-major, as the shared pass's columns),
// zeroed by the block at its start. Each thread reads its words two
// windows at a time (one coalesced load a warp and window, the next two
// issued before these are used) and loads the value, freq and code of up
// to kAddBatch of its selected slots at once, then adds them in slot
// (= row) order with the shared pass's expressions. The trees then reduce
// each warp's columns and the warps into the chunk's partials.
template <int G>
__global__ void __launch_bounds__(scan::kThreads)
masked_moments(const __grid_constant__ Moments p) {
  constexpr int kOut = scan::kStats * G;
  extern __shared__ float4 s_cols4[];       // [kOut][kColStride], padded
  __shared__ float s_red[scan::kWarps][kOut];
  __shared__ int s_touched[scan::kWarps];
  float* s_cols = reinterpret_cast<float*>(s_cols4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = blockIdx.x;
  const long long chunk = blockIdx.y;
  const unsigned* words = p.bits + q * p.plane + chunk * p.chunk_words +
                          warp * p.windows * 32 + lane;
  // Two windows (64 slots) a step, the next step's words issued before
  // this one's are used.
  unsigned lo = __ldg(words), hi = p.windows > 1 ? __ldg(words + 32) : 0u;
  for (int j = tid; j < (kOut * kColStride + 3) / 4; j += scan::kThreads)
    s_cols4[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const long long base = chunk * p.rows_per_chunk + tid;
  float* col = s_cols + tid;
  const float k = __ldg(p.ks + q);
  bool touched = false;                     // warp-uniform
  for (int v = 0; v < p.windows; v += 2) {
    unsigned long long mine = lo | static_cast<unsigned long long>(hi) << 32;
    if (v + 2 < p.windows) {
      lo = __ldg(words + (v + 2) * 32);
      hi = v + 3 < p.windows ? __ldg(words + (v + 3) * 32) : 0u;
    }
    if (!__any_sync(0xffffffffu, mine != 0ull)) continue;
    touched = true;
    while (mine) {
      long long row[kAddBatch];
      bool take[kAddBatch];
#pragma unroll
      for (int b = 0; b < kAddBatch; ++b) {
        take[b] = mine != 0ull;
        row[b] = base + static_cast<long long>(32 * v + __ffsll(mine) - 1) *
                            scan::kThreads;
        mine &= mine - 1ull;
      }
      float val[kAddBatch], f[kAddBatch];
      int c[kAddBatch];
#pragma unroll
      for (int b = 0; b < kAddBatch; ++b) {
        if (take[b]) {
          const long long at[1] = {row[b]};
          float x[1];
          int y[1];
          scan::load_f32<1>(p.values, p.values_tag, at, x);
          scan::load_i32<1>(p.codes, p.codes_tag, at, y);
          val[b] = x[0];
          c[b] = y[0];
          f[b] = __ldg(p.freq + row[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < kAddBatch; ++b) {
        if (take[b] && static_cast<unsigned>(c[b]) < static_cast<unsigned>(G)) {
          const float r = fminf(1.0f, k / f[b]), x = val[b];
          const float w = 1.0f / r;
          const float wx = w * x;
          const float vfac = (1.0f - r) / (r * r);
          const float vx = vfac * x;
          float* a = col + c[b] * kColStride;
          constexpr int kS = G * kColStride;  // stride of one statistic
          a[0] += 1.0f;
          a[kS] += w;
          a[2 * kS] += wx;
          a[3 * kS] += wx * x;
          a[4 * kS] += vfac;
          a[5 * kS] += vx;
          a[6 * kS] += vx * x;
        }
      }
    }
  }
  if (lane == 0) s_touched[warp] = touched;
  __syncthreads();
  // Task t = (warp w, sum j): one thread adds warp w's 32 columns of sum j
  // by the shuffle tree's pairing; an untouched warp's sums are +0. The
  // tasks of a warp of threads have distinct j, so their reads hit
  // distinct banks (kColStride = 1 mod 32) from G = 5.
  for (int t = tid; t < scan::kWarps * kOut; t += scan::kThreads) {
    const int w = t / kOut, j = t - w * kOut;
    float x = 0.0f;
    if (s_touched[w]) {
      float u[32];
      const float* src = s_cols + j * kColStride + w * 32;
#pragma unroll
      for (int i = 0; i < 32; ++i) u[i] = src[i];
#pragma unroll
      for (int i = 0; i < 16; ++i) u[i] += u[i + 16];
#pragma unroll
      for (int i = 0; i < 8; ++i) u[i] += u[i + 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] += u[i + 4];
#pragma unroll
      for (int i = 0; i < 2; ++i) u[i] += u[i + 2];
      x = u[0] + u[1];
    }
    s_red[w][j] = x;
  }
  __syncthreads();
  if (tid < kOut) {
    float v[scan::kWarps];
#pragma unroll
    for (int w = 0; w < scan::kWarps; ++w) v[w] = s_red[w][tid];
#pragma unroll
    for (int half = scan::kWarps / 2; half > 0; half >>= 1)
#pragma unroll
      for (int w = 0; w < half; ++w) v[w] += v[w + half];
    // tid = s * G + g: partial [chunk][q][s][g]
    p.partial[(chunk * p.Q + q) * kOut + tid] = v[0];
  }
}

template <int kOp>
int launch_select(const Select& a, int n_chunks, cudaStream_t s) {
  select_bits<kOp><<<n_chunks, scan::kThreads, 0, s>>>(a);
  return 0;
}

template <int G>
int launch_masked(const Moments& m, int n_chunks, cudaStream_t s) {
  constexpr int bytes = (scan::kStats * G * kColStride + 3) / 4 * 16;
  static bool ready = false;
  if (!ready) {
    // The SM's whole shared-memory carveout, so that the sums' columns,
    // not the split with L1, cap the blocks an SM holds.
    cudaError_t e = cudaFuncSetAttribute(
        masked_moments<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(masked_moments<G>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  masked_moments<G><<<dim3(m.Q, n_chunks), scan::kThreads, bytes, s>>>(m);
  return 0;
}

int select_then_add(const Select& a, const Moments& m, int G, int n_chunks,
                    float* out, cudaStream_t s) {
  // The one-atom compare of a one-conjunction template, the prefix alone
  // for a TRUE one (no conjunction, or one without atoms).
  int op = kAnyDnf;
  if (a.n_conj == 0 || (a.n_conj == 1 && a.n_atoms == 0))
    op = kNoDnf;
  else if (a.n_conj == 1 && a.n_atoms == 1)
    op = a.atom_op[0];
  int rc;
  switch (op) {
    case 0: rc = launch_select<0>(a, n_chunks, s); break;
    case 1: rc = launch_select<1>(a, n_chunks, s); break;
    case 2: rc = launch_select<2>(a, n_chunks, s); break;
    case 3: rc = launch_select<3>(a, n_chunks, s); break;
    case 4: rc = launch_select<4>(a, n_chunks, s); break;
    case 5: rc = launch_select<5>(a, n_chunks, s); break;
    case kNoDnf: rc = launch_select<kNoDnf>(a, n_chunks, s); break;
    default: rc = launch_select<kAnyDnf>(a, n_chunks, s);
  }
  if (rc != 0) return rc;
  switch (G) {
    case 1: rc = launch_masked<1>(m, n_chunks, s); break;
    case 2: rc = launch_masked<2>(m, n_chunks, s); break;
    case 3: rc = launch_masked<3>(m, n_chunks, s); break;
    case 4: rc = launch_masked<4>(m, n_chunks, s); break;
    case 5: rc = launch_masked<5>(m, n_chunks, s); break;
    case 6: rc = launch_masked<6>(m, n_chunks, s); break;
    case 7: rc = launch_masked<7>(m, n_chunks, s); break;
    default: rc = launch_masked<8>(m, n_chunks, s);
  }
  if (rc != 0) return rc;
  scan::launch_reduce(s, m.partial, out, n_chunks,
                      static_cast<long long>(m.Q) * scan::kStats * G);
  return 0;
}

}  // namespace

// Launches the scan on `stream`; returns cudaGetLastError() after it (0 =
// success), or -1 for arguments the kernels do not take. Data pointers are
// device pointers; col_ptrs (the atom rows, each f32[n]) ... conj_end are
// host arrays copied into the kernels' parameters. Up to 8 groups, bits is
// scratch of Q * n_chunks * 256 * ceil(rows_per_chunk / 8192) words (the
// Select layout; no zeroing needed); above, it is unused. partial is
// [n_chunks, Q, 7, G], out [Q, 7, G].
extern "C" int agg_scan_batched_launch(
    const void* values, int values_tag, const float* freq, const float* ek,
    const void* codes, int codes_tag,
    const unsigned long long* col_ptrs, const int* col_tags, int n_cols,
    const int* atom_slot, const int* atom_op, int n_atoms,
    const int* conj_end, int n_conj,
    const float* ks, const float* consts, int Q, int G, long long n,
    long long rows_per_chunk, int n_chunks, int gt, unsigned* bits,
    float* partial, float* out, void* stream) {
  BatchedRows p;
  if (!scan::fill_plan(p, Q, G, n, rows_per_chunk, n_chunks, gt, partial) ||
      !scan::fill_dnf(p, col_ptrs, col_tags, n_cols, atom_slot, atom_op,
                      n_atoms, conj_end, n_conj, consts) ||
      values_tag < scan::kF32 || values_tag > scan::kF16 ||
      codes_tag < scan::kI8 || codes_tag > scan::kU8)
    return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= kSelGroups) {
    if (!bits || rows_per_chunk % scan::kStep != 0) return -1;
    Select a;
    static_cast<scan::Dnf&>(a) = p;
    a.ek = ek;
    a.ks = ks;
    a.n = n; a.rows_per_chunk = rows_per_chunk;
    a.Q = Q;
    a.slots = static_cast<int>(rows_per_chunk / scan::kThreads);
    a.windows = (a.slots + 31) / 32;
    a.chunk_words = 32LL * scan::kWarps * a.windows;
    a.plane = n_chunks * a.chunk_words;
    a.bits = bits;
    Moments m;
    m.values = values; m.values_tag = values_tag;
    m.freq = freq;
    m.codes = codes; m.codes_tag = codes_tag;
    m.ks = ks;
    m.bits = bits;
    m.rows_per_chunk = rows_per_chunk;
    m.plane = a.plane; m.chunk_words = a.chunk_words;
    m.Q = Q; m.windows = a.windows;
    m.partial = partial;
    const int rc = select_then_add(a, m, G, n_chunks, out, s);
    return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
  }
  p.values = values; p.values_tag = values_tag;
  p.freq = freq;
  p.ek = ek;
  p.codes = codes; p.codes_tag = codes_tag;
  p.ks = ks;
  int rc = scan::launch_pass<BatchedRows, 0, true, false>(p, scan::Hist{},
                                                           n_chunks, s);
  if (rc == 0)
    scan::launch_reduce(s, partial, out, n_chunks,
                        static_cast<long long>(Q) * scan::kStats * G);
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
