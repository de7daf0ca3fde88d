// Shared pieces of the sample-scan kernels for Hopper (sm_90a): the launch
// plan, narrow-column reads, the DNF predicate, the row producers'
// contract, the scan pass (grouped moments and the quantile histogram) and
// the chunk reduction. Every kernel source includes it: the scan pass is
// one template over a row producer, so agg_scan.cu (precomputed rates),
// agg_scan_batched.cu (materialized freq and entry_key), agg_scan_fused.cu
// and quantile_scan.cu (HT state derived from the frequency table) all add
// their rows in one order and give the same bits for the same selected
// rows; weighted_sum.cu reuses the chunk reduction.
//
// It carries the moments pass of the TPU kernels `agg_scan_fused_pallas`,
// `quantile_scan_pallas`, `agg_scan_pallas` and `agg_scan_batched_pallas`
// (src/repro/kernels/agg_scan.py:411, :557, :128, :220), whose one-hot
// matmuls become predicated adds here.
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
// What bounds the pass on this card: device-memory bytes. A row is a few
// bytes of narrow columns and a dozen float operations, far below the
// card's ~20 float operations per byte at 3.35 TB/s. So the pass must keep
// enough loads in flight: each thread takes kRows rows per step, issues
// the prefix columns' loads of all of them (read-only, at the column's
// stored width) before it uses any, then, in warps that hold a prefix row,
// the value and atom loads together (prefix_rows), and computes the
// selection without branches.
//   register mode (group tile <= 8): each thread keeps its 7 x tile sums in
//     registers (tiles of 1 and 2) or in its own column of shared memory
//     (4 and 8, where 56 registers of sums would halve the blocks an SM
//     holds), adds its own rows in row order, and a fixed shuffle tree plus
//     a fixed tree over the warps adds the block's threads: no barrier in
//     the row loop;
//   shared mode (tile 9..1024 groups): warp w owns the groups whose code
//     is w mod 8. The step's selected rows are staged in shared memory in
//     eight buckets, one per owner, each in row order (a stable counting
//     sort: per-(owner, row, warp) counts, one block scan). Warp w walks
//     its bucket; lanes whose rows share a group are found with
//     __match_any_sync and the lowest of them adds their rows in lane
//     (= row) order, so each group's rows are added one after another, in
//     row order, by one thread: O(1) work per row, where the first kernel
//     made every thread test every staged row (256 tests per row per group
//     tile). One tile of up to 1024 groups covers every G of the main path
//     (one read of the chunk at G = 500, where 256-group tiles read it
//     twice).
// The quantile histogram (256 bins per group) rides the same pass. Beside
// register mode (G <= 8) each warp keeps its own histogram [G][256] in
// shared memory and adds its own rows: the lowest lane of each run of one
// (group, bin) key adds the run's weights w = 1/r in lane (= row) order,
// and the warps' histograms are added in warp order at the chunk's end;
// the row loop still has no block barrier. Beside shared mode the owner
// warp of a group also adds its rows' weights to the block's histogram
// tile, by the same match on the (group, bin) key. Every weight is added
// once, by one thread, in shared memory; no float atomics.
//
// Summation order (no float atomics anywhere): a block takes a contiguous
// chunk of rows, one query and one group tile; the sums above run in a
// fixed order within the chunk; partials go to scratch [n_chunks, ...]; the
// chunk reduction adds them with a fixed shape (chunk lane y adds chunks y,
// y + 32, ... in order, then a fixed tree over the 32 lanes). The chunking
// and the tile depend on the row count, the group count and the card only,
// never on how many queries share the launch, so query q of a Q-query
// launch has the bits of the same query launched alone, and repeat launches
// are bit-identical.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr int kThreads = 256;       // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;            // rows per thread per step
constexpr int kStep = kThreads * kRows;   // rows per block step
constexpr int kStats = 7;
constexpr int kMaxQ = 64;           // queries per launch (scratch grows with Q)
constexpr int kMaxAtoms = 127;
constexpr int kMaxConj = 128;
constexpr int kMaxStrata = 4096;
constexpr int kRegGroups = 8;       // register mode up to this group tile
constexpr int kColGroups = 4;       // ... its sums in shared columns from here
constexpr int kMaxTile = 1024;      // groups per tile in shared mode
constexpr int kBins = 256;          // quantile histogram bins per group
constexpr int kOnePassGroups = 32;  // quantile: histogram in the moments pass
constexpr int kHistTile = 64;       // groups per tile of a separate histogram
constexpr int kMaxShared = 232448;  // dynamic shared bytes a block may have
constexpr int kStaticShared = 48 * 1024;
static_assert(kRows * kWarps * kWarps == kThreads,
              "one bucket slot (owner, row of the thread, warp) a thread");

// Column dtype tags (kernels/agg_scan.py _VALUE_TAGS, _INT_TAGS).
enum : int { kF32 = 0, kI8 = 1, kI16 = 2, kI32 = 3, kU8 = 4, kF16 = 5 };

// The scan pass's launch plan (kernels/agg_scan.py launch_plan).
struct Plan {
  int Q, G;
  long long n, rows_per_chunk;
  int gt, n_gtiles;                         // group tile and tile count
  float* partial;                           // [n_chunks, Q, 7, G]
};

// The quantile histogram of a scan pass (Q = 1): bins over [lo, hi].
struct Hist {
  float lo, hi;
  float* partial;                           // [n_chunks, G, kBins]
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

// Reads of R rows of one column at its stored width; every load is issued
// before any is used.
template <int R>
__device__ __forceinline__ void load_f32(const void* p, int tag,
                                         const long long (&i)[R],
                                         float (&x)[R]) {
  switch (tag) {
    case kF32: {
      const float* a = static_cast<const float*>(p);
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = __ldg(a + i[j]);
      break;
    }
    case kI8: {
      const signed char* a = static_cast<const signed char*>(p);
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = static_cast<float>(__ldg(a + i[j]));
      break;
    }
    case kI16: {
      const short* a = static_cast<const short*>(p);
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = static_cast<float>(__ldg(a + i[j]));
      break;
    }
    case kI32: {
      const int* a = static_cast<const int*>(p);
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = static_cast<float>(__ldg(a + i[j]));
      break;
    }
    case kF16: {
      const __half* a = static_cast<const __half*>(p);
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = __half2float(__ldg(a + i[j]));
      break;
    }
    default: {
      const unsigned char* a = static_cast<const unsigned char*>(p);
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = static_cast<float>(__ldg(a + i[j]));
    }
  }
}

template <int R>
__device__ __forceinline__ void load_i32(const void* p, int tag,
                                         const long long (&i)[R],
                                         int (&x)[R]) {
  switch (tag) {
    case kI8: {
      const signed char* a = static_cast<const signed char*>(p);
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = __ldg(a + i[j]);
      break;
    }
    case kI16: {
      const short* a = static_cast<const short*>(p);
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = __ldg(a + i[j]);
      break;
    }
    case kI32: {
      const int* a = static_cast<const int*>(p);
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = __ldg(a + i[j]);
      break;
    }
    default: {
      const unsigned char* a = static_cast<const unsigned char*>(p);
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = __ldg(a + i[j]);
    }
  }
}

// m[j] &= (x[j] op c) for R rows.
template <int R>
__device__ __forceinline__ void compare(int op, const float (&x)[R], float c,
                                        bool (&m)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    bool t;
    switch (op) {
      case 0: t = x[j] == c; break;
      case 1: t = x[j] != c; break;
      case 2: t = x[j] < c; break;
      case 3: t = x[j] <= c; break;
      case 4: t = x[j] > c; break;
      default: t = x[j] >= c;
    }
    m[j] = m[j] & t;
  }
}

// DNF of the template for query q on R rows; no conjunctions = TRUE, an
// empty conjunction = TRUE (as the reference's eval_pred_flat). Every atom
// column is read for every row it is given (no short cut), R loads in
// flight per atom.
template <int R>
__device__ __forceinline__ void eval_dnf(const Dnf& d, int q,
                                         const long long (&i)[R],
                                         bool (&any)[R]) {
  if (d.n_conj == 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) any[j] = true;
    return;
  }
  const float* c = d.consts + static_cast<long long>(q) * d.n_atoms;
#pragma unroll
  for (int j = 0; j < R; ++j) any[j] = false;
  int a = 0;
  for (int cj = 0; cj < d.n_conj; ++cj) {
    const int end = d.conj_end[cj];
    bool m[R];
#pragma unroll
    for (int j = 0; j < R; ++j) m[j] = true;
    for (; a < end; ++a) {
      const int s = d.atom_slot[a];
      float x[R];
      load_f32<R>(d.cols[s], d.col_tag[s], i, x);
      compare<R>(d.atom_op[a], x, __ldg(c + a), m);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) any[j] = any[j] | m[j];
  }
}

// The value and the DNF of R rows for a warp one of whose lanes holds a
// row in query q's prefix (live); a warp with none skips both and gives
// m = false. A block is sorted by entry key, so past the prefix (most of
// it at a small K) whole warps skip the value and atom columns, and a
// template of tens of atoms reads them only for the prefix's warps. The
// vote is warp-uniform, so the loads of a live warp stay in flight
// together. Every lane of the warp calls it.
template <int R>
__device__ __forceinline__ void prefix_rows(const Dnf& d, int q,
                                            const long long (&i)[R],
                                            bool live, const void* values,
                                            int values_tag, float (&val)[R],
                                            bool (&m)[R]) {
  if (__any_sync(0xffffffffu, live)) {
    if (values) {
      load_f32<R>(values, values_tag, i, val);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) val[j] = 1.0f;
    }
    eval_dnf<R>(d, q, i, m);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      val[j] = 1.0f;
      m[j] = false;
    }
  }
}

// A row producer is a Plan with
//   int n_tab() const                  floats of shared table it needs
//   void load_shared(float* tab) const fills it (the block's threads)
//   template <int R> void rows(tab, q, i[R], code[R], val[R], rate[R])
// where rows() gives each row's group code, or -1 when the row is outside
// query q's selection, and its value and HT rate (any value for a row with
// code -1). The scan pass asks only for indices inside the block's chunk.

// The fused scan's producer (agg_scan_fused.cu, quantile_scan.cu).
struct Params : Plan, Dnf {
  const void* values; int values_tag;       // nullptr: every value is 1
  const float* unit;
  const void* strat; int strat_tag;
  const float* ftab; int n_strata;
  const uint8_t* valid;
  const void* codes; int codes_tag;         // nullptr: every row in group 0
  const float* ks;                          // [Q]

  __host__ __device__ int n_tab() const { return n_strata; }
  __device__ void load_shared(float* tab) const {
    for (int i = threadIdx.x; i < n_strata; i += kThreads) tab[i] = ftab[i];
  }
  template <int R>
  __device__ __forceinline__ void rows(const float* tab, int q,
                                       const long long (&i)[R], int (&code)[R],
                                       float (&val)[R], float (&rate)[R]) const {
    int c[R], st[R];
    float u[R], f[R];
    unsigned char ok[R];
    bool pre[R], m[R];
    if (codes) {
      load_i32<R>(codes, codes_tag, i, c);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) c[j] = 0;
    }
    load_i32<R>(strat, strat_tag, i, st);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      u[j] = __ldg(unit + i[j]);
      ok[j] = __ldg(valid + i[j]);
    }
    const float k = __ldg(ks + q);
    bool live = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      f[j] = tab[st[j]];
      pre[j] = (ok[j] != 0) & (u[j] * f[j] < k);
      live |= pre[j];
    }
    prefix_rows<R>(*this, q, i, live, values, values_tag, val, m);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      code[j] = (pre[j] & m[j]) ? c[j] : -1;
      rate[j] = fminf(1.0f, k / f[j]);
    }
  }
};

// Byte layout of the scan pass's dynamic shared memory, in floats: the
// producer's table, the shared-mode moments [7][gt], the register mode's
// per-thread sums for tiles of 4 and 8 [7][gt][256] (one column a thread)
// and its per-warp sums [8][7][gt], the histogram tile ([gt][256], or one per warp
// [8][gt][256] beside register-mode moments, with each warp's 32 lane
// weights) and the staged step (code, value, w, vfac, histogram key;
// kStep each; then the bucket slots' counts and offsets, kThreads each,
// and the 8 bucket sizes).
struct Layout {
  int tab, mom, cols, red, hist, lane, stage, floats;
};

__host__ __device__ inline Layout layout(int n_tab, int gt, bool mom,
                                         bool hist) {
  const bool reg = mom && gt <= kRegGroups;
  const bool priv = hist && reg;
  Layout l;
  int at = 0;
  l.tab = at;
  at += (n_tab + 3) & ~3;
  l.mom = at;
  if (mom && !reg) at += (kStats * gt + 3) & ~3;
  l.cols = at;
  if (reg && gt >= kColGroups && !hist) at += kStats * gt * kThreads;
  l.red = at;
  if (reg) at += kWarps * kStats * gt;
  l.hist = at;
  if (hist) at += (priv ? kWarps : 1) * gt * kBins;
  l.lane = at;
  if (priv) at += kWarps * 32;
  l.stage = at;
  if ((mom && !reg) || (hist && !priv)) at += 5 * kStep + 2 * kThreads + kWarps;
  l.floats = at;
  return l;
}

__device__ __forceinline__ int bin_of(float v, float lo, float span) {
  const float x = (v - lo) / span * static_cast<float>(kBins);
  return static_cast<int>(fminf(fmaxf(x, 0.0f),
                                static_cast<float>(kBins - 1)));
}

// The scan pass over any row producer P. Grid (Q * n_gtiles, n_chunks): x
// picks the query and the group tile, so the blocks that read one chunk run
// side by side and share it through L2. GT is the register-mode tile (1, 2,
// 4 or 8) or 0 for shared mode; kMom adds the moments, kHist the histogram
// of the tile's groups (Q = 1).
template <class P, int GT, bool kMom, bool kHist>
__global__ void __launch_bounds__(kThreads)
scan_partials(const __grid_constant__ P p, const __grid_constant__ Hist h) {
  constexpr bool kReg = kMom && GT > 0;
  constexpr bool kPriv = kHist && kReg;     // one histogram per warp
  // Register mode's per-thread sums of tiles of 4 and 8 groups live in the
  // thread's own shared-memory column (no bank conflicts): 7 adds per
  // selected row instead of 7 x GT predicated ones, and a third of the
  // registers, so more blocks fit an SM. Same order, same bits.
  constexpr bool kCols = kReg && GT >= kColGroups && !kHist;
  constexpr bool kStaged = (kMom && !kReg) || (kHist && !kPriv);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout(p.n_tab(), p.gt, kMom, kHist);
  float* s_tab = smem + L.tab;
  float* s_mom = smem + L.mom;
  float* s_red = smem + L.red;
  float* s_cols = smem + L.cols + threadIdx.x;  // [7][GT] stride kThreads
  float* s_hist = smem + L.hist;
  float* s_lane = smem + L.lane + 32 * (threadIdx.x >> 5);
  int* s_code = reinterpret_cast<int*>(smem + L.stage);
  float* s_val = smem + L.stage + kStep;
  float* s_w = s_val + kStep;
  float* s_vfac = s_w + kStep;
  int* s_key = reinterpret_cast<int*>(s_vfac + kStep);
  int* s_cnt = s_key + kStep;               // [kThreads] slot counts
  int* s_off = s_cnt + kThreads;            // [kThreads] slot offsets
  int* s_wsum = s_off + kThreads;           // [kWarps] bucket sizes

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = blockIdx.x / p.n_gtiles;
  const int g0 = (blockIdx.x % p.n_gtiles) * p.gt;
  const int g_hi = min(g0 + p.gt, p.G);
  const long long chunk = blockIdx.y;
  p.load_shared(s_tab);
  if (kMom && !kReg)
    for (int j = tid; j < kStats * p.gt; j += kThreads) s_mom[j] = 0.0f;
  if (kHist)
    for (int j = tid; j < (kPriv ? kWarps : 1) * p.gt * kBins; j += kThreads)
      s_hist[j] = 0.0f;
  if (kStaged) s_cnt[tid] = 0;
  constexpr int kAcc = (GT > 0 && !kCols) ? GT : 1;
  float acc[kStats][kAcc];
#pragma unroll
  for (int s = 0; s < kStats; ++s)
#pragma unroll
    for (int g = 0; g < kAcc; ++g) acc[s][g] = 0.0f;
  if (kCols)
    for (int j = 0; j < kStats * GT; ++j) s_cols[j * kThreads] = 0.0f;
  const float lo = h.lo;
  const float span = fmaxf(h.hi - h.lo, 1e-12f);
  const long long row0 = chunk * p.rows_per_chunk;
  const long long row_end = min(row0 + p.rows_per_chunk, p.n);
  const unsigned below = (1u << lane) - 1u;
  __syncthreads();

  for (long long base = row0; base < row_end; base += kStep) {
    long long idx[kRows];
    bool in[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long i = base + j * kThreads + tid;
      in[j] = i < row_end;
      idx[j] = in[j] ? i : row0;
    }
    int code[kRows];
    float val[kRows], rate[kRows];
    p.template rows<kRows>(s_tab, q, idx, code, val, rate);
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      code[j] = (in[j] & (code[j] >= g0) & (code[j] < g_hi)) ? code[j] : -1;

    if constexpr (kReg) {
      // Each thread adds its rows in row order.
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float r = rate[j], v = val[j];
        const float w = 1.0f / r;
        const float wx = w * v;
        const float vfac = (1.0f - r) / (r * r);
        const float vx = vfac * v;
        const int c = code[j] - g0;
        if constexpr (kCols) {
          if (c >= 0) {
            float* a = s_cols + c * kThreads;
            constexpr int kS = GT * kThreads;     // stride of one statistic
            a[0] += 1.0f;
            a[kS] += w;
            a[2 * kS] += wx;
            a[3 * kS] += wx * v;
            a[4 * kS] += vfac;
            a[5 * kS] += vx;
            a[6 * kS] += vx * v;
          }
        } else {
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            if (c == g) {
              acc[0][g] += 1.0f;
              acc[1][g] += w;
              acc[2][g] += wx;
              acc[3][g] += wx * v;
              acc[4][g] += vfac;
              acc[5][g] += vx;
              acc[6][g] += vx * v;
            }
          }
        }
      }
    }
    if constexpr (kPriv) {
      // Each warp adds its own rows to its own histogram: the lowest lane
      // of each run of one (group, bin) key adds the run's weights in lane
      // (= row) order.
      float* hw = s_hist + warp * p.gt * kBins;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int key = code[j] < 0
                            ? -1
                            : (code[j] - g0) * kBins + bin_of(val[j], lo, span);
        s_lane[lane] = 1.0f / rate[j];
        __syncwarp();
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key >= 0 && (peers & below) == 0) {
          float a = hw[key];
          for (unsigned rest = peers; rest; rest &= rest - 1u)
            a += s_lane[__ffs(rest) - 1];
          hw[key] = a;
        }
        __syncwarp();
      }
    }
    if constexpr (kStaged) {
      // Bucket the step's selected rows by owner warp (group code mod 8),
      // each bucket in row order: count each (owner, j, warp) slot, scan
      // the 256 slots in slot order (slot = thread), and stage each row at
      // its slot's offset plus its rank among its warp's lanes of that
      // owner. Bucket w is then the rows of the groups warp w owns.
      int own[kRows], rank[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        own[j] = code[j] >= 0 ? (code[j] & (kWarps - 1)) : kWarps;
        const unsigned peers = __match_any_sync(0xffffffffu, own[j]);
        rank[j] = __popc(peers & below);
        if (own[j] < kWarps && rank[j] == 0)
          s_cnt[(own[j] * kRows + j) * kWarps + warp] = __popc(peers);
      }
      __syncthreads();
      const int cnt = s_cnt[tid];
      s_cnt[tid] = 0;                       // zero for the next step
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) s_wsum[warp] = incl;  // bucket `warp`'s size
      __syncthreads();
      int start = 0;                        // bucket `warp`'s first slot
      for (int w = 0; w < warp; ++w) start += s_wsum[w];
      s_off[tid] = start + incl - cnt;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (own[j] < kWarps) {
          const int at = s_off[(own[j] * kRows + j) * kWarps + warp] + rank[j];
          const float r = rate[j];
          s_code[at] = code[j];
          s_val[at] = val[j];
          s_w[at] = 1.0f / r;
          if (kMom && !kReg) s_vfac[at] = (1.0f - r) / (r * r);
          if (kHist)
            s_key[at] = (code[j] - g0) * kBins + bin_of(val[j], lo, span);
        }
      }
      __syncthreads();
      // Warp w walks its bucket in row order; the lowest lane of each run
      // of one group (one (group, bin) key) adds the run's rows in lane
      // (= row) order. No barrier after: the next step's stage writes
      // follow its first barrier, which every warp reaches only when done.
      const int len = s_wsum[warp];
      for (int b0 = 0; b0 < len; b0 += 32) {
        const bool in_b = b0 + lane < len;
        const int at = start + b0;
        if (kMom && !kReg) {
          const int c = in_b ? s_code[at + lane] : -1;
          const unsigned peers = __match_any_sync(0xffffffffu, c);
          if (c >= 0 && (peers & below) == 0) {
            float* m = s_mom + (c - g0);
            float acc_g[kStats];
#pragma unroll
            for (int t = 0; t < kStats; ++t) acc_g[t] = m[t * p.gt];
            for (unsigned rest = peers; rest; rest &= rest - 1u) {
              const int r = at + __ffs(rest) - 1;
              const float v = s_val[r], w = s_w[r], vfac = s_vfac[r];
              const float wx = w * v, vx = vfac * v;
              acc_g[0] += 1.0f;
              acc_g[1] += w;
              acc_g[2] += wx;
              acc_g[3] += wx * v;
              acc_g[4] += vfac;
              acc_g[5] += vx;
              acc_g[6] += vx * v;
            }
#pragma unroll
            for (int t = 0; t < kStats; ++t) m[t * p.gt] = acc_g[t];
          }
        }
        if (kHist) {
          const int key = in_b ? s_key[at + lane] : -1;
          const unsigned peers = __match_any_sync(0xffffffffu, key);
          if (key >= 0 && (peers & below) == 0) {
            float a = s_hist[key];
            for (unsigned rest = peers; rest; rest &= rest - 1u)
              a += s_w[at + __ffs(rest) - 1];
            s_hist[key] = a;
          }
        }
      }
    }
  }
  __syncthreads();

  const int width = g_hi - g0;
  if constexpr (kReg) {
    // Fixed shuffle tree over each warp's lanes, then a fixed tree over
    // the warps.
#pragma unroll
    for (int s = 0; s < kStats; ++s) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float x;
        if constexpr (kCols) {
          x = s_cols[(s * GT + g) * kThreads];
        } else {
          x = acc[s][g];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lane == 0) s_red[(warp * kStats + s) * GT + g] = x;
      }
    }
    __syncthreads();
    if (tid < kStats * GT) {
      const int s = tid / GT, g = tid % GT;
      float v[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v[w] = s_red[(w * kStats + s) * GT + g];
#pragma unroll
      for (int half = kWarps / 2; half > 0; half >>= 1)
#pragma unroll
        for (int w = 0; w < half; ++w) v[w] += v[w + half];
      if (g < width)
        p.partial[((chunk * p.Q + q) * kStats + s) * p.G + g0 + g] = v[0];
    }
  }
  if constexpr (kPriv) {
    // The warps' histograms, added in warp order (the barrier above has
    // seen every warp leave the row loop).
    float* out = h.partial + (chunk * p.G + g0) * kBins;
    for (int j = tid; j < width * kBins; j += kThreads) {
      float a = s_hist[j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) a += s_hist[w * p.gt * kBins + j];
      out[j] = a;
    }
  }
  if constexpr (kMom && !kReg) {
    for (int j = tid; j < kStats * width; j += kThreads) {
      const int s = j / width, g = j % width;
      p.partial[((chunk * p.Q + q) * kStats + s) * p.G + g0 + g] =
          s_mom[s * p.gt + g];
    }
  }
  if constexpr (kHist && !kPriv) {
    float* out = h.partial + (chunk * p.G + g0) * kBins;
    for (int j = tid; j < width * kBins; j += kThreads) out[j] = s_hist[j];
  }
}

// The chunk reduction, over one or two (partial [n_chunks, per_chunk],
// out [per_chunk]) segments: out[j] = Σ_c partial[c, j]. Block (32, 32):
// x picks one of 32 consecutive outputs, y a chunk lane; lane y adds
// chunks y, y + 32, ... in order, then a fixed tree adds the 32 lanes.
struct Reduce {
  const float* partial[2];
  float* out[2];
  int n_chunks[2];
  long long per_chunk[2];
  unsigned blocks0;                         // blocks of segment 0
};

__global__ void __launch_bounds__(1024)
reduce_chunks(const __grid_constant__ Reduce r) {
  __shared__ float s_sum[32][33];
  const int seg = blockIdx.x < r.blocks0 ? 0 : 1;
  const long long b = blockIdx.x - (seg ? r.blocks0 : 0u);
  const long long per = r.per_chunk[seg];
  const long long j = b * 32 + threadIdx.x;
  const float* part = r.partial[seg];
  float acc = 0.0f;
  if (j < per) {
#pragma unroll 4
    for (int c = threadIdx.y; c < r.n_chunks[seg]; c += 32)
      acc += part[c * per + j];
  }
  s_sum[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  for (int stride = 16; stride > 0; stride >>= 1) {
    if (threadIdx.y < stride)
      s_sum[threadIdx.y][threadIdx.x] += s_sum[threadIdx.y + stride][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && j < per) r.out[seg][j] = s_sum[0][threadIdx.x];
}

// Enqueues the chunk reduction of one segment, or two when partial1 is set.
inline void launch_reduce(cudaStream_t s, const float* partial0, float* out0,
                          int chunks0, long long per0,
                          const float* partial1 = nullptr,
                          float* out1 = nullptr, int chunks1 = 0,
                          long long per1 = 0) {
  Reduce r;
  r.partial[0] = partial0; r.out[0] = out0;
  r.n_chunks[0] = chunks0; r.per_chunk[0] = per0;
  r.partial[1] = partial1; r.out[1] = out1;
  r.n_chunks[1] = chunks1; r.per_chunk[1] = partial1 ? per1 : 0;
  r.blocks0 = static_cast<unsigned>((per0 + 31) / 32);
  const unsigned blocks1 = static_cast<unsigned>((r.per_chunk[1] + 31) / 32);
  reduce_chunks<<<r.blocks0 + blocks1, dim3(32, 32), 0, s>>>(r);
}

// Fills the plan; false for a plan the scan pass does not take.
inline bool fill_plan(Plan& p, int Q, int G, long long n,
                      long long rows_per_chunk, int n_chunks, int gt,
                      float* partial) {
  if (Q < 1 || Q > kMaxQ || G < 1 || gt < 1 || gt > kMaxTile ||
      (gt <= kRegGroups && (gt & (gt - 1)) != 0) || n_chunks < 1 ||
      n_chunks > 65535 || rows_per_chunk < 1 || n < 0)
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

// Enqueues one scan pass of kernel mode (GT, kMom, kHist) on grid
// (Q * n_gtiles, n_chunks); returns a CUDA error, 0 on success.
template <class P, int GT, bool kMom, bool kHist>
inline int launch_pass(const P& p, const Hist& h, int n_chunks,
                       cudaStream_t s) {
  const Layout L = layout(p.n_tab(), p.gt, kMom, kHist);
  const int bytes = L.floats * static_cast<int>(sizeof(float));
  if (bytes > kMaxShared) return -1;
  auto kernel = scan_partials<P, GT, kMom, kHist>;
  if (bytes > kStaticShared) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(p.Q) * p.n_gtiles, n_chunks);
  kernel<<<grid, kThreads, bytes, s>>>(p, h);
  return 0;
}

// The moments pass (with the histogram when kHist): register mode for a
// group tile of 1, 2, 4 or 8, shared mode above.
template <class P, bool kHist>
inline int launch_moments_pass(const P& p, const Hist& h, int n_chunks,
                               cudaStream_t s) {
  switch (p.gt) {
    case 1: return launch_pass<P, 1, true, kHist>(p, h, n_chunks, s);
    case 2: return launch_pass<P, 2, true, kHist>(p, h, n_chunks, s);
    case 4: return launch_pass<P, 4, true, kHist>(p, h, n_chunks, s);
    case 8: return launch_pass<P, 8, true, kHist>(p, h, n_chunks, s);
    default: return launch_pass<P, 0, true, kHist>(p, h, n_chunks, s);
  }
}

// Enqueues the moments pass and its chunk reduction for producer p on
// stream s; returns a CUDA error, -1 for a plan it does not take, 0 on
// success.
template <class P>
inline int launch_moments(const P& p, int n_chunks, float* out,
                          cudaStream_t s) {
  const int rc = launch_moments_pass<P, false>(p, Hist{}, n_chunks, s);
  if (rc != 0) return rc;
  launch_reduce(s, p.partial, out, n_chunks,
                static_cast<long long>(p.Q) * kStats * p.G);
  return 0;
}

}  // namespace scan
