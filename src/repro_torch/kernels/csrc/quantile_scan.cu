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
// times the [rows, groups] one-hot on the MXU.
//
// What bounds it on this card: device-memory bytes, as the fused scan's,
// plus the 256 x G x 4 B histogram written. The histogram adds one weight
// per selected row; the first kernel spent 256 thread-steps on each (every
// thread walked every selected row and kept its own bin's), read the block
// a second time and made four launches.
//
// The design: one pass over the block, O(1) work per selected row. Up to
// G = 32 (scan::kOnePassGroups) the histogram rides the moments pass
// itself (scan_common.cuh), lanes that share a (group, bin) key found with
// __match_any_sync and their weights added by the lowest of them in row
// order. Up to G = 8, beside the register-mode moments, each warp adds its
// own rows to its own histogram [G][256] (8 x 8 KB at most) and the warps'
// histograms are added in warp order at the chunk's end, with no block
// barrier in the row loop. From 9 to 32 groups the step is staged in
// shared memory for the moments anyway, and warp w adds the staged rows
// whose key is w mod 8 to the block's one histogram tile (up to 32 KB).
// No float atomics, so repeat launches give the same bits. The moments
// come from the same pass and the same code as agg_scan_fused's at Q = 1,
// with the same chunk plan (kernels/agg_scan.py launch_plan), so their bits
// equal its. One chunk reduction adds both partials: two launches per call.
// The histogram's scratch is the moments' chunk count x G KB (34.6 MB at
// G = 32 on 132 SMs), which is what caps the one-pass path at G = 32.
//
// Above G = 32 the moments pass runs alone and the histogram takes a second
// pass over the block with its own chunk plan (kernels/agg_scan.py
// hist_plan, scratch capped at 64 MiB) and tiles of 64 groups (64 KB of
// shared memory); each tile's blocks stage every row of their chunk once
// and add the tile's rows as above. Three launches per call.
//
// Occupancy traded for the shared histograms: with a 4096-entry table a
// one-pass block takes up to 83 KB (the eight warp histograms at G = 5..8;
// registers already hold that variant to two blocks per SM) or 70 KB at
// G = 32 (three per SM); the separate histogram pass 100 KB (two per SM).
//
// Build as agg_scan_fused.cu: -fmad=false and no fast math, so the bin
// index is computed with the reference's correctly rounded float32 ops.

#include "scan_common.cuh"

namespace {

// Fills producer P (the frequency table in shared memory, or read through
// L2) and enqueues the passes and the chunk reduction.
template <class P>
int launch_quantile(
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
    float* hist_partial, float* hist_out, cudaStream_t s) {
  P p;
  const bool one_pass = G <= scan::kOnePassGroups;
  if (!scan::fill_params(p, values, values_tag, unit, strat, strat_tag,
                         ftab, n_strata, valid, codes, codes_tag, col_ptrs,
                         col_tags, n_cols, atom_slot, atom_op, n_atoms,
                         conj_end, n_conj, k, consts, 1, G, n, rows_per_chunk,
                         n_chunks, gt, partial) ||
      hist_chunks < 1 || hist_chunks > 65535 || hist_rows_per_chunk < 1 ||
      (one_pass && (p.n_gtiles != 1 || hist_chunks != n_chunks ||
                    hist_rows_per_chunk != rows_per_chunk)))
    return -1;
  const scan::Hist h{lo, hi, hist_partial};
  int rc;
  if (one_pass) {
    rc = scan::launch_moments_pass<P, true>(p, h, n_chunks, s);
  } else {
    rc = scan::launch_moments_pass<P, false>(p, scan::Hist{}, n_chunks, s);
    P hp = p;
    hp.rows_per_chunk = hist_rows_per_chunk;
    hp.gt = scan::kHistTile;
    hp.n_gtiles = (G + scan::kHistTile - 1) / scan::kHistTile;
    if (rc == 0)
      rc = scan::launch_pass<P, 0, false, true>(hp, h, hist_chunks, s);
  }
  if (rc != 0) return rc;
  scan::launch_reduce(s, partial, out, n_chunks,
                      static_cast<long long>(scan::kStats) * G, hist_partial,
                      hist_out, hist_chunks,
                      static_cast<long long>(G) * scan::kBins);
  return 0;
}

}  // namespace

// Launches the scan on `stream`: G <= 32 one pass (moments and histogram)
// with the moments' chunk plan, which hist_rows_per_chunk/hist_chunks must
// repeat; above, the moments pass and a histogram pass with its own plan.
// Then one chunk reduction of both. Returns cudaGetLastError() after them
// (0 = success), or -1 for arguments the kernel does not take. Pointer
// conventions as agg_scan_fused_launch; k and consts hold one query ([1],
// [1, n_atoms]). Up to scan::kMaxStrata strata the table is staged in
// shared memory, above it is read through L2.
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
  auto launch = n_strata > scan::kMaxStrata
                    ? launch_quantile<scan::ParamsL2>
                    : launch_quantile<scan::Params>;
  const int rc = launch(
      values, values_tag, unit, strat, strat_tag, ftab, n_strata, valid,
      codes, codes_tag, col_ptrs, col_tags, n_cols, atom_slot, atom_op,
      n_atoms, conj_end, n_conj, k, consts, G, n, rows_per_chunk, n_chunks,
      gt, partial, out, lo, hi, hist_rows_per_chunk, hist_chunks,
      hist_partial, hist_out, static_cast<cudaStream_t>(stream));
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
