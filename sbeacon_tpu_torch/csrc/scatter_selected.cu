// Fused match + genotype-plane kernel for Hopper (sm_90a).
//
// Replaces sbeacon_tpu/ops/scatter_kernel.py::_selected_batch (driven by
// run_selected_scattered): the XLA program that answers a selected-samples
// or sample-extraction query in one launch, the match of _scatter_core
// followed by the genotype-plane reductions of its matched rows.
//
// What it computes, per query slot q (semantics of _selected_batch):
//   - the window match and agg[q] of scatter_core.cuh (J1's code);
//   - the first R matched lanes in lane order (R = min(record_cap, the
//     tier's cap)): rows[q][k] = their global row ids, -1 past the
//     matches; each keeps its window-local record id seg (the inclusive
//     count of lanes without SAME_PREV, a record's rows sharing one);
//   - per matched row, under the query's mask[q][W]: pc_call = popc(gt)
//     (+ popc(gt2) with counts), pc_tok = popc(tok1) + popc(tok2) with
//     counts, else 0; both 0 past the matches (the JAX program writes row
//     0's popcounts there; no caller reads them);
//   - rc = (with counts and the row lacks AC_INFO) ? pc_call : ac, 0 past
//     the matches;
//   - or_sel[k] = matched & (base > 0 | fwd_any | bwd_any) from the same
//     forward and backward segmented scans over the R lanes as the JAX
//     program (c = cumsum rc, base = cummax of the cumsum before each
//     record's first lane; the mirror image from the end), all in int32
//     with wraparound. On non-negative rc it selects the rows of records
//     k0.. (k0 = the first record with a positive cumulative rc);
//   - or_words[q][w] = OR over the or_sel rows of gt[row][w] & mask[w].
//
// What bounds it on this card: latency. A point query (C = 1, B = 1, the
// most launched case) reads one 4 KB tile and a few plane rows of 316 B
// (x4 with counts); its bound is under a nanosecond of bytes, so its time
// is the launch plus a chain of dependent memory round trips and block
// barriers. The design keeps that chain short:
//   - one 128-thread block per query slot (match_window's width);
//   - the match pass (scatter_core.cuh, through a lane hook) loads each
//     lane's AN with its other columns and keeps AC, flags and AN of the
//     matched lanes in shared memory, so nothing is read from the tiles
//     again; in windows of more than one tile it also issues an L2
//     prefetch of the plane row lines of each matched lane among the
//     first R, so the plane rows' DRAM latency overlaps the AN pass and
//     the ballot compaction;
//   - the sample mask is copied to shared memory with cp.async, off the
//     match's critical path;
//   - the matched lanes are compacted in lane order by a ballot and a
//     block prefix; plane_reduce::row_popcounts then reads their plane
//     rows with every load of a warp's rows in flight before use (one
//     row a warp when the rows fit the block's four warps, as a point
//     query's do, else kRB), leaves the masked gt words of the first
//     rows that fit in a shared cache, and gives rc from the kept AC and
//     flags;
//   - plane_reduce::or_select runs the reference's four scans in log
//     depth over the valid lanes rounded up to a warp, by one warp in
//     shuffles when they fit it (the record id seg is the scans' record
//     id; padding lanes are never read), and plane_reduce::or_rows ORs
//     the or_sel rows from the cache.
// A point query's critical path: the query words and tile id, the tile
// columns (DRAM), the plane rows, the stores.

#include "plane_reduce.cuh"
#include "scatter_core.cuh"

namespace {

using namespace scatter;

constexpr int kWarps = kThreads / 32;
// bytes of shared memory the gt cache may take, and its most rows
constexpr int kCacheBytes = 32 * 1024;
constexpr int kCacheRowsMax = 32;

// Rows of the masked-gt cache at W words a row.
__host__ __device__ constexpr int cache_rows(int R, int W) {
  const int fit = kCacheBytes / (4 * W);
  const int r = fit < kCacheRowsMax ? fit : kCacheRowsMax;
  return r < R ? r : R;
}

__host__ __device__ constexpr long long align16(long long x) {
  return (x + 15) / 16 * 16;
}

// Dynamic shared memory of one block: the mask and the OR words (8 W),
// the gt cache, six int32 arrays over the R lanes (window lane, plane
// row, record id, rc, two scan buffers), AC, flags and AN of each window
// lane (12 C T), its match and SAME_PREV bytes (2 C T) and or_sel (R).
__host__ __device__ constexpr long long selected_smem(int T, int C, int R,
                                                      int W) {
  return align16(8LL * W + 4LL * cache_rows(R, W) * W + 24LL * R +
                 12LL * C * T) +
         2LL * C * T + R;
}

// match_window's lane hook: keeps AC, flags and AN of each matched lane
// and prefetches the plane rows of the matched lanes l < R (whose slot
// is then below R too).
template <bool kCounts>
struct KeepLanes {
  int32_t* s_ac;
  int32_t* s_flags;
  int32_t* s_an;
  const uint32_t* gt;
  const uint32_t* gt2;
  const uint32_t* tok1;
  const uint32_t* tok2;
  long long row0, n_plane;
  int R, W;
  bool prefetch;

  __device__ __forceinline__ void lane(int l, bool m, int f, int a,
                                       int n) const {
    if (!m) return;
    s_ac[l] = a;
    s_flags[l] = f;
    s_an[l] = n;
    if (prefetch && l < R) {
      long long g = row0 + l;
      g = g < 0 ? 0 : (g >= n_plane ? n_plane - 1 : g);
      const size_t off = static_cast<size_t>(g) * static_cast<size_t>(W);
      plane_reduce::prefetch_row(gt, off, W);
      if constexpr (kCounts) {
        plane_reduce::prefetch_row(gt2, off, W);
        plane_reduce::prefetch_row(tok1, off, W);
        plane_reduce::prefetch_row(tok2, off, W);
      }
    }
  }
  __device__ __forceinline__ int an(int l) const { return s_an[l]; }
};

template <bool kExactOnly, bool kCounts>
__global__ void __launch_bounds__(kThreads) scatter_selected_kernel(
    const int32_t* __restrict__ tiles, const uint32_t* __restrict__ gt,
    const uint32_t* __restrict__ gt2, const uint32_t* __restrict__ tok1,
    const uint32_t* __restrict__ tok2, const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ q8, const uint32_t* __restrict__ mask,
    int32_t* __restrict__ agg, int32_t* __restrict__ rows,
    int32_t* __restrict__ pc_call, int32_t* __restrict__ pc_tok,
    uint32_t* __restrict__ or_words, int n_tiles, int T, int C, int cap,
    int R, int W, long long n_plane, bool prefetch) {
  extern __shared__ int32_t smem[];
  const int span = C * T;
  const int n_cache = cache_rows(R, W);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem);  // [W]
  uint32_t* s_or = s_mask + W;                           // [W]
  uint32_t* s_cache = s_or + W;                          // [n_cache, W]
  int32_t* s_lane = reinterpret_cast<int32_t*>(
      s_cache + static_cast<size_t>(n_cache) * W);  // [R] window lane
  int32_t* s_row = s_lane + R;                      // [R] plane row
  int32_t* s_seg = s_row + R;                       // [R] record id
  int32_t* s_rc = s_seg + R;                        // [R]
  int32_t* s_a = s_rc + R;                          // [R] scan buffer
  int32_t* s_b = s_a + R;                           // [R] scan buffer
  int32_t* s_ac = s_b + R;                          // [span] per lane
  int32_t* s_flags = s_ac + span;                   // [span]
  int32_t* s_an = s_flags + span;                   // [span]
  uint8_t* s_match = reinterpret_cast<uint8_t*>(smem) +
                     align16(8LL * W + 4LL * n_cache * W + 24LL * R +
                             12LL * span);  // [span]
  uint8_t* s_same = s_match + span;         // [span]
  uint8_t* s_sel = s_same + span;           // [R]
  __shared__ int32_t s_warp[kWarps];
  __shared__ int s_wm[kWarps], s_ws[kWarps];

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile0 = tile_ids[q];
  // the mask is first read by the popcounts: its copy does not hold up
  // the match's loads
  plane_reduce::copy_words_async(s_mask, mask + static_cast<size_t>(q) * W,
                                 W);
  for (int w = tid; w < W; w += kThreads) s_or[w] = 0u;

  // 1. the window match and the aggregate row (J1's code), keeping the
  // matched lanes' AC, flags and AN and prefetching their plane rows
  KeepLanes<kCounts> keep{s_ac, s_flags, s_an, gt, gt2, tok1, tok2,
                          static_cast<long long>(tile0) * T, n_plane, R, W,
                          prefetch};
  match_window<kExactOnly>(tiles, q8 + static_cast<size_t>(q) * 8, tile0,
                           n_tiles, T, C, cap, s_match, s_same,
                           agg + static_cast<size_t>(q) * 8, keep);

  // 2. the first R matched lanes in lane order, with their record ids
  // (the chunks' barriers also publish the mask)
  plane_reduce::copy_wait();
  const unsigned lt = (1u << lane) - 1u;
  int n_m = 0, seg_run = 0;  // block-uniform running counts
  for (int base = 0; base < span; base += kThreads) {
    const int l = base + tid;
    const bool m = l < span && s_match[l];
    const bool ns = l < span && !s_same[l];
    const unsigned bm = __ballot_sync(0xffffffffu, m);
    const unsigned bs = __ballot_sync(0xffffffffu, ns);
    if (lane == 0) {
      s_wm[warp] = __popc(bm);
      s_ws[warp] = __popc(bs);
    }
    __syncthreads();
    int before_m = 0, tot_m = 0, before_s = 0, tot_s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before_m += w < warp ? s_wm[w] : 0;
      before_s += w < warp ? s_ws[w] : 0;
      tot_m += s_wm[w];
      tot_s += s_ws[w];
    }
    if (m) {
      const int slot = n_m + before_m + __popc(bm & lt);
      if (slot < R) {
        long long g = static_cast<long long>(tile0) * T + l;
        g = g < 0 ? 0 : (g >= n_plane ? n_plane - 1 : g);
        s_lane[slot] = l;
        s_row[slot] = static_cast<int32_t>(g);
        s_seg[slot] = seg_run + before_s + __popc(bs & (lt | (1u << lane)));
      }
    }
    n_m += tot_m;
    seg_run += tot_s;
    __syncthreads();  // s_wm / s_ws are rewritten by the next chunk
  }
  const int n_fill = min(n_m, R);

  // 3. masked popcounts of the matched rows (the first n_cache rows'
  // masked gt words kept), then rc from the kept AC and flags
  int32_t* rows_q = rows + static_cast<size_t>(q) * R;
  int32_t* pcc_q = pc_call + static_cast<size_t>(q) * R;
  int32_t* pct_q = pc_tok + static_cast<size_t>(q) * R;
  auto sink = [&](int k, uint32_t c, uint32_t t) {
    const int l = s_lane[k];
    const int call = static_cast<int32_t>(c);
    rows_q[k] = tile0 * T + l;
    pcc_q[k] = call;
    pct_q[k] = static_cast<int32_t>(t);
    s_rc[k] = (kCounts && !(s_flags[l] & F_AC_INFO)) ? call : s_ac[l];
  };
  if (n_fill <= kWarps) {  // a point query: one row a warp
    plane_reduce::row_popcounts<kThreads, kCounts, 1>(
        gt, gt2, tok1, tok2, s_row, n_fill, W, s_mask, s_cache, n_cache,
        sink);
  } else {
    plane_reduce::row_popcounts<kThreads, kCounts>(
        gt, gt2, tok1, tok2, s_row, n_fill, W, s_mask, s_cache, n_cache,
        sink);
  }
  for (int k = n_fill + tid; k < R; k += kThreads) {
    rows_q[k] = -1;
    pcc_q[k] = 0;
    pct_q[k] = 0;
  }

  // 4. or_sel from the forward and backward segmented scans, then the
  // list of its lanes (in s_b, free after the scans)
  plane_reduce::or_select<kThreads>(s_rc, s_seg, n_fill, R, s_a, s_b,
                                    s_sel, s_warp);
  const int n_list = plane_reduce::sel_list(s_sel, n_fill, s_b);

  // 5. the sample-hit OR over the or_sel rows, from the cache
  plane_reduce::or_rows<kThreads>(gt, s_row, s_b, n_list, W, s_mask,
                                  s_cache, n_cache, s_or);
  __syncthreads();
  uint32_t* or_q = or_words + static_cast<size_t>(q) * W;
  for (int w = tid; w < W; w += kThreads) or_q[w] = s_or[w];
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the kernel takes.
long long scatter_selected_smem(int T, int C, int R, int W) {
  return selected_smem(T, C, R, W);
}

// Launch one tier: n_slots blocks of 128 threads on `stream`. Every
// pointer is a device pointer to contiguous 32-bit data: tiles
// [n_tiles, 8, T], the planes gt/gt2/tok1/tok2 [n_plane, W] (without
// counts only gt is read), tile_ids [n_slots], q8 [n_slots, 8], mask
// [n_slots, W]; outputs agg [n_slots, 8], rows/pc_call/pc_tok
// [n_slots, R], or_words [n_slots, W]. The plane rows' L2 prefetch runs
// for windows of more than one tile (C > 1): a one-tile window's rows are
// read right after its match, and there the prefetch cost more than it
// hid on the H100. The caller guarantees T % 128 == 0 and
// 1 <= R <= C * T; shared memory above 48 KB is opted into. Returns
// cudaGetLastError() after the launch.
int scatter_selected_launch(const void* tiles, const void* gt,
                            const void* gt2, const void* tok1,
                            const void* tok2, const void* tile_ids,
                            const void* q8, const void* mask, void* agg,
                            void* rows, void* pc_call, void* pc_tok,
                            void* or_words, int n_slots, int n_tiles, int T,
                            int C, int cap, int exact_only, int R, int W,
                            long long n_plane, int with_counts, void* stream) {
  if (n_slots <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(selected_smem(T, C, R, W));
  auto kernel = exact_only
                    ? (with_counts ? &scatter_selected_kernel<true, true>
                                   : &scatter_selected_kernel<true, false>)
                    : (with_counts ? &scatter_selected_kernel<false, true>
                                   : &scatter_selected_kernel<false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(n_slots), scatter::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tiles), static_cast<const uint32_t*>(gt),
      static_cast<const uint32_t*>(gt2), static_cast<const uint32_t*>(tok1),
      static_cast<const uint32_t*>(tok2),
      static_cast<const int32_t*>(tile_ids), static_cast<const int32_t*>(q8),
      static_cast<const uint32_t*>(mask), static_cast<int32_t*>(agg),
      static_cast<int32_t*>(rows), static_cast<int32_t*>(pc_call),
      static_cast<int32_t*>(pc_tok), static_cast<uint32_t*>(or_words),
      n_tiles, T, C, cap, R, W, n_plane, C > 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
