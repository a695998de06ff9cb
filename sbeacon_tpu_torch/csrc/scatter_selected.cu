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
// What bounds it on this card: bytes. Besides J1's window (C * 4 KB of
// tiles), a matched row reads W words of each plane it needs (316 B at
// 2504 samples, x4 with counts) from planes of GBs, far above the 50 MB
// L2. Design: one 128-thread block per query slot, as J1. The matched
// lanes are stream-compacted in lane order by a ballot and a block
// prefix (bisect_query.cu's way); the mask sits in shared memory; each
// matched row is read by one warp whose lanes stride its W words
// (coalesced), __popc and a warp shuffle sum give the popcounts. The four
// scans run over the R lanes in shared memory (a thread per contiguous
// chunk, then the chunk totals). A second warp-per-row pass re-reads the
// or_sel rows' gt (mostly from L2, just read) into a shared OR
// accumulator. Making it fast (more warps per query, several queries per
// block at B = 1) is later work.

#include "scatter_core.cuh"

namespace {

using namespace scatter;

constexpr int kWarps = kThreads / 32;

template <bool kMax>
__device__ __forceinline__ int32_t combine(int32_t a, int32_t b) {
  if (kMax) return a > b ? a : b;
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// a - b in int32 with wraparound
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// Inclusive scan of a[0..n) in shared memory, in place, by the block:
// a running int32 sum with wraparound (kMax false) or a running signed
// max, from the front (kReverse false) or from the back. Each thread
// scans a contiguous chunk, then adds the combined totals of the chunks
// before it. Starts and ends with the block synchronised.
template <bool kMax, bool kReverse>
__device__ void block_scan(int32_t* a, int n, int32_t* s_tot) {
  const int tid = threadIdx.x;
  const int32_t ident = kMax ? INT32_MIN : 0;
  const int per = (n + kThreads - 1) / kThreads;
  const int b = min(tid * per, n);
  const int e = min(b + per, n);
  auto at = [n](int i) { return kReverse ? n - 1 - i : i; };
  __syncthreads();
  int32_t acc = ident;
  for (int i = b; i < e; ++i) {
    acc = combine<kMax>(acc, a[at(i)]);
    a[at(i)] = acc;
  }
  s_tot[tid] = acc;
  __syncthreads();
  int32_t pre = ident;
  for (int j = 0; j < tid; ++j) pre = combine<kMax>(pre, s_tot[j]);
  for (int i = b; i < e; ++i) a[at(i)] = combine<kMax>(pre, a[at(i)]);
  __syncthreads();
}

__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <bool kExactOnly>
__global__ void __launch_bounds__(kThreads) scatter_selected_kernel(
    const int32_t* __restrict__ tiles, const uint32_t* __restrict__ gt,
    const uint32_t* __restrict__ gt2, const uint32_t* __restrict__ tok1,
    const uint32_t* __restrict__ tok2, const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ q8, const uint32_t* __restrict__ mask,
    int32_t* __restrict__ agg, int32_t* __restrict__ rows,
    int32_t* __restrict__ pc_call, int32_t* __restrict__ pc_tok,
    uint32_t* __restrict__ or_words, int n_tiles, int T, int C, int cap,
    int R, int W, long long n_plane, bool with_counts) {
  extern __shared__ int32_t smem[];
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem);  // [W]
  uint32_t* s_or = s_mask + W;                           // [W]
  int32_t* s_lane = smem + 2 * W;                        // [R] window lane
  int32_t* s_seg = s_lane + R;                           // [R] record id
  int32_t* s_rc = s_seg + R;                             // [R]
  int32_t* s_a = s_rc + R;                               // [R] scan buffer
  int32_t* s_b = s_a + R;                                // [R] scan buffer
  const int span = C * T;
  uint8_t* s_match = reinterpret_cast<uint8_t*>(s_b + R);  // [span]
  uint8_t* s_same = s_match + span;                         // [span]
  uint8_t* s_sel = s_same + span;                           // [R] or_sel
  __shared__ int32_t s_tot[kThreads];
  __shared__ int s_wm[kWarps], s_ws[kWarps];

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile0 = tile_ids[q];
  for (int w = tid; w < W; w += kThreads) {
    s_mask[w] = mask[static_cast<size_t>(q) * W + w];
    s_or[w] = 0u;
  }

  // 1. the window match and the aggregate row (J1's code)
  match_window<kExactOnly>(tiles, q8 + static_cast<size_t>(q) * 8, tile0,
                           n_tiles, T, C, cap, s_match, s_same,
                           agg + static_cast<size_t>(q) * 8);

  // 2. the first R matched lanes in lane order, with their record ids
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
        s_lane[slot] = l;
        s_seg[slot] = seg_run + before_s + __popc(bs & (lt | (1u << lane)));
      }
    }
    n_m += tot_m;
    seg_run += tot_s;
    __syncthreads();  // s_wm / s_ws are rewritten by the next chunk
  }
  const int n_fill = min(n_m, R);
  for (int k = n_fill + tid; k < R; k += kThreads) {
    s_lane[k] = -1;
    s_seg[k] = -2;
  }

  // 3. per matched row, one warp: masked popcounts, then rc
  int32_t* rows_q = rows + static_cast<size_t>(q) * R;
  int32_t* pcc_q = pc_call + static_cast<size_t>(q) * R;
  int32_t* pct_q = pc_tok + static_cast<size_t>(q) * R;
  auto plane_row = [&](int k) {
    long long g = static_cast<long long>(tile0) * T + s_lane[k];
    g = g < 0 ? 0 : (g >= n_plane ? n_plane - 1 : g);
    return static_cast<size_t>(g) * W;
  };
  for (int k = warp; k < n_fill; k += kWarps) {
    const size_t off = plane_row(k);
    int p_gt = 0, p_gt2 = 0, p_t1 = 0, p_t2 = 0;
    for (int w = lane; w < W; w += 32) {
      const uint32_t m = s_mask[w];
      p_gt += __popc(gt[off + w] & m);
      if (with_counts) {
        p_gt2 += __popc(gt2[off + w] & m);
        p_t1 += __popc(tok1[off + w] & m);
        p_t2 += __popc(tok2[off + w] & m);
      }
    }
    p_gt = warp_sum_i(p_gt);
    p_gt2 = warp_sum_i(p_gt2);
    p_t1 = warp_sum_i(p_t1);
    p_t2 = warp_sum_i(p_t2);
    if (lane == 0) {
      const int l = s_lane[k];
      const int call = with_counts ? p_gt + p_gt2 : p_gt;
      const int ac = window_at(tiles, tile0, n_tiles, T, P_AC, l);
      const int flags = window_at(tiles, tile0, n_tiles, T, P_FLAGS, l);
      rows_q[k] = tile0 * T + l;
      pcc_q[k] = call;
      pct_q[k] = with_counts ? p_t1 + p_t2 : 0;
      s_rc[k] = (with_counts && !(flags & F_AC_INFO)) ? call : ac;
    }
  }
  for (int k = n_fill + tid; k < R; k += kThreads) {
    rows_q[k] = -1;
    pcc_q[k] = 0;
    pct_q[k] = 0;
    s_rc[k] = 0;
  }
  __syncthreads();

  // 4. or_sel from the forward and backward segmented scans
  for (int k = tid; k < R; k += kThreads) s_a[k] = s_rc[k];
  block_scan<false, false>(s_a, R, s_tot);  // s_a = c
  for (int k = tid; k < R; k += kThreads) {
    const bool first = k < n_fill && (k == 0 || s_seg[k] != s_seg[k - 1]);
    s_b[k] = first ? sub32(s_a[k], s_rc[k]) : -1;
  }
  block_scan<true, false>(s_b, R, s_tot);  // s_b = base
  for (int k = tid; k < R; k += kThreads) {
    const int32_t fwd = sub32(s_a[k], s_b[k]);
    s_sel[k] = (s_b[k] > 0 || fwd > 0) ? 1 : 0;
    s_a[k] = s_rc[k];
  }
  block_scan<false, true>(s_a, R, s_tot);  // s_a = sum of rc from k on
  for (int k = tid; k < R; k += kThreads) {
    const bool last =
        k < n_fill && (k == R - 1 || s_seg[k] != s_seg[k + 1]);
    s_b[k] = last ? sub32(s_a[k], s_rc[k]) : -1;
  }
  block_scan<true, true>(s_b, R, s_tot);  // s_b = base from the back
  for (int k = tid; k < R; k += kThreads) {
    const int32_t bwd = sub32(s_a[k], s_b[k]);
    s_sel[k] = (k < n_fill && (s_sel[k] || bwd > 0)) ? 1 : 0;
  }
  __syncthreads();

  // 5. the sample-hit OR over the or_sel rows, one warp per row
  for (int k = warp; k < n_fill; k += kWarps) {
    if (!s_sel[k]) continue;
    const size_t off = plane_row(k);
    for (int w = lane; w < W; w += 32) {
      const uint32_t g = gt[off + w];
      if (g) atomicOr(&s_or[w], g);
    }
  }
  __syncthreads();
  uint32_t* or_q = or_words + static_cast<size_t>(q) * W;
  for (int w = tid; w < W; w += kThreads) or_q[w] = s_or[w] & s_mask[w];
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the kernel takes: the mask and the
// OR words (8 W), five int32 arrays over the R lanes (20 R), the match
// and SAME_PREV bytes of the window (2 C T) and or_sel (R).
long long scatter_selected_smem(int T, int C, int R, int W) {
  return 8LL * W + 21LL * R + 2LL * C * T;
}

// Launch one tier: n_slots blocks of 128 threads on `stream`. Every
// pointer is a device pointer to contiguous 32-bit data: tiles
// [n_tiles, 8, T], the planes gt/gt2/tok1/tok2 [n_plane, W] (gt for all
// four without counts), tile_ids [n_slots], q8 [n_slots, 8], mask
// [n_slots, W]; outputs agg [n_slots, 8], rows/pc_call/pc_tok
// [n_slots, R], or_words [n_slots, W]. The caller guarantees T % 128 == 0
// and 1 <= R <= C * T; shared memory above 48 KB is opted into. Returns
// cudaGetLastError() after the launch.
int scatter_selected_launch(const void* tiles, const void* gt,
                            const void* gt2, const void* tok1,
                            const void* tok2, const void* tile_ids,
                            const void* q8, const void* mask, void* agg,
                            void* rows, void* pc_call, void* pc_tok,
                            void* or_words, int n_slots, int n_tiles, int T,
                            int C, int cap, int exact_only, int R, int W,
                            long long n_plane, int with_counts,
                            void* stream) {
  if (n_slots <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(scatter_selected_smem(T, C, R, W));
  auto kernel = exact_only ? &scatter_selected_kernel<true>
                           : &scatter_selected_kernel<false>;
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
      n_tiles, T, C, cap, R, W, n_plane, with_counts != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
