// The masked-plane reduction (sm_90a): block-level routines for the
// kernels that match rows and then read their genotype planes,
// stacked_selected.cu (J7, one block per (query, dataset): reduce()),
// the owner-sliced fused query mesh_fused.cu (J6, a cluster per query
// slot) and the fused match + planes kernel scatter_selected.cu (J2),
// both built from the pieces below.
//
// Replaces sbeacon_tpu/parallel/mesh.py::_plane_reduce (mesh.py:347).
// What it computes, for one query over R lanes whose first n_valid hold
// matched rows (sorted, the rest padding), under the query's sample mask:
//   - with counts: pc_call = popc(gt & m) + popc(gt2 & m), pc_tok =
//     popc(tok1 & m) + popc(tok2 & m); rc = pc_call where the row lacks
//     AC_INFO (and use_counts), else its AC; an_eff = pc_tok where the row
//     lacks AN_INFO (and use_counts), else its AN. Without counts pc_call
//     = pc_tok = 0, rc = AC, an_eff = AN. Padding lanes: rc = pc_* = 0;
//   - call_count = sum of rc; all_alleles = sum of an_eff over each
//     record's first lane (padding lanes take record id -2, so no segment
//     crosses the valid/padding edge);
//   - or_sel from the forward and the flipped backward segmented scans:
//     c = cumsum rc, base = cummax of the cumsum before each record's
//     first lane (-1 elsewhere), fwd = c - base > 0; the mirror image from
//     the end gives bwd; or_sel = valid & (base > 0 | fwd | bwd), the
//     rows of the records from the first one with a positive cumulative
//     rc on (materialize_response's grp >= k0), all int32 with wraparound;
//   - or_words[w] = OR over the or_sel lanes of gt[row][w] & m[w].
//
// What bounds it: the latency of the matched rows' plane reads (W words a
// row, from planes of GBs far above the 50 MB L2), then the scans'
// dependent steps. Design:
//   - row_popcounts / or_rows: each warp takes kRB rows at a time (one,
//     for a caller whose rows fit its warps) and issues every load of kU
//     32-word chunks of all of them (clamped addresses, no branches)
//     before it uses any, so a lane has up to kRB * kU * 4 plane loads in
//     flight; __popc and a shuffle sum give a row's popcounts, a shared
//     atomicOr per lane and chunk the OR;
//   - the scans cover only the valid lanes rounded up to a warp (padding
//     lanes add rc 0 and are no record edge, so the valid lanes' values
//     are those of the R-lane scans): each thread scans a contiguous chunk
//     of at most ceil(R / kThreads) lanes, a warp-shuffle scan combines
//     the threads' totals within each warp and warp 0 the warps' totals,
//     in log depth, or (at most 32 valid lanes) one warp scans them in
//     shuffles with no block barrier; the four scans of the reference are
//     kept as they are;
//   - copy_words_async brings a mask to shared memory by cp.async, and
//     prefetch_row a plane row into L2, so neither holds up the caller.
// J6 spreads one query's rows over a cluster of blocks (mesh_fused.cu);
// J7 runs reduce() in one block per (query, dataset); J2 calls the
// pieces from its own block (scatter_selected.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace plane_reduce {

constexpr int F_AC_INFO = 512;
constexpr int F_AN_INFO = 1024;
// rows a warp reads at once, and the 32-word chunks of each it loads
// before it uses any
constexpr int kRB = 4;
constexpr int kU = 4;

// a - b and a + b in int32 with wraparound
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// Prefetch into L2 the 128-byte lines of words [off, off + W) of plane
// p: issued where a row's match is known, so its DRAM latency overlaps
// the work before row_popcounts reads it.
__device__ __forceinline__ void prefetch_row(const uint32_t* p, size_t off,
                                             int W) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(p + off) & ~uintptr_t(127);
  const uintptr_t e = reinterpret_cast<uintptr_t>(p + off + W);
  for (uintptr_t a = b; a < e; a += 128) {
    asm volatile("prefetch.L2 [%0];" ::"l"(a));
  }
}

// dst[0..n) = src[0..n) (dst in shared memory) by the block's threads,
// without waiting: each thread issues its words' cp.async copies and
// returns, so the copy's global round trip overlaps what follows. The
// words are there for the issuing thread after copy_wait(), for the
// block after a barrier that follows it.
__device__ __forceinline__ void copy_words_async(uint32_t* dst,
                                                 const uint32_t* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(__cvta_generic_to_global(src + i))
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ uint32_t warp_sum_u(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Inclusive scan of a[0..n) in shared memory, in place, by a block of
// kThreads: a running int32 sum with wraparound (kMax false) or a running
// signed max, from the front (kReverse false) or from the back. Each
// thread scans a contiguous chunk; the chunks' totals are combined by
// warp shuffles in log depth. Starts and ends with the block
// synchronised. `s_warp` holds kThreads / 32 words.
template <int kThreads, bool kMax, bool kReverse>
__device__ void block_scan(int32_t* a, int n, int32_t* s_warp) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int32_t ident = kMax ? INT32_MIN : 0;
  auto combine = [](int32_t x, int32_t y) {
    return kMax ? (x > y ? x : y) : add32(x, y);
  };
  const int per = (n + kThreads - 1) / kThreads;
  const int b = min(tid * per, n);
  const int e = min(b + per, n);
  auto at = [n](int i) { return kReverse ? n - 1 - i : i; };
  __syncthreads();
  int32_t acc = ident;
  for (int i = b; i < e; ++i) {
    acc = combine(acc, a[at(i)]);
    a[at(i)] = acc;
  }
  // the chunks before this thread's, within its warp
  int32_t x = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = combine(y, x);
  }
  int32_t pre = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) pre = ident;
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  // the warps before this thread's
  if (warp == 0) {
    int32_t t = lane < kWarps ? s_warp[lane] : ident;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t = combine(y, t);
    }
    int32_t ex = __shfl_up_sync(0xffffffffu, t, 1);
    if (lane == 0) ex = ident;
    if (lane < kWarps) s_warp[lane] = ex;
  }
  __syncthreads();
  pre = combine(s_warp[warp], pre);
  for (int i = b; i < e; ++i) a[at(i)] = combine(pre, a[at(i)]);
  __syncthreads();
}

// or_select's four scans for n_valid <= 32 by one warp, lane k holding
// lane k, in warp shuffles with no block barrier: the warp's lanes past
// n_valid add rc 0 and base -1, as the padding lanes of the block form
// do, so the valid lanes' values are the same. Writes sel[0..n_valid).
__device__ __forceinline__ void warp_or_select(const int32_t* s_rc,
                                               const int32_t* s_rec,
                                               int n_valid, uint8_t* sel) {
  constexpr unsigned kAll = 0xffffffffu;
  const int k = threadIdx.x & 31;
  const bool valid = k < n_valid;
  const int32_t rc = valid ? s_rc[k] : 0;
  const int32_t rec = valid ? s_rec[k] : -2;
  const int32_t rec_prev = __shfl_up_sync(kAll, rec, 1);
  const int32_t rec_next = __shfl_down_sync(kAll, rec, 1);
  const bool first = valid && (k == 0 || rec != rec_prev);
  const bool last = valid && (k == n_valid - 1 || rec != rec_next);
  int32_t c = rc;  // inclusive sum from the front
  int32_t a = rc;  // inclusive sum from the back
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(kAll, c, off);
    const int32_t z = __shfl_down_sync(kAll, a, off);
    if (k >= off) c = add32(y, c);
    if (k + off < 32) a = add32(a, z);
  }
  int32_t b = first ? sub32(c, rc) : -1;  // base, a running max
  int32_t d = last ? sub32(a, rc) : -1;   // base from the back
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(kAll, b, off);
    const int32_t z = __shfl_down_sync(kAll, d, off);
    if (k >= off) b = y > b ? y : b;
    if (k + off < 32) d = z > d ? z : d;
  }
  const bool fwd = b > 0 || sub32(c, b) > 0;
  if (valid) sel[k] = (fwd || sub32(a, d) > 0) ? 1 : 0;
}

// or_sel of lanes [0, n_valid) into sel[], from rc (s_rc) and the record
// ids (s_rec): the reference's four scans over the lanes rounded up to a
// warp (at most R), in the scratch a and b ([R] words each); a point
// query's lanes (n_valid <= 32) take warp_or_select instead, two block
// barriers in place of fourteen. Called by all kThreads threads; starts
// and ends with the block synchronised.
template <int kThreads>
__device__ void or_select(const int32_t* s_rc, const int32_t* s_rec,
                          int n_valid, int R, int32_t* a, int32_t* b,
                          uint8_t* sel, int32_t* s_warp) {
  const int tid = threadIdx.x;
  const int n = min((n_valid + 31) & ~31, R);
  __syncthreads();
  if (n_valid <= 32) {
    if (tid < 32) warp_or_select(s_rc, s_rec, n_valid, sel);
    __syncthreads();
    return;
  }
  for (int k = tid; k < n; k += kThreads) a[k] = k < n_valid ? s_rc[k] : 0;
  block_scan<kThreads, false, false>(a, n, s_warp);  // a = c
  for (int k = tid; k < n; k += kThreads) {
    const bool first = k < n_valid && (k == 0 || s_rec[k] != s_rec[k - 1]);
    b[k] = first ? sub32(a[k], s_rc[k]) : -1;
  }
  block_scan<kThreads, true, false>(b, n, s_warp);  // b = base
  for (int k = tid; k < n; k += kThreads) {
    sel[k] = (b[k] > 0 || sub32(a[k], b[k]) > 0) ? 1 : 0;
    a[k] = k < n_valid ? s_rc[k] : 0;
  }
  block_scan<kThreads, false, true>(a, n, s_warp);  // a = sum of rc from k
  for (int k = tid; k < n; k += kThreads) {
    const bool last =
        k < n_valid && (k == n_valid - 1 || s_rec[k] != s_rec[k + 1]);
    b[k] = last ? sub32(a[k], s_rc[k]) : -1;
  }
  block_scan<kThreads, true, true>(b, n, s_warp);  // b = base from the back
  for (int k = tid; k < n; k += kThreads) {
    const bool bwd = sub32(a[k], b[k]) > 0;
    sel[k] = (k < n_valid && (sel[k] || bwd)) ? 1 : 0;
  }
  __syncthreads();
}

// The lanes k < n_valid whose sel[k] is set, ascending, into list[] by
// warp 0 (a ballot per 32 lanes, no atomics); returns their count in
// every thread. Called by all threads after or_select (whose closing
// barrier published sel); ends with the block synchronised.
__device__ __forceinline__ int sel_list(const uint8_t* sel, int n_valid,
                                        int32_t* list) {
  __shared__ int s_count;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < n_valid; base += 32) {
      const int k = base + lane;
      const bool on = k < n_valid && sel[k];
      const unsigned ball = __ballot_sync(0xffffffffu, on);
      if (on) list[n + __popc(ball & ((1u << lane) - 1u))] = k;
      n += __popc(ball);
    }
    if (lane == 0) s_count = n;
  }
  __syncthreads();
  return s_count;
}

// Masked popcounts of n rows by the block's warps, kRows rows a warp at
// a time: row i is plane row rows[i] (W words at a 64-bit word offset).
// Lane 0 of the row's warp calls sink(i, pc_call, pc_tok). Rows i <
// cache_rows also leave their masked gt words at cache[i * W]. Without
// kCounts only gt is read: pc_call = popc(gt & mask), pc_tok = 0. A
// caller with at most one row per warp passes kRows 1, so no lane loads
// a row twice (the loads of kRB rows with counts outgrow the registers).
template <int kThreads, bool kCounts = true, int kRows = kRB, class Sink>
__device__ void row_popcounts(const uint32_t* __restrict__ gt,
                              const uint32_t* __restrict__ gt2,
                              const uint32_t* __restrict__ tok1,
                              const uint32_t* __restrict__ tok2,
                              const int32_t* rows, int n, int W,
                              const uint32_t* mask, uint32_t* cache,
                              int cache_rows, Sink sink) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i0 = warp * kRows; i0 < n; i0 += kWarps * kRows) {
    size_t off[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      off[j] = static_cast<size_t>(rows[min(i0 + j, n - 1)]) *
               static_cast<size_t>(W);
    }
    uint32_t pc[kRows], pt[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) pc[j] = pt[j] = 0u;
    for (int w0 = 0; w0 < W; w0 += 32 * kU) {
      uint32_t g[kU][kRows], g2[kU][kRows], t1[kU][kRows], t2[kU][kRows];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const size_t w = min(w0 + 32 * u + lane, W - 1);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          g[u][j] = gt[off[j] + w];
          if constexpr (kCounts) {
            g2[u][j] = gt2[off[j] + w];
            t1[u][j] = tok1[off[j] + w];
            t2[u][j] = tok2[off[j] + w];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int w = w0 + 32 * u + lane;
        const uint32_t m = w < W ? mask[w] : 0u;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const uint32_t gm = g[u][j] & m;
          if constexpr (kCounts) {
            pc[j] += __popc(gm) + __popc(g2[u][j] & m);
            pt[j] += __popc(t1[u][j] & m) + __popc(t2[u][j] & m);
          } else {
            pc[j] += __popc(gm);
          }
          const int i = i0 + j;
          if (w < W && i < n && i < cache_rows) {
            cache[static_cast<size_t>(i) * W + w] = gm;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const uint32_t c = warp_sum_u(pc[j]);
      const uint32_t t = warp_sum_u(pt[j]);
      if (lane == 0 && i0 + j < n) sink(i0 + j, c, t);
    }
  }
}

// acc[w] |= the OR over the rows list[0..n_list) of their gt words &
// mask[w], by the block's warps, kRB rows a warp at a time: row i from
// cache[i * W] when i < cache_rows (already masked), else from plane row
// rows[i] of gt. acc is shared memory.
template <int kThreads>
__device__ void or_rows(const uint32_t* gt, const int32_t* rows,
                        const int32_t* list, int n_list, int W,
                        const uint32_t* mask, const uint32_t* cache,
                        int cache_rows, uint32_t* acc) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int l0 = warp * kRB; l0 < n_list; l0 += kWarps * kRB) {
    const uint32_t* src[kRB];
#pragma unroll
    for (int j = 0; j < kRB; ++j) {
      const int i = list[min(l0 + j, n_list - 1)];  // a repeat ORs nothing new
      src[j] = i < cache_rows
                   ? cache + static_cast<size_t>(i) * W
                   : gt + static_cast<size_t>(rows[i]) * static_cast<size_t>(W);
    }
    for (int w0 = 0; w0 < W; w0 += 32 * kU) {
      uint32_t g[kU][kRB];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int w = min(w0 + 32 * u + lane, W - 1);
#pragma unroll
        for (int j = 0; j < kRB; ++j) g[u][j] = src[j][w];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int w = w0 + 32 * u + lane;
        if (w < W) {
          uint32_t v = 0u;
#pragma unroll
          for (int j = 0; j < kRB; ++j) v |= g[u][j];
          v &= mask[w];
          if (v) atomicOr(&acc[w], v);
        }
      }
    }
  }
}

// Shared-memory scratch of reduce(): a, b over the R lanes, sel (R
// bytes), acc over the W words, tot over the block's warps.
struct Scratch {
  int32_t* a;
  int32_t* b;
  uint8_t* sel;
  uint32_t* acc;
  int32_t* tot;
};

// The query's sums, valid in thread 0 after reduce() returns.
struct Sums {
  int32_t call_count, all_alleles;
};

// The whole reduction in one block, called by all kThreads threads.
// `gt`..`tok2` point at row 0 of the planes the lanes' rows index, row
// stride W words (without counts only gt is read). Lane k < n_valid reads
// plane row s_row[k]; its gathered columns are s_flags, s_ac, s_an and
// s_rec (shared, [R]). s_ac becomes rc and s_an becomes an_eff, in place.
// `mask` is the query's W-word sample mask in shared memory. Writes
// pc_call and pc_tok ([R], zero past n_valid) and or_words ([W]) to
// global memory. Starts and ends with the block synchronised.
template <int kThreads>
__device__ Sums reduce(const uint32_t* __restrict__ gt,
                       const uint32_t* __restrict__ gt2,
                       const uint32_t* __restrict__ tok1,
                       const uint32_t* __restrict__ tok2,
                       const int32_t* s_row, const int32_t* s_flags,
                       int32_t* s_ac, int32_t* s_an, const int32_t* s_rec,
                       int n_valid, int R, int W, bool has_counts,
                       bool use_counts, const uint32_t* mask, Scratch s,
                       int32_t* pc_call, int32_t* pc_tok,
                       uint32_t* or_words) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  __shared__ uint32_t s_part[kWarps][2];
  __syncthreads();
  for (int w = tid; w < W; w += kThreads) s.acc[w] = 0u;

  // 1. masked popcounts (one row a warp when the rows fit the warps, as
  // a point query's do), then rc and an_eff
  if (has_counts) {
    auto sink = [&](int k, uint32_t c, uint32_t t) {
      const int flags = s_flags[k];
      pc_call[k] = static_cast<int32_t>(c);
      pc_tok[k] = static_cast<int32_t>(t);
      if (use_counts && !(flags & F_AC_INFO)) {
        s_ac[k] = static_cast<int32_t>(c);
      }
      if (use_counts && !(flags & F_AN_INFO)) {
        s_an[k] = static_cast<int32_t>(t);
      }
    };
    if (n_valid <= kWarps) {
      row_popcounts<kThreads, true, 1>(gt, gt2, tok1, tok2, s_row, n_valid,
                                       W, mask, nullptr, 0, sink);
    } else {
      row_popcounts<kThreads>(gt, gt2, tok1, tok2, s_row, n_valid, W, mask,
                              nullptr, 0, sink);
    }
  } else {
    for (int k = tid; k < n_valid; k += kThreads) {
      pc_call[k] = 0;
      pc_tok[k] = 0;
    }
  }
  for (int k = n_valid + tid; k < R; k += kThreads) {
    pc_call[k] = 0;
    pc_tok[k] = 0;
  }
  __syncthreads();

  // 2. the sums: rc over the valid lanes, an_eff over records' first lanes
  uint32_t cc = 0, al = 0;
  for (int k = tid; k < n_valid; k += kThreads) {
    cc += static_cast<uint32_t>(s_ac[k]);
    if (k == 0 || s_rec[k] != s_rec[k - 1]) {
      al += static_cast<uint32_t>(s_an[k]);
    }
  }
  cc = warp_sum_u(cc);
  al = warp_sum_u(al);
  if (lane == 0) {
    s_part[warp][0] = cc;
    s_part[warp][1] = al;
  }

  // 3. or_sel, then the list of its lanes (in b, free after the scans)
  or_select<kThreads>(s_ac, s_rec, n_valid, R, s.a, s.b, s.sel, s.tot);
  const int n_list = sel_list(s.sel, n_valid, s.b);

  // 4. the sample-hit OR over the or_sel rows
  or_rows<kThreads>(gt, s_row, s.b, n_list, W, mask, nullptr, 0, s.acc);
  __syncthreads();
  for (int w = tid; w < W; w += kThreads) or_words[w] = s.acc[w];

  Sums out{0, 0};
  if (tid == 0) {
    uint32_t tot_cc = 0, tot_al = 0;
    for (int w = 0; w < kWarps; ++w) {
      tot_cc += s_part[w][0];
      tot_al += s_part[w][1];
    }
    out.call_count = static_cast<int32_t>(tot_cc);
    out.all_alleles = static_cast<int32_t>(tot_al);
  }
  __syncthreads();
  return out;
}

}  // namespace plane_reduce
