// The masked-plane reduction (sm_90a), a block-level routine for the
// kernels that match rows and then read their genotype planes:
// stacked_selected.cu (J7) now, the owner-sliced fused query (J6) later.
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
// Design: a warp per matched row reads its W plane words (lanes stride
// the row, coalesced), __popc and a shuffle sum give the popcounts; the
// four scans run in shared memory over the R lanes (each thread scans a
// contiguous chunk, then adds the totals of the chunks before it); a
// second warp-per-row pass re-reads the or_sel rows' gt words (mostly
// from L2, just read) into a shared OR accumulator.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace plane_reduce {

constexpr int F_AC_INFO = 512;
constexpr int F_AN_INFO = 1024;

// a - b and a + b in int32 with wraparound
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
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
// signed max, from the front (kReverse false) or from the back. Starts
// and ends with the block synchronised. `tot` holds kThreads words.
template <int kThreads, bool kMax, bool kReverse>
__device__ void block_scan(int32_t* a, int n, int32_t* tot) {
  const int tid = threadIdx.x;
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
  tot[tid] = acc;
  __syncthreads();
  int32_t pre = ident;
  for (int j = 0; j < tid; ++j) pre = combine(pre, tot[j]);
  for (int i = b; i < e; ++i) a[at(i)] = combine(pre, a[at(i)]);
  __syncthreads();
}

// Shared-memory scratch of reduce(): a, b over the R lanes, sel (R
// bytes), acc over the W words, tot over the block's threads.
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

// Called by all kThreads threads of the block. `gt`..`tok2` point at row
// 0 of the planes the lanes' rows index, row stride W words (without
// counts only gt is read). Lane k < n_valid reads plane row s_row[k]; its
// gathered columns are s_flags, s_ac, s_an and s_rec (shared, [R]).
// s_ac becomes rc and s_an becomes an_eff, in place. `mask` is the
// query's W-word sample mask in shared memory. Writes pc_call and pc_tok
// ([R], zero past n_valid) and or_words ([W]) to global memory. Starts
// and ends with the block synchronised.
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
  auto row_off = [s_row, W](int k) {
    return static_cast<size_t>(s_row[k]) * static_cast<size_t>(W);
  };
  __syncthreads();
  for (int w = tid; w < W; w += kThreads) s.acc[w] = 0u;

  // 1. per matched row, one warp: masked popcounts, then rc and an_eff
  if (has_counts) {
    for (int k = warp; k < n_valid; k += kWarps) {
      const size_t off = row_off(k);
      uint32_t p_call = 0, p_tok = 0;
      for (int w = lane; w < W; w += 32) {
        const uint32_t m = mask[w];
        p_call += __popc(gt[off + w] & m) + __popc(gt2[off + w] & m);
        p_tok += __popc(tok1[off + w] & m) + __popc(tok2[off + w] & m);
      }
      p_call = warp_sum_u(p_call);
      p_tok = warp_sum_u(p_tok);
      if (lane == 0) {
        const int flags = s_flags[k];
        pc_call[k] = static_cast<int32_t>(p_call);
        pc_tok[k] = static_cast<int32_t>(p_tok);
        if (use_counts && !(flags & F_AC_INFO)) {
          s_ac[k] = static_cast<int32_t>(p_call);
        }
        if (use_counts && !(flags & F_AN_INFO)) {
          s_an[k] = static_cast<int32_t>(p_tok);
        }
      }
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
    s_ac[k] = 0;
  }
  __syncthreads();

  // 2. the sums: rc over every lane, an_eff over records' first lanes
  uint32_t cc = 0, al = 0;
  for (int k = tid; k < R; k += kThreads) {
    cc += static_cast<uint32_t>(s_ac[k]);
    if (k < n_valid && (k == 0 || s_rec[k] != s_rec[k - 1])) {
      al += static_cast<uint32_t>(s_an[k]);
    }
  }
  cc = warp_sum_u(cc);
  al = warp_sum_u(al);
  if (lane == 0) {
    s_part[warp][0] = cc;
    s_part[warp][1] = al;
  }

  // 3. or_sel from the forward and backward segmented scans
  for (int k = tid; k < R; k += kThreads) s.a[k] = s_ac[k];
  block_scan<kThreads, false, false>(s.a, R, s.tot);  // a = c
  for (int k = tid; k < R; k += kThreads) {
    const bool first = k < n_valid && (k == 0 || s_rec[k] != s_rec[k - 1]);
    s.b[k] = first ? sub32(s.a[k], s_ac[k]) : -1;
  }
  block_scan<kThreads, true, false>(s.b, R, s.tot);  // b = base
  for (int k = tid; k < R; k += kThreads) {
    s.sel[k] = (s.b[k] > 0 || sub32(s.a[k], s.b[k]) > 0) ? 1 : 0;
    s.a[k] = s_ac[k];
  }
  block_scan<kThreads, false, true>(s.a, R, s.tot);  // a = sum of rc from k
  for (int k = tid; k < R; k += kThreads) {
    const bool last =
        k < n_valid && (k == n_valid - 1 || s_rec[k] != s_rec[k + 1]);
    s.b[k] = last ? sub32(s.a[k], s_ac[k]) : -1;
  }
  block_scan<kThreads, true, true>(s.b, R, s.tot);  // b = base from the back
  for (int k = tid; k < R; k += kThreads) {
    const bool bwd = sub32(s.a[k], s.b[k]) > 0;
    s.sel[k] = (k < n_valid && (s.sel[k] || bwd)) ? 1 : 0;
  }
  __syncthreads();

  // 4. the sample-hit OR over the or_sel rows, one warp per row
  for (int k = warp; k < n_valid; k += kWarps) {
    if (!s.sel[k]) continue;
    const size_t off = row_off(k);
    for (int w = lane; w < W; w += 32) {
      const uint32_t g = gt[off + w] & mask[w];
      if (g) atomicOr(&s.acc[w], g);
    }
  }
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
