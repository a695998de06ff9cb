// The per-query body of the bisection kernels (sm_90a), run by the
// leader block of J6's planes kernel (mesh_fused.cu), whose constants
// and semantics every query kernel shares: J3 (bisect_query.cu) and J6
// match-only through fused_match.cuh, J7 through stacked_core.cuh. One
// 256-thread block answers one query against one segment table row, the
// semantics of sbeacon_tpu/ops/kernel.py::_bisect / _query_one.
//
// What it computes, per query q against columns `cols` (stride n_pad) and
// one 27-entry segment row `seg`:
//   - window: lo = first row of the segment seg[chrom] .. seg[chrom + 1]
//     (indices clamp like an XLA gather) with pos >= start_min, hi = first
//     row with pos > start_max (no target + 1, so INT32_MAX cannot wrap);
//     lanes [lo, min(hi, lo + W)) are valid;
//   - per valid lane: the end bracket, ref hash + length (or a wildcard
//     ref), the length bounds, and the alt predicate: exact hash + length,
//     any single base, or the DEL/INS/DUP/DUP:TANDEM/CNV chain, with every
//     other variant type answered as SYMBOLIC && alt_prefix matches
//     '<' + type (16-byte prefix, XOR and mask);
//   - agg = {call_count > 0, call_count = sum AC over matched lanes,
//     n_variants = matched lanes with AC != 0, all_alleles = AN of each
//     record's first matched lane, n_matched, overflow = hi - lo > W},
//     then the first R matched row ids in ascending order, -1 padded.
//     Sums are int32 and wrap like XLA's.
//
// "First matched lane of its record": a matched lane walks back while the
// previous lane holds the same rec_id and is first iff none of those lanes
// matched. Lanes before lo are never visited, and rec_id is nondecreasing
// inside a segment, so this equals the JAX program's cumsum + searchsorted
// rule.
//
// Design (latency first, then bytes): warp 0 finds lo and warp 1 finds hi
// at the same time, each with a 32-ary search (32 lanes probe 32 evenly
// spaced rows, a ballot narrows the range 32-fold: about 5 dependent steps
// instead of 26); threads visit only the valid lanes, each warp reading 32
// consecutive rows of a column, and skip the columns a predicate does not
// need; the matched row ids are written in order by stream compaction
// (ballot + block prefix over each 256-lane chunk), not sorted.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bisect {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAgg = 6;
constexpr int kQFields = 24;
constexpr int kSegs = 27;

// rows of the stacked column tensor (ops.kernel.C_*)
constexpr int C_POS = 0;
constexpr int C_REC_END = 1;
constexpr int C_REF_LEN = 2;
constexpr int C_ALT_LEN = 3;
constexpr int C_REF_HASH = 4;
constexpr int C_ALT_HASH = 5;
constexpr int C_REPEAT_K = 6;
constexpr int C_FLAGS = 7;
constexpr int C_AC = 8;
constexpr int C_AN = 9;
constexpr int C_REC_ID = 10;
constexpr int kColumns = 11;

// fields of a packed query (ops.kernel.QF_*)
constexpr int QF_CHROM = 0;
constexpr int QF_SHARD = 1;
constexpr int QF_START_MIN = 2;
constexpr int QF_START_MAX = 3;
constexpr int QF_END_MIN = 4;
constexpr int QF_END_MAX = 5;
constexpr int QF_REF_WILD = 6;
constexpr int QF_REF_HASH = 7;
constexpr int QF_REF_LEN = 8;
constexpr int QF_ALT_MODE = 9;
constexpr int QF_ALT_HASH = 10;
constexpr int QF_ALT_LEN = 11;
constexpr int QF_VT_CODE = 12;
constexpr int QF_MIN_LEN = 13;
constexpr int QF_MAX_LEN = 14;
constexpr int QF_VPREFIX = 15;
constexpr int QF_VMASK = 19;

// index flag bits (index.columnar.FLAG)
constexpr int F_SYMBOLIC = 1;
constexpr int F_CN_PREFIX = 2;
constexpr int F_CN0 = 4;
constexpr int F_CN1 = 8;
constexpr int F_CN2 = 16;
constexpr int F_DOT = 32;
constexpr int F_DEL_PREFIX = 64;
constexpr int F_DUP_PREFIX = 128;
constexpr int F_SINGLE_BASE = 256;
constexpr int F_AC_INFO = 512;
constexpr int F_AN_INFO = 1024;

constexpr int MODE_EXACT = 0;
constexpr int MODE_ANY_BASE = 1;
constexpr int VT_DEL = 0;
constexpr int VT_INS = 1;
constexpr int VT_DUP = 2;
constexpr int VT_DUP_TANDEM = 3;
constexpr int VT_CNV = 4;

// Dynamic shared memory query_block takes: rec_id and the match byte of
// each of the W window lanes.
__host__ __device__ constexpr long long window_smem(int W) {
  return 5LL * W;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// First row in [a, b) whose pos is >= target (kUpper false) or
// > target (kUpper true); b when there is none. Called by all 32 lanes
// of one warp. The answer always lies in [a, b]: each step probes rows
// a, a + step, ... (step = ceil((b - a) / 32)); on a sorted segment the
// probes that lie before the answer form a prefix of the lanes, and its
// length narrows [a, b] to one step.
template <bool kUpper>
__device__ int warp_bound(const int32_t* __restrict__ pos, int a, int b,
                          int target) {
  const int lane = threadIdx.x & 31;
  while (a < b) {
    const long long step = (static_cast<long long>(b) - a + 31) / 32;
    const long long idx = a + lane * step;
    bool before = false;
    if (idx < b) {
      const int p = pos[idx];
      before = kUpper ? (p <= target) : (p < target);
    }
    const int c = __popc(__ballot_sync(0xffffffffu, before));
    const long long na = c > 0 ? a + (c - 1) * step + 1 : a;
    const long long nb = a + c * step < b ? a + c * step : b;
    a = static_cast<int>(na);
    b = static_cast<int>(nb);
  }
  return a;
}

// One query's answer after query_block returns: n_matched and overflow
// in every thread, the three sums in thread 0.
struct Agg {
  int32_t call_count, n_variants, all_alleles, n_matched;
  bool overflow;
};

// The per-query body, called by all kThreads threads of the block with
// the same arguments. `cols` [11, n_pad] and `alt_prefix` [n_pad, 4] are
// the columns the query searches, `seg` its 27-entry segment row, `qp`
// its packed fields. `win` is window_smem(W) bytes of shared memory.
// Writes the aggregate row to `agg` (kAgg words; may be null) and the
// first R matched row ids, ascending and -1 padded, to `rows` (global or
// shared). Ends with the block synchronised.
__device__ Agg query_block(const int32_t* __restrict__ cols, long long n_pad,
                           const int32_t* __restrict__ alt_prefix,
                           const int32_t* __restrict__ seg,
                           const int32_t* __restrict__ qp, int W, int R,
                           int32_t* rows, int32_t* agg, int32_t* win) {
  int32_t* s_rec = win;                                     // [W] rec_id
  uint8_t* s_match = reinterpret_cast<uint8_t*>(win + W);  // [W] matched
  __shared__ int s_bounds[2];
  __shared__ uint32_t s_wcount[kWarps];
  __shared__ uint32_t s_part[kWarps][3];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  auto col = [cols, n_pad](int c) {
    return cols + static_cast<long long>(c) * n_pad;
  };

  // 1. the window: warp 0 finds lo, warp 1 finds hi, inside the query's
  // segment
  if (warp < 2) {
    const int chrom = qp[QF_CHROM];
    const int seg_lo = seg[min(max(chrom, 0), kSegs - 1)];
    const int seg_hi = seg[chrom < kSegs - 1 ? max(chrom + 1, 0) : kSegs - 1];
    const int r = warp == 0
                      ? warp_bound<false>(col(C_POS), seg_lo, seg_hi,
                                          qp[QF_START_MIN])
                      : warp_bound<true>(col(C_POS), seg_lo, seg_hi,
                                         qp[QF_START_MAX]);
    if (lane == 0) s_bounds[warp] = r;
  }
  __syncthreads();
  const int lo = s_bounds[0];
  const int hi = s_bounds[1];
  const int n_valid = max(0, min(hi - lo, W));

  const int end_min = qp[QF_END_MIN];
  const int end_max = qp[QF_END_MAX];
  const bool ref_wild = qp[QF_REF_WILD] != 0;
  const int ref_hash_q = qp[QF_REF_HASH];
  const int ref_len_q = qp[QF_REF_LEN];
  const int mode = qp[QF_ALT_MODE];
  const int alt_hash_q = qp[QF_ALT_HASH];
  const int alt_len_q = qp[QF_ALT_LEN];
  const int vt = qp[QF_VT_CODE];
  const int min_len = qp[QF_MIN_LEN];
  const int max_len = qp[QF_MAX_LEN];
  uint32_t vp[4], vm[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    vp[w] = static_cast<uint32_t>(qp[QF_VPREFIX + w]);
    vm[w] = static_cast<uint32_t>(qp[QF_VMASK + w]);
  }

  uint32_t call_count = 0, n_variants = 0, all_alleles = 0;
  int n_matched = 0;  // block-uniform running count

  // 2. the valid lanes, 256 at a time: predicates, then stream
  // compaction of the matched row ids and the AN first-match rule
  for (int base = 0; base < n_valid; base += kThreads) {
    const int l = base + tid;
    bool m = false;
    if (l < n_valid) {
      const long long r = static_cast<long long>(lo) + l;
      const int rec_end = col(C_REC_END)[r];
      const int alt_len = col(C_ALT_LEN)[r];
      const int flags = col(C_FLAGS)[r];
      m = end_min <= rec_end && rec_end <= end_max && min_len <= alt_len &&
          alt_len <= max_len;
      if (m && !ref_wild) {
        m = col(C_REF_HASH)[r] == ref_hash_q && col(C_REF_LEN)[r] == ref_len_q;
      }
      if (m) {
        auto f = [flags](int bit) { return (flags & bit) != 0; };
        if (mode == MODE_EXACT) {
          m = col(C_ALT_HASH)[r] == alt_hash_q && alt_len == alt_len_q;
        } else if (mode == MODE_ANY_BASE) {
          m = f(F_SINGLE_BASE);
        } else if (f(F_SYMBOLIC)) {
          const int4 ap = reinterpret_cast<const int4*>(alt_prefix)[r];
          const bool pm =
              ((static_cast<uint32_t>(ap.x) ^ vp[0]) & vm[0]) == 0 &&
              ((static_cast<uint32_t>(ap.y) ^ vp[1]) & vm[1]) == 0 &&
              ((static_cast<uint32_t>(ap.z) ^ vp[2]) & vm[2]) == 0 &&
              ((static_cast<uint32_t>(ap.w) ^ vp[3]) & vm[3]) == 0;
          switch (vt) {
            case VT_DEL:
              m = pm || f(F_CN0);
              break;
            case VT_DUP:
              m = pm || (f(F_CN_PREFIX) && !f(F_CN0) && !f(F_CN1));
              break;
            case VT_DUP_TANDEM:
              m = pm || f(F_CN2);
              break;
            case VT_CNV:
              m = pm || f(F_CN_PREFIX) || f(F_DEL_PREFIX) || f(F_DUP_PREFIX);
              break;
            default:  // INS, and every other type (VT_OTHER)
              m = pm;
          }
        } else {
          const int ref_len = col(C_REF_LEN)[r];
          const int k = col(C_REPEAT_K)[r];
          switch (vt) {
            case VT_DEL:
              m = alt_len < ref_len;
              break;
            case VT_INS:
              m = alt_len > ref_len;
              break;
            case VT_DUP:
              m = k >= 2;
              break;
            case VT_DUP_TANDEM:
              m = k == 2;
              break;
            case VT_CNV:
              m = f(F_DOT) || k >= 1;
              break;
            default:
              m = false;
          }
        }
      }
      s_rec[l] = col(C_REC_ID)[r];
      s_match[l] = m ? 1 : 0;
      if (m) {
        const int ac = col(C_AC)[r];
        call_count += static_cast<uint32_t>(ac);
        n_variants += ac != 0 ? 1u : 0u;
      }
    }
    const unsigned ball = __ballot_sync(0xffffffffu, m);
    if (lane == 0) s_wcount[warp] = __popc(ball);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = static_cast<int>(s_wcount[w]);
      before += w < warp ? c : 0;
      total += c;
    }
    if (m) {
      const int slot = n_matched + before + __popc(ball & ((1u << lane) - 1u));
      if (slot < R) rows[slot] = lo + l;
      bool first = true;
      for (int j = l; j > 0 && s_rec[j - 1] == s_rec[j]; --j) {
        if (s_match[j - 1]) {
          first = false;
          break;
        }
      }
      if (first) {
        all_alleles += static_cast<uint32_t>(
            col(C_AN)[static_cast<long long>(lo) + l]);
      }
    }
    n_matched += total;
    __syncthreads();  // s_wcount is rewritten by the next chunk
  }
  for (int i = min(n_matched, R) + tid; i < R; i += kThreads) rows[i] = -1;

  // 3. block sums, int32 with wraparound
  uint32_t sums[3] = {call_count, n_variants, all_alleles};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sums[i] = warp_sum(sums[i]);
    if (lane == 0) s_part[warp][i] = sums[i];
  }
  __syncthreads();
  Agg out{0, 0, 0, n_matched, (hi - lo) > W};
  if (tid == 0) {
    uint32_t tot[3] = {0, 0, 0};
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int i = 0; i < 3; ++i) tot[i] += s_part[w][i];
    }
    out.call_count = static_cast<int32_t>(tot[0]);
    out.n_variants = static_cast<int32_t>(tot[1]);
    out.all_alleles = static_cast<int32_t>(tot[2]);
    if (agg != nullptr) {
      agg[0] = out.call_count > 0 ? 1 : 0;
      agg[1] = out.call_count;
      agg[2] = out.n_variants;
      agg[3] = out.all_alleles;
      agg[4] = out.n_matched;
      agg[5] = out.overflow ? 1 : 0;
    }
  }
  __syncthreads();  // rows (when shared) and s_part are complete
  return out;
}

}  // namespace bisect
