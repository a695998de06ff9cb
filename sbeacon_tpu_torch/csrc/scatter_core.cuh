// The window match of the scatter kernels (sm_90a): the layout constants
// of sbeacon_tpu/ops/scatter_kernel.py::_scatter_core, shared by
// scatter_match.cu (J1, which runs its own window body and predicate)
// and scatter_selected.cu (J2, which runs match_window below).
//
// Per query slot q (semantics of _scatter_core):
//   - gather the C consecutive [8, T] tiles starting at tile_ids[q];
//     lane l of the window is global row tile_ids[q]*T + l;
//   - per lane: window lo <= gidx < min(hi, lo + CAP), the end bracket,
//     ref hash + length (or a wildcard ref), the length bounds (0xFFFF
//     max_len = unbounded), and the alt predicate: exact hash + length,
//     any single base, or the DEL/INS/DUP/DUP:TANDEM/CNV chain (other
//     types match nothing here; the host answers them);
//   - agg[q] = {call_count > 0, call_count = sum AC over matched lanes,
//     n_variants = matched lanes with AC != 0, all_alleles = AN of each
//     record's first matched lane, n_matched, overflow, 0, 0}; overflow
//     when hi - lo > CAP or any valid lane carries ROW_CLAMPED. Sums are
//     int32 and wrap like XLA's.
//
// "First matched lane of its record": a matched lane is first iff no
// earlier lane of its own SAME_PREV chain matched. Lanes before lo never
// match, so this one rule equals both the K-shift and the segmented-scan
// forms of the JAX program.
//
// match_window (J2's body): one 128-thread block a slot, each thread
// owning lanes tid, tid + 128, ...; each packed row of a tile is read as
// 512 coalesced bytes, AN with the other columns. The match and
// SAME_PREV bits of every lane stay in shared memory (1 byte each) for
// the caller, and a lane hook sees every lane's columns in the first
// pass and answers the AN pass from what it kept, so the window's tiles
// are read in one round.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scatter {

constexpr int kThreads = 128;
constexpr int kPacked = 8;

// packed hot-matrix rows (scatter_kernel.P_*)
constexpr int P_REC_END = 1;
constexpr int P_REF_HASH = 2;
constexpr int P_ALT_HASH = 3;
constexpr int P_LENS = 4;
constexpr int P_FLAGS = 5;
constexpr int P_AC = 6;
constexpr int P_AN = 7;

// query words (query_pack.Q_*)
constexpr int Q_LO = 0;
constexpr int Q_HI = 1;
constexpr int Q_END_MIN = 2;
constexpr int Q_END_MAX = 3;
constexpr int Q_REF_HASH = 4;
constexpr int Q_ALT_HASH = 5;
constexpr int Q_META = 6;
constexpr int Q_LENS = 7;

// index flag bits (index.columnar.FLAG, query_pack.PM_*, scatter_kernel)
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
constexpr int PM_INS = 1 << 16;
constexpr int PM_DUPT = 1 << 17;
constexpr int PM_CNV = 1 << 18;
constexpr int SAME_PREV = 1 << 26;
constexpr int ROW_CLAMPED = 1 << 27;

constexpr int MODE_EXACT = 0;
constexpr int MODE_ANY_BASE = 1;
constexpr int VT_DEL = 0;
constexpr int VT_INS = 1;
constexpr int VT_DUP = 2;
constexpr int VT_DUP_TANDEM = 3;
constexpr int VT_CNV = 4;

constexpr int kSums = 5;  // call_count, n_variants, n_matched, all_alleles, clamped

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The match of one query slot over its C*T window lanes, by the whole
// block: fills s_match[l] and s_same[l] (0/1 per lane) and writes the
// slot's aggregate row agg_q[0..8). The hook offers lane(l, matched,
// flags, ac, an), called for every window lane in the first pass, and
// an(l), the AN of a matched lane l, read by the AN pass. Ends with the
// block synchronised and both arrays visible to every thread.
template <bool kExactOnly, class Hook>
__device__ void match_window(const int32_t* __restrict__ tiles,
                             const int32_t* __restrict__ qp, int tile0,
                             int n_tiles, int T, int C, int cap,
                             uint8_t* s_match, uint8_t* s_same,
                             int32_t* __restrict__ agg_q, const Hook& hook) {
  __shared__ uint32_t s_part[kThreads / 32][kSums];
  const int span = C * T;
  const int tid = threadIdx.x;
  const int lo = qp[Q_LO];
  const int hi = qp[Q_HI];
  const int end_min = qp[Q_END_MIN];
  const int end_max = qp[Q_END_MAX];
  const int ref_hash_q = qp[Q_REF_HASH];
  const int alt_hash_q = qp[Q_ALT_HASH];
  const uint32_t meta = static_cast<uint32_t>(qp[Q_META]);
  const uint32_t lens_q = static_cast<uint32_t>(qp[Q_LENS]);
  const bool ref_wild = (meta & 1u) != 0;
  const int mode = static_cast<int>((meta >> 1) & 3u);
  const int vt = static_cast<int>((meta >> 3) & 7u);
  const int ref_len_q = static_cast<int>((meta >> 6) & 0x1FFFu);
  const int min_len_q = static_cast<int>((meta >> 19) & 0x1FFFu);
  const int alt_len_q = static_cast<int>(lens_q & 0xFFFFu);
  int max_len_q = static_cast<int>((lens_q >> 16) & 0xFFFFu);
  if (max_len_q == 0xFFFF) max_len_q = 0x7fffffff;
  const int win_end = min(hi, lo + cap);

  uint32_t call_count = 0, n_variants = 0, n_matched = 0, clamped = 0;
  for (int l = tid; l < span; l += kThreads) {
    const int c = l / T;
    const int t = l - c * T;
    const int tile = min(max(tile0 + c, 0), n_tiles - 1);
    const int32_t* col = tiles + static_cast<size_t>(tile) * kPacked * T + t;
    const int rec_end = col[P_REC_END * T];
    const int ref_hash = col[P_REF_HASH * T];
    const int alt_hash = col[P_ALT_HASH * T];
    const uint32_t lens = static_cast<uint32_t>(col[P_LENS * T]);
    const int flags = col[P_FLAGS * T];
    const int ac = col[P_AC * T];
    const int an = col[P_AN * T];

    const int gidx = tile0 * T + l;
    const bool valid = gidx >= lo && gidx < win_end;
    const int alt_len = static_cast<int>(lens & 0xFFFFu);
    const int ref_len = static_cast<int>((lens >> 16) & 0x1FFFu);
    const bool end_ok = end_min <= rec_end && rec_end <= end_max;
    const bool ref_ok =
        ref_wild || (ref_hash == ref_hash_q && ref_len == ref_len_q);
    const bool len_ok = min_len_q <= alt_len && alt_len <= max_len_q;
    const bool exact_ok = alt_hash == alt_hash_q && alt_len == alt_len_q;

    bool alt_ok;
    if (kExactOnly) {
      alt_ok = exact_ok;
    } else if (mode == MODE_EXACT) {
      alt_ok = exact_ok;
    } else if (mode == MODE_ANY_BASE) {
      alt_ok = (flags & F_SINGLE_BASE) != 0;
    } else {
      const bool sym = (flags & F_SYMBOLIC) != 0;
      const int k = ((flags >> 19) & 0x7F) - 1;
      auto f = [flags](int bit) { return (flags & bit) != 0; };
      switch (vt) {
        case VT_DEL:
          alt_ok = sym ? (f(F_DEL_PREFIX) || f(F_CN0)) : alt_len < ref_len;
          break;
        case VT_INS:
          alt_ok = sym ? f(PM_INS) : alt_len > ref_len;
          break;
        case VT_DUP:
          alt_ok = sym ? (f(F_DUP_PREFIX) ||
                          (f(F_CN_PREFIX) && !f(F_CN0) && !f(F_CN1)))
                       : k >= 2;
          break;
        case VT_DUP_TANDEM:
          alt_ok = sym ? (f(PM_DUPT) || f(F_CN2)) : k == 2;
          break;
        case VT_CNV:
          alt_ok = sym ? (f(PM_CNV) || f(F_CN_PREFIX) || f(F_DEL_PREFIX) ||
                          f(F_DUP_PREFIX))
                       : (f(F_DOT) || k >= 1);
          break;
        default:
          alt_ok = false;  // VT_OTHER: host-resolved (pack_q8)
      }
    }

    const bool m = valid && end_ok && ref_ok && len_ok && alt_ok;
    s_match[l] = m ? 1 : 0;
    s_same[l] = (flags & SAME_PREV) ? 1 : 0;
    hook.lane(l, m, flags, ac, an);
    if (m) {
      call_count += static_cast<uint32_t>(ac);
      n_variants += ac != 0 ? 1u : 0u;
      n_matched += 1u;
    }
    clamped += (valid && (flags & ROW_CLAMPED)) ? 1u : 0u;
  }
  __syncthreads();

  // AN once per record: first matched lane of each SAME_PREV chain
  uint32_t all_alleles = 0;
  for (int l = tid; l < span; l += kThreads) {
    if (!s_match[l]) continue;
    bool first = true;
    for (int j = l; j > 0 && s_same[j]; --j) {
      if (s_match[j - 1]) {
        first = false;
        break;
      }
    }
    if (first) all_alleles += static_cast<uint32_t>(hook.an(l));
  }

  uint32_t sums[kSums] = {call_count, n_variants, n_matched, all_alleles,
                          clamped};
  const int warp = tid >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    sums[i] = warp_sum(sums[i]);
    if (lane == 0) s_part[warp][i] = sums[i];
  }
  __syncthreads();
  if (tid == 0) {
    uint32_t tot[kSums] = {0, 0, 0, 0, 0};
    for (int w = 0; w < kThreads / 32; ++w) {
#pragma unroll
      for (int i = 0; i < kSums; ++i) tot[i] += s_part[w][i];
    }
    const int cc = static_cast<int32_t>(tot[0]);
    agg_q[0] = cc > 0 ? 1 : 0;
    agg_q[1] = cc;
    agg_q[2] = static_cast<int32_t>(tot[1]);
    agg_q[3] = static_cast<int32_t>(tot[3]);
    agg_q[4] = static_cast<int32_t>(tot[2]);
    agg_q[5] = ((hi - lo) > cap || tot[4] > 0) ? 1 : 0;
    agg_q[6] = 0;
    agg_q[7] = 0;
  }
}

}  // namespace scatter
