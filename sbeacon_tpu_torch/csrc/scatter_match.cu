// Scatter match kernel for Hopper (sm_90a).
//
// Replaces sbeacon_tpu/ops/scatter_kernel.py::_scatter_core /
// _scatter_batch / _scatter_many (the XLA gather program that answers
// every single-dataset variant query on the accelerator). One launch
// covers every padded query slot of one (tier, exact) split: the grid
// axis takes the place of _scatter_many's lax.map over chunks.
//
// What it computes, per query slot q (semantics of _scatter_core):
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
//     int32 and wrap like XLA's;
//   - masks[q][w] bit b = lane w*16 + b matched.
//
// "First matched lane of its record": a matched lane walks back along
// its own SAME_PREV chain and is first iff no earlier lane of the chain
// matched. Lanes before lo never match, so this one rule equals both the
// K-shift and the segmented-scan forms of the JAX program.
//
// What bounds it on this card: bytes. A query reads C * 4 KB of tiles
// (T = 128) from random places of the packed index (about 640 MB at
// 2e7 rows, far above the 50 MB L2), and does a few tens of integer
// operations per lane; tensor cores (wgmma) have no role. This first
// version is the simple, correct one: one 128-thread block per query
// slot, each thread owning lanes tid, tid + 128, ...; each packed row
// of a tile is read as 512 coalesced bytes. Match and SAME_PREV bits
// live in shared memory (2 bytes per lane), the sums are reduced by warp
// shuffles and one thread per 16-lane word packs the masks. Making it
// fast (asynchronous tile copies, several queries per block) is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <bool kExactOnly>
__global__ void __launch_bounds__(kThreads) scatter_match_kernel(
    const int32_t* __restrict__ tiles, const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ q8, int32_t* __restrict__ agg,
    int32_t* __restrict__ masks, int n_tiles, int T, int C, int cap) {
  extern __shared__ uint8_t smem[];
  __shared__ uint32_t s_part[kThreads / 32][kSums];

  const int span = C * T;
  uint8_t* s_match = smem;
  uint8_t* s_same = smem + span;

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t* qp = q8 + static_cast<size_t>(q) * 8;
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
  const int tile0 = tile_ids[q];

  uint32_t call_count = 0, n_variants = 0, n_matched = 0, clamped = 0;
  for (int l = tid; l < span; l += kThreads) {
    const int c = l / T;
    const int t = l - c * T;
    // out-of-range tile ids clamp like an XLA gather (the index's
    // MAX_C padding tiles keep real queries in range)
    const int tile = min(max(tile0 + c, 0), n_tiles - 1);
    const int32_t* col = tiles + static_cast<size_t>(tile) * kPacked * T + t;
    const int rec_end = col[P_REC_END * T];
    const int ref_hash = col[P_REF_HASH * T];
    const int alt_hash = col[P_ALT_HASH * T];
    const uint32_t lens = static_cast<uint32_t>(col[P_LENS * T]);
    const int flags = col[P_FLAGS * T];
    const int ac = col[P_AC * T];

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
    if (first) {
      const int c = l / T;
      const int t = l - c * T;
      const int tile = min(max(tile0 + c, 0), n_tiles - 1);
      all_alleles += static_cast<uint32_t>(
          tiles[(static_cast<size_t>(tile) * kPacked + P_AN) * T + t]);
    }
  }

  // bit-packed match mask: bit b of word w = lane w*16 + b
  const int nw = span / 16;
  int32_t* mq = masks + static_cast<size_t>(q) * nw;
  for (int w = tid; w < nw; w += kThreads) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      word |= static_cast<uint32_t>(s_match[w * 16 + b]) << b;
    }
    mq[w] = static_cast<int32_t>(word);
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
    int32_t* out = agg + static_cast<size_t>(q) * 8;
    out[0] = cc > 0 ? 1 : 0;
    out[1] = cc;
    out[2] = static_cast<int32_t>(tot[1]);
    out[3] = static_cast<int32_t>(tot[3]);
    out[4] = static_cast<int32_t>(tot[2]);
    out[5] = ((hi - lo) > cap || tot[4] > 0) ? 1 : 0;
    out[6] = 0;
    out[7] = 0;
  }
}

}  // namespace

extern "C" {

// Launch one tier: n_slots blocks of 128 threads on `stream`. Every
// pointer is a device pointer (tiles [n_tiles, 8, T], tile_ids
// [n_slots], q8 [n_slots, 8], agg [n_slots, 8], masks
// [n_slots, C*T/16], all int32 and contiguous). The caller guarantees
// T % 128 == 0 and 2*C*T bytes of shared memory <= 48 KB. Returns
// cudaGetLastError() after the launch.
int scatter_match_launch(const void* tiles, const void* tile_ids,
                         const void* q8, void* agg, void* masks, int n_slots,
                         int n_tiles, int T, int C, int cap, int exact_only,
                         void* stream) {
  if (n_slots <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>(n_slots));
  const dim3 block(kThreads);
  const size_t smem = static_cast<size_t>(2) * C * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(tiles);
  const int32_t* ids = static_cast<const int32_t*>(tile_ids);
  const int32_t* qq = static_cast<const int32_t*>(q8);
  int32_t* a = static_cast<int32_t*>(agg);
  int32_t* m = static_cast<int32_t*>(masks);
  if (exact_only) {
    scatter_match_kernel<true><<<grid, block, smem, s>>>(t, ids, qq, a, m,
                                                         n_tiles, T, C, cap);
  } else {
    scatter_match_kernel<false><<<grid, block, smem, s>>>(t, ids, qq, a, m,
                                                          n_tiles, T, C, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
