// The search, lane loads and cluster fan-in of the stacked kernels
// (sm_90a), shared by stacked_query.cu and stacked_selected.cu (J7): one
// cluster of c = min(d_local, 8) blocks of 256 threads answers one query
// over a mesh device's block of d_local datasets.
//
// Semantics are bisect_core.cuh's query_block (its header says what that
// computes); the pieces here shorten its chain of dependent memory round
// trips:
//   - load_query reads a packed query's fields once per block;
//   - block_window finds the window [lo, hi) inside the query's segment:
//     the segment row is loaded beside the query row (each warp's lanes
//     load its 27 entries and a shuffle picks the segment's ends), then
//     threads 0-127 find lo and 128-255 hi with block_bound, four warps
//     probing 128 rows a step and meeting at a named barrier per half: 3
//     dependent steps on a chr1-sized segment of a 2e7-row dataset where
//     warp_bound's 32 probes take 5;
//   - load_lane loads every column lane_match may read for the query
//     (chosen by its ref and alt modes), with rec_id, AC and AN, in one
//     round of independent loads, where query_block's short-circuit chain
//     takes up to four;
//   - cluster_sum: each block leaves its partials in the leader's shared
//     memory (distributed shared memory, after the cluster barrier that
//     every block arrives at when it starts: cluster_arrive_relaxed at
//     the kernel's entry), and after one more barrier the leader writes
//     the sums with plain stores: no fill of the output, no atomics.
// fused_match.cuh (the body of J3, bisect_query.cu, and of J6's
// match-only kernel, mesh_fused.cu) runs load_query, block_window,
// load_lane, lane_match and launch_clusters too; query_block and
// warp_bound, which only J6's planes kernel runs, are left as they are.
// Every device function here is inlined, as the
// same functions were in J7 query's own anonymous namespace: a call left
// out of line costs that kernel a stack frame and a spill.

#pragma once

#include <cooperative_groups.h>

#include "bisect_core.cuh"

namespace stacked {

using namespace bisect;
namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kHalf = kThreads / 2;     // threads of one bound's search
constexpr int kHalfWarps = kHalf / 32;  // warps of one bound's search

__device__ __forceinline__ void half_barrier(int half) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + half), "r"(kHalf) : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// First row in [a, b) whose pos is >= target (kUpper false) or
// > target (kUpper true); b when there is none: what warp_bound returns,
// with 128 probes a step. Called by the kHalf threads of one half of the
// block (`half` 0: threads 0-127, 1: threads 128-255), which meet at
// named barrier 1 + half once a step; `cnt` is that half's [2][4] count
// table (double buffered, so one barrier a step suffices). Each step
// probes rows a, a + step, ... (step = ceil((b - a) / 128)); on a sorted
// segment the probes that lie before the answer form a prefix of the
// threads, and its length narrows [a, b] to one step.
template <bool kUpper>
__device__ __forceinline__ int block_bound(const int32_t* __restrict__ pos,
                                           int a, int b, int target,
                                           int half,
                                           int (*cnt)[kHalfWarps]) {
  const int t = threadIdx.x - half * kHalf;
  const int w = t >> 5;
  int parity = 0;
  while (a < b) {
    const long long step = (static_cast<long long>(b) - a + kHalf - 1) / kHalf;
    const long long idx = a + t * step;
    bool before = false;
    if (idx < b) {
      const int p = pos[idx];
      before = kUpper ? (p <= target) : (p < target);
    }
    const int cw = __popc(__ballot_sync(0xffffffffu, before));
    if ((t & 31) == 0) cnt[parity][w] = cw;
    half_barrier(half);
    int c = 0;
#pragma unroll
    for (int k = 0; k < kHalfWarps; ++k) c += cnt[parity][k];
    parity ^= 1;
    const long long na = c > 0 ? a + (c - 1) * step + 1 : a;
    const long long nb = a + c * step < b ? a + c * step : b;
    a = static_cast<int>(na);
    b = static_cast<int>(nb);
  }
  return a;
}

// A packed query's fields, read once per block.
struct Query {
  int chrom, start_min, start_max, end_min, end_max, ref_hash, ref_len,
      mode, alt_hash, alt_len, vt, min_len, max_len;
  bool ref_wild;
  uint32_t vp[4], vm[4];
};

__device__ __forceinline__ Query load_query(const int32_t* __restrict__ qp) {
  Query q;
  q.chrom = qp[QF_CHROM];
  q.start_min = qp[QF_START_MIN];
  q.start_max = qp[QF_START_MAX];
  q.end_min = qp[QF_END_MIN];
  q.end_max = qp[QF_END_MAX];
  q.ref_wild = qp[QF_REF_WILD] != 0;
  q.ref_hash = qp[QF_REF_HASH];
  q.ref_len = qp[QF_REF_LEN];
  q.mode = qp[QF_ALT_MODE];
  q.alt_hash = qp[QF_ALT_HASH];
  q.alt_len = qp[QF_ALT_LEN];
  q.vt = qp[QF_VT_CODE];
  q.min_len = qp[QF_MIN_LEN];
  q.max_len = qp[QF_MAX_LEN];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    q.vp[w] = static_cast<uint32_t>(qp[QF_VPREFIX + w]);
    q.vm[w] = static_cast<uint32_t>(qp[QF_VMASK + w]);
  }
  return q;
}

// The window [lo, hi) of query q inside its segment of one dataset
// (columns `cols`, 27-entry segment row `seg`), by all kThreads threads:
// threads 0-127 find lo, 128-255 hi. Lane k of every warp loads seg[k]
// (lanes past the row's end its last entry), with no wait on the query
// row, and the segment's two ends come by shuffle. Returns the same
// (lo, hi) in every thread; ends with the block synchronised.
__device__ __forceinline__ int2 block_window(
    const int32_t* __restrict__ cols, const int32_t* __restrict__ seg,
    const Query& q) {
  __shared__ int s_bounds[2];
  __shared__ int s_cnt[2][2][kHalfWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int half = tid / kHalf;
  const int chrom = q.chrom;
  const int32_t seg_k = seg[min(lane, kSegs - 1)];
  const int seg_lo =
      __shfl_sync(0xffffffffu, seg_k, min(max(chrom, 0), kSegs - 1));
  const int seg_hi = __shfl_sync(
      0xffffffffu, seg_k, chrom < kSegs - 1 ? max(chrom + 1, 0) : kSegs - 1);
  const int r = half == 0
                    ? block_bound<false>(cols, seg_lo, seg_hi, q.start_min, 0,
                                         s_cnt[0])
                    : block_bound<true>(cols, seg_lo, seg_hi, q.start_max, 1,
                                        s_cnt[1]);
  if (tid % kHalf == 0) s_bounds[half] = r;
  __syncthreads();
  return make_int2(s_bounds[0], s_bounds[1]);
}

// One window lane's columns, loaded in one round.
struct Lane {
  int rec_end, alt_len, flags, ref_hash, ref_len, alt_hash, repeat_k,
      rec_id, ac, an;
  int4 ap;
};

// Every column lane_match may read for query q, with rec_id, AC and AN,
// in one round of independent loads; a column q's predicate never reads
// (the ref for a wildcard ref, the alt hash outside exact mode, the
// repeat count and the alt prefix outside the typed modes) is not
// loaded and reads 0.
__device__ __forceinline__ Lane load_lane(
    const Query& q, const int32_t* __restrict__ cols, long long n_pad,
    const int32_t* __restrict__ alt_prefix, long long r) {
  auto col = [cols, n_pad, r](int c) {
    return cols[static_cast<long long>(c) * n_pad + r];
  };
  const bool typed = q.mode != MODE_EXACT && q.mode != MODE_ANY_BASE;
  Lane v{};
  v.rec_end = col(C_REC_END);
  v.alt_len = col(C_ALT_LEN);
  v.flags = col(C_FLAGS);
  v.rec_id = col(C_REC_ID);
  v.ac = col(C_AC);
  v.an = col(C_AN);
  if (!q.ref_wild) v.ref_hash = col(C_REF_HASH);
  if (!q.ref_wild || typed) v.ref_len = col(C_REF_LEN);
  if (q.mode == MODE_EXACT) v.alt_hash = col(C_ALT_HASH);
  if (typed) {
    v.repeat_k = col(C_REPEAT_K);
    v.ap = reinterpret_cast<const int4*>(alt_prefix)[r];
  }
  return v;
}

// query_block's predicate on a loaded lane.
__device__ __forceinline__ bool lane_match(const Query& q, const Lane& v) {
  bool m = q.end_min <= v.rec_end && v.rec_end <= q.end_max &&
           q.min_len <= v.alt_len && v.alt_len <= q.max_len;
  if (m && !q.ref_wild) {
    m = v.ref_hash == q.ref_hash && v.ref_len == q.ref_len;
  }
  if (!m) return false;
  auto f = [&v](int bit) { return (v.flags & bit) != 0; };
  if (q.mode == MODE_EXACT) {
    return v.alt_hash == q.alt_hash && v.alt_len == q.alt_len;
  }
  if (q.mode == MODE_ANY_BASE) return f(F_SINGLE_BASE);
  if (f(F_SYMBOLIC)) {
    const bool pm =
        ((static_cast<uint32_t>(v.ap.x) ^ q.vp[0]) & q.vm[0]) == 0 &&
        ((static_cast<uint32_t>(v.ap.y) ^ q.vp[1]) & q.vm[1]) == 0 &&
        ((static_cast<uint32_t>(v.ap.z) ^ q.vp[2]) & q.vm[2]) == 0 &&
        ((static_cast<uint32_t>(v.ap.w) ^ q.vp[3]) & q.vm[3]) == 0;
    switch (q.vt) {
      case VT_DEL:
        return pm || f(F_CN0);
      case VT_DUP:
        return pm || (f(F_CN_PREFIX) && !f(F_CN0) && !f(F_CN1));
      case VT_DUP_TANDEM:
        return pm || f(F_CN2);
      case VT_CNV:
        return pm || f(F_CN_PREFIX) || f(F_DEL_PREFIX) || f(F_DUP_PREFIX);
      default:  // INS, and every other type (VT_OTHER)
        return pm;
    }
  }
  switch (q.vt) {
    case VT_DEL:
      return v.alt_len < v.ref_len;
    case VT_INS:
      return v.alt_len > v.ref_len;
    case VT_DUP:
      return v.repeat_k >= 2;
    case VT_DUP_TANDEM:
      return v.repeat_k == 2;
    case VT_CNV:
      return f(F_DOT) || v.repeat_k >= 1;
    default:
      return false;
  }
}

// The cluster's fan-in of kN uint32 partials, read in thread 0 of each
// block: every block writes its partials into the leader's shared memory
// once the whole cluster has started, and after one more barrier the
// leader's first kN threads store the sums (int32, wrapping) to out[0..kN).
// Called by every thread of every block of the cluster (c blocks, this
// one of rank `rank`), whose blocks each called cluster_arrive_relaxed()
// when they started.
template <int kN>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster, int c,
                                            int rank,
                                            const uint32_t (&part)[kN],
                                            int32_t* __restrict__ out) {
  __shared__ uint32_t s_fan[kMaxCluster][kN];  // the leader's
  // every block of the cluster has started: the leader's shared memory
  // may be written
  cluster_wait();
  if (threadIdx.x == 0) {
    uint32_t* dst = cluster.map_shared_rank(&s_fan[rank][0], 0);
#pragma unroll
    for (int i = 0; i < kN; ++i) dst[i] = part[i];
  }
  cluster.sync();  // every block's partials are in the leader
  if (rank == 0 && threadIdx.x < kN) {
    uint32_t sum = 0;
    for (int r = 0; r < c; ++r) sum += s_fan[r][threadIdx.x];
    out[threadIdx.x] = static_cast<int32_t>(sum);
  }
}

// Launch `kernel` on `stream` as one cluster of min(n_datasets, 8)
// blocks of kThreads per query, with `smem` bytes of dynamic shared
// memory (opted into above 48 KB). Returns the launch's error (a cluster
// launch the card refuses included), else cudaGetLastError() after it.
template <class... Params, class... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int n_queries,
                            int n_datasets, size_t smem, cudaStream_t stream,
                            Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int c = n_datasets < kMaxCluster ? n_datasets : kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_queries) * c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace stacked
