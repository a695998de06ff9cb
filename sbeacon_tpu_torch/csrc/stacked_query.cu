// Stacked query kernel for Hopper (sm_90a): the query-only body of the
// dataset-sharded stack.
//
// Replaces sbeacon_tpu/parallel/mesh.py::_local_query (mesh.py:309): the
// per-device program of sharded_query, a grid of (local dataset x query)
// running _query_one, then the sums over the local datasets and one psum
// over the mesh. Here one launch covers one mesh device's block of
// d_local datasets; the psum is the caller's (a sum of the per-device
// partials).
//
// What it computes, per (query q, local dataset d):
//   - the per-query semantics of bisect_core.cuh's query_block (its
//     header says what that computes) against dataset d's columns, which
//     start at the 64-bit offset d * 11 * n_pad, and its segment row
//     chrom_offsets[d]. The rows are local to the dataset (< n_pad). A
//     padding dataset has an all-zero segment row: every window is empty
//     and it stays silent;
//   - out[d][q] = {exists, call_count, n_variants, all_alleles,
//     n_matched, overflow}, then the first R matched row ids;
//   - the cross-dataset fan-in, folded into the same launch: agg[q] =
//     {call_count, all_alleles_count, n_variants, n_datasets_hit
//     (call_count > 0), n_overflow}, int32 sums that wrap like the JAX
//     program's jnp.sum over datasets and then psum.
//
// What bounds it on this card: latency. A point query touches a few
// rows, so its time is a chain of dependent memory round trips (the
// query row, the segment row, the search's probes, the window's
// columns) plus the launch; the bytes are a few hundred. The design
// shortens the chain:
//   - a cluster of c = min(d_local, 8) blocks answers one query (one
//     cluster per query, launched with cudaLaunchKernelEx and a cluster
//     dimension); block `rank` takes datasets rank, rank + c, ...;
//     each block leaves its five partials in the leader's shared memory
//     (distributed shared memory, after the cluster barrier that every
//     block arrives at when it starts), and after one more barrier the
//     leader writes agg[q] with plain stores: the wrapper allocates agg
//     without a fill launch and no atomics are needed;
//   - each bound is found by four warps (threads 0-127 the lower bound,
//     128-255 the upper) probing 128 rows a step and meeting at a named
//     barrier per half: 3 dependent steps on a chr1-sized segment of a
//     2e7-row dataset where warp_bound's 32 probes take 5;
//   - the segment row is loaded beside the query row (each warp's lanes
//     load its 27 entries and a shuffle picks the segment's ends), not
//     after it;
//   - each valid lane loads every column the query's predicate may need
//     (chosen by the query's ref and alt modes, AN, rec_id and the alt
//     prefix included) in one round before any test, where query_block's
//     short-circuit chain takes up to four.
// What bounds this design: five dependent memory round trips a query
// (the query and segment rows together, three search steps, the lane
// loads), the cluster launch and its two barriers; wide windows then
// add a round of lane loads per 256 lanes.
// query_block and warp_bound, which bisect_query.cu, mesh_fused.cu and
// stacked_selected.cu run, are not used here and are left as they are.

#include <cooperative_groups.h>

#include "bisect_core.cuh"

namespace {

using namespace bisect;
namespace cg = cooperative_groups;

constexpr int kStackAgg = 5;
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
__device__ int block_bound(const int32_t* __restrict__ pos, int a, int b,
                           int target, int half,
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

__device__ Query load_query(const int32_t* __restrict__ qp) {
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

// One query against one dataset, called by all kThreads threads of the
// block: query_block's outputs (the aggregate row to `agg`, the first R
// matched row ids to `rows`, the Agg returned with the sums in thread 0)
// from the two-half search and the one-round lane loads. Ends with the
// block synchronised.
__device__ Agg query_wide(const int32_t* __restrict__ cols, long long n_pad,
                          const int32_t* __restrict__ alt_prefix,
                          const int32_t* __restrict__ seg, const Query& q,
                          int W, int R, int32_t* __restrict__ rows,
                          int32_t* __restrict__ agg, int32_t* win) {
  int32_t* s_rec = win;                                     // [W] rec_id
  uint8_t* s_match = reinterpret_cast<uint8_t*>(win + W);  // [W] matched
  __shared__ int s_bounds[2];
  __shared__ int s_cnt[2][2][kHalfWarps];
  __shared__ uint32_t s_wcount[kWarps];
  __shared__ uint32_t s_part[kWarps][3];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // 1. the window: threads 0-127 find lo, 128-255 find hi, inside the
  // query's segment. Lane k of every warp loads seg[k] (lanes past the
  // row's end its last entry), with no wait on the query row, and the
  // segment's two ends come by shuffle
  {
    const int half = tid / kHalf;
    const int chrom = q.chrom;
    const int32_t seg_k = seg[min(lane, kSegs - 1)];
    const int seg_lo =
        __shfl_sync(0xffffffffu, seg_k, min(max(chrom, 0), kSegs - 1));
    const int seg_hi = __shfl_sync(
        0xffffffffu, seg_k, chrom < kSegs - 1 ? max(chrom + 1, 0) : kSegs - 1);
    const int r = half == 0
                      ? block_bound<false>(cols, seg_lo, seg_hi, q.start_min,
                                           0, s_cnt[0])
                      : block_bound<true>(cols, seg_lo, seg_hi, q.start_max,
                                          1, s_cnt[1]);
    if (tid % kHalf == 0) s_bounds[half] = r;
  }
  __syncthreads();
  const int lo = s_bounds[0];
  const int hi = s_bounds[1];
  const int n_valid = max(0, min(hi - lo, W));

  uint32_t call_count = 0, n_variants = 0, all_alleles = 0;
  int n_matched = 0;  // block-uniform running count

  // 2. the valid lanes, 256 at a time: every column in one round, the
  // predicate, then stream compaction of the matched row ids and the AN
  // first-match rule
  for (int base = 0; base < n_valid; base += kThreads) {
    const int l = base + tid;
    bool m = false;
    int an = 0;
    if (l < n_valid) {
      const Lane v = load_lane(q, cols, n_pad, alt_prefix,
                               static_cast<long long>(lo) + l);
      m = lane_match(q, v);
      an = v.an;
      s_rec[l] = v.rec_id;
      s_match[l] = m ? 1 : 0;
      if (m) {
        call_count += static_cast<uint32_t>(v.ac);
        n_variants += v.ac != 0 ? 1u : 0u;
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
      if (first) all_alleles += static_cast<uint32_t>(an);
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
    agg[0] = out.call_count > 0 ? 1 : 0;
    agg[1] = out.call_count;
    agg[2] = out.n_variants;
    agg[3] = out.all_alleles;
    agg[4] = out.n_matched;
    agg[5] = out.overflow ? 1 : 0;
  }
  __syncthreads();  // s_part and the window are rewritten by the next call
  return out;
}

// One cluster of c blocks per query (c from the launch's cluster
// dimension); block `rank` answers datasets rank, rank + c, ...
__global__ void __launch_bounds__(kThreads) stacked_query_kernel(
    const int32_t* __restrict__ cols, long long n_pad,
    const int32_t* __restrict__ alt_prefix,
    const int32_t* __restrict__ offsets, int n_datasets,
    const int32_t* __restrict__ qpack, int n_queries,
    int32_t* __restrict__ out, int32_t* __restrict__ agg, int W, int R) {
  extern __shared__ int32_t smem[];
  __shared__ uint32_t s_fan[kMaxCluster][kStackAgg];  // the leader's
  cluster_arrive_relaxed();  // this block has started (waited on below)
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int q = blockIdx.x / c;
  const Query qv = load_query(qpack + static_cast<size_t>(q) * kQFields);
  uint32_t part[kStackAgg] = {0, 0, 0, 0, 0};
  for (int d = rank; d < n_datasets; d += c) {
    const long long col_base = static_cast<long long>(d) * kColumns * n_pad;
    int32_t* oq =
        out + (static_cast<size_t>(d) * n_queries + q) * (kAgg + R);
    const Agg a = query_wide(
        cols + col_base, n_pad,
        alt_prefix + static_cast<long long>(d) * n_pad * 4,
        offsets + static_cast<size_t>(d) * kSegs, qv, W, R, oq + kAgg, oq,
        smem);
    part[0] += static_cast<uint32_t>(a.call_count);
    part[1] += static_cast<uint32_t>(a.all_alleles);
    part[2] += static_cast<uint32_t>(a.n_variants);
    part[3] += a.call_count > 0 ? 1u : 0u;
    part[4] += a.overflow ? 1u : 0u;
  }
  // every block of the cluster has started: the leader's shared memory
  // may be written
  cluster_wait();
  if (threadIdx.x == 0) {
    uint32_t* dst = cluster.map_shared_rank(&s_fan[rank][0], 0);
#pragma unroll
    for (int i = 0; i < kStackAgg; ++i) dst[i] = part[i];
  }
  cluster.sync();  // every block's partials are in the leader
  if (rank == 0 && threadIdx.x < kStackAgg) {
    uint32_t sum = 0;
    for (int r = 0; r < c; ++r) sum += s_fan[r][threadIdx.x];
    agg[static_cast<size_t>(q) * kStackAgg + threadIdx.x] =
        static_cast<int32_t>(sum);
  }
}

}  // namespace

extern "C" {

// Launch one mesh device's block on `stream`: one cluster of
// min(n_datasets, 8) blocks of 256 threads per query. Every pointer is a
// device pointer to contiguous int32 data: cols [n_datasets, 11, n_pad],
// alt_prefix [n_datasets, n_pad, 4], offsets [n_datasets, 27], qpack
// [n_queries, 24], out [n_datasets, n_queries, 6 + R], agg [n_queries, 5]
// (every word written by the launch). The window takes 5 bytes of shared
// memory per lane. Returns the launch's error (a cluster launch the card
// refuses included), else cudaGetLastError() after it.
int stacked_query_launch(const void* cols, long long n_pad,
                         const void* alt_prefix, const void* offsets,
                         int n_datasets, const void* qpack, int n_queries,
                         void* out, void* agg, int W, int R, void* stream) {
  if (n_queries <= 0 || n_datasets <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(window_smem(W));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stacked_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int c = n_datasets < kMaxCluster ? n_datasets : kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_queries) * c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, stacked_query_kernel, static_cast<const int32_t*>(cols), n_pad,
      static_cast<const int32_t*>(alt_prefix),
      static_cast<const int32_t*>(offsets), n_datasets,
      static_cast<const int32_t*>(qpack), n_queries,
      static_cast<int32_t*>(out), static_cast<int32_t*>(agg), W, R);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
