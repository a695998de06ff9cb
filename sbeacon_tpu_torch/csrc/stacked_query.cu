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
// (stacked_core.cuh, which stacked_selected.cu shares) shortens the
// chain: one cluster of c = min(d_local, 8) blocks per query, block
// `rank` taking datasets rank, rank + c, ...; the segment row loaded
// beside the query row; each bound found by 128 probes a step (3 steps
// on a chr1-sized segment of a 2e7-row dataset, where warp_bound takes
// 5); every column the query's predicate may need, AN and rec_id
// included, loaded in one round; the five partials summed in the
// leader's shared memory, so the wrapper allocates agg without a fill
// launch and no atomics are needed.
// What bounds this design: five dependent memory round trips a query
// (the query and segment rows together, three search steps, the lane
// loads), the cluster launch and its two barriers; wide windows then
// add a round of lane loads per 256 lanes.

#include "stacked_core.cuh"

namespace {

using namespace stacked;

constexpr int kStackAgg = 5;

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
  __shared__ uint32_t s_wcount[kWarps];
  __shared__ uint32_t s_part[kWarps][3];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // 1. the window: threads 0-127 find lo, 128-255 find hi, inside the
  // query's segment
  const int2 bounds = block_window(cols, seg, q);
  const int lo = bounds.x;
  const int hi = bounds.y;
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
  cluster_arrive_relaxed();  // this block has started (cluster_sum waits)
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
  cluster_sum(cluster, c, rank, part,
              agg + static_cast<size_t>(q) * kStackAgg);
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
  return static_cast<int>(launch_clusters(
      stacked_query_kernel, n_queries, n_datasets,
      static_cast<size_t>(window_smem(W)), static_cast<cudaStream_t>(stream),
      static_cast<const int32_t*>(cols), n_pad,
      static_cast<const int32_t*>(alt_prefix),
      static_cast<const int32_t*>(offsets), n_datasets,
      static_cast<const int32_t*>(qpack), n_queries,
      static_cast<int32_t*>(out), static_cast<int32_t*>(agg), W, R));
}

}  // extern "C"
