// Bisection query kernel for Hopper (sm_90a).
//
// Replaces sbeacon_tpu/ops/kernel.py::_bisect / _query_one /
// _query_batch (kernel.py:478,502,626): the XLA program that answers
// every multi-dataset variant query against the fused stack of all warm
// shards, and a DeviceIndex's queries. One launch covers a whole batch.
// Query q is answered against the segment row offsets[shard[q]] (the
// shard id clamps like an XLA gather) with bisect_core.cuh's semantics
// (query_block's header says what it computes): out[q] = the aggregate
// row {exists, call_count, n_variants, all_alleles, n_matched,
// overflow}, then the first R matched row ids, ascending, -1 padded.
//
// What bounds it on this card: latency, then bytes. A point query
// touches a few rows of columns far larger than the 50 MB L2; its cost
// is its chain of dependent memory round trips (query row, segment row,
// the search steps, the lane loads) and the block's start-up. A bracket
// of 2-200 kb spans hundreds to a couple of thousand lanes, whose loads
// one SM issues in series of 256-lane chunks unless the window is split.
//
// Design: fused_match.cuh's match_slot, the body of J6's match-only
// kernel (mesh_fused.cu), in its J3 form (every slot owned, shard ids
// clamped, no rebase, the exists column), on a cluster of min(8,
// ceil(W / 256)) blocks a query, block rank r taking lanes [256 r,
// 256 r + 256) of a window up to 2048 lanes. The segment table comes in
// the query row's round (up to 9 shards), the search probes 128 rows a
// step (3 steps on a chr1-sized segment, where one warp's 32 probes take
// 5), every column a lane's predicate needs comes in one round of loads
// with rec_id, AC and AN, and the first-match rule and the row
// compaction are ballots with a carry across warps, chunks and blocks:
// no serial walk back over earlier lanes, no AN load after it. A window
// inside rank 0's 256 lanes (a point query's) is answered by rank 0
// alone with no cluster barrier, a wider one with one exchange of
// summaries in distributed shared memory. One block a query loading up
// to 8 lanes a thread in one round ran level with the cluster at every
// batch phase 9 of chip_smoke.py times (PERF.md), so the window split
// stays. A cluster launch the card refuses returns its error; the
// wrapper raises.

#include "fused_match.cuh"

namespace {

using namespace bisect;

__global__ void __launch_bounds__(kThreads) bisect_query_kernel(
    fused_match::MatchArgs p) {
  fused_match::match_slot<true>(p);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the launch takes.
long long bisect_query_smem(int W, int R) {
  return fused_match::match_smem(W, R, fused_match::match_blocks(W));
}

// Launch one batch on `stream`: a cluster of min(8, ceil(W / 256))
// blocks of 256 threads a query. Every pointer is a device pointer to
// contiguous int32 data: cols [11, n_pad], alt_prefix [n_pad, 4],
// offsets [n_shards, 27], qpack [n_queries, 24], out [n_queries, 6 + R];
// the launch writes every word of out. Returns the launch's error (a
// refused cluster launch included), else cudaGetLastError() after it.
int bisect_query_launch(const void* cols, long long n_pad,
                        const void* alt_prefix, const void* offsets,
                        int n_shards, const void* qpack, void* out,
                        int n_queries, int W, int R, void* stream) {
  if (n_queries <= 0) return static_cast<int>(cudaSuccess);
  fused_match::MatchArgs a{};
  a.cols = static_cast<const int32_t*>(cols);
  a.n_pad = n_pad;
  a.alt_prefix = static_cast<const int32_t*>(alt_prefix);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.d_local = n_shards;
  a.qpack = static_cast<const int32_t*>(qpack);
  a.n_slots = n_queries;
  a.C = n_queries;
  a.agg = static_cast<int32_t*>(out);
  a.Wwin = W;
  a.R = R;
  return static_cast<int>(stacked::launch_clusters(
      bisect_query_kernel, n_queries, fused_match::match_blocks(W),
      static_cast<size_t>(bisect_query_smem(W, R)),
      static_cast<cudaStream_t>(stream), a));
}

}  // extern "C"
