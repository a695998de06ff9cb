// Stacked selected-samples kernel for Hopper (sm_90a): the plane body of
// the dataset-sharded stack.
//
// Replaces sbeacon_tpu/parallel/mesh.py::_local_selected (mesh.py:460):
// the per-device program of sharded_selected_query, a grid of (local
// dataset x query) running _query_one, then gathers of the matched rows'
// columns and genotype planes under the dataset's sample mask, the
// plane reduction _plane_reduce, and the sums over the local datasets
// before one psum. Here one launch covers one mesh device's block of
// d_local datasets; the psum is the caller's.
//
// What it computes, per (query q, local dataset d):
//   - the per-query semantics of bisect_core.cuh's query_block against
//     dataset d's columns (64-bit offset d * 11 * n_pad) and segment row
//     chrom_offsets[d]: the first R matched rows (dataset-local,
//     ascending) and n_matched;
//   - the flags, AC, AN and rec_id of those rows, and plane_reduce.cuh
//     over their plane rows under mask[d]: dataset d's plane row r is
//     row d * n_pad + r of the [d_local * n_pad, W] planes, a word offset
//     past 2^31 at full width, so every offset is 64-bit;
//   - scal[d][q] = {call_count, all_alleles_count, overflow | (n_matched >
//     record_cap), n_matched}, rows[d][q] (-1 padded), pc_call, pc_tok
//     and or_words[d][q];
//   - the fan-in over datasets, folded into the same launch: agg[q] =
//     {call_count, all_alleles_count, n_overflow}, int32 sums that wrap
//     like the JAX program's jnp.sum over datasets.
//
// What bounds it on this card: latency. A point query reads a few rows'
// columns and a few plane rows of 316 B (x4 with counts); its bound is a
// few nanoseconds of bytes, so its time is the launch plus a chain of
// dependent memory round trips and block barriers. The design takes J7
// query's (stacked_core.cuh):
//   - one cluster of c = min(d_local, 8) blocks of 256 threads per query,
//     block `rank` taking datasets rank, rank + c, ...; each block writes
//     its per-dataset outputs with plain stores and leaves its three
//     partials in the leader's shared memory, which sums them into agg[q]
//     (no fill launch, no atomics);
//   - the segment row loaded beside the query row, the 128-probe
//     block_bound (3 steps on a chr1-sized segment), then one round of
//     lane loads that brings each lane's predicate columns with its
//     flags, AC, AN and rec_id, kept in shared memory for the first R
//     matched lanes by a ballot compaction (query_block's search, its
//     short-circuit loads and a second gather of the matched rows'
//     columns are gone), and an L2 prefetch of each kept lane's plane row
//     lines issued as soon as its slot is known;
//   - plane_reduce::reduce (log-depth scans over the valid lanes, every
//     plane load of kRB rows in flight before use) in each block.
// A point query's critical path: the query and segment rows, three
// search steps, the lane loads, the plane rows (prefetched), the stores
// and the cluster's two barriers.

#include "plane_reduce.cuh"
#include "stacked_core.cuh"

namespace {

using namespace stacked;

constexpr int kScal = 4;
constexpr int kSelAgg = 3;

// Dynamic shared memory of one block: seven int32 arrays over the R
// lanes (rows, flags, ac, an, rec_id and two scan buffers), the mask and
// the OR words (2 W) and or_sel (R bytes).
__host__ __device__ constexpr long long selected_smem(int R, int W) {
  return 28LL * R + 8LL * W + R;
}

__global__ void __launch_bounds__(kThreads) stacked_selected_kernel(
    const int32_t* __restrict__ cols, long long n_pad,
    const int32_t* __restrict__ alt_prefix,
    const int32_t* __restrict__ offsets, int n_datasets,
    const uint32_t* __restrict__ gt, const uint32_t* __restrict__ gt2,
    const uint32_t* __restrict__ tok1, const uint32_t* __restrict__ tok2,
    const uint32_t* __restrict__ masks, const int32_t* __restrict__ qpack,
    int n_queries, int32_t* __restrict__ scal, int32_t* __restrict__ rows,
    int32_t* __restrict__ pc_call, int32_t* __restrict__ pc_tok,
    uint32_t* __restrict__ or_words, int32_t* __restrict__ agg, int Wwin,
    int R, int W, int record_cap, bool has_counts) {
  extern __shared__ int32_t smem[];
  cluster_arrive_relaxed();  // this block has started (cluster_sum waits)
  int32_t* s_row = smem;
  int32_t* s_flags = s_row + R;
  int32_t* s_ac = s_flags + R;
  int32_t* s_an = s_ac + R;
  int32_t* s_rec = s_an + R;
  plane_reduce::Scratch sc;
  sc.a = s_rec + R;
  sc.b = sc.a + R;
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(sc.b + R);
  sc.acc = s_mask + W;
  sc.sel = reinterpret_cast<uint8_t*>(sc.acc + W);
  __shared__ int32_t s_tot[kWarps];
  __shared__ uint32_t s_wcount[kWarps];
  sc.tot = s_tot;

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int q = blockIdx.x / c;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Query qv = load_query(qpack + static_cast<size_t>(q) * kQFields);
  uint32_t part[kSelAgg] = {0, 0, 0};
  for (int d = rank; d < n_datasets; d += c) {
    const size_t slot = static_cast<size_t>(d) * n_queries + q;
    const int32_t* dcols = cols + static_cast<long long>(d) * kColumns * n_pad;
    const int32_t* dalt = alt_prefix + static_cast<long long>(d) * n_pad * 4;
    const size_t plane0 = static_cast<size_t>(d) * n_pad * W;
    // the mask is first read by the plane reduction: its copy does not
    // hold up the search
    plane_reduce::copy_words_async(s_mask, masks + static_cast<size_t>(d) * W,
                                   W);

    // 1. the window inside the query's segment of dataset d
    const int2 bounds =
        block_window(dcols, offsets + static_cast<size_t>(d) * kSegs, qv);
    const int lo = bounds.x;
    const int hi = bounds.y;
    const int n_lanes = max(0, min(hi - lo, Wwin));

    // 2. the valid lanes, 256 at a time: every column in one round, the
    // predicate, then the first R matched lanes' row and columns kept in
    // lane order (ballot + block prefix), their plane rows prefetched
    int n_matched = 0;  // block-uniform running count
    for (int base = 0; base < n_lanes; base += kThreads) {
      const int l = base + tid;
      bool m = false;
      Lane v{};
      if (l < n_lanes) {
        v = load_lane(qv, dcols, n_pad, dalt, static_cast<long long>(lo) + l);
        m = lane_match(qv, v);
      }
      const unsigned ball = __ballot_sync(0xffffffffu, m);
      if (lane == 0) s_wcount[warp] = __popc(ball);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int cw = static_cast<int>(s_wcount[w]);
        before += w < warp ? cw : 0;
        total += cw;
      }
      if (m) {
        const int k = n_matched + before + __popc(ball & ((1u << lane) - 1u));
        if (k < R) {
          const int r = lo + l;
          s_row[k] = r;
          s_flags[k] = v.flags;
          s_ac[k] = v.ac;
          s_an[k] = v.an;
          s_rec[k] = v.rec_id;
          const size_t off = plane0 + static_cast<size_t>(r) * W;
          plane_reduce::prefetch_row(gt, off, W);
          if (has_counts) {
            plane_reduce::prefetch_row(gt2, off, W);
            plane_reduce::prefetch_row(tok1, off, W);
            plane_reduce::prefetch_row(tok2, off, W);
          }
        }
      }
      n_matched += total;
      __syncthreads();  // s_wcount is rewritten by the next chunk
    }
    const int n_valid = min(n_matched, R);
    for (int k = tid; k < R; k += kThreads) {
      rows[slot * R + k] = k < n_valid ? s_row[k] : -1;
    }

    // 3. the plane reduction over dataset d's plane rows (its first
    // barrier publishes the mask)
    plane_reduce::copy_wait();
    const plane_reduce::Sums s = plane_reduce::reduce<kThreads>(
        gt + plane0, gt2 + plane0, tok1 + plane0, tok2 + plane0, s_row,
        s_flags, s_ac, s_an, s_rec, n_valid, R, W, has_counts, true, s_mask,
        sc, pc_call + slot * R, pc_tok + slot * R, or_words + slot * W);

    if (tid == 0) {
      const bool overflow = (hi - lo) > Wwin || n_matched > record_cap;
      int32_t* sq = scal + slot * kScal;
      sq[0] = s.call_count;
      sq[1] = s.all_alleles;
      sq[2] = overflow ? 1 : 0;
      sq[3] = n_matched;
      part[0] += static_cast<uint32_t>(s.call_count);
      part[1] += static_cast<uint32_t>(s.all_alleles);
      part[2] += overflow ? 1u : 0u;
    }
  }
  cluster_sum(cluster, c, rank, part,
              agg + static_cast<size_t>(q) * kSelAgg);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the kernel takes.
long long stacked_selected_smem(int R, int W) { return selected_smem(R, W); }

// Launch one mesh device's block on `stream`: one cluster of
// min(n_datasets, 8) blocks of 256 threads per query. Every pointer is a
// device pointer to contiguous 32-bit data: cols [n_datasets, 11, n_pad],
// alt_prefix [n_datasets, n_pad, 4], offsets [n_datasets, 27], the planes
// gt/gt2/tok1/tok2 [n_datasets * n_pad, W] (without counts only gt is
// read), masks [n_datasets, W], qpack [n_queries, 24]; outputs scal
// [n_datasets, n_queries, 4], rows/pc_call/pc_tok [n_datasets, n_queries,
// R], or_words [n_datasets, n_queries, W] and agg [n_queries, 3] (every
// word written by the launch). The caller guarantees 1 <= R <= Wwin.
// Returns the launch's error (a cluster launch the card refuses
// included), else cudaGetLastError() after it.
int stacked_selected_launch(const void* cols, long long n_pad,
                            const void* alt_prefix, const void* offsets,
                            const void* gt, const void* gt2, const void* tok1,
                            const void* tok2, const void* masks,
                            int n_datasets, const void* qpack, int n_queries,
                            void* scal, void* rows, void* pc_call,
                            void* pc_tok, void* or_words, void* agg, int Wwin,
                            int R, int W, int record_cap, int has_counts,
                            void* stream) {
  if (n_queries <= 0 || n_datasets <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch_clusters(
      stacked_selected_kernel, n_queries, n_datasets,
      static_cast<size_t>(selected_smem(R, W)),
      static_cast<cudaStream_t>(stream), static_cast<const int32_t*>(cols),
      n_pad, static_cast<const int32_t*>(alt_prefix),
      static_cast<const int32_t*>(offsets), n_datasets,
      static_cast<const uint32_t*>(gt), static_cast<const uint32_t*>(gt2),
      static_cast<const uint32_t*>(tok1), static_cast<const uint32_t*>(tok2),
      static_cast<const uint32_t*>(masks), static_cast<const int32_t*>(qpack),
      n_queries, static_cast<int32_t*>(scal), static_cast<int32_t*>(rows),
      static_cast<int32_t*>(pc_call), static_cast<int32_t*>(pc_tok),
      static_cast<uint32_t*>(or_words), static_cast<int32_t*>(agg), Wwin, R, W,
      record_cap, has_counts != 0));
}

}  // extern "C"
