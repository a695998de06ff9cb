// Plane-stats kernel for Hopper (sm_90a).
//
// Replaces sbeacon_tpu/ops/plane_kernel.py::_plane_stats (plane_kernel.py:
// 164, the XLA program that reads the genotype bit planes of a
// matched-row set for the selected-samples leaf and for sample-hit
// extraction, when the rows came from the host matcher: window or
// record overflow, N-wildcard refs).
//
// What it computes, for a row set rows[0..R) of planes [n_plane, W] int32
// (uint32 bit patterns, bit s%32 of word s//32 = sample s):
//   - counts[r] = {popc(gt & mask), popc(gt2 & mask), popc(tok1 & mask),
//     popc(tok2 & mask)} summed over the row's W words; the last three
//     are 0 without counts (the caller then passes gt for those planes);
//   - or_words[w] = OR over the rows with or_sel[r] != 0 of gt[row][w] &
//     mask[w] with with_or, else 0 (the launch writes every word).
// Row ids clamp to [0, n_plane) like an XLA gather.
//
// What bounds it on this card: bytes. Each row reads W words per plane
// (316 B at 2504 samples) from random places of planes that hold GBs,
// far above the 50 MB L2, and does a few integer operations per word, so
// the launch is as fast as it keeps row loads in flight.
//
// Design (plane_reduce.cuh's loading discipline):
//   - grid sized to the card: at most kBlocksPerSM blocks an SM, each
//     taking a contiguous run of whole groups of kRows rows (8 without
//     counts, 2 with: about 24 plane loads a lane either way), a warp a
//     group at a time; a warp issues every load of its group's rows (kU
//     32-word chunks of each, clamped addresses) before it uses any;
//     __popc and a shuffle sum give each row's counts, one 16-byte store;
//   - the OR: each lane ORs the words it owns over its group's selected
//     rows in registers, then into the block's shared words (one shared
//     atomicOr a word a group, not a row);
//   - across blocks, with no fill and no global atomic on the words: the
//     blocks form clusters of up to 8 (cudaLaunchKernelEx), whose blocks
//     OR their words into the leader's through distributed shared memory
//     (after the cluster barrier each block arrives at once its words are
//     zeroed), one cluster.sync; a launch of one cluster (up to 8 blocks,
//     about 500 rows without counts) has its leader write or_words. Else
//     each leader stores its words to its row of a scratch buffer, and
//     the leader that takes the last ticket (an acq_rel atomic) folds
//     every row into or_words with plain stores and resets the ticket to
//     0: one ticket a cluster, where one a block serialised a hundred
//     same-address atomics. The ticket is zeroed once, when the wrapper
//     first allocates it for a (device, stream), never per launch.
//     Without with_or block 0 stores the zeros.
// A cluster launch the card refuses returns its error; the wrapper
// raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = plane_reduce::kU;  // 32-word chunks of a row a round
constexpr int kBlocksPerSM = 2;
constexpr int kCluster = 8;  // blocks of a cluster (the portable maximum)
constexpr int kFold = 16;  // scratch words a thread of the fold loads at once

namespace cg = cooperative_groups;

// Rows a warp reads at once: about 24 plane loads a lane at W = 79.
__host__ __device__ constexpr int group_rows(bool counts) {
  return counts ? 2 : 8;
}

// Blocks with rows of a launch over R rows on a card of n_sm SMs: whole
// groups of rows, about one group a warp, at most kBlocksPerSM an SM.
int grid_blocks(int R, bool counts, int n_sm) {
  const int groups = (R + group_rows(counts) - 1) / group_rows(counts);
  if (groups <= 0) return 1;  // no row: one block writes or_words
  int g = (groups + kWarps - 1) / kWarps;
  const int cap = n_sm > 0 ? kBlocksPerSM * n_sm : 1;
  g = g < cap ? g : cap;
  const int per = (groups + g - 1) / g;  // groups a block
  return (groups + per - 1) / per;
}

// Blocks of a cluster, and clusters, of a launch of `blocks` blocks with
// rows (the last cluster's blocks past them have none).
int cluster_blocks(int blocks) { return blocks < kCluster ? blocks : kCluster; }
int clusters(int blocks) {
  return (blocks + cluster_blocks(blocks) - 1) / cluster_blocks(blocks);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Ticket t's old value, t incremented with release and acquire at device
// scope: after the block's barrier, the block's stores are visible to the
// leader that takes a later ticket, and that leader sees every earlier
// taker's.
__device__ __forceinline__ unsigned take_ticket(unsigned* t) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(t)
               : "memory");
  return old;
}

struct Args {
  const uint32_t *gt, *gt2, *tok1, *tok2;
  const int32_t* rows;
  const int32_t* or_sel;
  const uint32_t* mask;
  int32_t* counts;
  uint32_t* or_words;
  uint32_t* partial;  // [clusters, W], with_or and more than one cluster
  unsigned* ticket;
  int R, W, per;  // per: rows of a block's run (whole groups)
  long long n_plane;
};

template <bool kCounts, bool kOr>
__global__ void __launch_bounds__(kThreads) plane_stats_kernel(Args p) {
  constexpr int kRows = group_rows(kCounts);
  extern __shared__ uint32_t smem[];
  uint32_t* s_mask = smem;    // [W]
  uint32_t* s_or = smem + p.W;  // [W]
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int W = p.W;
  plane_reduce::copy_words_async(s_mask, p.mask, W);
  if (kOr) {
    for (int w = tid; w < W; w += kThreads) s_or[w] = 0u;
  }
  plane_reduce::copy_wait();
  __syncthreads();
  if (kOr) cluster_arrive();  // this block's OR words are zeroed

  const int r0 = blockIdx.x * p.per;
  const int r1 = min(r0 + p.per, p.R);
  for (int i0 = r0 + warp * kRows; i0 < r1; i0 += kWarps * kRows) {
    size_t off[kRows];
    bool sel[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int i = min(i0 + j, r1 - 1);  // a repeat is neither kept nor ORed
      long long row = p.rows[i];
      row = row < 0 ? 0 : (row >= p.n_plane ? p.n_plane - 1 : row);
      off[j] = static_cast<size_t>(row) * static_cast<size_t>(W);
      sel[j] = kOr && i0 + j < r1 && p.or_sel[i] != 0;
    }
    uint32_t pc[kRows][4];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      pc[j][0] = pc[j][1] = pc[j][2] = pc[j][3] = 0u;
    }
    for (int w0 = 0; w0 < W; w0 += 32 * kU) {
      uint32_t g[kU][kRows], g2[kU][kRows], t1[kU][kRows], t2[kU][kRows];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (w0 + 32 * u >= W) break;  // warp-uniform
        const size_t w = min(w0 + 32 * u + lane, W - 1);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          g[u][j] = p.gt[off[j] + w];
          if constexpr (kCounts) {
            g2[u][j] = p.gt2[off[j] + w];
            t1[u][j] = p.tok1[off[j] + w];
            t2[u][j] = p.tok2[off[j] + w];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (w0 + 32 * u >= W) break;
        const int w = w0 + 32 * u + lane;
        const uint32_t m = w < W ? s_mask[w] : 0u;
        uint32_t v = 0u;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const uint32_t gm = g[u][j] & m;
          pc[j][0] += __popc(gm);
          if constexpr (kCounts) {
            pc[j][1] += __popc(g2[u][j] & m);
            pc[j][2] += __popc(t1[u][j] & m);
            pc[j][3] += __popc(t2[u][j] & m);
          }
          if (sel[j]) v |= gm;
        }
        if (kOr && v) atomicOr(&s_or[w], v);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      int4 c;
      c.x = static_cast<int>(plane_reduce::warp_sum_u(pc[j][0]));
      c.y = kCounts ? static_cast<int>(plane_reduce::warp_sum_u(pc[j][1])) : 0;
      c.z = kCounts ? static_cast<int>(plane_reduce::warp_sum_u(pc[j][2])) : 0;
      c.w = kCounts ? static_cast<int>(plane_reduce::warp_sum_u(pc[j][3])) : 0;
      if (lane == 0 && i0 + j < r1) {
        reinterpret_cast<int4*>(p.counts)[i0 + j] = c;
      }
    }
  }

  if constexpr (!kOr) {
    if (blockIdx.x == 0) {
      for (int w = tid; w < W; w += kThreads) p.or_words[w] = 0u;
    }
    return;
  }
  // the cluster's words into its leader's, through distributed shared
  // memory once every block of the cluster has zeroed its own
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // the block's OR words are complete
  cluster_wait();
  if (cluster.block_rank() != 0) {
    uint32_t* lead = cluster.map_shared_rank(s_or, 0);
    for (int w = tid; w < W; w += kThreads) {
      if (s_or[w]) atomicOr(&lead[w], s_or[w]);
    }
  }
  cluster.sync();  // the leader holds the cluster's words
  if (cluster.block_rank() != 0) return;
  const int n_clusters = gridDim.x / cluster.num_blocks();
  if (n_clusters == 1) {
    for (int w = tid; w < W; w += kThreads) p.or_words[w] = s_or[w];
    return;
  }
  const int me = blockIdx.x / cluster.num_blocks();
  uint32_t* mine = p.partial + static_cast<size_t>(me) * W;
  for (int w = tid; w < W; w += kThreads) mine[w] = s_or[w];
  __syncthreads();
  if (tid == 0) s_last = take_ticket(p.ticket) == n_clusters - 1;
  __syncthreads();
  if (!s_last) return;
  // the last leader: every cluster's words into s_or (which holds its
  // own), kFold scratch words a thread in flight, read from L2
  const int n = n_clusters * W;
  for (int k0 = tid; k0 < n; k0 += kFold * kThreads) {
    uint32_t v[kFold];
#pragma unroll
    for (int k = 0; k < kFold; ++k) {
      const int i = k0 + k * kThreads;
      v[k] = i < n ? __ldcg(p.partial + i) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kFold; ++k) {
      if (v[k]) atomicOr(&s_or[(k0 + k * kThreads) % W], v[k]);
    }
  }
  __syncthreads();
  for (int w = tid; w < W; w += kThreads) p.or_words[w] = s_or[w];
  if (tid == 0) *p.ticket = 0u;  // every leader has taken its ticket
}

template <bool kCounts, bool kOr>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.W) * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        plane_stats_kernel<kCounts, kOr>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int c = cluster_blocks(blocks);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters(blocks) * c));
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, plane_stats_kernel<kCounts, kOr>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Clusters of a launch over R rows on a card of n_sm SMs: the rows of
// the scratch buffer a launch with with_or needs (W words each; none at
// one cluster).
int plane_stats_clusters(int R, int with_counts, int n_sm) {
  return clusters(grid_blocks(R, with_counts != 0, n_sm));
}

// Launch one row set on `stream`. Every pointer is a device pointer to
// contiguous 32-bit data: gt, gt2, tok1, tok2 [n_plane, W], rows and
// or_sel [R], mask [W], counts [R, 4], or_words [W] (written by the
// launch), and with with_or, scratch [plane_stats_clusters(R, with_counts,
// n_sm), W] and the (device, stream)'s ticket, a word that is 0 between
// launches. Shared memory: 8 * W bytes (opt-in above 48 KB). Returns the
// launch's error (a refused cluster launch included), else
// cudaGetLastError() after it.
int plane_stats_launch(const void* gt, const void* gt2, const void* tok1,
                       const void* tok2, const void* rows, const void* or_sel,
                       const void* mask, void* counts, void* or_words,
                       void* scratch, void* ticket, int R, int W,
                       long long n_plane, int with_counts, int with_or,
                       int n_sm, void* stream) {
  const bool counts_on = with_counts != 0;
  const int blocks = grid_blocks(R, counts_on, n_sm);
  const int groups = (R + group_rows(counts_on) - 1) / group_rows(counts_on);
  Args a{};
  a.gt = static_cast<const uint32_t*>(gt);
  a.gt2 = static_cast<const uint32_t*>(gt2);
  a.tok1 = static_cast<const uint32_t*>(tok1);
  a.tok2 = static_cast<const uint32_t*>(tok2);
  a.rows = static_cast<const int32_t*>(rows);
  a.or_sel = static_cast<const int32_t*>(or_sel);
  a.mask = static_cast<const uint32_t*>(mask);
  a.counts = static_cast<int32_t*>(counts);
  a.or_words = static_cast<uint32_t*>(or_words);
  a.partial = static_cast<uint32_t*>(scratch);
  a.ticket = static_cast<unsigned*>(ticket);
  a.R = R;
  a.W = W;
  a.per = (groups + blocks - 1) / blocks * group_rows(counts_on);
  a.n_plane = n_plane;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (counts_on) {
    e = with_or ? launch<true, true>(a, blocks, s)
                : launch<true, false>(a, blocks, s);
  } else {
    e = with_or ? launch<false, true>(a, blocks, s)
                : launch<false, false>(a, blocks, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
