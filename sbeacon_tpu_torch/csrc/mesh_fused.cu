// Owner-sliced fused query kernel for Hopper (sm_90a): one mesh entry's
// part of the mesh-sharded fused index.
//
// Replaces sbeacon_tpu/parallel/mesh.py::_local_fused_query (mesh.py:1401),
// the per-device body of MeshFusedIndex.run_mesh_queries. Mesh entry
// `me` holds ONE fused block of the d_local dataset shards
// [me * d_local, (me + 1) * d_local): their columns concatenated over
// n_pad rows, a [d_local, 27] segment table in block-absolute rows, and
// seg_base[d_local], each shard's first block row. One launch answers
// the entry's query slots.
//
// What it computes, per query slot j (one cluster of blocks per output
// slot):
//   1. sid = shard - me * d_local from the slot's global shard id; the
//      entry owns the slot iff 0 <= sid < d_local;
//   2. the semantics of bisect_core.cuh's query_block over segment row
//      offsets[sid]: the aggregates and the first R matched block rows;
//   3. the aggregates {call_count, n_variants, all_alleles, n_matched,
//      overflow} masked by ownership (a slot the entry does not own
//      writes structural zeros and runs no search);
//   4. the rows rebased to dataset-local ids (row - seg_base[sid]);
//   5. with planes, plane_reduce.cuh over the matched rows under the
//      slot's own W-word sample mask and its own use_counts switch:
//      pc_call, pc_tok [R] and or_words [W];
//   6. its own output slot: j in the owner layout (raw rebased rows, -1
//      padded) and in the replicated layout, me * C + j of the [n_dev *
//      C] outputs in the sliced-combine layout, whose other slots (the
//      other entries') its launch fills with zeros. Both combine layouts
//      write rows + 1 (0 for padding and for non-owners), so that the
//      sum over entries, minus 1, is the owner's rows.
// The cross-entry sums (the psum and the ring gather) are the caller's.
//
// What bounds it on this card: latency, as for bisect_query (a point
// query's cost is its chain of dependent rounds: query row, segment row,
// search steps, lane loads); with planes, then the
// dependent HBM reads of the matched rows' plane words (W words each, x4
// with counts) from planes of GBs far above the 50 MB L2.
//
// Design, match-only: a cluster of c = min(8, ceil(Wwin / 256)) blocks
// per output slot, launched with cudaLaunchKernelEx (sm_90), running
// fused_match.cuh's match_slot, the body J3 (bisect_query.cu) runs too
// (its header gives the chain of rounds): block rank r takes window
// lanes [r L, r L + L), L = 256 for windows up to 2048 lanes; a window
// that fits rank 0's lanes (a point query's) is answered by rank 0 alone
// with no cluster barrier, a wider one through one exchange of
// summaries in distributed shared memory. A launch of 14 slots (phase
// 25's largest) is 112 blocks: one wave on 132 SMs. A slot the entry
// does not own is decided alike by every block of its cluster, which
// writes its share of the structural zeros and leaves before any
// cluster barrier.
//
// Design, with planes: a cluster of kCluster blocks per output slot,
// launched with cudaLaunchKernelEx and a cluster dimension (sm_90), so
// one slot's plane reads run on kCluster SMs:
//   1. the leader (rank 0) runs the search and the column gathers and
//      keeps the rows, their columns and n_valid in its shared memory;
//      cluster.sync;
//   2. every block copies its contiguous share of the leader's rows
//      through distributed shared memory and, with counts, reads their
//      four planes' words (plane_reduce::row_popcounts: kRB rows a warp,
//      every load of kU chunks issued before any is used), writes the
//      popcounts to the outputs and to the leader's shared memory, and
//      keeps its rows' masked gt words in a shared cache as far as they
//      fit; cluster.sync;
//   3. the leader computes rc and or_sel (plane_reduce::or_select: one
//      warp's shuffles for at most 32 valid lanes, else four scans in
//      log depth); cluster.sync;
//   4. every block lists its share's or_sel lanes from the leader by
//      ballots (plane_reduce::sel_list, no atomics), ORs those
//      rows' gt words (from its cache, else from the plane) into a local
//      accumulator and then into the leader's with remote atomicOr;
//      cluster.sync; the leader writes or_words.
// Only the leader's shared memory is read remotely, and it leaves last.
// What bounds this design: the leader's serial search and scans between
// the cluster barriers, then one or two rounds of dependent plane loads
// per block (kWarps * kRB rows in flight on each SM). A slot the entry
// does not own is decided alike in every block of its cluster: the
// leader writes its structural zeros and the cluster leaves together,
// before any barrier. Plane offsets are 64-bit (a block's plane passes
// 4 GiB at 1000-Genomes width). A launch the card refuses returns its
// error; there is no one-block fallback.

#include "fused_match.cuh"
#include "plane_reduce.cuh"

namespace {

using namespace bisect;
using fused_match::kMeshAgg;
using fused_match::kOwner;
using fused_match::kSliced;
namespace cg = cooperative_groups;

// blocks of one slot's cluster with planes (the portable maximum)
constexpr int kCluster = 8;
// dynamic shared memory a planes block may take with its gt cache
constexpr long long kSmemCap = 200 * 1024;

__host__ __device__ constexpr long long align16(long long x) {
  return (x + 15) / 16 * 16;
}

// Rows of one cluster block's share of the R lanes (with planes).
__host__ __device__ constexpr int share_rows(int R) {
  return (R + kCluster - 1) / kCluster;
}

// Dynamic shared memory of one planes block before its gt cache: the
// search window and, over the R lanes, the matched rows, flags, ac, an,
// rec_id, the two popcounts and two scan buffers, the mask and the OR
// words (2 W), the share's rows and or_sel list, and or_sel (R bytes).
__host__ __device__ constexpr long long planes_smem(int Wwin, int R, int W) {
  return align16(window_smem(Wwin)) +
         align16(36LL * R + 8LL * W + 8LL * share_rows(R) + R);
}

// Words of the gt cache: the share's rows' masked gt words (with counts
// only), as far as kSmemCap allows.
__host__ __device__ constexpr long long cache_words(int Wwin, int R, int W,
                                                    bool counts) {
  const long long room = (kSmemCap - planes_smem(Wwin, R, W)) / 4;
  const long long want = static_cast<long long>(share_rows(R)) * W;
  return !counts || room <= 0 ? 0 : (want < room ? want : room);
}

// Match-only: the block's matched rows (fused_match::match_smem).
__host__ __device__ constexpr long long fused_smem(int Wwin, int R, int W,
                                                   int planes) {
  if (planes == 0) {
    return fused_match::match_smem(Wwin, R, fused_match::match_blocks(Wwin));
  }
  return planes_smem(Wwin, R, W) + 4 * cache_words(Wwin, R, W, planes == 2);
}

// The match fields (fused_match::MatchArgs) and the planes'.
struct Args : fused_match::MatchArgs {
  const uint32_t *gt, *gt2, *tok1, *tok2, *masks;
  const int32_t* use_counts;
  int32_t *pc_call, *pc_tok;
  uint32_t* or_words;
  int W;
  bool has_counts;
  int cache_rows;
};

__global__ void __launch_bounds__(kThreads) mesh_fused_kernel(Args p) {
  fused_match::match_slot<false>(p);
}

__global__ void __launch_bounds__(kThreads) mesh_fused_planes_kernel(Args p) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t s_tot[kWarps];
  __shared__ int s_nvalid;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int R = p.R;
  const int W = p.W;
  const int S = share_rows(R);
  int32_t* win = smem;
  int32_t* s_row = smem + align16(window_smem(p.Wwin)) / 4;
  int32_t* s_flags = s_row + R;
  int32_t* s_ac = s_flags + R;
  int32_t* s_an = s_ac + R;
  int32_t* s_rec = s_an + R;
  int32_t* s_pcc = s_rec + R;
  int32_t* s_pct = s_pcc + R;
  int32_t* s_a = s_pct + R;
  int32_t* s_b = s_a + R;
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_b + R);
  uint32_t* s_acc = s_mask + W;
  int32_t* s_lrow = reinterpret_cast<int32_t*>(s_acc + W);
  int32_t* s_list = s_lrow + S;
  uint8_t* s_sel = reinterpret_cast<uint8_t*>(s_list + S);
  uint32_t* cache = reinterpret_cast<uint32_t*>(
      smem + planes_smem(p.Wwin, R, W) / 4);  // 16-byte aligned

  const int tid = threadIdx.x;
  const size_t o = blockIdx.x / kCluster;
  const int j = p.layout == kSliced ? static_cast<int>(o) - p.me * p.C
                                    : static_cast<int>(o);
  const bool mine = j >= 0 && j < p.n_slots;
  const int32_t* qp = p.qpack + static_cast<size_t>(mine ? j : 0) * kQFields;
  const int sid = qp[QF_SHARD] - p.me * p.d_local;
  const bool owned = mine && sid >= 0 && sid < p.d_local;
  const int sidc = min(max(sid, 0), p.d_local - 1);
  const bool combine = p.layout != kOwner;
  int32_t* agg = p.agg + o * kMeshAgg;
  int32_t* rows = p.rows + o * R;
  int32_t* pc_call = p.pc_call + o * R;
  int32_t* pc_tok = p.pc_tok + o * R;
  if (!owned) {  // cluster-uniform: the leader's zeros, no barrier
    if (rank == 0) {
      if (tid < kMeshAgg) agg[tid] = 0;
      for (int k = tid; k < R; k += kThreads) {
        rows[k] = combine ? 0 : -1;
        pc_call[k] = 0;
        pc_tok[k] = 0;
      }
      for (int w = tid; w < W; w += kThreads) p.or_words[o * W + w] = 0u;
    }
    return;
  }
  for (int w = tid; w < W; w += kThreads) {
    s_mask[w] = p.masks[static_cast<size_t>(j) * W + w];
    s_acc[w] = 0u;
  }
  if (rank == 0) {
    const Agg a = query_block(p.cols, p.n_pad, p.alt_prefix,
                              p.offsets + static_cast<size_t>(sidc) * kSegs,
                              qp, p.Wwin, R, s_row, nullptr, win);
    if (tid == 0) {
      agg[0] = a.call_count;
      agg[1] = a.n_variants;
      agg[2] = a.all_alleles;
      agg[3] = a.n_matched;
      agg[4] = a.overflow ? 1 : 0;
      s_nvalid = min(a.n_matched, R);
    }
    const int32_t base = p.seg_base[sidc];
    for (int k = tid; k < R; k += kThreads) {
      const long long r = s_row[k];
      rows[k] = r >= 0 ? r - base + (combine ? 1 : 0) : (combine ? 0 : -1);
      if (k < a.n_matched) {
        s_flags[k] = p.cols[C_FLAGS * p.n_pad + r];
        s_ac[k] = p.cols[C_AC * p.n_pad + r];
        s_an[k] = p.cols[C_AN * p.n_pad + r];
        s_rec[k] = p.cols[C_REC_ID * p.n_pad + r];
      }
    }
  }
  cluster.sync();  // 1. the leader's rows, columns and n_valid

  const int n_valid = *cluster.map_shared_rank(&s_nvalid, 0);
  const int32_t* l_row = cluster.map_shared_rank(s_row, 0);
  int32_t* l_pcc = cluster.map_shared_rank(s_pcc, 0);
  int32_t* l_pct = cluster.map_shared_rank(s_pct, 0);
  const uint8_t* l_sel = cluster.map_shared_rank(s_sel, 0);
  uint32_t* l_acc = cluster.map_shared_rank(s_acc, 0);
  const int share = (n_valid + kCluster - 1) / kCluster;
  const int lo = min(rank * share, n_valid);
  const int n = min(lo + share, n_valid) - lo;
  for (int i = tid; i < n; i += kThreads) s_lrow[i] = l_row[lo + i];
  __syncthreads();
  if (p.has_counts) {
    plane_reduce::row_popcounts<kThreads>(
        p.gt, p.gt2, p.tok1, p.tok2, s_lrow, n, W, s_mask, cache,
        p.cache_rows, [&](int i, uint32_t c, uint32_t t) {
          const int k = lo + i;
          pc_call[k] = static_cast<int32_t>(c);
          pc_tok[k] = static_cast<int32_t>(t);
          l_pcc[k] = static_cast<int32_t>(c);
          l_pct[k] = static_cast<int32_t>(t);
        });
    cluster.sync();  // 2. the popcounts are in the leader
  }

  if (rank == 0) {
    const bool use_counts = p.has_counts && p.use_counts[j] != 0;
    for (int k = tid; k < R; k += kThreads) {
      if (k >= n_valid || !p.has_counts) {
        pc_call[k] = 0;
        pc_tok[k] = 0;
      }
      if (k < n_valid && use_counts && !(s_flags[k] & plane_reduce::F_AC_INFO)) {
        s_ac[k] = s_pcc[k];
      }
    }
    plane_reduce::or_select<kThreads>(s_ac, s_rec, n_valid, R, s_a, s_b,
                                      s_sel, s_tot);
  }
  cluster.sync();  // 3. or_sel is in the leader

  const int n_list = plane_reduce::sel_list(l_sel + lo, n, s_list);
  plane_reduce::or_rows<kThreads>(p.gt, s_lrow, s_list, n_list, W, s_mask,
                                  cache, p.has_counts ? p.cache_rows : 0,
                                  s_acc);
  __syncthreads();
  if (rank != 0) {
    for (int w = tid; w < W; w += kThreads) {
      if (s_acc[w]) atomicOr(&l_acc[w], s_acc[w]);
    }
  }
  cluster.sync();  // 4. every block's OR is in the leader
  if (rank == 0) {
    for (int w = tid; w < W; w += kThreads) p.or_words[o * W + w] = s_acc[w];
  }
}

int launch_match(const Args& args, int n_dev, void* stream) {
  if (args.n_slots <= 0) return static_cast<int>(cudaSuccess);
  const long long n_out = args.layout == kSliced
                              ? static_cast<long long>(n_dev) * args.C
                              : args.n_slots;
  return static_cast<int>(stacked::launch_clusters(
      mesh_fused_kernel, static_cast<int>(n_out),
      fused_match::match_blocks(args.Wwin),
      static_cast<size_t>(fused_smem(args.Wwin, args.R, args.W, 0)),
      static_cast<cudaStream_t>(stream), args));
}

int launch_planes(Args args, int n_dev, void* stream) {
  if (args.n_slots <= 0) return static_cast<int>(cudaSuccess);
  const long long n_out = args.layout == kSliced
                              ? static_cast<long long>(n_dev) * args.C
                              : args.n_slots;
  const int planes = args.has_counts ? 2 : 1;
  const size_t smem =
      static_cast<size_t>(fused_smem(args.Wwin, args.R, args.W, planes));
  args.cache_rows = static_cast<int>(
      cache_words(args.Wwin, args.R, args.W, args.has_counts) / args.W);
  cudaError_t e = cudaFuncSetAttribute(
      mesh_fused_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_out * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, mesh_fused_planes_kernel, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block takes (planes: 0 match-only, 1 with
// planes and no counts, 2 with counts).
long long mesh_fused_smem(int Wwin, int R, int W, int planes) {
  return fused_smem(Wwin, R, W, planes);
}

// Match-only launch: one cluster of min(8, ceil(Wwin / 256)) blocks of
// 256 threads per output slot on `stream`. Device pointers to contiguous
// int32 data: cols [11, n_pad], alt_prefix [n_pad, 4], offsets
// [d_local, 27], seg_base [d_local],
// qpack [n_slots, 24] (global shard ids); outputs agg [n_out, 5] and
// rows [n_out, R], n_out = n_dev * C in the sliced-combine layout (1: the
// entry's queries go to slots [me * C, me * C + n_slots), zeros to the
// rest), else n_slots (layouts 0 owner and 2 replicated). The launch
// writes every output slot. The caller guarantees 1 <= R <= Wwin.
// Returns the launch's error, a refused cluster launch included.
int mesh_fused_launch(const void* cols, long long n_pad,
                      const void* alt_prefix, const void* offsets,
                      const void* seg_base, int d_local, int me, int n_dev,
                      const void* qpack, int n_slots, int C, int layout,
                      void* agg, void* rows, int Wwin, int R, void* stream) {
  Args a{};
  a.cols = static_cast<const int32_t*>(cols);
  a.n_pad = n_pad;
  a.alt_prefix = static_cast<const int32_t*>(alt_prefix);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.seg_base = static_cast<const int32_t*>(seg_base);
  a.d_local = d_local;
  a.me = me;
  a.qpack = static_cast<const int32_t*>(qpack);
  a.n_slots = n_slots;
  a.C = C;
  a.layout = layout;
  a.agg = static_cast<int32_t*>(agg);
  a.rows = static_cast<int32_t*>(rows);
  a.Wwin = Wwin;
  a.R = R;
  a.W = 0;
  return launch_match(a, n_dev, stream);
}

// The launch with planes, a cluster of 8 blocks of 256 threads per output
// slot: as mesh_fused_launch, plus the block's planes
// gt/gt2/tok1/tok2 [n_pad, W] (gt for all four without counts), masks
// [n_slots, W], use_counts [n_slots] (0 or 1), and the outputs pc_call,
// pc_tok [n_out, R] and or_words [n_out, W]. Returns the launch's error,
// a refused cluster launch included.
int mesh_fused_planes_launch(const void* cols, long long n_pad,
                             const void* alt_prefix, const void* offsets,
                             const void* seg_base, int d_local, int me,
                             int n_dev, const void* qpack, int n_slots,
                             int C,
                             int layout, void* agg, void* rows,
                             const void* gt, const void* gt2,
                             const void* tok1, const void* tok2,
                             const void* masks, const void* use_counts,
                             void* pc_call, void* pc_tok, void* or_words,
                             int Wwin, int R, int W, int has_counts,
                             void* stream) {
  Args a{};
  a.cols = static_cast<const int32_t*>(cols);
  a.n_pad = n_pad;
  a.alt_prefix = static_cast<const int32_t*>(alt_prefix);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.seg_base = static_cast<const int32_t*>(seg_base);
  a.d_local = d_local;
  a.me = me;
  a.qpack = static_cast<const int32_t*>(qpack);
  a.n_slots = n_slots;
  a.C = C;
  a.layout = layout;
  a.agg = static_cast<int32_t*>(agg);
  a.rows = static_cast<int32_t*>(rows);
  a.gt = static_cast<const uint32_t*>(gt);
  a.gt2 = static_cast<const uint32_t*>(gt2);
  a.tok1 = static_cast<const uint32_t*>(tok1);
  a.tok2 = static_cast<const uint32_t*>(tok2);
  a.masks = static_cast<const uint32_t*>(masks);
  a.use_counts = static_cast<const int32_t*>(use_counts);
  a.pc_call = static_cast<int32_t*>(pc_call);
  a.pc_tok = static_cast<int32_t*>(pc_tok);
  a.or_words = static_cast<uint32_t*>(or_words);
  a.Wwin = Wwin;
  a.R = R;
  a.W = W;
  a.has_counts = has_counts != 0;
  return launch_planes(a, n_dev, stream);
}

}  // extern "C"
