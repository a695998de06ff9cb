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
// What it computes, per query slot j (one block per output slot):
//   1. sid = shard - me * d_local from the slot's global shard id; the
//      entry owns the slot iff 0 <= sid < d_local; sid is clamped;
//   2. the per-query body of bisect_core.cuh over segment row
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
// query's cost is its two dependent searches); with planes, then the
// bytes of the matched rows' plane words (W words each, x4 with counts),
// from planes of GBs far above the 50 MB L2. Design: one 256-thread
// block per slot, the matched rows kept in shared memory from the search
// to the column gathers and the plane reduction, plane offsets 64-bit
// (a block's plane passes 4 GiB at 1000-Genomes width).

#include "bisect_core.cuh"
#include "plane_reduce.cuh"

namespace {

using namespace bisect;

constexpr int kMeshAgg = 5;
constexpr int kOwner = 0;
constexpr int kSliced = 1;

__host__ __device__ constexpr long long align16(long long x) {
  return (x + 15) / 16 * 16;
}

// Dynamic shared memory of one block: the search window and the R matched
// rows; with planes also flags, ac, an, rec_id and two scan buffers over
// the R lanes, the mask and the OR words (2 W) and or_sel (R bytes).
__host__ __device__ constexpr long long fused_smem(int Wwin, int R, int W,
                                                   bool planes) {
  return align16(window_smem(Wwin)) +
         (planes ? 28LL * R + 8LL * W + R : 4LL * R);
}

struct Args {
  const int32_t* cols;
  long long n_pad;
  const int32_t* alt_prefix;
  const int32_t* offsets;
  const int32_t* seg_base;
  int d_local, me;
  const int32_t* qpack;
  int n_slots, C, layout;
  int32_t* agg;
  int32_t* rows;
  const uint32_t *gt, *gt2, *tok1, *tok2, *masks;
  const int32_t* use_counts;
  int32_t *pc_call, *pc_tok;
  uint32_t* or_words;
  int Wwin, R, W;
  bool has_counts;
};

template <bool kPlanes>
__global__ void __launch_bounds__(kThreads) mesh_fused_kernel(Args p) {
  extern __shared__ int32_t smem[];
  int32_t* win = smem;
  int32_t* s_row = smem + align16(window_smem(p.Wwin)) / 4;
  const int R = p.R;
  const int W = p.W;
  // one block per output slot o; in the sliced layout only the slots
  // [me * C, me * C + n_slots) hold this entry's queries
  const size_t o = blockIdx.x;
  const int j = p.layout == kSliced ? static_cast<int>(o) - p.me * p.C
                                    : static_cast<int>(o);
  const int tid = threadIdx.x;
  const bool mine = j >= 0 && j < p.n_slots;
  const int32_t* qp = p.qpack + static_cast<size_t>(mine ? j : 0) * kQFields;
  const int sid = qp[QF_SHARD] - p.me * p.d_local;
  const bool owned = mine && sid >= 0 && sid < p.d_local;
  const int sidc = min(max(sid, 0), p.d_local - 1);
  const bool combine = p.layout != kOwner;
  int32_t* agg = p.agg + o * kMeshAgg;
  int32_t* rows = p.rows + o * R;

  if (!owned) {  // block-uniform: structural zeros, no search
    if (tid < kMeshAgg) agg[tid] = 0;
    for (int k = tid; k < R; k += kThreads) {
      rows[k] = combine ? 0 : -1;
      if (kPlanes) {
        p.pc_call[o * R + k] = 0;
        p.pc_tok[o * R + k] = 0;
      }
    }
    if (kPlanes) {
      for (int w = tid; w < W; w += kThreads) p.or_words[o * W + w] = 0u;
    }
    return;
  }

  const Agg a = query_block(p.cols, p.n_pad, p.alt_prefix,
                            p.offsets + static_cast<size_t>(sidc) * kSegs, qp,
                            p.Wwin, R, s_row, nullptr, win);
  if (tid == 0) {
    agg[0] = a.call_count;
    agg[1] = a.n_variants;
    agg[2] = a.all_alleles;
    agg[3] = a.n_matched;
    agg[4] = a.overflow ? 1 : 0;
  }
  const int32_t base = p.seg_base[sidc];
  for (int k = tid; k < R; k += kThreads) {
    const int32_t r = s_row[k];
    rows[k] = r >= 0 ? r - base + (combine ? 1 : 0) : (combine ? 0 : -1);
  }
  if (!kPlanes) return;

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
  __shared__ int32_t s_tot[kThreads];
  sc.tot = s_tot;

  const int n_valid = min(a.n_matched, R);
  for (int w = tid; w < W; w += kThreads) {
    s_mask[w] = p.masks[static_cast<size_t>(j) * W + w];
  }
  for (int k = tid; k < n_valid; k += kThreads) {
    const long long r = s_row[k];
    s_flags[k] = p.cols[C_FLAGS * p.n_pad + r];
    s_ac[k] = p.cols[C_AC * p.n_pad + r];
    s_an[k] = p.cols[C_AN * p.n_pad + r];
    s_rec[k] = p.cols[C_REC_ID * p.n_pad + r];
  }
  plane_reduce::reduce<kThreads>(
      p.gt, p.gt2, p.tok1, p.tok2, s_row, s_flags, s_ac, s_an, s_rec,
      n_valid, R, W, p.has_counts, p.use_counts[j] != 0, s_mask, sc,
      p.pc_call + o * R, p.pc_tok + o * R, p.or_words + o * W);
}

template <bool kPlanes>
int launch(const Args& args, int n_dev, void* stream) {
  if (args.n_slots <= 0) return static_cast<int>(cudaSuccess);
  const long long n_out = args.layout == kSliced
                              ? static_cast<long long>(n_dev) * args.C
                              : args.n_slots;
  const size_t smem =
      static_cast<size_t>(fused_smem(args.Wwin, args.R, args.W, kPlanes));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mesh_fused_kernel<kPlanes>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mesh_fused_kernel<kPlanes>
      <<<static_cast<unsigned>(n_out), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block takes (planes: 0 or 1).
long long mesh_fused_smem(int Wwin, int R, int W, int planes) {
  return fused_smem(Wwin, R, W, planes != 0);
}

// Match-only launch: one block of 256 threads per output slot on
// `stream`. Device pointers to contiguous int32 data: cols [11, n_pad],
// alt_prefix [n_pad, 4], offsets [d_local, 27], seg_base [d_local],
// qpack [n_slots, 24] (global shard ids); outputs agg [n_out, 5] and
// rows [n_out, R], n_out = n_dev * C in the sliced-combine layout (1: the
// entry's queries go to slots [me * C, me * C + n_slots), zeros to the
// rest), else n_slots (layouts 0 owner and 2 replicated). The launch
// writes every output slot. The caller guarantees 1 <= R <= Wwin.
// Returns cudaGetLastError() after the launch.
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
  return launch<false>(a, n_dev, stream);
}

// The launch with planes: as mesh_fused_launch, plus the block's planes
// gt/gt2/tok1/tok2 [n_pad, W] (gt for all four without counts), masks
// [n_slots, W], use_counts [n_slots] (0 or 1), and the outputs pc_call,
// pc_tok [n_out, R] and or_words [n_out, W].
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
  return launch<true>(a, n_dev, stream);
}

}  // extern "C"
