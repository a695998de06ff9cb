// The window match of one query slot by a cluster of blocks (sm_90a),
// shared by the match-only owner-sliced fused query (mesh_fused.cu, J6)
// and the fused-stack bisection query (bisect_query.cu, J3).
//
// What it computes, per slot: the semantics of bisect_core.cuh's
// query_block (its header says what that computes) over the slot's
// segment row: the aggregates {call_count, n_variants, all_alleles,
// n_matched, overflow} and the first R matched rows, ascending. The two
// forms differ only around that:
//   - J6 (kBisect false): the slot's shard id is global; the entry owns
//     it iff 0 <= shard - me * d_local < d_local, and a slot it does not
//     own writes structural zeros; rows are rebased by seg_base[sid];
//     the three layouts of mesh_fused.cu place the outputs (agg [n_out,
//     5], rows [n_out, R]);
//   - J3 (kBisect true): every slot is owned, the shard id clamps into
//     [0, d_local) like an XLA gather, rows are stacked row ids (no
//     rebase), and slot q writes out[q] = {exists, the five aggregates,
//     R rows} (agg [n_slots, 6 + R]).
//
// The chain of dependent rounds a slot runs:
//   1. the query row (stacked::load_query) and, when the segment table
//      (and J6's seg_base) fit the block's threads (at most 9 shards),
//      every segment row in the same round, one word a thread, into
//      shared memory, where the slot's row is picked; a wider table loads
//      the slot's row after the query row, one round more;
//   2. the window [lo, hi) by stacked::block_window (128 probes a step:
//      3 steps on a chr1-sized segment). Every block of the cluster
//      searches for itself: the same few probes from 8 SMs cost no more
//      time than one;
//   3. block rank r of the c-block cluster takes window lanes [r L, r L +
//      L), L = ceil(chunks / c) 256-lane chunks, a chunk a round: each
//      thread loads its lane (stacked::load_lane: every column the query's
//      modes need, with rec_id, AC and AN) in one round; a ballot and a
//      prefix over the block's warps place each match among the block's
//      matches (rows kept in shared memory), and its record's first match
//      is decided
//      from the previous matched lane: within the warp by ballot and
//      shuffle, else the last matched rec_id of the warps (and chunks)
//      before it (rec_id is nondecreasing inside a segment, so the
//      previous match shares the lane's rec_id iff an earlier lane of its
//      record matched: query_block's rule, with no walk back). The
//      block's first match is provisionally first;
//   4. a window of at most L lanes lies in rank 0 alone (every block
//      finds the same window, so all decide alike): the other ranks write
//      the padding past rank 0's lanes and leave, and rank 0 writes the
//      rest of the slot with no cluster barrier. Otherwise each
//      block's summary (match count, three sums, its first match's rec_id
//      and AN, its last match's rec_id) goes into every block of the
//      cluster through distributed shared memory (after the cluster
//      barrier each block arrives at when it starts), then one
//      cluster.sync. Every block takes its exclusive prefix over the ranks
//      (its offset into the first R rows) and writes its rows and its
//      share of the padding; the leader sums the ranks' summaries, taking
//      back the AN of a rank's first match where the nearest earlier rank
//      with matches ended on the same record, and writes the aggregates.
//      No block reads another's shared memory, so none waits for the
//      others to leave; no atomics, no fill.

#pragma once

#include "stacked_core.cuh"

namespace fused_match {

using namespace bisect;
namespace cg = cooperative_groups;

constexpr int kMeshAgg = 5;  // J6's aggregates: no exists column
constexpr int kOwner = 0;
constexpr int kSliced = 1;

// 256-lane chunks of a window of Wwin lanes
__host__ __device__ constexpr int chunks_of(int Wwin) {
  return (Wwin + kThreads - 1) / kThreads;
}

// Blocks of a cluster that gives each block one chunk up to 8 chunks.
__host__ __device__ constexpr int match_blocks(int Wwin) {
  return chunks_of(Wwin) < stacked::kMaxCluster ? chunks_of(Wwin)
                                                : stacked::kMaxCluster;
}

// Window lanes each block of a c-block cluster takes (whole chunks).
__host__ __device__ constexpr int block_lanes(int Wwin, int c) {
  return (chunks_of(Wwin) + c - 1) / c * kThreads;
}

// Dynamic shared memory of one block: its matched rows, at most
// min(its lanes, R).
__host__ __device__ constexpr long long match_smem(int Wwin, int R, int c) {
  return 4LL * (block_lanes(Wwin, c) < R ? block_lanes(Wwin, c) : R);
}

struct MatchArgs {
  const int32_t* cols;
  long long n_pad;
  const int32_t* alt_prefix;
  const int32_t* offsets;
  const int32_t* seg_base;  // J6 only
  int d_local, me;
  const int32_t* qpack;
  int n_slots, C, layout;  // C and layout: J6 only
  int32_t* agg;
  int32_t* rows;  // J6 only (J3's rows follow each slot's aggregates)
  int Wwin, R;
};

// One rank's summary for the cluster (uint32 words): its match count,
// the three sums (all_alleles counting its first match as first), its
// first match's rec_id and AN, its last match's rec_id.
constexpr int kFan = 7;
enum {
  FAN_COUNT,
  FAN_CALLS,
  FAN_VARIANTS,
  FAN_ALLELES,
  FAN_FIRST_REC,
  FAN_FIRST_AN,
  FAN_LAST_REC
};

// A slot the entry does not own (J6): structural zeros, this block's
// share of them (block rank of c).
__device__ __forceinline__ void zero_slot(int32_t* agg, int32_t* rows, int R,
                                          bool combine, int rank, int c) {
  if (rank == 0 && threadIdx.x < kMeshAgg) agg[threadIdx.x] = 0;
  for (int k = rank * kThreads + threadIdx.x; k < R; k += c * kThreads) {
    rows[k] = combine ? 0 : -1;
  }
}

// The slot of this block's cluster (blockIdx.x / c), by every thread of
// every block of a cluster of c blocks, launched with match_smem(Wwin,
// R, c) bytes of dynamic shared memory.
template <bool kBisect>
__device__ __forceinline__ void match_slot(const MatchArgs p) {
  extern __shared__ int32_t s_row[];       // this block's matched rows
  __shared__ int32_t s_seg[kThreads];      // segment table (+ seg_base)
  __shared__ uint32_t s_fan[stacked::kMaxCluster][kFan];  // every rank's
  __shared__ uint32_t s_mine[kFan];
  __shared__ int s_wcount[kWarps];
  __shared__ int32_t s_wlast[kWarps];
  __shared__ uint32_t s_part[kWarps][3];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int R = p.R;
  const size_t o = blockIdx.x / c;
  int j = static_cast<int>(o);
  bool combine = false;
  int32_t* agg;
  int32_t* rows;
  if constexpr (kBisect) {
    agg = p.agg + o * (kAgg + R);
    rows = agg + kAgg;
  } else {
    if (p.layout == kSliced) j -= p.me * p.C;
    combine = p.layout != kOwner;
    agg = p.agg + o * kMeshAgg;
    rows = p.rows + o * R;
  }
  const bool mine = j >= 0 && j < p.n_slots;

  // 1. the query row, and (at most 9 shards) the segment table (and
  // seg_base) beside it, one word a thread
  const int32_t* qp = p.qpack + static_cast<size_t>(mine ? j : 0) * kQFields;
  const int n_seg = p.d_local * kSegs;
  const int n_words = kBisect ? n_seg : n_seg + p.d_local;
  const bool table = n_words <= kThreads;
  int32_t word = 0;
  if (table && tid < n_words) {
    word = tid < n_seg ? p.offsets[tid] : p.seg_base[tid - n_seg];
  }
  const stacked::Query qv = stacked::load_query(qp);
  int sid;
  if constexpr (kBisect) {
    sid = min(max(qp[QF_SHARD], 0), p.d_local - 1);
  } else {
    sid = qp[QF_SHARD] - p.me * p.d_local;
    if (!(mine && sid >= 0 && sid < p.d_local)) {  // cluster-uniform
      zero_slot(agg, rows, R, combine, rank, c);
      return;
    }
  }
  stacked::cluster_arrive_relaxed();  // this block has started
  s_seg[tid] = word;
  __syncthreads();
  const int32_t* seg = table ? s_seg + sid * kSegs
                             : p.offsets + static_cast<size_t>(sid) * kSegs;
  int32_t base = 0;
  if constexpr (!kBisect) base = table ? s_seg[n_seg + sid] : p.seg_base[sid];

  // 2. the window, by every block
  const int2 bounds = stacked::block_window(p.cols, seg, qv);
  const int lo = bounds.x;
  const int hi = bounds.y;
  const int n_valid = max(0, min(hi - lo, p.Wwin));
  const int L = block_lanes(p.Wwin, c);
  // every lane in rank 0: it answers the slot alone and no block waits
  // at the cluster barrier (cluster-uniform); the other ranks pad the
  // rows past its lanes, which no match reaches
  const bool solo = n_valid <= L;
  if (solo && rank != 0) {
    for (int k = L + (rank - 1) * kThreads + tid; k < R;
         k += (c - 1) * kThreads) {
      rows[k] = combine ? 0 : -1;
    }
    return;
  }
  const int l_end = min(rank * L + L, n_valid);

  // 3. this block's lanes, 256 at a time
  uint32_t call_count = 0, n_variants = 0, all_alleles = 0;
  int n_kept = 0;    // block-uniform: this block's matches so far
  int last_rec = 0;  // block-uniform: the rec_id of the last of them
  for (int l0 = rank * L; l0 < l_end; l0 += kThreads) {
    const int l = l0 + tid;
    bool m = false;
    stacked::Lane v{};
    if (l < l_end) {
      v = stacked::load_lane(qv, p.cols, p.n_pad, p.alt_prefix,
                             static_cast<long long>(lo) + l);
      m = stacked::lane_match(qv, v);
    }
    const unsigned ball = __ballot_sync(0xffffffffu, m);
    const unsigned lower = ball & ((1u << lane) - 1u);
    const int prev = __shfl_sync(0xffffffffu, v.rec_id,
                                 lower ? 31 - __clz(lower) : 0);
    const int wlast = __shfl_sync(0xffffffffu, v.rec_id,
                                  ball ? 31 - __clz(ball) : 0);
    if (lane == 0) {
      s_wcount[warp] = __popc(ball);
      s_wlast[warp] = wlast;
    }
    __syncthreads();
    int before = 0, total = 0;
    bool have = n_kept > 0;  // a match before this warp, in this block
    int carry = last_rec;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cw = s_wcount[w];
      if (w < warp && cw) {
        before += cw;
        have = true;
        carry = s_wlast[w];
      }
      total += cw;
    }
    if (m) {
      const int k = n_kept + before + __popc(lower);
      if (k < R) s_row[k] = lo + l;
      call_count += static_cast<uint32_t>(v.ac);
      n_variants += v.ac != 0 ? 1u : 0u;
      bool first;
      if (lower) {
        first = prev != v.rec_id;
      } else if (have) {
        first = carry != v.rec_id;
      } else {  // the block's first match
        first = true;
        s_mine[FAN_FIRST_REC] = static_cast<uint32_t>(v.rec_id);
        s_mine[FAN_FIRST_AN] = static_cast<uint32_t>(v.an);
      }
      if (first) all_alleles += static_cast<uint32_t>(v.an);
    }
    for (int w = kWarps - 1; w >= 0; --w) {
      if (s_wcount[w]) {
        last_rec = s_wlast[w];
        break;
      }
    }
    n_kept += total;
    __syncthreads();  // s_wcount is rewritten by the next chunk
  }

  // 4. the summary (into every block, unless rank 0 is alone), then
  // offsets, rows and sums
  uint32_t sums[3] = {call_count, n_variants, all_alleles};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sums[i] = warp_sum(sums[i]);
    if (lane == 0) s_part[warp][i] = sums[i];
  }
  __syncthreads();
  if (tid < 3) {
    uint32_t t = 0;
    for (int w = 0; w < kWarps; ++w) t += s_part[w][tid];
    s_mine[FAN_CALLS + tid] = t;
  } else if (tid == 3) {
    s_mine[FAN_COUNT] = static_cast<uint32_t>(n_kept);
    s_mine[FAN_LAST_REC] = static_cast<uint32_t>(last_rec);
  }
  __syncthreads();
  int prefix = 0, total = n_kept, ranks = 1, stride = 1, first_pad = 0;
  int pad_end = min(L, R);  // alone, rank 0 pads up to its lanes' end
  if (!solo) {
    stacked::cluster_wait();  // every block has started
    if (tid < c * kFan) {
      const int to = tid / kFan;
      const int k = tid - to * kFan;
      *cluster.map_shared_rank(&s_fan[rank][k], to) = s_mine[k];
    }
    cluster.sync();  // every rank's summary is in every block
    total = 0;
    for (int r = 0; r < c; ++r) {
      const int n = static_cast<int>(s_fan[r][FAN_COUNT]);
      prefix += r < rank ? n : 0;
      total += n;
    }
    ranks = c;
    stride = c;
    first_pad = rank;
    pad_end = R;
  }
  const int32_t shift = combine ? 1 : 0;
  for (int k = tid; k < n_kept && prefix + k < R; k += kThreads) {
    rows[prefix + k] = s_row[k] - base + shift;
  }
  for (int k = min(total, R) + first_pad * kThreads + tid; k < pad_end;
       k += stride * kThreads) {
    rows[k] = combine ? 0 : -1;
  }
  if (rank == 0 && tid == 0) {
    uint32_t calls = 0, variants = 0, alleles = 0;
    bool have = false;
    uint32_t carry = 0;  // the last matched rec_id of the ranks so far
    for (int r = 0; r < ranks; ++r) {
      const uint32_t* f = solo ? s_mine : s_fan[r];
      calls += f[FAN_CALLS];
      variants += f[FAN_VARIANTS];
      alleles += f[FAN_ALLELES];
      if (f[FAN_COUNT] == 0) continue;
      if (have && carry == f[FAN_FIRST_REC]) alleles -= f[FAN_FIRST_AN];
      have = true;
      carry = f[FAN_LAST_REC];
    }
    int32_t* a = agg;
    if constexpr (kBisect) {
      agg[0] = static_cast<int32_t>(calls) > 0 ? 1 : 0;
      a = agg + 1;
    }
    a[0] = static_cast<int32_t>(calls);
    a[1] = static_cast<int32_t>(variants);
    a[2] = static_cast<int32_t>(alleles);
    a[3] = total;
    a[4] = (hi - lo) > p.Wwin ? 1 : 0;
  }
}

}  // namespace fused_match
