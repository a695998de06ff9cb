// Scatter match kernel for Hopper (sm_90a).
//
// Replaces sbeacon_tpu/ops/scatter_kernel.py::_scatter_core /
// _scatter_batch / _scatter_many (the XLA gather program that answers
// every single-dataset variant query on the accelerator). One launch
// covers every padded query slot of one (tier, exact) split: the grid
// axis takes the place of _scatter_many's lax.map over chunks.
//
// Per query slot q: the semantics of scatter_core.cuh (the predicate
// stack and agg[q]), then masks[q][w] bit b = lane w*16 + b matched.
//
// What bounds it on this card: at a full batch (2048 slots) bytes and
// the loads in flight: a query reads C * 3.5 KB of tile rows (T = 128)
// from random places of the packed index (about 640 MB at 2e7 rows, far
// above the 50 MB L2); at the main path's shape (64 slots, about 6 of
// them real) the latency of each slot's dependent rounds. Tensor cores
// (wgmma) have no role.
//
// Design: one block per slot, every load of the window in one round.
//   1. The slot's query row and tile id. The window's valid lanes are
//      [a, b) = [lo, min(hi, lo + CAP)) - tile0 * T, clipped to the span
//      (all of the span when tile0 * T + span could wrap int32, where the
//      lanes' own test decides). A slot with no valid lane (hi <= lo: a
//      pad slot of _launch_tier, an empty window) writes its aggregate
//      row (overflow (hi - lo) > CAP) and zero mask words and reads no
//      tile.
//   2. The columns of the valid lanes in one round, by one of two routes
//      chosen by the span:
//      - up to 2048 lanes (C = 1, 2, 5 at T = 128): each valid lane's
//        seven packed rows (rec_end .. AN) straight into registers, tile
//        ids clamped like an XLA gather, every load of a thread issued
//        before any is used; one 32-lane group a warp up to 256 lanes
//        (4 and 8 warps), two beyond (C = 5: 10 warps), so that a full
//        batch keeps enough blocks resident;
//      - wider (C = 17): thread 0 arms one mbarrier with the bytes to
//        come, then each of the first threads issues one Hopper bulk copy
//        (cp.async.bulk ... mbarrier::complete_tx::bytes) of rows 1-7 of
//        one window tile (clamped), only the 16-byte-aligned part of the
//        row over [a, b), into shared memory laid out [C][7][T]; every
//        copy is issued before anyone waits. 14 warps take the 68 groups
//        (at most 5 a warp), so three blocks (60 KB of shared memory
//        each) fit an SM.
//      Each route is the one that measured faster for its tiers on the
//      H100 (PERF.md): at C = 17 register loads of several lanes a
//      thread leave too few blocks resident for a full batch, and at the
//      small tiers the bulk copies measured slower than plain loads.
//   3. Per 32-lane group: the predicate per valid lane, ballots of the
//      match and of SAME_PREV over the valid lanes; lanes 0 and 1 write
//      mask words 2g and 2g + 1 (16 lanes a word: the halves of the match
//      ballot) and lane 0 keeps both ballots in shared memory.
//   4. After one barrier, the first-match rule from the ballots: a
//      matched lane is first iff no lane of its chain before it matched
//      (the lanes from the last chain start at or before it in its
//      group); a chain that enters the group at lane 0 carries whether
//      it matched in earlier groups, read back over their ballots until
//      a chain start (lanes outside [a, b) start chains, so the walk ends
//      at the window). AN came in the round of step 2, so it needs no
//      second global round; lanes before lo never match, so stopping at
//      the window's first lane changes nothing.
//   5. The five sums by warp shuffles and one pass over the warps.

#include "scatter_core.cuh"

namespace {

using namespace scatter;

constexpr int kMaxThreads = 1024;
constexpr int kRows = kPacked - 1;  // rows 1-7 of a tile (pos is not read)
// warps of a bulk-copy block
constexpr int kCopyWarps = 16;

// The route of tier (C, T): the 32-lane groups each thread takes straight
// into registers (1 up to 256 lanes, 2 up to 2048), or 0 for the bulk
// copies.
__host__ __device__ constexpr int reg_groups(int C, int T) {
  return C * T <= 256 ? 1 : (C * T <= 2048 ? 2 : 0);
}

// Dynamic shared memory of one block: the match and SAME_PREV ballots of
// the C*T/32 groups, and on the bulk route rows 1-7 of the C tiles.
__host__ __device__ constexpr long long match_smem(int C, int T) {
  return (reg_groups(C, T) ? 0 : 4LL * kRows * C * T) + 8LL * (C * T / 32);
}

// Warps of one block: the groups over reg_groups a warp on the register
// route; on the bulk route up to kCopyWarps, as few as keep every warp's
// groups within one of each other.
__host__ __device__ constexpr int match_warps(int C, int T) {
  const int groups = C * T / 32;
  const int k = reg_groups(C, T);
  const int per = k ? k : (groups + kCopyWarps - 1) / kCopyWarps;
  return (groups + per - 1) / per;
}

// A slot's packed query (pack_q8), decoded once per block.
struct SlotQuery {
  int lo, hi, end_min, end_max, ref_hash, alt_hash, ref_len, min_len,
      alt_len, max_len, mode, vt;
  bool ref_wild;
};

__device__ __forceinline__ SlotQuery load_slot(
    const int32_t* __restrict__ qp) {
  SlotQuery q;
  q.lo = qp[Q_LO];
  q.hi = qp[Q_HI];
  q.end_min = qp[Q_END_MIN];
  q.end_max = qp[Q_END_MAX];
  q.ref_hash = qp[Q_REF_HASH];
  q.alt_hash = qp[Q_ALT_HASH];
  const uint32_t meta = static_cast<uint32_t>(qp[Q_META]);
  const uint32_t lens_q = static_cast<uint32_t>(qp[Q_LENS]);
  q.ref_wild = (meta & 1u) != 0;
  q.mode = static_cast<int>((meta >> 1) & 3u);
  q.vt = static_cast<int>((meta >> 3) & 7u);
  q.ref_len = static_cast<int>((meta >> 6) & 0x1FFFu);
  q.min_len = static_cast<int>((meta >> 19) & 0x1FFFu);
  q.alt_len = static_cast<int>(lens_q & 0xFFFFu);
  q.max_len = static_cast<int>((lens_q >> 16) & 0xFFFFu);
  if (q.max_len == 0xFFFF) q.max_len = 0x7fffffff;
  return q;
}

// The predicate of one window lane from its packed columns, the window
// bracket aside (the caller ANDs it in): match_window's, which J2 keeps
// inline (sharing this function measured J2's point query 2% slower on
// the H100).
template <bool kExactOnly>
__device__ __forceinline__ bool lane_match(const SlotQuery& q, int rec_end,
                                           int ref_hash, int alt_hash,
                                           uint32_t lens, int flags) {
  const int alt_len = static_cast<int>(lens & 0xFFFFu);
  const int ref_len = static_cast<int>((lens >> 16) & 0x1FFFu);
  const bool end_ok = q.end_min <= rec_end && rec_end <= q.end_max;
  const bool ref_ok =
      q.ref_wild || (ref_hash == q.ref_hash && ref_len == q.ref_len);
  const bool len_ok = q.min_len <= alt_len && alt_len <= q.max_len;
  const bool exact_ok = alt_hash == q.alt_hash && alt_len == q.alt_len;

  bool alt_ok;
  if (kExactOnly) {
    alt_ok = exact_ok;
  } else if (q.mode == MODE_EXACT) {
    alt_ok = exact_ok;
  } else if (q.mode == MODE_ANY_BASE) {
    alt_ok = (flags & F_SINGLE_BASE) != 0;
  } else {
    const bool sym = (flags & F_SYMBOLIC) != 0;
    const int k = ((flags >> 19) & 0x7F) - 1;
    auto f = [flags](int bit) { return (flags & bit) != 0; };
    switch (q.vt) {
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
  return end_ok && ref_ok && len_ok && alt_ok;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Thread 0's one arrival, announcing the bytes the copies will bring.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Lanes [t0, t1) of tile c of the window holding lanes [a, b), widened
// to whole 16-byte chunks.
__device__ __forceinline__ int2 tile_lanes(int c, int T, int a, int b) {
  const int t0 = max(a - c * T, 0) & ~3;
  const int t1 = (min(b - c * T, T) + 3) & ~3;
  return make_int2(t0, t1);
}

// kGroups: the groups a thread takes into registers (reg_groups), or 0
// for the bulk-copy route, whose blocks are declared at most 512 threads:
// declared at 1024, its full C = 17 batch measured 18% slower on the H100.
template <bool kExactOnly, int kGroups>
__global__ void __launch_bounds__(kGroups ? kMaxThreads : kCopyWarps * 32)
    scatter_match_kernel(
    const int32_t* __restrict__ tiles, const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ q8, int32_t* __restrict__ agg,
    int32_t* __restrict__ masks, int n_tiles, int T, int C, int cap) {
  constexpr bool kCopy = kGroups == 0;
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ uint64_t s_bar;
  __shared__ uint32_t s_part[kMaxThreads / 32][kSums];
  const int span = C * T;
  const int groups = span / 32;
  int32_t* s_win = smem;  // [C][kRows][T] on the bulk route
  uint32_t* s_mb =
      reinterpret_cast<uint32_t*>(smem + (kCopy ? kRows * span : 0));
  uint32_t* s_sb = s_mb + groups;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int q = blockIdx.x;

  // 1. the query row, the tile id and the window's valid lanes [a, b)
  const SlotQuery sq = load_slot(q8 + static_cast<size_t>(q) * 8);
  const int tile0 = tile_ids[q];
  const int lo = sq.lo;
  const int hi = sq.hi;
  // int32 with wraparound, as XLA's lo + CAP and hi - lo
  const int win_end = min(hi, static_cast<int>(static_cast<uint32_t>(lo) +
                                               static_cast<uint32_t>(cap)));
  const bool wide =
      static_cast<int>(static_cast<uint32_t>(hi) - static_cast<uint32_t>(lo)) >
      cap;
  const long long g0 = static_cast<long long>(tile0) * T;
  int a, b;
  if (g0 < INT32_MIN || g0 + span - 1 > INT32_MAX) {
    a = 0;  // gidx may wrap: copy the span, each lane tests itself
    b = span;
  } else {
    a = static_cast<int>(min(max(static_cast<long long>(lo) - g0, 0LL),
                             static_cast<long long>(span)));
    b = static_cast<int>(min(max(static_cast<long long>(win_end) - g0,
                                 static_cast<long long>(a)),
                             static_cast<long long>(span)));
  }
  int32_t* agg_q = agg + static_cast<size_t>(q) * 8;
  int32_t* mask_q = masks + static_cast<size_t>(q) * (span / 16);
  if (a >= b) {  // block-uniform: no valid lane, no tile read
    if (tid < 8) agg_q[tid] = tid == 5 && wide ? 1 : 0;
    for (int w = tid; w < span / 16; w += blockDim.x) mask_q[w] = 0;
    return;
  }

  // 2. rows 1-7 of the tiles over [a, b): bulk copies, one a (tile, row)
  if constexpr (kCopy) {
    const int c0 = a / T;
    const int n_copies = ((b - 1) / T - c0 + 1) * kRows;
    if (tid == 0) {
      bar_init(&s_bar);
      uint32_t bytes = 0;
      for (int c = c0; c <= (b - 1) / T; ++c) {
        const int2 t = tile_lanes(c, T, a, b);
        bytes += static_cast<uint32_t>(kRows * 4 * (t.y - t.x));
      }
      bar_expect(&s_bar, bytes);
    }
    __syncthreads();  // the barrier is armed
    for (int k = tid; k < n_copies; k += blockDim.x) {
      const int c = c0 + k / kRows;
      const int r = 1 + k % kRows;
      const int2 t = tile_lanes(c, T, a, b);
      const long long tile =
          min(max(static_cast<long long>(tile0) + c, 0LL),
              static_cast<long long>(n_tiles - 1));
      bulk_copy(s_win + (c * kRows + r - 1) * T + t.x,
                tiles + (tile * kPacked + r) * T + t.x,
                static_cast<uint32_t>(4 * (t.y - t.x)), &s_bar);
    }
    bar_wait(&s_bar);
  }

  // 3. the predicate per lane, ballots and mask words per 32-lane group
  uint32_t call_count = 0, n_variants = 0, n_matched = 0, clamped = 0;
  auto lane_valid = [&](int l) {
    const int gidx = static_cast<int>(static_cast<uint32_t>(tile0) *
                                          static_cast<uint32_t>(T) +
                                      static_cast<uint32_t>(l));
    return gidx >= lo && gidx < win_end;  // implies a <= l < b
  };
  // one valid lane's predicate and sums from its packed rows 1-7
  // (row(r)); returns {matched, SAME_PREV}
  auto lane_body = [&](auto row) {
    const int flags = row(P_FLAGS);
    const int ac = row(P_AC);
    const bool m = lane_match<kExactOnly>(
        sq, row(P_REC_END), row(P_REF_HASH), row(P_ALT_HASH),
        static_cast<uint32_t>(row(P_LENS)), flags);
    clamped += (flags & ROW_CLAMPED) ? 1u : 0u;
    if (m) {
      call_count += static_cast<uint32_t>(ac);
      n_variants += ac != 0 ? 1u : 0u;
      n_matched += 1u;
    }
    return make_int2(m, (flags & SAME_PREV) != 0);
  };
  auto group_done = [&](int g, bool m, bool same) {
    const uint32_t mb = __ballot_sync(0xffffffffu, m);
    const uint32_t sb = __ballot_sync(0xffffffffu, same);
    if (lane == 0) {
      s_mb[g] = mb;
      s_sb[g] = sb;
    }
    if (lane < 2) {
      mask_q[2 * g + lane] =
          static_cast<int32_t>(lane ? mb >> 16 : mb & 0xFFFFu);
    }
  };
  // register route: the thread's lanes' rows, every load issued before
  // any is used; AN kept for step 4
  int32_t an_kept[kCopy ? 1 : kGroups];
  if constexpr (kCopy) {
    for (int g = warp; g < groups; g += warps) {
      const int l = g * 32 + lane;
      int2 ms = make_int2(0, 0);
      if (lane_valid(l)) {
        const int32_t* row1 = s_win + (l / T) * kRows * T + l % T;
        ms = lane_body([row1, T](int r) { return row1[(r - 1) * T]; });
      }
      group_done(g, ms.x, ms.y);
    }
  } else {
    int32_t v[kGroups][kRows];
    bool ok[kGroups];
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int g = warp + i * warps;
      const int l = g * 32 + lane;
      ok[i] = g < groups && lane_valid(l);
      if (ok[i]) {
        const int c = l / T;
        const long long tile =
            min(max(static_cast<long long>(tile0) + c, 0LL),
                static_cast<long long>(n_tiles - 1));
        const int32_t* row1 = tiles + (tile * kPacked + 1) * T + (l - c * T);
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[i][r] = row1[r * T];
      }
    }
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int g = warp + i * warps;
      if (g >= groups) break;  // warp-uniform
      int2 ms = make_int2(0, 0);
      if (ok[i]) {
        ms = lane_body([&v, i](int r) { return v[i][r - 1]; });
        an_kept[i] = v[i][P_AN - 1];
      }
      group_done(g, ms.x, ms.y);
    }
  }
  __syncthreads();  // every group's ballots

  // 4. AN of each record's first matched lane
  uint32_t all_alleles = 0;
  const uint32_t before = (1u << lane) - 1u;
  // whether this lane of group g is its record's first matched lane
  auto first_match = [&](int g) {
    const uint32_t mb = s_mb[g];
    if (!((mb >> lane) & 1u)) return false;
    const uint32_t starts = ~s_sb[g];  // lanes that start a chain
    const uint32_t own = starts & (before | (1u << lane));
    if (own) return (mb & before & ~((1u << (31 - __clz(own))) - 1u)) == 0;
    if (mb & before) return false;
    // the chain entering lane 0: did it match in earlier groups?
    for (int h = g - 1; h >= 0; --h) {
      const uint32_t mh = s_mb[h];
      const uint32_t sh = ~s_sb[h];
      if (sh) return (mh >> (31 - __clz(sh))) == 0;
      if (mh) return false;
    }
    return true;
  };
  if constexpr (kCopy) {
    for (int g = warp; g < groups; g += warps) {
      if (first_match(g)) {
        const int l = g * 32 + lane;
        all_alleles += static_cast<uint32_t>(
            s_win[((l / T) * kRows + P_AN - 1) * T + l % T]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int g = warp + i * warps;
      if (g < groups && first_match(g)) {
        all_alleles += static_cast<uint32_t>(an_kept[i]);
      }
    }
  }

  // 5. block sums, int32 with wraparound
  uint32_t sums[kSums] = {call_count, n_variants, n_matched, all_alleles,
                          clamped};
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    sums[i] = warp_sum(sums[i]);
    if (lane == 0) s_part[warp][i] = sums[i];
  }
  __syncthreads();
  if (tid == 0) {
    uint32_t tot[kSums] = {0, 0, 0, 0, 0};
    for (int w = 0; w < warps; ++w) {
#pragma unroll
      for (int i = 0; i < kSums; ++i) tot[i] += s_part[w][i];
    }
    const int cc = static_cast<int32_t>(tot[0]);
    agg_q[0] = cc > 0 ? 1 : 0;
    agg_q[1] = cc;
    agg_q[2] = static_cast<int32_t>(tot[1]);
    agg_q[3] = static_cast<int32_t>(tot[3]);
    agg_q[4] = static_cast<int32_t>(tot[2]);
    agg_q[5] = (wide || tot[4] > 0) ? 1 : 0;
    agg_q[6] = 0;
    agg_q[7] = 0;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of tier (C, T).
long long scatter_match_smem(int C, int T) { return match_smem(C, T); }

// Launch one tier: n_slots blocks of match_warps(C, T) warps on `stream`.
// Every pointer is a device pointer (tiles [n_tiles, 8, T], 16-byte
// aligned, tile_ids [n_slots], q8 [n_slots, 8], agg [n_slots, 8], masks
// [n_slots, C*T/16], all int32 and contiguous). The caller guarantees
// T % 128 == 0 and scatter_match_smem(C, T) within the card's shared
// memory a block (opted into above 48 KB here). Returns the launch's
// error.
int scatter_match_launch(const void* tiles, const void* tile_ids,
                         const void* q8, void* agg, void* masks, int n_slots,
                         int n_tiles, int T, int C, int cap, int exact_only,
                         void* stream) {
  if (n_slots <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(match_smem(C, T));
  using Kernel = void (*)(const int32_t*, const int32_t*, const int32_t*,
                         int32_t*, int32_t*, int, int, int, int);
  constexpr Kernel kernels[2][3] = {
      {&scatter_match_kernel<false, 0>, &scatter_match_kernel<false, 1>,
       &scatter_match_kernel<false, 2>},
      {&scatter_match_kernel<true, 0>, &scatter_match_kernel<true, 1>,
       &scatter_match_kernel<true, 2>}};
  const Kernel kernel = kernels[exact_only ? 1 : 0][reg_groups(C, T)];
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(n_slots),
           static_cast<unsigned>(32 * match_warps(C, T)), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tiles),
      static_cast<const int32_t*>(tile_ids), static_cast<const int32_t*>(q8),
      static_cast<int32_t*>(agg), static_cast<int32_t*>(masks), n_tiles, T,
      C, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
