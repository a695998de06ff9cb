// Scatter match kernel for Hopper (sm_90a).
//
// Replaces sbeacon_tpu/ops/scatter_kernel.py::_scatter_core /
// _scatter_batch / _scatter_many (the XLA gather program that answers
// every single-dataset variant query on the accelerator). One launch
// covers every padded query slot of one (tier, exact) split: the grid
// axis takes the place of _scatter_many's lax.map over chunks.
//
// Per query slot q: the window match of scatter_core.cuh (the predicate
// stack and agg[q]), then masks[q][w] bit b = lane w*16 + b matched.
//
// What bounds it on this card: bytes. A query reads C * 4 KB of tiles
// (T = 128) from random places of the packed index (about 640 MB at
// 2e7 rows, far above the 50 MB L2), and does a few tens of integer
// operations per lane; tensor cores (wgmma) have no role. This first
// version is the simple, correct one: one 128-thread block per query
// slot, each thread owning lanes tid, tid + 128, ...; each packed row
// of a tile is read as 512 coalesced bytes. Match and SAME_PREV bits
// live in shared memory (2 bytes per lane), the sums are reduced by warp
// shuffles and one thread per 16-lane word packs the masks. Making it
// fast (asynchronous tile copies, several queries per block) is later
// work.

#include "scatter_core.cuh"

namespace {

using namespace scatter;

template <bool kExactOnly>
__global__ void __launch_bounds__(kThreads) scatter_match_kernel(
    const int32_t* __restrict__ tiles, const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ q8, int32_t* __restrict__ agg,
    int32_t* __restrict__ masks, int n_tiles, int T, int C, int cap) {
  extern __shared__ uint8_t smem[];
  const int span = C * T;
  uint8_t* s_match = smem;
  uint8_t* s_same = smem + span;
  const int q = blockIdx.x;

  match_window<kExactOnly>(tiles, q8 + static_cast<size_t>(q) * 8,
                           tile_ids[q], n_tiles, T, C, cap, s_match, s_same,
                           agg + static_cast<size_t>(q) * 8);

  // bit-packed match mask: bit b of word w = lane w*16 + b
  const int nw = span / 16;
  int32_t* mq = masks + static_cast<size_t>(q) * nw;
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      word |= static_cast<uint32_t>(s_match[w * 16 + b]) << b;
    }
    mq[w] = static_cast<int32_t>(word);
  }
}

}  // namespace

extern "C" {

// Launch one tier: n_slots blocks of 128 threads on `stream`. Every
// pointer is a device pointer (tiles [n_tiles, 8, T], tile_ids
// [n_slots], q8 [n_slots, 8], agg [n_slots, 8], masks
// [n_slots, C*T/16], all int32 and contiguous). The caller guarantees
// T % 128 == 0 and 2*C*T bytes of shared memory <= 48 KB. Returns
// cudaGetLastError() after the launch.
int scatter_match_launch(const void* tiles, const void* tile_ids,
                         const void* q8, void* agg, void* masks, int n_slots,
                         int n_tiles, int T, int C, int cap, int exact_only,
                         void* stream) {
  if (n_slots <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>(n_slots));
  const dim3 block(scatter::kThreads);
  const size_t smem = static_cast<size_t>(2) * C * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(tiles);
  const int32_t* ids = static_cast<const int32_t*>(tile_ids);
  const int32_t* qq = static_cast<const int32_t*>(q8);
  int32_t* a = static_cast<int32_t*>(agg);
  int32_t* m = static_cast<int32_t*>(masks);
  if (exact_only) {
    scatter_match_kernel<true><<<grid, block, smem, s>>>(t, ids, qq, a, m,
                                                         n_tiles, T, C, cap);
  } else {
    scatter_match_kernel<false><<<grid, block, smem, s>>>(t, ids, qq, a, m,
                                                          n_tiles, T, C, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
