// Plane-stats kernel for Hopper (sm_90a).
//
// Replaces sbeacon_tpu/ops/plane_kernel.py::_plane_stats (the XLA program
// that reads the genotype bit planes of a matched-row set for the
// selected-samples leaf and for sample-hit extraction, when the rows came
// from the host matcher: window or record overflow, N-wildcard refs).
//
// What it computes, for a row set rows[0..R) of planes [n_plane, W] int32
// (uint32 bit patterns, bit s%32 of word s//32 = sample s):
//   - counts[r] = {popc(gt & mask), popc(gt2 & mask), popc(tok1 & mask),
//     popc(tok2 & mask)} summed over the row's W words; the last three
//     are 0 without counts (the caller then passes gt for those planes);
//   - or_words[w] = OR over the rows with or_sel[r] != 0 of gt[row][w] &
//     mask[w] (only with with_or; the caller zeroes or_words).
// Row ids clamp to [0, n_plane) like an XLA gather.
//
// What bounds it on this card: bytes. Each row reads W words per plane
// (316 B at 2504 samples) from random places of planes that hold GBs,
// far above the 50 MB L2, and does three integer operations per word.
// Design: one warp per row, its 32 lanes striding the row's words, so
// each warp's load of a plane row is one coalesced run; __popc per word
// and a warp shuffle sum. The mask and a per-block OR accumulator sit in
// shared memory; a block ORs its rows into the accumulator with shared
// atomics and then ORs the accumulator into the global words with one
// atomicOr per non-zero word. Warps walk rows with a grid stride, so the
// global atomics stay at one per word per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 8;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) plane_stats_kernel(
    const uint32_t* __restrict__ gt, const uint32_t* __restrict__ gt2,
    const uint32_t* __restrict__ tok1, const uint32_t* __restrict__ tok2,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ or_sel,
    const uint32_t* __restrict__ mask, int32_t* __restrict__ counts,
    uint32_t* __restrict__ or_words, int R, int W, long long n_plane,
    bool with_counts, bool with_or) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_mask = smem;      // [W]
  uint32_t* s_or = smem + W;    // [W]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int w = tid; w < W; w += kThreads) {
    s_mask[w] = mask[w];
    s_or[w] = 0u;
  }
  __syncthreads();

  bool any_or = false;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
       r < R; r += static_cast<long long>(gridDim.x) * kWarps) {
    long long row = rows[r];
    row = row < 0 ? 0 : (row >= n_plane ? n_plane - 1 : row);
    const size_t base = static_cast<size_t>(row) * W;
    const bool sel = with_or && or_sel[r] != 0;
    int pc[4] = {0, 0, 0, 0};
    for (int w = lane; w < W; w += 32) {
      const uint32_t m = s_mask[w];
      const uint32_t g = gt[base + w] & m;
      pc[0] += __popc(g);
      if (with_counts) {
        pc[1] += __popc(gt2[base + w] & m);
        pc[2] += __popc(tok1[base + w] & m);
        pc[3] += __popc(tok2[base + w] & m);
      }
      if (sel && g) atomicOr(&s_or[w], g);
    }
    any_or = any_or || sel;
#pragma unroll
    for (int i = 0; i < 4; ++i) pc[i] = warp_sum(pc[i]);
    if (lane == 0) {
      int4 out = make_int4(pc[0], pc[1], pc[2], pc[3]);
      reinterpret_cast<int4*>(counts)[r] = out;
    }
  }
  if (!with_or) return;
  // any warp of the block selected a row: fold the block's words in
  if (!__syncthreads_or(any_or)) return;
  for (int w = tid; w < W; w += kThreads) {
    const uint32_t v = s_or[w];
    if (v) atomicOr(&or_words[w], v);
  }
}

}  // namespace

extern "C" {

// Launch one row set on `stream`. Every pointer is a device pointer to
// contiguous 32-bit data: gt, gt2, tok1, tok2 [n_plane, W], rows and
// or_sel [R], mask [W], counts [R, 4], or_words [W] (zeroed by the
// caller). Shared memory: 8 * W bytes (opt-in above 48 KB). Returns
// cudaGetLastError() after the launch.
int plane_stats_launch(const void* gt, const void* gt2, const void* tok1,
                       const void* tok2, const void* rows, const void* or_sel,
                       const void* mask, void* counts, void* or_words, int R,
                       int W, long long n_plane, int with_counts, int with_or,
                       void* stream) {
  if (R <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(W) * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        plane_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  long long blocks = (static_cast<long long>(R) + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  plane_stats_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(gt), static_cast<const uint32_t*>(gt2),
      static_cast<const uint32_t*>(tok1), static_cast<const uint32_t*>(tok2),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(or_sel),
      static_cast<const uint32_t*>(mask), static_cast<int32_t*>(counts),
      static_cast<uint32_t*>(or_words), R, W, n_plane, with_counts != 0,
      with_or != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
