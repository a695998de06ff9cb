// Ring gather step for Hopper (sm_90a): one step of the combine of
// per-entry partial blocks on a mesh.
//
// Replaces sbeacon_tpu/ops/gather_kernel.py::_ring_step_kernel /
// _ring_step_fn / gather_partials_tpu (gather_kernel.py:43,64,79; the
// pl.pallas_call at :70): n - 1 ring steps in which every mesh entry
// receives its left neighbour's current block and adds it into its own
// accumulator, so that after the last step every entry holds the sum of
// all n partials. On the TPU each step is a remote DMA of the block to
// the right neighbour over ICI. Here the direction is reversed: each
// entry's launch reads its left neighbour's current block through a
// device pointer, adds it to its own running sum and copies it into its
// own second buffer, which becomes its current block for the next step
// (the caller orders the steps with CUDA events).
//
// On one card every neighbour pointer is an ordinary device pointer.
// A neighbour on another card would need peer access
// (cudaDeviceEnablePeerAccess) before this kernel could read it, or the
// combine would move to an NCCL collective outside the kernel; neither
// is used here: the mesh entries of this package share one card.
//
// What it computes, for n int32 words: acc[i] = own[i] + src[i]
// (wrapping, like XLA's int32 add), and next[i] = src[i] unless the step
// is the last. The first step reads the entry's own partial as `own` and
// writes a fresh `acc` (out of place: the caller needs no copy of its
// inputs); later steps pass own == acc.
//
// What bounds it on this card: bytes at the HBM rate, 16 a word for a
// step with next (read src and own, write acc and next) and 12 for the
// last step and for an out-of-place first step. What the design does
// about it:
//   - every thread issues its U int4 loads of src and of own before any
//     add or store (U = 4 from 4.3 MB a stream, 2 from 2.2 MB, else 1,
//     so that blocks of a few MB still spread over every SM); src is
//     read with a streaming hint (this step is its last reader), own
//     without (a first step's own is its neighbour's src, and an
//     evict-first own slows a step whose blocks are already in L2);
//     next stays in L2 for the neighbour that reads it in the next step;
//   - the grid is at most one resident wave (the SMs times the blocks
//     that fit on one) and loops past it, so no tail wave runs half
//     empty; a block too small to reach every SM takes 64-thread blocks
//     and one int4 a thread, so that more SMs share it;
//   - whether the step writes next is a template parameter, not a test
//     in the loop.
// Pointers that are not all 16-byte aligned take a word-at-a-time
// kernel; the last n % 4 words of an aligned block are done one at a
// time by the same launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads of a block, large blocks
constexpr int kSmallThreads = 64;  // threads of a block, small blocks
constexpr int kMaxUnroll = 4;      // int4s a thread has in flight a stream

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// 16-byte aligned src, own, next (when kNext) and acc; n4 = n / 4 int4s,
// then the n % 4 tail words. own may equal acc.
template <bool kNext, int kU>
__global__ void __launch_bounds__(kThreads)
    ring_step_vec(const int32_t* __restrict__ src, const int32_t* own,
                  int32_t* __restrict__ next, int32_t* acc, long long n) {
  const long long n4 = n / 4;
  const int4* s4 = reinterpret_cast<const int4*>(src);
  const int4* o4 = reinterpret_cast<const int4*>(own);
  int4* a4 = reinterpret_cast<int4*>(acc);
  int4* x4 = reinterpret_cast<int4*>(next);
  const long long tile = static_cast<long long>(blockDim.x) * kU;
  const long long stride = tile * gridDim.x;
  for (long long base = blockIdx.x * tile + threadIdx.x; base < n4;
       base += stride) {
    int4 s[kU], o[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const long long i = base + static_cast<long long>(k) * blockDim.x;
      if (i < n4) {
        s[k] = __ldcs(s4 + i);
        o[k] = o4[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const long long i = base + static_cast<long long>(k) * blockDim.x;
      if (i < n4) {
        int4 a;
        a.x = add32(o[k].x, s[k].x);
        a.y = add32(o[k].y, s[k].y);
        a.z = add32(o[k].z, s[k].z);
        a.w = add32(o[k].w, s[k].w);
        a4[i] = a;
        if (kNext) __stcg(x4 + i, s[k]);
      }
    }
  }
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (long long i = n4 * 4 + t; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int32_t v = src[i];
    acc[i] = add32(own[i], v);
    if (kNext) next[i] = v;
  }
}

// Any alignment: one word a thread per grid-stride iteration.
template <bool kNext>
__global__ void __launch_bounds__(kThreads)
    ring_step_words(const int32_t* __restrict__ src, const int32_t* own,
                    int32_t* __restrict__ next, int32_t* acc, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int32_t v = src[i];
    acc[i] = add32(own[i], v);
    if (kNext) next[i] = v;
  }
}

using StepKernel = void (*)(const int32_t*, const int32_t*, int32_t*,
                            int32_t*, long long);

template <bool kNext>
StepKernel step_kernel(bool vec, int unroll) {
  if (!vec) return ring_step_words<kNext>;
  if (unroll == 4) return ring_step_vec<kNext, 4>;
  if (unroll == 2) return ring_step_vec<kNext, 2>;
  return ring_step_vec<kNext, 1>;
}

}  // namespace

extern "C" {

// One entry's launch of one ring step on `stream`: acc = own + src, and
// next = src unless next is null (the last step). src, own, next and acc
// are device pointers to n contiguous int32 words; own may equal acc (a
// step after the first), src may lie in another entry's buffer on the
// same card, and no other two may overlap. Returns the first CUDA error
// of the launch (cudaGetLastError() after it).
int ring_step_launch(const void* src, const void* own, void* next, void* acc,
                     long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const bool with_next = next != nullptr;
  const bool vec = (reinterpret_cast<uintptr_t>(src) |
                    reinterpret_cast<uintptr_t>(own) |
                    reinterpret_cast<uintptr_t>(next) |
                    reinterpret_cast<uintptr_t>(acc)) % 16 == 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long items = vec ? n / 4 : n;
  int unroll = 1;
  while (vec && unroll < kMaxUnroll &&
         items >= static_cast<long long>(sms) * kThreads * unroll * 4) {
    unroll *= 2;
  }
  const bool small = items < static_cast<long long>(sms) * kThreads;
  const int threads = small ? kSmallThreads : kThreads;
  StepKernel kernel = with_next ? step_kernel<true>(vec, unroll)
                                : step_kernel<false>(vec, unroll);
  int per_sm = 0;  // blocks of `threads` that fit on one SM at a time
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(kernel), threads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long wave =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long per_block = static_cast<long long>(threads) * unroll;
  long long blocks = (items + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;        // an aligned block of under 4 words
  if (blocks > wave) blocks = wave;  // one resident wave, then the loop
  void* args[] = {&src, &own, &next, &acc, &n};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                       dim3(static_cast<unsigned>(blocks)), dim3(threads),
                       args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
