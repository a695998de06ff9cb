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
// device pointer, adds it into its accumulator and copies it into its
// own second buffer, which becomes its current block for the next step
// (the caller orders the steps with CUDA events).
//
// On one card every neighbour pointer is an ordinary device pointer.
// A neighbour on another card would need peer access
// (cudaDeviceEnablePeerAccess) before this kernel could read it, or the
// combine would move to an NCCL collective outside the kernel; neither
// is used here: the mesh entries of this package share one card.
//
// What it computes, for n int32 words: acc[i] += src[i] (wrapping, like
// XLA's int32 add), and next[i] = src[i] when next is not null.
//
// What bounds it on this card: bytes (16 a word: read src and acc, write
// acc and next). Each thread moves 16 bytes of each stream with one
// int4 load or store when all three pointers are 16-byte aligned; a
// grid-stride loop covers any length, the last n % 4 words one at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    ring_step_kernel(const int32_t* __restrict__ src,
                     int32_t* __restrict__ next, int32_t* __restrict__ acc,
                     long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* a4 = reinterpret_cast<int4*>(acc);
    int4* x4 = reinterpret_cast<int4*>(next);
    for (long long i = t; i < n4; i += stride) {
      const int4 v = s4[i];
      int4 a = a4[i];
      a.x = add32(a.x, v.x);
      a.y = add32(a.y, v.y);
      a.z = add32(a.z, v.z);
      a.w = add32(a.w, v.w);
      a4[i] = a;
      if (next != nullptr) x4[i] = v;
    }
    done = n4 * 4;
  }
  for (long long i = done + t; i < n; i += stride) {
    const int32_t v = src[i];
    acc[i] = add32(acc[i], v);
    if (next != nullptr) next[i] = v;
  }
}

}  // namespace

extern "C" {

// One entry's launch of one ring step on `stream`: acc += src, and
// next = src unless next is null (the last step). src, next and acc are
// device pointers to n contiguous int32 words; src may lie in another
// entry's buffer on the same card. Returns cudaGetLastError() after the
// launch.
int ring_step_launch(const void* src, void* next, void* acc, long long n,
                     void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const bool vec = (reinterpret_cast<uintptr_t>(src) |
                    reinterpret_cast<uintptr_t>(next) |
                    reinterpret_cast<uintptr_t>(acc)) % 16 == 0;
  const long long items = vec ? (n + 3) / 4 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride past 16 per SM
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    ring_step_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(src), static_cast<int32_t*>(next),
        static_cast<int32_t*>(acc), n);
  } else {
    ring_step_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(src), static_cast<int32_t*>(next),
        static_cast<int32_t*>(acc), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
