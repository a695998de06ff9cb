// Bisection query kernel for Hopper (sm_90a).
//
// Replaces sbeacon_tpu/ops/kernel.py::_bisect / _query_one /
// _query_batch (kernel.py:478,502,626): the XLA program that answers
// every multi-dataset variant query against the fused stack of all warm
// shards, and a DeviceIndex's queries. One launch covers a whole batch;
// one block answers one query with the shared per-query body of
// bisect_core.cuh (its header says what it computes) against the segment
// row chrom_offsets[shard[q]] (the shard id clamps like an XLA gather).
// out[q] = the aggregate row {exists, call_count, n_variants,
// all_alleles, n_matched, overflow}, then the first R matched row ids.
//
// What bounds it on this card: latency, then bytes. A point query
// touches a few rows; its cost is the chain of dependent probes that
// find lo and hi (about 26 steps of a binary search at 3.5e7 rows, each
// a round trip to device memory) and the block's own start-up. The
// columns are far larger than the 50 MB L2. bisect_core.cuh's 32-ary
// warp searches, valid-lane-only coalesced reads and ballot compaction
// are the design's answer. Making it faster (several queries per block
// for point traffic, persistent blocks) is later work.

#include "bisect_core.cuh"

namespace {

using namespace bisect;

__global__ void __launch_bounds__(kThreads) bisect_query_kernel(
    const int32_t* __restrict__ cols, long long n_pad,
    const int32_t* __restrict__ alt_prefix,
    const int32_t* __restrict__ offsets, int n_shards,
    const int32_t* __restrict__ qpack, int32_t* __restrict__ out, int W,
    int R) {
  extern __shared__ int32_t smem[];
  const int q = blockIdx.x;
  const int32_t* qp = qpack + static_cast<size_t>(q) * kQFields;
  const int shard = min(max(qp[QF_SHARD], 0), n_shards - 1);
  int32_t* oq = out + static_cast<size_t>(q) * (kAgg + R);
  query_block(cols, n_pad, alt_prefix,
              offsets + static_cast<size_t>(shard) * kSegs, qp, W, R,
              oq + kAgg, oq, smem);
}

}  // namespace

extern "C" {

// Launch one batch: n_queries blocks of 256 threads on `stream`. Every
// pointer is a device pointer to contiguous int32 data: cols
// [11, n_pad], alt_prefix [n_pad, 4], offsets [n_shards, 27], qpack
// [n_queries, 24], out [n_queries, 6 + R]. The window takes 5 bytes of
// shared memory per lane (W <= 46489). Returns cudaGetLastError() after
// the launch.
int bisect_query_launch(const void* cols, long long n_pad,
                        const void* alt_prefix, const void* offsets,
                        int n_shards, const void* qpack, void* out,
                        int n_queries, int W, int R, void* stream) {
  if (n_queries <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(window_smem(W));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bisect_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bisect_query_kernel<<<n_queries, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), n_pad,
      static_cast<const int32_t*>(alt_prefix),
      static_cast<const int32_t*>(offsets), n_shards,
      static_cast<const int32_t*>(qpack), static_cast<int32_t*>(out), W, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
