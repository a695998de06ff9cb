// Stacked query kernel for Hopper (sm_90a): the query-only body of the
// dataset-sharded stack.
//
// Replaces sbeacon_tpu/parallel/mesh.py::_local_query (mesh.py:309): the
// per-device program of sharded_query, a grid of (local dataset x query)
// running _query_one, then the sums over the local datasets and one psum
// over the mesh. Here one launch covers one mesh device's block of
// d_local datasets; the psum is the caller's (a sum of the per-device
// partials).
//
// What it computes, per (query q, local dataset d):
//   - the per-query body of bisect_core.cuh (its header says what that
//     computes) against dataset d's columns, which start at the 64-bit
//     offset d * 11 * n_pad, and its segment row chrom_offsets[d]. The
//     rows are local to the dataset (< n_pad). A padding dataset has an
//     all-zero segment row: every window is empty and it stays silent;
//   - out[d][q] = {exists, call_count, n_variants, all_alleles,
//     n_matched, overflow}, then the first R matched row ids;
//   - the cross-dataset fan-in, folded into the same launch: one
//     atomicAdd per block into agg[q] = {call_count, all_alleles_count,
//     n_variants, n_datasets_hit (call_count > 0), n_overflow}. int32
//     addition wraps identically in any order, so this equals the JAX
//     program's jnp.sum over datasets and then psum.
//
// What bounds it on this card: latency, as for bisect_query (a point
// query's cost is its two dependent searches), then the bytes of the
// valid lanes. One 256-thread block per (query, dataset) keeps every
// dataset's search in flight at once; the atomics are 5 a block, on a
// [B, 5] array that stays in L2. Making it faster (several queries per
// block at point traffic) is later work.

#include "bisect_core.cuh"

namespace {

using namespace bisect;

constexpr int kStackAgg = 5;

__global__ void __launch_bounds__(kThreads) stacked_query_kernel(
    const int32_t* __restrict__ cols, long long n_pad,
    const int32_t* __restrict__ alt_prefix,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ qpack,
    int n_queries, int32_t* __restrict__ out, int32_t* __restrict__ agg,
    int W, int R) {
  extern __shared__ int32_t smem[];
  const int q = blockIdx.x;
  const int d = blockIdx.y;
  const int32_t* qp = qpack + static_cast<size_t>(q) * kQFields;
  const long long col_base = static_cast<long long>(d) * kColumns * n_pad;
  int32_t* oq =
      out + (static_cast<size_t>(d) * n_queries + q) * (kAgg + R);
  const Agg a = query_block(cols + col_base, n_pad,
                            alt_prefix + static_cast<long long>(d) * n_pad * 4,
                            offsets + static_cast<size_t>(d) * kSegs, qp, W,
                            R, oq + kAgg, oq, smem);
  if (threadIdx.x == 0) {
    int32_t* aq = agg + static_cast<size_t>(q) * kStackAgg;
    atomicAdd(aq + 0, a.call_count);
    atomicAdd(aq + 1, a.all_alleles);
    atomicAdd(aq + 2, a.n_variants);
    atomicAdd(aq + 3, a.call_count > 0 ? 1 : 0);
    atomicAdd(aq + 4, a.overflow ? 1 : 0);
  }
}

}  // namespace

extern "C" {

// Launch one mesh device's block: n_queries x n_datasets blocks of 256
// threads on `stream`. Every pointer is a device pointer to contiguous
// int32 data: cols [n_datasets, 11, n_pad], alt_prefix [n_datasets,
// n_pad, 4], offsets [n_datasets, 27], qpack [n_queries, 24], out
// [n_datasets, n_queries, 6 + R], agg [n_queries, 5] (zeroed by the
// caller; the launch adds into it). The window takes 5 bytes of shared
// memory per lane. Returns cudaGetLastError() after the launch.
int stacked_query_launch(const void* cols, long long n_pad,
                         const void* alt_prefix, const void* offsets,
                         int n_datasets, const void* qpack, int n_queries,
                         void* out, void* agg, int W, int R, void* stream) {
  if (n_queries <= 0 || n_datasets <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(window_smem(W));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stacked_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(n_queries),
                  static_cast<unsigned>(n_datasets));
  stacked_query_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), n_pad,
      static_cast<const int32_t*>(alt_prefix),
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(qpack), n_queries,
      static_cast<int32_t*>(out), static_cast<int32_t*>(agg), W, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
