// Stacked selected-samples kernel for Hopper (sm_90a): the plane body of
// the dataset-sharded stack.
//
// Replaces sbeacon_tpu/parallel/mesh.py::_local_selected (mesh.py:460):
// the per-device program of sharded_selected_query, a grid of (local
// dataset x query) running _query_one, then gathers of the matched rows'
// columns and genotype planes under the dataset's sample mask, the
// plane reduction _plane_reduce, and the sums over the local datasets
// before one psum. Here one launch covers one mesh device's block of
// d_local datasets; the psum is the caller's.
//
// What it computes, per (query q, local dataset d):
//   - the per-query body of bisect_core.cuh against dataset d's columns
//     (64-bit offset d * 11 * n_pad) and segment row chrom_offsets[d]:
//     the first R matched rows (dataset-local, ascending) and n_matched;
//   - the flags, AC, AN and rec_id of those rows, and plane_reduce.cuh
//     over their plane rows under mask[d]: dataset d's plane row r is
//     row d * n_pad + r of the [d_local * n_pad, W] planes, a word offset
//     past 2^31 at full width, so every offset is 64-bit;
//   - scal[d][q] = {call_count, all_alleles_count, overflow | (n_matched >
//     record_cap), n_matched}, rows[d][q] (-1 padded), pc_call, pc_tok
//     and or_words[d][q];
//   - the fan-in over datasets: one atomicAdd per block into agg[q] =
//     {call_count, all_alleles_count, n_overflow} (int32 wraparound, any
//     order).
//
// What bounds it on this card: bytes. A matched row reads W words of
// each plane it needs (316 B at 2504 samples, x4 with counts) from planes
// of GBs, far above the 50 MB L2, after the search's latency. Design: one
// 256-thread block per (query, dataset); the matched rows stay in shared
// memory from the search to the gathers; plane_reduce.cuh reads each row
// with one warp. Making it faster (TMA plane gathers, several queries per
// block) is later work.

#include "bisect_core.cuh"
#include "plane_reduce.cuh"

namespace {

using namespace bisect;

constexpr int kScal = 4;
constexpr int kSelAgg = 3;

__host__ __device__ constexpr long long align16(long long x) {
  return (x + 15) / 16 * 16;
}

// Dynamic shared memory of one block: the search window, seven int32
// arrays over the R lanes (rows, flags, ac, an, rec_id and two scan
// buffers), the mask and the OR words (2 W) and or_sel (R bytes).
__host__ __device__ constexpr long long selected_smem(int Wwin, int R, int W) {
  return align16(window_smem(Wwin)) + 28LL * R + 8LL * W + R;
}

__global__ void __launch_bounds__(kThreads) stacked_selected_kernel(
    const int32_t* __restrict__ cols, long long n_pad,
    const int32_t* __restrict__ alt_prefix,
    const int32_t* __restrict__ offsets, const uint32_t* __restrict__ gt,
    const uint32_t* __restrict__ gt2, const uint32_t* __restrict__ tok1,
    const uint32_t* __restrict__ tok2, const uint32_t* __restrict__ masks,
    const int32_t* __restrict__ qpack, int n_queries,
    int32_t* __restrict__ scal, int32_t* __restrict__ rows,
    int32_t* __restrict__ pc_call, int32_t* __restrict__ pc_tok,
    uint32_t* __restrict__ or_words, int32_t* __restrict__ agg, int Wwin,
    int R, int W, int record_cap, bool has_counts) {
  extern __shared__ int32_t smem[];
  int32_t* win = smem;
  int32_t* s_row = smem + align16(window_smem(Wwin)) / 4;
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

  const int q = blockIdx.x;
  const int d = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t slot = static_cast<size_t>(d) * n_queries + q;
  const int32_t* qp = qpack + static_cast<size_t>(q) * kQFields;
  const int32_t* dcols = cols + static_cast<long long>(d) * kColumns * n_pad;
  for (int w = tid; w < W; w += kThreads) {
    s_mask[w] = masks[static_cast<size_t>(d) * W + w];
  }

  // 1. the first R matched rows of dataset d
  const Agg a = query_block(dcols, n_pad,
                            alt_prefix + static_cast<long long>(d) * n_pad * 4,
                            offsets + static_cast<size_t>(d) * kSegs, qp, Wwin,
                            R, s_row, nullptr, win);
  const int n_valid = min(a.n_matched, R);

  // 2. their columns
  for (int k = tid; k < R; k += kThreads) {
    const int r = s_row[k];
    rows[slot * R + k] = r;
    if (k < n_valid) {
      s_flags[k] = dcols[C_FLAGS * n_pad + r];
      s_ac[k] = dcols[C_AC * n_pad + r];
      s_an[k] = dcols[C_AN * n_pad + r];
      s_rec[k] = dcols[C_REC_ID * n_pad + r];
    }
  }

  // 3. the plane reduction over dataset d's plane rows
  const size_t plane0 = static_cast<size_t>(d) * n_pad * W;
  const plane_reduce::Sums s = plane_reduce::reduce<kThreads>(
      gt + plane0, gt2 + plane0, tok1 + plane0, tok2 + plane0, s_row,
      s_flags, s_ac, s_an, s_rec, n_valid, R, W, has_counts, true, s_mask,
      sc, pc_call + slot * R, pc_tok + slot * R, or_words + slot * W);

  if (tid == 0) {
    const bool overflow = a.overflow || a.n_matched > record_cap;
    int32_t* sq = scal + slot * kScal;
    sq[0] = s.call_count;
    sq[1] = s.all_alleles;
    sq[2] = overflow ? 1 : 0;
    sq[3] = a.n_matched;
    int32_t* aq = agg + static_cast<size_t>(q) * kSelAgg;
    atomicAdd(aq + 0, s.call_count);
    atomicAdd(aq + 1, s.all_alleles);
    atomicAdd(aq + 2, overflow ? 1 : 0);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the kernel takes.
long long stacked_selected_smem(int Wwin, int R, int W) {
  return selected_smem(Wwin, R, W);
}

// Launch one mesh device's block: n_queries x n_datasets blocks of 256
// threads on `stream`. Every pointer is a device pointer to contiguous
// 32-bit data: cols [n_datasets, 11, n_pad], alt_prefix [n_datasets,
// n_pad, 4], offsets [n_datasets, 27], the planes gt/gt2/tok1/tok2
// [n_datasets * n_pad, W] (gt for all four without counts), masks
// [n_datasets, W], qpack [n_queries, 24]; outputs scal [n_datasets,
// n_queries, 4], rows/pc_call/pc_tok [n_datasets, n_queries, R], or_words
// [n_datasets, n_queries, W] and agg [n_queries, 3] (zeroed by the caller;
// the launch adds into it). The caller guarantees 1 <= R <= Wwin; shared
// memory above 48 KB is opted into. Returns cudaGetLastError() after the
// launch.
int stacked_selected_launch(const void* cols, long long n_pad,
                            const void* alt_prefix, const void* offsets,
                            const void* gt, const void* gt2, const void* tok1,
                            const void* tok2, const void* masks,
                            int n_datasets, const void* qpack, int n_queries,
                            void* scal, void* rows, void* pc_call,
                            void* pc_tok, void* or_words, void* agg, int Wwin,
                            int R, int W, int record_cap, int has_counts,
                            void* stream) {
  if (n_queries <= 0 || n_datasets <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(selected_smem(Wwin, R, W));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stacked_selected_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(n_queries),
                  static_cast<unsigned>(n_datasets));
  stacked_selected_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), n_pad,
      static_cast<const int32_t*>(alt_prefix),
      static_cast<const int32_t*>(offsets), static_cast<const uint32_t*>(gt),
      static_cast<const uint32_t*>(gt2), static_cast<const uint32_t*>(tok1),
      static_cast<const uint32_t*>(tok2), static_cast<const uint32_t*>(masks),
      static_cast<const int32_t*>(qpack), n_queries,
      static_cast<int32_t*>(scal), static_cast<int32_t*>(rows),
      static_cast<int32_t*>(pc_call), static_cast<int32_t*>(pc_tok),
      static_cast<uint32_t*>(or_words), static_cast<int32_t*>(agg), Wwin, R, W,
      record_cap, has_counts != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
