// Distinct-count kernel for Hopper (sm_90a).
//
// Replaces sbeacon_tpu/parallel/distinct.py::_local_distinct (the XLA
// program behind distinct_count_device: a lexsort-unique count of one key
// block per device, then a psum). It carries the cross-VCF
// distinct-variant count, the reference's duplicateVariantSearch.
//
// What it computes: the number of distinct rows among the rows of keys
// [n, 6] int32 (chrom_code, pos, ref_hash, alt_hash, ref_len, alt_len; the
// FNV hashes as int32 bit patterns) whose column 0 is not INT32_MAX (the
// padding of a partition_keys block). All six columns are compared, so the
// count is hash-exact, as in JAX.
//
// What bounds it on this card: bytes. The least any implementation moves
// is the keys read once, 24 B a row (1.7 GB at 7e7 keys, 0.5 ms at
// 3.35 TB/s); the comparisons are a few integer operations a row.
//
// Design: one pass, no sort. An open-addressing hash set in device memory
// of `cap` slots (a power of two, at most 0.7 full counting every row),
// each slot one 32-byte sector: the six key words, a state word (EMPTY 0,
// BUSY 1, FULL 2; a memset makes the table EMPTY) and a pad word. Keys may
// hold any bit pattern, so the state lives in its own word. One thread per
// row hashes the six words with a 64-bit mix unrelated to partition_keys'
// bucket mix, then probes linearly:
//   - an EMPTY slot is claimed with atomicCAS(state, EMPTY, BUSY); the
//     claimer writes the key, fences, and publishes state = FULL: a fresh
//     key;
//   - a BUSY slot is waited on (a volatile read, __nanosleep between) until
//     it is published; the wait ends because the claimer runs on under
//     independent thread scheduling, even in the same warp;
//   - a FULL slot's key is read from L2 (ld.cg) after a fence and compared
//     word by word: equal means a duplicate, else the next slot.
// Fresh rows are counted per warp (__ballot_sync/__popc), per block in
// shared memory, and added to the result with one atomicAdd per block.
// Blocks walk the rows with a grid stride; rows index in 64 bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kSlotWords = 8;
constexpr int kEmpty = 0;
constexpr int kBusy = 1;
constexpr int kFull = 2;
constexpr int32_t kPad = 0x7fffffff;

__device__ __forceinline__ uint64_t mix64(uint64_t z) {
  z ^= z >> 30;
  z *= 0xbf58476d1ce4e5b9ull;
  z ^= z >> 27;
  z *= 0x94d049bb133111ebull;
  z ^= z >> 31;
  return z;
}

__device__ __forceinline__ uint64_t pair(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

// Inserts key k into the table; true when it was not there before.
__device__ bool insert(int32_t* __restrict__ table, unsigned long long mask,
                       const int32_t k[6]) {
  uint64_t h = mix64(pair(k[0], k[1]) ^ 0x9e3779b97f4a7c15ull);
  h = mix64(h ^ pair(k[2], k[3]));
  h = mix64(h ^ pair(k[4], k[5]));
  unsigned long long slot = h & mask;
  while (true) {
    int32_t* s = table + slot * kSlotWords;
    volatile int32_t* state = s + 6;
    int st = *state;
    if (st == kEmpty) {
      st = atomicCAS(s + 6, kEmpty, kBusy);
      if (st == kEmpty) {
        reinterpret_cast<int4*>(s)[0] = make_int4(k[0], k[1], k[2], k[3]);
        reinterpret_cast<int2*>(s)[2] = make_int2(k[4], k[5]);
        __threadfence();
        atomicExch(s + 6, kFull);
        return true;
      }
    }
    while (st == kBusy) {
      __nanosleep(32);
      st = *state;
    }
    __threadfence();
    const int4 a = __ldcg(reinterpret_cast<const int4*>(s));
    const int2 b = __ldcg(reinterpret_cast<const int2*>(s) + 2);
    if (a.x == k[0] && a.y == k[1] && a.z == k[2] && a.w == k[3] &&
        b.x == k[4] && b.y == k[5]) {
      return false;
    }
    slot = (slot + 1) & mask;
  }
}

__global__ void __launch_bounds__(kThreads) distinct_count_kernel(
    const int32_t* __restrict__ keys, long long n, int32_t* __restrict__ table,
    unsigned long long mask, unsigned long long* __restrict__ count) {
  __shared__ unsigned int s_count;
  if (threadIdx.x == 0) s_count = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned int warp_count = 0u;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // every lane of a warp runs the same rounds, so the ballot is whole
  for (long long start = static_cast<long long>(blockIdx.x) * kThreads;
       start < n; start += stride) {
    const long long r = start + threadIdx.x;
    bool fresh = false;
    if (r < n) {
      // a row is 24 B: three 8-byte loads, coalesced across the warp
      const int2* p = reinterpret_cast<const int2*>(keys + r * 6);
      const int2 k01 = p[0], k23 = p[1], k45 = p[2];
      if (k01.x != kPad) {
        const int32_t k[6] = {k01.x, k01.y, k23.x, k23.y, k45.x, k45.y};
        fresh = insert(table, mask, k);
      }
    }
    warp_count += __popc(__ballot_sync(0xffffffffu, fresh));
  }
  if (lane == 0 && warp_count) atomicAdd(&s_count, warp_count);
  __syncthreads();
  if (threadIdx.x == 0 && s_count) {
    atomicAdd(count, static_cast<unsigned long long>(s_count));
  }
}

}  // namespace

extern "C" {

// Count the distinct non-pad rows of keys [n, 6] int32 on `stream`.
// table: device scratch of cap * 32 bytes, cap a power of two (the launch
// clears it); count: one device uint64, set to the result. Every pointer
// is a device pointer to contiguous data. Returns cudaGetLastError()
// after the launch (or the first failing call's error).
int distinct_count_launch(const void* keys, long long n, void* table,
                          long long cap, void* count, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || (cap & (cap - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(unsigned long long), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  e = cudaMemsetAsync(table, 0, static_cast<size_t>(cap) * kSlotWords * 4,
                      st);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  distinct_count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int32_t*>(keys), n, static_cast<int32_t*>(table),
      static_cast<unsigned long long>(cap - 1),
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
