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
// is the keys read once, 24 B a row (1.8 GB at 7.6e7 keys, 0.55 ms at
// 3.35 TB/s); the comparisons are a few integer operations a row.
//
// Design: streaming passes over the keys, one scatter, and a hash set in
// shared memory per bucket, in place of one hash set of random sectors in
// device memory (and its clear). Every real key hashes (a 64-bit mix
// unrelated to partition_keys' bucket mix) to bucket h >> (64 -
// log2_buckets), so equal keys share a bucket and a bucket's count is its
// own:
//   1. hist: each of n_blocks blocks counts its contiguous row range's
//      keys per bucket in shared memory and adds the counts to the
//      buckets' totals;
//   2. starts: the exclusive scan of the totals (one block, warp
//      shuffles), also the buckets' write cursors;
//   3. scatter: every key, with its hash, goes as a 32-byte item to the
//      place an atomicAdd on its bucket's cursor hands out: bucket order.
//      A 24-byte key written alone would leave the sectors it touches
//      part-written, read and merged again under ECC; an item fills its
//      sector. One cursor per bucket (not per block and bucket) keeps
//      each bucket's open line one and the same;
//   4. count: one block of 1024 threads per bucket reads the bucket's
//      contiguous items into an open-addressing set in shared memory
//      (4096 slots: a state word, EMPTY, BUSY or a hash tag, and the six
//      key words; a claim is a shared atomicCAS, a waiter spins on BUSY,
//      a tag match compares the key), counts the fresh keys and adds one
//      total per block.
// What bounds this design: the scatter's one random 32-byte sector write
// per key (far from HBM's streaming rate), then the count's read of the
// items. Sorting a tile by bucket in shared memory before writing it
// gives runs of under one key at 32768 buckets; on the H100 a coarse-
// then-fine pair of staged scatters, and 64-byte items, measured slower
// than this one scatter (PERF.md §6).
// A bucket's distinct keys may outgrow its set (a skewed key set, or
// more keys than the plan's buckets hold): a pass over more items than
// `table_limit` lets the set take at most that many keys (a shared
// counter of claimed slots), a key that finds no room is deferred
// (compacted to the front of the bucket's region, which the block owns),
// the deferred keys the finished set holds are dropped as duplicates,
// and the rest go round again with an empty set. Each pass counts at
// least one key, so the count is exact in every case; the passes past
// the first are added to `spills`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPassThreads = 1024;  // hist and scatter blocks
constexpr int kSetThreads = 1024;   // count blocks
constexpr int kTableSlots = 4096;
constexpr int kMaxLog2Buckets = 15;
constexpr int32_t kPad = 0x7fffffff;
constexpr uint32_t kEmpty = 0u;
constexpr uint32_t kBusy = 1u;
// shared memory of a count block's set: a state word and six key words
// a slot
constexpr int kSetSmem = kTableSlots * 7 * 4;

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

__device__ __forceinline__ uint64_t key_hash(const int32_t k[6]) {
  uint64_t h = mix64(pair(k[0], k[1]) ^ 0x9e3779b97f4a7c15ull);
  h = mix64(h ^ pair(k[2], k[3]));
  return mix64(h ^ pair(k[4], k[5]));
}

__device__ __forceinline__ uint32_t bucket_of(uint64_t h, int log2b) {
  return log2b == 0 ? 0u : static_cast<uint32_t>(h >> (64 - log2b));
}

// Key row r (three 8-byte loads, coalesced across a warp); false for a
// pad row.
__device__ __forceinline__ bool load_key(const int32_t* keys, long long r,
                                         int32_t k[6]) {
  const int2* p = reinterpret_cast<const int2*>(keys + r * 6);
  const int2 a = p[0], b = p[1], c = p[2];
  k[0] = a.x;
  k[1] = a.y;
  k[2] = b.x;
  k[3] = b.y;
  k[4] = c.x;
  k[5] = c.y;
  return a.x != kPad;
}

// Item i of the bucket-ordered scratch: 32 bytes, the six key words and
// the key's hash, so a write fills one whole sector.
__device__ __forceinline__ void store_item(int32_t* items, long long i,
                                           const int32_t k[6], uint64_t h) {
  int4* p = reinterpret_cast<int4*>(items + i * 8);
  p[0] = make_int4(k[0], k[1], k[2], k[3]);
  p[1] = make_int4(k[4], k[5], static_cast<int32_t>(h),
                   static_cast<int32_t>(h >> 32));
}

__device__ __forceinline__ uint64_t load_item(const int32_t* items,
                                              long long i, int32_t k[6]) {
  const int4* p = reinterpret_cast<const int4*>(items + i * 8);
  const int4 a = p[0], b = p[1];
  k[0] = a.x;
  k[1] = a.y;
  k[2] = a.z;
  k[3] = a.w;
  k[4] = b.x;
  k[5] = b.y;
  return (static_cast<uint64_t>(static_cast<uint32_t>(b.w)) << 32) |
         static_cast<uint32_t>(b.z);
}

// 1. totals[b] += the keys of bucket b among the block's rows
// [blockIdx * chunk, + chunk)
__global__ void __launch_bounds__(kPassThreads) hist_kernel(
    const int32_t* __restrict__ keys, long long n, long long chunk,
    int log2b, uint32_t* __restrict__ totals) {
  extern __shared__ uint32_t s_hist[];
  const int B = 1 << log2b;
  for (int b = threadIdx.x; b < B; b += kPassThreads) s_hist[b] = 0u;
  __syncthreads();
  const long long lo = static_cast<long long>(blockIdx.x) * chunk;
  const long long hi = min(n, lo + chunk);
  for (long long r = lo + threadIdx.x; r < hi; r += kPassThreads) {
    int32_t k[6];
    if (load_key(keys, r, k)) {
      atomicAdd(&s_hist[bucket_of(key_hash(k), log2b)], 1u);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += kPassThreads) {
    if (s_hist[b]) atomicAdd(&totals[b], s_hist[b]);
  }
}

// 2. starts[b] = cursors[b]: the keys of the buckets before b (one block)
__global__ void __launch_bounds__(1024) starts_kernel(
    const uint32_t* __restrict__ totals, int B,
    uint32_t* __restrict__ starts, uint32_t* __restrict__ cursors) {
  __shared__ uint32_t s_warp[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (B + 1023) / 1024;
  const int b0 = min(tid * per, B);
  const int b1 = min(b0 + per, B);
  uint32_t acc = 0u;
  for (int b = b0; b < b1; ++b) acc += totals[b];
  uint32_t x = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t t = s_warp[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += y;
    }
    s_warp[lane] = t - s_warp[lane];  // exclusive
  }
  __syncthreads();
  uint32_t pre = s_warp[warp] + x - acc;
  for (int b = b0; b < b1; ++b) {
    starts[b] = pre;
    cursors[b] = pre;
    pre += totals[b];
  }
}

// 3. every real key, with its hash, to its bucket's region of items
__global__ void __launch_bounds__(kPassThreads) scatter_kernel(
    const int32_t* __restrict__ keys, long long n, int log2b,
    uint32_t* __restrict__ cursors, int32_t* __restrict__ items) {
  const long long stride = static_cast<long long>(gridDim.x) * kPassThreads;
  for (long long r = static_cast<long long>(blockIdx.x) * kPassThreads +
                     threadIdx.x;
       r < n; r += stride) {
    int32_t k[6];
    if (load_key(keys, r, k)) {
      const uint64_t h = key_hash(k);
      store_item(items, atomicAdd(&cursors[bucket_of(h, log2b)], 1u), k, h);
    }
  }
}

struct Set {
  uint32_t* state;  // [kTableSlots]
  int32_t* kw;      // [6][kTableSlots]
  int* used;        // slots claimed or reserved
  int limit;
};

// Key k (hash h) against the set: 1 inserted (fresh), 0 already there,
// -1 not inserted (may_insert false, or the set at its limit). A pass
// with no more keys than the limit (`limited` false) cannot fill the
// set and claims slots without counting them.
__device__ int set_insert(const Set& t, const int32_t k[6], uint64_t h,
                          bool may_insert, bool limited) {
  uint32_t slot = static_cast<uint32_t>(h) & (kTableSlots - 1);
  const uint32_t tag = static_cast<uint32_t>(h >> 24) | 2u;  // never 0, 1
  bool reserved = false;
  while (true) {
    volatile uint32_t* vs = t.state + slot;
    uint32_t st = *vs;
    if (st == kEmpty) {
      if (!may_insert) return -1;
      if (limited && !reserved) {
        // at most `limit` slots are ever claimed, so an EMPTY slot is
        // always ahead and every probe ends
        if (atomicAdd(t.used, 1) >= t.limit) {
          atomicSub(t.used, 1);
          return -1;
        }
        reserved = true;
      }
      st = atomicCAS(t.state + slot, kEmpty, kBusy);
      if (st == kEmpty) {
#pragma unroll
        for (int c = 0; c < 6; ++c) t.kw[c * kTableSlots + slot] = k[c];
        __threadfence_block();
        atomicExch(t.state + slot, tag);
        return 1;
      }
    }
    while (st == kBusy) st = *vs;  // the claimer publishes its key
    if (st == tag) {
      __threadfence_block();
      const volatile int32_t* kw = t.kw;
      bool eq = true;
#pragma unroll
      for (int c = 0; c < 6; ++c) eq = eq && kw[c * kTableSlots + slot] == k[c];
      if (eq) {
        if (reserved) atomicSub(t.used, 1);
        return 0;
      }
    }
    slot = (slot + 1) & (kTableSlots - 1);
  }
}

// 4. the distinct keys of bucket blockIdx (items[starts[b], + totals[b]),
// which the block may rewrite), added to count[0]; the passes past the
// first to spills[0]
__global__ void __launch_bounds__(kSetThreads) count_kernel(
    int32_t* items, const uint32_t* __restrict__ starts,
    const uint32_t* __restrict__ totals, int limit,
    unsigned long long* __restrict__ count,
    unsigned long long* __restrict__ spills) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_used, s_def, s_next;
  __shared__ unsigned int s_fresh;
  const int tid = threadIdx.x;
  const Set t{smem, reinterpret_cast<int32_t*>(smem + kTableSlots), &s_used,
              limit};
  int32_t* bk = items + static_cast<size_t>(starts[blockIdx.x]) * 8;
  int m = static_cast<int>(totals[blockIdx.x]);  // items still unresolved
  unsigned int fresh = 0u;
  int passes = 0;
  if (tid == 0) s_fresh = 0u;
  while (m > 0) {  // block-uniform
    ++passes;
    const bool limited = m > limit;
    for (int s = tid; s < kTableSlots; s += kSetThreads) t.state[s] = kEmpty;
    if (tid == 0) {
      s_used = 0;
      s_def = 0;
      s_next = 0;
    }
    __syncthreads();
    // a. every item into the set; the deferred ones to the front
    for (int c0 = 0; c0 < m; c0 += kSetThreads) {
      const int i = c0 + tid;
      int32_t k[6];
      uint64_t h = 0;
      int r = 0;
      if (i < m) {
        h = load_item(bk, i, k);
        r = set_insert(t, k, h, true, limited);
        fresh += r == 1 ? 1u : 0u;
      }
      if (limited) {
        __syncthreads();  // the chunk is read before any of it is rewritten
        if (r == -1) store_item(bk, atomicAdd(&s_def, 1), k, h);
      }
    }
    __syncthreads();
    const int m1 = s_def;
    if (m1 == 0) break;
    // b. a deferred item the finished set holds is a duplicate
    for (int c0 = 0; c0 < m1; c0 += kSetThreads) {
      const int i = c0 + tid;
      int32_t k[6];
      uint64_t h = 0;
      int r = 0;
      if (i < m1) {
        h = load_item(bk, i, k);
        r = set_insert(t, k, h, false, true);
      }
      __syncthreads();
      if (r == -1) store_item(bk, atomicAdd(&s_next, 1), k, h);
    }
    __syncthreads();
    m = s_next;
    __syncthreads();  // every thread read s_next before the next pass
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    fresh += __shfl_down_sync(0xffffffffu, fresh, off);
  }
  if ((tid & 31) == 0 && fresh) atomicAdd(&s_fresh, fresh);
  __syncthreads();
  if (tid == 0) {
    if (s_fresh) atomicAdd(count, static_cast<unsigned long long>(s_fresh));
    if (passes > 1) {
      atomicAdd(spills, static_cast<unsigned long long>(passes - 1));
    }
  }
}

cudaError_t set_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

// Count the distinct non-pad rows of keys [n, 6] int32 on `stream`, n <
// 2^31, in B = 2^log2_buckets buckets (at most 2^15) by n_blocks hist
// blocks (twice as many scatter blocks), each bucket's set taking at most
// table_limit keys (1 <= table_limit < 4096) before it spills to another
// pass. Device scratch: items [n, 8] int32 (the keys in bucket order,
// each with its hash), cursors, starts and totals [B] uint32. count and
// spills: one device uint64 each, set to the distinct count and to the
// passes past each bucket's first. Every pointer is a device pointer to
// contiguous data. Returns the first failing call's error
// (cudaGetLastError() after each launch).
int distinct_count_launch(const void* keys, long long n, void* items,
                          void* cursors, void* starts, void* totals,
                          int log2_buckets, int n_blocks, int table_limit,
                          void* count, void* spills, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n >= (1LL << 31) || log2_buckets < 0 ||
      log2_buckets > kMaxLog2Buckets || n_blocks < 1 || table_limit < 1 ||
      table_limit >= kTableSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int B = 1 << log2_buckets;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(unsigned long long), st);
  if (e == cudaSuccess) {
    e = cudaMemsetAsync(spills, 0, sizeof(unsigned long long), st);
  }
  if (e == cudaSuccess && n > 0) e = cudaMemsetAsync(totals, 0, 4 * B, st);
  if (e != cudaSuccess || n == 0) return static_cast<int>(e);
  const int hist_smem = 4 * B;
  const long long chunk = (n + n_blocks - 1) / n_blocks;
  const int32_t* k = static_cast<const int32_t*>(keys);
  int32_t* it = static_cast<int32_t*>(items);
  uint32_t* c = static_cast<uint32_t*>(cursors);
  uint32_t* s = static_cast<uint32_t*>(starts);
  uint32_t* t = static_cast<uint32_t*>(totals);
  if ((e = set_smem(reinterpret_cast<const void*>(hist_kernel), hist_smem)) !=
          cudaSuccess ||
      (e = set_smem(reinterpret_cast<const void*>(count_kernel),
                    kSetSmem)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  hist_kernel<<<n_blocks, kPassThreads, hist_smem, st>>>(k, n, chunk,
                                                         log2_buckets, t);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  starts_kernel<<<1, 1024, 0, st>>>(t, B, s, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  scatter_kernel<<<2 * n_blocks, kPassThreads, 0, st>>>(k, n, log2_buckets,
                                                        c, it);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  count_kernel<<<B, kSetThreads, kSetSmem, st>>>(
      it, s, t, table_limit, static_cast<unsigned long long*>(count),
      static_cast<unsigned long long*>(spills));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
