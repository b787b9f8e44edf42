// Pieces shared by the two 1-NN kernels (nn1_scan.cu, nn1_mma.cu).
//
// Both split the candidate range across blocks, so a query's partial
// results meet in device memory: each block folds its (d2, index) into one
// 64-bit key per query with atomicMin. The key's high word is d2's bits
// mapped to an unsigned integer of the same order (negative d2 included:
// self-matches can round below 0), the low word the candidate index, so the
// minimum key is the smallest d2 and, among equal d2, the lowest index. min
// is commutative, so the result does not depend on the blocks' order.
//
// Both also take a batch of pairs in one launch sequence (the counterpart
// of the TPU kernel under vmap, which prepends a grid axis): pair b's rows
// start at b * n0 (queries) and b * n1 (candidates), the grid's z axis runs
// over the pairs, and each pair's counts come from an int32 array on the
// device. Queries and candidates keep pair-local indices, so every (query,
// candidate) lands in the same thread, fragment slot and order of
// arithmetic as in a launch of that pair alone: a batched launch returns
// each pair's unbatched result bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace nn1 {

constexpr unsigned long long kNoKey = ~0ull;  // no candidate yet

// Pair b's query and candidate counts: nums[2b] and nums[2b + 1] (clamped
// to the n0 / n1 rows each pair holds) for a batched launch, else the
// scalars of a one-pair launch.
struct Counts {
  const int* nums;  // [batch, 2] on the device, or null
  int num0, num1;   // the counts when nums is null
  int n0, n1;       // rows a pair holds

  __device__ __forceinline__ int q(int b) const {
    return nums ? min(max(nums[2 * b], 0), n0) : num0;
  }
  __device__ __forceinline__ int c(int b) const {
    return nums ? min(max(nums[2 * b + 1], 0), n1) : num1;
  }
};

__device__ __forceinline__ unsigned long long make_key(float d, int idx) {
  uint32_t u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0u;  // -0 ties with +0, as under '<'
  const uint32_t m = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(m) << 32) | static_cast<uint32_t>(idx);
}

__device__ __forceinline__ float key_d(unsigned long long key) {
  const uint32_t m = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((m & 0x80000000u) ? (m & 0x7fffffffu) : ~m);
}

// Rows >= num0 and rows that no block reached return (0, +inf). Grid:
// (row blocks, pairs).
__global__ void decode_kernel(const unsigned long long* __restrict__ keys,
                              Counts cnt, int* __restrict__ idx,
                              float* __restrict__ d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cnt.n0) return;
  const size_t r = static_cast<size_t>(blockIdx.y) * cnt.n0 + i;
  const unsigned long long k = keys[r];
  const bool found = i < cnt.q(blockIdx.y) && k != kNoKey;
  idx[r] = found ? static_cast<int>(k & 0xffffffffu) : 0;
  d[r] = found ? key_d(k) : CUDART_INF_F;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Candidate tiles per block. The grid is (query tiles) x (candidate
// splits); with `slots` blocks resident on the card at once, a launch takes
// about ceil(blocks / slots) rounds of (tiles per block + overhead) tile
// times. Pick the chunk that minimises that; ties keep fewer blocks.
inline int choose_chunk(int q_tiles, int n_tiles, int slots, int overhead) {
  int best_chunk = n_tiles, s = 1;
  long long best_cost = -1;
  for (; s <= n_tiles && s <= 512; ++s) {
    const int chunk = (n_tiles + s - 1) / s;
    const long long blocks = static_cast<long long>(q_tiles) *
                             ((n_tiles + chunk - 1) / chunk);
    const long long cost = (blocks + slots - 1) / slots * (chunk + overhead);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_chunk = chunk;
    }
  }
  return best_chunk > 0 ? best_chunk : 1;
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

inline size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

}  // namespace nn1
