// Fixed-order slot sum for Hopper (sm_90a): each output row adds the rows
// its slots name, one after another in ascending slot order.
//
// Replaces the JAX package's gather-sum edge conv composition,
// deepglobalregistration_tpu/ops/edge_conv.py:557 (_conv_gather, with
// _slot_sum_tiered at :579): there every edge's product is computed first,
// in tile order, and each output row then gathers its own slots and sums
// them. That is no Pallas kernel (XLA lowers it); the port's convs had
// taken an index_add_ instead, whose atomic adds on the card sum a row in
// another order on every run.
//
// What it computes. Row r owns the slots slots[ptr[r] .. ptr[r + 1]),
// ascending. Of those, the slots s in the chunk's range [s0, s1) are added:
//
//   acc = out[r];  for s in order: acc += src[s - s0];  out[r] = acc
//
// (dgr_slot_sum: src is the chunk's product rows P [s1 - s0, C]), or
// acc += x[rows[s]] (dgr_slot_sum_rows: the rows of x that a map's slots
// read, for sum pooling, which has no products). Every add is one f32 add
// in that sequence: no atomics, no tree. A row's sum therefore depends only
// on the map and the values, not on how its slots are cut into chunks, on
// the stream or on the thread schedule, and equals the plain per-round
// index_add_ form of ops/slot_sum.py bit for bit. A row with no slot in the
// chunk is neither read nor written.
//
// What bounds it. Bytes: P (or the rows read) once, out read and written
// once, the slot lists; one add a value. Design: a warp a row and a block
// of 32 V columns (blockIdx.y), each lane V = 4 columns as a float4 where
// C and the pointers allow (else V = 1). The warp loads 32 of the row's
// slots at once, one a lane, and takes those in the chunk in lane order
// (a ballot, then each slot broadcast from its lane), and loads up to 8 of
// the values before it adds them in order, so those loads are in flight
// together (the kernel gradient's rows are long runs of an offset's tiles,
// latency-bound one load at a time). A row with more than 32
// slots (the kernel gradient: an offset's tiles) first finds the chunk's
// first slot by binary search. Simple first: at C = 32 three lanes in four
// idle; fusing the gather and the GEMM into this kernel (output-stationary,
// wgmma) is later work.
//
// Interface: plain C, loaded with ctypes. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a column count the grid cannot hold.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kBatch = 8;  // values a lane loads before it adds them

template <int V> struct Vec { using T = float; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <int V, bool kRows>
__global__ void __launch_bounds__(kThreads)
slot_sum_kernel(const float* __restrict__ src,
                const long long* __restrict__ src_rows, int s0, int s1,
                const int* __restrict__ ptr, const int* __restrict__ slots,
                int n_rows, int c, float* __restrict__ out) {
  using T = typename Vec<V>::T;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int col = (blockIdx.y * 32 + lane) * V;
  const bool active = col < c;
  int lo = __ldg(ptr + r);
  const int hi = __ldg(ptr + r + 1);
  if (hi - lo > 32) {  // the first slot >= s0
    int b = hi;
    while (lo < b) {
      const int m = (lo + b) >> 1;
      if (__ldg(slots + m) < s0) lo = m + 1; else b = m;
    }
  }
  T* dst = reinterpret_cast<T*>(out + (size_t)r * c + col);
  T acc = T();
  bool started = false;
  for (int base = lo; base < hi; base += 32) {
    const int j = base + lane;
    const int s = j < hi ? __ldg(slots + j) : INT_MAX;
    unsigned take = __ballot_sync(kAll, s >= s0 && s < s1);
    const bool past = __ballot_sync(kAll, s >= s1) != 0u;
    if (take != 0u && !started) {
      if (active) acc = *dst;
      started = true;
    }
    while (take != 0u) {  // ascending lanes: ascending slots
      // Up to kBatch values loaded before any is added, so their loads are
      // in flight together; the adds stay in slot order.
      T v[kBatch];
      int n = 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (take == 0u) break;  // warp-uniform
        const int l = __ffs(take) - 1;
        take &= take - 1u;
        const int sl = __shfl_sync(kAll, s, l);
        const size_t row = kRows ? (size_t)__ldg(src_rows + sl) : (size_t)(sl - s0);
        if (active) v[u] = __ldg(reinterpret_cast<const T*>(src + row * c + col));
        n = u + 1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (u < n && active) add_to(acc, v[u]);
    }
    if (past) break;
  }
  if (started && active) *dst = acc;
}

template <bool kRows>
int launch(const void* src, const void* src_rows, int s0, int s1,
           const void* ptr, const void* slots, int n_rows, int c, void* out,
           void* stream) {
  if (n_rows <= 0 || c <= 0 || s1 <= s0) return 0;
  const bool vec4 = c % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const int v = vec4 ? 4 : 1;
  const int col_blocks = (c + 32 * v - 1) / (32 * v);
  if (col_blocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_rows + kWarps - 1) / kWarps, col_blocks);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(src);
  const auto* rows = static_cast<const long long*>(src_rows);
  const auto* p = static_cast<const int*>(ptr);
  const auto* sl = static_cast<const int*>(slots);
  auto* o = static_cast<float*>(out);
  if (vec4)
    slot_sum_kernel<4, kRows><<<grid, kThreads, 0, st>>>(s, rows, s0, s1, p, sl, n_rows, c, o);
  else
    slot_sum_kernel<1, kRows><<<grid, kThreads, 0, st>>>(s, rows, s0, s1, p, sl, n_rows, c, o);
  return (int)cudaGetLastError();
}

}  // namespace

// out [>= n_rows, c] += P [s1 - s0, c] through the slot lists (P row s - s0).
extern "C" int dgr_slot_sum(const void* p, int s0, int s1, const void* ptr,
                            const void* slots, int n_rows, int c, void* out,
                            void* stream) {
  return launch<false>(p, nullptr, s0, s1, ptr, slots, n_rows, c, out, stream);
}

// out [>= n_rows, c] += x [N, c] row rows[s] (int64) for each slot s.
extern "C" int dgr_slot_sum_rows(const void* x, const void* rows, int s0,
                                 int s1, const void* ptr, const void* slots,
                                 int n_rows, int c, void* out, void* stream) {
  return launch<true>(x, rows, s0, s1, ptr, slots, n_rows, c, out, stream);
}
