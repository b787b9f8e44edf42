// Fixed-order slot sums for Hopper (sm_90a): each output row adds the rows
// its slots name, one after another in ascending slot order.
//
// Replaces the JAX package's gather-sum edge conv composition,
// deepglobalregistration_tpu/ops/edge_conv.py:557 (_conv_gather, with
// _slot_sum_tiered at :579): there every edge's product is computed first,
// in tile order, and each output row then gathers its own slots and sums
// them; and its kernel gradient, the dk.at[...].add of _chunk_bwd_step
// (:642, the add at :662), which _conv_gather_bwd (:673) runs over the
// tiles in order. None of these is a Pallas kernel (XLA lowers them); the
// port's convs had taken an index_add_ instead, whose atomic adds on the
// card sum a row in another order on every run.
//
// What it computes. Row r owns the slots slots[ptr[r] .. ptr[r + 1]),
// ascending. Of those, the slots s in the chunk's range [s0, s1) are added:
//
//   acc = out[r];  for s in order: acc += src[s - s0];  out[r] = acc
//
// (dgr_slot_sum: src is the chunk's product rows P [s1 - s0, C]), or
// acc += x[rows[s]] (dgr_slot_sum_rows: the rows of x that a map's slots
// read, for sum pooling, which has no products). dgr_slot_sum_runs takes
// no slot list: row r's slots are the run ptr[r] .. ptr[r + 1] itself (the
// kernel gradient, whose row k is offset k and whose slots are that
// offset's tiles, consecutive). Every add is one f32 add in that sequence:
// no atomics, no tree, no sum split across threads. A row's sum therefore
// depends only on the map and the values, not on how its slots are cut
// into chunks, on the stream or on the thread schedule, and equals the
// plain per-round index_add_ form of ops/slot_sum.py bit for bit. A row
// with no slot in the chunk is neither read nor written.
//
// What bounds them: bytes. P (or the rows read) once, out read and written
// once, the slot lists (runs: only ptr); one add a value.
//
// By-row kernel (slot_sum_kernel: the forward, dx and sum pooling; rows of
// ~3-60 slots at C = 32-256). A group of G lanes a row, each lane V = 4
// columns as a float4 where C and the pointers allow (else V = 1), G the
// fewest of 4, 8, 16, 32 lanes that cover the row (at C = 32, 8 lanes and
// four rows a warp; from C = 128 a full warp, with column blocks on
// blockIdx.y), so no lane idles on narrow rows. Every lane reads its row's
// pointers and slots itself (one address across the group: a broadcast
// from L1), then issues kBatch = 4 value loads, and out's load when the
// batch reaches the chunk, before it adds them in slot order. What bounds
// it on this card is rows in flight: small blocks (128 threads) and few
// registers (12 blocks an SM) beat more values in flight a lane, which the
// variant sweep (tools/slot_sum_sweep.py) found slower at every width. A
// row with more than 32 slots that starts before the chunk first finds the
// chunk's first slot by binary search.
//
// Runs kernel (slot_runs_kernel: the kernel gradient; 27 rows of ~20-160
// tiles at C = Cin Cout = 1024-8192 on the 3D maps, 729 rows of a few
// tiles at C = 1024-65536 on the 6D maps). A warp a row would give 27
// rows 32 blocks on 132 SMs, each walking its run one dependent load batch
// at a time. Instead a block takes a (row, slab of 128 columns), V columns
// a thread (one warp of float4 where C and the pointers allow, else 128
// threads of one column): 216 blocks at 27 x 1024. The slab of a row's
// run is one strided region of P; each thread streams its own columns
// through a ring of kStages stages of kStageRows rows in shared memory
// with cp.async (16 or 4 bytes a copy), the next stages in flight while it
// waits for the oldest, whose values it then adds in tile order. A thread
// reads only what it copied itself: no barrier. The time is that of the
// longest run's slabs (the centre offset holds every row: 232 tiles at the
// bench, 605 at KITTI scale), each a serial chain of one warp, so what
// counts is that warp's cost a row: stages of 16 rows with no per-row
// test when full (2 stages, 16 KB a block) beat 8 stages of 8 rows, and
// more stages in flight gained nothing (the sweep). Runs of one or two
// tiles (the 6D maps) take 2 stages of 4 rows (4 KB) and issue out's load
// beside their P copies.
//
// Interface: plain C, loaded with ctypes. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a column count the grid cannot hold.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // by-row kernel: threads a block
constexpr int kBatch = 4;      // values a lane loads before it adds them
// Runs kernel: columns a block (a slab), for long and for short runs.
constexpr int kLongSlab = 128;
constexpr int kShortSlab = 128;

template <int V> struct Vec { using T = float; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <int V, int G, bool kRows>
__global__ void __launch_bounds__(kThreads, 8)
slot_sum_kernel(const float* __restrict__ src,
                const long long* __restrict__ src_rows, int s0, int s1,
                const int* __restrict__ ptr, const int* __restrict__ slots,
                int n_rows, int c, float* __restrict__ out) {
  using T = typename Vec<V>::T;
  const int r = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const int col = (blockIdx.y * G + threadIdx.x % G) * V;
  if (r >= n_rows || col >= c) return;  // no barrier or shuffle below
  int lo = __ldg(ptr + r);
  const int hi = __ldg(ptr + r + 1);
  if (hi - lo > 32 && __ldg(slots + lo) < s0) {  // the first slot >= s0
    int b = hi;
    while (lo < b) {
      const int m = (lo + b) >> 1;
      if (__ldg(slots + m) < s0) lo = m + 1; else b = m;
    }
  }
  T* dst = reinterpret_cast<T*>(out + (size_t)r * c + col);
  T acc = T();
  bool started = false;
  for (int base = lo; base < hi; base += kBatch) {
    int s[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      s[u] = base + u < hi ? __ldg(slots + base + u) : INT_MAX;
    // Every value of the batch in flight at once (and out's, at the first
    // batch that reaches the chunk); the adds then go in slot order.
    T v[kBatch];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (s[u] >= s0 && s[u] < s1) {
        const size_t row = kRows ? (size_t)__ldg(src_rows + s[u]) : (size_t)(s[u] - s0);
        v[u] = __ldg(reinterpret_cast<const T*>(src + row * c + col));
        any = true;
      }
    }
    if (any && !started) {
      acc = *dst;
      started = true;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (s[u] >= s0 && s[u] < s1) add_to(acc, v[u]);
    if (s[kBatch - 1] >= s1) break;  // past the chunk, or the row's end
  }
  if (started) *dst = acc;
}

// One thread's copy of V floats (4 or 16 bytes) from device to shared memory.
template <int V>
__device__ __forceinline__ void cp_async(void* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int V, int kStages, int kStageRows, int kSlab>
__global__ void __launch_bounds__(kSlab / V)
slot_runs_kernel(const float* __restrict__ P, int s0, int s1,
                 const int* __restrict__ ptr, int c, float* __restrict__ out) {
  using T = typename Vec<V>::T;
  constexpr int kW = kSlab / V;  // threads a block
  __shared__ T ring[kStages][kStageRows][kW];
  const int r = blockIdx.x;
  const int col = blockIdx.y * kSlab + threadIdx.x * V;
  if (col >= c) return;  // no barrier below
  const int a = max(__ldg(ptr + r), s0);
  const int n = min(__ldg(ptr + r + 1), s1) - a;  // the run's tiles in the chunk
  if (n <= 0) return;                             // neither read nor written
  const float* next = P + (size_t)(a - s0) * c + col;  // the next stage's first row
  int left = n;                                         // rows not yet copied
  // The next stage's rows into buffer b, one commit group. Past the run's
  // end the group is empty, so that wait_group's count stays in step; a
  // full stage takes no per-row test.
  auto fill = [&](int b) {
    T* buf = &ring[b][0][threadIdx.x];
    if (left >= kStageRows) {
#pragma unroll
      for (int i = 0; i < kStageRows; ++i) cp_async<V>(buf + i * kW, next + (size_t)i * c);
    } else {
#pragma unroll
      for (int i = 0; i < kStageRows; ++i)
        if (i < left) cp_async<V>(buf + i * kW, next + (size_t)i * c);
    }
    cp_async_commit();
    next += (size_t)kStageRows * c;
    left -= kStageRows;
  };
#pragma unroll
  for (int b = 0; b < kStages; ++b) fill(b);
  T* dst = reinterpret_cast<T*>(out + (size_t)r * c + col);
  T acc = *dst;  // in flight beside the copies
  for (int m = n, b = 0; m > 0; m -= kStageRows) {
    cp_async_wait<kStages - 1>();  // the oldest stage has landed
    const T* buf = &ring[b][0][threadIdx.x];
    if (m >= kStageRows) {
#pragma unroll
      for (int i = 0; i < kStageRows; ++i) add_to(acc, buf[i * kW]);
    } else {
#pragma unroll
      for (int i = 0; i < kStageRows; ++i)
        if (i < m) add_to(acc, buf[i * kW]);
    }
    fill(b);  // into the buffer just added, which only this thread reads
    b = b + 1 == kStages ? 0 : b + 1;
  }
  *dst = acc;
}

template <int V, bool kRows>
int launch_rows(const float* src, const long long* rows, int s0, int s1,
                const int* ptr, const int* slots, int n_rows, int c, float* out,
                cudaStream_t st) {
  const int lanes = (c + V - 1) / V;
  const int g = lanes <= 4 ? 4 : lanes <= 8 ? 8 : lanes <= 16 ? 16 : 32;
  const int col_blocks = (lanes + g - 1) / g;
  if (col_blocks > 65535) return (int)cudaErrorInvalidValue;
  const int per_block = kThreads / g;
  const dim3 grid((n_rows + per_block - 1) / per_block, col_blocks);
  switch (g) {
    case 4:
      slot_sum_kernel<V, 4, kRows><<<grid, kThreads, 0, st>>>(src, rows, s0, s1, ptr, slots, n_rows, c, out);
      break;
    case 8:
      slot_sum_kernel<V, 8, kRows><<<grid, kThreads, 0, st>>>(src, rows, s0, s1, ptr, slots, n_rows, c, out);
      break;
    case 16:
      slot_sum_kernel<V, 16, kRows><<<grid, kThreads, 0, st>>>(src, rows, s0, s1, ptr, slots, n_rows, c, out);
      break;
    default:
      slot_sum_kernel<V, 32, kRows><<<grid, kThreads, 0, st>>>(src, rows, s0, s1, ptr, slots, n_rows, c, out);
  }
  return (int)cudaGetLastError();
}

template <bool kRows>
int launch(const void* src, const void* src_rows, int s0, int s1,
           const void* ptr, const void* slots, int n_rows, int c, void* out,
           void* stream) {
  if (n_rows <= 0 || c <= 0 || s1 <= s0) return 0;
  const bool vec4 = c % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(src);
  const auto* rows = static_cast<const long long*>(src_rows);
  const auto* p = static_cast<const int*>(ptr);
  const auto* sl = static_cast<const int*>(slots);
  auto* o = static_cast<float*>(out);
  if (vec4) return launch_rows<4, kRows>(s, rows, s0, s1, p, sl, n_rows, c, o, st);
  return launch_rows<1, kRows>(s, rows, s0, s1, p, sl, n_rows, c, o, st);
}

template <int V, int kStages, int kStageRows, int kSlab>
int launch_runs(const float* P, int s0, int s1, const int* ptr, int n_rows, int c,
                float* out, cudaStream_t st) {
  const int slabs = (c + kSlab - 1) / kSlab;
  if (slabs > 65535) return (int)cudaErrorInvalidValue;
  slot_runs_kernel<V, kStages, kStageRows, kSlab>
      <<<dim3(n_rows, slabs), kSlab / V, 0, st>>>(P, s0, s1, ptr, c, out);
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

// out [>= n_rows, c] += P [s1 - s0, c] over runs: row r adds P row s - s0
// for s in [ptr[r], ptr[r + 1]) within [s0, s1), in order.
// out [>= n_rows, c] += P [s1 - s0, c] over runs: row r adds P row s - s0
// for s in [ptr[r], ptr[r + 1]) within [s0, s1), in order.
extern "C" int dgr_slot_sum_runs(const void* p, int s0, int s1, const void* ptr,
                                 int n_rows, int c, void* out, void* stream) {
  if (n_rows <= 0 || c <= 0 || s1 <= s0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* P = static_cast<const float*>(p);
  const auto* pt = static_cast<const int*>(ptr);
  auto* o = static_cast<float*>(out);
  const bool vec4 = c % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  // The chunk's mean run: 16-row stages for the 3D maps' offsets (~20-160
  // tiles), 4-row ones for the 6D maps' (~1 tile).
  if ((long long)(s1 - s0) >= 8LL * n_rows) {
    if (vec4) return launch_runs<4, 2, 16, kLongSlab>(P, s0, s1, pt, n_rows, c, o, st);
    return launch_runs<1, 2, 16, kLongSlab>(P, s0, s1, pt, n_rows, c, o, st);
  }
  if (vec4) return launch_runs<4, 2, 4, kShortSlab>(P, s0, s1, pt, n_rows, c, o, st);
  return launch_runs<1, 2, 4, kShortSlab>(P, s0, s1, pt, n_rows, c, o, st);
}
