// Variants of the gather probe's kernels, built and timed only by
// tools/gather_sweep.py beside the shipped kernels of csrc/gather.cu (one
// index a thread, a block for every 256 indices).
//
// - Design A: V indices a thread. V = 1 is the shipped body, here so that
//   the sweep can set its shared-memory carveout. For V > 1 a thread reads
//   its V indices as 16-byte loads (8 bytes for V = 2), issues all V table
//   reads before it uses any, and writes the V words with 16-byte stores.
//   Piece p of a thread lies p * (all threads) pieces after its first, so
//   every load and store of a warp is coalesced. The grid is one wave (the
//   resident count from dgr_take_a_resident_blocks) with a grid-stride loop
//   beyond it. The elements before idx and out reach 16-byte alignment
//   (the caller allocates out at idx's offset from it) and the n mod 4 (or
//   2) after the last piece take a scalar path in the first threads. With
//   kCached false the index loads do not allocate in L1
//   (ld.global.nc.L1::no_allocate) and the stores stream (__stcs); with it
//   true they are __ldg loads and plain stores.
// - Design B: the table held in a thread block cluster's distributed shared
//   memory, the Hopper counterpart of the TPU kernel's table resident in
//   VMEM. A cluster of K blocks copies the table into its K blocks' shared
//   memory (a bulk copy of W * 4 / K bytes a block, completion on an
//   mbarrier); after a cluster barrier every lookup is a DSMEM load from the
//   block that holds its word (cluster.map_shared_rank). The grid is the
//   clusters that fit at once; the indices are split over all their blocks
//   with design A's body at V = 4. The table must be a multiple of 128
//   words.
//
// Interface: plain C, loaded with ctypes; entries return cudaError_t values
// (0 on success) unless said otherwise.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;  // design A's threads a block at most
constexpr int kLanes = 128;       // words in a row of the 2D table

// Indices and outputs move in pieces of 16 bytes (8 for V = 2).
template <int V> struct Piece { using T = int4; };
template <> struct Piece<2> { using T = int2; };

template <bool kCached>
__device__ __forceinline__ int4 load_piece(const int4* p) {
  if constexpr (kCached) return __ldg(p);
  int4 r;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

template <bool kCached>
__device__ __forceinline__ int2 load_piece(const int2* p) {
  if constexpr (kCached) return __ldg(p);
  int2 r;
  asm("ld.global.nc.L1::no_allocate.v2.s32 {%0, %1}, [%2];"
      : "=r"(r.x), "=r"(r.y) : "l"(p));
  return r;
}

template <bool kCached, class T>
__device__ __forceinline__ void store(T* p, T v) {
  if constexpr (kCached) *p = v; else __stcs(p, v);
}

// Word k of a piece (k is a constant once the loops are unrolled).
__device__ __forceinline__ int word(const int4& a, int k) {
  return k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
}
__device__ __forceinline__ int word(const int2& a, int k) {
  return k == 0 ? a.x : a.y;
}
__device__ __forceinline__ void set_word(int4& a, int k, int v) {
  if (k == 0) a.x = v; else if (k == 1) a.y = v; else if (k == 2) a.z = v; else a.w = v;
}
__device__ __forceinline__ void set_word(int2& a, int k, int v) {
  if (k == 0) a.x = v; else a.y = v;
}

struct FlatTable {
  const int* table;
  __device__ __forceinline__ int operator()(int v) const {
    return __ldg(table + v);
  }
};

struct RowTable {
  const int* table2d;  // [rows, kLanes]
  __device__ __forceinline__ int operator()(int v) const {
    return __ldg(table2d + (size_t)(v >> 7) * kLanes + (v & (kLanes - 1)));
  }
};

// out[i] = look(idx[i]) for i < n. V = 1: index tid, one a thread. V > 1:
// elements [0, head) and the tail after head + pieces * kWords one a thread,
// the pieces V words a thread a step.
template <int V, bool kCached, class Lookup>
__device__ __forceinline__ void gather(const Lookup& look,
                                       const int* __restrict__ idx,
                                       int* __restrict__ out, int n, int head,
                                       int pieces) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (V == 1) {
    if (tid < n) out[tid] = look(__ldg(idx + tid));
  } else {
    using P = typename Piece<V>::T;
    constexpr int kWords = sizeof(P) / sizeof(int);  // words a piece
    constexpr int kPieces = V / kWords;              // pieces a thread a step
    const int nthreads = gridDim.x * blockDim.x;
    const int body_end = head + pieces * kWords;
    if (tid < head) store<kCached>(out + tid, look(__ldg(idx + tid)));
    if (tid < n - body_end)
      store<kCached>(out + body_end + tid, look(__ldg(idx + body_end + tid)));

    const P* src = reinterpret_cast<const P*>(idx + head);
    P* dst = reinterpret_cast<P*>(out + head);
    for (int base = tid; base < pieces; base += kPieces * nthreads) {
      P in[kPieces];
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
        if (base + p * nthreads < pieces)
          in[p] = load_piece<kCached>(src + base + p * nthreads);
      P res[kPieces];
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
#pragma unroll
        for (int k = 0; k < kWords; ++k)
          if (base + p * nthreads < pieces) set_word(res[p], k, look(word(in[p], k)));
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
        if (base + p * nthreads < pieces)
          store<kCached>(dst + base + p * nthreads, res[p]);
    }
  }
}

template <int V, bool kCached, bool kTwoD>
__global__ void __launch_bounds__(kMaxThreads)
take_a_kernel(const int* __restrict__ table, const int* __restrict__ idx,
              int* __restrict__ out, int n, int head, int pieces) {
  if constexpr (kTwoD)
    gather<V, kCached>(RowTable{table}, idx, out, n, head, pieces);
  else
    gather<V, kCached>(FlatTable{table}, idx, out, n, head, pieces);
}

using Kernel = void (*)(const int*, const int*, int*, int, int, int);

template <bool kTwoD>
Kernel pick_form(int v, int cached) {
  switch (v * 2 + (cached != 0)) {
    case 2: return take_a_kernel<1, false, kTwoD>;
    case 4: return take_a_kernel<2, false, kTwoD>;
    case 5: return take_a_kernel<2, true, kTwoD>;
    case 8: return take_a_kernel<4, false, kTwoD>;
    case 9: return take_a_kernel<4, true, kTwoD>;
    case 16: return take_a_kernel<8, false, kTwoD>;
    case 17: return take_a_kernel<8, true, kTwoD>;
    default: return nullptr;  // V = 1 has no cached form: it stores plainly
  }
}

Kernel pick(int two_d, int v, int cached) {
  return two_d ? pick_form<true>(v, cached) : pick_form<false>(v, cached);
}

constexpr int kClusterThreads = 1024;
constexpr int kChunkBytes = 32768;  // bytes a bulk copy instruction

// A word of the table, read from the shared memory of the cluster's block
// that holds it: block r holds words [r * slice, (r + 1) * slice).
template <bool kTwoD>
struct ClusterTable {
  const int* part;  // this block's slice (a shared-memory address)
  int slice;        // words a block holds, a multiple of kLanes
  __device__ __forceinline__ int operator()(int v) const {
    int r, off;
    if (kTwoD) {
      const int row = v >> 7, lane = v & (kLanes - 1), rows = slice >> 7;
      r = row / rows;
      off = ((row - r * rows) << 7) + lane;
    } else {
      r = v / slice;
      off = v - r * slice;
    }
    return cg::this_cluster().map_shared_rank(part, r)[off];
  }
};

__device__ __forceinline__ bool barrier_done(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

template <bool kTwoD>
__global__ void __launch_bounds__(kClusterThreads, 1)
take_cluster_kernel(const int* __restrict__ table, int words, int slice,
                    const int* __restrict__ idx, int* __restrict__ out, int n,
                    int head, int pieces) {
  extern __shared__ int4 smem[];
  __shared__ uint64_t bar;
  int* part = reinterpret_cast<int*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int lo = (int)cluster.block_rank() * slice;
  const int bytes = 4 * max(0, min(slice, words - lo));
  const unsigned bar_s = (unsigned)__cvta_generic_to_shared(&bar);
  const unsigned part_s = (unsigned)__cvta_generic_to_shared(part);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar_s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar_s), "r"(bytes) : "memory");
    const char* src = reinterpret_cast<const char*>(table + lo);
    for (int off = 0; off < bytes; off += kChunkBytes)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          :: "r"(part_s + off), "l"(src + off),
             "r"(min(kChunkBytes, bytes - off)), "r"(bar_s)
          : "memory");
  }
  __syncthreads();
  while (!barrier_done(bar_s, 0)) {
  }
  cluster.sync();  // every block's slice is in place
  gather<4, false>(ClusterTable<kTwoD>{part, slice}, idx, out, n, head, pieces);
  cluster.sync();  // no block leaves while another reads its slice
}

using ClusterKernel = void (*)(const int*, int, int, const int*, int*, int,
                               int, int);

// The launch configuration of design B, or an error: slice and shared
// memory a block, and the grid of the clusters that fit at once.
cudaError_t cluster_config(int two_d, int words, int k, int threads,
                           ClusterKernel* kernel, int* slice,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *kernel = two_d ? take_cluster_kernel<true> : take_cluster_kernel<false>;
  if (k < 1 || k > 16 || threads <= 0 || threads > kClusterThreads ||
      words <= 0 || words % kLanes != 0)
    return cudaErrorInvalidValue;
  *slice = ((words + k - 1) / k + kLanes - 1) / kLanes * kLanes;
  const int smem = *slice * 4;
  cudaError_t e = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && k > 8)
    e = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  cfg->gridDim = dim3(k);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, *kernel, cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg->gridDim = dim3(clusters * k);
  return cudaSuccess;
}

// head and pieces describe n words cut into a scalar head (at most 3), whole
// pieces of `words` words and a scalar tail shorter than a piece.
bool pieces_ok(int n, int head, int pieces, int words) {
  const long long tail = n - head - (long long)pieces * words;
  return n > 0 && head >= 0 && head <= 3 && pieces >= 0 && tail >= 0 &&
         tail < words;
}

bool aligned(const void* idx, const void* out, int head) {
  return ((uintptr_t)idx + 4 * head) % 16 == 0 &&
         ((uintptr_t)out + 4 * head) % 16 == 0;
}

}  // namespace

// Blocks of design A that fit on the current device at once, or -1.
extern "C" int dgr_take_a_resident_blocks(int two_d, int v, int cached,
                                          int threads) {
  const Kernel kernel = pick(two_d, v, cached);
  int per_sm = 0, dev = 0, sms = 0;
  if (kernel == nullptr || threads <= 0 || threads > kMaxThreads) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void*>(kernel), threads, 0) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

// Design A. carveout: the kernel's preferred shared-memory carveout in
// percent (0: the most L1), or -1 for CUDA's default; it is set on every
// call, since it belongs to the kernel and not to the launch.
extern "C" int dgr_take_a(int two_d, int cached, const void* table,
                          const void* idx, void* out, int n, int v,
                          int threads, int blocks, int head, int pieces,
                          int carveout, void* stream) {
  const Kernel kernel = pick(two_d, v, cached);
  const int words = v < 4 ? v : 4;
  if (kernel == nullptr || threads <= 0 || threads > kMaxThreads ||
      blocks <= 0 || !pieces_ok(n, head, pieces, words) ||
      (long long)blocks * threads < (v == 1 ? n : 4))
    return (int)cudaErrorInvalidValue;
  if (v == 1 && (head != 0 || pieces != n)) return (int)cudaErrorInvalidValue;
  if (v > 1 && pieces > 0 && !aligned(idx, out, head))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (e != cudaSuccess) return (int)e;
  const int* t = static_cast<const int*>(table);
  const int* i = static_cast<const int*>(idx);
  int* o = static_cast<int*>(out);
  void* args[] = {&t, &i, &o, &n, &head, &pieces};
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                               dim3(blocks), dim3(threads), args, 0,
                               static_cast<cudaStream_t>(stream));
}

// Blocks in design B's grid (clusters that fit at once, times k), or minus
// the error.
extern "C" int dgr_take_cluster_blocks(int two_d, int words, int k,
                                       int threads) {
  ClusterKernel kernel;
  int slice;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t e =
      cluster_config(two_d, words, k, threads, &kernel, &slice, &cfg, &attr);
  return e == cudaSuccess ? (int)cfg.gridDim.x : -(int)e;
}

// Design B. head and pieces as for design A at V = 4.
extern "C" int dgr_take_cluster(int two_d, const void* table, int words,
                                const void* idx, void* out, int n, int k,
                                int threads, int head, int pieces,
                                void* stream) {
  ClusterKernel kernel;
  int slice;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e =
      cluster_config(two_d, words, k, threads, &kernel, &slice, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  if (!pieces_ok(n, head, pieces, 4) || ((uintptr_t)table % 16) != 0 ||
      (pieces > 0 && !aligned(idx, out, head)))
    return (int)cudaErrorInvalidValue;
  cfg.stream = static_cast<cudaStream_t>(stream);
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const int*>(table),
                                 words, slice, static_cast<const int*>(idx),
                                 static_cast<int*>(out), n, head, pieces);
}
