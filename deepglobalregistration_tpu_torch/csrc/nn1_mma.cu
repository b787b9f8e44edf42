// Brute-force 1-nearest-neighbour search (squared L2) for wide rows,
// 8 < C <= 64, on the tensor cores of Hopper (sm_90a) in 3xTF32. The feature
// match (C = 32) runs here.
//
// Replaces the TPU kernel deepglobalregistration_tpu/ops/pallas_knn.py
// (_nn_kernel, launched by find_nn_pallas), which put the cross term on the
// matrix unit at Precision.HIGHEST. Contract: for every one of the first
// num0 rows of F0, the lowest-index row among the first num1 rows of F1
// that minimises d2 = |a|^2 - 2 a.b + |b|^2 in f32; rows >= num0, and
// queries with no candidate, return (0, +inf).
//
// Arithmetic. Each f32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna: the tensor cores would truncate), and the
// cross term is hi.hi + (lo.hi + hi.lo) from
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, the two small products in an
// accumulator of their own, added to the large one(s) at the end. Products of
// tf32 values are exact in f32, so what is lost is the lo.lo term (2^-22
// of |a||b|) and the accumulators' rounding. The norms are rounded squares
// summed in channel order on the CUDA cores (the plain version's order);
// d2 = fmaf(-2, cross, |a|^2) + |b|^2. d2 lies within 2^-20 (|a|^2 + |b|^2)
// of its exact value; identical rows give identical products, so exact
// duplicates tie exactly and the lowest index wins.
//
// What bounds it: 3 * 2 * N0 * N1 * C tensor-core operations (495 TFLOP/s
// dense TF32) against (N0 + N1) * C * 4 bytes, so the tensor cores and the
// epilogue's issue slots, never device memory. The design:
//  - a pre-pass splits F1 into hi/lo once and lays each tile of 8
//    candidates out in B-fragment order ([tile][k-step][lane] float4s of
//    hi(b0), hi(b1), lo(b0), lo(b1)), with the norms beside them (+inf past
//    num1, so no column mask in the scan), and sets every key to kNoKey;
//  - a block of 8 warps owns 16 * kMT query rows a warp, their hi/lo
//    A-fragments in registers for the whole scan;
//  - tiles of 64 candidates stream into a kStages ring in shared memory
//    with 16-byte cp.async copies; each warp reads its B fragments as
//    conflict-free LDS.128, so a staged tile feeds all 8 warps;
//  - the epilogue works on the accumulators in registers: each thread keeps
//    a running (min, argmin) for its two rows over its own columns, in
//    ascending order with a strict '<'; the 4 lanes of a quad that share a
//    row merge with __shfl_xor_sync by (d2, index), and the candidate
//    splits of the grid meet through the key of nn1_common.cuh;
//  - a batch of pairs (register_batch's feature match) runs as one launch
//    sequence with the grid's z axis over the pairs, bit for bit each
//    pair's own launch (see nn1_common.cuh).
//
// Interface: plain C, loaded with ctypes. The caller allocates the
// workspace (dgr_nn1_mma_workspace bytes). Returns cudaGetLastError().

#include "nn1_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 64;           // candidates a staged tile
constexpr int kSub = kTileN / 8;     // n8 sub-tiles a tile
constexpr int kStages = 3;

template <int KS>  // m16 tiles a warp
__host__ __device__ constexpr int m_tiles() { return KS <= 4 ? 2 : 1; }

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void take(float d, int j, float& best, int& bi) {
  if (d < best) {
    best = d;
    bi = j;
  }
}

// Fragment-ordered hi/lo candidates, their norms, and the keys' reset.
// Item i of the fragments: lane L = i % 32 (g = L / 4, t = L % 4), k-step
// ks = (i / 32) % KS, sub-tile s = i / (32 KS); it holds candidate s*8 + g
// at channels ks*8 + t and ks*8 + t + 4 (B[k][n] of the m16n8k8 fragment).
// Grid: (item blocks, pairs).
template <int KS>
__global__ void pack_kernel(const float* __restrict__ f1, int c,
                            nn1::Counts cnt, int n1p,
                            float4* __restrict__ frags,
                            float* __restrict__ norms,
                            unsigned long long* __restrict__ keys) {
  const int pair = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cnt.n0) keys[static_cast<size_t>(pair) * cnt.n0 + i] = nn1::kNoKey;
  const int num1 = cnt.c(pair);
  f1 += static_cast<size_t>(pair) * cnt.n1 * c;
  frags += static_cast<size_t>(pair) * (n1p / 8) * KS * 32;
  norms += static_cast<size_t>(pair) * n1p;
  if (i < n1p) {
    float nrm = CUDART_INF_F;  // rows past num1 never win
    if (i < num1) {
      nrm = 0.f;
      for (int k = 0; k < c; ++k) {
        const float v = f1[static_cast<size_t>(i) * c + k];
        nrm = __fadd_rn(nrm, __fmul_rn(v, v));
      }
    }
    norms[i] = nrm;
  }
  if (i < n1p / 8 * KS * 32) {
    const int lane = i & 31, ks = (i >> 5) % KS, s = i / (32 * KS);
    const int n = s * 8 + (lane >> 2), k = ks * 8 + (lane & 3);
    const float* row = f1 + static_cast<size_t>(n) * c;
    const float x0 = (n < num1 && k < c) ? row[k] : 0.f;
    const float x1 = (n < num1 && k + 4 < c) ? row[k + 4] : 0.f;
    const uint32_t h0 = tf32(x0), h1 = tf32(x1);
    frags[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                           __uint_as_float(tf32(x0 - __uint_as_float(h0))),
                           __uint_as_float(tf32(x1 - __uint_as_float(h1))));
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads, 2)
mma_kernel(const float* __restrict__ f0, int c, nn1::Counts cnt,
           const float4* __restrict__ frags, const float* __restrict__ norms,
           int n_tiles, int chunk, unsigned long long* __restrict__ keys) {
  constexpr int MT = m_tiles<KS>();
  constexpr int kFragF4 = kSub * KS * 32;  // fragment float4s a tile
  constexpr int kStageF4 = kFragF4 + kTileN / 4;
  // The large products run in chains of at most 4 k-steps (32 channels):
  // the tensor cores' f32 accumulation loses more than round-to-nearest
  // would, step by step (one chain of 8 k-steps, C = 64, reached 0.86 of
  // the 2^-20 tolerance on exact duplicates), so short chains bound it.
  constexpr int kChains = (KS + 3) / 4;
  extern __shared__ float4 ring[];  // kStages x (fragments, norms)

  // Pair z's query tile and candidate chunk; a block past its pair's num0
  // or num1 has nothing to do (the whole block leaves together).
  const int pair = blockIdx.z;
  const int num0 = cnt.q(pair);
  const int t0 = blockIdx.y * chunk;
  const int t1 = min(t0 + chunk, (cnt.c(pair) + kTileN - 1) / kTileN);
  if (static_cast<int>(blockIdx.x) * kWarps * 16 * MT >= num0 || t0 >= t1)
    return;
  f0 += static_cast<size_t>(pair) * cnt.n0 * c;
  frags += static_cast<size_t>(pair) * n_tiles * kFragF4;
  norms += static_cast<size_t>(pair) * n_tiles * kTileN;
  keys += static_cast<size_t>(pair) * cnt.n0;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row_base = (blockIdx.x * kWarps + warp) * 16 * MT + g;

  // A fragments (hi, lo) and the norms of rows row_base + 16 mt + {0, 8}.
  uint32_t ah[MT][KS][4], al[MT][KS][4];
  float qn[MT][2], best[MT][2];
  int bi[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_base + 16 * mt + 8 * h;
      const float* row = f0 + static_cast<size_t>(r) * c;
      float nrm = 0.f;
      if (r < num0)
        for (int k = 0; k < c; ++k) nrm = __fadd_rn(nrm, __fmul_rn(row[k], row[k]));
      qn[mt][h] = nrm;
      best[mt][h] = CUDART_INF_F;
      bi[mt][h] = 0;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // a0/a1: column t; a2/a3: t + 4
          const int k = ks * 8 + t + 4 * e;
          const float x = (r < num0 && k < c) ? row[k] : 0.f;
          const uint32_t hi = tf32(x);
          ah[mt][ks][2 * e + h] = hi;
          al[mt][ks][2 * e + h] = tf32(x - __uint_as_float(hi));
        }
      }
    }
  }

  auto load = [&](int tile) {
    float4* dst = ring + ((tile - t0) % kStages) * kStageF4;
    const float4* src = frags + static_cast<size_t>(tile) * kFragF4;
#pragma unroll
    for (int i = threadIdx.x; i < kFragF4; i += kThreads)
      nn1::cp_async16(dst + i, src + i);
    if (threadIdx.x < kTileN / 4)
      nn1::cp_async16(dst + kFragF4 + threadIdx.x,
                      norms + static_cast<size_t>(tile) * kTileN + 4 * threadIdx.x);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t0 + s < t1) load(t0 + s);
    nn1::cp_async_commit();
  }
  for (int tile = t0; tile < t1; ++tile) {
    nn1::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (tile + kStages - 1 < t1) load(tile + kStages - 1);
    nn1::cp_async_commit();
    const float4* stage = ring + ((tile - t0) % kStages) * kStageF4;
    const float2* nrm = reinterpret_cast<const float2*>(stage + kFragF4);
#pragma unroll 1
    for (int sub = 0; sub < kSub; ++sub) {
      uint32_t bh[KS][2], bl[KS][2];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const float4 v = stage[(sub * KS + ks) * 32 + lane];
        bh[ks][0] = __float_as_uint(v.x);
        bh[ks][1] = __float_as_uint(v.y);
        bl[ks][0] = __float_as_uint(v.z);
        bl[ks][1] = __float_as_uint(v.w);
      }
      const float2 n1 = nrm[sub * 4 + t];  // columns 2t, 2t + 1
      const int j = tile * kTileN + sub * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float big[kChains][4] = {}, small[4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma(small, al[mt][ks], bh[ks][0], bh[ks][1]);
          mma(small, ah[mt][ks], bl[ks][0], bl[ks][1]);
          mma(big[ks / 4], ah[mt][ks], bh[ks][0], bh[ks][1]);
        }
        // c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8.
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = big[0][e];
#pragma unroll
          for (int ch = 1; ch < kChains; ++ch) sum = __fadd_rn(sum, big[ch][e]);
          const float cross = __fadd_rn(sum, small[e]);
          const float d = __fadd_rn(fmaf(-2.f, cross, qn[mt][e >> 1]),
                                    (e & 1) ? n1.y : n1.x);
          take(d, j + (e & 1), best[mt][e >> 1], bi[mt][e >> 1]);
        }
      }
    }
  }
  nn1::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float b = best[mt][h];
      int i = bi[mt][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the quad sharing the row
        const float ob = __shfl_xor_sync(0xffffffffu, b, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        if (ob < b || (ob == b && oi < i)) {
          b = ob;
          i = oi;
        }
      }
      const int r = row_base + 16 * mt + 8 * h;
      if (t == 0 && r < num0 && b < CUDART_INF_F)
        atomicMin(keys + r, nn1::make_key(b, i));
    }
  }
}

struct Layout {
  int n_tiles;
  size_t keys_bytes, frag_bytes, norm_bytes;
};

// rows1: candidate rows packed a pair (num1 for one pair, n1 for a batch).
Layout layout(int batch, int n0, int c, int rows1) {
  Layout l;
  const int ks = (c + 7) / 8;
  l.n_tiles = (rows1 + kTileN - 1) / kTileN;
  l.keys_bytes = nn1::align256(static_cast<size_t>(batch) * n0 * 8);
  l.frag_bytes = nn1::align256(static_cast<size_t>(batch) * l.n_tiles * kSub *
                               ks * 32 * 16);
  l.norm_bytes = static_cast<size_t>(batch) * l.n_tiles * kTileN * 4;
  return l;
}

template <int KS>
int launch(const float* f0, const float* f1, int batch, int c, nn1::Counts cnt,
           int rows0, int rows1, char* ws, int* idx, float* d,
           cudaStream_t stream) {
  constexpr int kSmem = kStages * (kSub * KS * 32 + kTileN / 4) * 16;
  constexpr int kQueriesPerBlock = kWarps * 16 * m_tiles<KS>();
  const Layout l = layout(batch, cnt.n0, c, rows1);
  auto* keys = reinterpret_cast<unsigned long long*>(ws);
  auto* frags = reinterpret_cast<float4*>(ws + l.keys_bytes);
  auto* norms = reinterpret_cast<float*>(ws + l.keys_bytes + l.frag_bytes);
  const int n1p = l.n_tiles * kTileN;
  const int pack_n = max(cnt.n0, n1p / 8 * KS * 32);
  pack_kernel<KS><<<dim3((pack_n + 255) / 256, batch), 256, 0, stream>>>(
      f1, c, cnt, n1p, frags, norms, keys);
  if (rows0 > 0 && l.n_tiles > 0) {
    static int resident = 0;  // blocks resident on the card (one device)
    if (resident == 0) {
      cudaFuncSetAttribute(mma_kernel<KS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      int per_sm = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mma_kernel<KS>,
                                                    kThreads, kSmem);
      resident = max(1, per_sm) * nn1::sm_count();
    }
    const int q_tiles = (rows0 + kQueriesPerBlock - 1) / kQueriesPerBlock;
    const int chunk = nn1::choose_chunk(q_tiles * batch, l.n_tiles, resident, 2);
    const dim3 grid(q_tiles, (l.n_tiles + chunk - 1) / chunk, batch);
    mma_kernel<KS><<<grid, kThreads, kSmem, stream>>>(
        f0, c, cnt, frags, norms, l.n_tiles, chunk, keys);
  }
  nn1::decode_kernel<<<dim3((cnt.n0 + 255) / 256, batch), 256, 0, stream>>>(
      keys, cnt, idx, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows1 is the candidates packed a pair: num1 for one pair (nums null),
// all n1 rows for a batch (each pair's own count is read on the device).
extern "C" long long dgr_nn1_mma_workspace(int batch, int n0, int c,
                                           int rows1) {
  const Layout l = layout(batch, n0, c, rows1);
  return static_cast<long long>(l.keys_bytes + l.frag_bytes + l.norm_bytes);
}

// f0 [batch, n0, c], f1 [batch, n1, c]; idx, d [batch, n0]. nums: null for
// one pair (batch 1, counts num0 / num1), else [batch, 2] int32 on the
// device.
extern "C" int dgr_nn1_mma(const void* f0, const void* f1, int batch, int n0,
                           int n1, int c, int num0, int num1, const void* nums,
                           void* ws, void* idx, void* d, void* stream) {
  const float* a = static_cast<const float*>(f0);
  const float* b = static_cast<const float*>(f1);
  const nn1::Counts cnt{static_cast<const int*>(nums), num0, num1, n0, n1};
  const int rows0 = nums ? n0 : num0, rows1 = nums ? n1 : num1;
  char* w = static_cast<char*>(ws);
  int* oi = static_cast<int*>(idx);
  float* od = static_cast<float*>(d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n0 <= 0) return 0;
  switch ((c + 7) / 8) {
#define DGR_CASE(KS) \
    case KS: return launch<KS>(a, b, batch, c, cnt, rows0, rows1, w, oi, od, s);
    DGR_CASE(2) DGR_CASE(3) DGR_CASE(4) DGR_CASE(5)
    DGR_CASE(6) DGR_CASE(7) DGR_CASE(8)
#undef DGR_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
