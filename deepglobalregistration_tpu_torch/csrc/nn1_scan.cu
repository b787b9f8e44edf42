// Brute-force 1-nearest-neighbour search (squared L2) for narrow rows,
// C <= 8, on the CUDA cores of Hopper (sm_90a). The ICP's full scan (C = 3,
// every iteration) runs here.
//
// Replaces the TPU kernel deepglobalregistration_tpu/ops/pallas_knn.py
// (_nn_kernel, launched by find_nn_pallas): for every one of the first num0
// rows of F0, the lowest-index row among the first num1 rows of F1 that
// minimises d2 = |a|^2 - 2 a.b + |b|^2 in f32; rows >= num0, and queries
// with no candidate, return (0, +inf). The arithmetic of each pair is that
// of ops/knn.py's plain version, bit for bit: the cross term is an FMA chain
// over channels 0..C-1 from 0, d2 = fmaf(-2, dot, |a|^2) + |b|^2, and both
// norms are rounded squares summed in channel order. (The ICP's stop rule
// is driven by d2's rounding, so d2 must not move.)
//
// What bounds it: N0 * N1 * (2C + 3) f32 operations on (N0 + N1) * C * 4
// bytes, so issue slots on the non-tensor pipes, never device memory. At
// C = 3 a pair costs ~8 instructions (3 FMA for the dot, FMA and add for
// d2, compare and two selects). The design spends next to nothing else:
//  - a pre-pass packs each candidate row once into float4s (x, y, z, |b|^2
//    at C = 3; channels, norm, zeros above), with |b|^2 = +inf past num1,
//    so the scan needs no bound check and no padding FMA;
//  - each thread holds kQ queries in registers, so one broadcast LDS.128
//    of a candidate feeds kQ queries;
//  - candidate tiles stream into a kStages ring in shared memory with
//    16-byte cp.async copies (coalesced), the next tiles' loads in flight
//    while a tile is scanned, one __syncthreads a tile;
//  - the grid is (query tiles) x (candidate splits) x (pairs), sized to
//    fill the SMs; each thread visits its candidates in ascending order
//    with a strict '<' and the splits meet through the (d2, index) key of
//    nn1_common.cuh, so the lowest index wins every tie;
//  - a batch of pairs (register_batch's ICP scan, one launch a step) runs
//    as one launch sequence, bit for bit each pair's own launch (see
//    nn1_common.cuh).
//
// Interface: plain C, loaded with ctypes. The caller allocates the
// workspace (dgr_nn1_scan_workspace bytes). Returns cudaGetLastError().

#include "nn1_common.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block, and candidates a tile
constexpr int kQ = 8;          // queries a thread
constexpr int kStages = 3;
constexpr int kQueriesPerBlock = kThreads * kQ;

template <int C>  // float4s a packed row
__host__ __device__ constexpr int slots() { return (C + 4) / 4; }

// Packs candidate rows 0 .. n1p-1 of every pair and sets every query's key
// to kNoKey. Grid: (row blocks, pairs).
template <int C>
__global__ void pack_kernel(const float* __restrict__ f1, nn1::Counts cnt,
                            int n1p, float4* __restrict__ packed,
                            unsigned long long* __restrict__ keys) {
  constexpr int NS = slots<C>();
  const int b = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < cnt.n0) keys[static_cast<size_t>(b) * cnt.n0 + j] = nn1::kNoKey;
  if (j >= n1p) return;
  const int num1 = cnt.c(b);
  f1 += static_cast<size_t>(b) * cnt.n1 * C;
  packed += static_cast<size_t>(b) * n1p * NS;
  float v[NS * 4];
#pragma unroll
  for (int k = 0; k < NS * 4; ++k) v[k] = 0.f;
  float nrm = CUDART_INF_F;  // rows past num1 never win
  if (j < num1) {
    nrm = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      v[k] = f1[static_cast<size_t>(j) * C + k];
      nrm = __fadd_rn(nrm, __fmul_rn(v[k], v[k]));
    }
  }
  v[C] = nrm;
#pragma unroll
  for (int s = 0; s < NS; ++s)
    packed[static_cast<size_t>(j) * NS + s] =
        make_float4(v[4 * s], v[4 * s + 1], v[4 * s + 2], v[4 * s + 3]);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 4)
scan_kernel(const float* __restrict__ f0, nn1::Counts cnt,
            const float4* __restrict__ packed, int n_tiles, int chunk,
            unsigned long long* __restrict__ keys) {
  constexpr int NS = slots<C>();
  __shared__ float4 ring[kStages][kThreads * NS];

  // Pair b's query tile and candidate chunk; a block past its pair's num0
  // or num1 has nothing to do (the whole block leaves together).
  const int pair = blockIdx.z;
  const int num0 = cnt.q(pair);
  const int t0 = blockIdx.y * chunk;
  const int t1 = min(t0 + chunk, (cnt.c(pair) + kThreads - 1) / kThreads);
  if (static_cast<int>(blockIdx.x) * kQueriesPerBlock >= num0 || t0 >= t1)
    return;
  f0 += static_cast<size_t>(pair) * cnt.n0 * C;
  packed += static_cast<size_t>(pair) * n_tiles * kThreads * NS;
  keys += static_cast<size_t>(pair) * cnt.n0;

  const int q0 = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  float qv[kQ][C], qn[kQ], best[kQ];
  int bi[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int q = q0 + i * kThreads;
    qn[i] = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      qv[i][k] = q < num0 ? f0[static_cast<size_t>(q) * C + k] : 0.f;
      qn[i] = __fadd_rn(qn[i], __fmul_rn(qv[i][k], qv[i][k]));
    }
    best[i] = CUDART_INF_F;
    bi[i] = 0;
  }

  auto load = [&](int t) {
    const float4* src = packed + static_cast<size_t>(t) * kThreads * NS;
    float4* dst = ring[(t - t0) % kStages];
#pragma unroll
    for (int s = 0; s < NS; ++s)
      nn1::cp_async16(dst + s * kThreads + threadIdx.x,
                      src + s * kThreads + threadIdx.x);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t0 + s < t1) load(t0 + s);
    nn1::cp_async_commit();
  }
  for (int t = t0; t < t1; ++t) {
    nn1::cp_async_wait<kStages - 2>();  // tile t has landed (own copies)
    __syncthreads();                    // everyone's; tile t-1 is done
    if (t + kStages - 1 < t1) load(t + kStages - 1);
    nn1::cp_async_commit();
    const float4* tile = ring[(t - t0) % kStages];
    const int base = t * kThreads;
#pragma unroll 8
    for (int jj = 0; jj < kThreads; ++jj) {
      float b[NS * 4];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 v = tile[jj * NS + s];
        b[4 * s] = v.x;
        b[4 * s + 1] = v.y;
        b[4 * s + 2] = v.z;
        b[4 * s + 3] = v.w;
      }
      const int j = base + jj;
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        float dot = fmaf(qv[i][0], b[0], 0.f);
#pragma unroll
        for (int k = 1; k < C; ++k) dot = fmaf(qv[i][k], b[k], dot);
        const float d = __fadd_rn(fmaf(-2.f, dot, qn[i]), b[C]);
        if (d < best[i]) {
          best[i] = d;
          bi[i] = j;
        }
      }
    }
  }
  nn1::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int q = q0 + i * kThreads;
    if (q < num0 && best[i] < CUDART_INF_F)
      atomicMin(keys + q, nn1::make_key(best[i], bi[i]));
  }
}

struct Layout {
  int n_tiles;
  size_t keys_bytes, packed_bytes;
};

// rows1: candidate rows packed a pair (num1 for one pair, n1 for a batch).
Layout layout(int batch, int n0, int c, int rows1) {
  Layout l;
  l.n_tiles = (rows1 + kThreads - 1) / kThreads;
  l.keys_bytes = nn1::align256(static_cast<size_t>(batch) * n0 * 8);
  l.packed_bytes = static_cast<size_t>(batch) * l.n_tiles * kThreads *
                   ((c + 4) / 4) * 16;
  return l;
}

template <int C>
int launch(const float* f0, const float* f1, int batch, nn1::Counts cnt,
           int rows0, int rows1, char* ws, int* idx, float* d,
           cudaStream_t stream) {
  const Layout l = layout(batch, cnt.n0, C, rows1);
  auto* keys = reinterpret_cast<unsigned long long*>(ws);
  auto* packed = reinterpret_cast<float4*>(ws + l.keys_bytes);
  const int n1p = l.n_tiles * kThreads;
  const int pack_n = max(cnt.n0, n1p);
  pack_kernel<C><<<dim3((pack_n + 255) / 256, batch), 256, 0, stream>>>(
      f1, cnt, n1p, packed, keys);
  if (rows0 > 0 && l.n_tiles > 0) {
    static int resident = 0;  // blocks resident on the card (one device)
    if (resident == 0) {
      int per_sm = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_kernel<C>,
                                                    kThreads, 0);
      resident = max(1, per_sm) * nn1::sm_count();
    }
    const int q_tiles = (rows0 + kQueriesPerBlock - 1) / kQueriesPerBlock;
    const int chunk = nn1::choose_chunk(q_tiles * batch, l.n_tiles, resident, 1);
    const dim3 grid(q_tiles, (l.n_tiles + chunk - 1) / chunk, batch);
    scan_kernel<C><<<grid, kThreads, 0, stream>>>(f0, cnt, packed, l.n_tiles,
                                                 chunk, keys);
  }
  nn1::decode_kernel<<<dim3((cnt.n0 + 255) / 256, batch), 256, 0, stream>>>(
      keys, cnt, idx, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows1 is the candidates packed a pair: num1 for one pair (nums null),
// all n1 rows for a batch (each pair's own count is read on the device).
extern "C" long long dgr_nn1_scan_workspace(int batch, int n0, int c,
                                            int rows1) {
  const Layout l = layout(batch, n0, c, rows1);
  return static_cast<long long>(l.keys_bytes + l.packed_bytes);
}

// f0 [batch, n0, c], f1 [batch, n1, c]; idx, d [batch, n0]. nums: null for
// one pair (batch 1, counts num0 / num1), else [batch, 2] int32 on the
// device.
extern "C" int dgr_nn1_scan(const void* f0, const void* f1, int batch, int n0,
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
  switch (c) {
#define DGR_CASE(C) \
    case C: return launch<C>(a, b, batch, cnt, rows0, rows1, w, oi, od, s);
    DGR_CASE(1) DGR_CASE(2) DGR_CASE(3) DGR_CASE(4)
    DGR_CASE(5) DGR_CASE(6) DGR_CASE(7) DGR_CASE(8)
#undef DGR_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
