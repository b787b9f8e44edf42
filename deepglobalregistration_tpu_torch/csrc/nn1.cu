// Brute-force 1-nearest-neighbour search (squared L2) for Hopper (sm_90a).
//
// Replaces the TPU kernel deepglobalregistration_tpu/ops/pallas_knn.py
// (_nn_kernel, launched by find_nn_pallas): for every query row of F0 it
// finds the lowest-index row among the first num1 rows of F1 that minimises
// d2 = |a|^2 - 2 a.b + |b|^2, computed in f32 with FMA (no TF32, no bf16).
// Query rows >= num0, and queries with no candidate, return (0, +inf).
// The cross term is an FMA chain over the channels in order; the norms are
// rounded squares summed in channel order (__fmul_rn / __fadd_rn, never
// contracted), as ops/knn.py's plain version sums them, so the two differ
// at most in how the cross term is summed.
//
// What bounds it: the work is N0 * N1 * (2C + 3) f32 operations against
// (N0 + N1) * C * 4 bytes of input, so it is bound by operations (FMA and
// compare issue) on the non-tensor f32 pipes, never by device memory.
// The design keeps every operand on chip: each block owns 32 queries (one
// per lane, the query row held in registers); the block stages tiles of
// 256 candidate rows (128 for C > 32) and their norms through shared
// memory, and each of its 8 (4) warps scans its own 32 candidates of the
// tile, reading candidate values as 16-byte shared-memory broadcasts. Each
// warp keeps a running (min, argmin) per query and visits its candidates in
// ascending index order with a strict '<', so it keeps the lowest index
// among equal distances; the final merge across the warps compares (d, index)
// lexicographically, which preserves the lowest-index tie rule.
//
// Interface: plain C, loaded with ctypes. Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kQueries = 32;  // one query per lane

// CP: channel count padded to a multiple of 4 (registers and shared memory
// only). kWarps: warps per block; the staged tile holds kWarps * 32
// candidates, so wide rows use fewer warps to stay within 48 KB of static
// shared memory.
template <int CP, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
nn1_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
           int n0, int c, int num0, int num1,
           int* __restrict__ out_idx, float* __restrict__ out_d) {
  constexpr int kTile = kWarps * 32;
  __shared__ float4 s_f[kTile][CP / 4];
  __shared__ float s_n[kTile];
  __shared__ float s_best[kWarps][kQueries];
  __shared__ int s_bi[kWarps][kQueries];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kQueries + lane;
  const bool q_ok = q < num0;

  float qv[CP];
  float qn = 0.f;
#pragma unroll
  for (int k = 0; k < CP; ++k) {
    qv[k] = (q_ok && k < c) ? f0[(size_t)q * c + k] : 0.f;
    qn = __fadd_rn(qn, __fmul_rn(qv[k], qv[k]));
  }

  float best = CUDART_INF_F;
  int bi = 0;
  for (int base = 0; base < num1; base += kTile) {
    // Stage candidate rows base .. base + kTile - 1 (zeros past num1).
    {
      const int j = base + threadIdx.x;
      float v[CP];
      float nrm = 0.f;
#pragma unroll
      for (int k = 0; k < CP; ++k) {
        v[k] = (j < num1 && k < c) ? f1[(size_t)j * c + k] : 0.f;
        nrm = __fadd_rn(nrm, __fmul_rn(v[k], v[k]));
      }
#pragma unroll
      for (int k4 = 0; k4 < CP / 4; ++k4)
        s_f[threadIdx.x][k4] = make_float4(v[4 * k4], v[4 * k4 + 1],
                                           v[4 * k4 + 2], v[4 * k4 + 3]);
      s_n[threadIdx.x] = nrm;
    }
    __syncthreads();
    const int lo = warp * 32;
    const int hi = min(lo + 32, num1 - base);
    for (int jj = lo; jj < hi; ++jj) {
      float dot = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < CP / 4; ++k4) {
        const float4 b = s_f[jj][k4];
        dot = fmaf(qv[4 * k4], b.x, dot);
        dot = fmaf(qv[4 * k4 + 1], b.y, dot);
        dot = fmaf(qv[4 * k4 + 2], b.z, dot);
        dot = fmaf(qv[4 * k4 + 3], b.w, dot);
      }
      const float d = fmaf(-2.f, dot, qn) + s_n[jj];
      if (d < best) {
        best = d;
        bi = base + jj;
      }
    }
    __syncthreads();
  }

  s_best[warp][lane] = best;
  s_bi[warp][lane] = bi;
  __syncthreads();
  if (warp == 0 && q < n0) {
    float b = s_best[0][lane];
    int i = s_bi[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float bw = s_best[w][lane];
      const int iw = s_bi[w][lane];
      if (bw < b || (bw == b && iw < i)) {
        b = bw;
        i = iw;
      }
    }
    const bool found = q_ok && b < CUDART_INF_F;
    out_idx[q] = found ? i : 0;
    out_d[q] = found ? b : CUDART_INF_F;
  }
}

template <int CP>
void launch(const float* f0, const float* f1, int n0, int c, int num0,
            int num1, int* idx, float* d, cudaStream_t stream) {
  constexpr int kWarps = CP <= 32 ? 8 : 4;
  const int blocks = (n0 + kQueries - 1) / kQueries;
  nn1_kernel<CP, kWarps><<<blocks, kWarps * 32, 0, stream>>>(
      f0, f1, n0, c, num0, num1, idx, d);
}

}  // namespace

extern "C" int dgr_nn1(const void* f0, const void* f1, int n0, int c,
                       int num0, int num1, void* idx, void* d, void* stream) {
  const float* a = static_cast<const float*>(f0);
  const float* b = static_cast<const float*>(f1);
  int* oi = static_cast<int*>(idx);
  float* od = static_cast<float*>(d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n0 <= 0) return 0;
  if (c <= 4) launch<4>(a, b, n0, c, num0, num1, oi, od, s);
  else if (c <= 8) launch<8>(a, b, n0, c, num0, num1, oi, od, s);
  else if (c <= 16) launch<16>(a, b, n0, c, num0, num1, oi, od, s);
  else if (c <= 32) launch<32>(a, b, n0, c, num0, num1, oi, od, s);
  else if (c <= 64) launch<64>(a, b, n0, c, num0, num1, oi, od, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
