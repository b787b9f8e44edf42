// Flat int32 gather out[i] = table[idx[i]] for Hopper (sm_90a), two forms.
//
// Replaces the TPU kernels of tools/pallas_gather_bench.py: pallas_take
// (a flat take from a table held whole in VMEM) and pallas_take2d (the same
// function as a row gather tab[idx >> 7] followed by the lane select
// idx & 127). On the TPU the two forms differed only in what Mosaic could
// lower. Here both are one thread per index: read the index, read the table
// word it names through the read-only path (__ldg), write the word.
//
// Contract: every idx[i] lies in [0, W) where W is the table's word count
// (W = rows * 128 for the 2D form). Nothing is checked on the card: an index
// outside the table reads outside it.
//
// What bounds it: N * 4 bytes of indices read, N * 4 bytes written and the
// table's W * 4 bytes read once, against one or three integer operations per
// index, so it is bound by bytes. The probe's 2 MiB table stays in the 50 MB
// L2 after its first touch, so the random 4-byte table reads are served from
// L2 sectors; the index and output streams are coalesced. The table is not
// staged in shared memory: 2 MiB does not fit a block's 227 KB.
//
// Interface: plain C, loaded with ctypes. Returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;  // words in a row of the 2D table

__global__ void __launch_bounds__(kThreads)
take_kernel(const int* __restrict__ table, const int* __restrict__ idx,
            int n, int* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = __ldg(table + __ldg(idx + i));
}

__global__ void __launch_bounds__(kThreads)
take2d_kernel(const int* __restrict__ table2d, const int* __restrict__ idx,
              int n, int* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    const int v = __ldg(idx + i);
    const int row = v >> 7;
    const int lane = v & (kLanes - 1);
    out[i] = __ldg(table2d + (size_t)row * kLanes + lane);
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int dgr_take(const void* table, const void* idx, int n, void* out,
                        void* stream) {
  if (n <= 0) return 0;
  take_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(idx), n,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

extern "C" int dgr_take2d(const void* table2d, const void* idx, int n,
                          void* out, void* stream) {
  if (n <= 0) return 0;
  take2d_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table2d), static_cast<const int*>(idx), n,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}
