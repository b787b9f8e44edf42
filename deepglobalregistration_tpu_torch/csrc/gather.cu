// Flat int32 gather out[i] = table[idx[i]] for Hopper (sm_90a), two forms.
//
// Replaces the TPU kernels of tools/pallas_gather_bench.py: take_kernel
// replaces pallas_take (:44, a flat take from a table held whole in VMEM)
// and take2d_kernel replaces pallas_take2d (:64, the same function as a row
// gather tab[idx >> 7] followed by the lane select idx & 127). On the TPU
// the two forms differed only in what Mosaic could lower; here they differ
// only in how a table word is addressed.
//
// Contract: every idx[i] lies in [0, W) where W is the table's word count
// (W = rows * 128 for the 2D form). Nothing is checked on the card: an index
// outside the table reads outside it.
//
// What bounds it. By the byte rule (each input read once, each output
// written once): 8 N + 4 W bytes over 3.35 TB/s, against one (flat) or three
// (2D) integer operations an index, so bytes. What a random 4-byte table
// read really costs is a whole 32-byte L2 sector: N * 32 bytes of sector
// traffic (14.2 MB at the bench probe's N = 442368, 56.6 MB at the KITTI
// probe's N = 1769472) beside the 8 N bytes of coalesced index and output
// streams. The probes' tables (2 MiB, 0.84 MiB) are larger than an SM's L1
// and stay in the 50 MB L2, so the rate at which L2 serves random sectors
// sets the pace, not the bytes the rule counts.
//
// Design: thread i reads idx[i] and the table word it names through the
// read-only path (__ldg) and writes the word; a block for every 256
// indices. At the L2's sector rate there is nothing left to schedule: wider
// designs (V indices a thread with all V table reads in flight, streaming
// 16-byte index loads and stores, one wave of blocks) and the table held in
// a thread block cluster's distributed shared memory were measured beside
// this one (tools/gather_variants.cu, tools/gather_sweep.py) and were no
// faster at either probe shape; the wider design pays only for tables that
// an SM's L1 holds, which no configuration of the repo has.
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
