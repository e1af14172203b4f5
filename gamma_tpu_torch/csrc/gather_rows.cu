// Row gather for Hopper (sm_90a): the kernel X1.
//
// Replaces the TPU kernel of experiments/exp_rerank.py, gather_rows_pallas
// (its inline kernel, rps row DMAs in flight per grid step).
//
// Contract: out[i, :] = table[idx[i], :] for 0 <= idx[i] < n, and a row of
// zeros for any other index (the TPU kernel leaves those undefined).  Rows
// are copied bit for bit, whatever the element type.
//
// What bounds it on the H100.  It does no arithmetic: each output row reads
// one table row and writes it once, k * row_bytes each way (at the exact
// rerank's geometry, 102,400 bf16 rows of 256 bytes: 26.2 MB + 26.2 MB,
// ~16 us at 3.35 TB/s).  The reads are random 256-byte rows, so the time
// is set by how many row reads are in flight to hide device-memory latency.
// Design: `tpr` threads per row (a power of two up to a warp, enough for
// one 16-byte unit each at d 128 bf16), 16-byte loads and stores when the
// row and both base pointers allow it, else one element per unit; a
// 256-thread block copies 256 / tpr rows and every SM holds several
// blocks, so thousands of independent row reads are in flight at once.
// The TPU kernel's sequential grid of DMA descriptors has no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Unit, typename Idx>
__global__ void gather_rows_kernel(const Unit* __restrict__ table,
                                   long long n,
                                   const Idx* __restrict__ idx,
                                   Unit* __restrict__ out, long long k,
                                   int units, int tpr) {
  const int rows_per_block = kThreads / tpr;
  const int lane = threadIdx.x % tpr;
  const long long stride = (long long)gridDim.x * rows_per_block;
  for (long long r = (long long)blockIdx.x * rows_per_block +
                     threadIdx.x / tpr;
       r < k; r += stride) {
    const long long src = (long long)idx[r];
    Unit* dst = out + r * units;
    if (src >= 0 && src < n) {
      const Unit* row = table + src * units;
      for (int u = lane; u < units; u += tpr) dst[u] = row[u];
    } else {
      for (int u = lane; u < units; u += tpr) dst[u] = Unit{};
    }
  }
}

template <typename Unit, typename Idx>
cudaError_t launch(const void* table, long long n, const void* idx,
                   void* out, long long k, int row_bytes,
                   cudaStream_t stream) {
  const int units = row_bytes / (int)sizeof(Unit);
  int tpr = 1;
  while (tpr < units && tpr < 32) tpr *= 2;
  const long long rows_per_block = kThreads / tpr;
  long long blocks = (k + rows_per_block - 1) / rows_per_block;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;   // grid-stride beyond
  gather_rows_kernel<Unit, Idx><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const Unit*)table, n, (const Idx*)idx, (Unit*)out, k, units, tpr);
  return cudaGetLastError();
}

template <typename Idx>
cudaError_t dispatch_unit(const void* table, long long n, const void* idx,
                          void* out, long long k, int row_bytes,
                          int unit_bytes, cudaStream_t stream) {
  switch (unit_bytes) {
    case 16: return launch<uint4, Idx>(table, n, idx, out, k, row_bytes,
                                       stream);
    case 8: return launch<uint2, Idx>(table, n, idx, out, k, row_bytes,
                                      stream);
    case 4: return launch<uint32_t, Idx>(table, n, idx, out, k, row_bytes,
                                         stream);
    case 2: return launch<uint16_t, Idx>(table, n, idx, out, k, row_bytes,
                                         stream);
    case 1: return launch<uint8_t, Idx>(table, n, idx, out, k, row_bytes,
                                        stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// table [n, row_bytes] (dense rows), idx [k] int32 (idx_bytes 4) or int64
// (8), out [k, row_bytes]; unit_bytes divides row_bytes, and is 16 only
// when table, out and row_bytes are 16-byte aligned.
extern "C" int gather_rows(const void* table, long long n, const void* idx,
                           int idx_bytes, void* out, long long k,
                           int row_bytes, int unit_bytes, void* stream) {
  if (k == 0 || row_bytes == 0) return (int)cudaGetLastError();
  if (unit_bytes <= 0 || row_bytes % unit_bytes != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (idx_bytes == 8)
    return (int)dispatch_unit<long long>(table, n, idx, out, k, row_bytes,
                                         unit_bytes, s);
  if (idx_bytes == 4)
    return (int)dispatch_unit<int>(table, n, idx, out, k, row_bytes,
                                   unit_bytes, s);
  return (int)cudaErrorInvalidValue;
}
