// Per-(query, probe) ADC table scans for Hopper (sm_90a): the kernels B4
// and B5.
//
// Replaces the TPU kernels in gamma_tpu/ops/pallas_adc.py:
//   adc_scan     <- _adc_kernel     (via adc_scan_pallas)
//   adc_fs_scan  <- _adc_fs_kernel  (via adc_scan_pallas_fs)
//
// Contract.  Pair i = b * P + p scans inverted list l = list_ids[i]:
//     B4: out[i, s] = sum_m lut[b, p, m, codes[l, s, m]]          (u8 codes)
//     B5: out[i, s] = sum_m lut[b, m, nibble_m(codes[l, s, :])]   (4-bit)
// with byte j of a packed row holding subquantizer 2j in its low nibble
// and 2j+1 in its high nibble.  The sum runs over m in ascending order in
// f32.  Only slots s < cap are written: the TPU kernel leaves its padded
// tail tile undefined, this one has no tail.
//
// What bounds it on the H100.  Per slot the scan reads M code bytes and
// does M table lookups, then writes 4 bytes; the table of a pair is at
// most a few KB.  At the B4 geometry the port reaches (M 20, ksub 16) a
// slot costs 20 B read + 4 B written, so the kernel is bound by device
// memory traffic, not arithmetic.  The TPU kernel spent ksub x more ALU
// on one-hot select-sums because its VPU cannot gather; a GPU thread
// gathers from shared memory directly.  Design: one block per (pair, 256
// slots); the pair's table (B4: M*ksub*4 bytes, B5: the query's M*16*4)
// is staged once per block in shared memory, and each thread sums its
// slot's M lookups in registers.
//
// No fast-math: the sums must match the plain version's IEEE arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 256;   // threads per block = slots per block

__device__ __forceinline__ void stage_lut(float* lut_s, const float* lut,
                                          int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) lut_s[i] = lut[i];
}

// grid (B*P, ceil(cap / kSlots)), block kSlots, dynamic smem M*ksub*4
__global__ void adc_kernel(const uint8_t* __restrict__ codes,
                           long long code_list_stride,
                           const int* __restrict__ list_ids,
                           const float* __restrict__ lut,
                           long long lut_b_stride, long long lut_p_stride,
                           float* __restrict__ out, int P, int cap, int M,
                           int ksub) {
  extern __shared__ float lut_s[];
  const int pair = blockIdx.x;
  const int b = pair / P, p = pair % P;
  stage_lut(lut_s, lut + b * lut_b_stride + p * lut_p_stride, M * ksub);
  __syncthreads();
  const int s = blockIdx.y * kSlots + threadIdx.x;
  if (s >= cap) return;
  const uint8_t* row =
      codes + (long long)list_ids[pair] * code_list_stride + (size_t)s * M;
  float acc = 0.f;
  for (int m = 0; m < M; ++m) acc += lut_s[m * ksub + row[m]];
  out[(size_t)pair * cap + s] = acc;
}

// grid (B*P, ceil(cap / kSlots)), block kSlots, dynamic smem M*16*4
__global__ void adc_fs_kernel(const uint8_t* __restrict__ codes,
                              long long code_list_stride,
                              const int* __restrict__ list_ids,
                              const float* __restrict__ lut,
                              float* __restrict__ out, int P, int cap,
                              int W) {
  extern __shared__ float lut_s[];
  const int pair = blockIdx.x;
  const int M = 2 * W;
  stage_lut(lut_s, lut + (size_t)(pair / P) * M * 16, M * 16);
  __syncthreads();
  const int s = blockIdx.y * kSlots + threadIdx.x;
  if (s >= cap) return;
  const uint8_t* row =
      codes + (long long)list_ids[pair] * code_list_stride + (size_t)s * W;
  float acc = 0.f;
  for (int j = 0; j < W; ++j) {
    const unsigned v = row[j];
    acc += lut_s[(2 * j) * 16 + (v & 15u)];
    acc += lut_s[(2 * j + 1) * 16 + (v >> 4)];
  }
  out[(size_t)pair * cap + s] = acc;
}

cudaError_t reserve_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int adc_scan(const void* codes, long long code_list_stride,
                        const void* list_ids, const void* lut,
                        long long lut_b_stride, long long lut_p_stride,
                        void* out, int BP, int P, int cap, int M, int ksub,
                        void* stream) {
  if (BP == 0 || cap == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)M * ksub * sizeof(float);
  cudaError_t e = reserve_smem((const void*)adc_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BP, (cap + kSlots - 1) / kSlots);
  adc_kernel<<<grid, kSlots, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, code_list_stride, (const int*)list_ids,
      (const float*)lut, lut_b_stride, lut_p_stride, (float*)out, P, cap, M,
      ksub);
  return (int)cudaGetLastError();
}

extern "C" int adc_fs_scan(const void* codes, long long code_list_stride,
                           const void* list_ids, const void* lut, void* out,
                           int BP, int P, int cap, int W, void* stream) {
  if (BP == 0 || cap == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)2 * W * 16 * sizeof(float);
  cudaError_t e = reserve_smem((const void*)adc_fs_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BP, (cap + kSlots - 1) / kSlots);
  adc_fs_kernel<<<grid, kSlots, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, code_list_stride, (const int*)list_ids,
      (const float*)lut, (float*)out, P, cap, W);
  return (int)cudaGetLastError();
}
