// Grouped SQ8 exact scan for Hopper (sm_90a): the kernels B1 and B2.
//
// Replaces the TPU kernels in gamma_tpu/ops/pallas_gsq.py:
//   gsq_scan       <- _gsq_kernel       (via _gsq_call, grouped_sq_scan fold=1)
//   gsq_fold_scan  <- _gsq_fold_kernel  (via _gsq_fold_call, fold > 1)
//
// Contract (the TPU kernel's result, not its blocking).  Queries probing
// the same inverted list form a group g of Q slots; for each group and
// each slot s of its list l = glist[g]:
//     out[g, q, s] = nrm[l, s] - alpha * (qs[g, q, :] . codes[l, s, :])
// with the u8 codes taken as exact floats and f32 accumulation.  A slot
// whose logical tile (s / tile) is >= ntiles[g] lies past the list's live
// length and is not scanned: it emits nrm[l, s] (masked: the norms
// operand carries the BIG mask bias) or 0 (unmasked).  The folded form
// then keeps, per bin c of each logical tile t, the (min, argmin) over
// the `fold` strided slots t*tile + j*lb + c (lb = tile / fold), strict
// '<' in ascending j so the first minimum wins; a skipped tile emits
// max(nrm over the tile) with args 0.
//
// What bounds it on the H100.  Per slot the scan reads d_pad (128) code
// bytes and writes Q*4 output bytes; at the slice's geometry Q = 64, so
// 256 B of [G, Q, cap] f32 output against 16 Ki FLOP -- about 43 FLOP/B,
// far below the card's ~295 FLOP/B ridge: the kernel is bound by the
// output write, not by arithmetic.  The design therefore stays simple:
// one thread per slot (coalesced output rows along the cap axis), the
// group's queries staged once per block in shared memory as f32, code
// rows read with 16-byte loads, FMA on the CUDA cores.  The folded form
// shrinks that output 8x (the reason the TPU tier has it).  Tensor-core
// (wgmma) and TMA versions are later work.
//
// No fast-math: masked operands are norms + BIG (3e38, next to the f32
// maximum) and must keep IEEE arithmetic exactly as the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 128;   // threads per block = slots (or bins) per block
constexpr int kQChunk = 16;   // queries accumulated per register pass

__device__ __forceinline__ void stage_queries(float* sq,
                                              const __nv_bfloat16* qs_g,
                                              int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sq[i] = __bfloat162float(qs_g[i]);
  }
}

__device__ __forceinline__ void unpack16(const uint4& w, float c[16]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      c[i * 4 + b] = static_cast<float>((words[i] >> (8 * b)) & 0xffu);
    }
  }
}

// acc[j] = row . sq[q0 + j, :] for j < nq (nq is uniform across the block)
__device__ __forceinline__ void dot_chunk(const uint8_t* row, const float* sq,
                                          int d_pad, int q0, int nq,
                                          float acc[kQChunk]) {
#pragma unroll
  for (int j = 0; j < kQChunk; ++j) acc[j] = 0.f;
  for (int k = 0; k < d_pad; k += 16) {
    float c[16];
    unpack16(*reinterpret_cast<const uint4*>(row + k), c);
#pragma unroll
    for (int j = 0; j < kQChunk; ++j) {
      if (j < nq) {
        const float4* qv =
            reinterpret_cast<const float4*>(sq + (size_t)(q0 + j) * d_pad + k);
        float a = acc[j];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 x = qv[v];
          a = fmaf(x.x, c[4 * v + 0], a);
          a = fmaf(x.y, c[4 * v + 1], a);
          a = fmaf(x.z, c[4 * v + 2], a);
          a = fmaf(x.w, c[4 * v + 3], a);
        }
        acc[j] = a;
      }
    }
  }
}

// grid (G, ceil(cap / kSlots)), block kSlots, dynamic smem Q*d_pad*4
__global__ void gsq_kernel(const uint8_t* __restrict__ codes,
                           long long code_list_stride,
                           const float* __restrict__ nrm,
                           long long nrm_list_stride,
                           const int* __restrict__ glist,
                           const int* __restrict__ ntiles,
                           const __nv_bfloat16* __restrict__ qs,
                           float* __restrict__ out, int Q, int cap, int d_pad,
                           int tile, float alpha, int with_norms, int masked) {
  extern __shared__ float sq[];
  const int g = blockIdx.x;
  const int s0 = blockIdx.y * kSlots;
  const int s = s0 + threadIdx.x;
  const long long lst = glist[g];
  const long long live_end = (long long)ntiles[g] * tile;
  float* out_g = out + (size_t)g * Q * cap;
  const bool in_cap = s < cap;
  const float nv = in_cap ? nrm[lst * nrm_list_stride + s] : 0.f;
  const float dead = masked ? nv : 0.f;
  if (s0 >= live_end) {  // the whole block lies in skipped tiles
    if (in_cap) {
      for (int q = 0; q < Q; ++q) out_g[(size_t)q * cap + s] = dead;
    }
    return;
  }
  stage_queries(sq, qs + (size_t)g * Q * d_pad, Q * d_pad);
  __syncthreads();
  const bool live = in_cap && s < live_end;
  const uint8_t* row =
      codes + lst * code_list_stride + (size_t)(live ? s : s0) * d_pad;
  for (int q0 = 0; q0 < Q; q0 += kQChunk) {
    const int nq = min(kQChunk, Q - q0);
    float acc[kQChunk];
    dot_chunk(row, sq, d_pad, q0, nq, acc);
    if (!in_cap) continue;
#pragma unroll
    for (int j = 0; j < kQChunk; ++j) {
      if (j < nq) {
        float v = dead;
        if (live) v = with_norms ? nv - alpha * acc[j] : -alpha * acc[j];
        out_g[(size_t)(q0 + j) * cap + s] = v;
      }
    }
  }
}

// grid (G, (cap / tile) * ceil(lb / kSlots)), block kSlots
__global__ void gsq_fold_kernel(const uint8_t* __restrict__ codes,
                                long long code_list_stride,
                                const float* __restrict__ nrm,
                                long long nrm_list_stride,
                                const int* __restrict__ glist,
                                const int* __restrict__ ntiles,
                                const __nv_bfloat16* __restrict__ qs,
                                float* __restrict__ out_v,
                                int* __restrict__ out_a, int Q, int cap,
                                int d_pad, int tile, int fold, float alpha) {
  extern __shared__ float sq[];
  __shared__ float red[kSlots / 32];
  const int lb = tile / fold;
  const int nb = (lb + kSlots - 1) / kSlots;  // blocks per logical tile
  const int t = blockIdx.y / nb;
  const int c = (blockIdx.y % nb) * kSlots + threadIdx.x;  // bin in tile
  const int g = blockIdx.x;
  const long long lst = glist[g];
  const int capf = cap / fold;
  const bool in_bin = c < lb;
  const int cc = in_bin ? c : 0;
  const size_t col = (size_t)t * lb + cc;
  float* ov = out_v + (size_t)g * Q * capf;
  int* oa = out_a + (size_t)g * Q * capf;
  const float* nrow = nrm + lst * nrm_list_stride + (size_t)t * tile;
  if (t >= ntiles[g]) {  // skipped tile: the max of its (all-BIG) operand
    float m = -INFINITY;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) m = fmaxf(m, nrow[i]);
    for (int o = 16; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    m = red[0];
    for (int w = 1; w < kSlots / 32; ++w) m = fmaxf(m, red[w]);
    if (in_bin) {
      for (int q = 0; q < Q; ++q) {
        ov[(size_t)q * capf + col] = m;
        oa[(size_t)q * capf + col] = 0;
      }
    }
    return;
  }
  stage_queries(sq, qs + (size_t)g * Q * d_pad, Q * d_pad);
  __syncthreads();
  const uint8_t* base = codes + lst * code_list_stride + (size_t)t * tile * d_pad;
  for (int q0 = 0; q0 < Q; q0 += kQChunk) {
    const int nq = min(kQChunk, Q - q0);
    float best[kQChunk];
    int arg[kQChunk];
    for (int j = 0; j < fold; ++j) {
      const int off = j * lb + cc;
      float acc[kQChunk];
      dot_chunk(base + (size_t)off * d_pad, sq, d_pad, q0, nq, acc);
      const float nv = nrow[off];
#pragma unroll
      for (int jj = 0; jj < kQChunk; ++jj) {
        const float dd = nv - alpha * acc[jj];
        if (j == 0 || dd < best[jj]) {
          best[jj] = dd;
          arg[jj] = j;
        }
      }
    }
    if (!in_bin) continue;
#pragma unroll
    for (int jj = 0; jj < kQChunk; ++jj) {
      if (jj < nq) {
        ov[(size_t)(q0 + jj) * capf + col] = best[jj];
        oa[(size_t)(q0 + jj) * capf + col] = arg[jj];
      }
    }
  }
}

cudaError_t reserve_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int gsq_scan(const void* codes, long long code_list_stride,
                        const void* nrm, long long nrm_list_stride,
                        const void* glist, const void* ntiles, const void* qs,
                        void* out, int G, int Q, int cap, int d_pad, int tile,
                        float alpha, int with_norms, int masked,
                        void* stream) {
  if (G == 0 || cap == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)Q * d_pad * sizeof(float);
  cudaError_t e = reserve_smem((const void*)gsq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(G, (cap + kSlots - 1) / kSlots);
  gsq_kernel<<<grid, kSlots, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, code_list_stride, (const float*)nrm,
      nrm_list_stride, (const int*)glist, (const int*)ntiles,
      (const __nv_bfloat16*)qs, (float*)out, Q, cap, d_pad, tile, alpha,
      with_norms, masked);
  return (int)cudaGetLastError();
}

extern "C" int gsq_fold_scan(const void* codes, long long code_list_stride,
                             const void* nrm, long long nrm_list_stride,
                             const void* glist, const void* ntiles,
                             const void* qs, void* out_v, void* out_a, int G,
                             int Q, int cap, int d_pad, int tile, int fold,
                             float alpha, void* stream) {
  if (G == 0 || cap == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)Q * d_pad * sizeof(float);
  cudaError_t e = reserve_smem((const void*)gsq_fold_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int lb = tile / fold;
  dim3 grid(G, (cap / tile) * ((lb + kSlots - 1) / kSlots));
  gsq_fold_kernel<<<grid, kSlots, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, code_list_stride, (const float*)nrm,
      nrm_list_stride, (const int*)glist, (const int*)ntiles,
      (const __nv_bfloat16*)qs, (float*)out_v, (int*)out_a, Q, cap, d_pad,
      tile, fold, alpha);
  return (int)cudaGetLastError();
}
