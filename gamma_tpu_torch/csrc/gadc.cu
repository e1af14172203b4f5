// Grouped ADC scan for Hopper (sm_90a): the kernel B3.
//
// Replaces the TPU kernel _gadc_kernel in gamma_tpu/ops/pallas_gadc.py
// (via _gadc_call / grouped_adc), 8-bit and packed 4-bit forms.
//
// Contract (the TPU kernel's result, not its blocking).  Queries probing
// the same inverted list form a group g of Q slots over list l = glist[g].
// For each query q of the group, subquantizer m and entry k:
//     lut[q, m, k] = bf16( cbn[m, k] - alpha * sum_t rg[g, q, m*dsub + t]
//                                                   * cb[m, k, t] )
// with rg and cb in bf16 and the dot in f32 (the TPU kernel's in-kernel
// LUT, rounded to bf16 as it stores it); then for each slot s
//     out[g, q, s] = sum_m lut[q, m, code_m(s)]  (+ bias[l, s])
// summed over m in ascending order in f32.  code_m is byte m of the slot
// (8-bit) or, packed, the low nibble of byte m/2 for even m and the high
// nibble for odd m.  A slot is scanned iff s < ntiles[g] * tile; the
// others emit bias[l, s], or 0 without a bias.  No slot >= cap is
// written.
//
// What bounds it on the H100.  The TPU kernel does the lookups as a
// one-hot matmul on the MXU and keeps a [Q, M*ksub] LUT and a
// [TILE, M*ksub] one-hot in VMEM: 1 MB and 4 MB at the 8-bit geometry
// (M 32, ksub 256), neither of which fits 227 KB of shared memory.  Here
// the lookup is a gather: per stage of subquantizers, the block builds
// the LUT slice of its queries in shared memory (f32 copies of the bf16
// values) and every thread adds one entry per (slot, query) to f32
// accumulators in registers.  The output [G, Q, cap] f32 (1 GB at the
// engine's 8-bit geometry) and the shared-memory gathers bound it.
//
// The LUT build is part of the kernel, as on the TPU: each block rebuilds
// the slices of its kQChunk queries, which costs Q*M*ksub*dsub FMAs per
// block against slots*Q*M lookups.  At 8 bits (ksub 256, dsub 4) a
// 256-slot block would spend 4x more on the build than on the scan, so
// a block covers up to kMaxSlots = 1024 slots (cap_eff 1280 takes two
// blocks of 640), and a thread builds its codebook entries for all the
// block's queries with the codebook values in registers (the rg values
// are broadcast reads): no LUT round trip through device memory, and the
// build costs about twice the scan.  At FastScan's geometry (ksub 16,
// dsub 2) it is 1/20 of the scan.
//
// No fast-math: masked slots carry bias + BIG (3e38, next to the f32
// maximum) and must keep IEEE arithmetic exactly as the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kMaxSlots = kThreads * kSlotsPerThread;
constexpr int kQChunk = 16;        // queries per block (accumulators/slot)
constexpr int kLutStage = 4096;    // f32 LUT entries per stage (16 KB)
constexpr int kDsubChunk = 8;      // codebook values a thread holds

struct Geometry {
  int Q, cap, M, ksub, dsub, W, tile, packed;
  int span;    // slots per block
  int mc;      // subquantizers per LUT stage
  int pitch;   // bytes per transposed code row in shared memory
};

__host__ __device__ inline size_t smem_floats(const Geometry& g) {
  return (size_t)kQChunk * g.M * g.dsub      // rg of the block's queries
         + (size_t)g.mc * kQChunk * g.ksub   // LUT stage
         + (size_t)g.dsub * g.mc * g.ksub;   // codebook stage, transposed
}

// grid (G, ceil(Q / kQChunk), ceil(cap / span)), block kThreads
__global__ void gadc_kernel(const uint8_t* __restrict__ codes,
                            long long code_list_stride,
                            const int* __restrict__ glist,
                            const int* __restrict__ ntiles,
                            const __nv_bfloat16* __restrict__ rg,
                            const __nv_bfloat16* __restrict__ cb,
                            const float* __restrict__ cbn,
                            const float* __restrict__ bias,
                            long long bias_list_stride,
                            float* __restrict__ out, Geometry geo,
                            float alpha) {
  extern __shared__ float smem[];
  const int md = geo.M * geo.dsub;
  float* rg_s = smem;
  float* lut_s = rg_s + kQChunk * md;
  float* cb_s = lut_s + geo.mc * kQChunk * geo.ksub;
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(cb_s + geo.dsub * geo.mc * geo.ksub);

  const int g = blockIdx.x;
  const int q0 = blockIdx.y * kQChunk;
  const int nq = min(kQChunk, geo.Q - q0);
  const int s_begin = blockIdx.z * geo.span;
  const int s_end = min(geo.cap, s_begin + geo.span);
  const long long lst = glist[g];
  const long long live_end = (long long)ntiles[g] * geo.tile;
  const float* brow = bias ? bias + lst * bias_list_stride : nullptr;
  float* out_g = out + ((size_t)g * geo.Q + q0) * geo.cap;
  const long long live_stop = live_end < s_end ? live_end : (long long)s_end;
  const int n_live = live_stop > s_begin ? (int)(live_stop - s_begin) : 0;

  if (n_live == 0) {  // the whole block lies in skipped tiles
    for (int s = s_begin + threadIdx.x; s < s_end; s += kThreads) {
      const float v = brow ? brow[s] : 0.f;
      for (int qc = 0; qc < nq; ++qc) out_g[(size_t)qc * geo.cap + s] = v;
    }
    return;
  }

  // stage the queries' rg rows (f32) and the live code rows, transposed
  // to [W][slot] so that a warp reads one code row without conflicts
  const __nv_bfloat16* rg_g = rg + ((size_t)g * geo.Q + q0) * md;
  for (int i = threadIdx.x; i < nq * md; i += kThreads) {
    rg_s[i] = __bfloat162float(rg_g[i]);
  }
  const uint8_t* crow = codes + lst * code_list_stride + (size_t)s_begin * geo.W;
  for (int i = threadIdx.x; i < n_live * geo.W; i += kThreads) {
    codes_s[(i % geo.W) * geo.pitch + i / geo.W] = crow[i];
  }

  float acc[kSlotsPerThread][kQChunk];
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
#pragma unroll
    for (int qc = 0; qc < kQChunk; ++qc) acc[j][qc] = 0.f;
  }

  const int stage_k = geo.mc * geo.ksub;
  for (int m0 = 0; m0 < geo.M; m0 += geo.mc) {
    const int mc = min(geo.mc, geo.M - m0);
    __syncthreads();  // the previous stage's LUT and codebook reads are done
    const __nv_bfloat16* cb_m = cb + (size_t)m0 * geo.ksub * geo.dsub;
    for (int i = threadIdx.x; i < mc * geo.ksub * geo.dsub; i += kThreads) {
      cb_s[(i % geo.dsub) * stage_k + i / geo.dsub] = __bfloat162float(cb_m[i]);
    }
    __syncthreads();
    // LUT stage: a thread owns codebook entries (mi, k) and computes
    // them for every query of the block, its codebook values held in
    // registers kDsubChunk at a time; the dot runs over t in ascending
    // order
    for (int p = threadIdx.x; p < mc * geo.ksub; p += kThreads) {
      const int mi = p / geo.ksub;
      const int k = p % geo.ksub;
      const int m = m0 + mi;
      const float* c = cb_s + p;
      float ip[kQChunk];
#pragma unroll
      for (int qc = 0; qc < kQChunk; ++qc) ip[qc] = 0.f;
      for (int t0 = 0; t0 < geo.dsub; t0 += kDsubChunk) {
        float cv[kDsubChunk];
#pragma unroll
        for (int t = 0; t < kDsubChunk; ++t) {
          cv[t] = t0 + t < geo.dsub ? c[(t0 + t) * stage_k] : 0.f;
        }
#pragma unroll
        for (int qc = 0; qc < kQChunk; ++qc) {
          const float* r = rg_s + qc * md + m * geo.dsub + t0;
#pragma unroll
          for (int t = 0; t < kDsubChunk; ++t) {
            if (qc < nq && t0 + t < geo.dsub) ip[qc] = fmaf(r[t], cv[t], ip[qc]);
          }
        }
      }
      const float cn = cbn[(size_t)m * geo.ksub + k];
#pragma unroll
      for (int qc = 0; qc < kQChunk; ++qc) {
        if (qc < nq) {
          const float v = __fsub_rn(cn, __fmul_rn(alpha, ip[qc]));
          lut_s[(mi * kQChunk + qc) * geo.ksub + k] =
              __bfloat162float(__float2bfloat16_rn(v));
        }
      }
    }
    __syncthreads();
    // scan: one entry per (slot, query) for each subquantizer of the stage
#pragma unroll
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const int sl = threadIdx.x + j * kThreads;
      if (sl < n_live) {
        for (int mi = 0; mi < mc; ++mi) {
          const int m = m0 + mi;
          int code;
          if (geo.packed) {
            const unsigned byte = codes_s[(m >> 1) * geo.pitch + sl];
            code = (m & 1) ? (int)(byte >> 4) : (int)(byte & 15u);
          } else {
            code = codes_s[m * geo.pitch + sl];
          }
          const float* l = lut_s + mi * kQChunk * geo.ksub + code;
#pragma unroll
          for (int qc = 0; qc < kQChunk; ++qc) {
            if (qc < nq) acc[j][qc] += l[qc * geo.ksub];
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    const int sl = threadIdx.x + j * kThreads;
    const int s = s_begin + sl;
    if (s >= s_end) continue;
    const float b = brow ? brow[s] : 0.f;
#pragma unroll
    for (int qc = 0; qc < kQChunk; ++qc) {
      if (qc < nq) {
        const float v = sl < n_live ? (brow ? __fadd_rn(acc[j][qc], b) : acc[j][qc]) : b;
        out_g[(size_t)qc * geo.cap + s] = v;
      }
    }
  }
}

Geometry make_geometry(int Q, int cap, int M, int ksub, int dsub, int W,
                       int tile, int packed) {
  Geometry geo;
  geo.Q = Q; geo.cap = cap; geo.M = M; geo.ksub = ksub; geo.dsub = dsub;
  geo.W = W; geo.tile = tile; geo.packed = packed;
  const int nsb = (cap + kMaxSlots - 1) / kMaxSlots;
  geo.span = (cap + nsb - 1) / nsb;
  geo.mc = std::max(1, std::min(M, kLutStage / (kQChunk * ksub)));
  // +4 bytes skews consecutive code rows across shared-memory banks
  geo.pitch = ((geo.span + 3) / 4) * 4 + 4;
  return geo;
}

}  // namespace

// A geometry whose shared memory exceeds the card's limit is refused by
// cudaFuncSetAttribute, and the error code is returned.
extern "C" int gadc_scan(const void* codes, long long code_list_stride,
                         const void* glist, const void* ntiles, const void* rg,
                         const void* cb, const void* cbn, const void* bias,
                         long long bias_list_stride, void* out, int G, int Q,
                         int cap, int M, int ksub, int dsub, int W, int tile,
                         float alpha, int packed, void* stream) {
  if (G == 0 || cap == 0) return (int)cudaGetLastError();
  const Geometry geo = make_geometry(Q, cap, M, ksub, dsub, W, tile, packed);
  const size_t smem = smem_floats(geo) * sizeof(float) + (size_t)W * geo.pitch;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)gadc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(G, (Q + kQChunk - 1) / kQChunk, (cap + geo.span - 1) / geo.span);
  gadc_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, code_list_stride, (const int*)glist,
      (const int*)ntiles, (const __nv_bfloat16*)rg, (const __nv_bfloat16*)cb,
      (const float*)cbn, (const float*)bias, bias_list_stride, (float*)out,
      geo, alpha);
  return (int)cudaGetLastError();
}
