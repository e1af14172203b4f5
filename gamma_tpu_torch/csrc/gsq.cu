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
// bytes and does Q * d_pad multiply-adds.  Both kernels run the product
// on the tensor cores: the u8 codes are exact in bf16 and every product
// of two 8-bit significands is exact in f32, so only the order of the
// f32 sum differs from the plain version.  The code rows are the A
// operand of mma.sync.m16n8k16, read straight from device memory (a
// thread's 32 bytes of a row are contiguous, the K axis permuted alike
// on both operands, so no shared-memory staging and no transposition),
// converted u8 -> bf16 in registers once per (group, slot); the queries
// are the B operand, staged once per block in shared memory in fragment
// order (conflict-free 8-byte loads).  A 16-slot chunk whose norms
// operand is all >= 1e37 (masked: + BIG) is not read or multiplied at
// all, since BIG - alpha * acc rounds back to the operand.
//   B1 (gsq_kernel) writes Q * 4 bytes per slot: at Q = 64 that is 256 B
//   of [G, Q, cap] f32 output against 16 Ki FLOP, about 43 FLOP/B, far
//   below the card's ~295 FLOP/B bf16 ridge, so its floor is the output
//   write (1.0 GB at the engine's G 3080 x Q 64 x cap 1280); on the
//   tensor cores the product is a small part of that time (on the CUDA
//   cores it was several times the write).  The write decides the
//   design.  A warp owns 32 slots and all Q (<= 64 per pass) queries;
//   the accumulator layout holds 32-byte pieces of eight different query
//   rows, so the tile goes through a per-warp shared-memory stage
//   ([queries][36] f32, conflict-free both ways) and leaves as whole
//   128-byte lines of one query's row, 16 bytes a lane, streaming
//   stores: 0.417 ms on chip_smoke.py's nominal masked operands (G 3080
//   x Q 64 x cap 1024; NVIDIA H100 80GB HBM3 at 700 W, three blocks an
//   SM each time), where handing each staged row to a bulk (TMA) copy,
//   128 bytes a copy, took 0.449 ms and storing straight from the
//   accumulators 0.504 ms.  A block covers a whole
//   logical tile of a list where it can (ops/gsq.scan_block_slots: 512
//   slots), so the 16 KB of staged queries serve 128 KB of output, and
//   a block in skipped tiles stages nothing and writes the norms
//   operand (or zeros) to every query row, 512 contiguous bytes a warp
//   instruction.  The next unit's code rows are requested before this
//   unit's epilogue, and three blocks an SM (168 registers, no spills)
//   beat four with spills.
//   B2 (gsq_fold_kernel) keeps one (min, argmin) per `fold` slots, so its
//   output is 8x smaller and the product is what bounds it: 2.45e14 FLOP
//   at the engine's hot geometry (3080 groups x 4864 slots x Q 64 x 128
//   dims), 3.7 ms on the CUDA cores at their peak against 0.25 ms on the
//   tensor cores.  A warp owns 16 bins and all Q (<= 64 per pass)
//   queries and folds in the accumulator's own layout; at the hot
//   geometry most lists hold ~490 live slots of 4864, so most chunks are
//   masked.  A block covers as many bins of a tile as divide it evenly
//   (ops/gsq.fold_bin_chunk: all 608 at the hot geometry), so the 16 KB
//   of staged queries serve the whole tile and no lane idles.
//
//
// Row types and the f32 form.  The rows are u8 codes (the SQ8 sidecar)
// or raw bf16 rows (the IVFFlat payload, _rows_as in the TPU kernel):
// bf16 rows feed the same mma.sync as they are, without a conversion.
// The K permutation is the same for both, d = chunk*16*KS + t*4*KS +
// s*4 + i: a lane's 4*KS dims of a chunk are contiguous, 4*KS bytes of
// u8 (KS 8: 32 bytes, two 16-byte loads) or 8*KS bytes of bf16 (KS 4:
// the same 32 bytes), and the four dims of k-step s are one u8 word
// (converted to the fragment's lo/hi pair) or two bf16 words (which ARE
// the lo/hi pair), so the staged queries do not change with the row
// type.  A bf16 chunk is therefore 64 dims where a u8 chunk is 128, and
// the registers of a prefetched unit are the same.  Rows of dead slots
// must be finite (a bf16 bit pattern can be NaN where a u8 code cannot):
// a masked chunk is not multiplied here but is in the plain version,
// where BIG - alpha * NaN would not round back to the operand.
//   precise (gsq_precise_kernel, gsq_fold_precise_kernel): the query
// operand is f32 and the rows are widened to f32, the product summed by
// fmaf on the CUDA cores in ascending dims (tf32 tensor cores keep 10
// bits and are not f32).  A thread owns one slot (one bin of the folded
// form) and eight queries at a time, the group's queries staged in
// shared memory and read as broadcasts; the row stays in L1 between the
// query passes.  No caller on the search paths: simple, and bound by the
// f32 FMA rate.
//
// No fast-math: masked operands are norms + BIG (3e38, next to the f32
// maximum) and must keep IEEE arithmetic exactly as the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------
// Tensor-core helpers of both scans: the code rows are the A operand of
// mma.sync.m16n8k16, the group's queries the B operand.  The rows enter
// only through load_code_rows and row_fragment, which the row type (RB
// bytes a value: 1 = u8 codes, 2 = bf16 rows) selects.
// ---------------------------------------------------------------------

constexpr int kMmaRows = 16;        // rows of one mma.sync.m16n8k16 A tile
constexpr float kDead = 1e37f;      // an operand at or above this is masked

// d[16x8] += a[16x16] . b[16x8], bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16_m16n8k16(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four u8 codes -> two bf16x2 words (lo: bytes 0,1; hi: bytes 2,3), exact:
// 0x4B0000xx is the float 2^23 + xx, minus 2^23 leaves xx, whose 8
// significant bits survive the cut to bf16 (the float's upper half).
__device__ __forceinline__ void u8x4_to_bf16x2(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t magic = 0x4B000000u;
  const float two23 = 8388608.f;
  const uint32_t f0 = __float_as_uint(
      __fsub_rn(__uint_as_float(__byte_perm(w, magic, 0x7440)), two23));
  const uint32_t f1 = __float_as_uint(
      __fsub_rn(__uint_as_float(__byte_perm(w, magic, 0x7441)), two23));
  const uint32_t f2 = __float_as_uint(
      __fsub_rn(__uint_as_float(__byte_perm(w, magic, 0x7442)), two23));
  const uint32_t f3 = __float_as_uint(
      __fsub_rn(__uint_as_float(__byte_perm(w, magic, 0x7443)), two23));
  lo = __byte_perm(f0, f1, 0x7632);
  hi = __byte_perm(f2, f3, 0x7632);
}

// The K axis is cut into chunks of 16*KS dims; inside a chunk, lane
// t = lane % 4 of the MMA owns the 4*KS contiguous dims
// [t*4*KS, (t+1)*4*KS), four per k-step s: physical dim
//     d(chunk, t, s, i) = chunk*16*KS + t*4*KS + s*4 + i
// stands at the MMA's k index {2t, 2t+1, 2t+8, 2t+9}[i] of step s, on
// both operands alike (a dot product does not mind the order).

// Stage the group's queries as B fragments: entry ((qt*nsteps + step)*32 +
// lane) holds the 4 bf16 (8 bytes) that lane (g = lane/4, t = lane%4)
// feeds k-step `step` of query tile qt, i.e. query qt*8 + g.  Queries
// at or past Q are zero rows.
template <int KS>
__device__ __forceinline__ void stage_query_fragments(
    uint2* qfrag, const __nv_bfloat16* qs_g, int Q, int d_pad, int qtiles) {
  const int units = d_pad / 4;           // 8-byte units per query row
  const int nsteps = d_pad / 16;
  for (int i = threadIdx.x; i < qtiles * 8 * units; i += blockDim.x) {
    const int q = i / units;
    const int d = (i - q * units) * 4;
    const int chunk = d / (16 * KS);
    const int rem = d - chunk * (16 * KS);
    const int t = rem / (4 * KS);
    const int s = (rem - t * (4 * KS)) / 4;
    uint2 v = make_uint2(0u, 0u);
    if (q < Q) {
      v = *reinterpret_cast<const uint2*>(qs_g + (size_t)q * d_pad + d);
    }
    qfrag[((size_t)(q >> 3) * nsteps + chunk * KS + s) * 32 + (q & 7) * 4 +
          t] = v;
  }
}

// A lane's bytes of one chunk of two rows: WN words each (KS words of u8
// codes, 2*KS of bf16 rows)
template <int WN>
__device__ __forceinline__ void load_code_rows(const uint8_t* p0,
                                               const uint8_t* p1,
                                               uint32_t (&w)[2][WN]) {
  if constexpr (WN % 4 == 0) {
#pragma unroll
    for (int v = 0; v < WN / 4; ++v) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p0) + v);
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(p1) + v);
      w[0][4 * v + 0] = a.x; w[0][4 * v + 1] = a.y;
      w[0][4 * v + 2] = a.z; w[0][4 * v + 3] = a.w;
      w[1][4 * v + 0] = b.x; w[1][4 * v + 1] = b.y;
      w[1][4 * v + 2] = b.z; w[1][4 * v + 3] = b.w;
    }
  } else if constexpr (WN % 2 == 0) {
#pragma unroll
    for (int v = 0; v < WN / 2; ++v) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p0) + v);
      const uint2 b = __ldg(reinterpret_cast<const uint2*>(p1) + v);
      w[0][2 * v + 0] = a.x; w[0][2 * v + 1] = a.y;
      w[1][2 * v + 0] = b.x; w[1][2 * v + 1] = b.y;
    }
  } else {
#pragma unroll
    for (int s = 0; s < WN; ++s) {
      w[0][s] = __ldg(reinterpret_cast<const uint32_t*>(p0) + s);
      w[1][s] = __ldg(reinterpret_cast<const uint32_t*>(p1) + s);
    }
  }
}

// The A fragment's (lo, hi) words of k-step s from a lane's words of one
// row: RB = 1, one word of four u8 codes, converted; RB = 2, the two
// words of four bf16 values, as they are.
template <int RB, int WN>
__device__ __forceinline__ void row_fragment(const uint32_t (&w)[WN], int s,
                                             uint32_t& lo, uint32_t& hi) {
  if constexpr (RB == 1) {
    u8x4_to_bf16x2(w[s], lo, hi);
  } else {
    lo = w[2 * s];
    hi = w[2 * s + 1];
  }
}

// acc[nt] (16 rows x 8 queries each) += rows . queries over one chunk
template <int NT, int KS, int RB>
__device__ __forceinline__ void mma_chunk(float (&acc)[NT][4],
                                          const uint32_t (&w)[2][KS * RB],
                                          const uint2* qfrag_lane,
                                          int nsteps) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint32_t a[4];
    row_fragment<RB>(w[0], s, a[0], a[2]);
    row_fragment<RB>(w[1], s, a[1], a[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = qfrag_lane[((size_t)nt * nsteps + s) * 32];
      mma_bf16_m16n8k16(acc[nt], a, b.x, b.y);
    }
  }
}

// As mma_chunk for two row tiles at once: each B fragment is read from
// shared memory once and feeds both.
template <int NT, int KS, int RB>
__device__ __forceinline__ void mma_chunk2(float (&acc)[2][NT][4],
                                           const uint32_t (&w)[2][2][KS * RB],
                                           const uint2* qfrag_lane,
                                           int nsteps) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint32_t a0[4], a1[4];
    row_fragment<RB>(w[0][0], s, a0[0], a0[2]);
    row_fragment<RB>(w[0][1], s, a0[1], a0[3]);
    row_fragment<RB>(w[1][0], s, a1[0], a1[2]);
    row_fragment<RB>(w[1][1], s, a1[1], a1[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = qfrag_lane[((size_t)nt * nsteps + s) * 32];
      mma_bf16_m16n8k16(acc[0][nt], a0, b.x, b.y);
      mma_bf16_m16n8k16(acc[1][nt], a1, b.x, b.y);
    }
  }
}

// ---------------------------------------------------------------------
// B1: the plain scan
// ---------------------------------------------------------------------

constexpr int kScanThreads = 128;               // 4 warps
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kUnit = 32;    // slots a warp scans at a time: per query one
                             // 128-byte line of f32 output
constexpr int kPitch = 36;   // floats per staged query row (32 + 4: the
                             // accumulator's scatter and the row reads are
                             // both free of bank conflicts)

// One slot's output from its norms operand and its product
__device__ __forceinline__ float scan_value(float nv, float ip, bool live,
                                            float alpha, int with_norms,
                                            int masked) {
  if (!live) return masked ? nv : 0.f;
  const float v = __fmul_rn(alpha, ip);
  return with_norms ? __fsub_rn(nv, v) : -v;
}

// grid (G, ceil(cap / span)), block kScanThreads; dynamic smem: the
// group's query fragments (npass*NT*8 x d_pad bf16), then one
// [NT*8][kPitch] f32 stage per warp.  NT: query tiles (of 8) per pass;
// KS: k-steps (of 16 dims) per chunk of the K axis; RB: bytes of a row
// value (1 u8, 2 bf16; strides of `codes` are in bytes); VEC: norms read and
// output written 16 bytes a lane (cap, the norms' list stride and both
// base pointers allow it), else 4 bytes a lane.
template <int NT, int KS, int RB, bool VEC>
__global__ void __launch_bounds__(kScanThreads, 3)
gsq_kernel(const uint8_t* __restrict__ codes, long long code_list_stride,
           const float* __restrict__ nrm, long long nrm_list_stride,
           const int* __restrict__ glist, const int* __restrict__ ntiles,
           const __nv_bfloat16* __restrict__ qs, float* __restrict__ out,
           int Q, int cap, int d_pad, int tile, int span, float alpha,
           int with_norms, int masked) {
  extern __shared__ __align__(16) uint2 scan_smem[];
  uint2* qfrag = scan_smem;
  constexpr int EW = VEC ? 4 : 1;   // slots a lane writes per query row
  const int g = blockIdx.x;
  const int b0 = blockIdx.y * span;
  const int b1 = min(cap, b0 + span);
  const long long lst = glist[g];
  const int live_end =
      (int)min((long long)cap, (long long)ntiles[g] * (long long)tile);
  float* out_g = out + (size_t)g * Q * cap;
  const float* nrow = nrm + lst * nrm_list_stride;

  if (b0 >= live_end) {
    // the whole block lies in skipped tiles: nothing is staged; every
    // query row gets the norms operand (masked) or zeros, a warp writing
    // 512 contiguous bytes an instruction
    for (int c = b0 + EW * threadIdx.x; c < b1; c += EW * kScanThreads) {
      float* o = out_g + c;
      if constexpr (VEC) {
        const float4 v = masked ? __ldg(reinterpret_cast<const float4*>(
                                      nrow + c))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < Q; ++q) {
          __stcs(reinterpret_cast<float4*>(o + (size_t)q * cap), v);
        }
      } else {
        const float v = masked ? __ldg(nrow + c) : 0.f;
        for (int q = 0; q < Q; ++q) __stcs(o + (size_t)q * cap, v);
      }
    }
    return;
  }

  const int npass = (Q + 8 * NT - 1) / (8 * NT);
  const int nsteps = d_pad / 16;
  const int nchunks = nsteps / KS;
  stage_query_fragments<KS>(qfrag, qs + (size_t)g * Q * d_pad, Q, d_pad,
                            npass * NT);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;   // row of the A tile (and gq + 8); query of B
  const int tq = lane & 3;
  float* stage = reinterpret_cast<float*>(qfrag + (size_t)npass * NT * 8 *
                                                      (d_pad / 4)) +
                 warp * (NT * 8 * kPitch);
  const uint8_t* lbase = codes + lst * code_list_stride + tq * (4 * KS * RB);
  const size_t row_pitch = (size_t)d_pad * RB;
  const bool may_skip = masked && with_norms;
  // the lane's slots of a unit in the epilogue, and its query row there
  const int eoff = VEC ? 4 * (lane & 7) : lane;
  const int erow = VEC ? lane >> 3 : 0;
  constexpr int EROWS = VEC ? 4 : 1;   // query rows a warp writes at once

  // the norms operand of the lane's epilogue slots of the unit at u
  auto load_norms = [&](int u, float (&nv)[EW]) {
    const int es = u + eoff;
    if constexpr (VEC) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (es < cap) v = __ldg(reinterpret_cast<const float4*>(nrow + es));
      nv[0] = v.x; nv[1] = v.y; nv[2] = v.z; nv[3] = v.w;
    } else {
      nv[0] = es < cap ? __ldg(nrow + es) : 0.f;
    }
  };
  // which of the unit's two 16-slot row tiles need the product (bit mt):
  // a tile past the live length does not, nor (masked, with norms) one
  // whose live slots are all masked, since BIG - alpha * ip rounds back
  // to the operand; and the lane's code rows of each tile, rows past
  // the live length replaced by one that exists (nothing of them is kept)
  auto plan_unit = [&](int u, const float (&nv)[EW], int (&rows)[2][2]) {
    unsigned on = 0u;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m0 = u + kMmaRows * mt;
      bool need = m0 < live_end;
      if (need && may_skip) {
        bool dead = true;
        if (eoff / kMmaRows == mt) {
#pragma unroll
          for (int i = 0; i < EW; ++i) {
            dead = dead && (u + eoff + i >= live_end || nv[i] >= kDead);
          }
        }
        need = !__all_sync(0xffffffffu, dead);
      }
      if (need) on |= 1u << mt;
      const int r0 = m0 + gq, r1 = r0 + 8;
      rows[mt][0] = r0 < live_end ? r0 : m0;
      rows[mt][1] = r1 < live_end ? r1 : m0;
    }
    return on;
  };
  auto load_unit = [&](unsigned on, const int (&rows)[2][2], int ch,
                       uint32_t (&w)[2][2][KS * RB]) {
    const uint8_t* p = lbase + (size_t)ch * (16 * KS * RB);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if ((on >> mt) & 1u) {
        load_code_rows<KS * RB>(p + (size_t)rows[mt][0] * row_pitch,
                                p + (size_t)rows[mt][1] * row_pitch, w[mt]);
      }
    }
  };

  // A warp takes every kScanWarps-th unit of the block.  The next
  // unit's code rows are asked for as soon as this unit's last products
  // have consumed their registers, so they arrive while the epilogue
  // stores; its norms one step earlier still.
  const int stride = kScanWarps * kUnit;
  int u0 = b0 + warp * kUnit;
  if (u0 >= b1) return;
  float nv[EW], nvn[EW];
  int rows[2][2], rowsn[2][2];
  uint32_t w[2][2][KS * RB];
  load_norms(u0, nv);
  unsigned on = plan_unit(u0, nv, rows), onn = 0u;
  load_unit(on, rows, 0, w);
  while (u0 < b1) {
    const int un = u0 + stride;
    const bool has_next = un < b1;
    if (has_next) load_norms(un, nvn);
    const int es = u0 + eoff;
    for (int qp = 0; qp < npass; ++qp) {
      const uint2* qfrag_lane = qfrag + (size_t)qp * NT * nsteps * 32 + lane;
      float acc[2][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        }
      }
      if (on) {
        for (int ch = 0; ch < nchunks; ++ch) {
          const uint2* qf = qfrag_lane + (size_t)ch * KS * 32;
          if (qp | ch) load_unit(on, rows, ch, w);
          if (on == 3u) {
            mma_chunk2<NT, KS, RB>(acc, w, qf, nsteps);
          } else if (on == 1u) {
            mma_chunk<NT, KS, RB>(acc[0], w[0], qf, nsteps);
          } else {
            mma_chunk<NT, KS, RB>(acc[1], w[1], qf, nsteps);
          }
        }
      }
      if (qp == npass - 1 && has_next) {
        onn = plan_unit(un, nvn, rowsn);
        load_unit(onn, rowsn, 0, w);
      }
      // the accumulators hold 32-byte pieces of eight query rows each;
      // through the warp's stage they become whole rows of 32 slots
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            stage[(nt * 8 + tq * 2 + (e & 1)) * kPitch + mt * kMmaRows + gq +
                  (e & 2) * 4] = acc[mt][nt][e];
          }
        }
      }
      __syncwarp();
#pragma unroll 4
      for (int ql = erow; ql < NT * 8; ql += EROWS) {
        const int q = qp * NT * 8 + ql;
        if (q >= Q || es >= cap) continue;
        float* o = out_g + (size_t)q * cap + es;
        if constexpr (VEC) {
          const float4 a =
              *reinterpret_cast<const float4*>(stage + ql * kPitch + eoff);
          float4 v;
          v.x = scan_value(nv[0], a.x, es + 0 < live_end, alpha, with_norms,
                           masked);
          v.y = scan_value(nv[1], a.y, es + 1 < live_end, alpha, with_norms,
                           masked);
          v.z = scan_value(nv[2], a.z, es + 2 < live_end, alpha, with_norms,
                           masked);
          v.w = scan_value(nv[3], a.w, es + 3 < live_end, alpha, with_norms,
                           masked);
          __stcs(reinterpret_cast<float4*>(o), v);
        } else {
          __stcs(o, scan_value(nv[0], stage[ql * kPitch + eoff],
                               es < live_end, alpha, with_norms, masked));
        }
      }
    }
    u0 = un;
    on = onn;
#pragma unroll
    for (int i = 0; i < EW; ++i) nv[i] = nvn[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) rows[i >> 1][i & 1] = rowsn[i >> 1][i & 1];
  }
}

constexpr int kFoldThreads = 128;   // 4 warps; a warp owns 16 bins at a time

// A skipped tile of the folded scan: the max of its (all-BIG) norms
// operand to every query row of the block's bins, args 0.  `red` holds
// one float per warp of the block.
__device__ __forceinline__ void write_skipped_tile(
    const float* nrow, int tile, float* ov, int* oa, int bin_lo, int bin_hi,
    int Q, int capf, float* red) {
  float m = -INFINITY;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) m = fmaxf(m, nrow[i]);
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < (int)blockDim.x / 32; ++w) m = fmaxf(m, red[w]);
  const int nb = bin_hi - bin_lo;
  for (int i = threadIdx.x; i < nb * Q; i += blockDim.x) {
    const int q = i / nb;
    const int c = bin_lo + (i - q * nb);
    ov[(size_t)q * capf + c] = m;
    oa[(size_t)q * capf + c] = 0;
  }
}

// grid (G, (cap / tile) * ceil(lb / nbins)), block kFoldThreads, dynamic
// smem qtiles*8 * d_pad * 2 bytes.  NT: query tiles (of 8) per pass;
// KS: k-steps (of 16 dims) per chunk of the K axis; RB: bytes of a row
// value (strides of `codes` in bytes).
template <int NT, int KS, int RB>
__global__ void __launch_bounds__(kFoldThreads, 3)
gsq_fold_kernel(const uint8_t* __restrict__ codes, long long code_list_stride,
                const float* __restrict__ nrm, long long nrm_list_stride,
                const int* __restrict__ glist, const int* __restrict__ ntiles,
                const __nv_bfloat16* __restrict__ qs,
                float* __restrict__ out_v, int* __restrict__ out_a, int Q,
                int cap, int d_pad, int tile, int fold, int nbins,
                float alpha) {
  extern __shared__ uint2 qfrag[];
  __shared__ float red[kFoldThreads / 32];
  const int lb = tile / fold;
  const int bpt = (lb + nbins - 1) / nbins;  // blocks per logical tile
  const int t = blockIdx.y / bpt;
  const int bin_lo = (blockIdx.y % bpt) * nbins;
  const int bin_hi = min(lb, bin_lo + nbins);
  const int g = blockIdx.x;
  const long long lst = glist[g];
  const int capf = cap / fold;
  float* ov = out_v + (size_t)g * Q * capf + (size_t)t * lb;
  int* oa = out_a + (size_t)g * Q * capf + (size_t)t * lb;
  const float* nrow = nrm + lst * nrm_list_stride + (size_t)t * tile;
  if (t >= ntiles[g]) {
    write_skipped_tile(nrow, tile, ov, oa, bin_lo, bin_hi, Q, capf, red);
    return;
  }
  const int npass = (Q + 8 * NT - 1) / (8 * NT);
  const int nsteps = d_pad / 16;
  const int nchunks = nsteps / KS;
  stage_query_fragments<KS>(qfrag, qs + (size_t)g * Q * d_pad, Q, d_pad,
                            npass * NT);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;   // row of the A tile (and gq + 8); query of B
  const int tq = lane & 3;
  const size_t row_pitch = (size_t)d_pad * RB;
  const uint8_t* base = codes + lst * code_list_stride +
                        (size_t)t * tile * row_pitch + tq * (4 * KS * RB);
  const int nunits = (bin_hi - bin_lo + kMmaRows - 1) / kMmaRows;
  const int total = fold * nchunks;
  for (int u = warp; u < nunits; u += kFoldThreads / 32) {
    const int c0 = bin_lo + u * kMmaRows + gq;
    const int c1 = c0 + 8;
    const bool ok0 = c0 < bin_hi, ok1 = c1 < bin_hi;
    // rows past the block's bins read a row that exists; nothing of
    // them is written
    const int r0 = ok0 ? c0 : bin_lo, r1 = ok1 ? c1 : bin_lo;
    // bit j: some of the 16 slots j*lb + [c0 .. c0+16) is not masked
    unsigned live = 0u;
    for (int j = 0; j < fold; ++j) {
      const bool dead = (!ok0 || nrow[j * lb + r0] >= kDead) &&
                        (!ok1 || nrow[j * lb + r1] >= kDead);
      if (!__all_sync(0xffffffffu, dead)) live |= 1u << j;
    }
    for (int qp = 0; qp < npass; ++qp) {
      const uint2* qfrag_lane = qfrag + (size_t)qp * NT * nsteps * 32 + lane;
      float acc[NT][4], best[NT][4];
      int arg[NT][4];
      uint32_t cur[2][KS * RB], nxt[2][KS * RB];
      if (live & 1u) {
        load_code_rows<KS * RB>(base + (size_t)r0 * row_pitch,
                                base + (size_t)r1 * row_pitch, nxt);
      }
      for (int st = 0; st < total; ++st) {
        const int j = st / nchunks;
        const int ch = st - j * nchunks;
        const bool on = (live >> j) & 1u;
#pragma unroll
        for (int s = 0; s < KS * RB; ++s) {
          cur[0][s] = nxt[0][s];
          cur[1][s] = nxt[1][s];
        }
        if (st + 1 < total) {  // the next step's rows, while this one runs
          const int jn = (st + 1) / nchunks;
          const int chn = (st + 1) - jn * nchunks;
          if ((live >> jn) & 1u) {
            const size_t off = (size_t)chn * (16 * KS * RB);
            load_code_rows<KS * RB>(
                base + (size_t)(jn * lb + r0) * row_pitch + off,
                base + (size_t)(jn * lb + r1) * row_pitch + off, nxt);
          }
        }
        if (ch == 0) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
          }
        }
        if (on) {
          mma_chunk<NT, KS, RB>(acc, cur, qfrag_lane + (size_t)ch * KS * 32,
                                nsteps);
        }
        if (ch != nchunks - 1) continue;
        // fold slot j into the running (min, argmin), first minimum wins
        const float nv0 = nrow[j * lb + r0];
        const float nv1 = nrow[j * lb + r1];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float nv = e < 2 ? nv0 : nv1;
            // a masked chunk: nv - alpha * acc rounds to nv itself
            const float dd =
                on ? __fsub_rn(nv, __fmul_rn(alpha, acc[nt][e])) : nv;
            if (j == 0 || dd < best[nt][e]) {
              best[nt][e] = dd;
              arg[nt][e] = j;
            }
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = (qp * NT + nt) * 8 + tq * 2 + (e & 1);
          const int c = e < 2 ? c0 : c1;
          if (q < Q && (e < 2 ? ok0 : ok1)) {
            ov[(size_t)q * capf + c] = best[nt][e];
            oa[(size_t)q * capf + c] = arg[nt][e];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// The f32 forms (precise): f32 queries, rows widened to f32, fmaf
// ---------------------------------------------------------------------

constexpr int kPreciseThreads = 128;   // slots (bins) of a block, one a thread
constexpr int kPreciseQ = 8;           // queries a thread carries at a time

// Dims [d, d + 4) of one row as f32 (a u8 code or a bf16 value is exact)
template <int RB>
__device__ __forceinline__ float4 load_row4(const uint8_t* row, int d) {
  if constexpr (RB == 1) {
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(row + d));
    return make_float4((float)(w & 0xffu), (float)((w >> 8) & 0xffu),
                       (float)((w >> 16) & 0xffu), (float)(w >> 24));
  } else {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(row + 2 * d));
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xffff0000u));
  }
}

// acc[i] = qsm[q0 + i, :] . row over d_pad dims in ascending order; qsm
// holds whole rows of kPreciseQ queries (zero rows past Q)
template <int RB>
__device__ __forceinline__ void precise_dot(float (&acc)[kPreciseQ],
                                            const uint8_t* row,
                                            const float* qsm, int q0,
                                            int d_pad) {
#pragma unroll
  for (int i = 0; i < kPreciseQ; ++i) acc[i] = 0.f;
  for (int d = 0; d < d_pad; d += 4) {
    const float4 x = load_row4<RB>(row, d);
#pragma unroll
    for (int i = 0; i < kPreciseQ; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(
          qsm + (size_t)(q0 + i) * d_pad + d);
      acc[i] = fmaf(x.x, qv.x, acc[i]);
      acc[i] = fmaf(x.y, qv.y, acc[i]);
      acc[i] = fmaf(x.z, qv.z, acc[i]);
      acc[i] = fmaf(x.w, qv.w, acc[i]);
    }
  }
}

// The group's f32 queries into shared memory, rows [Q, qrows) zeroed
__device__ __forceinline__ void stage_queries_f32(float* qsm,
                                                  const float* qs_g, int Q,
                                                  int qrows, int d_pad) {
  const int n4 = d_pad / 4;
  for (int i = threadIdx.x; i < qrows * n4; i += blockDim.x) {
    const int q = i / n4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < Q) v = __ldg(reinterpret_cast<const float4*>(qs_g) + i);
    reinterpret_cast<float4*>(qsm)[i] = v;
  }
}

// grid (G, ceil(cap / kPreciseThreads)), block kPreciseThreads; dynamic
// smem ceil(Q / 8) * 8 * d_pad floats.  The contract of gsq_kernel.
template <int RB>
__global__ void __launch_bounds__(kPreciseThreads)
gsq_precise_kernel(const uint8_t* __restrict__ codes,
                   long long code_list_stride, const float* __restrict__ nrm,
                   long long nrm_list_stride, const int* __restrict__ glist,
                   const int* __restrict__ ntiles,
                   const float* __restrict__ qs, float* __restrict__ out,
                   int Q, int cap, int d_pad, int tile, float alpha,
                   int with_norms, int masked) {
  extern __shared__ __align__(16) float qsm_scan[];
  const int g = blockIdx.x;
  const int b0 = blockIdx.y * kPreciseThreads;
  const int s = b0 + threadIdx.x;
  const long long lst = glist[g];
  const int live_end =
      (int)min((long long)cap, (long long)ntiles[g] * (long long)tile);
  float* out_g = out + (size_t)g * Q * cap;
  const float* nrow = nrm + lst * nrm_list_stride;
  if (b0 >= live_end) {  // wholly in skipped tiles: nothing is staged
    if (s < cap) {
      const float v = masked ? nrow[s] : 0.f;
      for (int q = 0; q < Q; ++q) out_g[(size_t)q * cap + s] = v;
    }
    return;
  }
  const int qrows = (Q + kPreciseQ - 1) / kPreciseQ * kPreciseQ;
  stage_queries_f32(qsm_scan, qs + (size_t)g * Q * d_pad, Q, qrows, d_pad);
  __syncthreads();
  if (s >= cap) return;
  const float nv = nrow[s];
  const bool live = s < live_end;
  // a masked slot: BIG - alpha * ip rounds back to the operand
  const bool skip = !live || (masked && with_norms && nv >= kDead);
  const uint8_t* row =
      codes + lst * code_list_stride + (size_t)s * d_pad * RB;
  for (int q0 = 0; q0 < Q; q0 += kPreciseQ) {
    float acc[kPreciseQ];
    if (!skip) precise_dot<RB>(acc, row, qsm_scan, q0, d_pad);
#pragma unroll
    for (int i = 0; i < kPreciseQ; ++i) {
      if (q0 + i < Q) {
        out_g[(size_t)(q0 + i) * cap + s] =
            skip ? (masked ? nv : 0.f)
                 : scan_value(nv, acc[i], true, alpha, with_norms, masked);
      }
    }
  }
}

// grid (G, (cap / tile) * ceil(lb / kPreciseThreads)), block
// kPreciseThreads; dynamic smem as gsq_precise_kernel.  The contract of
// gsq_fold_kernel.
template <int RB>
__global__ void __launch_bounds__(kPreciseThreads)
gsq_fold_precise_kernel(const uint8_t* __restrict__ codes,
                        long long code_list_stride,
                        const float* __restrict__ nrm,
                        long long nrm_list_stride,
                        const int* __restrict__ glist,
                        const int* __restrict__ ntiles,
                        const float* __restrict__ qs,
                        float* __restrict__ out_v, int* __restrict__ out_a,
                        int Q, int cap, int d_pad, int tile, int fold,
                        float alpha) {
  extern __shared__ __align__(16) float qsm_fold[];
  __shared__ float red[kPreciseThreads / 32];
  const int lb = tile / fold;
  const int bpt = (lb + kPreciseThreads - 1) / kPreciseThreads;
  const int t = blockIdx.y / bpt;
  const int bin_lo = (blockIdx.y % bpt) * kPreciseThreads;
  const int bin_hi = min(lb, bin_lo + kPreciseThreads);
  const int g = blockIdx.x;
  const long long lst = glist[g];
  const int capf = cap / fold;
  float* ov = out_v + (size_t)g * Q * capf + (size_t)t * lb;
  int* oa = out_a + (size_t)g * Q * capf + (size_t)t * lb;
  const float* nrow = nrm + lst * nrm_list_stride + (size_t)t * tile;
  if (t >= ntiles[g]) {
    write_skipped_tile(nrow, tile, ov, oa, bin_lo, bin_hi, Q, capf, red);
    return;
  }
  const int qrows = (Q + kPreciseQ - 1) / kPreciseQ * kPreciseQ;
  stage_queries_f32(qsm_fold, qs + (size_t)g * Q * d_pad, Q, qrows, d_pad);
  __syncthreads();
  const int c = bin_lo + threadIdx.x;
  if (c >= bin_hi) return;
  const size_t row_pitch = (size_t)d_pad * RB;
  const uint8_t* base =
      codes + lst * code_list_stride + (size_t)t * tile * row_pitch;
  for (int q0 = 0; q0 < Q; q0 += kPreciseQ) {
    float best[kPreciseQ];
    int arg[kPreciseQ];
    for (int j = 0; j < fold; ++j) {
      const int sl = j * lb + c;
      const float nv = nrow[sl];
      const bool on = nv < kDead;   // a masked slot keeps its operand
      float acc[kPreciseQ];
      if (on) precise_dot<RB>(acc, base + (size_t)sl * row_pitch, qsm_fold,
                              q0, d_pad);
#pragma unroll
      for (int i = 0; i < kPreciseQ; ++i) {
        const float dd = on ? __fsub_rn(nv, __fmul_rn(alpha, acc[i])) : nv;
        if (j == 0 || dd < best[i]) {   // first minimum wins
          best[i] = dd;
          arg[i] = j;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPreciseQ; ++i) {
      if (q0 + i < Q) {
        ov[(size_t)(q0 + i) * capf + c] = best[i];
        oa[(size_t)(q0 + i) * capf + c] = arg[i];
      }
    }
  }
}

cudaError_t reserve_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

size_t precise_smem(int Q, int d_pad) {
  return (size_t)((Q + kPreciseQ - 1) / kPreciseQ * kPreciseQ) * d_pad *
         sizeof(float);
}

}  // namespace

namespace {

template <int NT, int KS, int RB, bool VEC>
int launch_scan(const void* codes, long long code_list_stride, const void* nrm,
                long long nrm_list_stride, const void* glist,
                const void* ntiles, const void* qs, void* out, int G, int Q,
                int cap, int d_pad, int tile, int span, float alpha,
                int with_norms, int masked, cudaStream_t stream) {
  const int npass = (Q + 8 * NT - 1) / (8 * NT);
  const size_t smem =
      (size_t)npass * NT * 8 * d_pad * sizeof(__nv_bfloat16) +
      (size_t)kScanWarps * NT * 8 * kPitch * sizeof(float);
  cudaError_t e =
      reserve_smem((const void*)gsq_kernel<NT, KS, RB, VEC>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(G, (cap + span - 1) / span);
  gsq_kernel<NT, KS, RB, VEC><<<grid, kScanThreads, smem, stream>>>(
      (const uint8_t*)codes, code_list_stride, (const float*)nrm,
      nrm_list_stride, (const int*)glist, (const int*)ntiles,
      (const __nv_bfloat16*)qs, (float*)out, Q, cap, d_pad, tile, span, alpha,
      with_norms, masked);
  return (int)cudaGetLastError();
}

template <int KS, int RB, bool VEC, typename... Args>
int launch_scan_q(int Q, Args... args) {
  if (Q > 32) return launch_scan<8, KS, RB, VEC>(args...);
  if (Q > 16) return launch_scan<4, KS, RB, VEC>(args...);
  if (Q > 8) return launch_scan<2, KS, RB, VEC>(args...);
  return launch_scan<1, KS, RB, VEC>(args...);
}

template <int KS, int RB, typename... Args>
int launch_scan_v(bool vec, int Q, Args... args) {
  if (vec) return launch_scan_q<KS, RB, true>(Q, args...);
  return launch_scan_q<KS, RB, false>(Q, args...);
}

template <int RB>
int launch_scan_precise(const void* codes, long long code_list_stride,
                        const void* nrm, long long nrm_list_stride,
                        const void* glist, const void* ntiles, const void* qs,
                        void* out, int G, int Q, int cap, int d_pad, int tile,
                        float alpha, int with_norms, int masked,
                        cudaStream_t stream) {
  const size_t smem = precise_smem(Q, d_pad);
  cudaError_t e = reserve_smem((const void*)gsq_precise_kernel<RB>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(G, (cap + kPreciseThreads - 1) / kPreciseThreads);
  gsq_precise_kernel<RB><<<grid, kPreciseThreads, smem, stream>>>(
      (const uint8_t*)codes, code_list_stride, (const float*)nrm,
      nrm_list_stride, (const int*)glist, (const int*)ntiles,
      (const float*)qs, (float*)out, Q, cap, d_pad, tile, alpha, with_norms,
      masked);
  return (int)cudaGetLastError();
}

}  // namespace

// `span` (slots of a list per block, a multiple of 32) is
// ops/gsq.scan_block_slots' choice; `row_bytes` is 1 (u8 codes) or 2
// (bf16 rows) and `code_list_stride` counts bytes; `precise` takes f32
// queries (else bf16).  d_pad % 16 == 0 and 16-byte aligned rows are the
// wrapper's to check.
extern "C" int gsq_scan(const void* codes, long long code_list_stride,
                        const void* nrm, long long nrm_list_stride,
                        const void* glist, const void* ntiles, const void* qs,
                        void* out, int G, int Q, int cap, int d_pad, int tile,
                        int span, float alpha, int with_norms, int masked,
                        int row_bytes, int precise, void* stream) {
  if (G == 0 || cap == 0) return (int)cudaGetLastError();
  if (d_pad % 16 || span < kUnit || span % kUnit || tile < 1 ||
      (row_bytes != 1 && row_bytes != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (precise) {
    if (row_bytes == 2) {
      return launch_scan_precise<2>(codes, code_list_stride, nrm,
                                    nrm_list_stride, glist, ntiles, qs, out,
                                    G, Q, cap, d_pad, tile, alpha, with_norms,
                                    masked, st);
    }
    return launch_scan_precise<1>(codes, code_list_stride, nrm,
                                  nrm_list_stride, glist, ntiles, qs, out, G,
                                  Q, cap, d_pad, tile, alpha, with_norms,
                                  masked, st);
  }
  // 16-byte norms reads and output stores: every row of both starts on
  // a 16-byte boundary (the output is dense [G, Q, cap])
  const bool vec = cap % 4 == 0 && nrm_list_stride % 4 == 0 &&
                   (uintptr_t)nrm % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (row_bytes == 2) {
    if (d_pad % 64 == 0) {  // 64-dim chunks: a lane's 32 bytes of a row
      return launch_scan_v<4, 2>(vec, Q, codes, code_list_stride, nrm,
                                 nrm_list_stride, glist, ntiles, qs, out, G,
                                 Q, cap, d_pad, tile, span, alpha, with_norms,
                                 masked, st);
    }
    return launch_scan_v<1, 2>(vec, Q, codes, code_list_stride, nrm,
                               nrm_list_stride, glist, ntiles, qs, out, G, Q,
                               cap, d_pad, tile, span, alpha, with_norms,
                               masked, st);
  }
  if (d_pad % 128 == 0) {  // 128-dim chunks, two 16-byte loads per row
    return launch_scan_v<8, 1>(vec, Q, codes, code_list_stride, nrm,
                               nrm_list_stride, glist, ntiles, qs, out, G, Q,
                               cap, d_pad, tile, span, alpha, with_norms,
                               masked, st);
  }
  return launch_scan_v<1, 1>(vec, Q, codes, code_list_stride, nrm,
                             nrm_list_stride, glist, ntiles, qs, out, G, Q,
                             cap, d_pad, tile, span, alpha, with_norms, masked,
                             st);
}

namespace {

template <int NT, int KS, int RB>
int launch_fold(const void* codes, long long code_list_stride, const void* nrm,
                long long nrm_list_stride, const void* glist,
                const void* ntiles, const void* qs, void* out_v, void* out_a,
                int G, int Q, int cap, int d_pad, int tile, int fold,
                int nbins, float alpha, cudaStream_t stream) {
  const int npass = (Q + 8 * NT - 1) / (8 * NT);
  const size_t smem = (size_t)npass * NT * 8 * d_pad * sizeof(__nv_bfloat16);
  cudaError_t e =
      reserve_smem((const void*)gsq_fold_kernel<NT, KS, RB>, smem);
  if (e != cudaSuccess) return (int)e;
  const int lb = tile / fold;
  dim3 grid(G, (cap / tile) * ((lb + nbins - 1) / nbins));
  gsq_fold_kernel<NT, KS, RB><<<grid, kFoldThreads, smem, stream>>>(
      (const uint8_t*)codes, code_list_stride, (const float*)nrm,
      nrm_list_stride, (const int*)glist, (const int*)ntiles,
      (const __nv_bfloat16*)qs, (float*)out_v, (int*)out_a, Q, cap, d_pad,
      tile, fold, nbins, alpha);
  return (int)cudaGetLastError();
}

template <int KS, int RB, typename... Args>
int launch_fold_q(int Q, Args... args) {
  if (Q > 32) return launch_fold<8, KS, RB>(args...);
  if (Q > 16) return launch_fold<4, KS, RB>(args...);
  if (Q > 8) return launch_fold<2, KS, RB>(args...);
  return launch_fold<1, KS, RB>(args...);
}

template <int RB>
int launch_fold_precise(const void* codes, long long code_list_stride,
                        const void* nrm, long long nrm_list_stride,
                        const void* glist, const void* ntiles, const void* qs,
                        void* out_v, void* out_a, int G, int Q, int cap,
                        int d_pad, int tile, int fold, float alpha,
                        cudaStream_t stream) {
  const size_t smem = precise_smem(Q, d_pad);
  cudaError_t e =
      reserve_smem((const void*)gsq_fold_precise_kernel<RB>, smem);
  if (e != cudaSuccess) return (int)e;
  const int lb = tile / fold;
  dim3 grid(G, (cap / tile) *
                   ((lb + kPreciseThreads - 1) / kPreciseThreads));
  gsq_fold_precise_kernel<RB><<<grid, kPreciseThreads, smem, stream>>>(
      (const uint8_t*)codes, code_list_stride, (const float*)nrm,
      nrm_list_stride, (const int*)glist, (const int*)ntiles,
      (const float*)qs, (float*)out_v, (int*)out_a, Q, cap, d_pad, tile,
      fold, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// `nbins` (bins of a logical tile per block) is ops/gsq.fold_bin_chunk's
// choice (the f32 form takes 128 bins a block); `row_bytes` and `precise`
// as gsq_scan; fold <= 32 (one bit per fold slot) and d_pad % 16 == 0
// are the wrapper's to check.
extern "C" int gsq_fold_scan(const void* codes, long long code_list_stride,
                             const void* nrm, long long nrm_list_stride,
                             const void* glist, const void* ntiles,
                             const void* qs, void* out_v, void* out_a, int G,
                             int Q, int cap, int d_pad, int tile, int fold,
                             int nbins, float alpha, int row_bytes,
                             int precise, void* stream) {
  if (G == 0 || cap == 0) return (int)cudaGetLastError();
  if (fold < 1 || fold > 32 || d_pad % 16 || nbins < 1 ||
      (row_bytes != 1 && row_bytes != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (precise) {
    if (row_bytes == 2) {
      return launch_fold_precise<2>(codes, code_list_stride, nrm,
                                    nrm_list_stride, glist, ntiles, qs, out_v,
                                    out_a, G, Q, cap, d_pad, tile, fold, alpha,
                                    st);
    }
    return launch_fold_precise<1>(codes, code_list_stride, nrm,
                                  nrm_list_stride, glist, ntiles, qs, out_v,
                                  out_a, G, Q, cap, d_pad, tile, fold, alpha,
                                  st);
  }
  if (row_bytes == 2) {
    if (d_pad % 64 == 0) {  // 64-dim chunks: a lane's 32 bytes of a row
      return launch_fold_q<4, 2>(Q, codes, code_list_stride, nrm,
                                 nrm_list_stride, glist, ntiles, qs, out_v,
                                 out_a, G, Q, cap, d_pad, tile, fold, nbins,
                                 alpha, st);
    }
    return launch_fold_q<1, 2>(Q, codes, code_list_stride, nrm,
                               nrm_list_stride, glist, ntiles, qs, out_v,
                               out_a, G, Q, cap, d_pad, tile, fold, nbins,
                               alpha, st);
  }
  if (d_pad % 128 == 0) {  // 128-dim chunks, two 16-byte loads per row
    return launch_fold_q<8, 1>(Q, codes, code_list_stride, nrm,
                               nrm_list_stride, glist, ntiles, qs, out_v,
                               out_a, G, Q, cap, d_pad, tile, fold, nbins,
                               alpha, st);
  }
  return launch_fold_q<1, 1>(Q, codes, code_list_stride, nrm, nrm_list_stride,
                             glist, ntiles, qs, out_v, out_a, G, Q, cap, d_pad,
                             tile, fold, nbins, alpha, st);
}
