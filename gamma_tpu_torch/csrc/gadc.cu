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
// the lookup is a gather from a LUT in shared memory, and two things are
// scarce: shared-memory bandwidth for the slots x Q x M lookups (up to
// 8 G at the engine's geometry, against a 1 GB f32 output whose write
// takes 0.3 ms), and issue slots for the Q x M x ksub x dsub FMAs of the
// LUT build.  The design spends both once:
//   - A block owns (group, 8 queries, up to 1280 slots).  Its LUT stage
//     holds, per (subquantizer, entry), the 8 queries' bf16 values side
//     by side (16 bytes, query-minor), so one thread's lookup for
//     (slot, m) is ONE 16-byte load that serves 8 queries; the values
//     are widened to f32 with a shift or a mask and added in ascending m.
//   - Every LUT entry is built once per (group, query): a stage holds 16
//     subquantizers at ksub 256 (64 KB, so two blocks share an SM and
//     one's build and its device-memory latencies overlap the other's
//     lookups), and the f32 sums of the block's slots stay in registers
//     across the stages.
//   - The build runs on the tensor cores: per subquantizer and 16
//     entries, one mma.sync.m16n8k16 of the codebook rows (A: 16 entries
//     x dsub dims, zeros up to 16) with the 8 residual rows (B: dsub x 8
//     queries), bf16 operands, f32 sums.  Its accumulator tile is the
//     LUT's own [entry][query] layout, so a lane rounds cbn - alpha * ip
//     to bf16 (once) and stores one 4-byte word per entry.  With FMAs on
//     the CUDA cores the build cost more than the lookups.
//   - The build never waits on device memory: the codebook rows and
//     norms come in units of up to 12 KB through cp.async into a double
//     buffer in shared memory, the next unit in flight while this one is
//     multiplied, and the first unit of the next stage in flight during
//     this stage's lookups.  Reading them per MMA from device memory
//     (L2) left the build at four times the cost of the lookups.
//   - The lookups of a slot carry no branch, so the 16-byte loads of a
//     stage go out back to back and their latency overlaps: with a
//     bound check per subquantizer each load waited for the one before.
//     Random codes make the 8 lanes of a load phase collide on the
//     16-byte bank groups (about 2.7-fold), but the lookups are bound by
//     instruction issue (a shift or a mask and an add per value), not
//     by shared memory: storing a small LUT 8 times, one copy per bank
//     group, made the loads conflict-free and the kernel no faster.
//   - A thread reads its slots' code bytes straight from device memory
//     (a warp reads consecutive rows: coalesced) before the build, so
//     the latency hides behind it; the output is written in full
//     128-byte lines per warp.
//
// No fast-math: masked slots carry bias + BIG (3e38, next to the f32
// maximum) and must keep IEEE arithmetic exactly as the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 5;   // 1280 slots a block
constexpr int kQChunk = 8;           // queries per block = per LUT entry
constexpr int kStageWords = 4;       // code words (16 bytes) a slot a stage

// span, mc, vec16 and tu are ops/gadc.gadc_geometry's choice
struct Geometry {
  int Q, cap, M, ksub, dsub, W, tile, packed;
  int span;    // slots per block, <= kThreads * kSlotsPerThread
  int mc;      // subquantizers per LUT stage (even when packed)
  int vec16;   // code rows may be read with 16-byte loads
  int tu;      // 16-entry codebook tiles per build unit
};

// bytes of one build unit's buffer: codebook rows (bf16), then norms (f32)
__host__ __device__ inline size_t unit_cb_bytes(const Geometry& g) {
  return (size_t)g.tu * 16 * g.dsub * sizeof(__nv_bfloat16);
}
__host__ __device__ inline size_t unit_bytes(const Geometry& g) {
  return unit_cb_bytes(g) + (size_t)g.tu * 16 * sizeof(float);
}
__host__ __device__ inline size_t lut_bytes(const Geometry& g) {
  return (size_t)g.mc * g.ksub * sizeof(uint4);
}
// LUT stage, two unit buffers, the block's residual rows (bf16)
inline size_t smem_bytes(const Geometry& g) {
  return lut_bytes(g) + 2 * unit_bytes(g) +
         (size_t)kQChunk * g.M * g.dsub * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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

// elements d and d + 1 of the `n`-vector at v (shared memory) as one
// bf16x2 word, zeros past n (or for an absent row).  kEven: n is even,
// so the pair is one aligned 4-byte load.
template <bool kEven>
__device__ __forceinline__ uint32_t bf16_pair(const __nv_bfloat16* v, int d,
                                              int n, bool present) {
  const bool ok = present && d < n;
  if (kEven) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(ok ? v + d : v);
    const uint32_t x = *p;
    return ok ? x : 0u;
  }
  const uint32_t lo = ok ? __bfloat16_as_ushort(v[d]) : 0u;
  const uint32_t hi = ok && d + 1 < n ? __bfloat16_as_ushort(v[d + 1]) : 0u;
  return lo | (hi << 16);
}

// the stage's `nbytes` code bytes of one slot, little-endian into cw
__device__ __forceinline__ void load_code_words(const uint8_t* p, int nbytes,
                                                int vec16,
                                                uint32_t (&cw)[kStageWords]) {
  if (vec16) {
#pragma unroll
    for (int v = 0; v < kStageWords / 4; ++v) {
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (v * 16 < nbytes) x = __ldg(reinterpret_cast<const uint4*>(p) + v);
      cw[4 * v + 0] = x.x; cw[4 * v + 1] = x.y;
      cw[4 * v + 2] = x.z; cw[4 * v + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int w = 0; w < kStageWords; ++w) {
      uint32_t x = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (w * 4 + b < nbytes) x |= (uint32_t)__ldg(p + w * 4 + b) << (8 * b);
      }
      cw[w] = x;
    }
  }
}

// acc[q] += the 8 queries' bf16 values of one LUT entry
__device__ __forceinline__ void lut_add(float (&acc)[kQChunk],
                                        const uint4* entry) {
  const uint4 e = *entry;
  acc[0] += __uint_as_float(e.x << 16);
  acc[1] += __uint_as_float(e.x & 0xffff0000u);
  acc[2] += __uint_as_float(e.y << 16);
  acc[3] += __uint_as_float(e.y & 0xffff0000u);
  acc[4] += __uint_as_float(e.z << 16);
  acc[5] += __uint_as_float(e.z & 0xffff0000u);
  acc[6] += __uint_as_float(e.w << 16);
  acc[7] += __uint_as_float(e.w & 0xffff0000u);
}

// One slot's lookups of a stage: one 16-byte entry per subquantizer, m
// ascending.  cw holds the stage's code bytes of the slot; packed: byte
// b holds subquantizer 2b in its low nibble and 2b + 1 in its high one.
// kFull: the stage fills all 16 code bytes, so no lookup is guarded and
// the loads go out back to back.
template <bool kPacked, bool kFull>
__device__ __forceinline__ void scan_slot(float (&acc)[kQChunk],
                                          const uint32_t (&cw)[kStageWords],
                                          const uint4* lut, int ksub,
                                          int mc) {
#pragma unroll
  for (int w = 0; w < kStageWords; ++w) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int byte = (cw[w] >> (8 * b)) & 0xffu;
      if (kPacked) {
        const int mi = (w * 4 + b) * 2;
        if (kFull || mi < mc) {
          lut_add(acc, lut + mi * ksub + (byte & 15));
          lut_add(acc, lut + (mi + 1) * ksub + (byte >> 4));
        }
      } else {
        const int mi = w * 4 + b;
        if (kFull || mi < mc) lut_add(acc, lut + mi * ksub + byte);
      }
    }
  }
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The LUT build.  Tiles [t0, t_end) of a stage (tile = (mi, kt), index
// mi * ktiles + kt: 16 entries of one subquantizer) on the tensor cores:
// per tile one MMA per 16 dims gives ip[entry][query] in f32, and the
// entry cbn - alpha * ip is rounded to bf16 once.  cb_u / cbn_u hold the
// unit's run of entries from entry e0 on, rq the residual row of the
// lane's query, lut_w the stage's LUT.  A warp takes a contiguous run of
// the unit's tiles.

// a warp's run of tiles [tl, tl_end)
__device__ __forceinline__ void warp_tiles(int t0, int t_end, int& tl,
                                           int& tl_end) {
  const int nw = kThreads / 32;
  const int per_warp = (t_end - t0 + nw - 1) / nw;
  tl = t0 + (threadIdx.x >> 5) * per_warp;
  tl_end = min(t_end, tl + per_warp);
}

// one tile's two LUT words of a lane, from its MMA accumulators
__device__ __forceinline__ void store_tile(uint32_t* lut_w, int l_lo, int tq,
                                           const float (&ip)[4], float cn_lo,
                                           float cn_hi, float alpha,
                                           bool in_lo, bool in_hi) {
  const uint32_t w_lo = bf16x2_bits(__fsub_rn(cn_lo, __fmul_rn(alpha, ip[0])),
                                    __fsub_rn(cn_lo, __fmul_rn(alpha, ip[1])));
  const uint32_t w_hi = bf16x2_bits(__fsub_rn(cn_hi, __fmul_rn(alpha, ip[2])),
                                    __fsub_rn(cn_hi, __fmul_rn(alpha, ip[3])));
  if (in_lo) lut_w[l_lo * 4 + tq] = w_lo;
  if (in_hi) lut_w[(l_lo + 8) * 4 + tq] = w_hi;
}

// The common geometry: dsub even and <= 16, ksub % 16 == 0, so a tile is
// one MMA, every operand pair one aligned 4-byte load, and no tile is
// ragged.  Four tiles go through together: their loads, then their
// MMAs, then their stores, so that the latencies of one hide behind the
// others (one tile at a time, the build cost more than the lookups).
__device__ __forceinline__ void build_tiles_fast(
    const Geometry& geo, const __nv_bfloat16* cb_u, const float* cbn_u,
    const __nv_bfloat16* rq, uint32_t* lut_w, int e0, int m0, int t0,
    int t_end, bool has_q, float alpha) {
  constexpr int kBatch = 4;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int dsub = geo.dsub, ksub = geo.ksub;
  const int ktiles = ksub / 16;
  const bool wide = dsub > 8;   // dims 8.. exist: the MMA's upper k half
  int tl, tl_end;
  warp_tiles(t0, t_end, tl, tl_end);
  if (tl >= tl_end) return;
  const int mi = tl / ktiles;
  int kt = tl - mi * ktiles;
  // ksub = 16 * ktiles, so consecutive tiles are consecutive runs of 16
  // entries, in the unit and in the LUT, also across subquantizers
  int u_lo = (m0 + mi) * ksub + kt * 16 + gq - e0;
  int l_lo = mi * ksub + kt * 16 + gq;
  const __nv_bfloat16* r_m = rq + (m0 + mi) * dsub;
  uint32_t b0 = bf16_pair<true>(r_m, 2 * tq, dsub, has_q);
  uint32_t b1 = wide ? bf16_pair<true>(r_m, 2 * tq + 8, dsub, has_q) : 0u;
  for (; tl < tl_end; tl += kBatch) {
    uint32_t a[kBatch][4], b[kBatch][2];
    float cn[kBatch][2];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      // a tile past the run repeats the run's last one and stores nothing
      const int u = u_lo + 16 * min(j, tl_end - tl - 1);
      const __nv_bfloat16* c_lo = cb_u + u * dsub;
      const __nv_bfloat16* c_hi = c_lo + 8 * dsub;
      a[j][0] = bf16_pair<true>(c_lo, 2 * tq, dsub, true);
      a[j][1] = bf16_pair<true>(c_hi, 2 * tq, dsub, true);
      a[j][2] = wide ? bf16_pair<true>(c_lo, 2 * tq + 8, dsub, true) : 0u;
      a[j][3] = wide ? bf16_pair<true>(c_hi, 2 * tq + 8, dsub, true) : 0u;
      cn[j][0] = cbn_u[u];
      cn[j][1] = cbn_u[u + 8];
      b[j][0] = b0;
      b[j][1] = b1;
      if (++kt == ktiles) {  // the next tile is the next subquantizer's
        kt = 0;
        r_m += dsub;
        if (tl + j + 1 < tl_end) {
          b0 = bf16_pair<true>(r_m, 2 * tq, dsub, has_q);
          b1 = wide ? bf16_pair<true>(r_m, 2 * tq + 8, dsub, has_q) : 0u;
        }
      }
    }
    float ip[kBatch][4];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      ip[j][0] = ip[j][1] = ip[j][2] = ip[j][3] = 0.f;
      mma_bf16_m16n8k16(ip[j], a[j], b[j][0], b[j][1]);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool on = tl + j < tl_end;
      store_tile(lut_w, l_lo + 16 * j, tq, ip[j], cn[j][0], cn[j][1], alpha,
                 on, on);
    }
    u_lo += 16 * kBatch;
    l_lo += 16 * kBatch;
  }
}

// Any geometry: odd dsub (pairs from two 2-byte loads), dsub > 16 (several
// MMAs a tile), ksub % 16 != 0 (a ragged last tile per subquantizer).
__device__ __forceinline__ void build_tiles_any(
    const Geometry& geo, const __nv_bfloat16* cb_u, const float* cbn_u,
    const __nv_bfloat16* rq, uint32_t* lut_w, int e0, int m0, int t0,
    int t_end, bool has_q, float alpha) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int dsub = geo.dsub, ksub = geo.ksub;
  const int ktiles = (ksub + 15) / 16;
  const int ksteps = (dsub + 15) / 16;
  int tl, tl_end;
  warp_tiles(t0, t_end, tl, tl_end);
  if (tl >= tl_end) return;
  int mi = tl / ktiles;
  int kt = tl - mi * ktiles;
  for (; tl < tl_end; ++tl) {
    const bool in_lo = kt * 16 + gq < ksub, in_hi = kt * 16 + gq + 8 < ksub;
    const int u_lo = (m0 + mi) * ksub + kt * 16 + gq - e0;
    const __nv_bfloat16* c_lo = cb_u + u_lo * dsub;
    const __nv_bfloat16* c_hi = c_lo + 8 * dsub;
    const __nv_bfloat16* r_m = rq + (m0 + mi) * dsub;
    float ip[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = 0; ks < ksteps; ++ks) {
      const int d_lo = ks * 16 + 2 * tq;
      uint32_t a[4];
      a[0] = bf16_pair<false>(c_lo, d_lo, dsub, in_lo);
      a[1] = bf16_pair<false>(c_hi, d_lo, dsub, in_hi);
      a[2] = bf16_pair<false>(c_lo, d_lo + 8, dsub, in_lo);
      a[3] = bf16_pair<false>(c_hi, d_lo + 8, dsub, in_hi);
      mma_bf16_m16n8k16(ip, a, bf16_pair<false>(r_m, d_lo, dsub, has_q),
                        bf16_pair<false>(r_m, d_lo + 8, dsub, has_q));
    }
    store_tile(lut_w, mi * ksub + kt * 16 + gq, tq, ip,
               in_lo ? cbn_u[u_lo] : 0.f, in_hi ? cbn_u[u_lo + 8] : 0.f,
               alpha, in_lo, in_hi);
    if (++kt == ktiles) {
      kt = 0;
      ++mi;
    }
  }
}

// grid (G, ceil(Q / kQChunk), ceil(cap / span)), block kThreads
__global__ void __launch_bounds__(kThreads, 2)
gadc_kernel(const uint8_t* __restrict__ codes, long long code_list_stride,
            const int* __restrict__ glist, const int* __restrict__ ntiles,
            const __nv_bfloat16* __restrict__ rg,
            const __nv_bfloat16* __restrict__ cb,
            const float* __restrict__ cbn, const float* __restrict__ bias,
            long long bias_list_stride, float* __restrict__ out, Geometry geo,
            float alpha) {
  extern __shared__ uint4 lut_s[];           // [mc][ksub] x 8 bf16
  uint32_t* lut_w = reinterpret_cast<uint32_t*>(lut_s);
  uint8_t* unit_s = reinterpret_cast<uint8_t*>(lut_s) + lut_bytes(geo);
  __nv_bfloat16* rg_s = reinterpret_cast<__nv_bfloat16*>(
      unit_s + 2 * unit_bytes(geo));         // [kQChunk][md]
  const int md = geo.M * geo.dsub;

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

  // the build's MMA coordinates: lane (gq, tq) holds entries gq, gq + 8
  // of a 16-entry tile for queries 2*tq, 2*tq + 1, and feeds query gq
  const int gq = (threadIdx.x & 31) >> 2;
  const bool fast =
      (geo.dsub & 1) == 0 && geo.dsub <= 16 && (geo.ksub & 15) == 0;
  const int ktiles = (geo.ksub + 15) / 16;
  const bool has_q = gq < nq;   // an absent query is a zero row
  const __nv_bfloat16* rq = rg_s + gq * md;

  // the block's residual rows (read after the first unit's barrier)
  const __nv_bfloat16* rg_g = rg + ((size_t)g * geo.Q + q0) * md;
  for (int i = threadIdx.x; i < nq * md; i += kThreads) rg_s[i] = rg_g[i];

  // Build units: tiles [t0, t0 + tu) of a stage, tile = (mi, kt) with
  // index mi * ktiles + kt.  A unit's codebook rows and norms are one
  // contiguous run of entries; it is copied into unit buffer `buf`.
  // With ksub % 16 == 0 every run starts and ends on 16 bytes and goes
  // through cp.async; otherwise it is copied element by element.
  const bool async_ok = (geo.ksub & 15) == 0;
  auto unit_entries = [&](int m0, int mc, int t0, size_t& e0) -> int {
    const int t1 = min(t0 + geo.tu, mc * ktiles) - 1;   // last tile
    const int ma = t0 / ktiles, mb = t1 / ktiles;
    e0 = (size_t)(m0 + ma) * geo.ksub + (t0 - ma * ktiles) * 16;
    const size_t e1 =
        (size_t)(m0 + mb) * geo.ksub +
        min((t1 - mb * ktiles + 1) * 16, geo.ksub);
    return (int)(e1 - e0);
  };
  auto issue_unit = [&](int m0, int mc, int t0, int buf) {
    size_t e0;
    const int n = unit_entries(m0, mc, t0, e0);
    uint8_t* dst = unit_s + (size_t)buf * unit_bytes(geo);
    uint8_t* dst_n = dst + unit_cb_bytes(geo);
    const __nv_bfloat16* src = cb + e0 * geo.dsub;
    const float* src_n = cbn + e0;
    if (async_ok) {
      const int c16 = n * geo.dsub / 8;     // 16-byte chunks of rows
      const int n16 = n / 4;                // and of norms
      for (int i = threadIdx.x; i < c16 + n16; i += kThreads) {
        if (i < c16) {
          cp_async16(dst + (size_t)i * 16,
                     reinterpret_cast<const uint8_t*>(src) + (size_t)i * 16);
        } else {
          cp_async16(dst_n + (size_t)(i - c16) * 16,
                     reinterpret_cast<const uint8_t*>(src_n) +
                         (size_t)(i - c16) * 16);
        }
      }
    } else {
      __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
      float* dn = reinterpret_cast<float*>(dst_n);
      for (int i = threadIdx.x; i < n * geo.dsub; i += kThreads) d[i] = src[i];
      for (int i = threadIdx.x; i < n; i += kThreads) dn[i] = src_n[i];
    }
  };
  int buf = 0;
  issue_unit(0, min(geo.mc, geo.M), 0, 0);

  float acc[kSlotsPerThread][kQChunk];
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
#pragma unroll
    for (int qc = 0; qc < kQChunk; ++qc) acc[i][qc] = 0.f;
  }
  const uint8_t* crow = codes + lst * code_list_stride +
                        (size_t)(s_begin + threadIdx.x) * geo.W;

  for (int m0 = 0; m0 < geo.M; m0 += geo.mc) {
    const int mc = min(geo.mc, geo.M - m0);
    // this stage's code bytes of the thread's live slots, asked for
    // before the build so that their latency hides behind it
    const int nbytes = geo.packed ? mc / 2 : mc;
    const int boff = geo.packed ? m0 / 2 : m0;
    uint32_t cw[kSlotsPerThread][kStageWords];
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i) {
      if (threadIdx.x + i * kThreads < n_live) {
        load_code_words(crow + (size_t)i * kThreads * geo.W + boff, nbytes,
                        geo.vec16, cw[i]);
      }
    }
    // the LUT stage, unit by unit
    const int stage_tiles = mc * ktiles;
    for (int t0 = 0; t0 < stage_tiles; t0 += geo.tu) {
      cp_async_wait_all();
      // this unit has landed; the previous unit's reads, and at t0 == 0
      // the previous stage's lookups, are done
      __syncthreads();
      if (t0 + geo.tu < stage_tiles) {  // the next unit, while this one runs
        issue_unit(m0, mc, t0 + geo.tu, buf ^ 1);
      } else if (m0 + geo.mc < geo.M) {
        issue_unit(m0 + geo.mc, min(geo.mc, geo.M - m0 - geo.mc), 0, buf ^ 1);
      }
      size_t e0;
      unit_entries(m0, mc, t0, e0);
      const __nv_bfloat16* cb_u = reinterpret_cast<const __nv_bfloat16*>(
          unit_s + (size_t)buf * unit_bytes(geo));
      const float* cbn_u = reinterpret_cast<const float*>(
          reinterpret_cast<const uint8_t*>(cb_u) + unit_cb_bytes(geo));
      const int t_end = min(t0 + geo.tu, stage_tiles);
      if (fast) {
        build_tiles_fast(geo, cb_u, cbn_u, rq, lut_w, (int)e0, m0, t0, t_end,
                         has_q, alpha);
      } else {
        build_tiles_any(geo, cb_u, cbn_u, rq, lut_w, (int)e0, m0, t0, t_end,
                        has_q, alpha);
      }
      buf ^= 1;
    }
    __syncthreads();

    // the lookups of the thread's live slots
    const bool full = nbytes == 4 * kStageWords;
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i) {
      if (threadIdx.x + i * kThreads >= n_live) continue;
      if (geo.packed) {
        if (full) scan_slot<true, true>(acc[i], cw[i], lut_s, geo.ksub, mc);
        else scan_slot<true, false>(acc[i], cw[i], lut_s, geo.ksub, mc);
      } else {
        if (full) scan_slot<false, true>(acc[i], cw[i], lut_s, geo.ksub, mc);
        else scan_slot<false, false>(acc[i], cw[i], lut_s, geo.ksub, mc);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    const int sl = threadIdx.x + i * kThreads;
    const int s = s_begin + sl;
    if (s >= s_end) continue;
    const float b = brow ? brow[s] : 0.f;
#pragma unroll
    for (int qc = 0; qc < kQChunk; ++qc) {
      if (qc < nq) {
        const float v =
            sl < n_live ? (brow ? __fadd_rn(acc[i][qc], b) : acc[i][qc]) : b;
        out_g[(size_t)qc * geo.cap + s] = v;
      }
    }
  }
}

}  // namespace

// span, mc, vec16 and tu come from ops/gadc.gadc_geometry; a geometry
// the kernel's registers cannot hold is refused here, and one whose shared
// memory exceeds the card's limit by cudaFuncSetAttribute: the error code
// is returned either way.
extern "C" int gadc_scan(const void* codes, long long code_list_stride,
                         const void* glist, const void* ntiles, const void* rg,
                         const void* cb, const void* cbn, const void* bias,
                         long long bias_list_stride, void* out, int G, int Q,
                         int cap, int M, int ksub, int dsub, int W, int tile,
                         float alpha, int packed, int span, int mc, int vec16,
                         int tu, void* stream) {
  if (G == 0 || cap == 0) return (int)cudaGetLastError();
  Geometry geo;
  geo.Q = Q; geo.cap = cap; geo.M = M; geo.ksub = ksub; geo.dsub = dsub;
  geo.W = W; geo.tile = tile; geo.packed = packed;
  geo.span = span; geo.mc = mc; geo.vec16 = vec16;
  geo.tu = tu;
  const int stage_bytes = packed ? mc / 2 : mc;
  if (span < 1 || span > kThreads * kSlotsPerThread || mc < 1 ||
      stage_bytes > 4 * kStageWords || (packed && (mc & 1)) || tu < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(geo);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)gadc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(G, (Q + kQChunk - 1) / kQChunk, (cap + span - 1) / span);
  gadc_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, code_list_stride, (const int*)glist,
      (const int*)ntiles, (const __nv_bfloat16*)rg, (const __nv_bfloat16*)cb,
      (const float*)cbn, (const float*)bias, bias_list_stride, (float*)out,
      geo, alpha);
  return (int)cudaGetLastError();
}
