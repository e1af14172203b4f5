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
// What bounds it on the H100.  Per slot the scan reads W code bytes and
// does M table lookups, then writes 4 bytes; the table of a pair is at
// most a few KB.  At the B4 geometry the port reaches (M 20, ksub 16) a
// slot costs 20 B read + 4 B written, so the floor is device memory
// traffic: the [pairs, cap] output, the tables, and each probed list
// once.  Every pair reads its list's rows again, though, 32 pairs a list
// at batch 1024 x 64 probes over 2048 lists: that traffic comes from L2
// and is several times the device memory's.  The TPU kernel spent ksub x
// more ALU on one-hot select-sums because its VPU cannot gather; a GPU
// thread gathers from shared memory directly.
// Design: one block per (pair, up to 1024 slots) stages the pair's
// table (B4: M*ksub*4 bytes, B5: the query's M*16*4) and the code rows
// of its slots, which are one contiguous byte range of the list, in
// shared memory: 16-byte asynchronous copies from the 16-byte boundary
// below the range's start, neighbouring threads on neighbouring
// addresses, table and rows all in flight at once (a thread a row read
// its 20-byte row byte by byte across five cache lines a warp, and the
// load unit, not memory, set the time).  Then each thread sums its
// slots' lookups out of shared memory, a row read in the widest units
// its alignment allows (16, 4 or 1 bytes; the 20-byte rows in words,
// five banks apart, so without conflicts).  With ksub 16 the lookups of
// a warp hit one bank per code value, lanes with the same code the same
// word: no conflicts either.  What is left is instruction count: for
// the row widths of the engines' geometries the kernel is compiled with
// the width and ksub 16 known, so the loop unrolls and a lookup is a
// byte extract, a shared-memory load at an immediate offset and an add.
// Blocks are two warps: a block waits once, for its copies, and the
// smaller it is the more of an SM's blocks are past that wait (64
// threads measured 0.155 ms where 256 took 0.217, B4 at M 20, 65,536
// pairs x 512 slots, NVIDIA H100 80GB HBM3 at 700 W).
//
// No fast-math: the sums must match the plain version's IEEE arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;            // two warps: small blocks, see above
constexpr int kRowBytes = 24 * 1024;   // code rows a block stages, about
constexpr int kMaxSlots = 1024;        // most slots a block covers

// 16 bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void stage_lut(float* lut_s, const float* lut,
                                          int n) {
  if ((reinterpret_cast<uintptr_t>(lut) & 15u) == 0 && n % 4 == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
      copy16_async(lut_s + 4 * i, lut + 4 * i);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) lut_s[i] = lut[i];
  }
}

// Copy the bytes [beg, end) of device memory to rows_s + (beg & 15): whole
// 16-byte units, asynchronously, from the boundary at or below beg (inside
// the tensor when its base is 16-byte aligned: `vec`), the ragged end byte
// by byte.  Returns where the byte at `beg` stands in rows_s.
__device__ __forceinline__ int stage_rows(uint8_t* rows_s, const uint8_t* beg,
                                          const uint8_t* end, bool vec) {
  const int off = (int)(reinterpret_cast<uintptr_t>(beg) & 15u);
  const uint8_t* a0 = beg - off;
  const uint8_t* a1 =
      end - (int)(reinterpret_cast<uintptr_t>(end) & 15u);
  if (!vec || a1 <= a0) {
    const int n = (int)(end - beg);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      rows_s[off + i] = __ldg(beg + i);
    }
    return off;
  }
  const int units = (int)((a1 - a0) >> 4);
  for (int i = threadIdx.x; i < units; i += blockDim.x) {
    copy16_async(rows_s + 16 * i, a0 + 16 * i);
  }
  const int tail = (int)(end - a1);
  if ((int)threadIdx.x < tail) {
    rows_s[(a1 - a0) + threadIdx.x] = __ldg(a1 + threadIdx.x);
  }
  return off;
}

// One code byte's share of a slot's sum: B4 one entry of table j, B5 the
// entries of tables 2j and 2j+1 (low nibble first)
template <bool PACKED>
__device__ __forceinline__ float add_byte(float acc, const float* lut_s,
                                          int j, unsigned v, int ksub) {
  if constexpr (PACKED) {
    acc += lut_s[(2 * j) * 16 + (v & 15u)];
    return acc + lut_s[(2 * j + 1) * 16 + (v >> 4)];
  } else {
    return acc + lut_s[j * ksub + v];
  }
}

// V code bytes of a row from shared memory (V 4 or 16)
template <int V>
__device__ __forceinline__ void load_words(const uint8_t* p,
                                           uint32_t (&words)[V / 4]) {
  if constexpr (V == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    words[0] = u.x; words[1] = u.y; words[2] = u.z; words[3] = u.w;
  } else {
    words[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// The sum of one slot's W code bytes, read from shared memory V at a
// time.  WC > 0: W == WC and ksub == 16 are known to the compiler, the
// loop is unrolled and every table offset is an immediate (the lookups
// are bound by instruction count: this halves the instructions of one).
template <int V, bool PACKED, int WC>
__device__ __forceinline__ float sum_row(const uint8_t* row,
                                         const float* lut_s, int W,
                                         int ksub) {
  float acc = 0.f;
  if constexpr (WC > 0) {
#pragma unroll
    for (int j = 0; j < WC; j += V) {
      uint32_t words[V / 4];
      load_words<V>(row + j, words);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc = add_byte<PACKED>(acc, lut_s, j + i,
                               (words[i / 4] >> (8 * (i % 4))) & 0xffu, 16);
      }
    }
  } else if constexpr (V == 1) {
    for (int j = 0; j < W; ++j) {
      acc = add_byte<PACKED>(acc, lut_s, j, row[j], ksub);
    }
  } else {
    for (int j = 0; j < W; j += V) {
      uint32_t words[V / 4];
      load_words<V>(row + j, words);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc = add_byte<PACKED>(acc, lut_s, j + i,
                               (words[i / 4] >> (8 * (i % 4))) & 0xffu, ksub);
      }
    }
  }
  return acc;
}

// grid (B*P, ceil(cap / span)), block kThreads; dynamic smem: the table
// (nlut floats, rounded up to 16 bytes), then span*W + 32 row bytes.
// W: bytes per code row; V: bytes per shared-memory read of a row (every
// row of the tensor then starts on a V-byte boundary); PACKED: B5; WC:
// W where the kernel is compiled for one row width and ksub 16, else 0.
template <int V, bool PACKED, int WC>
__global__ void __launch_bounds__(kThreads)
adc_kernel(const uint8_t* __restrict__ codes, long long code_list_stride,
           const int* __restrict__ list_ids, const float* __restrict__ lut,
           long long lut_b_stride, long long lut_p_stride,
           float* __restrict__ out, int P, int cap, int W, int ksub,
           int span, int vec) {
  extern __shared__ __align__(16) unsigned char adc_smem[];
  const int pair = blockIdx.x;
  const int nlut = PACKED ? 2 * W * 16 : W * ksub;
  float* lut_s = reinterpret_cast<float*>(adc_smem);
  uint8_t* rows_s = adc_smem + ((nlut * 4 + 15) & ~15);
  const int s0 = blockIdx.y * span;
  const int n = min(span, cap - s0);
  // the table and every row of the block are asked for at once
  stage_lut(lut_s,
            lut + (pair / P) * lut_b_stride + (pair % P) * lut_p_stride,
            nlut);
  const uint8_t* beg = codes +
                       (long long)list_ids[pair] * code_list_stride +
                       (size_t)s0 * W;
  const int off = stage_rows(rows_s, beg, beg + (size_t)n * W, vec);
  wait_async_copies();
  __syncthreads();
  float* out_p = out + (size_t)pair * cap + s0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    out_p[i] = sum_row<V, PACKED, WC>(rows_s + off + (size_t)i * W, lut_s, W,
                                  ksub);
  }
}

// slots per block: about kRowBytes of code rows, in steps of kThreads
inline int block_slots(int cap, int W) {
  int span = kRowBytes / W / kThreads * kThreads;
  span = span < kThreads ? kThreads : span > kMaxSlots ? kMaxSlots : span;
  const int whole = (cap + kThreads - 1) / kThreads * kThreads;
  return span < whole ? span : whole;
}

template <int V, bool PACKED, int WC>
int launch(const void* codes, long long code_list_stride,
           const void* list_ids, const void* lut, long long lut_b_stride,
           long long lut_p_stride, void* out, int BP, int P, int cap, int W,
           int ksub, bool vec, cudaStream_t stream) {
  const int nlut = PACKED ? 2 * W * 16 : W * ksub;
  const int span = block_slots(cap, W);
  const size_t smem = (size_t)((nlut * 4 + 15) & ~15) + (size_t)span * W + 32;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)adc_kernel<V, PACKED, WC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(BP, (cap + span - 1) / span);
  adc_kernel<V, PACKED, WC><<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)codes, code_list_stride, (const int*)list_ids,
      (const float*)lut, lut_b_stride, lut_p_stride, (float*)out, P, cap, W,
      ksub, span, (int)vec);
  return (int)cudaGetLastError();
}

// The widest read every row start allows (W, the list stride and the
// base all multiples of it); the row widths compiled for (ksub 16: B4's
// M with M*16 % 128 != 0 in steps of 4, B5's M 32 and 64) take their
// unrolled kernel.
template <bool PACKED>
int dispatch(const void* codes, long long code_list_stride,
             const void* list_ids, const void* lut, long long lut_b_stride,
             long long lut_p_stride, void* out, int BP, int P, int cap, int W,
             int ksub, cudaStream_t stream) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  const bool vec = base % 16 == 0;
  auto fits = [&](int v) {
    return W % v == 0 && code_list_stride % v == 0 && base % v == 0;
  };
#define ADC_LAUNCH(V, WC)                                                   \
  return launch<V, PACKED, WC>(codes, code_list_stride, list_ids, lut,     \
                               lut_b_stride, lut_p_stride, out, BP, P, cap, \
                               W, ksub, vec, stream)
  if constexpr (PACKED) {
    if (fits(16) && W == 16) ADC_LAUNCH(16, 16);
    if (fits(16) && W == 32) ADC_LAUNCH(16, 32);
  } else if (ksub == 16 && fits(4)) {
    if (W == 4) ADC_LAUNCH(4, 4);
    if (W == 12) ADC_LAUNCH(4, 12);
    if (W == 20) ADC_LAUNCH(4, 20);
    if (W == 28) ADC_LAUNCH(4, 28);
  }
  if (fits(16)) ADC_LAUNCH(16, 0);
  if (fits(4)) ADC_LAUNCH(4, 0);
  ADC_LAUNCH(1, 0);
#undef ADC_LAUNCH
}

}  // namespace

extern "C" int adc_scan(const void* codes, long long code_list_stride,
                        const void* list_ids, const void* lut,
                        long long lut_b_stride, long long lut_p_stride,
                        void* out, int BP, int P, int cap, int M, int ksub,
                        void* stream) {
  if (BP == 0 || cap == 0) return (int)cudaGetLastError();
  return dispatch<false>(codes, code_list_stride, list_ids, lut, lut_b_stride,
                         lut_p_stride, out, BP, P, cap, M, ksub,
                         (cudaStream_t)stream);
}

// one table per query: the pair's table is lut[b], whatever p
extern "C" int adc_fs_scan(const void* codes, long long code_list_stride,
                           const void* list_ids, const void* lut, void* out,
                           int BP, int P, int cap, int W, void* stream) {
  if (BP == 0 || cap == 0) return (int)cudaGetLastError();
  return dispatch<true>(codes, code_list_stride, list_ids, lut,
                        (long long)2 * W * 16, 0, out, BP, P, cap, W, 16,
                        (cudaStream_t)stream);
}
