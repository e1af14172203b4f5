// Row gather for Hopper (sm_90a): the kernel X1.
//
// Replaces the TPU kernel of experiments/exp_rerank.py, gather_rows_pallas
// (its inline kernel, rps row DMAs in flight per grid step).
//
// Contract: out[i, :] = table[idx[i], :] for 0 <= idx[i] < n, and a row of
// zeros for any other index (the TPU kernel leaves those undefined).  Rows
// are copied bit for bit, whatever the element type; indices are int32 or
// int64 and byte offsets are 64-bit (mirrors of 2.56 GB).
//
// What bounds it on the H100.  It does no arithmetic: its least time is
// the distinct rows read once plus the k output rows written once, over
// 3.35 TB/s.  The exact rerank hands it a batch's candidates, and a batch
// of repeated queries repeats them (88-94% of the indices at D-vgg and
// D-10M), so the output write is most of the bound (D-vgg: 419 MB written
// against 52 MB of distinct 2 KB rows) and the repeats can come from L2
// if they are read close together in time.  Every row is a dependent
// chain (index, row, store), so the time is set by how many chains are
// in flight and by how close together the repeats of a row are read.
// Two paths, one kernel each, chosen in the launcher by row bytes and
// alignment (no path gives way to another: a refused launch raises):
//   bulk (gather_rows_bulk_kernel): rows of kBulkMinRowBytes to
//     kBulkMaxRowBytes with 16-byte alignment.  One warp a block.  k is
//     split evenly into kBulkSlotsPerSm slots an SM and each slot into
//     blocks of kBulkRows rows; block b takes position b / slots of slot
//     b % slots, so the blocks resident together copy the same position
//     of every slot: a batch of repeated queries (each slot a copy's
//     share) reads each repeat of a row at about the same time, and it
//     hits L2, while the blocks are still scheduled by the hardware as
//     they finish.  Lane 0 copies whole rows with cp.async.bulk (TMA)
//     into a ring of shared-memory stages, one mbarrier a stage, and
//     sends each arrived stage out with a bulk store (bulk_group; at
//     most kBulkLag stores pending before a stage is refilled).  No
//     register holds a byte of a row.  The ring and a row of zeros stay
//     under the 48 KB a block takes without opting in, and four such
//     blocks fit an SM, so wider rows take the vector path.
//   vector (gather_rows_kernel): narrower rows (fp8 and bf16 at d 128:
//     128 and 256 B), wider ones, and rows whose width or base allows
//     no 16-byte unit (units of 8, 4, 2 or 1 bytes).  tpr threads a row
//     (a power of two up to a warp), 2 rows a thread for 16-byte units
//     and 4 for the narrower ones: each thread issues all its rows'
//     loads before its stores and loads the next step's indices before
//     this step's rows; 256-thread blocks, as many as fit, each walking
//     steps a grid apart.
// Cache policy: an output larger than L2 is written with an L2
// evict_first policy (the rerank reads it back from memory anyway, and
// the repeated rows stay); a smaller one with the normal policy, so that
// the rerank that reads it next finds it in L2.  The table's rows are
// read with the default policy.
//
// The threshold, measured (chip_smoke.py phase C's "X1 paths": f32 rows,
// 204,800 distinct / 8x-repeated indices of a 1M-row table, ms, vector
// against bulk; NVIDIA H100 80GB HBM3, 700 W):
//   256 B  0.0402 / 0.0421   repeated 0.0262 / 0.0352   -> vector
//   512 B  0.0768 / 0.0771   repeated 0.0531 / 0.0475   -> bulk
//   1 KB   0.1516 / 0.1486   repeated 0.1285 / 0.0904   -> bulk
//   2 KB   0.2989 / 0.2960   repeated 0.2862 / 0.1816   -> bulk
// so kBulkMinRowBytes is 512.  On distinct 2 KB rows both paths took
// 0.296-0.300 ms against torch.index_select's 0.286 (the same run's "X1
// sweep float32 d512 distinct" row): a loss of 1-4% that this design
// does not close.  The repeats are where it gains.
// ptxas (phase B): vector 40 registers for 16-byte units (58-71 for the
// narrow units), bulk 39 registers and 128 B of static shared memory
// (its barriers), no spills.
//
// The TPU kernel's sequential grid of DMA descriptors has no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;          // vector path: threads a block
constexpr int kBulkRows = 16;          // bulk path: rows a block, and at
                                       // most as many ring stages
constexpr int kBulkLag = 4;            // bulk stores pending before a refill
constexpr int kBulkRingBytes = 24576;  // a block's ring, at most kBulkRows
constexpr int kBulkSlotsPerSm = 4;     // blocks an SM the rows are split to
constexpr int kBulkMinRowBytes = 512;  // measured: see the note
constexpr int kBulkMaxRowBytes = 4096; // 8 stages and a zero row: 36 KB
constexpr int kMaxDevices = 64;        // devices whose geometry is kept

// The output's L2 policy: evict_first when `stream` (an output larger
// than L2, which the rerank reads back from memory anyway), else normal.
__device__ __forceinline__ uint64_t out_policy(int stream) {
  uint64_t p;
  if (stream)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
                 : "=l"(p));
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------
// vector path
// ---------------------------------------------------------------------

// rows a thread: 2 for 16-byte units (40 registers), 4 for the narrower
template <typename Unit>
__host__ __device__ constexpr int rows_a_thread() {
  return sizeof(Unit) == 16 ? 2 : 4;
}

// 16-byte stores carry the output's policy; the narrower units of the odd
// row widths take plain stores.
template <typename Unit>
__device__ __forceinline__ void store_unit(Unit* p, Unit v, uint64_t) {
  *p = v;
}

template <>
__device__ __forceinline__ void store_unit<uint4>(uint4* p, uint4 v,
                                                  uint64_t pol) {
  asm volatile(
      "st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;"
      :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(pol)
      : "memory");
}

template <typename Idx, int kRows>
__device__ __forceinline__ void load_indices(long long (&src)[kRows],
                                             const Idx* __restrict__ idx,
                                             long long k, long long r0,
                                             int pass) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = r0 + (long long)i * pass;
    src[i] = r < k ? (long long)idx[r] : -1;
  }
}

template <typename Unit, typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Unit* __restrict__ table, long long n,
                   const Idx* __restrict__ idx, Unit* __restrict__ out,
                   long long k, int units, int tpr_log2, int stream) {
  constexpr int kRows = rows_a_thread<Unit>();
  const int tpr = 1 << tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  const int slot = threadIdx.x >> tpr_log2;
  const int pass = kThreads >> tpr_log2;             // rows a pass
  const long long step = (long long)pass * kRows;    // rows a block step
  const long long stride = step * gridDim.x;
  const uint64_t st_pol = out_policy(stream);
  long long base = (long long)blockIdx.x * step;
  long long src[kRows];
  load_indices<Idx, kRows>(src, idx, k, base + slot, pass);
  for (; base < k; base += stride) {
    long long nxt[kRows];            // the next step's, ahead of its rows
    load_indices<Idx, kRows>(nxt, idx, k, base + stride + slot, pass);
    for (int u = lane; u < units; u += tpr) {
      Unit v[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        v[i] = (src[i] >= 0 && src[i] < n)
                   ? __ldg(table + src[i] * units + u)
                   : Unit{};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const long long r = base + (long long)i * pass + slot;
        if (r < k) store_unit(out + r * units + u, v[i], st_pol);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) src[i] = nxt[i];
  }
}

// ---------------------------------------------------------------------
// bulk path
// ---------------------------------------------------------------------

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One warp, up to kBulkRows rows.  Block b covers rows [lo, hi) of slot
// b % slots at position b / slots: the slots split k evenly, and the
// blocks that run together (in order of b) copy the same position of
// every slot.  Dynamic shared memory: `stages` rows of the ring, then one
// row of zeros (the source of every out-of-range row's store).
template <typename Idx>
__global__ void __launch_bounds__(32)
gather_rows_bulk_kernel(const char* __restrict__ table, long long n,
                        const Idx* __restrict__ idx, char* __restrict__ out,
                        long long k, int row_bytes, int stages, int slots,
                        int stream) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kBulkRows];
  const int lane = threadIdx.x;
  const long long per_slot = (k + slots - 1) / slots;
  const long long slot = blockIdx.x % slots;
  const long long lo =
      slot * per_slot + (long long)(blockIdx.x / slots) * kBulkRows;
  long long hi = lo + kBulkRows;
  if (hi > (slot + 1) * per_slot) hi = (slot + 1) * per_slot;
  if (hi > k) hi = k;
  if (lo >= hi) return;
  const long long cnt = hi - lo;
  // cur: the indices of rows lo + [win, win + 32), a lane each; nxt: the
  // 32 after them, loaded a window ahead of the copies that need them
  long long win = 0;
  long long cur = lane < cnt ? (long long)idx[lo + lane] : -1;
  long long nxt = 32 + lane < cnt ? (long long)idx[lo + 32 + lane] : -1;
  unsigned char* zero = ring + (size_t)stages * row_bytes;
  for (int b = lane * 16; b < row_bytes; b += 32 * 16)
    *reinterpret_cast<uint4*>(zero + b) = make_uint4(0, 0, 0, 0);
  // the zeros were written by the threads; the bulk stores read them
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  const uint32_t ring_s = smem_addr(ring), zero_s = smem_addr(zero);
  const uint32_t full_s = smem_addr(full);
  if (lane == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(full_s + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const uint64_t st_pol = out_policy(stream);

  uint32_t zeros = 0;        // bit s: stage s holds an out-of-range row
  int ls = 0;                // the stage the next load fills
  long long ld = 0;          // the next row to load
  auto issue = [&]() {       // all lanes (the shuffle), lane 0 copies
    if (ld == win + 32) {
      cur = nxt;
      win += 32;
      nxt = win + 32 + lane < cnt ? (long long)idx[lo + win + 32 + lane]
                                  : -1;
    }
    const long long src = __shfl_sync(0xffffffffu, cur, (int)(ld - win));
    if (lane == 0) {
      const uint32_t bar = full_s + 8 * ls;
      if (src >= 0 && src < n) {
        zeros &= ~(1u << ls);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
            :: "r"(bar), "r"(row_bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
            "::bytes [%0], [%1], %2, [%3];"
            :: "r"(ring_s + (uint32_t)(ls * row_bytes)),
               "l"(table + src * row_bytes), "r"(row_bytes), "r"(bar)
            : "memory");
      } else {
        zeros |= 1u << ls;
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                     :: "r"(bar) : "memory");
      }
    }
    if (++ls == stages) ls = 0;
    ++ld;
  };

  while (ld < cnt && ld < stages - kBulkLag) issue();
  int ss = 0;                // the stage row j arrives in
  uint32_t phase = 0;
  for (long long j = 0; j < cnt; ++j) {
    if (lane == 0) {
      mbar_wait(full_s + 8 * ss, phase);
      const uint32_t from = ((zeros >> ss) & 1)
                                ? zero_s
                                : ring_s + (uint32_t)(ss * row_bytes);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
          " [%0], [%1], %2, %3;"
          :: "l"(out + (lo + j) * row_bytes), "r"(from), "r"(row_bytes),
             "l"(st_pol)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (++ss == stages) {
      ss = 0;
      phase ^= 1;
    }
    if (ld < cnt) {
      // the stage row `ld` takes last held row ld - stages = j - kBulkLag,
      // whose store is the oldest of the kBulkLag + 1 committed since
      if (lane == 0 && ld >= stages)
        asm volatile("cp.async.bulk.wait_group.read %0;"
                     :: "n"(kBulkLag) : "memory");
      issue();
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------

// The current device, its SM count and whether `out_bytes` exceeds its L2
// (the output's policy); the attributes are asked once a device.
cudaError_t device_geometry(long long out_bytes, int* dev, int* sms,
                            int* stream_out) {
  static std::atomic<int> sm_of[kMaxDevices];
  static std::atomic<int> l2_of[kMaxDevices];
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  int l2 = 0;
  if (*dev < kMaxDevices && sm_of[*dev].load() > 0) {
    *sms = sm_of[*dev].load();
    l2 = l2_of[*dev].load();
  } else {
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, *dev);
    if (e != cudaSuccess) return e;
    if (*dev < kMaxDevices) {
      l2_of[*dev].store(l2);
      sm_of[*dev].store(*sms);
    }
  }
  *stream_out = out_bytes > l2;
  return cudaSuccess;
}

template <typename Unit, typename Idx>
cudaError_t launch_vector(const void* table, long long n, const void* idx,
                          void* out, long long k, int row_bytes,
                          cudaStream_t stream) {
  // the blocks of this kernel that fit an SM, asked once a device
  static std::atomic<int> fit_of[kMaxDevices];
  const int units = row_bytes / (int)sizeof(Unit);
  int tpr_log2 = 0;
  while ((1 << tpr_log2) < units && tpr_log2 < 5) ++tpr_log2;
  const long long step =
      (long long)(kThreads >> tpr_log2) * rows_a_thread<Unit>();
  auto kern = gather_rows_kernel<Unit, Idx>;
  int dev = 0, sms = 0, stream_out = 0, fit = 0;
  cudaError_t e = device_geometry(k * row_bytes, &dev, &sms, &stream_out);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices) fit = fit_of[dev].load();
  if (fit == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kern,
                                                      kThreads, 0);
    if (e != cudaSuccess) return e;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    if (dev < kMaxDevices) fit_of[dev].store(fit);
  }
  long long blocks = (long long)sms * fit;
  if ((k + step - 1) / step < blocks) blocks = (k + step - 1) / step;
  kern<<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const Unit*)table, n, (const Idx*)idx, (Unit*)out, k, units,
      tpr_log2, stream_out);
  return cudaGetLastError();
}

template <typename Idx>
cudaError_t launch_bulk(const void* table, long long n, const void* idx,
                        void* out, long long k, int row_bytes,
                        cudaStream_t stream) {
  int stages = kBulkRingBytes / row_bytes;
  if (stages < 2 * kBulkLag) stages = 2 * kBulkLag;
  if (stages > kBulkRows) stages = kBulkRows;
  // at most 9 x 4 KB: no opt-in, and kBulkSlotsPerSm blocks fit an SM
  const size_t smem = (size_t)(stages + 1) * row_bytes;
  int dev = 0, sms = 0, stream_out = 0;
  cudaError_t e = device_geometry(k * row_bytes, &dev, &sms, &stream_out);
  if (e != cudaSuccess) return e;
  long long slots = (long long)sms * kBulkSlotsPerSm;
  if (k < slots) slots = k;
  const long long per_slot = (k + slots - 1) / slots;
  const long long blocks = slots * ((per_slot + kBulkRows - 1) / kBulkRows);
  gather_rows_bulk_kernel<Idx><<<(unsigned)blocks, 32, smem, stream>>>(
      (const char*)table, n, (const Idx*)idx, (char*)out, k, row_bytes,
      stages, (int)slots, stream_out);
  return cudaGetLastError();
}

template <typename Idx>
cudaError_t dispatch(const void* table, long long n, const void* idx,
                     void* out, long long k, int row_bytes, int unit_bytes,
                     int path, cudaStream_t s) {
  const bool bulk_fits = unit_bytes == 16 && row_bytes <= kBulkMaxRowBytes;
  if (path < 0) path = bulk_fits && row_bytes >= kBulkMinRowBytes;
  if (path == 1) {
    if (!bulk_fits) return cudaErrorInvalidValue;
    return launch_bulk<Idx>(table, n, idx, out, k, row_bytes, s);
  }
  if (path != 0) return cudaErrorInvalidValue;
  switch (unit_bytes) {
    case 16: return launch_vector<uint4, Idx>(table, n, idx, out, k,
                                              row_bytes, s);
    case 8: return launch_vector<uint2, Idx>(table, n, idx, out, k,
                                             row_bytes, s);
    case 4: return launch_vector<uint32_t, Idx>(table, n, idx, out, k,
                                                row_bytes, s);
    case 2: return launch_vector<uint16_t, Idx>(table, n, idx, out, k,
                                                row_bytes, s);
    case 1: return launch_vector<uint8_t, Idx>(table, n, idx, out, k,
                                               row_bytes, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// table [n, row_bytes] (dense rows), idx [k] int32 (idx_bytes 4) or int64
// (8), out [k, row_bytes]; unit_bytes divides row_bytes, and is 16 only
// when table, out and row_bytes are 16-byte aligned.  path: -1 chooses by
// row bytes (bulk from kBulkMinRowBytes to kBulkMaxRowBytes with 16-byte
// units, else vector), 0 forces the vector path, 1 the bulk path (to
// measure the threshold); a path the row does not allow returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int gather_rows_path(const void* table, long long n,
                                const void* idx, int idx_bytes, void* out,
                                long long k, int row_bytes, int unit_bytes,
                                int path, void* stream) {
  if (k == 0 || row_bytes == 0) return (int)cudaGetLastError();
  if (unit_bytes <= 0 || row_bytes % unit_bytes != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (idx_bytes == 8)
    return (int)dispatch<long long>(table, n, idx, out, k, row_bytes,
                                    unit_bytes, path, s);
  if (idx_bytes == 4)
    return (int)dispatch<int>(table, n, idx, out, k, row_bytes, unit_bytes,
                              path, s);
  return (int)cudaErrorInvalidValue;
}

// The path chosen by row bytes and alignment.
extern "C" int gather_rows(const void* table, long long n, const void* idx,
                           int idx_bytes, void* out, long long k,
                           int row_bytes, int unit_bytes, void* stream) {
  return gather_rows_path(table, n, idx, idx_bytes, out, k, row_bytes,
                          unit_bytes, -1, stream);
}
