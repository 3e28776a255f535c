// mailbox_gather — per-destination-row windows of the row-sorted
// candidate stream, for the "sort2" select-sweep insert.
//
// Replaces the Pallas TPU kernel shadow_tpu/core/insert_pallas.py
// (mailbox_gather, pl.pallas_call at :118), which issued one
// HBM->VMEM DMA per destination row with 16 in flight.
//
//   out[h, j, :] = stream[min(max(start[h], 0) + j, rows - 1), :]
//   for h < H, j < Wn
//
// stream [rows, P] int32 (rows = n + Wn: the sorted stream padded with
// Wn zero rows), start [H] int32 (exclusive cumsum of per-row arrival
// counts: non-decreasing, steps of at most Wn, start[h] <= n), out
// [H, Wn, P] int32. The clamps never bind under that contract; they keep
// the kernel equal to its plain PyTorch version
// (core/insert_kernels.py mailbox_gather_ref) on every input.
//
// Bound: device memory, no arithmetic. At the main path (H = 10,240,
// Wn = 32, P = 11, Poisson(8) arrivals a row) the output is 14.4 MB and
// the distinct stream rows 3.6 MB: 5.3 us at 3.35 TB/s. Writes are 80%
// of the bytes. Consecutive windows overlap ~4x, so a copy per window
// reads the stream ~4 times (L2 hits, mostly).
//
// The first design (tools/gather_designs/first.cu) gave each block of
// 128 threads 4 rows, one after another, with 4-byte loads and stores:
// 0.00905-0.00936 ms cold at the main path (57-59% of the bound),
// 0.0031-0.0034 ms at H = 1,000 (13%), on an H100 80GB HBM3 at 700 W
// (PERF.md).
//
// This design: one tile of R <= 32 consecutive rows a block, the grid
// ceil(H / R) blocks (insert_kernels.gather_geometry: R = ceil(H / (2 *
// SMs)) up to 16, so every SM gets blocks at every width and the card's
// block scheduler keeps every resident block's copy in flight). Under
// the contract a tile's windows lie in one span [min s, max s + Wn) of
// the stream, at most R * Wn rows. Warp 0 loads the tile's starts; its
// lane 0 copies the span into the block's shared-memory stage with ONE
// bulk async copy (cp.async.bulk, the TMA's 1D form, completing on an
// mbarrier), so each stream byte is read once. The block's 4 warps then
// write the tile's windows, one window a warp at a time, with 16-byte
// stores (the output row stride Wn*P*4 is a multiple of 16 when Wn*P is
// a multiple of 4; else scalar stores), taking up each window's
// 0-3-word misalignment from two aligned 16-byte reads of the stage.
// A persistent grid walking tiles through a 2-stage ring was measured
// slower than one tile a block at every width the repo runs (PERF.md).
//
// Every edge stays in this kernel: a span wider than the stage (starts
// that jump or go down) takes the word-by-word path, every word read
// from device memory; so do clamped windows (near rows - 1) and the
// words of a widened span that would leave the tensor. The stage stays
// under 48 KB, so no launch raises the dynamic shared-memory limit.
//
// Traps:
// - Bulk copy: size a multiple of 16, both addresses 16-byte aligned.
//   The span is widened to 16-byte boundaries of the ABSOLUTE address
//   (data_ptr need not be 16-byte aligned: a view like big[1:]), then
//   cut back to the tensor's own aligned interior; nothing outside
//   [data_ptr, data_ptr + rows*P*4) is read.
// - expect_tx's byte count equals the copy's size exactly (0 when there
//   is no copy): the phase completes on the arrival AND the bytes.
// - The mbarrier is used once, so every wait is on phase parity 0.
// - int64 byte offsets throughout: n * P * 4 reaches 230 MB at the Tor
//   shape, and a general stream may pass 2 GB.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define WARPS (THREADS / 32)
#define MAX_TILE_ROWS 32           // one start a lane of warp 0
#define STAGE_MAX (48 * 1024 - 256)  // the stage, under 48 KB with the
                                     // static shared memory below

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst_smem, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst_smem)), "l"(src), "r"(bytes),
         "r"(smem_addr(bar)) : "memory");
}

// One word of a window: from the stage when the bulk copy brought it,
// else from device memory. [blo, bhi) are the copied bytes and glo the
// stage's byte 0, as byte offsets from the stream's data_ptr.
__device__ __forceinline__ int32_t window_word(
    const int32_t* __restrict__ stream, const int32_t* stage,
    long long glo, long long blo, long long bhi, int s, int w,
    int64_t rows, int P) {
  const int j = w / P;
  int64_t row = (int64_t)s + j;
  if (row > rows - 1) row = rows - 1;
  const int64_t k = row * P + (w - j * P);
  const long long b = 4 * k;
  if (b >= blo && b < bhi) return stage[(b - glo) >> 2];
  return __ldg(stream + k);
}

__global__ void __launch_bounds__(THREADS)
mailbox_gather_kernel(const int32_t* __restrict__ stream,
                      const int32_t* __restrict__ start,
                      int32_t* __restrict__ out,
                      int H, int64_t rows, int Wn, int P, int tile_rows,
                      int stage_bytes, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];   // the stage
  __shared__ uint64_t full;
  __shared__ long long span[3];   // glo, blo, bhi
  __shared__ int bs[MAX_TILE_ROWS];   // the tile's starts, clamped

  const int64_t h0 = (int64_t)blockIdx.x * tile_rows;
  const int nr = (int)(H - h0 < tile_rows ? H - h0 : tile_rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long win_words = (long long)Wn * P;
  const long long row_bytes = 4LL * P;

  if (warp == 0) {
    long long v = lane < nr ? start[h0 + lane] : 0;
    if (v < 0) v = 0;
    if (v > rows - 1) v = rows - 1;
    const int s = (int)v;
    if (lane < nr) bs[lane] = s;
    const int mn = __reduce_min_sync(0xffffffffu,
                                     lane < nr ? s : 0x7fffffff);
    const int mx = __reduce_max_sync(0xffffffffu, s);
    if (lane == 0) {
      mbar_init(&full, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const long long mis = (long long)((uintptr_t)stream & 15);
      long long end = (long long)mx + Wn;
      if (end > rows) end = rows;
      const long long lo = (long long)mn * row_bytes;
      const long long hi = end * row_bytes;
      // widen to 16-byte boundaries of the absolute address
      long long glo = ((lo + mis) & ~15LL) - mis;
      const long long ghi = ((hi + mis + 15) & ~15LL) - mis;
      long long blo = 0, bhi = 0;
      if (ghi - glo <= stage_bytes) {
        // cut to the tensor's 16-byte-aligned interior
        const long long a0 = (16 - mis) & 15;
        const long long a1 = ((rows * row_bytes + mis) & ~15LL) - mis;
        blo = glo > a0 ? glo : a0;
        bhi = ghi < a1 ? ghi : a1;
        if (bhi < blo) bhi = blo;
      } else {
        glo = 0;   // word by word: the bulk region is empty
      }
      span[0] = glo;
      span[1] = blo;
      span[2] = bhi;
      const uint32_t bytes = (uint32_t)(bhi - blo);
      mbar_arrive_tx(&full, bytes);
      if (bytes)
        bulk_copy(smem + (blo - glo),
                  reinterpret_cast<const unsigned char*>(stream) + blo,
                  bytes, &full);
    }
  }
  __syncthreads();   // the barrier's init, the starts and the span
  mbar_wait(&full, 0);

  const long long glo = span[0], blo = span[1], bhi = span[2];
  const int32_t* stage = reinterpret_cast<const int32_t*>(smem);
  const int vrow = (int)(win_words >> 2);     // 16-byte words a window
  for (int r = warp; r < nr; r += WARPS) {
    const int s = bs[r];
    const long long b0 = (long long)s * row_bytes;
    int32_t* dst = out + (h0 + r) * win_words;
    if (vec && s + Wn <= rows && b0 >= blo && b0 + 4 * win_words <= bhi) {
      // the whole window is in the stage: 16-byte stores, the row's
      // 0-3-word misalignment taken up from two aligned 16-byte reads
      const int o = (int)((b0 - glo) >> 2);
      const int4* src = reinterpret_cast<const int4*>(stage + (o & ~3));
      int4* d4 = reinterpret_cast<int4*>(dst);
      switch (o & 3) {
        case 0:
#pragma unroll 4
          for (int q = lane; q < vrow; q += 32) d4[q] = src[q];
          break;
        case 1:
#pragma unroll 4
          for (int q = lane; q < vrow; q += 32) {
            const int4 x = src[q], y = src[q + 1];
            d4[q] = make_int4(x.y, x.z, x.w, y.x);
          }
          break;
        case 2:
#pragma unroll 4
          for (int q = lane; q < vrow; q += 32) {
            const int4 x = src[q], y = src[q + 1];
            d4[q] = make_int4(x.z, x.w, y.x, y.y);
          }
          break;
        default:
#pragma unroll 4
          for (int q = lane; q < vrow; q += 32) {
            const int4 x = src[q], y = src[q + 1];
            d4[q] = make_int4(x.w, y.x, y.y, y.z);
          }
          break;
      }
    } else {
      // word by word: a clamped window, a span past the stage, words the
      // copy left out, or Wn * P not a multiple of 4
      for (int w = lane; w < win_words; w += 32)
        dst[w] = window_word(stream, stage, glo, blo, bhi, s, w, rows, P);
    }
  }
}

// The geometry comes from core/insert_kernels.py gather_geometry.
// Returns a cudaError_t (0 on success); a geometry this kernel cannot
// run is cudaErrorInvalidValue and launches nothing.
extern "C" int mailbox_gather_launch(
    const void* stream, const void* start, void* out, int H,
    long long rows, int Wn, int P, int tile_rows, int stage_bytes,
    int grid, void* cuda_stream) {
  if (H <= 0) return 0;
  if (tile_rows < 1 || tile_rows > MAX_TILE_ROWS || stage_bytes < 16 ||
      stage_bytes % 16 != 0 || stage_bytes > STAGE_MAX ||
      (long long)grid * tile_rows < H ||
      (long long)(grid - 1) * tile_rows >= H || Wn < 1 || P < 1 ||
      rows < Wn)
    return (int)cudaErrorInvalidValue;
  // 16-byte stores need a 16-byte output row stride and base
  const int vec = (long long)Wn * P % 4 == 0 && ((uintptr_t)out & 15) == 0;
  mailbox_gather_kernel<<<grid, THREADS, stage_bytes,
                          (cudaStream_t)cuda_stream>>>(
      (const int32_t*)stream, (const int32_t*)start, (int32_t*)out, H,
      (int64_t)rows, Wn, P, tile_rows, stage_bytes, vec);
  return (int)cudaGetLastError();
}
