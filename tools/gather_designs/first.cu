// mailbox_gather, the port's first design of this kernel: measured,
// not used by the port. tools/torch_gather_ab.py builds it
// beside the port's kernel (shadow_tpu_torch/csrc/mailbox_gather.cu)
// and times the two on the same inputs.
//
// Replaces the Pallas TPU kernel shadow_tpu/core/insert_pallas.py
// (mailbox_gather, pl.pallas_call at :118), which issued one
// HBM->VMEM DMA per destination row with 16 in flight.
//
//   out[h, j, :] = stream[min(start[h] + j, rows - 1), :]
//   for h < H, j < Wn
//
// stream [rows, P] int32 (rows = n + Wn: the sorted stream padded with
// Wn zero rows), start [H] int32 (exclusive cumsum of per-row arrival
// counts, start[h] <= n), out [H, Wn, P] int32. The clamp never binds
// under that contract; it keeps the kernel equal to its plain PyTorch
// version (core/insert_kernels.py mailbox_gather_ref) even off it.
//
// Bound: device memory. Each row's window is Wn*P consecutive int32
// words (352 at the main path's Wn = 32, P = 11), so a block copies it
// with coalesced 4-byte loads and stores; start[h]*P breaks 16-byte
// alignment, so no vector width is assumed. At the main path (H =
// 10,240) the windows are about 2 x 10,240 x 32 x 11 x 4 B = 28.8 MB of
// reads plus writes per launch, about 8.6 us at 3.35 TB/s (reads of
// overlapping windows mostly hit L2, so the distinct bytes are fewer).
// Design, first version: one block of 128 threads handles
// ROWS_PER_BLOCK destination rows, one row after another; the window
// goes through device memory. Fusing the select sweep (so the window
// is placed into the queue's free slots without a round trip) and TMA
// bulk copies are left to a later performance change.

#include <cuda_runtime.h>
#include <stdint.h>

#define ROWS_PER_BLOCK 4
#define THREADS 128

__global__ void __launch_bounds__(THREADS)
first_gather_kernel(const int32_t* __restrict__ stream,
                      const int32_t* __restrict__ start,
                      int32_t* __restrict__ out,
                      int H, int64_t rows, int Wn, int P) {
  const int64_t win = (int64_t)Wn * P;
  for (int r = 0; r < ROWS_PER_BLOCK; ++r) {
    const int64_t h = (int64_t)blockIdx.x * ROWS_PER_BLOCK + r;
    if (h >= H) return;
    int64_t s = start[h];
    if (s < 0) s = 0;
    int32_t* dst = out + h * win;
    if (s + Wn <= rows) {
      // whole window in bounds: one contiguous copy
      const int32_t* src = stream + s * P;
      for (int64_t i = threadIdx.x; i < win; i += THREADS) dst[i] = src[i];
    } else {
      for (int64_t i = threadIdx.x; i < win; i += THREADS) {
        int64_t j = i / P;
        int64_t c = i - j * P;
        int64_t row = s + j;
        if (row > rows - 1) row = rows - 1;
        dst[i] = stream[row * P + c];
      }
    }
  }
}

extern "C" int first_gather_launch(const void* stream, const void* start,
                                     void* out, int H, long long rows,
                                     int Wn, int P, void* cuda_stream) {
  if (H <= 0) return 0;
  const unsigned blocks = (unsigned)((H + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  first_gather_kernel<<<blocks, THREADS, 0, (cudaStream_t)cuda_stream>>>(
      (const int32_t*)stream, (const int32_t*)start, (int32_t*)out, H,
      (int64_t)rows, Wn, P);
  return (int)cudaGetLastError();
}
