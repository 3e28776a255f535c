// mailbox_gather as a register-only gather: measured, not used by the
// port. tools/torch_gather_ab.py builds it beside the port's kernel
// (shadow_tpu_torch/csrc/mailbox_gather.cu) and times the two on the
// same inputs.
//
//   out[h, j, :] = stream[min(max(start[h], 0) + j, rows - 1), :]
//   for h < H, j < Wn
//
// One warp a destination row, 8 rows a block of 256 threads, a grid of
// ceil(H / 8) blocks. A window that lies inside the tensor's 16-byte
// aligned interior is copied with two aligned 16-byte loads per
// 16-byte store, in registers, with no shared memory and no barrier;
// every other window (clamped, at the tensor's ends, or Wn * P not a
// multiple of 4) word by word. So it reads each window from device
// memory (consecutive windows overlap ~4x on the main path; L2 takes
// the repeats) where the port's kernel reads a tile's span once.

#include <cuda_runtime.h>
#include <stdint.h>

#define ROWS_PER_BLOCK 8

__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
register_gather_kernel(const int32_t* __restrict__ stream,
                       const int32_t* __restrict__ start,
                       int32_t* __restrict__ out, int H, int64_t rows,
                       int Wn, int P, int vec) {
  const int64_t h = (int64_t)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (h >= H) return;
  long long s = start[h];
  if (s < 0) s = 0;
  if (s > rows - 1) s = rows - 1;
  const long long win_words = (long long)Wn * P;
  int32_t* dst = out + h * win_words;
  // words from the 16-byte boundary at or below data_ptr
  const long long mis = (long long)(((uintptr_t)stream & 15) >> 2);
  const long long w0 = s * P + mis;
  const long long a_end = ((rows * P + mis) & ~3LL);  // aligned interior end
  const long long need_end = ((w0 + win_words + 3) & ~3LL);
  if (vec && s + Wn <= rows && (w0 & ~3LL) >= (mis ? 4 : 0) &&
      need_end <= a_end) {
    const int4* src = reinterpret_cast<const int4*>(stream - mis) + (w0 >> 2);
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int vrow = (int)(win_words >> 2);
    switch (w0 & 3) {
      case 0:
        for (int q = lane; q < vrow; q += 32) d4[q] = __ldg(src + q);
        break;
      case 1:
        for (int q = lane; q < vrow; q += 32) {
          const int4 x = __ldg(src + q), y = __ldg(src + q + 1);
          d4[q] = make_int4(x.y, x.z, x.w, y.x);
        }
        break;
      case 2:
        for (int q = lane; q < vrow; q += 32) {
          const int4 x = __ldg(src + q), y = __ldg(src + q + 1);
          d4[q] = make_int4(x.z, x.w, y.x, y.y);
        }
        break;
      default:
        for (int q = lane; q < vrow; q += 32) {
          const int4 x = __ldg(src + q), y = __ldg(src + q + 1);
          d4[q] = make_int4(x.w, y.x, y.y, y.z);
        }
        break;
    }
    return;
  }
  for (int w = lane; w < win_words; w += 32) {
    const int j = w / P;
    long long row = s + j;
    if (row > rows - 1) row = rows - 1;
    dst[w] = __ldg(stream + row * P + (w - j * P));
  }
}

extern "C" int register_gather_launch(const void* stream, const void* start,
                                      void* out, int H, long long rows,
                                      int Wn, int P, void* cuda_stream) {
  if (H <= 0) return 0;
  const int vec = (long long)Wn * P % 4 == 0 && ((uintptr_t)out & 15) == 0;
  const int grid = (H + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  register_gather_kernel<<<grid, 32 * ROWS_PER_BLOCK, 0,
                           (cudaStream_t)cuda_stream>>>(
      (const int32_t*)stream, (const int32_t*)start, (int32_t*)out, H,
      (int64_t)rows, Wn, P, vec);
  return (int)cudaGetLastError();
}
