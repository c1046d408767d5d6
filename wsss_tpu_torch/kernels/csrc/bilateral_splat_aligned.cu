// bilateral_splat_aligned — splat of the aligned bilateral grid, sm_90a.
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py `_splat_aligned_kernel` (:1167,
// called at :1344): per tile row, one-hot matmuls that add every pixel
// into the colour cell of its own tile.
//
// Computes, for every image b, pixel p = (y, x) and channel c:
//     G[b, y / t, x / t, cell(p), c] += X[b, p, c]
// Cells of the aligned grid are centred on the t x t pixel tiles, so the
// nearest spatial cell of a pixel is the tile that contains it: no corner
// weights and no fold pass.  cell(p) = (cr*gc + cg)*gc + cb is the
// pixel's nearest colour cell.  G is the canonical grid
// [B, nty, ntx, gc, gc, gc, C] in f32, C innermost; the caller zeroes it.
//
// Bound on the H100: bytes.  X and the cell map are read once and the
// grid is written once (795 MB at batch 8, 17 x 17 tiles, gc 16, C 21,
// almost all of it the caller's memset); one add per element is nothing
// against 3.35 TB/s.
//
// Design: the TPU kernel blocks over tile rows and column groups, pads
// the tile to a multiple of 16 pixels and packs four colour planes into
// the matmul's N dimension, all to feed its matrix unit; none of that
// carries over.  Hopper has fast f32 atomics in L2, so each thread takes
// one (pixel, channel) pair and does one atomicAdd into the canonical
// grid.  With C innermost the lanes of a warp hit neighbouring addresses.
// An image row is the launch grid's y dimension, so the index arithmetic
// of a thread is 32-bit.
// The adds of a cell land in an order that changes from run to run, so
// the result agrees with the plain version to f32 rounding, not bit for
// bit.
#include <cuda_runtime.h>

__global__ void bilateral_splat_aligned_kernel(
    const float* __restrict__ x, const int* __restrict__ cell,
    float* __restrict__ grid, int B, int H, int W, int C, int t, int nty,
    int ntx, int gc3) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;   // (x, c) of one row
  if (e >= W * C) return;
  int xx = e / C, c = e - xx * C;
  for (int row = blockIdx.y; row < B * H; row += gridDim.y) {
    int b = row / H, y = row - b * H;
    long long p = (long long)row * W + xx;            // flat pixel
    long long tile = ((long long)b * nty + y / t) * ntx + xx / t;
    atomicAdd(grid + (tile * gc3 + cell[p]) * C + c, x[p * C + c]);
  }
}

extern "C" int bilateral_splat_aligned(const void* x, const void* cell,
                                       void* grid, int B, int H, int W,
                                       int C, int t, int nty, int ntx,
                                       int gc3, void* stream) {
  if ((long long)B * H * W * C == 0) return 0;
  if ((long long)W * C > 2147483647LL || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const int threads = 256;
  dim3 blocks((unsigned int)((W * C + threads - 1) / threads),
              (unsigned int)(B * H < 65535 ? B * H : 65535));
  bilateral_splat_aligned_kernel<<<blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      (const float*)x, (const int*)cell, (float*)grid, B, H, W, C, t, nty,
      ntx, gc3);
  return (int)cudaGetLastError();
}
