// bilateral_slice_aligned — slice of the aligned bilateral grid, sm_90a.
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py `_slice_aligned_kernel` (:1203,
// called at :1411): per tile row, a one-hot matmul against the tile's own
// cell slab, a lane mask and a group-sum matmul.
//
// Computes, for every image b, pixel p = (y, x) and channel c:
//     out[b, p, c] = G[b, y / t, x / t, cell(p), c]
// a pure gather from the canonical grid [B, nty, ntx, gc, gc, gc, C]
// (f32, C innermost) at the pixel's own tile and nearest colour cell
// cell(p) = (cr*gc + cg)*gc + cb.  Output [B, H, W, C] f32 is the cropped
// image directly: pad pixels of the TPU layout are never computed.
//
// Bound on the H100: bytes.  It reads the grid entries the pixels touch
// (at most C per pixel, fewer where pixels of a tile share a cell), the
// cell map once and writes the output once; no arithmetic.
//
// Design: the TPU kernel gathers with one-hot matmuls because it has no
// fast gather; here each thread takes one (pixel, channel) pair and
// copies its grid value.  With C innermost a warp reads and writes
// contiguous runs.  An image row is the launch grid's y dimension, so
// the index arithmetic of a thread is 32-bit.  A copy has no rounding, so the result is bit-equal
// to the plain version.
#include <cuda_runtime.h>

__global__ void bilateral_slice_aligned_kernel(
    const float* __restrict__ grid, const int* __restrict__ cell,
    float* __restrict__ out, int B, int H, int W, int C, int t, int nty,
    int ntx, int gc3) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;   // (x, c) of one row
  if (e >= W * C) return;
  int xx = e / C, c = e - xx * C;
  for (int row = blockIdx.y; row < B * H; row += gridDim.y) {
    int b = row / H, y = row - b * H;
    long long p = (long long)row * W + xx;            // flat pixel
    long long tile = ((long long)b * nty + y / t) * ntx + xx / t;
    out[p * C + c] = grid[(tile * gc3 + cell[p]) * C + c];
  }
}

extern "C" int bilateral_slice_aligned(const void* grid, const void* cell,
                                       void* out, int B, int H, int W,
                                       int C, int t, int nty, int ntx,
                                       int gc3, void* stream) {
  if ((long long)B * H * W * C == 0) return 0;
  if ((long long)W * C > 2147483647LL || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const int threads = 256;
  dim3 blocks((unsigned int)((W * C + threads - 1) / threads),
              (unsigned int)(B * H < 65535 ? B * H : 65535));
  bilateral_slice_aligned_kernel<<<blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      (const float*)grid, (const int*)cell, (float*)out, B, H, W, C, t,
      nty, ntx, gc3);
  return (int)cudaGetLastError();
}
