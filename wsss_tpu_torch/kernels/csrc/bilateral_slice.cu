// bilateral_slice — slice of the bilateral-grid filter, for sm_90a.
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py `_slice_kernel` as `_slice_v2`
// calls it (cq=32): per-tile one-hot matmuls against 4 corner slabs, a
// lane mask and a group-sum matmul.
//
// Computes, for every image b, pixel p = (y, x) and channel c:
//     out[b, p, c] = sum_q w_q(p) * G[b, node_q(p), cell(p), c]
// over the 4 spatial corners q = (by, bx) of the pixel's tile, bilinear
// in space and nearest in colour, from the canonical grid
// [B, gy, gx, gc, gc, gc, C] (f32, C innermost).  Output [B, H, W, C] f32
// is the cropped image directly: pad pixels of the TPU layout are never
// computed.
//
// Bound on the H100: bytes.  It reads the grid entries the pixels touch
// (at most 4 nodes x C per pixel, fewer where pixels share a cell),
// the cell map once and writes the output once; 7 flops per element.
//
// Design: the TPU kernel gathers with one-hot matmuls because it has no
// fast gather; here each thread takes one (pixel, channel) pair and reads
// its 4 grid values directly.  With C innermost a warp's reads of one
// corner are contiguous.  Arithmetic uses round-to-nearest intrinsics in
// the plain version's order (no FMA contraction), so the result is
// bit-equal to the plain PyTorch version on the card.
#include <cuda_runtime.h>

__global__ void bilateral_slice_kernel(
    const float* __restrict__ grid, const int* __restrict__ cell,
    float* __restrict__ out, int B, int H, int W, int C, int t, int gy,
    int gx, int gc3) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long n = (long long)B * H * W * C;
  if (i >= n) return;
  int c = (int)(i % C);
  long long p = i / C;
  int xx = (int)(p % W);
  long long r = p / W;
  int y = (int)(r % H);
  long long b = r / H;
  int m = cell[p];
  float fy = (float)(y % t) / (float)t;
  float fx = (float)(xx % t) / (float)t;
  float wy0 = 1.0f - fy, wx0 = 1.0f - fx;
  long long sx = (long long)gc3 * C;
  long long sy = (long long)gx * sx;
  const float* g = grid + ((b * gy + y / t) * gx + xx / t) * sx
                   + (long long)m * C + c;
  float acc = __fmul_rn(__fmul_rn(wy0, wx0), g[0]);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wy0, fx), g[sx]));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(fy, wx0), g[sy]));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(fy, fx), g[sy + sx]));
  out[i] = acc;
}

extern "C" int bilateral_slice(const void* grid, const void* cell, void* out,
                               int B, int H, int W, int C, int t, int gy,
                               int gx, int gc3, void* stream) {
  long long n = (long long)B * H * W * C;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  bilateral_slice_kernel<<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)grid, (const int*)cell, (float*)out, B, H, W, C, t, gy,
      gx, gc3);
  return (int)cudaGetLastError();
}
