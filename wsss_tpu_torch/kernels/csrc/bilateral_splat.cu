// bilateral_splat — splat of the bilateral-grid filter, for sm_90a.
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py `_splat_kernel_v2` (per-tile
// one-hot-matmul splat partials) and the fold half of
// `_combine_blur_kernel_v2` (summing the 4 neighbouring tiles' corner
// partials into each grid node).
//
// Computes, for every image b, pixel p = (y, x) and channel c:
//     G[b, y/t + by, x/t + bx, cell(p), c] += w_by(y) * w_bx(x) * X[b, p, c]
// with bilinear spatial weights w_0 = 1 - (y mod t)/t, w_1 = (y mod t)/t
// and the pixel's nearest colour cell cell(p) = (cr*gc + cg)*gc + cb.
// The weights come in as a [2, t] table that the plain version's own ops
// computed (on the card PyTorch divides by t as a multiply by 1/t, which
// a division here would not match for t 24, 40, 48); a pixel's value is
// (w_by * w_bx) * x, the plain version's order of multiplies.
// G is the canonical grid [B, gy, gx, gc, gc, gc, C] in f32, C innermost;
// the caller zeroes it.
//
// Bound on the H100: bytes.  It reads X once (B*H*W*C f32) and the grid
// must be written once (B*gy*gx*gc^3*C f32 — 223 MB at the VOC batch-8
// config, dominated by the caller's memset); the 4 multiply-adds per
// element are nothing against 3.35 TB/s.
//
// Design: the TPU kernel builds per-tile one-hot matrices and matmuls
// because the TPU has no fast scatter; Hopper has fast f32 atomics in L2,
// so each thread takes one (pixel, channel) pair and does 4 atomicAdds
// straight into the canonical grid — no partials, no fold pass.  With C
// innermost, the 32 lanes of a warp handle neighbouring channels of one
// or two pixels and hit neighbouring addresses.  Sums land in an order
// that changes from run to run (atomics), so results agree with the
// plain version to f32 rounding, not bit for bit.
#include <cuda_runtime.h>

__global__ void bilateral_splat_kernel(
    const float* __restrict__ x, const int* __restrict__ cell,
    const float* __restrict__ wt, float* __restrict__ grid, int B, int H,
    int W, int C, int t, int gy, int gx, int gc3) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long n = (long long)B * H * W * C;
  if (i >= n) return;
  int c = (int)(i % C);
  long long p = i / C;                       // flat pixel (b, y, x)
  int xx = (int)(p % W);
  long long r = p / W;
  int y = (int)(r % H);
  long long b = r / H;
  float v = x[i];
  int m = cell[p];
  const int iy = y % t, ix = xx % t;
  const float wy0 = wt[iy], fy = wt[t + iy];
  const float wx0 = wt[ix], fx = wt[t + ix];
  long long sx = (long long)gc3 * C;         // one grid node along x
  long long sy = (long long)gx * sx;         // one grid node along y
  float* g = grid + ((b * gy + y / t) * gx + xx / t) * sx
             + (long long)m * C + c;
  atomicAdd(g, __fmul_rn(__fmul_rn(wy0, wx0), v));
  atomicAdd(g + sx, __fmul_rn(__fmul_rn(wy0, fx), v));
  atomicAdd(g + sy, __fmul_rn(__fmul_rn(fy, wx0), v));
  atomicAdd(g + sy + sx, __fmul_rn(__fmul_rn(fy, fx), v));
}

// wt: the [2, t] f32 weight table, w_0 then w_1 of each in-tile offset.
extern "C" int bilateral_splat(const void* x, const void* cell,
                               const void* wt, void* grid, int B, int H,
                               int W, int C, int t, int gy, int gx, int gc3,
                               void* stream) {
  long long n = (long long)B * H * W * C;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  bilateral_splat_kernel<<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)x, (const int*)cell, (const float*)wt, (float*)grid, B,
      H, W, C, t, gy, gx, gc3);
  return (int)cudaGetLastError();
}
