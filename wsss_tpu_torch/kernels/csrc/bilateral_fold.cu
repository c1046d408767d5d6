// bilateral_fold — fold of the per-tile splat partials into the grid, for
// sm_90a (the v1 route's unfused path).
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py:414 `_combine_kernel` (fold the
// corner groups of the 4 neighbouring tiles' partials into one grid node,
// no blur).
//
// Computes, for every image b, node (sy, sx), colour cell m and channel c:
//     G[b, sy, sx, m, c] = P[b, sy-1, sx-1, 3, m, c] + P[b, sy-1, sx, 2, m, c]
//                        + P[b, sy, sx-1, 1, m, c] + P[b, sy, sx, 0, m, c]
// added in that order (the reference's: p11, p10, p01, p00), a tile
// outside [0, nty) x [0, ntx) skipped.  P is [B, nty, ntx, 4, gc^3, C] f32,
// G the canonical grid [B, nty+1, ntx+1, gc^3, C] f32.
//
// Bound on the H100: bytes.  Every partial is read once and every grid
// element written once (704 MB + 223 MB at B 8, 8x8 tiles, gc 16, C 21);
// 3 adds per element.
//
// Design: one thread per grid element; its four reads are at one offset
// (m, c) of four partial cubes, so a warp reads and writes neighbouring
// addresses.  The adds are round-to-nearest in the plain version's order,
// so the result equals the plain version bit for bit.
#include <cuda_runtime.h>

__global__ void bilateral_fold_kernel(
    const float* __restrict__ part, float* __restrict__ grid, long long n,
    int gy, int gx, long long cube) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long e = i % cube;                    // (m, c) inside the node
  long long node = i / cube;
  int sx = (int)(node % gx);
  long long r = node / gx;
  int sy = (int)(r % gy);
  long long b = r / gy;
  int nty = gy - 1, ntx = gx - 1;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {              // p11, p10, p01, p00
    int ty = sy - 1 + (k >> 1), tx = sx - 1 + (k & 1);
    if (ty < 0 || ty >= nty || tx < 0 || tx >= ntx) continue;
    long long src = ((b * nty + ty) * ntx + tx) * 4 + (3 - k);
    acc = __fadd_rn(acc, part[src * cube + e]);
  }
  grid[i] = acc;
}

extern "C" int bilateral_fold(const void* part, void* grid, long long n,
                              int gy, int gx, long long cube, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  bilateral_fold_kernel<<<(unsigned int)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)part, (float*)grid, n, gy, gx, cube);
  return (int)cudaGetLastError();
}
