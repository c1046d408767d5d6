// bilateral_fold_blur — fold of the per-tile splat partials fused with the
// colour blur, for sm_90a (the v1 route's fused path).
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py:537 `_combine_blur_kernel` (fold
// the 4 neighbouring tiles' corner partials into one node's cube in VMEM,
// then blur it along cr, cg and cb; cb masked at the cg boundaries).
//
// Computes, for every image b and node (sy, sx), the cube
//     F[m, c] = P[b, sy-1, sx-1, 3, m, c] + P[b, sy-1, sx, 2, m, c]
//             + P[b, sy, sx-1, 1, m, c] + P[b, sy, sx, 0, m, c]
// (that order, tiles outside the image skipped: `bilateral_fold`), and
// then its radius-2 blur along cr, cg, cb with zero fill
// (`bilateral_cube_blur`).  P is [B, nty, ntx, 4, gc^3, C] f32, the result
// the canonical grid [B, nty+1, ntx+1, gc, gc, gc, C] f32.
//
// Bound on the H100: bytes.  The partials are read once and the grid is
// written once (704 MB + 223 MB at B 8, 8x8 tiles, gc 16, C 21): the folded
// cube never reaches device memory.
//
// Design (cube_blur.cuh): a block owns one node and a few channels, folds
// those channels' cube into shared memory and blurs the three axes there.
// The wrapper picks the channels per block and cuts a cube that no block
// can hold along cr.  With C innermost a block of few channels reads
// C-strided words of the four partial cubes.  Adds and blur are
// round-to-nearest in the plain version's order: bit-equal to it.
#include "cube_blur.cuh"

struct FoldLoad {
  const float* p[4];                         // p11, p10, p01, p00 or null
  __device__ __forceinline__ float operator()(long long e) const {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (p[k]) acc = __fadd_rn(acc, p[k][e]);
    return acc;
  }
};

__global__ void bilateral_fold_blur_kernel(
    const float* __restrict__ part, float* __restrict__ out, int gy, int gx,
    int gc, int C, int nc, int planes, float t0, float t1, float t2) {
  long long cube = (long long)gc * gc * gc * C;
  CubeBlock blk(gc, C, nc, planes);
  long long node = blk.node;                 // (b * gy + sy) * gx + sx
  int sx = (int)(node % gx);
  long long r = node / gx;
  int sy = (int)(r % gy);
  long long b = r / gy;
  int nty = gy - 1, ntx = gx - 1;
  FoldLoad load;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int ty = sy - 1 + (k >> 1), tx = sx - 1 + (k & 1);
    bool ok = ty >= 0 && ty < nty && tx >= 0 && tx < ntx;
    load.p[k] = ok ? part + (((b * nty + ty) * ntx + tx) * 4 + (3 - k)) * cube
                   : nullptr;
  }
  cube_blur_block(load, out + node * cube, blk, gc, C, t0, t1, t2);
}

extern "C" int bilateral_fold_blur(const void* part, void* out, int B, int gy,
                                   int gx, int gc, int C, int nc, int planes,
                                   float t0, float t1, float t2,
                                   void* stream) {
  long long nodes = (long long)B * gy * gx;
  if (nodes == 0 || C == 0) return 0;
  size_t smem = cube_blur_smem(gc, nc, planes);
  cudaError_t err = cudaFuncSetAttribute(
      bilateral_fold_blur_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  unsigned int blocks = cube_blur_blocks(nodes, gc, C, nc, planes);
  if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
  bilateral_fold_blur_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
      (const float*)part, (float*)out, gy, gx, gc, C, nc, planes, t0, t1,
      t2);
  return (int)cudaGetLastError();
}
