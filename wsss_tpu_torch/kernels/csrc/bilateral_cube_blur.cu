// bilateral_cube_blur — one-pass colour blur of the bilateral grid, for
// sm_90a (the v1 route's unfused path).
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py:515 `_color_blur_kernel` (radius-2
// separable blur over the three colour axes of one node's [gc, gc, gc*C]
// cube, the whole cube in VMEM).
//
// Computes, on the canonical grid [B, gy, gx, gc, gc, gc, C] (f32, C
// innermost), along cr, then cg, then cb of every node's cube:
//     out[k] = t0*in[k] + t1*(in[k+1] + in[k-1]) + t2*(in[k+2] + in[k-2])
// with zero outside [0, gc) — the function of `bilateral_color_blur`, in
// one launch.
//
// Bound on the H100: bytes.  The grid is read once and written once
// (2 x 223 MB at B 8, 9x9 nodes, gc 16, C 21); 27 flops per element.
//
// Design (cube_blur.cuh): the blur is independent per channel, so a block
// owns one node and a few channels and keeps those channels' cube in
// shared memory (16 KB a channel at gc 16, two buffers); the three axes
// are blurred there and the grid moves once, where `bilateral_color_blur`
// moves it three times.  The wrapper picks the channels per block and,
// for a cube that no block can hold (gc 52: 562 KB for one channel), how
// many cr-planes a block takes (halo planes are then re-read).  With C
// innermost a block of few channels reads C-strided words: each 32-byte
// sector is fetched by several blocks and held by L2 in between.
// Bit-equal to the plain version.
#include "cube_blur.cuh"

struct GridLoad {
  const float* node;
  __device__ __forceinline__ float operator()(long long e) const {
    return node[e];
  }
};

__global__ void bilateral_cube_blur_kernel(
    const float* __restrict__ in, float* __restrict__ out, int gc, int C,
    int nc, int planes, float t0, float t1, float t2) {
  long long cube = (long long)gc * gc * gc * C;
  CubeBlock blk(gc, C, nc, planes);
  GridLoad load{in + blk.node * cube};
  cube_blur_block(load, out + blk.node * cube, blk, gc, C, t0, t1, t2);
}

extern "C" int bilateral_cube_blur(const void* in, void* out, long long nodes,
                                   int gc, int C, int nc, int planes,
                                   float t0, float t1, float t2,
                                   void* stream) {
  if (nodes == 0 || C == 0) return 0;
  size_t smem = cube_blur_smem(gc, nc, planes);
  cudaError_t err = cudaFuncSetAttribute(
      bilateral_cube_blur_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  unsigned int blocks = cube_blur_blocks(nodes, gc, C, nc, planes);
  if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
  bilateral_cube_blur_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, gc, C, nc, planes, t0, t1, t2);
  return (int)cudaGetLastError();
}
