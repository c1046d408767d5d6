// bilateral_color_blur — colour-axis blur of the bilateral grid, sm_90a.
//
// Replaces: the blur half of wsss_tpu/ops/crf/mxu_grid.py
// `_combine_blur_kernel_v2` (radius-2 separable blur along cr, cg and cb
// with zero fill; the v2 layout's padded cb slots are never sliced, so
// its blur equals zero fill on [0, gc)).
//
// One launch blurs one colour axis of the canonical grid
// [B, gy, gx, gc, gc, gc, C] (f32, C innermost):
//     out[.., k, ..] = t0*in[k] + t1*(in[k+1] + in[k-1]) + t2*(in[k+2] + in[k-2])
// with taps (t0, t1, t2) and zero outside [0, gc).  The axis is given by
// its element stride: gc*gc*C (cr), gc*C (cg), C (cb).  The wrapper
// launches it three times, ping-ponging between two buffers.
//
// Bound on the H100: bytes.  The function must read the grid once and
// write it once (2 x 223 MB at the VOC batch-8 config); 9 flops per
// element and pass are far below the card's rate.  This design moves the
// grid three times (one read + write per axis): fusing the axes needs a
// node's whole colour cube on chip, and 16^3 * 21 * 4 B = 344 KB exceeds
// a block's 227 KB of shared memory, so that is a later design.
//
// Design: one thread per output element, 5 taps along the axis, with C
// innermost so a warp reads neighbouring addresses for every tap.
// Arithmetic uses explicit round-to-nearest intrinsics (no FMA
// contraction), in the plain version's order, so the result is bit-equal
// to the plain PyTorch version on the card.
#include <cuda_runtime.h>

__global__ void bilateral_color_blur_kernel(
    const float* __restrict__ in, float* __restrict__ out, long long n,
    long long stride, int gc, float t0, float t1, float t2) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int k = (int)((i / stride) % gc);          // coordinate along the axis
  float acc = __fmul_rn(t0, in[i]);
  float up1 = k + 1 < gc ? in[i + stride] : 0.0f;
  float dn1 = k - 1 >= 0 ? in[i - stride] : 0.0f;
  acc = __fadd_rn(acc, __fmul_rn(t1, __fadd_rn(up1, dn1)));
  float up2 = k + 2 < gc ? in[i + 2 * stride] : 0.0f;
  float dn2 = k - 2 >= 0 ? in[i - 2 * stride] : 0.0f;
  acc = __fadd_rn(acc, __fmul_rn(t2, __fadd_rn(up2, dn2)));
  out[i] = acc;
}

extern "C" int bilateral_color_blur(const void* in, void* out, long long n,
                                    long long stride, int gc, float t0,
                                    float t1, float t2, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  bilateral_color_blur_kernel<<<(unsigned int)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, n, stride, gc, t0, t1, t2);
  return (int)cudaGetLastError();
}
