// flat_color_blur — colour-axis blur of the scatter bilateral grid, sm_90a.
//
// Replaces: wsss_tpu/ops/crf/pallas_blur.py `color_blur_fused` (:47, the
// three colour-axis convolutions of one spatial cell's flat
// (gr, gg, gb, C) stripe) and the kernel of `blur_color_axes` (:84, the
// (gg, gb) convolutions of one per-gr stripe).  Both are chains of the
// same pass, which is what one launch of this kernel computes.
//
// One launch applies one pass to x [n_stripes, L] f32:
//     out[s, f] = sum_j taps[j] * x[s, f + (j - r) * stride],  r = (n - 1)/2
// with zero outside [0, L) of the stripe.  A colour axis is embedded in
// the flat stripe, so a shift by `stride` elements is a step along that
// axis; at a row's end the shift runs on into the next row (there is no
// per-row zero fill), exactly as the plain version `_flat_conv_last`
// does: the scatter grid keeps two margin cells per colour axis for that
// bleed.  The wrapper launches one pass per axis, ping-ponging between
// two buffers: stripes of F = gr*gg*gb*C with three passes (the fused
// form), or stripes of F/gr with two passes and a third launch on
// stripes of F (the split form).
//
// Bound on the H100: bytes.  The function must read the grid once and
// write it once (2 x 1.19 GB for the IRNet label CRF's grid of
// 9 x 9 x 56^3 cells at 21 channels); 9 flops per element and pass are
// far below the card's rate.  This design moves the grid once per pass,
// three times in all; keeping a stripe on chip across the passes is a
// later design (a 3.7 M-element stripe exceeds a block's shared memory,
// so it has to be cut along gr with halos).
//
// Design: the TPU kernel holds a whole stripe in VMEM and shifts it with
// static slices of a zero-padded copy.  Here one thread takes one output
// element and reads its taps straight from device memory; neighbouring
// threads read neighbouring addresses for every tap, and the taps of one
// element are at most 2r strides apart, so most re-reads hit L2.  The
// stripe is the launch grid's y dimension, so no thread divides to find
// its place in the stripe, and the 5-tap case (every grid of the CRF) is
// unrolled.  The products and sums use round-to-nearest intrinsics in
// the plain version's order (tap 0 first, no FMA contraction), so the
// result is bit-equal to the plain PyTorch version on the card.
#include <cuda_runtime.h>

#define FLAT_BLUR_MAX_TAPS 17

struct FlatBlurTaps {
  float v[FLAT_BLUR_MAX_TAPS];
};

// N_TAPS > 0: the tap count at compile time; 0: n_taps at run time.
template <int N_TAPS>
__global__ void flat_color_blur_kernel(
    const float* __restrict__ in, float* __restrict__ out,
    long long n_stripes, long long L, long long stride, int n_taps,
    FlatBlurTaps taps) {
  long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= L) return;                        // position inside the stripe
  const int n = N_TAPS > 0 ? N_TAPS : n_taps;
  const int r = (n - 1) / 2;
  for (long long s = blockIdx.y; s < n_stripes; s += gridDim.y) {
    const float* x = in + s * L + f;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      long long off = (long long)(j - r) * stride;
      long long g = f + off;
      float v = (g >= 0 && g < L) ? x[off] : 0.0f;
      float term = __fmul_rn(taps.v[j], v);
      acc = j == 0 ? term : __fadd_rn(acc, term);
    }
    out[s * L + f] = acc;
  }
}

extern "C" int flat_color_blur(const void* in, void* out,
                               long long n_stripes, long long L,
                               long long stride, const float* taps,
                               int n_taps, void* stream) {
  if (n_taps < 1 || n_taps > FLAT_BLUR_MAX_TAPS || n_taps % 2 == 0)
    return (int)cudaErrorInvalidValue;
  if (n_stripes == 0 || L == 0) return 0;
  FlatBlurTaps t;
  for (int j = 0; j < n_taps; ++j) t.v[j] = taps[j];
  const int threads = 256;
  long long bx = (L + threads - 1) / threads;
  if (bx > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned int)bx,
            (unsigned int)(n_stripes < 65535 ? n_stripes : 65535));
  if (n_taps == 5) {
    flat_color_blur_kernel<5><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)in, (float*)out, n_stripes, L, stride, n_taps, t);
  } else {
    flat_color_blur_kernel<0><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)in, (float*)out, n_stripes, L, stride, n_taps, t);
  }
  return (int)cudaGetLastError();
}
