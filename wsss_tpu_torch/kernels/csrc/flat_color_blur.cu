// flat_color_blur — colour-axis blur of the scatter bilateral grid, sm_90a.
//
// Replaces: wsss_tpu/ops/crf/pallas_blur.py `color_blur_fused` (:47, the
// three colour-axis convolutions of one spatial cell's flat
// (gr, gg, gb, C) stripe) and the kernel of `blur_color_axes` (:84, the
// (gg, gb) convolutions of one per-gr stripe).  Both are chains of the
// same pass, and one launch of this kernel computes a chain of 1-3.
//
// Applies passes p = 0, 1, ... to x [n_stripes, L] f32:
//     y_p[s, f] = sum_j taps_p[j] * y_{p-1}[s, f + (j - r_p) * stride_p]
// with zero outside [0, L) of the stripe at every pass.  A colour axis is
// embedded in the flat stripe, so a shift by `stride` elements is a step
// along that axis; at a row's end the shift runs on into the next row
// (there is no per-row zero fill), exactly as the plain version
// `_flat_conv_last` does: the scatter grid keeps two margin cells per
// colour axis for that bleed.
//
// Bound on the H100: bytes.  The function must read the grid once and
// write it once (2 x 1.19 GB for the IRNet label CRF's grid of
// 9 x 9 x 56^3 cells at 21 channels); 9 flops per element and pass are
// far below the card's rate.
//
// Design: a stripe is too large for a block (14.75 MB at the IRN grid),
// so a block owns a window [a, a + lc) of positions inside pass 0's
// stride S and walks the stripe along S: step k covers k*S + [a, a + lc).
// Pass 0 shifts by whole steps, so its taps are the same window of steps
// k - r0 .. k + r0, held in a ring of 2*r0 + 1 + F slots with F steps in
// flight (16-byte cp.async, ring_copy.cuh).  Passes 1 and 2 shift inside
// the window, so step k's pass-0 window reaches halo[0] = r1*s1 + r2*s2
// beyond [a, a + lc) on each side and pass 1's halo[1] = r2*s2.  Pass 0
// writes its window in place over the input window of step k - r0, which
// no later step reads.  Where S (and s1) are multiples of 4, every window
// of a step sits at the same 16-byte offset and passes 0 (and 1) run on
// float4s of shared memory.  The last pass (stride C) runs on walkers: a
// thread takes 12 outputs C apart and slides its taps along them, so it
// reads each element of pass 1's window about once; a warp's stores cover
// runs of C consecutive floats.  Every index is flat, so the bleed across
// rows holds by construction.  Device memory is read about once: the
// halos re-read neighbouring windows, whose blocks run at the same time,
// so those reads meet in L2.  Blocks are persistent and their ring runs
// on from one window to the next.  The wrapper's planner
// (kernels/bilateral.py: flat_blur_plan) sets the window, the ring and
// the buffers.
//
// What this leaves on the table: a ring slot holds the window and both
// halos, so shared memory caps the window (4116 positions against halos
// of 2394 at the IRN grid) and pass 0 runs on 2.2x the positions it
// owns; neighbouring blocks compute the same halos.  A cluster of blocks
// that trade pass 0's halos through distributed shared memory is the
// next design.
//
// The products and sums use round-to-nearest intrinsics in the plain
// version's order (tap 0 first, no FMA contraction), so the result is
// bit-equal to the plain PyTorch version on the card.
#include "ring_copy.cuh"

#define FLAT_BLUR_MAX_TAPS 17
#define FLAT_BLUR_MAX_PASSES 3

struct FlatChain {
  float taps[FLAT_BLUR_MAX_PASSES][FLAT_BLUR_MAX_TAPS];
  long long stride[FLAT_BLUR_MAX_PASSES];
  int n[FLAT_BLUR_MAX_PASSES];
  int halo[FLAT_BLUR_MAX_PASSES];     // reach of pass p's window past [a, a+lc)
  int passes;
};

__device__ __forceinline__ float4 mul4(float t, float4 x) {
  return make_float4(__fmul_rn(t, x.x), __fmul_rn(t, x.y), __fmul_rn(t, x.z),
                     __fmul_rn(t, x.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// v with the lanes whose flat position f0 + q lies outside [0, L) zeroed
__device__ __forceinline__ float4 mask4(float4 v, long long f0, long long L) {
  if (f0 >= 0 && f0 + 3 < L) return v;
  v.x = f0 >= 0 && f0 < L ? v.x : 0.0f;
  v.y = f0 + 1 >= 0 && f0 + 1 < L ? v.y : 0.0f;
  v.z = f0 + 2 >= 0 && f0 + 2 < L ? v.z : 0.0f;
  v.w = f0 + 3 >= 0 && f0 + 3 < L ? v.w : 0.0f;
  return v;
}

template <int F, int MAXT>
__global__ void __launch_bounds__(512, 1) flat_color_blur_kernel(
    const float* __restrict__ in, float* __restrict__ out, long long L,
    const __grid_constant__ FlatChain ch, int Lc, int nwin, long long nk,
    long long units, int slot, int buf0, int tile, int buf_y0) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int toff[MAXT];
  const int r0 = (ch.n[0] - 1) / 2;
  const long long S = ch.stride[0];
  // the walk: along S with a ring of the 2*r0 + 1 steps pass 0 reads; or,
  // for a tile, one step over [0, L) whose window carries pass 0's reach
  // r0*S besides (tile mode, for strides too short to walk along)
  const int taps_ring = tile ? 1 : 2 * r0 + 1;
  const int R = taps_ring + F;
  const long long walk = tile ? L : S;
  const int h0 = tile ? r0 * (int)S : 0;
  const int E0 = ch.halo[0], E1 = ch.halo[1];
  const int s1 = (int)ch.stride[1], s2 = (int)ch.stride[2];
  // with S a multiple of 4 every tap of pass 0 reads at the same 16-byte
  // offset: pass 0 (and pass 1 where s1 is a multiple of 4) run on float4s
  const bool vec0 = S % 4 == 0, vec1 = vec0 && s1 % 4 == 0;
  float* ring = smem;
  float* y1 = smem + buf0;     // pass 1's window (passes == 3)
  const long long nb = gridDim.x;
  const long long nq = (units - blockIdx.x + nb - 1) / nb;
  const long long per = nk + taps_ring - 1;  // input windows a unit streams

  auto unit = [&](long long q, long long& s, int& a, int& lc) {
    const long long u = blockIdx.x + q * nb;
    s = u / nwin;
    a = (int)(u - s * nwin) * Lc;
    lc = (int)min((long long)Lc, walk - a);
  };
  // the next input window to copy: step ij - (taps_ring - 1) / 2 of unit
  // iq, into ring slot is
  long long iq = 0, ij = 0, is_s;
  int is = 0, ia, ilc;
  unit(0, is_s, ia, ilc);
  auto issue_next = [&]() {
    if (iq < nq) {
      copy_window(ring + is * slot, in,
                  is_s * L + (ij - (taps_ring - 1) / 2) * walk + ia - E0 - h0,
                  ilc + 2 * (E0 + h0), is_s * L, is_s * L + L);
      if (++ij == per) {
        ij = 0;
        if (++iq < nq) unit(iq, is_s, ia, ilc);
      }
    }
    ring_commit();
    is = is + 1 == R ? 0 : is + 1;
  };

  long long issued = 0;
  int ps = 0;                                // ring slot of step k - r0
  for (long long q = 0; q < nq; ++q) {
    long long s;
    int a, lc;
    unit(q, s, a, lc);
    for (long long k = 0; k < nk; ++k, ps = ps + 1 == R ? 0 : ps + 1) {
      const long long pos = q * per + k;
      __syncthreads();                       // the ring slot to refill is read
      for (; issued <= pos + taps_ring - 1 + F; ++issued) issue_next();
      ring_wait<F>();
      if (threadIdx.x < ch.n[0]) {
        // pass 0's tap j: the window of step k + j - r0, or this step's
        // window j*S further on
        const int j = threadIdx.x;
        toff[j] = tile ? ps * slot + window_offset(in, s * L + a - E0 - h0) +
                             j * (int)S
                       : (ps + j < R ? ps + j : ps + j - R) * slot +
                             window_offset(in, s * L + (k + j - r0) * S + a -
                                                   E0);
      }
      __syncthreads();
      int off0[MAXT];
#pragma unroll
      for (int j = 0; j < MAXT; ++j) off0[j] = j < ch.n[0] ? toff[j] : 0;
      // on the walk pass 0 writes its window in place over the input
      // window of step k - r0 (tap 0: no other thread reads an element a
      // thread writes, and the slot is refilled only after the next step's
      // first sync); the windows of passes 0 and 1 sit at the offset of
      // the input window
      float* y0 = tile ? smem + buf_y0 : ring + ps * slot;
      const int sh = (off0[0] - ps * slot) & 3;
      const long long fk = k * S + a;        // the window's first position
      float* o = out + s * L + fk;
      const int n_out = (int)max(0LL, min((long long)lc, L - fk));

      auto p0 = [&](int i) {                 // pass 0 at window index i
        float acc = __fmul_rn(ch.taps[0][0], ring[off0[0] + i]);
#pragma unroll
        for (int j = 1; j < MAXT; ++j)
          if (j < ch.n[0])
            acc = __fadd_rn(acc, __fmul_rn(ch.taps[0][j], ring[off0[j] + i]));
        return acc;
      };
      // pass p >= 1 at window index i: its window starts r_p * s_p after
      // the previous pass's, so tap j reads index i + j * s_p there
      auto pk = [&](int p, const float* __restrict__ src, int st, int i) {
        const float* b = src + sh + i;
        float acc = __fmul_rn(ch.taps[p][0], b[0]);
#pragma unroll
        for (int j = 1; j < MAXT; ++j)
          if (j < ch.n[p]) acc = __fadd_rn(acc, __fmul_rn(ch.taps[p][j], b[j * st]));
        return acc;
      };

      if (ch.passes == 1) {
        for (int i = threadIdx.x; i < n_out; i += blockDim.x) o[i] = p0(i);
        continue;
      }
      // pass 0: ring -> y0 over [fk - E0, fk + lc + E0)
      const int n0 = lc + 2 * E0;
      if (vec0) {
        for (int g = threadIdx.x; g < (sh + n0 + 3) >> 2; g += blockDim.x) {
          float4 acc = mul4(ch.taps[0][0], ld4(ring + off0[0] - sh + 4 * g));
#pragma unroll
          for (int j = 1; j < MAXT; ++j)
            if (j < ch.n[0])
              acc = add4(acc, mul4(ch.taps[0][j],
                                   ld4(ring + off0[j] - sh + 4 * g)));
          *reinterpret_cast<float4*>(y0 + 4 * g) =
              mask4(acc, fk - E0 + 4 * g - sh, L);
        }
      } else {
        for (int i = threadIdx.x; i < n0; i += blockDim.x) {
          const long long f = fk - E0 + i;
          y0[sh + i] = f >= 0 && f < L ? p0(i) : 0.0f;
        }
      }
      __syncthreads();
      if (ch.passes == 2) {
        for (int i = threadIdx.x; i < n_out; i += blockDim.x)
          o[i] = pk(1, y0, s1, i);
        continue;
      }
      // pass 1: y0 -> y1 over [fk - E1, fk + lc + E1)
      const int n1 = lc + 2 * E1;
      if (vec1) {
        for (int g = threadIdx.x; g < (sh + n1 + 3) >> 2; g += blockDim.x) {
          const float* b = y0 + 4 * g;
          float4 acc = mul4(ch.taps[1][0], ld4(b));
#pragma unroll
          for (int j = 1; j < MAXT; ++j)
            if (j < ch.n[1]) acc = add4(acc, mul4(ch.taps[1][j], ld4(b + j * s1)));
          *reinterpret_cast<float4*>(y1 + 4 * g) =
              mask4(acc, fk - E1 + 4 * g - sh, L);
        }
      } else {
        for (int i = threadIdx.x; i < n1; i += blockDim.x) {
          const long long f = fk - E1 + i;
          y1[sh + i] = f >= 0 && f < L ? pk(1, y0, s1, i) : 0.0f;
        }
      }
      __syncthreads();
      if (s2 >= 8 && ch.n[2] == MAXT) {
        // pass 2 by walkers: walker (run, c) takes the outputs
        // c + (run*W + m) * s2, m < W, and slides a window of its MAXT
        // taps along them, reading each element of y1 about once
        constexpr int W = 12;
        const int runs = (n_out + W * s2 - 1) / (W * s2);
        for (int w = threadIdx.x; w < runs * s2; w += blockDim.x) {
          const int run = w / s2, c = w - run * s2;
          const int i0 = c + run * W * s2;
          const float* b = y1 + sh + i0;
          float win[MAXT];
#pragma unroll
          for (int j = 0; j < MAXT - 1; ++j) win[j] = b[j * s2];
#pragma unroll
          for (int m = 0; m < W; ++m) {
            if (i0 + m * s2 >= n_out) break;
            win[MAXT - 1] = b[(m + MAXT - 1) * s2];
            float acc = __fmul_rn(ch.taps[2][0], win[0]);
#pragma unroll
            for (int j = 1; j < MAXT; ++j)
              acc = __fadd_rn(acc, __fmul_rn(ch.taps[2][j], win[j]));
            o[i0 + m * s2] = acc;
#pragma unroll
            for (int j = 0; j < MAXT - 1; ++j) win[j] = win[j + 1];
          }
        }
      } else {
        for (int i = threadIdx.x; i < n_out; i += blockDim.x)
          o[i] = pk(2, y1, s2, i);
      }
    }
    ps = (ps + taps_ring - 1) % R;           // past the unit's last windows
  }
  ring_wait<0>();
}

template <int F, int MAXT>
static int launch(const float* in, float* out, long long L,
                  const FlatChain& ch, int Lc, int nwin, long long nk,
                  long long units, int slot, int buf0, int tile, int buf_y0,
                  int smem, int blocks, int threads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flat_color_blur_kernel<F, MAXT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flat_color_blur_kernel<F, MAXT><<<blocks, threads, smem, stream>>>(
      in, out, L, ch, Lc, nwin, nk, units, slot, buf0, tile, buf_y0);
  return (int)cudaGetLastError();
}

// taps: passes x 17 floats (pass p's taps from taps[17 p]); n_taps,
// strides, halos: one per pass.  The geometry comes from the wrapper's
// planner: windows of `Lc` positions (`nwin` of them across the stride
// of pass 0), `nk` steps along it, `in_flight` windows in flight, ring
// slots of `slot` floats, pass 1's window from float offset buf0 on,
// `tile` (one step a unit, see the kernel) with pass 0's window from
// float offset buf_y0 on, `smem` bytes of dynamic shared memory, `blocks` persistent blocks of
// `threads`.
extern "C" int flat_color_blur(const void* in, void* out,
                               long long n_stripes, long long L, int passes,
                               const float* taps, const int* n_taps,
                               const long long* strides, const int* halos,
                               int Lc, int nwin, long long nk, int in_flight,
                               int slot, int buf0, int tile, int buf_y0,
                               int smem,
                               int blocks, int threads, void* stream) {
  if (passes < 1 || passes > FLAT_BLUR_MAX_PASSES)
    return (int)cudaErrorInvalidValue;
  FlatChain ch = {};
  ch.passes = passes;
  int max_taps = 1;
  for (int p = 0; p < FLAT_BLUR_MAX_PASSES; ++p) {
    ch.n[p] = 1;
    ch.taps[p][0] = 1.0f;
  }
  for (int p = 0; p < passes; ++p) {
    const int n = n_taps[p];
    if (n < 1 || n > FLAT_BLUR_MAX_TAPS || n % 2 == 0 || strides[p] < 1)
      return (int)cudaErrorInvalidValue;
    ch.n[p] = n;
    ch.stride[p] = strides[p];
    ch.halo[p] = halos[p];
    for (int j = 0; j < n; ++j) ch.taps[p][j] = taps[FLAT_BLUR_MAX_TAPS * p + j];
    if (n > max_taps) max_taps = n;
  }
  if (n_stripes == 0 || L == 0) return 0;
  const long long units = n_stripes * nwin;
  if (blocks < 1 || threads < 32 || threads > 512 || Lc < 1)
    return (int)cudaErrorInvalidConfiguration;
  if (blocks > units) blocks = (int)units;
  const float* i = (const float*)in;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const bool narrow = max_taps <= 5;
  if (in_flight == 1)
    return narrow ? launch<1, 5>(i, o, L, ch, Lc, nwin, nk, units, slot, buf0,
                                 tile, buf_y0, smem, blocks, threads, s)
                  : launch<1, FLAT_BLUR_MAX_TAPS>(i, o, L, ch, Lc, nwin, nk,
                                                  units, slot, buf0, tile,
                                                  buf_y0, smem, blocks,
                                                  threads, s);
  if (in_flight == 2)
    return narrow ? launch<2, 5>(i, o, L, ch, Lc, nwin, nk, units, slot, buf0,
                                 tile, buf_y0, smem, blocks, threads, s)
                  : launch<2, FLAT_BLUR_MAX_TAPS>(i, o, L, ch, Lc, nwin, nk,
                                                  units, slot, buf0, tile,
                                                  buf_y0, smem, blocks,
                                                  threads, s);
  return (int)cudaErrorInvalidValue;
}
