// bilateral_slice — slice of the bilateral-grid filter, for sm_90a.
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py `_slice_kernel` (:448) as
// `_slice_v2` (:1052, call :1066) and `_slice` (:1090, call :1108) call
// it: per-tile one-hot matmuls against 4 corner slabs, a lane mask and a
// group-sum matmul.
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
// (at most 4 nodes x C per pixel, fewer where pixels share a cell), the
// cell map once and writes the output once; 7 flops per element.  At the
// main path's shape (B 8, 64x64, C 21) that is 1.6 MB of cells and 2.75 MB
// written, ~1.3 us, against the ~2.2 us a launch takes on its own; at SEC
// prediction's (one 38x50 guide) 0.1 us.  So what costs is latency: the
// chain of dependent instructions and round trips to memory before a
// thread's first store, and the integer work an element.
//
// Design: the TPU kernel gathers with one-hot matmuls because it has no
// fast gather.  Every division (by C, W, H and t) is one 64-bit high
// multiply by a reciprocal the host works out (Div32): a 32-bit division
// is a chain of ~15 dependent instructions, and a pixel's coordinates
// take three in a row on the way to its first load.  Two cuts, one
// launch, chosen by the wrapper (`slice_run`) from the input's size:
//  * up to as many elements as the card holds threads at once (SEC
//    prediction's and the wide path's guides), a thread takes an element:
//    the shortest chain (coordinates, then the cell map and the weight
//    table, then the four corners, then the store);
//  * past that (the main path's 32768 pixels), a warp takes a run of
//    L <= 32 consecutive pixels of the flat [B*H*W] order (runs cross
//    image rows and images, as in bilateral_slice_aligned).  Lane i < L
//    loads cell[p0 + i] and works out its pixel's row of corner (0, 0) and
//    the four weight products w00 = wy0 wx0, w01 = wy0 fx, w10 = fy wx0,
//    w11 = fy fx once; the warp then writes the run's L*C contiguous
//    floats, lane l elements e = k*32 + l, each from pixel e / C, its row
//    and weights from a __shfl_sync, so that one load instruction of the
//    warp reads 32 consecutive floats of the corner rows and one store
//    writes 128 contiguous bytes.  L*C <= 256: a thread issues the 4
//    corners' loads of its SLICE_ELEMS elements before it adds or stores
//    any, and each pixel's coordinates serve C elements.
// Persistent blocks walk the elements or the runs grid-stride.
//
// Each element keeps the plain version's arithmetic and order:
// acc = w00 g00, then + w01 g01, + w10 g10, + w11 g11, round-to-nearest
// intrinsics with no FMA contraction; the weights come from the wrapper as
// the plain version computes them (on the card PyTorch divides by t as a
// multiply by 1/t) and a product computed once and shuffled has the same
// bits.  So the result is bit-equal to the plain PyTorch version at any t.
#include <cuda_runtime.h>

#define SLICE_THREADS 256   // 1024 threads an SM at <= 64 registers
#define SLICE_ELEMS 8        // a lane's elements a round of a run

// q = i / d for every 32-bit i, by one 64-bit high multiply with
// m = ceil(2^64 / d) from the host (exact: i * (m d - 2^64) < 2^64), or
// q = i where d is 1 (m = 0).
struct Div32 {
  unsigned long long m;
  __device__ __forceinline__ unsigned div(unsigned i) const {
    return m ? (unsigned)__umul64hi(i, m) : i;
  }
};

static Div32 div32(unsigned d) {
  return Div32{d == 1 ? 0ULL : ~0ULL / d + 1};
}

// One thread an element: e = (pixel, channel) of the flat output.
__global__ void __launch_bounds__(SLICE_THREADS, 1024 / SLICE_THREADS)
bilateral_slice_elem_kernel(
    const float* __restrict__ grid, const int* __restrict__ cell,
    const float* __restrict__ wts, float* __restrict__ out, unsigned n,
    int H, int W, int C, int t, int gy, int gx, int gc3, Div32 by_w,
    Div32 by_h, Div32 by_t, Div32 by_c) {
  const long long sx = (long long)gc3 * C;           // next node along x
  const long long sy = (long long)gx * sx;           // next node along y
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    const unsigned p = by_c.div(e), c = e - p * C;
    const unsigned bh = by_w.div(p), b = by_h.div(bh);
    const unsigned xx = p - bh * W, y = bh - b * H;
    const unsigned ty = by_t.div(y), tx = by_t.div(xx);
    const unsigned iy = y - ty * t, ix = xx - tx * t;
    const float wy0 = wts[iy], fy = wts[t + iy];
    const float wx0 = wts[ix], fx = wts[t + ix];
    const int row = (int)(((b * gy + ty) * gx + tx) * gc3) + cell[p];
    const float* s = grid + (long long)row * C + c;
    float acc = __fmul_rn(__fmul_rn(wy0, wx0), s[0]);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wy0, fx), s[sx]));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(fy, wx0), s[sy]));
    out[e] = __fadd_rn(acc, __fmul_rn(__fmul_rn(fy, fx), s[sy + sx]));
  }
}

// One warp a run of L pixels.
__global__ void __launch_bounds__(SLICE_THREADS, 1024 / SLICE_THREADS)
bilateral_slice_kernel(
    const float* __restrict__ grid, const int* __restrict__ cell,
    const float* __restrict__ wts, float* __restrict__ out, int P, int H,
    int W, int C, int t, int gy, int gx, int gc3, int L, int runs,
    Div32 by_w, Div32 by_h, Div32 by_t, Div32 by_c) {
  const int lane = threadIdx.x & 31;
  const int step = (gridDim.x * blockDim.x) >> 5;
  const long long sx = (long long)gc3 * C;           // next node along x
  const long long sy = (long long)gx * sx;           // next node along y
  for (int run = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; run < runs;
       run += step) {
    const int p0 = run * L;
    const int n = min(L, P - p0);
    int row = 0;                   // grid row of lane's corner (0, 0)
    float w00 = 0.f, w01 = 0.f, w10 = 0.f, w11 = 0.f;
    if (lane < n) {
      const unsigned p = p0 + lane;
      const unsigned bh = by_w.div(p), b = by_h.div(bh);
      const unsigned xx = p - bh * W, y = bh - b * H;
      const unsigned ty = by_t.div(y), tx = by_t.div(xx);
      const unsigned iy = y - ty * t, ix = xx - tx * t;
      const float wy0 = wts[iy], fy = wts[t + iy];
      const float wx0 = wts[ix], fx = wts[t + ix];
      w00 = __fmul_rn(wy0, wx0);
      w01 = __fmul_rn(wy0, fx);
      w10 = __fmul_rn(fy, wx0);
      w11 = __fmul_rn(fy, fx);
      row = (int)(((b * gy + ty) * gx + tx) * gc3) + cell[p];
    }
    const int total = n * C;
    float* o = out + (long long)p0 * C;
    for (int e0 = 0; e0 < total; e0 += 32 * SLICE_ELEMS) {
      // rows of 32 elements in this round (the same on every lane)
      const int m = min(SLICE_ELEMS, (total - e0 + 31) >> 5);
      // every gather of the round first ...
      float g[SLICE_ELEMS][4];
#pragma unroll
      for (int k = 0; k < SLICE_ELEMS; ++k) {
        if (k < m) {
          const int e = e0 + k * 32 + lane;
          const int q = by_c.div(e);            // e >= 0
          const int r = __shfl_sync(0xffffffffu, row, q & 31);
          if (e < total) {
            const float* s = grid + (long long)r * C + (e - q * C);
            g[k][0] = s[0];
            g[k][1] = s[sx];
            g[k][2] = s[sy];
            g[k][3] = s[sy + sx];
          } else {
            g[k][0] = g[k][1] = g[k][2] = g[k][3] = 0.f;
          }
        }
      }
      // ... then the weights, the sums and the stores
#pragma unroll
      for (int k = 0; k < SLICE_ELEMS; ++k) {
        if (k < m) {
          const int e = e0 + k * 32 + lane;
          const int i = by_c.div(e) & 31;
          const float a0 = __shfl_sync(0xffffffffu, w00, i);
          const float a1 = __shfl_sync(0xffffffffu, w01, i);
          const float a2 = __shfl_sync(0xffffffffu, w10, i);
          const float a3 = __shfl_sync(0xffffffffu, w11, i);
          float acc = __fmul_rn(a0, g[k][0]);
          acc = __fadd_rn(acc, __fmul_rn(a1, g[k][1]));
          acc = __fadd_rn(acc, __fmul_rn(a2, g[k][2]));
          acc = __fadd_rn(acc, __fmul_rn(a3, g[k][3]));
          if (e < total) o[e] = acc;
        }
      }
    }
  }
}

// wts [2][t] holds the bilinear weights 1 - i/t and i/t, as the plain
// version computes them.  L = 0: a thread an element; else runs of L
// pixels.  The wrapper checks what the kernel takes: pixels and grid rows
// under 2^31, C <= 8192, L <= 32 (and elements under 2^31 for L = 0).
extern "C" int bilateral_slice(const void* grid, const void* cell,
                               const void* wts, void* out, int B, int H,
                               int W, int C, int t, int gy, int gx, int gc3,
                               int L, int blocks, void* stream) {
  const long long P = (long long)B * H * W;
  if (P * C == 0) return 0;
  if (P > 2147483647LL || (long long)B * gy * gx * gc3 > 2147483647LL ||
      C > 8192 || t < 1 || L < 0 || L > 32 || blocks < 1 ||
      (L == 0 && P * C > 2147483647LL))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (L == 0)
    bilateral_slice_elem_kernel<<<blocks, SLICE_THREADS, 0, st>>>(
        (const float*)grid, (const int*)cell, (const float*)wts,
        (float*)out, (unsigned)(P * C), H, W, C, t, gy, gx, gc3, div32(W),
        div32(H), div32(t), div32(C));
  else
    bilateral_slice_kernel<<<blocks, SLICE_THREADS, 0, st>>>(
        (const float*)grid, (const int*)cell, (const float*)wts,
        (float*)out, (int)P, H, W, C, t, gy, gx, gc3, L,
        (int)((P + L - 1) / L), div32(W), div32(H), div32(t), div32(C));
  return (int)cudaGetLastError();
}
