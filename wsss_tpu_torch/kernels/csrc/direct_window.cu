// direct_window — the CRF's exact truncated bilateral window, sm_90a.
//
// Replaces no TPU kernel: wsss_tpu/ops/crf/meanfield.py:DirectBilateral
// is plain jnp there (XLA fuses its offset loop).  The port's plain
// version (ops/crf/meanfield.py: DirectBilateral._filter) issued one
// multiply-add launch an offset, 2 821 a filter at HistoSegNet's ADP
// window, each reading and writing the whole [B, H, W, C] sum; this
// kernel is the whole filter in one launch.
//
// Computes, for every image b, output pixel p and channel c,
//     out[b, p, c] = sum_o ws[o] * exp(-|I[p] - I[p + o]|^2 * inv)
//                                * x[b, p + o, c]
// over the window's offsets o = (dy, dx) with p + o inside the image
// (outside it the plain version's padded x is zero).  The offsets come
// as a table of rows, one a dy from dy0 on, each a run of dx lo..hi, and
// the spatial weights as a dense table wd[dx + rx][k + 7] (k = dy - dy0;
// 0 where (dy, dx) is no offset, and in 7 zero rows at each end).
//
// Bound on the H100: arithmetic.  A filter moves ~93 MB at ADP's morph
// shape (28 us at 3.35 TB/s) but costs, per (pixel, offset) pair, the
// colour weight (~17 float32 instructions with one MUFU ex2 inside expf)
// and C fused multiply-adds.  The weights are computed at every filter:
// all of a CRF's would be 4.5 GB, more to read back than to compute.
//
// Design.  A block is one warp and owns one image's pixels of P rows x
// 32 columns, and one group of G channels (all C where C <= 32; G is
// one of a few widths built, channels past C staged as zeros); a lane
// owns the P pixels of its column.  The warp walks the rows the window
// reaches, top to bottom: step t stages guide row y0 + dy0 + t and its x
// row, 32 + 2 rx columns, into shared memory (a ring of two slots filled
// by 4-byte cp.async, zero outside the image; pixel-major, the guide at
// 4 floats a pixel for one 16-byte load, x at an odd compile-time stride
// of G | 1 floats, so the lanes' loads meet no bank twice and take
// immediate offsets), and serves every pixel j whose dy = dy0 + t - j is
// a row of the window.  Along dx each lane loads the guide and G
// channels at its column + dx once and feeds them to its P pixels, so a
// loaded x value feeds P multiply-adds and each weight is computed once
// for all G channels.  A lane's dx is the warp's, so the spatial
// weights' loads are broadcasts, at immediate offsets -j from one
// address in the dense table's column; there is no branch inside the
// walk along dx: a pixel outside its run reads weight 0.
//
// Order and precision.  Each output element is summed by one thread, dy
// ascending and dx ascending within a dy (the plain version's order),
// in float32 fused multiply-adds: no atomics, no fast-math, no tensor
// cores; expf, not __expf.  The colour distance and the weight use
// explicit round-to-nearest operations, so an element's bits depend on
// its own image alone, whatever the tile, the channel groups or the
// batch.  A pair outside the window or the image adds 0 * x, exactly
// nothing.
#include <cuda_runtime.h>
#include <climits>

#include "ring_copy.cuh"

namespace {

constexpr int kMaxG = 32;
// zero rows at each end of the dense weight table: P - 1 at most
constexpr int kPad = 7;

// Pixels a thread (rows), for G channels a thread: about 128
// accumulators a thread (kernels/bilateral.py: _window_rows mirrors it).
// On an H100 at ADP's shapes 128 beat 96 and 160 (C 29: 3.64 ms a filter
// against 4.32 and 4.23), and two steps along dx unrolled beat one.
__host__ __device__ constexpr int rows_of(int g) {
  return 128 / g < 1 ? 1 : (128 / g > 8 ? 8 : 128 / g);
}

// Floats a ring slot: 32 + 2 rx pixels of the guide (4 floats) and of x
// (g | 1 floats), rounded up to 16 bytes.
__host__ __device__ constexpr int slot_floats(int g, int rx) {
  return ((32 + 2 * rx) * (4 + (g | 1)) + 3) / 4 * 4;
}

struct WindowArgs {
  const float* img;    // [B, H, W, 3]
  const float* x;      // [B, H, W, C]
  float* out;          // [B, H, W, C]
  const int* rows;     // [ndy][2]: lo, hi
  const float* wd;     // [2 rx + 1][ndy + 2 kPad]
  int h, w, c, groups;
  int dy0, ndy, rx;
  float ninv;          // -0.5 / srgb^2
};

__device__ __forceinline__ void cp_async4_fill(float* dst, const float* src,
                                               bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

template <int G, int P>
__global__ void __launch_bounds__(32)
    direct_window_kernel(const WindowArgs a) {
  constexpr int GS = G | 1;            // floats a staged x pixel
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int x0 = blockIdx.x * 32, xl = x0 + lane;
  const int y0 = blockIdx.y * P;
  const int b = blockIdx.z / a.groups;
  const int c0 = (blockIdx.z - b * a.groups) * G;
  const int gn = min(G, a.c - c0);
  const int cols = 32 + 2 * a.rx;
  const int slot = slot_floats(G, a.rx);
  const int nk = a.ndy + 2 * kPad;
  const int nsteps = a.ndy + P - 1;
  const long long img_b = (long long)b * a.h * a.w;

  // channels of the group past C stay zero in both slots
  if (gn < G)
    for (int i = lane; i < 2 * cols; i += 32) {
      float* px = smem + (i / cols) * slot + 4 * cols + (i % cols) * GS;
      for (int k = gn; k < G; ++k) px[k] = 0.0f;
    }

  float ip[P][3];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const bool in = y0 + j < a.h && xl < a.w;
    const long long e = (img_b + (long long)(y0 + j) * a.w + xl) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) ip[j][k] = in ? a.img[e + k] : 0.0f;
  }
  float acc[P][G];
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int ch = 0; ch < G; ++ch) acc[j][ch] = 0.0f;

  // stage guide row y0 + dy0 + t and its x row into ring slot t & 1
  const FastDiv by_gn(gn);
  auto stage = [&](int t) {
    const int r = y0 + a.dy0 + t;
    if (r >= 0 && r < a.h) {
      float* gs = smem + (t & 1) * slot;
      float* xs = gs + 4 * cols;
      const long long row = img_b + (long long)r * a.w;
      const int xa = x0 - a.rx;
      for (int i = lane; i < 3 * cols; i += 32) {
        const int col = i / 3, k = i - 3 * col, xc = xa + col;
        const bool in = xc >= 0 && xc < a.w;
        cp_async4_fill(gs + 4 * col + k,
                       a.img + (in ? (row + xc) * 3 + k : 0), in);
      }
      for (int i = lane; i < gn * cols; i += 32) {
        const int col = by_gn.div(i), k = i - gn * col, xc = xa + col;
        const bool in = xc >= 0 && xc < a.w;
        cp_async4_fill(xs + GS * col + k,
                       a.x + (in ? (row + xc) * a.c + c0 + k : 0), in);
      }
    }
    ring_commit();
  };

  stage(0);
  for (int t = 0; t < nsteps; ++t) {
    if (t + 1 < nsteps) stage(t + 1); else ring_commit();
    ring_wait<1>();
    __syncwarp();
    const int r = y0 + a.dy0 + t;
    if (r >= 0 && r < a.h) {
      // pixel j meets row r at dy = dy0 + t - j: table row t - j; the
      // walk covers the union of the pixels' runs, clipped to the
      // columns some lane has inside the image
      int dlo = INT_MAX, dhi = INT_MIN;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int k = t - j;
        if (k >= 0 && k < a.ndy && y0 + j < a.h) {
          const int l = __ldg(a.rows + 2 * k), h = __ldg(a.rows + 2 * k + 1);
          if (l <= h) {
            dlo = min(dlo, l);
            dhi = max(dhi, h);
          }
        }
      }
      dlo = max(dlo, -(x0 + 31));
      dhi = min(dhi, a.w - 1 - x0);
      if (dlo > dhi) {                  // no pixel meets this row
        dlo = 0;
        dhi = -1;
      }
      const float* gp = smem + (t & 1) * slot + 4 * (lane + dlo + a.rx);
      const float* xp = smem + (t & 1) * slot + 4 * cols +
                        GS * (lane + dlo + a.rx);
      const float* wp = a.wd + (long long)(dlo + a.rx) * nk + t + kPad;
#pragma unroll 2
      for (int dx = dlo; dx <= dhi; ++dx) {
        const float4 q = *reinterpret_cast<const float4*>(gp);
        float wt[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float d0 = __fsub_rn(ip[j][0], q.x);
          const float d1 = __fsub_rn(ip[j][1], q.y);
          const float d2 = __fsub_rn(ip[j][2], q.z);
          const float s =
              __fmaf_rn(d2, d2, __fmaf_rn(d1, d1, __fmul_rn(d0, d0)));
          const float e = expf(__fmul_rn(s, a.ninv));
          wt[j] = __fmul_rn(__ldg(wp - j), e);
        }
#pragma unroll
        for (int ch = 0; ch < G; ++ch) {
          const float v = xp[ch];
#pragma unroll
          for (int j = 0; j < P; ++j)
            acc[j][ch] = __fmaf_rn(wt[j], v, acc[j][ch]);
        }
        gp += 4;
        xp += GS;
        wp += nk;
      }
    }
    __syncwarp();
  }

  if (xl < a.w) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (y0 + j >= a.h) break;
      float* o = a.out + (img_b + (long long)(y0 + j) * a.w + xl) * a.c + c0;
#pragma unroll
      for (int ch = 0; ch < G; ++ch)
        if (ch < gn) o[ch] = acc[j][ch];
    }
  }
}

template <int G>
int launch(const WindowArgs& a, int b, int smem, cudaStream_t stream) {
  constexpr int P = rows_of(G);
  auto kernel = direct_window_kernel<G, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.w + 31) / 32, (a.h + P - 1) / P, b * a.groups);
  kernel<<<grid, 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// img [B, H, W, 3], x and out [B, H, W, C], float32, contiguous.  rows
// [ndy][2] int32 and wd [2 rx + 1][ndy + 14] float32: the window's
// tables, on the device.  The geometry comes from the wrapper's planner
// (kernels/bilateral.py: direct_window_plan): g channels a block in
// `groups` groups, p rows a thread (checked against rows_of(g)), `smem`
// bytes of dynamic shared memory (two slots of slot_floats(g, rx)).
extern "C" int direct_window(const float* img, const float* x, float* out,
                             const int* rows, const float* wd, int b, int h,
                             int w, int c, int dy0, int ndy, int rx,
                             float ninv, int g, int p, int groups, int smem,
                             void* stream) {
  if (g < 1 || g > kMaxG || p != rows_of(g) || groups < 1 ||
      (groups - 1) * g >= c || groups * g < c || ndy < 1 || rx < 0 ||
      smem < 2 * slot_floats(g, rx) * 4)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || w == 0) return 0;
  const WindowArgs a{img, x, out, rows, wd, h, w, c, groups, dy0, ndy, rx,
                     ninv};
  cudaStream_t s = (cudaStream_t)stream;
  switch (g) {
#define DW_CASE(G) \
  case G:          \
    return launch<G>(a, b, smem, s);
    // the paths' widths (C 1, 5, 21, 29) and powers of two between;
    // kernels/bilateral.py: _WINDOW_G lists the same
    DW_CASE(1) DW_CASE(2) DW_CASE(4) DW_CASE(5) DW_CASE(8) DW_CASE(16)
    DW_CASE(21) DW_CASE(29) DW_CASE(32)
#undef DW_CASE
  }
  return (int)cudaErrorInvalidValue;
}
