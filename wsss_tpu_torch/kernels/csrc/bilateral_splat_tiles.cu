// bilateral_splat_tiles — per-tile splat of the bilateral grid's v1 route,
// for sm_90a.
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py:226 `_splat_kernel` (per-tile
// one-hot-matmul splat partials in the packed-corner [gc, hip, 4C]
// layout).
//
// Computes, for every image b, spatial tile (ty, tx), corner q = by*2 + bx,
// colour cell m and channel c:
//     P[b, ty, tx, q, m, c] = sum over the tile's pixels p with cell(p) = m
//                             of w_by(y) * w_bx(x) * X[b, p, c]
// with bilinear weights w_0 = 1 - (y mod t)/t, w_1 = (y mod t)/t.  P is
// [B, nty, ntx, 4, gc^3, C] f32 in the canonical colour order
// m = (cr*gc + cg)*gc + cb (not the TPU's hi/lo split), C innermost; the
// caller zeroes it.  Corner q of tile (ty, tx) belongs to grid node
// (ty + by, tx + bx): `bilateral_fold` / `bilateral_fold_blur` add them up.
//
// Bound on the H100: bytes.  X and the cell map are read once and P is
// written once (704 MB at B 8, 8x8 tiles, gc 16, C 21 — almost all of it
// the caller's memset); 3 flops per (pixel, corner, channel) are nothing
// against 3.35 TB/s.
//
// Design: the TPU kernel multiplies one-hot matrices because it has no
// scatter.  Here a block owns one (tile, corner) and thread c owns channel
// c of all its gc^3 cells, so no two threads ever touch one address: the
// thread walks the tile's pixels in row-major order and adds each weighted
// value to P[.., cell(p), c] with a plain load, add and store.  No atomics,
// so the sums have one fixed order: the result has the same bits on every
// run and equals the plain version bit for bit.  With C innermost the
// threads of a warp read and write neighbouring addresses.  The price is a
// chain of t^2 dependent read-modify-writes through L2 per thread (64 at
// t 8, 2304 at t 48) and only C threads a block.
#include <cuda_runtime.h>

__global__ void bilateral_splat_tiles_kernel(
    const float* __restrict__ x, const int* __restrict__ cell,
    float* __restrict__ part, int H, int W, int C, int t, int nty, int ntx,
    int gc3) {
  long long tile = blockIdx.x;               // (b * nty + ty) * ntx + tx
  int q = blockIdx.y;
  int by = q >> 1, bx = q & 1;
  int tx = (int)(tile % ntx);
  long long r = tile / ntx;
  int ty = (int)(r % nty);
  long long b = r / nty;
  int y0 = ty * t, x0 = tx * t;
  int ny = min(t, H - y0), nx = min(t, W - x0);
  float* out = part + (tile * 4 + q) * (long long)gc3 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int iy = 0; iy < ny; ++iy) {
      float fy = (float)iy / (float)t;
      float wy = by ? fy : 1.0f - fy;
      long long row = (b * H + y0 + iy) * W + x0;
      for (int ix = 0; ix < nx; ++ix) {
        float fx = (float)ix / (float)t;
        float wx = bx ? fx : 1.0f - fx;
        long long p = row + ix;
        float v = __fmul_rn(__fmul_rn(wy, wx), x[p * C + c]);
        float* o = out + (long long)cell[p] * C + c;
        *o = __fadd_rn(*o, v);
      }
    }
  }
}

extern "C" int bilateral_splat_tiles(const void* x, const void* cell,
                                     void* part, int B, int H, int W, int C,
                                     int t, int nty, int ntx, int gc3,
                                     void* stream) {
  long long tiles = (long long)B * nty * ntx;
  if (tiles == 0 || C == 0) return 0;
  int threads = C >= 256 ? 256 : (C + 31) / 32 * 32;
  dim3 grid((unsigned int)tiles, 4);
  bilateral_splat_tiles_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)cell, (float*)part, H, W, C, t, nty, ntx,
      gc3);
  return (int)cudaGetLastError();
}
