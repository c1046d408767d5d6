// bilateral_splat_tiles — per-tile splat of the bilateral grid's v1 route,
// for sm_90a.
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py:226 `_splat_kernel` (per-tile
// one-hot-matmul splat partials in the packed-corner [gc, hip, 4C]
// layout).
//
// Computes, for every image b, spatial tile (ty, tx), corner q = by*2 + bx,
// colour cell m and channel c:
//     P[b, ty, tx, q, m, c] = sum over the tile's pixels p with cell(p) = m,
//                             in row-major order, from +0.0,
//                             of (w_by(y) * w_bx(x)) * X[b, p, c]
// with bilinear weights w_0 = 1 - (y mod t)/t, w_1 = (y mod t)/t.  P is
// [B, nty, ntx, 4, gc^3, C] f32 in the canonical colour order
// m = (cr*gc + cg)*gc + cb (not the TPU's hi/lo split), C innermost.
// Corner q of tile (ty, tx) belongs to grid node (ty + by, tx + bx):
// `bilateral_fold` / `bilateral_fold_blur` add them up.
//
// Bound on the H100: bytes.  P is written once (705 MB at B 8, 8x8 tiles,
// gc 16, C 21; 48 MB at SEC prediction's 5x7 tiles), almost all of it
// zeros; X and the cell map are read once.  3 flops per (pixel, corner,
// channel) are nothing against 3.35 TB/s.
//
// Design: the TPU kernel multiplies one-hot matrices because it has no
// scatter.  Here the work is cut into units (tile, range of consecutive
// colour cells; the planner's cut: kernels/bilateral.py splat_tiles_plan)
// and each persistent block walks an even, consecutive share of them
// (the wrapper sizes the launch so that every block has the same number),
// writing every element of its units exactly once: the caller needs no
// memset.  When its walk enters a tile the block stages the tile's cells,
// and where they fit its pixel values, in shared memory, all its 4-byte
// cp.async copies in flight at once.  Per unit it lists the tile's pixels
// whose cell lies in the range in row-major order (a ballot and a prefix
// sum over warps), stages their values where the tile's did not fit
// (`chunk` at a time), and lets thread (q, c) add them into corner q,
// channel c of the range's four corner segments in shared memory, in list
// order, a run of pixels of one cell in a register.  Then
// the block streams the four segments out with 16-byte evict-first
// stores (the partials are written once and read once, by the fold), and
// zeroes each float4 as it reads it, so the segments are zero again for
// the next unit.  A segment sits at the float offset (0-3) of its run in
// device memory, so the body of every run is aligned.  Consecutive units
// of a tile continue each corner's run.
//
// The bilinear weights come from the wrapper as a table computed by the
// plain version's own ops (on the card PyTorch divides by t as a multiply
// by 1/t, which a division here would not match where t is no power of
// two).  Every (cell, channel) adds its pixels in row-major order from
// +0.0 with the plain version's __fmul_rn / __fadd_rn, and no two threads
// touch one element: no atomics, the same bits on every run, bit-equal to
// the plain version.
#include "ring_copy.cuh"

__global__ void __launch_bounds__(256) bilateral_splat_tiles_kernel(
    const float* __restrict__ x, const int* __restrict__ cell,
    const float* __restrict__ wts, float* __restrict__ part, int H, int W,
    int C, int t, int nty, int ntx, int gc3, int cells, int ranges,
    int chunk, int seg, long long units) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int wcount[32];
  const bool whole = chunk == 0;                     // the tile's x staged
  float* S = smem;                                   // [4][seg]
  float* wt = S + 4 * seg;                           // [2][t]
  int* tc = reinterpret_cast<int*>(wt + ((2 * t + 3) & ~3));   // [t*t]
  int* list = tc + t * t;                            // [t*t]
  float* X = reinterpret_cast<float*>(list + t * t);   // [t*t or chunk][C]
  const FastDiv by_c(C);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long slab = (long long)gc3 * C;
  for (int i = threadIdx.x; i < 2 * t; i += blockDim.x)
    cp_async4(wt + i, wts + i);
  for (int i = threadIdx.x; i < seg; i += blockDim.x)
    reinterpret_cast<float4*>(S)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the tile staged in shared memory, and its geometry
  long long tile = -1, p0 = 0;                       // p0: its first pixel
  int nx = 1, npix = 0;
  FastDiv by_nx(1);
  const long long u1 = (blockIdx.x + 1) * units / gridDim.x;
  for (long long u = blockIdx.x * units / gridDim.x; u < u1; ++u) {
    if (u / ranges != tile) {
      tile = u / ranges;                             // (b*nty + ty)*ntx + tx
      const int tx = (int)(tile % ntx);
      const long long bt = tile / ntx;
      const int ty = (int)(bt % nty);
      const int y0 = ty * t, x0 = tx * t;
      nx = min(t, W - x0);
      npix = min(t, H - y0) * nx;
      p0 = ((bt / nty) * H + y0) * W + x0;
      by_nx = FastDiv(nx);
      // every copy in flight at once: 4-byte cp.async
      for (int f = threadIdx.x; f < npix; f += blockDim.x) {
        const int iy = by_nx.div(f);
        cp_async4(reinterpret_cast<float*>(tc + f),
                  reinterpret_cast<const float*>(cell) + p0 +
                      (long long)iy * W + (f - iy * nx));
      }
      if (whole) {
        for (int i = threadIdx.x; i < npix * C; i += blockDim.x) {
          const int f = by_c.div(i), iy = by_nx.div(f);
          cp_async4(X + i, x + (p0 + (long long)iy * W + (f - iy * nx)) * C +
                               (i - f * C));
        }
      }
      ring_commit();
      ring_wait<0>();
      __syncthreads();
    }
    const int m0 = (int)(u - tile * ranges) * cells;
    const int mlen = min(cells, gc3 - m0);
    const long long e0 = (tile * 4 * gc3 + m0) * (long long)C;   // corner 0

    // the codes (cell - m0) << 12 | iy << 6 | ix of the range's pixels,
    // in row-major order.  Its first barrier also orders the last unit's
    // stores, which zero the segments, before this unit's adds.
    int L = 0;
    for (int base = 0; base < npix; base += blockDim.x) {
      const int f = base + threadIdx.x;
      int code = -1;
      if (f < npix) {
        const int m = tc[f] - m0;
        if (m >= 0 && m < mlen) {
          const int iy = by_nx.div(f);
          code = (m << 12) | (iy << 6) | (f - iy * nx);
        }
      }
      const unsigned bal = __ballot_sync(0xffffffffu, code >= 0);
      if (lane == 0) wcount[warp] = __popc(bal);
      __syncthreads();
      int before = L;
      for (int w = 0; w < nwarps; ++w) {
        const int n = wcount[w];
        before += w < warp ? n : 0;
        L += n;
      }
      if (code >= 0) list[before + __popc(bal & ((1u << lane) - 1u))] = code;
      __syncthreads();
    }

    for (int k0 = 0; k0 < L; k0 += whole ? L : chunk) {
      const int n = whole ? L : min(chunk, L - k0);
      if (!whole) {
        for (int i = threadIdx.x; i < n * C; i += blockDim.x) {
          const int k = by_c.div(i);
          const int code = list[k0 + k];
          cp_async4(X + i, x + (p0 + (long long)((code >> 6) & 63) * W +
                                (code & 63)) * C + (i - k * C));
        }
        ring_commit();
        ring_wait<0>();
        __syncthreads();
      }
      for (int qc = threadIdx.x; qc < 4 * C; qc += blockDim.x) {
        const int q = by_c.div(qc), c = qc - q * C;
        const float* wy = wt + (q >> 1) * t;
        const float* wx = wt + (q & 1) * t;
        float* s = S + q * seg + window_offset(part, e0 + q * slab) + c;
        int prev = -1;
        float acc = 0.0f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          const int code = list[k0 + k];
          const int m = code >> 12, iy = (code >> 6) & 63, ix = code & 63;
          const float xv = X[(whole ? iy * nx + ix : k) * C + c];
          const float v = __fmul_rn(__fmul_rn(wy[iy], wx[ix]), xv);
          if (m != prev) {
            if (prev >= 0) s[prev * C] = acc;
            acc = s[m * C];
            prev = m;
          }
          acc = __fadd_rn(acc, v);
        }
        if (prev >= 0) s[prev * C] = acc;
      }
      __syncthreads();
    }

    // stream the four segments out, a run of mlen*C floats a corner, and
    // leave them zero: whole float4s with 16-byte stores, the 0-3 floats
    // at either end of a run one by one
    const int n = mlen * C;
    for (int q = 0; q < 4; ++q) {
      const long long e = e0 + q * slab;
      const int o = window_offset(part, e);
      float* s = S + q * seg;
      float* d = part + (e - o);                     // 16-byte aligned
      const int h = (o + 3) >> 2, tl = max(h, (o + n) >> 2);
#pragma unroll 4
      for (int i = h + threadIdx.x; i < tl; i += blockDim.x) {
        const float4 v = reinterpret_cast<const float4*>(s)[i];
        reinterpret_cast<float4*>(s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        __stcs(reinterpret_cast<float4*>(d) + i, v);
      }
      if (threadIdx.x < 8) {                         // head, then tail
        const int j = threadIdx.x < 4 ? o + threadIdx.x
                                      : 4 * tl + threadIdx.x - 4;
        if (j < (threadIdx.x < 4 ? min(4 * h, o + n) : o + n)) {
          __stcs(d + j, s[j]);
          s[j] = 0.0f;
        }
      }
    }
  }
}

// The geometry comes from the wrapper's planner: ranges of `cells` cells
// (`ranges` of them a slab), the tile's x staged whole (chunk 0) or
// `chunk` pixels at a time, corner segments of `seg` floats, `smem` bytes
// of dynamic shared memory, `blocks` persistent blocks of `threads`.
// wts [2][t] holds the bilinear weights 1 - i/t and i/t.
extern "C" int bilateral_splat_tiles(const void* x, const void* cell,
                                     const void* wts, void* part, int B,
                                     int H, int W, int C, int t, int nty,
                                     int ntx, int gc3, int cells, int ranges,
                                     int chunk, int seg, int smem, int blocks,
                                     int threads, void* stream) {
  const long long units = (long long)B * nty * ntx * ranges;
  if (units == 0 || C == 0) return 0;
  const long long staged = chunk == 0 ? (long long)t * t : chunk;
  const long long need = 4LL * (4LL * seg + ((2 * t + 3) & ~3) +
                                2LL * t * t + staged * C);
  if (t < 1 || t > 64 || cells < 1 || cells >= (1 << 19) ||
      (long long)cells * ranges < gc3 || chunk < 0 || seg % 4 ||
      (long long)seg < (long long)cells * C + 3 || smem < need ||
      blocks < 1 || threads < 32 || threads > 256 || threads % 32)
    return (int)cudaErrorInvalidConfiguration;
  // the attribute is set once a device and size, not on every launch
  static int smem_set[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(bilateral_splat_tiles_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) smem_set[dev] = smem;
  }
  bilateral_splat_tiles_kernel<<<(unsigned int)(blocks < units ? blocks
                                                               : units),
                                 threads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)cell, (const float*)wts, (float*)part, H,
      W, C, t, nty, ntx, gc3, cells, ranges, chunk, seg, units);
  return (int)cudaGetLastError();
}
