// bilateral_fold — fold of the per-tile splat partials into the grid, for
// sm_90a (the v1 route's unfused path).
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py:414 `_combine_kernel` (call :993:
// fold the corner groups of the 4 neighbouring tiles' partials into one
// grid node, no blur).
//
// Computes, for every image b, node (sy, sx), colour cell m and channel c:
//     G[b, sy, sx, m, c] = P[b, sy-1, sx-1, 3, m, c] + P[b, sy-1, sx, 2, m, c]
//                        + P[b, sy, sx-1, 1, m, c] + P[b, sy, sx, 0, m, c]
// added in that order (the reference's: p11, p10, p01, p00) from +0.0, a
// tile outside [0, nty) x [0, ntx) skipped.  P is [B, nty, ntx, 4, gc^3, C]
// f32, G the canonical grid [B, nty+1, ntx+1, gc^3, C] f32.
//
// Bound on the H100: bytes.  Every partial is read once and every grid
// element written once (704 MB + 223 MB at B 8, 8x8 tiles, gc 16, C 21:
// 0.277 ms at 3.35 TB/s); 3 adds per element.  So the kernel is a stream:
// it has to keep enough loads in flight and spend little else.
//
// Design: a unit of work is a node and a span of its cube (gc^3 C floats;
// `fold_plan` cuts each cube into `spans` spans of whole steps and hands
// the units to persistent blocks in even shares).  A block works out once
// a unit which tiles exist and the base address of each of the node's 1,
// 2 or 4 source cubes, in order; then it streams the span: a thread loads
// FOLD_UNROLL 16-byte words (where the cube is a multiple of 4 floats,
// so that every cube starts 16-byte aligned) or 4 x FOLD_UNROLL 4-byte
// words (an odd cube, such as gc 17 at C 33) from every source before it
// adds any.  Partials and grid move with evict-first loads and stores
// (`__ldcs`, `__stcs`): the partials are read once, and streaming the grid
// out measured faster on an H100 than default stores at every shape timed
// (batch 8 by ~5%), although the spatial matmul reads it next.  No integer
// division is done per element.  The adds are round-to-nearest from +0.0
// in the plain version's order, so the result equals the plain version
// bit for bit.
#include <cuda_runtime.h>

#define FOLD_THREADS 256
#define FOLD_UNROLL 2

__device__ __forceinline__ float4 fold_load(const float4* p) {
  return __ldcs(p);
}
__device__ __forceinline__ float fold_load(const float* p) {
  return __ldcs(p);
}
__device__ __forceinline__ float4 fold_add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float fold_add(float a, float b) {
  return __fadd_rn(a, b);
}

// dst[i] = +0.0 + src[0][i] + ... + src[N-1][i] for i in [i0, i1), V a
// float4 (i counts float4s) or a float.
template <typename V, int N, int U>
__device__ __forceinline__ void fold_span(const V* const* src, V* dst,
                                          int i0, int i1) {
  const V zero = V();
  for (int i = i0 + (int)threadIdx.x; i < i1; i += FOLD_THREADS * U) {
    V v[N][U];
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = i + u * FOLD_THREADS;
        v[k][u] = j < i1 ? fold_load(src[k] + j) : zero;
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = i + u * FOLD_THREADS;
      V acc = zero;
#pragma unroll
      for (int k = 0; k < N; ++k) acc = fold_add(acc, v[k][u]);
      if (j < i1) __stcs(dst + j, acc);
    }
  }
}

// The N source cubes of a node in the fold's order: tiles (ty0 + m / nc,
// tx0 + m % nc), m = 0 .. N-1, each at its corner (sy - ty)*2 + (sx - tx).
template <typename V, int N, int U>
__device__ __forceinline__ void fold_node(const float* part, float* grid,
                                          int b, int sy, int sx, int nty,
                                          int ntx, int ty0, int tx0, int nc,
                                          long long node, int cube, int i0,
                                          int i1) {
  const V* src[N];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const int ty = ty0 + (nc == 2 ? m >> 1 : m);
    const int tx = tx0 + (nc == 2 ? (m & 1) : 0);
    const long long cube_index = ((long long)(b * nty + ty) * ntx + tx) * 4
                                 + (sy - ty) * 2 + (sx - tx);
    src[m] = reinterpret_cast<const V*>(part + cube_index * cube);
  }
  fold_span<V, N, U>(src, reinterpret_cast<V*>(grid + node * cube), i0, i1);
}

template <typename V, int U>
__global__ void __launch_bounds__(FOLD_THREADS, 4) bilateral_fold_kernel(
    const float* __restrict__ part, float* __restrict__ grid, int gy, int gx,
    int cube, int span, int spans, int units, int per) {
  const int nty = gy - 1, ntx = gx - 1;
  const int per_v = (int)(sizeof(V) / sizeof(float));  // floats a word
  const int u1 = min(units, ((int)blockIdx.x + 1) * per);
  for (int unit = blockIdx.x * per; unit < u1; ++unit) {
    const int node = unit / spans, s = unit - node * spans;
    const int r = node / gx, sx = node - r * gx;
    const int b = r / gy, sy = r - b * gy;
    // rows sy-1 and sy, columns sx-1 and sx, where they are tiles
    const int ty0 = sy > 0 ? sy - 1 : 0, tx0 = sx > 0 ? sx - 1 : 0;
    const int nr = (sy > 0 && sy < nty) ? 2 : 1;
    const int nc = (sx > 0 && sx < ntx) ? 2 : 1;
    const int e0 = s * span, e1 = min(cube, e0 + span);
    const int i0 = e0 / per_v, i1 = e1 / per_v;
    switch (nr * nc) {
      case 1:
        fold_node<V, 1, U>(part, grid, b, sy, sx, nty, ntx, ty0, tx0, nc,
                           node, cube, i0, i1);
        break;
      case 2:
        fold_node<V, 2, U>(part, grid, b, sy, sx, nty, ntx, ty0, tx0, nc,
                           node, cube, i0, i1);
        break;
      default:
        fold_node<V, 4, U>(part, grid, b, sy, sx, nty, ntx, ty0, tx0, nc,
                           node, cube, i0, i1);
    }
  }
}

// vec 4: float4 words (cube % 4 == 0, span % 4 == 0, both pointers 16-byte
// aligned); vec 1: 4-byte words, FOLD_UNROLL x 4 of them a thread and
// step.  `blocks` blocks take `per` consecutive units each.
extern "C" int bilateral_fold(const void* part, void* grid, int gy, int gx,
                              int cube, int vec, int span, int spans,
                              int units, int blocks, int per, void* stream) {
  if (units == 0) return 0;
  if (gy < 2 || gx < 2 || cube < 1 || span < 1 || spans < 1 ||
      blocks < 1 || per < 1 || (long long)blocks * per < units ||
      (long long)spans * span < cube)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec == 4) {
    if (cube % 4 || span % 4 || (((unsigned long long)part |
                                  (unsigned long long)grid) & 15ULL))
      return (int)cudaErrorInvalidValue;
    bilateral_fold_kernel<float4, FOLD_UNROLL><<<blocks, FOLD_THREADS, 0,
                                                 st>>>(
        (const float*)part, (float*)grid, gy, gx, cube, span, spans, units,
        per);
  } else if (vec == 1) {
    bilateral_fold_kernel<float, 4 * FOLD_UNROLL><<<blocks, FOLD_THREADS, 0,
                                                    st>>>(
        (const float*)part, (float*)grid, gy, gx, cube, span, spans, units,
        per);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
