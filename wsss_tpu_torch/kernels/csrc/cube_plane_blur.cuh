// cube_plane_blur.cuh — the v1 route's radius-2 colour blur of node cubes,
// streamed as whole cr-planes; shared by bilateral_cube_blur.cu (the grid
// in) and bilateral_fold_blur.cu (the four corner partials in, folded as
// they land).
//
// On the canonical grid [B, gy, gx, gc, gc, gc, C] (f32, C innermost) a
// node's cube is one contiguous span and its cr-planes contiguous
// gc*gc*C spans; a tile's corner partial [gc^3, C] is laid out the same.
// Along cr, then cg, then cb of every node's cube:
//     out[k] = t0*in[k] + t1*(in[k+1] + in[k-1]) + t2*(in[k+2] + in[k-2])
// with zero outside [0, gc).
//
// A unit of work is (node, slab of output cr-planes [l0, l1), group of
// channels [c0, c0 + ncu)).  Persistent blocks walk the units in turn
// (unit blockIdx.x + q * gridDim.x) and stream each unit's input planes
// (the slab and its 2-plane halo, inside the cube) with 16-byte cp.async
// copies (ring_copy.cuh): a whole plane of all C is one contiguous span;
// a group's plane is gc^2 runs of ncu channels, copied into a dense slot.
// The stream runs on across units, so the next unit's planes are in
// flight while the last one's are blurred.
//
//   * FOLD false: the planes land in a ring of 5 + F slots: the 5 an
//     output plane's cr taps read and F in flight.
//   * FOLD true: the four partials' planes (p11, p10, p01, p00 of the
//     tiles around the node; those outside the image are not read) land
//     in F landing slots of 4; as the cr pass first needs a plane, it is
//     folded, +0.0 then each partial added in that order, into a ring of
//     5 planes.  The folded cube never reaches device memory.
//
// For each output plane the cr pass reads the ring's 5 planes into the
// work plane A ([gc + 4][gc][ncu], two zero cg rows at each end, so the
// cg taps need no bounds test).  Then the row phase, one of two
// (REG_ROWS):
//   * a thread takes one (cg, channel) row of gc <= 24 cb cells, blurs it
//     along cg from A into registers and along cb there, and stores it
//     (bilateral_color_blur.cu's row phase), where a plane has rows for
//     at least half of 512 threads;
//   * element-parallel: cg from A into the plane B, then cb from B to the
//     output, one element a thread (any gc; C 1 and channel groups, whose
//     small planes let two or more blocks share an SM).
// Every output element is written once.  Every product and sum is the
// plain version's, with round-to-nearest intrinsics (no FMA contraction)
// in its order, so the result equals the plain PyTorch version bit for
// bit however the cube is cut.
//
// The geometry comes from the planner in kernels/bilateral.py
// (cube_blur_plan), which keeps the whole layout inside a block's shared
// memory.
#pragma once
#include "ring_copy.cuh"

__device__ __forceinline__ float blur5(float c0, float up1, float dn1,
                                       float up2, float dn2, float t0,
                                       float t1, float t2) {
  float acc = __fmul_rn(t0, c0);
  acc = __fadd_rn(acc, __fmul_rn(t1, __fadd_rn(up1, dn1)));
  return __fadd_rn(acc, __fmul_rn(t2, __fadd_rn(up2, dn2)));
}

// gc of the largest cube the register row phase takes
#define CUBE_BLUR_REG_GC 24

struct CubeBlurArgs {
  const float* in;       // grid [nodes][cube], or partials [tiles][4][cube]
  float* out;            // grid [nodes][cube]
  long long total;       // elements of `in`
  long long units;       // nodes * slabs * groups
  int gy, gx;            // nodes of an image (FOLD: tiles are gy-1, gx-1)
  int gc, C, nc, groups, slabs, nl;
  int slot;              // floats of a landing / ring slot
  int buf_ring, buf_a, buf_b;
  float t0, t1, t2;
};

// What unit u is: node, first output plane and end, channels.
struct CubeUnit {
  long long node;
  int l0, l1, c0, ncu, lo, hi;           // input planes [lo, hi)
  __device__ CubeUnit(const CubeBlurArgs& a, long long u) {
    const int g = (int)(u % a.groups);
    const long long r = u / a.groups;
    const int s = (int)(r % a.slabs);
    node = r / a.slabs;
    c0 = g * a.nc;
    ncu = min(a.nc, a.C - c0);
    l0 = s * a.nl;
    l1 = min(a.gc, l0 + a.nl);
    lo = max(0, l0 - 2);
    hi = min(a.gc, l1 + 2);
  }
};

// Element offset in `in` of corner k's (0..3: p11, p10, p01, p00) partial
// cube of a node, or -1 where that tile is outside the image.
__device__ __forceinline__ long long corner_cube(const CubeBlurArgs& a,
                                                 long long node, int k) {
  const long long cube = (long long)a.gc * a.gc * a.gc * a.C;
  const int sx = (int)(node % a.gx);
  const long long r = node / a.gx;
  const int sy = (int)(r % a.gy);
  const long long b = r / a.gy;
  const int nty = a.gy - 1, ntx = a.gx - 1;
  const int ty = sy - 1 + (k >> 1), tx = sx - 1 + (k & 1);
  if (ty < 0 || ty >= nty || tx < 0 || tx >= ntx) return -1;
  return (((b * nty + ty) * ntx + tx) * 4 + (3 - k)) * cube;
}

// Plane pl of a cube at element `base` of `in`, channels [c0, c0 + ncu),
// into dst: a whole plane at its 0-3 float offset, a group dense.
__device__ __forceinline__ void copy_plane(const CubeBlurArgs& a, float* dst,
                                           long long base, int pl, int c0,
                                           int ncu) {
  const int plane = a.gc * a.gc * a.C;
  const long long g0 = base + (long long)pl * plane;
  if (a.groups == 1)
    copy_window(dst, a.in, g0, plane, 0, a.total);
  else
    copy_runs(dst, a.in + g0 + c0, a.gc * a.gc, ncu, a.C);
}

// Blocks: 512 threads with the register row phase (one block an SM: its
// planes fill shared memory), else up to 256 threads at 64 registers, so
// that small planes (C 1, channel groups) run several blocks an SM.
template <int F, bool FOLD, bool REG_ROWS>
__global__ void __launch_bounds__(REG_ROWS ? 512 : 256, REG_ROWS ? 1 : 4)
    cube_plane_blur_kernel(const CubeBlurArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = FOLD ? 5 : 5 + F;       // ring slots the cr pass reads
  const int gc = a.gc, C = a.C;
  const long long cube = (long long)gc * gc * gc * C;
  const int plane = gc * gc * C;             // a cr-plane in device memory
  const long long nb = gridDim.x;
  const long long nq = (a.units - blockIdx.x + nb - 1) / nb;
  float* ring = smem + a.buf_ring;
  const int rslot = FOLD ? ((gc * gc * a.nc + 3) & ~3) : a.slot;
  const float t0 = a.t0, t1 = a.t1, t2 = a.t2;

  // the issue cursor: plane ip of unit iq, stream index `issued`; the
  // unit's cubes in `in` (FOLD: the four partials', -1 where absent)
  long long iq = 0, issued = 0;
  CubeUnit iu(a, blockIdx.x);
  int ip = iu.lo;
  long long ib[4];
  auto unit_bases = [&]() {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ib[k] = FOLD ? corner_cube(a, iu.node, k)
                   : (k == 0 ? iu.node * cube : -1);
  };
  unit_bases();
  auto issue_next = [&]() {
    if (iq < nq) {
      if (FOLD) {
        float* land = smem + (int)(issued % F) * 4 * a.slot;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (ib[k] >= 0)
            copy_plane(a, land + k * a.slot, ib[k], ip, iu.c0, iu.ncu);
      } else {
        copy_plane(a, ring + (int)(issued % R) * a.slot, ib[0], ip, iu.c0,
                   iu.ncu);
      }
      if (++ip == iu.hi && ++iq < nq) {
        iu = CubeUnit(a, blockIdx.x + iq * nb);
        ip = iu.lo;
        unit_bases();
      }
    }
    ring_commit();
    ++issued;
  };

  long long base = 0;                        // stream index of unit's lo
  long long folded = 0;                      // FOLD: next plane to fold
  if (FOLD)
    for (int k = 0; k < F; ++k) issue_next();
  for (long long q = 0; q < nq; ++q) {
    const CubeUnit u(a, blockIdx.x + q * nb);
    const int ncu = u.ncu;
    const int row = gc * ncu;                // a cg row of the dense plane
    const int pl = gc * row;                 // the dense plane
    // A: [gc + 4][row], cg rows -2 .. gc+1, rows 2 .. gc+1 16-byte aligned
    float* A = smem + a.buf_a + ((4 - (2 * row) % 4) % 4);
    float* ap = A + 2 * row;
    const FastDiv by_nc(ncu), by_gc(gc);
    long long cbase[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      cbase[k] = FOLD ? corner_cube(a, u.node, k) : -1;
    for (int l = u.l0; l < u.l1; ++l) {
      // stream index of the last input plane this output plane reads
      const long long need = base + min(l + 2, gc - 1) - u.lo;
      __syncthreads();                       // the last plane's reads done
      if (FOLD) {
        for (; folded <= need; ++folded) {
          ring_wait<F - 1>();                // plane `folded` has landed
          __syncthreads();
          const float* land = smem + (int)(folded % F) * 4 * a.slot;
          const int lp = u.lo + (int)(folded - base);
          const float* src[4];
          bool wide = (pl & 3) == 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int o = a.groups == 1 && cbase[k] >= 0
                              ? window_offset(a.in, cbase[k] +
                                                        (long long)lp * plane)
                              : 0;
            wide = wide && o == 0;
            src[k] = land + k * a.slot + o;
          }
          float* dst = ring + (int)(folded % 5) * rslot;
          if (wide) {
            for (int v = threadIdx.x; v < (pl >> 2); v += blockDim.x) {
              float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                if (cbase[k] < 0) continue;
                const float4 x = reinterpret_cast<const float4*>(src[k])[v];
                s.x = __fadd_rn(s.x, x.x);
                s.y = __fadd_rn(s.y, x.y);
                s.z = __fadd_rn(s.z, x.z);
                s.w = __fadd_rn(s.w, x.w);
              }
              reinterpret_cast<float4*>(dst)[v] = s;
            }
          } else {
            for (int e = threadIdx.x; e < pl; e += blockDim.x) {
              float s = 0.0f;
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if (cbase[k] >= 0) s = __fadd_rn(s, src[k][e]);
              dst[e] = s;
            }
          }
          __syncthreads();                   // the landing slot is free
          issue_next();
        }
      } else {
        for (; issued <= need + F; ) issue_next();
        ring_wait<F>();
      }
      if (l == u.l0) {                       // zero rows of this unit's A
        for (int i = threadIdx.x; i < 2 * row; i += blockDim.x) {
          A[i] = 0.0f;
          ap[pl + i] = 0.0f;
        }
      }
      __syncthreads();

      // cr: ring -> A; planes outside the cube are zero
      const float* src[5];
      bool ok[5];
      bool wide = (pl & 3) == 0;             // every tap 16-byte aligned
#pragma unroll
      for (int d = 0; d < 5; ++d) {
        const int ld = l + d - 2;
        ok[d] = ld >= 0 && ld < gc;
        const long long s = base + ld - u.lo;
        int o = 0;
        if (!FOLD && a.groups == 1 && ok[d])
          o = window_offset(a.in, u.node * cube + (long long)ld * plane);
        wide = wide && (!ok[d] || o == 0);
        src[d] = ring + (ok[d] ? (int)(s % R) : 0) * rslot + o;
      }
      const int nv = wide ? pl >> 2 : 0;
      for (int v = threadIdx.x; v < nv; v += blockDim.x) {
        float4 x[5];
#pragma unroll
        for (int d = 0; d < 5; ++d)
          x[d] = ok[d] ? reinterpret_cast<const float4*>(src[d])[v]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        float4 r;
        r.x = blur5(x[2].x, x[3].x, x[1].x, x[4].x, x[0].x, t0, t1, t2);
        r.y = blur5(x[2].y, x[3].y, x[1].y, x[4].y, x[0].y, t0, t1, t2);
        r.z = blur5(x[2].z, x[3].z, x[1].z, x[4].z, x[0].z, t0, t1, t2);
        r.w = blur5(x[2].w, x[3].w, x[1].w, x[4].w, x[0].w, t0, t1, t2);
        reinterpret_cast<float4*>(ap)[v] = r;
      }
      for (int e = 4 * nv + threadIdx.x; e < pl; e += blockDim.x)
        ap[e] = blur5(src[2][e], ok[3] ? src[3][e] : 0.0f,
                      ok[1] ? src[1][e] : 0.0f, ok[4] ? src[4][e] : 0.0f,
                      ok[0] ? src[0][e] : 0.0f, t0, t1, t2);
      __syncthreads();

      float* o = a.out + u.node * cube + (long long)l * plane + u.c0;
      if (REG_ROWS) {
        // cg, then cb: a thread takes one (cg, channel) row of cb cells,
        // blurs it along cg from A into registers, along cb there, and
        // stores it
        for (int t = threadIdx.x; t < row; t += blockDim.x) {
          const int cg = by_nc.div(t), c = t - cg * ncu;
          const float* s = ap + cg * row + c;
          float v[CUBE_BLUR_REG_GC];
#pragma unroll
          for (int cb = 0; cb < CUBE_BLUR_REG_GC; ++cb) {
            const float* sc = s + cb * ncu;
            v[cb] = cb < gc ? blur5(sc[0], sc[row], sc[-row], sc[2 * row],
                                    sc[-2 * row], t0, t1, t2)
                            : 0.0f;
          }
          float* oc = o + (long long)cg * gc * C + c;
#pragma unroll
          for (int cb = 0; cb < CUBE_BLUR_REG_GC; ++cb) {
            if (cb < gc)
              oc[(long long)cb * C] = blur5(
                  v[cb],
                  cb + 1 < gc && cb + 1 < CUBE_BLUR_REG_GC ? v[cb + 1] : 0.0f,
                  cb >= 1 ? v[cb - 1] : 0.0f,
                  cb + 2 < gc && cb + 2 < CUBE_BLUR_REG_GC ? v[cb + 2] : 0.0f,
                  cb >= 2 ? v[cb - 2] : 0.0f, t0, t1, t2);
          }
        }
      } else {
        // cg: A (whose pad rows are zero) -> B
        float* B = smem + a.buf_b;
        const int nw = (row & 3) == 0 ? pl >> 2 : 0;
        for (int v = threadIdx.x; v < nw; v += blockDim.x) {
          const float4* s = reinterpret_cast<const float4*>(ap) + v;
          const int r4 = row >> 2;
          const float4 c0 = s[0], u1 = s[r4], d1 = s[-r4], u2 = s[2 * r4],
                       d2 = s[-2 * r4];
          float4 r;
          r.x = blur5(c0.x, u1.x, d1.x, u2.x, d2.x, t0, t1, t2);
          r.y = blur5(c0.y, u1.y, d1.y, u2.y, d2.y, t0, t1, t2);
          r.z = blur5(c0.z, u1.z, d1.z, u2.z, d2.z, t0, t1, t2);
          r.w = blur5(c0.w, u1.w, d1.w, u2.w, d2.w, t0, t1, t2);
          reinterpret_cast<float4*>(B)[v] = r;
        }
        for (int e = 4 * nw + threadIdx.x; e < pl; e += blockDim.x) {
          const float* s = ap + e;
          B[e] = blur5(s[0], s[row], s[-row], s[2 * row], s[-2 * row], t0,
                       t1, t2);
        }
        __syncthreads();
        // cb: B -> the output, one element a thread
        for (int e = threadIdx.x; e < pl; e += blockDim.x) {
          const int r = by_nc.div(e), c = e - r * ncu;
          const int cb = r - by_gc.div(r) * gc;
          const float* s = B + e;
          o[(long long)r * C + c] = blur5(
              s[0], cb + 1 < gc ? s[ncu] : 0.0f, cb >= 1 ? s[-ncu] : 0.0f,
              cb + 2 < gc ? s[2 * ncu] : 0.0f, cb >= 2 ? s[-2 * ncu] : 0.0f,
              t0, t1, t2);
        }
      }
    }
    base += u.hi - u.lo;
  }
  ring_wait<0>();
}

template <int F, bool FOLD, bool REG_ROWS>
static int cube_plane_blur_launch(const CubeBlurArgs& a, int smem,
                                  int blocks, int threads,
                                  cudaStream_t stream) {
  auto kern = cube_plane_blur_kernel<F, FOLD, REG_ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // no more blocks than run at once: they are persistent
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (blocks > per_sm * sms) blocks = per_sm * sms;
  kern<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// One launch of the cube blur with the planner's geometry.
template <bool FOLD>
static int cube_plane_blur(const CubeBlurArgs& a, int in_flight,
                           int reg_rows, int smem, int blocks, int threads,
                           cudaStream_t s) {
  if (a.units == 0 || a.C == 0) return 0;
  if (a.gc < 1 || blocks < 1 || threads < 32 || threads > 512 || a.nc < 1 ||
      (long long)a.groups * a.nc < a.C || a.slabs < 1 ||
      (long long)a.slabs * a.nl < a.gc ||
      (reg_rows ? a.gc > CUBE_BLUR_REG_GC : threads > 256))
    return (int)cudaErrorInvalidConfiguration;
  const int b = blocks > a.units ? (int)a.units : blocks;
#define CUBE_BLUR_CASE(F)                                                   \
  case F:                                                                   \
    return reg_rows ? cube_plane_blur_launch<F, FOLD, true>(a, smem, b,     \
                                                            threads, s)     \
                    : cube_plane_blur_launch<F, FOLD, false>(a, smem, b,    \
                                                             threads, s);
  switch (in_flight) {
    CUBE_BLUR_CASE(1)
    CUBE_BLUR_CASE(2)
    CUBE_BLUR_CASE(3)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CUBE_BLUR_CASE
}
