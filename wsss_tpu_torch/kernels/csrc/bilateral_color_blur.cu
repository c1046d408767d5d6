// bilateral_color_blur — colour-axis blur of the bilateral grid, sm_90a.
//
// Replaces: the blur half of wsss_tpu/ops/crf/mxu_grid.py
// `_combine_blur_kernel_v2` (radius-2 separable blur along cr, cg and cb
// with zero fill; the v2 layout's padded cb slots are never sliced, so
// its blur equals zero fill on [0, gc)).
//
// Computes, on the canonical grid [B, gy, gx, gc, gc, gc, C] (f32, C
// innermost), along cr, then cg, then cb of every node's cube:
//     out[k] = t0*in[k] + t1*(in[k+1] + in[k-1]) + t2*(in[k+2] + in[k-2])
// with zero outside [0, gc), in one launch.
//
// Bound on the H100: bytes.  The function must read the grid once and
// write it once (2 x 223 MB at the VOC batch-8 config); 27 flops per
// element are far below the card's rate.
//
// Design: a node's cube is one contiguous span and its cr-planes are
// contiguous gc*gc*C spans (21.5 KB at gc 16, C 21).  A block streams
// cr-planes through a ring of 5 + F slots in shared memory: the 5 input
// planes one output plane's cr taps need and F planes in flight, copied
// with 16-byte cp.async (ring_copy.cuh).  For each output plane it blurs
// cr from the ring into the work plane A with 16-byte shared-memory
// accesses; then a thread takes one (cg, channel) row of gc cb cells,
// blurs it along cg from A into registers and along cb in registers, and
// stores it.  Every input plane is read from device memory once, with no
// halo, and every output plane written once; a warp's stores cover runs
// of C consecutive floats.  A carries two zero cg-rows at each end, so
// the cg taps need no bounds test.  Blocks are persistent: each walks its
// units (node, channel group) in turn and its ring runs on across them,
// so the next unit's planes are in flight while the last one's are
// blurred.
//
// What this leaves on the table: the cg and cb passes run on one thread
// a (cg, channel) row, 336 of a block's 512 threads at gc 16 and C 21,
// each a chain of gc cells; with one block an SM that phase takes longer
// than the plane's copy.
//
// The wrapper's planner (kernels/bilateral.py: color_blur_plan) sets the
// geometry: whole planes of all C channels where 5 + F of them fit a
// block, else groups of >= 8 consecutive channels, copied as runs into a
// dense [gc*gc][nc] slot (the v2 route's largest plane, gc 24 and C 32,
// is 74 KB).  Group blocks of one node run side by side, so the sectors
// they share meet in L2.
//
// Every pass is the plain version's expression with round-to-nearest
// intrinsics (no FMA contraction), cr then cg then cb per element, so the
// result equals the plain PyTorch version bit for bit.
#include "ring_copy.cuh"

__device__ __forceinline__ float blur5(float c0, float up1, float dn1,
                                       float up2, float dn2, float t0,
                                       float t1, float t2) {
  float acc = __fmul_rn(t0, c0);
  acc = __fadd_rn(acc, __fmul_rn(t1, __fadd_rn(up1, dn1)));
  return __fadd_rn(acc, __fmul_rn(t2, __fadd_rn(up2, dn2)));
}

// gc of the largest cube a block blurs: the v2 route admits gc <= 24
#define COLOR_BLUR_MAX_GC 24

template <int F>
__global__ void __launch_bounds__(512, 1) bilateral_color_blur_kernel(
    const float* __restrict__ in, float* __restrict__ out, long long total,
    long long units, int gc, int C, int nc, int groups, int slot, int buf_a,
    float t0, float t1, float t2) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = 5 + F;
  float* ring = smem;
  const long long cube = (long long)gc * gc * gc * C;
  const int plane = gc * gc * C;             // a cr-plane in device memory
  const long long nb = gridDim.x;
  const long long nq = (units - blockIdx.x + nb - 1) / nb;

  // unit q of this block: node, first channel, channels
  auto unit = [&](long long q, long long& node, int& c0, int& ncu) {
    const long long u = blockIdx.x + q * nb;
    node = u / groups;
    c0 = (int)(u - node * groups) * nc;
    ncu = min(nc, C - c0);
  };
  // the next plane to copy: plane il of unit iq, into ring slot is
  long long iq = 0, inode;
  int il = 0, is = 0, ic0, incu;
  unit(0, inode, ic0, incu);
  auto issue_next = [&]() {
    if (iq < nq) {
      const long long g0 = inode * cube + (long long)il * plane + ic0;
      if (groups == 1)
        copy_window(ring + is * slot, in, g0, plane, 0, total);
      else
        copy_runs(ring + is * slot, in + g0, gc * gc, incu, C);
      if (++il == gc) {
        il = 0;
        if (++iq < nq) unit(iq, inode, ic0, incu);
      }
    }
    ring_commit();
    is = is + 1 == R ? 0 : is + 1;
  };

  long long issued = 0;
  int ps = 0;                                // ring slot of the plane blurred
  for (long long q = 0; q < nq; ++q) {
    long long node;
    int c0, ncu;
    unit(q, node, c0, ncu);
    const int row = gc * ncu;                // a cg row of the dense plane
    const int pl = gc * row;                 // the dense plane
    // A: [gc + 4][row], cg rows -2 .. gc+1, rows 2 .. gc+1 16-byte aligned
    float* A = smem + buf_a + ((4 - (2 * row) % 4) % 4);
    float* a = A + 2 * row;
    const FastDiv by_nc(ncu);
    for (int l = 0; l < gc; ++l, ps = ps + 1 == R ? 0 : ps + 1) {
      const long long pos = q * gc + l;
      __syncthreads();                       // the ring slot to refill is read
      for (; issued <= pos + 2 + F; ++issued) issue_next();
      ring_wait<F>();
      if (l == 0) {                          // zero rows of this unit's A
        for (int i = threadIdx.x; i < 2 * row; i += blockDim.x) {
          A[i] = 0.0f;
          a[pl + i] = 0.0f;
        }
      }
      __syncthreads();

      // cr: ring -> A; planes outside the cube are zero
      const float* src[5];
      bool ok[5];
      bool wide = true;                      // every tap 16-byte aligned
#pragma unroll
      for (int d = 0; d < 5; ++d) {
        const int ld = l + d - 2;
        ok[d] = ld >= 0 && ld < gc;
        const int o = groups == 1 ? window_offset(
                                        in, node * cube + (long long)ld * plane)
                                  : 0;
        wide = wide && (!ok[d] || o == 0);
        src[d] = ring + ((ps + d + R - 2) % R) * slot + o;
      }
      auto cr = [&](int e) {
        return blur5(src[2][e], ok[3] ? src[3][e] : 0.0f,
                     ok[1] ? src[1][e] : 0.0f, ok[4] ? src[4][e] : 0.0f,
                     ok[0] ? src[0][e] : 0.0f, t0, t1, t2);
      };
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
        reinterpret_cast<float4*>(a)[v] = r;
      }
      for (int e = 4 * nv + threadIdx.x; e < pl; e += blockDim.x) a[e] = cr(e);
      __syncthreads();

      // cg, then cb: a thread takes one (cg, channel) row of cb cells,
      // blurs it along cg from A (whose pad rows are zero) into
      // registers, along cb there, and stores it
      float* o = out + node * cube + (long long)l * plane + c0;
      for (int t = threadIdx.x; t < row; t += blockDim.x) {
        const int cg = by_nc.div(t), c = t - cg * ncu;
        const float* s = a + cg * row + c;
        float v[COLOR_BLUR_MAX_GC];
#pragma unroll
        for (int cb = 0; cb < COLOR_BLUR_MAX_GC; ++cb) {
          const float* sc = s + cb * ncu;
          v[cb] = cb < gc ? blur5(sc[0], sc[row], sc[-row], sc[2 * row],
                                  sc[-2 * row], t0, t1, t2)
                          : 0.0f;
        }
        float* oc = o + (long long)cg * gc * C + c;
#pragma unroll
        for (int cb = 0; cb < COLOR_BLUR_MAX_GC; ++cb) {
          if (cb < gc)
            oc[(long long)cb * C] = blur5(
                v[cb], cb + 1 < gc && cb + 1 < COLOR_BLUR_MAX_GC ? v[cb + 1] : 0.0f,
                cb >= 1 ? v[cb - 1] : 0.0f,
                cb + 2 < gc && cb + 2 < COLOR_BLUR_MAX_GC ? v[cb + 2] : 0.0f,
                cb >= 2 ? v[cb - 2] : 0.0f, t0, t1, t2);
        }
      }
    }
  }
  ring_wait<0>();
}

template <int F>
static int launch(const float* in, float* out, long long total,
                  long long units, int gc, int C, int nc, int groups,
                  int slot, int buf_a, int smem, int blocks, int threads,
                  float t0, float t1, float t2, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bilateral_color_blur_kernel<F>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bilateral_color_blur_kernel<F><<<blocks, threads, smem, stream>>>(
      in, out, total, units, gc, C, nc, groups, slot, buf_a, t0, t1, t2);
  return (int)cudaGetLastError();
}

// The geometry comes from the wrapper's planner: `nc` channels a group
// (`groups` groups), `in_flight` planes in flight, ring slots of `slot`
// floats, A from float offset buf_a, `smem` bytes of dynamic shared
// memory, `blocks` persistent blocks of `threads`.
extern "C" int bilateral_color_blur(const void* in, void* out, long long nodes,
                                    int gc, int C, int nc, int groups,
                                    int in_flight, int slot, int buf_a,
                                    int smem, int blocks, int threads,
                                    float t0, float t1, float t2,
                                    void* stream) {
  if (nodes == 0 || C == 0) return 0;
  if (gc < 1 || gc > COLOR_BLUR_MAX_GC || blocks < 1 || threads < 32 ||
      threads > 512 || nc < 1 || (long long)groups * nc < C)
    return (int)cudaErrorInvalidConfiguration;
  const long long units = nodes * groups;
  if (blocks > units) blocks = (int)units;
  const long long total = nodes * gc * gc * gc * (long long)C;
  const float* i = (const float*)in;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (in_flight) {
    case 1:
      return launch<1>(i, o, total, units, gc, C, nc, groups, slot, buf_a,
                       smem, blocks, threads, t0, t1, t2, s);
    case 2:
      return launch<2>(i, o, total, units, gc, C, nc, groups, slot, buf_a,
                       smem, blocks, threads, t0, t1, t2, s);
    case 3:
      return launch<3>(i, o, total, units, gc, C, nc, groups, slot, buf_a,
                       smem, blocks, threads, t0, t1, t2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
