// bilateral_fold_blur — fold of the per-tile splat partials fused with the
// colour blur, for sm_90a (the v1 route's fused path).
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py:537 `_combine_blur_kernel` (fold
// the 4 neighbouring tiles' corner partials into one node's cube in VMEM,
// then blur it along cr, cg and cb; call :961).
//
// Computes, for every image b and node (sy, sx), the cube
//     F[m, c] = P[b, sy-1, sx-1, 3, m, c] + P[b, sy-1, sx, 2, m, c]
//             + P[b, sy, sx-1, 1, m, c] + P[b, sy, sx, 0, m, c]
// (that order from +0.0, tiles outside the image skipped:
// `bilateral_fold`), and then its radius-2 blur along cr, cg, cb with zero
// fill (`bilateral_cube_blur`).  P is [B, nty, ntx, 4, gc^3, C] f32, the
// result the canonical grid [B, nty+1, ntx+1, gc, gc, gc, C] f32.
//
// Bound on the H100: bytes.  The partials must be read once and the grid
// written once (704 MB + 223 MB at B 8, 8x8 tiles, gc 16, C 21; 48 MB +
// 4 MB at SEC's 5x7 tiles); the folded cube never reaches device memory.
//
// Design (cube_plane_blur.cuh): the four partials' cr-planes of a node
// (contiguous spans, like the grid's) land with 16-byte cp.async copies in
// a landing area while the blocks blur the planes before them; each is
// folded once, as the cr pass first needs it, into a ring of five folded
// planes, and blurred there.  Every partial byte is read once in full
// 32-byte sectors, with no C-strided words, and each output plane is
// written once.  Persistent blocks walk (node, cr slab, channel group)
// units; the planner (kernels/bilateral.py: cube_blur_plan) cuts SEC's 48
// nodes into slabs and planes too large for a landing area and a ring
// (C 40, C 64, gc 24 C 42) into groups of up to 8 channels.  Bit-equal to
// the plain version.
#include "cube_plane_blur.cuh"

// The geometry comes from the wrapper's planner, as bilateral_cube_blur's;
// buf_ring is where the ring of folded planes starts, behind `in_flight`
// landing planes of 4 slots.
extern "C" int bilateral_fold_blur(const void* part, void* out, int B, int gy,
                                   int gx, int gc, int C, int nc, int groups,
                                   int slabs, int nl, int in_flight,
                                   int reg_rows, int slot, int buf_ring,
                                   int buf_a, int buf_b, int smem,
                                   int blocks, int threads, float t0,
                                   float t1, float t2, void* stream) {
  const long long nodes = (long long)B * gy * gx;
  CubeBlurArgs a;
  a.in = (const float*)part;
  a.out = (float*)out;
  a.total = (long long)B * (gy - 1) * (gx - 1) * 4 * gc * gc * gc *
            (long long)C;
  a.units = nodes * slabs * groups;
  a.gy = gy;
  a.gx = gx;
  a.gc = gc;
  a.C = C;
  a.nc = nc;
  a.groups = groups;
  a.slabs = slabs;
  a.nl = nl;
  a.slot = slot;
  a.buf_ring = buf_ring;
  a.buf_a = buf_a;
  a.buf_b = buf_b;
  a.t0 = t0;
  a.t1 = t1;
  a.t2 = t2;
  return cube_plane_blur<true>(a, in_flight, reg_rows, smem, blocks, threads,
                               (cudaStream_t)stream);
}
