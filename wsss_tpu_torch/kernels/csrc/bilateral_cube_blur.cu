// bilateral_cube_blur — one-pass colour blur of the bilateral grid, for
// sm_90a (the v1 route's unfused path and the aligned grid).
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py:515 `_color_blur_kernel` (radius-2
// separable blur over the three colour axes of one node's [gc, gc, gc*C]
// cube, the whole cube in VMEM; calls :1040 and :1389).
//
// Computes, on the canonical grid [B, gy, gx, gc, gc, gc, C] (f32, C
// innermost), along cr, then cg, then cb of every node's cube:
//     out[k] = t0*in[k] + t1*(in[k+1] + in[k-1]) + t2*(in[k+2] + in[k-2])
// with zero outside [0, gc), in one launch.
//
// Bound on the H100: bytes.  The grid must be read once and written once
// (2 x 223 MB at B 8, 9x9 nodes, gc 16, C 21); 27 flops per element are
// far below the card's rate.
//
// Design (cube_plane_blur.cuh): whole cr-planes of all C channels (a
// contiguous span each) stream through a ring of 16-byte cp.async copies
// on persistent blocks, so every input byte is read once in full 32-byte
// sectors, the next unit's planes are in flight while the last one's are
// blurred, and each output plane is written once.  The planner
// (kernels/bilateral.py: cube_blur_plan) cuts a node into cr slabs where
// there are too few nodes to fill the card (SEC's 48), into groups of 8
// channels where a ring of whole planes does not fit (C 40 at gc 16: two
// blocks an SM), and blurs cg and cb in registers for whole planes up to
// gc 24, element by element in shared memory for groups, C 1 and larger
// cubes (gc 52, 64).  Bit-equal to the plain version.
#include "cube_plane_blur.cuh"

// The geometry comes from the wrapper's planner: nc channels a group,
// `slabs` slabs of nl cr-planes, `in_flight` planes in flight, slots of
// `slot` floats, A and B from float offsets buf_a and buf_b, `smem` bytes
// of dynamic shared memory, at most `blocks` persistent blocks of
// `threads`, the register row phase where `reg_rows`.
extern "C" int bilateral_cube_blur(const void* in, void* out, long long nodes,
                                   int gc, int C, int nc, int groups,
                                   int slabs, int nl, int in_flight,
                                   int reg_rows, int slot, int buf_a,
                                   int buf_b, int smem, int blocks,
                                   int threads, float t0, float t1, float t2,
                                   void* stream) {
  CubeBlurArgs a;
  a.in = (const float*)in;
  a.out = (float*)out;
  a.total = nodes * gc * gc * gc * (long long)C;
  a.units = nodes * slabs * groups;
  a.gy = a.gx = 1;
  a.gc = gc;
  a.C = C;
  a.nc = nc;
  a.groups = groups;
  a.slabs = slabs;
  a.nl = nl;
  a.slot = slot;
  a.buf_ring = 0;
  a.buf_a = buf_a;
  a.buf_b = buf_b;
  a.t0 = t0;
  a.t1 = t1;
  a.t2 = t2;
  return cube_plane_blur<false>(a, in_flight, reg_rows, smem, blocks,
                                threads, (cudaStream_t)stream);
}
