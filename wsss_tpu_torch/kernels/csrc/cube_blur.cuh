// cube_blur.cuh — the radius-2 blur of one node's colour cube in shared
// memory, shared by bilateral_fold_blur.cu and bilateral_cube_blur.cu.
//
// A block blurs `nc` channels of `planes` cr-planes of one node's
// [gc, gc, gc, C] cube (C innermost in device memory) along cr, cg and cb,
// zero fill outside [0, gc):
//     out[k] = t0*in[k] + t1*(in[k+1] + in[k-1]) + t2*(in[k+2] + in[k-2]).
// It loads its planes plus a 2-plane halo on each side through `load`
// (which the two kernels differ in), blurs cr from buffer A into buffer B,
// cg from B back into A, cb from A into B, and stores B: the cube is read
// once and written once.  Shared memory: nc * (2*planes + 4) * gc^2
// floats, channel-major so that a pass's threads walk neighbouring words;
// loads and stores walk device memory with the channel fastest.  A cube
// too large for one block is cut along cr; only the halo planes are then
// loaded twice.
//
// Blocks are numbered with the channel group fastest and the node slowest
// (CubeBlock), so the blocks that share a node's 32-byte sectors run at
// the same time and meet in L2.  With the node fastest they ran a whole
// grid apart and every sector came from device memory once per group.
//
// Every pass is the plain version's expression with round-to-nearest
// intrinsics (no FMA contraction), cr then cg then cb per element, so the
// result equals the plain PyTorch version bit for bit however the cube is
// cut.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ float blur5(float c0, float up1, float dn1,
                                       float up2, float dn2, float t0,
                                       float t1, float t2) {
  float acc = __fmul_rn(t0, c0);
  acc = __fadd_rn(acc, __fmul_rn(t1, __fadd_rn(up1, dn1)));
  return __fadd_rn(acc, __fmul_rn(t2, __fadd_rn(up2, dn2)));
}

// Hands the block's threads the (row r, channel j) pairs of a slab, the
// channel fastest (the nc channels of a cell are neighbours in device
// memory), stepping a whole block at a time without a division.
struct RowChannelWalk {
  int r, j, dr, dj, nc;
  __device__ RowChannelWalk(int nc_)
      : r(threadIdx.x / nc_), j(threadIdx.x % nc_), dr(blockDim.x / nc_),
        dj(blockDim.x % nc_), nc(nc_) {}
  __device__ void next() {
    r += dr;
    j += dj;
    if (j >= nc) {
      j -= nc;
      ++r;
    }
  }
};

// What block blockIdx.x works on: channels [c0, c0 + nc) of cr-planes
// [l0, l0 + nl) of node `node`.
struct CubeBlock {
  long long node;
  int c0, nc, l0, nl;
  __device__ CubeBlock(int gc, int C, int nc_max, int planes) {
    const int groups = (C + nc_max - 1) / nc_max;
    const int slabs = (gc + planes - 1) / planes;
    long long i = blockIdx.x;
    c0 = (int)(i % groups) * nc_max;
    i /= groups;
    l0 = (int)(i % slabs) * planes;
    node = i / slabs;
    nc = min(nc_max, C - c0);
    nl = min(planes, gc - l0);
  }
};

// Blocks of a launch, or 0 when they do not fit gridDim.x.
inline unsigned int cube_blur_blocks(long long nodes, int gc, int C, int nc,
                                     int planes) {
  long long n = nodes * ((C + nc - 1) / nc) * ((gc + planes - 1) / planes);
  return n <= 2147483647LL ? (unsigned int)n : 0;
}

// load(e): element e = m*C + c of this node's (unblurred) cube.
// out: this node's cube in the output grid.
template <class Load>
__device__ __forceinline__ void cube_blur_block(
    const Load& load, float* __restrict__ out, const CubeBlock& blk, int gc,
    int C, float t0, float t1, float t2) {
  extern __shared__ float smem[];
  const int plane = gc * gc;
  const int c0 = blk.c0, nc = blk.nc, l0 = blk.l0, nl = blk.nl;
  const int sa = (nl + 4) * plane;           // a channel of A, with the halo
  const int sb = nl * plane;                 // a channel of B
  float* A = smem;                           // [nc][nl + 4][plane]
  float* B = smem + nc * sa;                 // [nc][nl][plane]

  // load: row r of A is cell m0 + r of the cube, zero outside it
  const int m0 = (l0 - 2) * plane, cells = plane * gc;
  for (RowChannelWalk w(nc); w.r < sa; w.next()) {
    int m = m0 + w.r;
    A[w.j * sa + w.r] =
        m >= 0 && m < cells ? load((long long)m * C + c0 + w.j) : 0.0f;
  }
  __syncthreads();
  // cr: A (with halo) -> B
  for (int j = 0; j < nc; ++j) {
    const float* a = A + j * sa + 2 * plane;
    float* b = B + j * sb;
    for (int r = threadIdx.x; r < sb; r += blockDim.x)
      b[r] = blur5(a[r], a[r + plane], a[r - plane], a[r + 2 * plane],
                   a[r - 2 * plane], t0, t1, t2);
  }
  __syncthreads();
  // cg: B -> A, now laid out like B; a thread keeps its (cg, cb)
  for (int rp = threadIdx.x; rp < plane; rp += blockDim.x) {
    const int cg = rp / gc;
    const bool u1 = cg + 1 < gc, d1 = cg >= 1, u2 = cg + 2 < gc, d2 = cg >= 2;
    for (int e = rp; e < nc * sb; e += plane) {
      const float* s = B + e;
      A[e] = blur5(s[0], u1 ? s[gc] : 0.0f, d1 ? s[-gc] : 0.0f,
                   u2 ? s[2 * gc] : 0.0f, d2 ? s[-2 * gc] : 0.0f, t0, t1,
                   t2);
    }
  }
  __syncthreads();
  // cb: A -> B
  for (int rp = threadIdx.x; rp < plane; rp += blockDim.x) {
    const int cb = rp % gc;
    const bool u1 = cb + 1 < gc, d1 = cb >= 1, u2 = cb + 2 < gc, d2 = cb >= 2;
    for (int e = rp; e < nc * sb; e += plane) {
      const float* s = A + e;
      B[e] = blur5(s[0], u1 ? s[1] : 0.0f, d1 ? s[-1] : 0.0f,
                   u2 ? s[2] : 0.0f, d2 ? s[-2] : 0.0f, t0, t1, t2);
    }
  }
  __syncthreads();
  // store: row r of B is cell l0*plane + r
  float* o = out + (long long)l0 * plane * C + c0;
  for (RowChannelWalk w(nc); w.r < sb; w.next())
    o[(long long)w.r * C + w.j] = B[w.j * sb + w.r];
}

inline size_t cube_blur_smem(int gc, int nc, int planes) {
  return (size_t)nc * (2 * planes + 4) * gc * gc * sizeof(float);
}
