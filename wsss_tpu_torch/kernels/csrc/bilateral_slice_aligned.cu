// bilateral_slice_aligned — slice of the aligned bilateral grid, sm_90a.
//
// Replaces: wsss_tpu/ops/crf/mxu_grid.py `_slice_aligned_kernel` (:1203,
// called at :1411): per tile row, a one-hot matmul against the tile's own
// cell slab, a lane mask and a group-sum matmul.
//
// Computes, for every image b, pixel p = (y, x) and channel c:
//     out[b, p, c] = G[b, y / t, x / t, cell(p), c]
// a pure gather from the canonical grid [B, nty, ntx, gc, gc, gc, C]
// (f32, C innermost) at the pixel's own tile and nearest colour cell
// cell(p) = (cr*gc + cg)*gc + cb.  Output [B, H, W, C] f32 is the cropped
// image directly: pad pixels of the TPU layout are never computed.
//
// Bound on the H100: bytes.  It reads the grid entries the pixels touch
// (at most C per pixel, fewer where pixels of a tile share a cell), the
// cell map once and writes the output once; no arithmetic.
//
// Design: the TPU kernel gathers with one-hot matmuls because it has no
// fast gather.  Here a warp takes a run of 32 consecutive pixels of the
// flat [B*H*W] order (a run may cross image rows, so a ragged width costs
// nothing).  Lane i loads cell[p0 + i] once, in one coalesced load, and
// computes that pixel's grid row.  The warp then copies the run's 32*C
// floats, which are contiguous in the output and start at a 16-byte
// boundary (p0 is a multiple of 32): lane l takes float4 v = k*32 + l,
// elements e = 4v .. 4v+3, each from pixel e / C (its row from a
// __shfl_sync) and channel e % C.  A thread issues the loads of
// SLICE_UNROLL float4s before it stores any, so it has 16 independent
// gathers in flight, not one.  A copy has no rounding, so the result is
// bit-equal to the plain version.
#include "ring_copy.cuh"

#define SLICE_UNROLL 4

__global__ void __launch_bounds__(256) bilateral_slice_aligned_kernel(
    const float* __restrict__ grid, const int* __restrict__ cell,
    float* __restrict__ out, long long P, int H, int W, int C, int t,
    int nty, int ntx, int gc3) {
  const int lane = threadIdx.x & 31;
  const FastDiv by_c(C);
  const long long runs = (P + 31) >> 5;
  const long long step = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long run = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       run < runs; run += step) {
    const long long p0 = run << 5;
    const int n = (int)min(32LL, P - p0);
    int row = 0;                                   // grid row of pixel lane
    if (lane < n) {
      const long long p = p0 + lane;
      long long bh, b;
      if (P <= 2147483647LL) {                     // 32-bit divisions
        bh = (unsigned)p / (unsigned)W;
        b = (unsigned)bh / (unsigned)H;
      } else {
        bh = p / W;
        b = bh / H;
      }
      const int xx = (int)(p - bh * W), y = (int)(bh - b * H);
      row = (int)(((b * nty + y / t) * ntx + xx / t) * gc3) + cell[p];
    }
    const int total = n * C;
    const int nv = total >> 2;
    float4* o4 = reinterpret_cast<float4*>(out + p0 * C);
    for (int v0 = 0; v0 < nv; v0 += 32 * SLICE_UNROLL) {
      float4 val[SLICE_UNROLL];
#pragma unroll
      for (int u = 0; u < SLICE_UNROLL; ++u) {
        const int v = v0 + u * 32 + lane;
        float f[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 4 * v + j;
          const int i = by_c.div(e);
          const int r = __shfl_sync(0xffffffffu, row, i & 31);
          f[j] = v < nv ? grid[(long long)r * C + (e - i * C)] : 0.0f;
        }
        val[u] = make_float4(f[0], f[1], f[2], f[3]);
      }
#pragma unroll
      for (int u = 0; u < SLICE_UNROLL; ++u) {
        const int v = v0 + u * 32 + lane;
        if (v < nv) o4[v] = val[u];
      }
    }
    // the last run's 0-3 floats past its last float4
    const int e = 4 * nv + lane;
    const int i = by_c.div(e);
    const int r = __shfl_sync(0xffffffffu, row, i & 31);
    if (e < total) out[p0 * C + e] = grid[(long long)r * C + (e - i * C)];
  }
}

extern "C" int bilateral_slice_aligned(const void* grid, const void* cell,
                                       void* out, int B, int H, int W,
                                       int C, int t, int nty, int ntx,
                                       int gc3, void* stream) {
  const long long P = (long long)B * H * W;
  if (P * C == 0) return 0;
  // grid rows and a run's floats are 32-bit; the output is 16-byte aligned
  if ((long long)B * nty * ntx * gc3 > 2147483647LL || C > 8192 ||
      t < 1 || ((unsigned long long)out & 15ULL))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = ((P + 31) / 32 * 32 + threads - 1) / threads;
  bilateral_slice_aligned_kernel<<<
      (unsigned int)(blocks < 1048576 ? blocks : 1048576), threads, 0,
      (cudaStream_t)stream>>>((const float*)grid, (const int*)cell,
                              (float*)out, P, H, W, C, t, nty, ntx, gc3);
  return (int)cudaGetLastError();
}
