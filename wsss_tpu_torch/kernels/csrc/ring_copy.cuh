// ring_copy.cuh — asynchronous copies from device memory into a ring of
// shared-memory slots, shared by bilateral_color_blur.cu,
// flat_color_blur.cu and cube_plane_blur.cuh (the v1 route's cube blurs).
//
// The kernels stream a block's input through a ring: the slots the
// current step reads, plus F steps in flight.  A step's copies are one
// cp.async group; `ring_wait<F>` leaves the F newest groups in flight and
// waits for the rest, and a __syncthreads after it makes every thread's
// copies visible to the block.
//
// copy_window copies a contiguous span with 16-byte `cp.async.cg` copies.
// A span's start is rounded down to a 16-byte boundary of device memory
// and the span lands at an offset of 0-3 floats in its slot
// (`window_offset`).  Whatever lies outside [lo, hi) — the stripe or the
// tensor — is zero in the slot: a chunk wholly outside is zeroed with a
// shared-memory store, a chunk that straddles an end is copied float by
// float with 4-byte `cp.async.ca` copies and zeros.  No address outside
// [lo, hi) is read.
//
// copy_runs copies `runs` runs of `n` floats at a stride of `stride`
// floats into a dense [runs][n] slot: 16-byte copies where the runs are
// 16-byte aligned, else 4-byte copies.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Float offset (0-3) in its slot of the span that starts at element g of
// `base`: the span's address modulo 16 bytes.
__device__ __forceinline__ int window_offset(const float* base,
                                             long long g) {
  return (int)((((unsigned long long)base >> 2) + (unsigned long long)g) &
               3ULL);
}

// base[g0 .. g0 + n) -> dst[o .. o + n), o = window_offset(base, g0); dst
// is 16-byte aligned and holds o + n floats rounded up to 4.  Elements
// outside [lo, hi) are zero.  All threads of the block take part.
__device__ __forceinline__ void copy_window(float* dst, const float* base,
                                            long long g0, int n,
                                            long long lo, long long hi) {
  const int o = window_offset(base, g0);
  const long long c0 = g0 - o;               // 16-byte aligned element
  const int chunks = (o + n + 3) >> 2;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const long long e = c0 + 4LL * i;
    float* d = dst + 4 * i;
    if (e >= lo && e + 4 <= hi) {
      cp_async16(d, base + e);
    } else if (e + 4 <= lo || e >= hi) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (e + q >= lo && e + q < hi)
          cp_async4(d + q, base + e + q);
        else
          d[q] = 0.0f;
      }
    }
  }
}

// q = i / d for i * d < 2^32, with one wide multiply (m = ceil(2^32 / d)).
struct FastDiv {
  unsigned long long m;
  __device__ explicit FastDiv(int d)
      : m(((1ULL << 32) + (unsigned long long)d - 1) / (unsigned long long)d) {}
  __device__ __forceinline__ int div(int i) const {
    return (int)(((unsigned long long)(unsigned)i * m) >> 32);
  }
};

// runs x n floats at src + r * stride -> dst[r * n + j].  dst is 16-byte
// aligned.
__device__ __forceinline__ void copy_runs(float* dst, const float* src,
                                          int runs, int n, int stride) {
  const bool wide = ((((unsigned long long)src) & 15ULL) == 0) &&
                    (n % 4 == 0) && (stride % 4 == 0);
  if (wide) {
    const int per = n >> 2;
    const FastDiv dv(per);
    for (int i = threadIdx.x; i < runs * per; i += blockDim.x) {
      const int r = dv.div(i), k = i - r * per;
      cp_async16(dst + 4 * i, src + (long long)r * stride + 4 * k);
    }
  } else {
    const FastDiv dv(n);
    for (int i = threadIdx.x; i < runs * n; i += blockDim.x) {
      const int r = dv.div(i), k = i - r * n;
      cp_async4(dst + i, src + (long long)r * stride + k);
    }
  }
}
