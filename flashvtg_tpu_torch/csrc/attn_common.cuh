// Helpers shared by the attention kernels of this directory: the head
// layout, float4 loads and stores, warp reductions, cp.async, and the
// backward kernels' q.k / dO.v tile loop.

#pragma once

#include <cuda_runtime.h>

constexpr int kDh = 32;            // head dim
constexpr int kRowsPerWarp = 8;    // query rows a warp owns in a tile
constexpr int kKStride = kDh + 4;  // K (and the backward's V) rows in shared memory, padded

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 scaled(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// acc[0 .. 3] += g x
__device__ __forceinline__ void axpy4(float* acc, float g, float4 x) {
  acc[0] = fmaf(g, x.x, acc[0]);
  acc[1] = fmaf(g, x.y, acc[1]);
  acc[2] = fmaf(g, x.z, acc[2]);
  acc[3] = fmaf(g, x.w, acc[3]);
}

// 16-byte copy from device memory to shared memory that bypasses the
// registers (cp.async, sm_80 and later); completion is awaited per group.
__device__ __forceinline__ void cp_async16(float* smem_dst, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most the newest committed group is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The backward kernels' recomputation: for the warp's kRowsPerWarp rows of
// the scaled Q tile q_w and the dO tile do_w (row stride kDh), and this
// lane's KPL keys lane + 32 t of k_s and v_s (row stride kKStride),
// s = q.k and dpv = dO.v, in registers.
template <int KPL>
__device__ __forceinline__ void qk_dov(const float* q_w, const float* do_w, const float* k_s,
                                       const float* v_s, float (&s)[kRowsPerWarp][KPL],
                                       float (&dpv)[kRowsPerWarp][KPL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      s[r][t] = 0.f;
      dpv[r][t] = 0.f;
    }
#pragma unroll
  for (int c = 0; c < kDh; c += 4) {
    float4 kk[KPL], vv[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      kk[t] = ld4(k_s + (lane + 32 * t) * kKStride + c);
      vv[t] = ld4(v_s + (lane + 32 * t) * kKStride + c);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4 qq = ld4(q_w + r * kDh + c);
      const float4 oo = ld4(do_w + r * kDh + c);
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        s[r][t] = dot4(qq, kk[t], s[r][t]);
        dpv[r][t] = dot4(oo, vv[t], dpv[r][t]);
      }
    }
  }
}
