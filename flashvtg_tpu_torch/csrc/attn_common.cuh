// Helpers shared by the attention kernels of this directory: the head
// layout, float4 loads and stores, cp.async, the 3xTF32 tensor-core
// products, and the flash kernels' key mask and staged key tiles.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kDh = 32;            // head dim
constexpr int kKStride = kDh + 4;  // rows of K, V, Q and dO in shared memory, padded

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

// ---- 3xTF32 products on the tensor cores ------------------------------------
//
// An f32 operand x is split into two TF32 values, hi = rna(x) and
// lo = rna(x - hi) (x - hi is exact in f32), so that x = hi + lo to about 22
// significant bits. A product a.b is then taken as lo_a.hi_b + hi_a.lo_b +
// hi_a.hi_b on mma.sync with f32 accumulators, the small terms first; the
// dropped lo_a.lo_b is below f32 rounding. This is CUTLASS's
// OpMultiplyAddFastF32, whose stated accuracy is that of f32 on CUDA cores. A
// single TF32 product (hi_a.hi_b) keeps about three decimal digits and is
// not used.
//
// mma.sync.m16n8k8 (tf32 in, f32 out) fragments, g = lane / 4, t = lane % 4:
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A C fragment feeds the next product as its A operand in registers as
// {c0, c2, c1, c3}: k-column t then stands for C column 2t and t + 4 for
// 2t + 1, and the B operand of that product reads its k rows in the same
// order (rows 2t and 2t + 1 of the 8).

// cvt.rna.tf32.f32 for every finite x (and +-inf): the low 13 bits rounded
// to nearest, ties away from zero, the carry free to raise the exponent; two
// integer instructions, where cvt.rna expands to more on sm_90 (the tensor
// core reads only the 19 high bits of a tf32 operand)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct FragA {  // a 16 x 8 A operand, split
  uint32_t hi[4], lo[4];
};

struct FragB {  // an 8 x 8 B operand, split
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

// the A operand of a product from the C fragment c of the previous one
__device__ __forceinline__ FragA frag_a_from_c(const float (&c)[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// c = a b for one 16 x 8 tile over the head dim (four k-steps), a's
// fragments in registers and b's k x 8 block read from shared memory at
// `b` (b[8 ks] and b[8 ks + 4] are this lane's elements of k-step ks),
// multiplied by `mult` before the split. The tensor core's f32
// accumulation truncates: a chain of the twelve products into one
// accumulator is less accurate than an f32 FMA loop, so each k-step's hi.hi
// product goes to a fresh accumulator and the four are summed on the CUDA
// cores (rounding to nearest), the small terms chained apart, which matches
// the FMA loop (tests/test_torch_kernels.py measures the three). TRANSPOSED takes
// the two small products in the other order: a transposed call on swapped
// operands (S^T = K Q^T for S = Q K^T) then takes the same products in the
// same order, and gives the same sums bit for bit.
template <bool TRANSPOSED = false>
__device__ __forceinline__ void dot_3xtf32(float (&c)[4], const FragA (&a)[kDh / 8],
                                           const float* b, float mult) {
  float small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kDh / 8; ++ks) {
    const FragB f = frag_b(b[8 * ks] * mult, b[8 * ks + 4] * mult);
    float big[4] = {0.f, 0.f, 0.f, 0.f};
    if (TRANSPOSED) {
      mma_tf32(small, a[ks].hi, f.lo);
      mma_tf32(small, a[ks].lo, f.hi);
    } else {
      mma_tf32(small, a[ks].lo, f.hi);
      mma_tf32(small, a[ks].hi, f.lo);
    }
    mma_tf32(big, a[ks].hi, f.hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += big[e];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += small[e];
}

// The flash kernels' key mask: one bit per key of the batch row in shared
// memory (L <= 4096; a ballot per 32 keys), and the 32-bit tile mask, one
// bit per 128-key tile that holds a valid key (all-masked tiles are
// skipped). Every thread of the block calls it; it ends with a barrier.
constexpr int kMaskWords = 4096 / 32;

__device__ __forceinline__ void build_key_mask(uint32_t* bits, unsigned* tile_mask,
                                               const float* mb, int len) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int words = (len + 31) >> 5;
  for (int w = warp; w < kMaskWords; w += blockDim.x >> 5) {
    const int j = w * 32 + lane;
    const unsigned word = __ballot_sync(0xffffffffu, w < words && j < len && mb[j] > 0.f);
    if (lane == 0) bits[w] = word;
  }
  __syncthreads();
  if (warp == 0) {
    const uint32_t* tw = bits + 4 * lane;
    const unsigned live = __ballot_sync(0xffffffffu, (tw[0] | tw[1] | tw[2] | tw[3]) != 0u);
    if (lane == 0) *tile_mask = live;
  }
  __syncthreads();
}

// the next set bit of the tile mask at or after `from`, or -1
__device__ __forceinline__ int next_tile(unsigned mask, int from) {
  if (from >= 32) return -1;
  const unsigned rest = mask & (0xffffffffu << from);
  return rest ? __ffs(rest) - 1 : -1;
}

// 1 / ln 2, for exp(x) = exp2(x log2 e)
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error near 2^-22; results
// below 2^-126 flush to 0, a probability that no f32 sum can see)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The flash kernels' staged key tile: `keys` rows of K and V from key j0 of
// head h, each row padded to kKStride floats (so that the fragment loads of
// a warp, rows g or 2t + {0, 1} and columns t or g, hit 32 distinct banks),
// by 16-byte cp.async copies. Rows past len are zero-filled with plain
// stores: their probabilities are exactly 0, and 0 times stale shared memory
// could be NaN.
__device__ __forceinline__ void load_kv_tile(float* k_s, float* v_s, const float* kb,
                                             const float* vb, int j0, int keys, int len,
                                             int d_model, int h) {
  for (int i = threadIdx.x; i < keys * (kDh / 4); i += blockDim.x) {
    const int r = i >> 3;
    const int c = (i & 7) * 4;
    const int j = j0 + r;
    if (j < len) {
      const size_t g = (size_t)j * d_model + h * kDh + c;
      cp_async16(k_s + r * kKStride + c, kb + g);
      cp_async16(v_s + r * kKStride + c, vb + g);
    } else {
      st4(k_s + r * kKStride + c, make_float4(0.f, 0.f, 0.f, 0.f));
      st4(v_s + r * kKStride + c, make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}
