// Helpers shared by the attention kernels of this directory: the head
// layout, float4 loads and stores, cp.async, the tensor-core products in
// their three forms (3xTF32, 1xTF32, bf16), the flash kernels' key mask
// and staged key tiles, and Hopper's TMA copies, mbarriers and warpgroup
// products (wgmma).

#pragma once

#include <cuda.h>
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

// ---- the products on the tensor cores, in three forms ------------------------
//
// Every kernel of this directory takes its dot products on mma.sync.m16n8k8
// (tf32 in, f32 out) in one of three forms, a compile-time parameter F of
// the helpers below and of every kernel that calls them; the C entry points
// take it as an int (`form`) and the precision dials choose it
// (flashvtg_tpu_torch/utils/runtime.py:matmul_precision):
//   kForm3xTF32 (float32, the parity mode): an f32 operand x is split into
//     two TF32 values, hi = rna(x) and lo = rna(x - hi) (x - hi is exact in
//     f32), so that x = hi + lo to about 22 significant bits. A product a.b
//     is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b with f32 accumulators,
//     the small terms first; the dropped lo_a.lo_b is below f32 rounding.
//     This is CUTLASS's OpMultiplyAddFastF32, whose stated accuracy is that
//     of f32 on CUDA cores.
//   kForm1xTF32 (tensorfloat32): hi_a.hi_b alone, one product per dot:
//     about three decimal digits, what cuBLAS's TF32 GEMMs keep.
//   kFormBF16 (bfloat16): each operand rounded to bf16, to nearest even
//     (cvt.rn.bf16x2.f32), with f32 sums. Every kernel's bf16 instances take
//     these operands on a bf16 instruction, in bodies of their own that the
//     m16n8k8 helpers below never see: the ACA kernels on mma.sync.m16n8k16
//     from bf16 tiles in shared memory (the section after dot_form below),
//     the flash forward and backward on Hopper's warpgroup product wgmma
//     from bf16 tiles that TMA copies (the last section).
// The 1xTF32 form keeps the 3xTF32 form's accumulation order: each k-step's
// product in a fresh accumulator (dot_form below), each chunk of keys in
// fresh accumulators added on the CUDA cores.
// flashvtg_tpu_torch/ops/forms.py emulates the three forms in torch, and
// the kernels' plain versions round their operands by it.
//
// mma.sync.m16n8k8 (tf32 in, f32 out) fragments, g = lane / 4, t = lane % 4:
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A C fragment feeds the next product as its A operand in registers as
// {c0, c2, c1, c3}: k-column t then stands for C column 2t and t + 4 for
// 2t + 1, and the B operand of that product reads its k rows in the same
// order (rows 2t and 2t + 1 of the 8).

constexpr int kForm3xTF32 = 0;
constexpr int kForm1xTF32 = 1;
constexpr int kFormBF16 = 2;

// cvt.rna.tf32.f32 for every finite x (and +-inf): the low 13 bits rounded
// to nearest, ties away from zero, the carry free to raise the exponent; two
// integer instructions, where cvt.rna expands to more on sm_90 (the tensor
// core reads only the 19 high bits of a tf32 operand)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct FragA {  // a 16 x 8 A operand, split (lo only in the 3xTF32 form)
  uint32_t hi[4], lo[4];
};

struct FragB {  // an 8 x 8 B operand, split
  uint32_t hi[2], lo[2];
};

// Two operands x and y of form F, each as (hi, lo): TF32 parts, hi =
// rna(v) and, in the 3xTF32 form only, lo = rna(v - hi). The bf16 form
// never comes here: its bodies take bf16 operands on bf16 instructions.
template <int F>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hx, uint32_t& lx,
                                           uint32_t& hy, uint32_t& ly) {
  static_assert(F != kFormBF16, "the bf16 form has bodies of its own");
  hx = tf32_rna(x);
  hy = tf32_rna(y);
  lx = F == kForm3xTF32 ? tf32_rna(x - __uint_as_float(hx)) : 0u;
  ly = F == kForm3xTF32 ? tf32_rna(y - __uint_as_float(hy)) : 0u;
}

template <int F = kForm3xTF32>
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_pair<F>(a0, a1, f.hi[0], f.lo[0], f.hi[1], f.lo[1]);
  split_pair<F>(a2, a3, f.hi[2], f.lo[2], f.hi[3], f.lo[3]);
  return f;
}

// the A operand of a product from the C fragment c of the previous one
template <int F = kForm3xTF32>
__device__ __forceinline__ FragA frag_a_from_c(const float (&c)[4]) {
  return frag_a<F>(c[0], c[2], c[1], c[3]);
}

template <int F = kForm3xTF32>
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_pair<F>(b0, b1, f.hi[0], f.lo[0], f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in form F
template <int F = kForm3xTF32>
__device__ __forceinline__ void mma_form(float (&c)[4], const FragA& a, const FragB& b) {
  if (F == kForm3xTF32) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
  }
  mma_tf32(c, a.hi, b.hi);
}

// c = a b for one 16 x 8 tile over the head dim (four k-steps) in form F,
// a's fragments in registers and b's k x 8 block read from shared memory at
// `b` (b[8 ks] and b[8 ks + 4] are this lane's elements of k-step ks),
// multiplied by `mult` before the split. The tensor core's f32
// accumulation truncates: a chain of the twelve 3xTF32 products into one
// accumulator is less accurate than an f32 FMA loop, so each k-step's hi.hi
// product goes to a fresh accumulator and the four are summed on the CUDA
// cores (rounding to nearest), the small terms chained apart, which matches
// the FMA loop (tests/test_torch_kernels.py measures the three). TRANSPOSED takes
// the two small products in the other order: a transposed call on swapped
// operands (S^T = K Q^T for S = Q K^T) then takes the same products in the
// same order, and gives the same sums bit for bit. The 1xTF32 and bf16
// forms take the hi.hi products alone, in the same fresh accumulators.
template <int F = kForm3xTF32, bool TRANSPOSED = false>
__device__ __forceinline__ void dot_form(float (&c)[4], const FragA (&a)[kDh / 8],
                                         const float* b, float mult) {
  float small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kDh / 8; ++ks) {
    const FragB f = frag_b<F>(b[8 * ks] * mult, b[8 * ks + 4] * mult);
    float big[4] = {0.f, 0.f, 0.f, 0.f};
    if (F == kForm3xTF32) {
      if (TRANSPOSED) {
        mma_tf32(small, a[ks].hi, f.lo);
        mma_tf32(small, a[ks].lo, f.hi);
      } else {
        mma_tf32(small, a[ks].lo, f.hi);
        mma_tf32(small, a[ks].hi, f.lo);
      }
    }
    mma_tf32(big, a[ks].hi, f.hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += big[e];
  }
  if (F == kForm3xTF32) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += small[e];
  }
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

// ---- bf16 operands on the bf16 instruction (mma.sync.m16n8k16) ---------------
//
// The bf16 form of the ACA kernels (aca_attention.cu, aca_attention_bwd.cu)
// takes its products on
// mma.sync.m16n8k16 (bf16 in, f32 out): twice the k of the TF32
// instruction, at twice its rate. Its operands are rounded to bf16 once,
// where they are staged (cvt.rn.bf16x2.f32, to nearest even).
// Fragments, g = lane / 4, t = lane % 4; a register holds two bf16 values,
// the lower column (or k row) in its low half:
//   A (16 x 16, row major): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                           a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, k x n):      b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
//   C (16 x 8):             c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// The C tiles of two adjacent 8-column n-tiles feed the next product as one
// A operand, in natural column order: a0 = (c0, c1) and a1 = (c2, c3) of the
// first tile, a2 = (c0, c1) and a3 = (c2, c3) of the second; the B operand
// of that product reads its k rows in their natural order too.
// A tile in shared memory is bf16 rows of kBStride elements (80 bytes, so
// the eight 16-byte rows of an 8 x 8 matrix that ldmatrix reads fall in
// distinct banks). ldmatrix.x4 reads four 8 x 8 matrices, lanes 8m .. 8m + 7
// giving the row addresses of matrix m, and leaves matrix m in register m:
// as stored, lane (g, t) holds row g, columns 2t and 2t + 1, the B operand
// of a product whose k index runs along the rows (K for S = Q K^T); with
// .trans, rows 2t and 2t + 1 of column g, the B operand of one whose k index
// runs down the rows (K for dq = dS K).

constexpr int kBStride = kDh + 8;  // bf16 elements a row of a bf16 tile

// {x (low half), y (high half)}, each rounded to bf16, to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  uint32_t u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(y), "f"(x));
  return u;
}

// four floats as bf16 into a tile in shared memory (p 8-byte aligned)
__device__ __forceinline__ void st_bf16x4(uint16_t* p, float4 x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

// c += a b, bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The A operand of a 16-row set over the head dim, two k16 steps, from
// device memory at `p` (row g's element 2t of the set's first row, `row8`
// floats on to row g + 8), each value times `mult` before the rounding
__device__ __forceinline__ void frag_a16_rows(uint32_t (&a)[kDh / 16][4], const float* p,
                                              size_t row8, float mult) {
#pragma unroll
  for (int ks = 0; ks < kDh / 16; ++ks) {
    const float* r = p + 16 * ks;
    const float2 x0 = *reinterpret_cast<const float2*>(r);
    const float2 x1 = *reinterpret_cast<const float2*>(r + row8);
    const float2 x2 = *reinterpret_cast<const float2*>(r + 8);
    const float2 x3 = *reinterpret_cast<const float2*>(r + row8 + 8);
    a[ks][0] = pack_bf16(x0.x * mult, x0.y * mult);
    a[ks][1] = pack_bf16(x1.x * mult, x1.y * mult);
    a[ks][2] = pack_bf16(x2.x * mult, x2.y * mult);
    a[ks][3] = pack_bf16(x3.x * mult, x3.y * mult);
  }
}

// the A operand of a product from the C tiles lo (columns 0-7) and hi
// (columns 8-15) of the previous one
__device__ __forceinline__ void frag_a16_from_c(uint32_t (&a)[4], const float (&lo)[4],
                                                const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// The 16 x 8 tile c = a b^T over the head dim: a's two k16 steps in
// registers, b the ldmatrix.x4 of its 8 rows as stored (register 2 ks and
// 2 ks + 1 step ks's B operand). Each step's product goes to a fresh
// accumulator and the two are added on the CUDA cores, as dot_form adds its
// k-steps. The ACA forward and backward take S (and the backward dO V^T)
// here, so their S agree bit for bit. The flash kernels take the same two
// k16 sums on wgmma, which sums a k16 step as mma.sync does, and add them
// alike (flash_attention.cu issue_s; flash_attention_bwd.cu
// dot_pair_wgmma), so the forward's S, the dq kernel's S and the dk/dv
// kernel's S^T agree bit for bit.
__device__ __forceinline__ void dot_bf16(float (&c)[4], const uint32_t (&a)[kDh / 16][4],
                                         const uint32_t (&b)[4]) {
  float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(s0, a[0], b[0], b[1]);
  mma_bf16(s1, a[1], b[2], b[3]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = s0[e] + s1[e];
}

// ---- Hopper: TMA tile copies, mbarriers, warpgroup products (sm_90a) ---------
//
// The flash forward's and backward's bf16 instances (flash_attention.cu,
// flash_attention_bwd.cu) take their products on wgmma, from bf16 tiles
// that TMA copies into shared memory, out of (B, L, H * 32) bf16 copies that
// a pre-pass of each rounds with st_bf16x8 (below), so that the two round
// alike:
//  * a tile is R rows of one head's 32 bf16 values: 64 bytes a row, exactly
//    the 64-byte swizzle atom. A TMA box of 32 x R with
//    CU_TENSOR_MAP_SWIZZLE_64B stores 16-byte chunk c of row r at chunk
//    c ^ ((r >> 1) & 3) (address bits 4-5 XOR bits 7-8, so a tile starts on
//    a 512-byte boundary; tiles here start on 1024), which is the layout
//    wgmma reads through a descriptor of layout type 2 (64-byte swizzle).
//    Rows past the tensor's end arrive as zeros;
//  * as the K-major operand of a product over the head dim (S = Q K^T: both
//    operands), 8 rows (512 bytes) make a core-matrix group (the stride
//    byte offset) and the second k16 step starts 32 bytes into the rows; as
//    the MN-major operand of a product whose k runs down the rows (K in dq =
//    dS K), the 32 head columns are one atom wide and 8 rows (512 bytes)
//    again make a k group, so the two byte offsets are both 512 there;
//  * an mbarrier counts the bytes of its stage's copies (arrive.expect_tx by
//    the one thread that issues them); the block waits on the stage's phase
//    parity, which flips each time the stage fills;
//  * wgmma.m64nNk16 (bf16 in, f32 out) takes 64 rows a warpgroup, warp w
//    rows 16w .. 16w + 15, each warp in the m16n8k16 C layout above repeated
//    over the 8-column n-tiles: accumulator register 4j + e is register e of
//    n-tile j. A in registers has the m16n8k16 A layout, so acc_to_a turns
//    columns 16kk .. 16kk + 15 of an accumulator into the A operand of the
//    next product (FlashAttention-3's P and dS in registers);
//  * a product is asynchronous: wgmma_fence before it (registers written
//    since are visible to it), commit, then wait before its accumulator or A
//    registers are read or written again (wgmma_hold keeps the compiler
//    from moving an access across the asm statements).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr int kBoxRows = 64;                    // rows of every TMA box
constexpr int kTileBytes = kBoxRows * kDh * 2;  // one box of bf16: 4 KB
constexpr int kRowBytes = kDh * 2;              // a tile row

// the first 1024-byte boundary at or after p in shared memory (a swizzled
// tile starts on one)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// eight floats x, y, each times mult, as bf16 to nearest even at p (16-byte
// aligned): the pre-passes' rounding of the copies the TMA maps read
__device__ __forceinline__ void st_bf16x8(uint16_t* p, float4 x, float4 y, float mult) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(x.x * mult, x.y * mult), pack_bf16(x.z * mult, x.w * mult),
                 pack_bf16(y.x * mult, y.y * mult), pack_bf16(y.z * mult, y.w * mult));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` more to land on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// orders this thread's earlier shared-memory accesses before later copies
// of the async proxy (TMA) into the same memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: the box of `map` at (column c, row r, batch row b) into `dst`,
// completing on `bar` (a 3-D map over a (B, L, H * 32) tensor)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c, int r,
                                            int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// The shared-memory matrix descriptor of a 64-byte-swizzled bf16 tile that
// starts at `tile` (bits 0-13: address / 16; 16-29: leading byte offset /
// 16; 32-45: stride byte offset / 16, 512 bytes; 62-63: layout type 2, the
// 64-byte swizzle). K-major operands take `lead` 1 (unused: a k16 step
// lies inside one atom), MN-major ones 32 (unused too: 32 columns are one
// atom; set to the group stride so that neither field reading matters).
constexpr uint32_t kDescKMajor = 1, kDescMNMajor = 512 >> 4;

__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, uint32_t lead) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3ffffu) >> 4) | ((uint64_t)lead << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void wgmma_hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_D16(c)                                                                   \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15])

// d (64 x 32) = a b^T in a fresh accumulator: one k16 step, a (64 rows) and
// b (32 rows) K-major tiles in shared memory, by descriptors
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D16("=f")
      : "l"(a), "l"(b), "r"(0));
}

// d (64 x 32) += a b: one k16 step, a (64 x 16) in registers (acc_to_a's
// layout), b (16 rows of 32 columns) an MN-major tile in shared memory
__device__ __forceinline__ void wgmma_n32_rs(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WGMMA_D16("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#define WGMMA_D32(c)                                                                    \
  WGMMA_D16(c), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]),       \
      c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])

// d (64 x 64) = a b^T in a fresh accumulator: one k16 step, a (64 x 16) in
// registers (acc_to_a's layout), b (64 rows) a K-major tile in shared memory
__device__ __forceinline__ void wgmma_n64_rs_k(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WGMMA_D32("=f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

#undef WGMMA_D32
#undef WGMMA_D16

// keeps the A registers of a product in flight alive, unchanged, up to here
// (after the wgmma_wait that covers it)
template <int N>
__device__ __forceinline__ void wgmma_hold_a(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// the A operand of k16 step kk of a product whose k runs along the columns
// of accumulator d: its columns 16kk .. 16kk + 15 (n-tiles 2kk and 2kk + 1),
// rounded to bf16
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[R], int kk) {
  a[0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// ---- host side: the TMA maps of the bf16 copies ----------------------------

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (so
// the library needs no -lcuda); null where the CUDA library lacks it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The TMA map of a (batch, len, heads * 32) bf16 tensor: boxes of 32
// columns (one head) x kBoxRows rows x 1 batch row, 64-byte swizzle; a box's
// rows past len arrive as zeros
inline CUresult encode_rows(EncodeTiled encode, CUtensorMap* map, const uint16_t* ptr, int batch,
                            int len, int heads) {
  const cuuint64_t dims[3] = {(cuuint64_t)heads * kDh, (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)heads * kRowBytes,
                                 (cuuint64_t)len * heads * kRowBytes};
  const cuuint32_t box[3] = {kDh, kBoxRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<uint16_t*>(ptr), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// an encode's failure, as the C entries return it: kTensorMapError plus the
// CUresult (ops/chunked_attn.py names it)
constexpr int kTensorMapError = 1 << 16;
