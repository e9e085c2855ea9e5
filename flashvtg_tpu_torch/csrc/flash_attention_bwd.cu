// Memory-linear backward of the masked self-attention (flash_attention.cu),
// for Hopper (sm_90a): the FlashAttention-2 backward with every product on
// the tensor cores in 3xTF32 (f32-accurate), 1xTF32 or bf16 (the forward's
// form).
//
// Replaces: the VJP of JAX's library Pallas flash_attention, long form (timed
// as forward + backward at scripts/bench_flash.py:62-74) and, on the JAX
// package's model path, the rematerialised backward of
// flashvtg_tpu/ops/chunked_attn.py:32-41 (jax.checkpoint per query chunk),
// which the long-video train step (tacos, charades_vgg: 2048 clips) runs
// through every encoder layer.
//
// What it computes, for batch row b, head h, query row i and key j, from
// q, k, v, the forward's output O and row log-sum-exp lse, and dO:
//   D_i   = sum_c dO_ic O_ic                       (pre-pass)
//   P_ij  = exp(scale q_i . k_j - lse_i)           (0 at masked keys)
//   z_ij  = the forward's dropout scale (attn_dropout.cuh), recomputed
//   dS_ij = P_ij (z_ij (dO_i . v_j) - D_i)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_i dS_ij q_i
//   dv_j  = sum_i P_ij z_ij dO_i
// Probabilities are recomputed from q, k and lse and never stored: the
// (B, H, L, L) tensor never exists in device memory. A batch row with no
// valid key gets zeros everywhere, as the forward gives it zeros.
//
// What bounds it: per valid (b, h, i, j) pair, 320 FLOP of dot products
// (q.k, dO.v, dq, dk and dv, 64 each) and about 6 other operations (exp,
// dP, dS). Dot products run at 3xTF32's f32-accurate rate, 495 / 3 = 165
// TFLOP/s, the rest at 67 TFLOP/s. At phase 7's TACoS train draw (B=32,
// H=8, L=2048, 31,908 of 65,536 keys valid) that is 167 GFLOP, 1.01 ms,
// against ~0.4 GB of inputs and outputs (0.12 ms at 3.35 TB/s): bound by
// operations, on the tensor cores. The design keeps the deterministic split
// of the f32 version (every sum in one block, in a fixed order; no float
// atomics; launches agree bit for bit), now on mma.sync.m16n8k8:
//  * pre-pass: one warp per (b, i) row computes D = rowsum(dO O) for every
//    head, for the dq kernel (an elementwise dot of 32, read once: bound by
//    bytes, on CUDA cores);
//  * dk/dv: a block owns (b, h) and 64 keys, four warps of 16 (skipped, and
//    written as zeros, when all 64 are masked); a warp keeps its keys' K and
//    V fragments in registers, split, and loops over every query tile of 64
//    rows (every query row takes part in the loss), whose Q, dO, lse, D and
//    dropout row hashes come through a two-stage cp.async ring. Per 16 query
//    rows it takes S^T = K (scale Q)^T and dP^T = V dO^T into accumulators,
//    forms P^T z and dS^T there, and feeds them as A operands from registers
//    to dv += (P z)^T dO and dk += dS^T Q, scaled once at the end (the B
//    fragments read their query rows in the order 2t, 2t + 1 of the C
//    layout); 16 rows a set keep the kernel under 170 registers without
//    spills (64 spilled and ran slower on the card);
//  * dq: a block owns (b, h) and 64 query rows, four warps of 16, with Q
//    (scaled) and dO fragments in registers; it loops over the 128-key tiles
//    that hold a valid key (the forward's key bits and cp.async ring), takes
//    S = (scale Q) K^T and dP = dO V^T for 32 keys at a time, forms dS and
//    feeds it to dq += dS K from registers;
//  * the tensor core's f32 accumulation truncates, so no chain of products
//    runs long: S and dP tiles take each k-step's hi.hi product in a fresh
//    accumulator (attn_common.cuh dot_form, as accurate as an f32 FMA
//    loop), and each set's dk, dv and dq products go to fresh accumulators
//    added on the CUDA cores;
//  * dS = P (z dP - D) cancels to 0 at a row with one valid key, and dk sums
//    its rounding over every query row: f32 sums in any order, the f32
//    plain version's included, leave dk near the tests' 1e-5 floor. So the
//    dq kernel, which runs first, also sums D' = rowsum(P z dP) from the
//    very P and dP it forms, and the dk/dv kernel takes D' for D; its S^T
//    and dP^T take the dq kernel's products in the same order
//    (dot_form<F, true>), and P = exp2((s - lse) log2 e) is exactly 1 at a
//    row's only key (the forward's lse is then exactly m): dS is exactly 0
//    there, as in exact arithmetic. Mathematically D' = D.
// This recomputes q.k and dO.v in both kernels: 14 B H L^2 Dh FLOP in all
// against the 10 of the bound, the price of sums without atomics.
// Why 3xTF32 is the f32 parity mode: each operand is split into two TF32
// parts (attn_common.cuh), and the three products keep about 22 significant
// bits, the accuracy of f32 on CUDA cores (CUTLASS's OpMultiplyAddFastF32);
// gradients agree with the f32 plain version within 1e-4 of their largest
// value. A single TF32 product keeps about three decimal digits: the
// tensorfloat32 form; bf16 operands with f32 sums are the bfloat16 form
// (attn_common.cuh; the dq and dk/dv kernels are templates on it, the D
// pre-pass has no product).
// The bf16 form has bodies of its own (dkdv_bf16, dq_bf16), on the bf16
// instruction mma.sync.m16n8k16 from bf16 tiles in shared memory: half the
// tensor-core instructions of the m16n8k8 form and no conversion inside
// the product loops. Its S and dP (dq kernel) and S^T and dP^T (dk/dv
// kernel) come from one helper, attn_common.cuh dot_bf16, so the two
// kernels' P and dP agree bit for bit and D' sums the very terms the dk/dv
// kernel forms. The forward's bf16 body takes its S by dot_bf16 too
// (flash_attention.cu), so its lse is exactly s at a row's only key, P =
// exp2((s - lse) log2 e) is exactly 1 there, and dS' = P (z dP - D') is
// exactly 0: dk is exactly 0 over a batch row with one valid key, as at the
// f32 forms. A batch row with no valid key still gets zeros everywhere (P =
// 0).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "attn_dropout.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kKvKeys = 16 * kWarps;  // keys per dk/dv block
constexpr int kQTile = 64;            // query rows per dk/dv stage
constexpr int kQSub = 16;             // query rows per S^T fragment set, 16, 32 or 64
constexpr int kDqRows = 16 * kWarps;  // query rows per dq block
constexpr int kDqKeys = 128;          // keys per dq stage (one bit of the tile mask)
constexpr int kDqChunk = 32;          // keys per S fragment set, 32 or 64
static_assert(kQTile % kQSub == 0 && kQSub % 8 == 0, "whole n-tiles in a stage");
static_assert(kDqChunk == 32 || kDqChunk == 64, "a chunk is one or two mask words");
constexpr int kMaxLen = kDqKeys * (kMaskWords / 4);

struct Operands {
  const float* q;
  const float* k;
  const float* v;
  const float* key_valid;
  const float* lse;
  const float* d_out;
  float* delta;  // (B, H, L): D from the pre-pass, then D' from the dq kernel
  float* dq;
  float* dk;
  float* dv;
  int len, heads;
  float scale;
  const uint32_t* seed;  // device memory, attn_dropout.cuh; null without dropout
  uint32_t threshold;
  float keep_scale;
};

__device__ __forceinline__ void cp_async4(float* smem_dst, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src)
               : "memory");
}

// D[b, h, i] = dO[b, i, h] . O[b, i, h] for the dq kernel: one warp per
// (b, i), a lane 8 columns, the four lanes of a head summed with shuffles
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const float* __restrict__ out, const float* __restrict__ d_out,
                       float* __restrict__ delta, int rows, int len, int heads) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int b = row / len;
  const int i = row - b * len;
  const int d_model = heads * kDh;
  for (int base = 0; base < d_model; base += 256) {
    const int c = base + lane * 8;
    float s = 0.f;
    if (c < d_model) {
      const size_t g = (size_t)row * d_model + c;
      s = dot4(ld4(out + g), ld4(d_out + g), 0.f);
      s = dot4(ld4(out + g + 4), ld4(d_out + g + 4), s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (c < d_model && (lane & 3) == 0) {
      delta[((size_t)b * heads + c / kDh) * len + i] = s;
    }
  }
}

// One dk/dv stage, in floats: Q and dO (kQTile rows of kKStride), then the
// rows' lse, D and dropout row hashes.
constexpr int kQStageFloats = 2 * kQTile * kKStride + 3 * kQTile;

// Starts the copies of query rows row0 .. row0 + kQTile - 1 into `stage`;
// rows past len read row len - 1 (they get P = 0).
__device__ __forceinline__ void load_query_stage(const Operands& a, float* stage, int b, int h,
                                                 int row0, uint32_t drop_h) {
  const int d_model = a.heads * kDh;
  float* q_s = stage;
  float* do_s = q_s + kQTile * kKStride;
  float* lse_s = do_s + kQTile * kKStride;
  float* d_s = lse_s + kQTile;
  uint32_t* rh_s = reinterpret_cast<uint32_t*>(d_s + kQTile);
  for (int i = threadIdx.x; i < kQTile * (kDh / 4); i += blockDim.x) {
    const int r = i >> 3;
    const int c = (i & 7) * 4;
    const size_t g = ((size_t)b * a.len + min(row0 + r, a.len - 1)) * d_model + h * kDh + c;
    cp_async16(q_s + r * kKStride + c, a.q + g);
    cp_async16(do_s + r * kKStride + c, a.d_out + g);
  }
  for (int r = threadIdx.x; r < kQTile; r += blockDim.x) {
    const size_t g = ((size_t)b * a.heads + h) * a.len + min(row0 + r, a.len - 1);
    cp_async4(lse_s + r, a.lse + g);
    cp_async4(d_s + r, a.delta + g);
    rh_s[r] = a.threshold != 0u ? drop_row(drop_h, row0 + r) : 0u;
  }
}

// ---- the bf16 form on mma.sync.m16n8k16 (attn_common.cuh) -------------------
//
// The same two kernels, their operands rounded to bf16 once, where they are
// staged: the dk/dv kernel's query stage as three bf16 tiles (scale q for
// S^T, q for dk, dO), the dq kernel's key stage as two (K, V), each loaded
// from device memory through registers and stored rounded, the next stage's
// rows in flight while the block computes the current one (a part of the
// stage a 16-row set or 32-key chunk); the lse, D' and row hashes by
// cp.async as in the f32 stage. Every product is one m16n8k16 step or two:
// S^T / dP^T (S / dP) two over the head dim (dot_bf16, the same helper in
// both kernels), dv += (P z)^T dO and dk += dS^T Q one over a set's 16 query
// rows, dq += dS K two over a chunk's 32 keys; B operands by ldmatrix, the
// transposed ones by ldmatrix.trans; P z and dS feed the next product from
// registers (frag_a16_from_c). The element-wise work, the masks, the
// dropout, the fresh accumulators added on the CUDA cores and the order of
// every sum are the f32 forms'.

constexpr int kQTileBF16 = kQTile * kBStride;                   // bf16 elements
constexpr int kQStageBytesBF16 = 3 * kQTileBF16 * 2 + 3 * kQTile * 4;
constexpr int kKvTileBF16 = kDqKeys * kBStride;
static_assert(kQStageBytesBF16 % 16 == 0, "16-byte aligned stages");
using QRowsBF16 = RowsBF16<kQSub, kWarps * 32>;
using KvRowsBF16 = RowsBF16<kDqChunk, kWarps * 32>;

// the lse, D' and dropout row hashes of query rows row0 .. row0 + kQTile - 1
// (rows past len read row len - 1), as load_query_stage's
__device__ __forceinline__ void load_query_scalars(const Operands& a, unsigned char* stage,
                                                   int b, int h, int row0, uint32_t drop_h) {
  float* lse_s = reinterpret_cast<float*>(stage + 3 * kQTileBF16 * 2);
  float* d_s = lse_s + kQTile;
  uint32_t* rh_s = reinterpret_cast<uint32_t*>(d_s + kQTile);
  for (int r = threadIdx.x; r < kQTile; r += blockDim.x) {
    const size_t g = ((size_t)b * a.heads + h) * a.len + min(row0 + r, a.len - 1);
    cp_async4(lse_s + r, a.lse + g);
    cp_async4(d_s + r, a.delta + g);
    rh_s[r] = a.threshold != 0u ? drop_row(drop_h, row0 + r) : 0u;
  }
}

__device__ __forceinline__ void dkdv_bf16(const Operands& a, unsigned char* stages) {
  static_assert(kQSub == 16, "one k16 step of dk and dv a set");
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d_model = a.heads * kDh;
  const float* mb = a.key_valid + (size_t)b * a.len;
  const int key0 = (int)blockIdx.x * kKvKeys + warp * 16 + g;
  const int key[2] = {key0, key0 + 8};
  const bool key_ok[2] = {key[0] < a.len && mb[key[0]] > 0.f,
                          key[1] < a.len && mb[key[1]] > 0.f};
  const size_t head0 = (size_t)b * a.len * d_model + h * kDh;  // row 0 of this head
  // ldmatrix rows: as stored (S^T, dP^T), and transposed, 8-row halves
  // (dv, dk)
  const int ld_row = lane & 7, ld_col = 8 * (lane >> 3);
  const int tr_row = 8 * ((lane >> 3) & 1) + (lane & 7), tr_col = 8 * (lane >> 4);

  float dk[kDh / 8][4], dv[kDh / 8][4];
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }

  if (__syncthreads_or(key_ok[0] || key_ok[1])) {
    const uint32_t drop_h = drop_head(drop_seed(a.seed), b * a.heads + h);
    load_query_scalars(a, stages, b, h, 0, drop_h);
    cp_async_commit();
    {
      uint16_t* qs_s = reinterpret_cast<uint16_t*>(stages);
#pragma unroll 1
      for (int r0 = 0; r0 < kQTile; r0 += kQSub) {
        QRowsBF16 q, d_o;
        q.load(a.q + head0, d_model, r0, a.len, a.len - 1);
        d_o.load(a.d_out + head0, d_model, r0, a.len, a.len - 1);
        q.store(qs_s, r0, a.scale);
        q.store(qs_s + kQTileBF16, r0);
        d_o.store(qs_s + 2 * kQTileBF16, r0);
      }
    }

    // the warp's 16 keys of K and V in bf16, the A operand of S^T and dP^T
    uint32_t kf[kDh / 16][4], vf[kDh / 16][4];
    {
      const size_t g0 = head0 + (size_t)min(key[0], a.len - 1) * d_model + 2 * t;
      const size_t row8 = (size_t)(min(key[1], a.len - 1) - min(key[0], a.len - 1)) * d_model;
      frag_a16_rows(kf, a.k + g0, row8, 1.f);
      frag_a16_rows(vf, a.v + g0, row8, 1.f);
    }
    cp_async_wait_all();
    __syncthreads();

    const int n_q = (a.len + kQTile - 1) / kQTile;
    for (int qt = 0; qt < n_q; ++qt) {
      const bool more = qt + 1 < n_q;
      unsigned char* cur = stages + (qt & 1) * kQStageBytesBF16;
      unsigned char* nxt = stages + ((qt + 1) & 1) * kQStageBytesBF16;
      if (more) load_query_scalars(a, nxt, b, h, (qt + 1) * kQTile, drop_h);
      cp_async_commit();
      const uint16_t* qs_s = reinterpret_cast<const uint16_t*>(cur);
      const uint16_t* q_s = qs_s + kQTileBF16;
      const uint16_t* do_s = q_s + kQTileBF16;
      const float* lse_s = reinterpret_cast<const float*>(do_s + kQTileBF16);
      const float* d_s = lse_s + kQTile;
      const uint32_t* rh_s = reinterpret_cast<const uint32_t*>(d_s + kQTile);

#pragma unroll 1
      for (int sub = 0; sub < kQTile; sub += kQSub) {
        // the next stage's rows of this set, in flight while it computes
        QRowsBF16 q_next, do_next;
        if (more) {
          q_next.load(a.q + head0, d_model, (qt + 1) * kQTile + sub, a.len, a.len - 1);
          do_next.load(a.d_out + head0, d_model, (qt + 1) * kQTile + sub, a.len, a.len - 1);
        }

        // S^T = K (scale Q)^T and dP^T = V dO^T: keys x kQSub query rows
        float st[kQSub / 8][4], dpt[kQSub / 8][4];
#pragma unroll
        for (int n = 0; n < kQSub / 8; ++n) {
          const int off = (sub + 8 * n + ld_row) * kBStride + ld_col;
          uint32_t qr[4], dr[4];
          ldsm_x4(qr, qs_s + off);
          ldsm_x4(dr, do_s + off);
          dot_bf16(st[n], kf, qr);
          dot_bf16(dpt[n], vf, dr);
        }

        // P^T z and dS^T in place; this lane's query rows are 2t, 2t + 1
        // of each 8
#pragma unroll
        for (int n = 0; n < kQSub / 8; ++n) {
          const int li = sub + 8 * n + 2 * t;  // the first of the two rows, in the stage
          const int row = qt * kQTile + li;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = e & 1;  // which of the two rows
            const int r = e >> 1;  // which of the two keys
            const bool live = key_ok[r] && row + c < a.len;
            const float p = live ? exp2_fast((st[n][e] - lse_s[li + c]) * kLog2e) : 0.f;
            const float z = a.threshold != 0u
                                ? drop_scale(rh_s[li + c], key[r], a.threshold, a.keep_scale)
                                : 1.f;
            st[n][e] = p * z;
            dpt[n][e] = p * (z * dpt[n][e] - d_s[li + c]);
          }
        }

        // dv += (P z)^T dO and dk += dS^T Q over the set's 16 rows: one k16
        // step per 8 head columns, each in a fresh accumulator added to dk
        // and dv on the CUDA cores
        uint32_t pa[4], da[4];
        frag_a16_from_c(pa, st[0], st[1]);
        frag_a16_from_c(da, dpt[0], dpt[1]);
#pragma unroll
        for (int np = 0; np < kDh / 16; ++np) {
          const int off = (sub + tr_row) * kBStride + 16 * np + tr_col;
          uint32_t ot[4], qt4[4];
          ldsm_x4_trans(ot, do_s + off);
          ldsm_x4_trans(qt4, q_s + off);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int n = 2 * np + half;
            float pdv[4] = {0.f, 0.f, 0.f, 0.f}, pdk[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(pdv, pa, ot[2 * half], ot[2 * half + 1]);
            mma_bf16(pdk, da, qt4[2 * half], qt4[2 * half + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv[n][e] += pdv[e];
              dk[n][e] += pdk[e];
            }
          }
        }

        if (more) {
          uint16_t* nq_s = reinterpret_cast<uint16_t*>(nxt);
          q_next.store(nq_s, sub, a.scale);
          q_next.store(nq_s + kQTileBF16, sub);
          do_next.store(nq_s + 2 * kQTileBF16, sub);
        }
      }
      cp_async_wait_all();
      __syncthreads();  // the next stage is in place; this one is free for the stage after
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.len) continue;
    const size_t g0 = ((size_t)b * a.len + key[r]) * d_model + h * kDh + 2 * t;
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      *reinterpret_cast<float2*>(a.dk + g0 + 8 * n) =
          make_float2(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<float2*>(a.dv + g0 + 8 * n) = make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

__device__ __forceinline__ void dq_bf16(const Operands& a, unsigned char* stages,
                                        uint32_t* key_bits, unsigned* tile_mask) {
  static_assert(kDqChunk % 16 == 0, "whole k16 steps of dq a chunk");
  constexpr int kStageElems = 2 * kKvTileBF16;
  uint16_t* tiles = reinterpret_cast<uint16_t*>(stages);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d_model = a.heads * kDh;
  const size_t head0 = (size_t)b * a.len * d_model + h * kDh;
  const float* kb = a.k + head0;
  const float* vb = a.v + head0;
  const int row0 = (int)blockIdx.x * kDqRows + warp * 16 + g;
  const int row[2] = {row0, row0 + 8};
  const int ld_row = lane & 7, ld_col = 8 * (lane >> 3);
  const int tr_row = 8 * ((lane >> 3) & 1) + (lane & 7), tr_col = 8 * (lane >> 4);

  build_key_mask(key_bits, tile_mask, a.key_valid + (size_t)b * a.len, a.len);
  const unsigned mask = *tile_mask;
  int tile = next_tile(mask, 0);
  if (tile >= 0) {
#pragma unroll 1
    for (int c0 = 0; c0 < kDqKeys; c0 += kDqChunk) {
      KvRowsBF16 k, v;
      k.load(kb, d_model, tile * kDqKeys + c0, a.len, -1);
      v.load(vb, d_model, tile * kDqKeys + c0, a.len, -1);
      k.store(tiles, c0);
      v.store(tiles + kKvTileBF16, c0);
    }
  }

  // the warp's 16 rows of scale * q and of dO in bf16, as A operands; the
  // rows' lse, D and dropout hashes
  uint32_t qf[kDh / 16][4], of[kDh / 16][4];
  float lse_r[2], dd[2];
  uint32_t drop_r[2] = {0u, 0u};
  {
    const int rc[2] = {min(row[0], a.len - 1), min(row[1], a.len - 1)};
    const size_t g0 = head0 + (size_t)rc[0] * d_model + 2 * t;
    const size_t row8 = (size_t)(rc[1] - rc[0]) * d_model;
    frag_a16_rows(qf, a.q + g0, row8, a.scale);
    frag_a16_rows(of, a.d_out + g0, row8, 1.f);
    const uint32_t drop_h = drop_head(drop_seed(a.seed), b * a.heads + h);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t gi = ((size_t)b * a.heads + h) * a.len + rc[r];
      lse_r[r] = a.lse[gi];
      dd[r] = a.delta[gi];
      if (a.threshold != 0u) drop_r[r] = drop_row(drop_h, row[r]);
    }
  }
  const bool live[2] = {row[0] < a.len, row[1] < a.len};

  float dq[kDh / 8][4];
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  float d_sum[2] = {0.f, 0.f};  // this lane's share of D' = rowsum(P z dP)
  __syncthreads();  // the first tile is in place

  for (int it = 0; tile >= 0; ++it) {
    const int next = next_tile(mask, tile + 1);
    const uint16_t* k_s = tiles + (it & 1) * kStageElems;
    const uint16_t* v_s = k_s + kKvTileBF16;
    uint16_t* nk_s = tiles + ((it + 1) & 1) * kStageElems;

#pragma unroll 1
    for (int c0 = 0; c0 < kDqKeys; c0 += kDqChunk) {
      // the next tile's keys of this chunk, in flight while it computes
      KvRowsBF16 k_next, v_next;
      if (next >= 0) {
        k_next.load(kb, d_model, next * kDqKeys + c0, a.len, -1);
        v_next.load(vb, d_model, next * kDqKeys + c0, a.len, -1);
      }
      const int j0 = tile * kDqKeys + c0;
      uint32_t words[kDqChunk / 32], any = 0u;
#pragma unroll
      for (int w = 0; w < kDqChunk / 32; ++w) any |= words[w] = key_bits[(j0 >> 5) + w];
      if (any != 0u) {  // the same in every warp
        // S = (scale Q) K^T and dP = dO V^T for the chunk's keys
        float s[kDqChunk / 8][4], dp[kDqChunk / 8][4];
#pragma unroll
        for (int n = 0; n < kDqChunk / 8; ++n) {
          const int off = (c0 + 8 * n + ld_row) * kBStride + ld_col;
          uint32_t kr[4], vr[4];
          ldsm_x4(kr, k_s + off);
          ldsm_x4(vr, v_s + off);
          dot_bf16(s[n], qf, kr);
          dot_bf16(dp[n], of, vr);
        }

        // dS in place of S
#pragma unroll
        for (int n = 0; n < kDqChunk / 8; ++n) {
          const uint32_t bits = words[n >> 2] >> ((n & 3) * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool ok = live[r] && ((bits >> (e & 1)) & 1u);
            const float p = ok ? exp2_fast((s[n][e] - lse_r[r]) * kLog2e) : 0.f;
            const float z =
                a.threshold != 0u
                    ? drop_scale(drop_r[r], j0 + 8 * n + 2 * t + (e & 1), a.threshold, a.keep_scale)
                    : 1.f;
            d_sum[r] += p * (z * dp[n][e]);
            s[n][e] = p * (z * dp[n][e] - dd[r]);
          }
        }

        // dq += dS K: dS from registers, a k16 step per 16 keys, K read
        // transposed; the chunk's sum in fresh accumulators, added to dq
        // on the CUDA cores
        float pdq[kDh / 8][4];
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pdq[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kDqChunk / 16; ++kk) {
          uint32_t da[4];
          frag_a16_from_c(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
          for (int np = 0; np < kDh / 16; ++np) {
            uint32_t kt[4];
            ldsm_x4_trans(kt, k_s + (c0 + 16 * kk + tr_row) * kBStride + 16 * np + tr_col);
            mma_bf16(pdq[2 * np], da, kt[0], kt[1]);
            mma_bf16(pdq[2 * np + 1], da, kt[2], kt[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[n][e] += pdq[n][e];
      }
      if (next >= 0) {
        k_next.store(nk_s, c0);
        v_next.store(nk_s + kKvTileBF16, c0);
      }
    }
    __syncthreads();  // the next tile is in place; this one is free for the tile after
    tile = next;
  }

  // D' over the quad, in a fixed order, for the dk/dv kernel: every lane of
  // the quad read its rows' D above, before this write
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    d_sum[r] += __shfl_xor_sync(0xffffffffu, d_sum[r], 1);
    d_sum[r] += __shfl_xor_sync(0xffffffffu, d_sum[r], 2);
    if (!live[r]) continue;
    if (t == 0) a.delta[((size_t)b * a.heads + h) * a.len + row[r]] = d_sum[r];
    float* o = a.dq + ((size_t)b * a.len + row[r]) * d_model + h * kDh + 2 * t;
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
    }
  }
}

// F = the product form (attn_common.cuh), as in the dq kernel
template <int F>
__global__ void __launch_bounds__(kWarps * 32, 3)
flash_bwd_dkdv_kernel(const Operands a) {
  extern __shared__ float4 smem4[];
  if constexpr (F == kFormBF16) {  // its own body, on the bf16 instruction (above)
    dkdv_bf16(a, reinterpret_cast<unsigned char*>(smem4));
    return;
  }
  float* stages = reinterpret_cast<float*>(smem4);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d_model = a.heads * kDh;
  const float* mb = a.key_valid + (size_t)b * a.len;
  // this lane's keys: key[0] and key[1] = key[0] + 8
  const int key0 = (int)blockIdx.x * kKvKeys + warp * 16 + g;
  const int key[2] = {key0, key0 + 8};
  const bool key_ok[2] = {key[0] < a.len && mb[key[0]] > 0.f,
                          key[1] < a.len && mb[key[1]] > 0.f};

  float dk[kDh / 8][4], dv[kDh / 8][4];
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }

  if (__syncthreads_or(key_ok[0] || key_ok[1])) {
    const uint32_t drop_h = drop_head(drop_seed(a.seed), b * a.heads + h);
    load_query_stage(a, stages, b, h, 0, drop_h);
    cp_async_commit();

    // the warp's 16 keys of K and V, split, as the A operand of S^T and dP^T
    FragA kf[kDh / 8], vf[kDh / 8];
    {
      const size_t g0 = ((size_t)b * a.len + min(key[0], a.len - 1)) * d_model + h * kDh + t;
      const size_t g1 = ((size_t)b * a.len + min(key[1], a.len - 1)) * d_model + h * kDh + t;
#pragma unroll
      for (int ks = 0; ks < kDh / 8; ++ks) {
        const int c = 8 * ks;
        kf[ks] = frag_a<F>(a.k[g0 + c], a.k[g1 + c], a.k[g0 + c + 4], a.k[g1 + c + 4]);
        vf[ks] = frag_a<F>(a.v[g0 + c], a.v[g1 + c], a.v[g0 + c + 4], a.v[g1 + c + 4]);
      }
    }

    const int n_q = (a.len + kQTile - 1) / kQTile;
    for (int qt = 0; qt < n_q; ++qt) {
      if (qt + 1 < n_q) {
        load_query_stage(a, stages + ((qt + 1) & 1) * kQStageFloats, b, h, (qt + 1) * kQTile,
                         drop_h);
      }
      cp_async_commit();
      cp_async_wait_all_but_newest();
      __syncthreads();
      const float* q_s = stages + (qt & 1) * kQStageFloats;
      const float* do_s = q_s + kQTile * kKStride;
      const float* lse_s = do_s + kQTile * kKStride;
      const float* d_s = lse_s + kQTile;
      const uint32_t* rh_s = reinterpret_cast<const uint32_t*>(d_s + kQTile);

#pragma unroll 1
      for (int sub = 0; sub < kQTile; sub += kQSub) {
        // S^T = K (scale Q)^T and dP^T = V dO^T: keys x kQSub query rows
        float st[kQSub / 8][4], dpt[kQSub / 8][4];
#pragma unroll
        for (int n = 0; n < kQSub / 8; ++n) {
          const int off = (sub + 8 * n + g) * kKStride + t;
          dot_form<F, true>(st[n], kf, q_s + off, a.scale);
          dot_form<F, true>(dpt[n], vf, do_s + off, 1.f);
        }

        // P^T z and dS^T in place; this lane's query rows are 2t, 2t + 1
        // of each 8
#pragma unroll
        for (int n = 0; n < kQSub / 8; ++n) {
          const int li = sub + 8 * n + 2 * t;  // the first of the two rows, in the stage
          const int row = qt * kQTile + li;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = e & 1;  // which of the two rows
            const int r = e >> 1;  // which of the two keys
            const bool live = key_ok[r] && row + c < a.len;
            const float p = live ? exp2_fast((st[n][e] - lse_s[li + c]) * kLog2e) : 0.f;
            const float z = a.threshold != 0u
                                ? drop_scale(rh_s[li + c], key[r], a.threshold, a.keep_scale)
                                : 1.f;
            st[n][e] = p * z;
            dpt[n][e] = p * (z * dpt[n][e] - d_s[li + c]);
          }
        }

        // dv += (P z)^T dO and dk += dS^T Q over those rows, in fresh
        // accumulators added to dk and dv on the CUDA cores
        float pdv[kDh / 8][4], pdk[kDh / 8][4];
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pdv[n][e] = 0.f;
            pdk[n][e] = 0.f;
          }
#pragma unroll
        for (int kk = 0; kk < kQSub / 8; ++kk) {
          const FragA pa = frag_a_from_c<F>(st[kk]);
          const FragA da = frag_a_from_c<F>(dpt[kk]);
          const int off = (sub + 8 * kk + 2 * t) * kKStride + g;
#pragma unroll
          for (int n = 0; n < kDh / 8; ++n) {
            mma_form<F>(pdv[n], pa, frag_b<F>(do_s[off + 8 * n], do_s[off + kKStride + 8 * n]));
            mma_form<F>(pdk[n], da, frag_b<F>(q_s[off + 8 * n], q_s[off + kKStride + 8 * n]));
          }
        }
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dv[n][e] += pdv[n][e];
            dk[n][e] += pdk[n][e];
          }
      }
      __syncthreads();  // this stage is free for the tile after next
    }
    cp_async_wait_all();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.len) continue;
    const size_t g0 = ((size_t)b * a.len + key[r]) * d_model + h * kDh + 2 * t;
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      *reinterpret_cast<float2*>(a.dk + g0 + 8 * n) =
          make_float2(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<float2*>(a.dv + g0 + 8 * n) = make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kWarps * 32, 3)
flash_bwd_dq_kernel(const Operands a) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  constexpr int kStageFloats = 2 * kDqKeys * kKStride;
  __shared__ uint32_t key_bits[kMaskWords];
  __shared__ unsigned tile_mask;
  if constexpr (F == kFormBF16) {  // its own body, on the bf16 instruction (above)
    dq_bf16(a, reinterpret_cast<unsigned char*>(smem4), key_bits, &tile_mask);
    return;
  }

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d_model = a.heads * kDh;
  const float* kb = a.k + (size_t)b * a.len * d_model;
  const float* vb = a.v + (size_t)b * a.len * d_model;
  const int row0 = (int)blockIdx.x * kDqRows + warp * 16 + g;
  const int row[2] = {row0, row0 + 8};

  build_key_mask(key_bits, &tile_mask, a.key_valid + (size_t)b * a.len, a.len);
  const unsigned mask = tile_mask;
  int tile = next_tile(mask, 0);
  if (tile >= 0) {
    load_kv_tile(stages, stages + kDqKeys * kKStride, kb, vb, tile * kDqKeys, kDqKeys, a.len,
                 d_model, h);
  }
  cp_async_commit();

  // the warp's 16 rows of scale * q and of dO, split, as A operands; the
  // rows' lse, D and dropout hashes
  FragA qf[kDh / 8], of[kDh / 8];
  float lse_r[2], dd[2];
  uint32_t drop_r[2] = {0u, 0u};
  {
    const int rc[2] = {min(row[0], a.len - 1), min(row[1], a.len - 1)};
    const size_t g0 = ((size_t)b * a.len + rc[0]) * d_model + h * kDh + t;
    const size_t g1 = ((size_t)b * a.len + rc[1]) * d_model + h * kDh + t;
#pragma unroll
    for (int ks = 0; ks < kDh / 8; ++ks) {
      const int c = 8 * ks;
      qf[ks] = frag_a<F>(a.q[g0 + c] * a.scale, a.q[g1 + c] * a.scale, a.q[g0 + c + 4] * a.scale,
                      a.q[g1 + c + 4] * a.scale);
      of[ks] = frag_a<F>(a.d_out[g0 + c], a.d_out[g1 + c], a.d_out[g0 + c + 4],
                      a.d_out[g1 + c + 4]);
    }
    const uint32_t drop_h = drop_head(drop_seed(a.seed), b * a.heads + h);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t gi = ((size_t)b * a.heads + h) * a.len + rc[r];
      lse_r[r] = a.lse[gi];
      dd[r] = a.delta[gi];
      if (a.threshold != 0u) drop_r[r] = drop_row(drop_h, row[r]);
    }
  }
  const bool live[2] = {row[0] < a.len, row[1] < a.len};

  float dq[kDh / 8][4];
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  float d_sum[2] = {0.f, 0.f};  // this lane's share of D' = rowsum(P z dP)

  for (int it = 0; tile >= 0; ++it) {
    const int next = next_tile(mask, tile + 1);
    if (next >= 0) {
      float* st = stages + ((it + 1) & 1) * kStageFloats;
      load_kv_tile(st, st + kDqKeys * kKStride, kb, vb, next * kDqKeys, kDqKeys, a.len, d_model,
                   h);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const float* k_s = stages + (it & 1) * kStageFloats;
    const float* v_s = k_s + kDqKeys * kKStride;

#pragma unroll 1
    for (int c0 = 0; c0 < kDqKeys; c0 += kDqChunk) {
      const int j0 = tile * kDqKeys + c0;
      uint32_t words[kDqChunk / 32], any = 0u;
#pragma unroll
      for (int w = 0; w < kDqChunk / 32; ++w) any |= words[w] = key_bits[(j0 >> 5) + w];
      if (any == 0u) continue;  // the same in every warp

      // S = (scale Q) K^T and dP = dO V^T for the chunk's keys
      float s[kDqChunk / 8][4], dp[kDqChunk / 8][4];
#pragma unroll
      for (int n = 0; n < kDqChunk / 8; ++n) {
        const int off = (c0 + 8 * n + g) * kKStride + t;
        dot_form<F>(s[n], qf, k_s + off, 1.f);
        dot_form<F>(dp[n], of, v_s + off, 1.f);
      }

      // dS in place of S
#pragma unroll
      for (int n = 0; n < kDqChunk / 8; ++n) {
        const uint32_t bits = words[n >> 2] >> ((n & 3) * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool ok = live[r] && ((bits >> (e & 1)) & 1u);
          const float p = ok ? exp2_fast((s[n][e] - lse_r[r]) * kLog2e) : 0.f;
          const float z =
              a.threshold != 0u
                  ? drop_scale(drop_r[r], j0 + 8 * n + 2 * t + (e & 1), a.threshold, a.keep_scale)
                  : 1.f;
          d_sum[r] += p * (z * dp[n][e]);
          s[n][e] = p * (z * dp[n][e] - dd[r]);
        }
      }

      // dq += dS K: dS from registers, K's key rows in the order 2t, 2t + 1;
      // the chunk's sum in fresh accumulators, added to dq on the CUDA cores
      float pdq[kDh / 8][4];
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pdq[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDqChunk / 8; ++kk) {
        const FragA da = frag_a_from_c<F>(s[kk]);
        const float* kr = k_s + (c0 + 8 * kk + 2 * t) * kKStride + g;
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n) {
          mma_form<F>(pdq[n], da, frag_b<F>(kr[8 * n], kr[kKStride + 8 * n]));
        }
      }
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] += pdq[n][e];
    }
    __syncthreads();  // this stage is free for the tile after next
    tile = next;
  }
  cp_async_wait_all();

  // D' over the quad, in a fixed order, for the dk/dv kernel: every lane of
  // the quad read its rows' D above, before this write
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    d_sum[r] += __shfl_xor_sync(0xffffffffu, d_sum[r], 1);
    d_sum[r] += __shfl_xor_sync(0xffffffffu, d_sum[r], 2);
    if (!live[r]) continue;
    if (t == 0) a.delta[((size_t)b * a.heads + h) * a.len + row[r]] = d_sum[r];
    float* o = a.dq + ((size_t)b * a.len + row[r]) * d_model + h * kDh + 2 * t;
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
    }
  }
}

template <int F>
constexpr int kDkdvSmem = F == kFormBF16 ? 2 * kQStageBytesBF16
                                         : (int)sizeof(float) * 2 * kQStageFloats;
template <int F>
constexpr int kDqSmem = F == kFormBF16 ? 2 * 2 * kKvTileBF16 * 2
                                       : (int)sizeof(float) * 2 * 2 * kDqKeys * kKStride;

// the dq kernel, then the dk/dv kernel, which reads the D' the dq kernel
// leaves in a.delta
template <int F>
cudaError_t launch_products(const Operands& a, int batch, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem<F>);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<F>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<F><<<dim3((a.len + kDqRows - 1) / kDqRows, a.heads, batch), kWarps * 32,
                           kDqSmem<F>, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem<F>);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<F><<<dim3((a.len + kKvKeys - 1) / kKvKeys, a.heads, batch),
                             kWarps * 32, kDkdvSmem<F>, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the pre-pass, the dq kernel and the dk/dv kernel on `stream` and
// returns cudaGetLastError() (0 = launched). q, k, v, out, d_out, dq, dk, dv
// (B, L, H*Dh); key_valid (B, L); lse and delta (B, H, L), delta scratch
// (the pre-pass writes D there, the dq kernel D'); threshold = floor(p *
// 2^24) (0 = no dropout), keep_scale = 1 / (1 - p), seed the forward's (device
// memory; null without dropout);
// form the products' form, 0 3xTF32, 1 1xTF32, 2 bf16 (attn_common.cuh),
// any other value refused. f32, contiguous and 16-byte aligned;
// 1 <= L <= 4096, Dh = 32.
int flashvtg_flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                                     const float* key_valid, const float* out,
                                     const float* lse, const float* d_out, float* delta,
                                     float* dq, float* dk, float* dv, int batch, int len,
                                     int heads, int head_dim, float scale, const unsigned* seed,
                                     unsigned threshold, float keep_scale, int form,
                                     void* stream) {
  if (head_dim != kDh || len < 1 || len > kMaxLen || batch < 1 || batch > 65535 ||
      heads < 1 || heads > 65535 || form < kForm3xTF32 || form > kFormBF16 ||
      (threshold != 0u && seed == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = batch * len;
  flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, s>>>(out, d_out, delta, rows, len, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const Operands a = {q, k, v, key_valid, lse, d_out, delta, dq, dk, dv,
                      len, heads, scale, seed, threshold, keep_scale};
  switch (form) {
    case kForm1xTF32: return (int)launch_products<kForm1xTF32>(a, batch, s);
    case kFormBF16: return (int)launch_products<kFormBF16>(a, batch, s);
    default: return (int)launch_products<kForm3xTF32>(a, batch, s);
  }
}

}  // extern "C"
