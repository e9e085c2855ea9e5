// Memory-linear masked self-attention over any number of keys, for Hopper
// (sm_90a): the products on the tensor cores in 3xTF32 (f32-accurate),
// 1xTF32 (both on mma.sync.m16n8k8) or bf16 (on m16n8k16), as the precision
// dial asks.
//
// Replaces: the long, memory-linear form of JAX's library Pallas kernel
// jax.experimental.pallas.ops.tpu.flash_attention (called at
// scripts/bench_flash.py:57) and, on the JAX package's model path,
// flashvtg_tpu/ops/chunked_attn.py:44 `chunked_attention`, which the encoder
// runs (flashvtg_tpu/models/transformer.py:246-255) whenever a video has more
// clips than attn_chunk: the long-video presets (tacos, charades_vgg: 2048
// clips; tvsum, youtube_uni: 1000).
//
// What it computes, for batch row b, query row i and head h:
//   logits_j = (scale * q[b, i, h]) . k[b, j, h]     over valid keys j
//   out[b, i, h*Dh:(h+1)*Dh] = sum_j softmax_j(logits) * v[b, j, h]
// q is scaled before the dot product, in the order of transformer.py:243.
// q, k, v and out are (B, L, H*Dh) in the model's merged-head layout; the
// key mask (B, L) may be any pattern, not only a valid prefix. A row whose
// batch row has no valid key at all gets zeros (never reached on the model's
// path: every video has at least one clip); the plain PyTorch version gives
// NaN there.
//
// Memory-linear: an online softmax over key tiles (a running max and sum per
// row, the accumulator rescaled when the max grows). Neither the (B, H, L, L)
// logits nor a (B, H, L, chunk) slab exists in device memory: a warp's
// logits and probabilities live in its registers only.
//
// What bounds it (3xTF32): per valid (b, h, i, j) pair, 128 FLOP of dot products
// (q.k and p.v, 64 each) and about 5 other operations (the softmax). The
// card's f32-accurate rate for dot products is 3xTF32's, 495 / 3 = 165
// TFLOP/s; the rest runs at the 67 TFLOP/s f32 rate. At the TACoS eval shape
// (B=8, H=8, L=2048, 10,878 of 16,384 keys valid) that is 22.8 GFLOP, 0.14 ms,
// against ~67 MB of inputs and outputs (0.02 ms at 3.35 TB/s): bound by
// operations, on the tensor cores. The design:
//  * a block owns one (batch row, head) and 64 query rows, four warps of
//    16: a warp's rows are the M of mma.sync.m16n8k8, and its scaled Q
//    fragments stay in registers, already split, for the whole kernel (four
//    warps at up to 170 registers hold three blocks an SM; eight warps of 16
//    were no faster on the card);
//  * the key mask becomes one bit per key in shared memory (a ballot per 32
//    keys) and the 32-bit tile mask, one bit per 128-key tile: a tile with
//    no valid key is skipped, so ragged batches pay for the keys they hold,
//    and so is a 64-key chunk with none;
//  * K and V tiles of 128 keys go through a ring of two stages of 16-byte
//    cp.async copies (rows padded to 36 floats: every fragment load of a
//    warp hits 32 distinct banks), the next tile's copies in flight while
//    this one computes;
//  * S = Q K^T for 64 keys at a time goes to mma accumulators (32 registers
//    a lane), and the online softmax runs on those fragments: a lane holds
//    two rows, and the row max is taken across the four lanes of a quad with
//    two shuffles; exp2 with the log2 e fold, of s - m (exactly 1 at the
//    max);
//  * P feeds p.v from registers as the A operand: the C layout holds keys
//    {2t, 2t+1} where A wants k-columns {t, t+4}, so the V fragment is loaded
//    with its key rows in that order instead of moving P;
//  * the tensor core's f32 accumulation truncates, so no chain of products
//    runs long: each S tile takes each k-step's hi.hi product in a fresh
//    accumulator (attn_common.cuh dot_form), and each chunk's p.v goes to
//    fresh accumulators added to O on the CUDA cores (one chain over 4096
//    keys missed the 1e-5 tolerance);
//  * each lane keeps its own share of the row sums; the quad sums them once
//    at the end, in a fixed order, and no float atomics are used: launches
//    agree bit for bit.
// Why 3xTF32 is the f32 parity mode: each operand is split into two TF32
// parts (attn_common.cuh), and the three products keep about 22 significant
// bits, the accuracy of f32 on CUDA cores (CUTLASS's OpMultiplyAddFastF32);
// forwards agree with the f32 plain version within 1e-5. A single TF32
// product keeps about three decimal digits (it misses that tolerance in
// the emulation of tests/test_torch_tf32x3.py): that is the tensorfloat32
// form, and bf16 operands with f32 sums the bfloat16 form (attn_common.cuh;
// the template F, chosen by the C entries' `form`).
//
// The bf16 form has a body of its own (flash_bf16 below), on the bf16
// instruction mma.sync.m16n8k16 from bf16 K and V tiles in shared memory:
//  * K and V are rounded to bf16 once a block, where they are staged (two
//    stages of 2 x 128 rows of kBStride bf16, 40 KB, against the f32 forms'
//    72 KB), loaded through registers a 64-key chunk at a time so that the
//    next tile's rows are in flight while the chunk computes; the f32 forms
//    convert every K and V value in each of the four warps, inside the
//    product loops;
//  * S = (scale Q) K^T is attn_common.cuh dot_bf16 on bf16(scale q) in
//    registers and K by ldmatrix: the function the backward's kernels take
//    S by, bit for bit, so at a row's only key lse = m = s exactly and the
//    backward's P is exactly 1 there;
//  * P feeds P V as bf16 A operands in natural key order (the C tiles of two
//    adjacent n-tiles), V's B operand by ldmatrix.trans;
//  * a 64-key chunk takes 32 tensor-core instructions a warp (16 for S, 16
//    for P V) against the m16n8k8 form's 64; the mask, max, exp2, row sums
//    and dropout hash on the CUDA cores are the other forms'.
// Its bound: the same pairs' dot products at the bf16 rate, 989 TFLOP/s
// (0.023 ms at the TACoS eval shape), against the same inputs and outputs;
// but each valid pair also takes one exp2 on the special-function unit (16
// a clock an SM: 0.04 ms at that shape) and ~6 other CUDA-core
// instructions, so the CUDA cores, not the tensor cores, bound it.
//
// Training form (flashvtg_flash_attention_train_f32, template TRAIN; the
// eval entry point compiles without it): it also writes the row log-sum-exp
// lse[b, h, i] = m + log(l) in natural-log units for the backward
// (flash_attention_bwd.cu), and multiplies each probability that feeds p.v
// by the attention-dropout scale (attn_dropout.cuh's hash of (seed, b H + h,
// i, j), evaluated per accumulator element); the row sum l keeps the
// undropped probabilities.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "attn_dropout.cuh"

namespace {

constexpr int kWarps = 4;               // 16 query rows each
constexpr int kMinBlocks = 3;           // per SM: caps a thread at 65536 / (32 kWarps kMinBlocks) registers
constexpr int kMinBlocksBF16 = 4;       // the same, for the bf16 form's body (128 registers,
                                        // no spills; 3 ran 4-9 % slower on the card)
constexpr int kTileRows = 16 * kWarps;  // query rows per block
constexpr int kTileKeys = 128;          // keys per staged tile (one bit of the tile mask)
constexpr int kChunk = 64;              // keys per S fragment set, 32 or 64
static_assert(kChunk == 32 || kChunk == 64, "a chunk is one or two mask words");
constexpr int kChunkTiles = kChunk / 8;
constexpr int kMaxLen = kTileKeys * (kMaskWords / 4);

constexpr int kStageFloats = 2 * kTileKeys * kKStride;  // K, V

// ---- the bf16 form on mma.sync.m16n8k16 (attn_common.cuh) -------------------
//
// The same kernel on bf16 K and V tiles (the design: this file's header);
// the online softmax on the C fragments is the other forms' (m16n8k16's C
// layout is m16n8k8's), so the mask bits, the dropout index and the lse
// write keep their indices.

constexpr int kKvTileBF16 = kTileKeys * kBStride;  // bf16 elements
constexpr int kStageElemsBF16 = 2 * kKvTileBF16;   // K, V
using KvRowsBF16 = RowsBF16<kChunk, kWarps * 32>;

template <int F>
constexpr int kSmemBytes = F == kFormBF16 ? (int)sizeof(uint16_t) * 2 * kStageElemsBF16
                                          : (int)sizeof(float) * 2 * kStageFloats;

template <bool TRAIN>
__device__ __forceinline__ void flash_bf16(const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ key_valid,
                                           float* __restrict__ out, int len, int heads,
                                           float scale, float* __restrict__ lse,
                                           const uint32_t* __restrict__ seed,
                                           uint32_t threshold, float keep_scale,
                                           uint16_t* tiles, uint32_t* key_bits,
                                           unsigned* tile_mask) {
  static_assert(kChunk % 16 == 0, "whole k16 steps of P V a chunk");
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d_model = heads * kDh;
  const size_t head0 = (size_t)b * len * d_model + h * kDh;
  const float* kb = k + head0;
  const float* vb = v + head0;
  const bool drop = TRAIN && threshold != 0u;
  const int row0 = (int)blockIdx.x * kTileRows + warp * 16 + g;
  const int row[2] = {row0, row0 + 8};
  // ldmatrix rows: as stored (K for S), and transposed, 8-row halves (V)
  const int ld_row = lane & 7, ld_col = 8 * (lane >> 3);
  const int tr_row = 8 * ((lane >> 3) & 1) + (lane & 7), tr_col = 8 * (lane >> 4);

  build_key_mask(key_bits, tile_mask, key_valid + (size_t)b * len, len);
  const unsigned mask = *tile_mask;
  int tile = next_tile(mask, 0);
  if (tile >= 0) {
#pragma unroll 1
    for (int c0 = 0; c0 < kTileKeys; c0 += kChunk) {
      KvRowsBF16 kr, vr;
      kr.load(kb, d_model, tile * kTileKeys + c0, len, -1);
      vr.load(vb, d_model, tile * kTileKeys + c0, len, -1);
      kr.store(tiles, c0);
      vr.store(tiles + kKvTileBF16, c0);
    }
  }

  // the warp's 16 rows of bf16(scale q), the A operand of S's two k16
  // steps; rows past len read row len - 1, computed and never written
  uint32_t qf[kDh / 16][4];
  {
    const int rc[2] = {min(row[0], len - 1), min(row[1], len - 1)};
    frag_a16_rows(qf, q + head0 + (size_t)rc[0] * d_model + 2 * t,
                  (size_t)(rc[1] - rc[0]) * d_model, scale);
  }
  uint32_t drop_r[2] = {0u, 0u};
  if (drop) {
    const uint32_t drop_h = drop_head(drop_seed(seed), b * heads + h);
    drop_r[0] = drop_row(drop_h, row[0]);
    drop_r[1] = drop_row(drop_h, row[1]);
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[kDh / 8][4];
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  __syncthreads();  // the first tile is in place

  for (int it = 0; tile >= 0; ++it) {
    const int next = next_tile(mask, tile + 1);
    const uint16_t* k_s = tiles + (it & 1) * kStageElemsBF16;
    const uint16_t* v_s = k_s + kKvTileBF16;
    uint16_t* nk_s = tiles + ((it + 1) & 1) * kStageElemsBF16;

#pragma unroll 1
    for (int c0 = 0; c0 < kTileKeys; c0 += kChunk) {
      // the next tile's keys of this chunk, in flight while it computes
      KvRowsBF16 k_next, v_next;
      if (next >= 0) {
        k_next.load(kb, d_model, next * kTileKeys + c0, len, -1);
        v_next.load(vb, d_model, next * kTileKeys + c0, len, -1);
      }
      const int j0 = tile * kTileKeys + c0;
      uint32_t words[kChunk / 32], any = 0u;
#pragma unroll
      for (int w = 0; w < kChunk / 32; ++w) any |= words[w] = key_bits[(j0 >> 5) + w];
      if (any != 0u) {  // the same in every warp
        // S = (scale Q) K^T for the chunk's keys
        float s[kChunkTiles][4];
#pragma unroll
        for (int n = 0; n < kChunkTiles; ++n) {
          uint32_t kf[4];
          ldsm_x4(kf, k_s + (c0 + 8 * n + ld_row) * kBStride + ld_col);
          dot_bf16(s[n], qf, kf);
        }

        // masked keys to -inf, then the chunk's row max across the quad
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < kChunkTiles; ++n) {
          const uint32_t bits = words[n >> 2] >> ((n & 3) * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!((bits >> (e & 1)) & 1u)) s[n][e] = -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
        }
        float m_use[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          m_use[r] = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = exp2_fast((m[r] - m_use[r]) * kLog2e);
          m[r] = m_new;
          l[r] *= alpha;
#pragma unroll
          for (int n = 0; n < kDh / 8; ++n) {
            o[n][2 * r] *= alpha;
            o[n][2 * r + 1] *= alpha;
          }
        }

        // P (0 at masked keys), the row sums, and the probabilities P V reads
#pragma unroll
        for (int n = 0; n < kChunkTiles; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = exp2_fast((s[n][e] - m_use[r]) * kLog2e);
            l[r] += p;
            s[n][e] = drop ? p * drop_scale(drop_r[r], j0 + 8 * n + 2 * t + (e & 1), threshold,
                                            keep_scale)
                           : p;
          }
        }

        // O += P V: P from registers, a k16 step per 16 keys, V read
        // transposed; the chunk's sum in fresh accumulators, added to O on
        // the CUDA cores
        float pv[kDh / 8][4];
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          uint32_t pa[4];
          frag_a16_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
          for (int np = 0; np < kDh / 16; ++np) {
            uint32_t vt[4];
            ldsm_x4_trans(vt, v_s + (c0 + 16 * kk + tr_row) * kBStride + 16 * np + tr_col);
            mma_bf16(pv[2 * np], pa, vt[0], vt[1]);
            mma_bf16(pv[2 * np + 1], pa, vt[2], vt[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] += pv[n][e];
      }
      if (next >= 0) {
        k_next.store(nk_s, c0);
        v_next.store(nk_s + kKvTileBF16, c0);
      }
    }
    __syncthreads();  // the next tile is in place; this one is free for the tile after
    tile = next;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= len) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no valid key: zeros
    float* orow = out + ((size_t)b * len + row[r]) * d_model + h * kDh + 2 * t;
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    if (TRAIN && t == 0) lse[((size_t)b * heads + h) * len + row[r]] = m[r] + logf(l[r]);
  }
}

// F = the product form (attn_common.cuh); TRAIN = the training form
template <int F, bool TRAIN>
__global__ void __launch_bounds__(kWarps * 32, F == kFormBF16 ? kMinBlocksBF16 : kMinBlocks)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ key_valid,
                       float* __restrict__ out, int len, int heads,
                       float scale, float* __restrict__ lse,
                       const uint32_t* __restrict__ seed, uint32_t threshold,
                       float keep_scale) {
  extern __shared__ float4 smem4[];
  __shared__ uint32_t key_bits[kMaskWords];
  __shared__ unsigned tile_mask;
  if constexpr (F == kFormBF16) {  // its own body, on the bf16 instruction (above)
    flash_bf16<TRAIN>(q, k, v, key_valid, out, len, heads, scale, lse, seed, threshold,
                      keep_scale, reinterpret_cast<uint16_t*>(smem4), key_bits, &tile_mask);
  } else {
    float* stages = reinterpret_cast<float*>(smem4);

    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int d_model = heads * kDh;
    const float* qb = q + (size_t)b * len * d_model;
    const float* kb = k + (size_t)b * len * d_model;
    const float* vb = v + (size_t)b * len * d_model;
    const bool drop = TRAIN && threshold != 0u;
    // this lane's rows: row[0] and row[1] = row[0] + 8
    const int row0 = (int)blockIdx.x * kTileRows + warp * 16 + g;
    const int row[2] = {row0, row0 + 8};

    build_key_mask(key_bits, &tile_mask, key_valid + (size_t)b * len, len);
    const unsigned mask = tile_mask;
    int tile = next_tile(mask, 0);
    if (tile >= 0) {
      load_kv_tile(stages, stages + kTileKeys * kKStride, kb, vb, tile * kTileKeys, kTileKeys,
                   len, d_model, h);
    }
    cp_async_commit();

    // the warp's 16 rows of scale * q, split, as the A operand of the four
    // k-steps of q.k; rows past len read row len - 1, computed and never written
    FragA qf[kDh / 8];
    {
      const float* q0 = qb + (size_t)min(row[0], len - 1) * d_model + h * kDh + t;
      const float* q1 = qb + (size_t)min(row[1], len - 1) * d_model + h * kDh + t;
#pragma unroll
      for (int ks = 0; ks < kDh / 8; ++ks) {
        qf[ks] = frag_a<F>(q0[8 * ks] * scale, q1[8 * ks] * scale, q0[8 * ks + 4] * scale,
                        q1[8 * ks + 4] * scale);
      }
    }
    uint32_t drop_r[2] = {0u, 0u};
    if (drop) {
      const uint32_t drop_h = drop_head(drop_seed(seed), b * heads + h);
      drop_r[0] = drop_row(drop_h, row[0]);
      drop_r[1] = drop_row(drop_h, row[1]);
    }

    // online softmax state of the lane's two rows (the same in the four lanes
    // of a quad), this lane's share of the row sums, and the output fragments
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float o[kDh / 8][4];
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

    for (int it = 0; tile >= 0; ++it) {
      const int next = next_tile(mask, tile + 1);
      if (next >= 0) {
        float* st = stages + ((it + 1) & 1) * kStageFloats;
        load_kv_tile(st, st + kTileKeys * kKStride, kb, vb, next * kTileKeys, kTileKeys, len,
                     d_model, h);
      }
      cp_async_commit();
      cp_async_wait_all_but_newest();  // this thread's copies of `tile` landed
      __syncthreads();                 // and every other thread's
      const float* k_s = stages + (it & 1) * kStageFloats;
      const float* v_s = k_s + kTileKeys * kKStride;

#pragma unroll 1
      for (int c0 = 0; c0 < kTileKeys; c0 += kChunk) {
        const int j0 = tile * kTileKeys + c0;
        uint32_t words[kChunk / 32], any = 0u;
#pragma unroll
        for (int w = 0; w < kChunk / 32; ++w) any |= words[w] = key_bits[(j0 >> 5) + w];
        if (any == 0u) continue;  // the same in every warp

        // S = (scale Q) K^T for the chunk's keys
        float s[kChunkTiles][4];
#pragma unroll
        for (int n = 0; n < kChunkTiles; ++n) {
          dot_form<F>(s[n], qf, k_s + (c0 + 8 * n + g) * kKStride + t, 1.f);
        }

        // masked keys to -inf, then the chunk's row max across the quad
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < kChunkTiles; ++n) {
          const uint32_t bits = words[n >> 2] >> ((n & 3) * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!((bits >> (e & 1)) & 1u)) s[n][e] = -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
        }
        // p = exp2((s - m) log2 e): exactly 1 at the row's max, so that a row
        // with one valid key gets P = 1 and lse = m exactly, as the backward
        // recomputes them
        float m_use[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          // -inf only while no valid key has come yet: nothing to rescale
          m_use[r] = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = exp2_fast((m[r] - m_use[r]) * kLog2e);  // 0 while m is -inf
          m[r] = m_new;
          l[r] *= alpha;
#pragma unroll
          for (int n = 0; n < kDh / 8; ++n) {
            o[n][2 * r] *= alpha;
            o[n][2 * r + 1] *= alpha;
          }
        }

        // P (0 at masked keys), the row sums, and the probabilities p.v reads
#pragma unroll
        for (int n = 0; n < kChunkTiles; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = exp2_fast((s[n][e] - m_use[r]) * kLog2e);
            l[r] += p;
            s[n][e] = drop ? p * drop_scale(drop_r[r], j0 + 8 * n + 2 * t + (e & 1), threshold,
                                            keep_scale)
                           : p;
          }
        }

        // O += P V: P from registers, V's key rows in the order 2t, 2t + 1;
        // the chunk's sum in fresh accumulators, added to O on the CUDA cores
        float pv[kDh / 8][4];
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kChunkTiles; ++kk) {
          const FragA pa = frag_a_from_c<F>(s[kk]);
          const float* vr = v_s + (c0 + 8 * kk + 2 * t) * kKStride + g;
#pragma unroll
          for (int n = 0; n < kDh / 8; ++n) {
            mma_form<F>(pv[n], pa, frag_b<F>(vr[8 * n], vr[kKStride + 8 * n]));
          }
        }
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] += pv[n][e];
      }
      __syncthreads();  // this stage is free for the tile after next
      tile = next;
    }
    cp_async_wait_all();  // a block with no valid key never waited

    // the row sums across the quad, in a fixed order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (row[r] >= len) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no valid key: zeros
      float* orow = out + ((size_t)b * len + row[r]) * d_model + h * kDh + 2 * t;
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      }
      if (TRAIN && t == 0) lse[((size_t)b * heads + h) * len + row[r]] = m[r] + logf(l[r]);
    }
  }
}

template <int F, bool TRAIN>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* key_valid, float* out, int batch, int len,
                   int heads, int head_dim, float scale, float* lse, const uint32_t* seed,
                   uint32_t threshold, float keep_scale, cudaStream_t stream) {
  if (head_dim != kDh || len < 1 || len > kMaxLen || batch < 1 ||
      batch > 65535 || heads < 1 || heads > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<F, TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes<F>);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_kernel<F, TRAIN>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((len + kTileRows - 1) / kTileRows, heads, batch);
  flash_attention_kernel<F, TRAIN><<<grid, kWarps * 32, kSmemBytes<F>, stream>>>(
      q, k, v, key_valid, out, len, heads, scale, lse, seed, threshold, keep_scale);
  return cudaGetLastError();
}

template <bool TRAIN>
cudaError_t launch_form(int form, const float* q, const float* k, const float* v,
                        const float* key_valid, float* out, int batch, int len, int heads,
                        int head_dim, float scale, float* lse, const uint32_t* seed,
                        uint32_t threshold, float keep_scale, cudaStream_t stream) {
#define FLASH_FORM(F)                                                                     \
  launch<F, TRAIN>(q, k, v, key_valid, out, batch, len, heads, head_dim, scale, lse, seed, \
                   threshold, keep_scale, stream)
  switch (form) {
    case kForm3xTF32: return FLASH_FORM(kForm3xTF32);
    case kForm1xTF32: return FLASH_FORM(kForm1xTF32);
    case kFormBF16: return FLASH_FORM(kFormBF16);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_FORM
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// q, k, v and out (B, L, H*Dh), key_valid (B, L); all f32, contiguous and
// 16-byte aligned; 1 <= L <= 4096, Dh = 32. form: the products' form, 0
// 3xTF32, 1 1xTF32, 2 bf16 (attn_common.cuh); any other value is refused.
int flashvtg_flash_attention_f32(const float* q, const float* k, const float* v,
                                 const float* key_valid, float* out, int batch,
                                 int len, int heads, int head_dim, float scale,
                                 int form, void* stream) {
  return (int)launch_form<false>(form, q, k, v, key_valid, out, batch, len, heads, head_dim,
                                 scale, nullptr, nullptr, 0u, 1.f, (cudaStream_t)stream);
}

// The training form: as above, plus lse (B, H, L) and attention dropout
// (seed a uint32 in device memory, read by the kernel; threshold =
// floor(p * 2^24), keep_scale = 1 / (1 - p); threshold 0 = none, and then
// seed may be null).
int flashvtg_flash_attention_train_f32(const float* q, const float* k, const float* v,
                                       const float* key_valid, float* out, float* lse,
                                       int batch, int len, int heads, int head_dim,
                                       float scale, const unsigned* seed, unsigned threshold,
                                       float keep_scale, int form, void* stream) {
  if (lse == nullptr || (threshold != 0u && seed == nullptr)) return (int)cudaErrorInvalidValue;
  return (int)launch_form<true>(form, q, k, v, key_valid, out, batch, len, heads, head_dim,
                                scale, lse, seed, threshold, keep_scale, (cudaStream_t)stream);
}

}  // extern "C"
