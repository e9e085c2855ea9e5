// Fused masked attention with dummy-dropping values and a fused head mean,
// for Hopper (sm_90a): the products on the tensor cores in 3xTF32
// (f32-accurate) or 1xTF32 (both on mma.sync.m16n8k8) or bf16 (on
// m16n8k16), as the precision dial asks.
//
// Replaces: scripts/bench_aca.py:_aca_kernel / aca_attention, the Pallas ACA
// kernel written for the TPU. Its function runs at every Adaptive
// Cross-Attention layer (flashvtg_tpu/models/transformer.py:80-128) and, with
// no dummies and no head mean, at every self-attention layer
// (transformer.py:236-264).
//
// What it computes, for batch row b, query row i and head h:
//   logits_j = (scale * q[b, i, h]) . k[b, j, h],  invalid keys -> -1e30
//   p_j      = softmax_j(logits)  over all Lk keys, dummies included
//   out[b, i, h*Dh:(h+1)*Dh] = sum_{j >= nd} p_j * v[b, j, h]
//   head_mean[b, i, j]       = (sum_h p_j) / H     (optional)
// q is scaled before the dot product, in the order of transformer.py:100.
// q, k, v are read in the model's merged-head layout (B, L, H*Dh), so no
// head split or merge copies are made; the (B, H, Lv, Lk) probabilities are
// never written.
//
// A row with no valid key (never reached on the model's path: ACA always
// has nd >= 1 valid dummies, and every video and text row has at least one
// valid token) gets uniform weights over all Lk keys, as the Pallas
// kernel's -1e30 fill gives; the plain PyTorch twin gives NaN there.
//
// What bounds it: bytes, at every shape the model gives it
// (chip_smoke.py:attention_bound; dot products priced at 3xTF32's 495 / 3 =
// 165 TFLOP/s). Per valid (b, h, i, j) pair it does 128 FLOP of dot products
// and ~6 other operations, against 2 x 4 x 32 bytes of q and out per (b, i,
// h) and 4 bytes of head mean per (b, i, j): at the flagship eval shape
// (B=256, Lv 75, Lk 42, H 8) ~65 MB, 0.019 ms at 3.35 TB/s; at TACoS eval
// (B=8, Lv 2048, Lk 75) ~38.5 MB, 0.012 ms; the training forms move the
// same bytes plus the row log-sum-exp. The design:
//  * a block owns one batch row and a tile of query rows in 16-row warp
//    tiles (the M of mma.sync.m16n8k8), as few warps as cover the rows
//    evenly, at most 5 (75 rows -> 80, one block; 2048 rows -> 26 blocks of
//    80), fewer where the grid would hold under 1.5 blocks an SM (the
//    flagship train shape, 64 x 75 rows: 320 blocks of one warp instead of
//    64 of five), and loops over the heads: one head's K, V and Q tile go
//    through a ring of two cp.async stages, the next head's copies in flight
//    while this head computes (rows padded to 36 floats: every fragment load
//    of a warp hits 32 distinct banks);
//  * keys are padded to a multiple of 8 (the mma n-tile), not of 32: 42 ->
//    48, 75 -> 80; S = (scale Q) K^T goes to mma accumulators with each
//    k-step's big product in a fresh accumulator (attn_common.cuh
//    dot_form, the same helper and order as the backward, which recomputes
//    S bit for bit);
//  * the softmax runs on the C fragments: a lane holds two rows, and the row
//    max and sum are taken across the four lanes of a quad with shuffles;
//    p = exp2((s - m) log2 e) on the SFU, exactly 1 at the row's max, and
//    lse = m + log(l) in natural-log units (so the backward's P at a row
//    with one valid key is exactly 1);
//  * the head-mean sums stay in registers across heads: with the warp-to-row
//    map fixed, a lane owns the same (row, key) C positions for every head,
//    so the sum over heads has a fixed order and needs no atomics;
//  * p.v takes P from registers as the A operand (the C layout holds keys
//    {2t, 2t+1}, so V's key rows are read in that order); the dummies' key
//    tiles are skipped and P is 0 at the dummies' columns; each 64 keys'
//    p.v goes to fresh accumulators added on the CUDA cores (the tensor
//    core's f32 sums truncate).
// Why 3xTF32 is the f32 parity mode: each operand is split into two TF32
// parts (attn_common.cuh), and the three products keep about 22 significant
// bits, the accuracy of f32 on CUDA cores (CUTLASS's OpMultiplyAddFastF32);
// a single TF32 product keeps about three decimal digits
// (tests/test_torch_tf32x3.py emulates each form). That single product is
// the tensorfloat32 form, and bf16 operands with f32 sums the bfloat16
// form: every kernel is a template on the form (F), the C entries' `form`
// picks the instance, and nothing else changes between 3xTF32 and 1xTF32.
//
// The bf16 form has a body of its own (aca_bf16 below), on the bf16
// instruction mma.sync.m16n8k16 (twice the k of m16n8k8, at twice its
// rate) from bf16 K and V tiles in shared memory:
//  * one f32 stage instead of the ring of two: a head's K, V and Q tile
//    land there by cp.async as before, then K and V are rounded to bf16
//    once a head and block into tiles of round16(lk) rows (kBStride bf16,
//    rows past lk zero), and each warp takes its 16 rows of bf16(scale q)
//    from the stage as the A operand of S; the next head's copies start
//    once the tiles are in place and land while this head computes (two
//    barriers a head; 47 KB a block at the TACoS shape against the ring's
//    69 KB);
//  * S = (scale Q) K^T is attn_common.cuh dot_bf16 on bf16(scale q) and K
//    by ldmatrix, in 8-key n-tiles: the backward's helper and operands, so
//    lse = m + log(l) is bit for bit what the backward subtracts, and P is
//    exactly 1 at a row with one valid key;
//  * P z feeds p.v as a bf16 A operand in natural key order (the C tiles of
//    two adjacent n-tiles; NT is even, and the n-tile past round8(lk), if
//    any, carries P = 0), V's B operand by ldmatrix.trans; the k16 steps
//    of dummies only are skipped (one that straddles nd carries P z = 0 at
//    j < nd); each 64 keys' p.v in fresh accumulators;
//  * the softmax, the masks, the dropout hash, the lse write and the head
//    mean (f32, undropped, in registers, summed over heads in a fixed
//    order) are the other forms'.
//
// Training form (flashvtg_aca_attention_train_f32, template TRAIN; the eval
// entry point compiles without it): it also writes the row log-sum-exp
// lse[b, h, i] = m + log(l) for the backward kernel (aca_attention_bwd.cu);
// it multiplies the probabilities that feed p.v by the attention-dropout
// scale (attn_dropout.cuh, the hash evaluated at each fragment's (i, j)),
// while the head mean keeps them undropped, as transformer.py:117-127; and it
// takes the reference's misaligned train mask (transformer.py:34-48,
// 107-116): with donor rows, (i, j) of (b, h) is also masked where
// !query_valid[d, i] && !donor_key_valid[d, j], d = donor_rows[b, h], a row
// of the donor tables (G rows: the batch in one process, the global batch
// under data parallelism, where d may be another rank's row).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "attn_dropout.cuh"

namespace {

constexpr int kMaxWarps = 5;  // 16 query rows each
constexpr int kMaxKeys = 128;
constexpr int kPvChunk = 8;  // key n-tiles (64 keys) per fresh p.v accumulator set
constexpr int kBlocksBF16 = 3;  // blocks an SM of the bf16 body at NT <= 10
constexpr float kMasked = -1e30f;

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }

// One head's staged inputs, in floats: K and V (round8(lk) rows each), the
// Q tile (tile_rows rows); every row kKStride floats.
__host__ __device__ constexpr int stage_floats(int lk, int tile_rows) {
  return (2 * round8(lk) + tile_rows) * kKStride;
}

// Starts the copies of head h's K, V and Q tile into `stage`. Key rows past
// lk are never copied (zeroed once at the start); tile rows past lv copy
// row lv - 1: they are computed and never written back.
__device__ __forceinline__ void load_head(float* stage, const float* qb, const float* kb,
                                          const float* vb, int h, int row0, int lv, int lk,
                                          int d_model, int tile_rows) {
  float* k_s = stage;
  float* v_s = k_s + round8(lk) * kKStride;
  float* q_s = v_s + round8(lk) * kKStride;
  for (int i = threadIdx.x; i < lk * (kDh / 4); i += blockDim.x) {
    const int j = i >> 3;
    const int c = (i & 7) * 4;
    const size_t g = (size_t)j * d_model + h * kDh + c;
    cp_async16(k_s + j * kKStride + c, kb + g);
    cp_async16(v_s + j * kKStride + c, vb + g);
  }
  for (int i = threadIdx.x; i < tile_rows * (kDh / 4); i += blockDim.x) {
    const int r = i >> 3;
    const int c = (i & 7) * 4;
    const int row = min(row0 + r, lv - 1);
    cp_async16(q_s + r * kKStride + c, qb + (size_t)row * d_model + h * kDh + c);
  }
}

// What the training form takes beside the eval operands: null pointers and
// threshold 0 switch each part off.
struct TrainArgs {
  const float* query_valid;      // donor table (G, Lv), with donor_rows
  const float* donor_key_valid;  // donor table (G, Lk), with donor_rows
  const int* donor_rows;         // (B, H), rows of the donor tables
  float* lse;                // (B, H, Lv)
  const uint32_t* seed;      // device memory, attn_dropout.cuh; null without dropout
  uint32_t threshold;  // attn_dropout.cuh; 0 = no dropout
  float keep_scale;    // 1 / (1 - p)
};

// ---- the bf16 form on mma.sync.m16n8k16 (attn_common.cuh) -------------------
//
// The same kernel on bf16 K and V tiles (the design: this file's header).
// The softmax, the masks, the dropout, the head mean and the lse write are
// the other forms' (m16n8k16's C layout is m16n8k8's, so a lane's keys and
// their mask bits keep their indices); S, p.v and the staging differ.

// Shared memory of the bf16 form, in bytes: one f32 stage (the copies of
// the next head land there while this head computes), then K and V of the
// head as bf16 tiles of 8 NT rows (whole k16 steps of p.v)
template <int NT>
__host__ __device__ constexpr int bf16_smem_bytes(int lk, int tile_rows) {
  return (int)sizeof(float) * stage_floats(lk, tile_rows) +
         (int)sizeof(uint16_t) * 2 * 8 * NT * kBStride;
}

template <int NT, bool HM, bool TRAIN>
__device__ __forceinline__ void aca_bf16(const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ key_valid,
                                         float* __restrict__ out, float* __restrict__ head_mean,
                                         int lv, int lk, int heads, int nd, int tile_rows,
                                         float scale, TrainArgs tr, float* stage) {
  static_assert(NT % 2 == 0 && kPvChunk % 2 == 0, "whole k16 steps of p.v");
  const int lkp = round8(lk);
  const int nt = lkp >> 3;
  const int kk0 = nd >> 4;  // the first k16 step of p.v that holds a non-dummy key
  const float* k32 = stage;
  const float* v32 = k32 + lkp * kKStride;
  const float* q32 = v32 + lkp * kKStride;
  uint16_t* k_s = reinterpret_cast<uint16_t*>(stage + stage_floats(lk, tile_rows));
  uint16_t* v_s = k_s + 8 * NT * kBStride;

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16;
  const int row0 = (int)blockIdx.x * tile_rows + wrow + g;
  const int row[2] = {row0, row0 + 8};
  const int d_model = heads * kDh;
  const float* qb = q + (size_t)b * lv * d_model;
  const float* kb = k + (size_t)b * lk * d_model;
  const float* vb = v + (size_t)b * lk * d_model;
  const bool drop = TRAIN && tr.threshold != 0u;
  // ldmatrix rows: as stored (K for S), and transposed, 8-row halves (V)
  const int ld_row = lane & 7, ld_col = 8 * (lane >> 3);
  const int tr_row = 8 * ((lane >> 3) & 1) + (lane & 7), tr_col = 8 * (lane >> 4);

  // K's and V's rows past lk, zero once: P is 0 there, and 0 times stale
  // shared memory could be NaN
  for (int i = threadIdx.x; i < (8 * NT - lk) * (kDh / 4); i += blockDim.x) {
    const int r = lk + (i >> 3);
    const int c = (i & 7) * 4;
    st_bf16x4(k_s + r * kBStride + c, make_float4(0.f, 0.f, 0.f, 0.f));
    st_bf16x4(v_s + r * kBStride + c, make_float4(0.f, 0.f, 0.f, 0.f));
  }

  // this lane's keys: in range, and valid in batch row b
  uint32_t in_bits = 0u, ok_bits = 0u;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 8 * n + 2 * t + c;
      if (j < lk) {
        in_bits |= 1u << (2 * n + c);
        if (key_valid[(size_t)b * lk + j] > 0.f) ok_bits |= 1u << (2 * n + c);
      }
    }

  float hm[NT][4];
  if (HM) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hm[n][e] = 0.f;
  }

  load_head(stage, qb, kb, vb, 0, (int)blockIdx.x * tile_rows, lv, lk, d_model, tile_rows);
  cp_async_commit();
  for (int h = 0; h < heads; ++h) {
    // training form: this head's donor-row mask and dropout hashes, read
    // before the barriers so that their loads' latency hides behind them
    uint32_t mask_bits[2] = {ok_bits, ok_bits};
    uint32_t drop_r[2] = {0u, 0u};
    if (TRAIN) {
      if (tr.donor_rows != nullptr) {
        const int d = tr.donor_rows[b * heads + h];
        uint32_t pad_bits = 0u;  // keys padded in the donor row
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = 8 * n + 2 * t + c;
            if (j < lk && tr.donor_key_valid[(size_t)d * lk + j] <= 0.f) pad_bits |= 1u << (2 * n + c);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (tr.query_valid[(size_t)d * lv + min(row[r], lv - 1)] <= 0.f) {
            mask_bits[r] &= ~pad_bits;
          }
        }
      }
      if (drop) {
        const uint32_t drop_h = drop_head(drop_seed(tr.seed), b * heads + h);
        drop_r[0] = drop_row(drop_h, row[0]);
        drop_r[1] = drop_row(drop_h, row[1]);
      }
    }

    cp_async_wait_all();  // this thread's copies of head h landed
    __syncthreads();      // and every other thread's; every warp is done with head h - 1
    // K and V rounded to bf16 once a head and block (unrolled: a block of
    // one warp converts every row itself), and the warp's 16 rows of
    // bf16(scale q), the A operand of S's two k16 steps
#pragma unroll 4
    for (int i = threadIdx.x; i < lk * (kDh / 4); i += blockDim.x) {
      const int r = i >> 3;
      const int c = (i & 7) * 4;
      st_bf16x4(k_s + r * kBStride + c, ld4(k32 + r * kKStride + c));
      st_bf16x4(v_s + r * kBStride + c, ld4(v32 + r * kKStride + c));
    }
    uint32_t qf[kDh / 16][4];
    frag_a16_rows(qf, q32 + (wrow + g) * kKStride + 2 * t, 8 * kKStride, scale);
    __syncthreads();  // the bf16 tiles are in place, and the f32 stage is free
    if (h + 1 < heads) {  // the next head's copies, in flight while this one computes
      load_head(stage, qb, kb, vb, h + 1, (int)blockIdx.x * tile_rows, lv, lk, d_model,
                tile_rows);
      cp_async_commit();
    }

    // S = (scale Q) K^T over the key n-tiles: dot_bf16, the backward's helper
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nt) {
        uint32_t kf[4];
        ldsm_x4(kf, k_s + (8 * n + ld_row) * kBStride + ld_col);
        dot_bf16(s[n], qf, kf);
      }
    }

    // masked keys to -1e30; the row max across the quad
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        if (!((mask_bits[r] >> (2 * n + (e & 1))) & 1u)) s[n][e] = kMasked;
        mx[r] = fmaxf(mx[r], s[n][e]);
      }
    }
    float inv[2], l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      l[r] = 0.f;
    }
    // e = exp2((s - m) log2 e) at keys in range (exactly 1 at the max), and
    // the row sums across the quad, in a fixed order
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool in = (in_bits >> (2 * n + (e & 1))) & 1u;
        s[n][e] = in ? exp2_fast((s[n][e] - mx[r]) * kLog2e) : 0.f;
        l[r] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
      if (TRAIN && tr.lse != nullptr && t == 0 && row[r] < lv) {
        tr.lse[((size_t)b * heads + h) * lv + row[r]] = mx[r] + logf(l[r]);
      }
    }

    // P; the head mean takes it undropped, p.v dropped and 0 at the dummies
    // (an n-tile of dummies only takes no dropout hash) and at an n-tile past
    // round8(lk) (the second half of the last k16 step)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n >= nt) {
          s[n][e] = 0.f;
          continue;
        }
        const int r = e >> 1;
        const int j = 8 * n + 2 * t + (e & 1);
        const float p = s[n][e] * inv[r];
        if (HM) hm[n][e] += p;
        float pz = 0.f;
        if (8 * n + 8 > nd) {
          pz = j >= nd ? p : 0.f;
          if (drop) pz *= drop_scale(drop_r[r], j, tr.threshold, tr.keep_scale);
        }
        s[n][e] = pz;
      }
    }

    // O = P V: P z from two adjacent C tiles, a k16 step per 16 keys, V read
    // transposed; the k16 steps of dummies only are skipped; each 64 keys'
    // sum in fresh accumulators, added on the CUDA cores
    float o[kDh / 8][4];
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < NT / 2; c0 += kPvChunk / 2) {
      float pv[kDh / 8][4];
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
      for (int kk = c0; kk < c0 + kPvChunk / 2 && kk < NT / 2; ++kk) {
        if (kk < kk0 || 2 * kk >= nt) continue;
        uint32_t pa[4];
        frag_a16_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < kDh / 16; ++np) {
          uint32_t vt[4];
          ldsm_x4_trans(vt, v_s + (16 * kk + tr_row) * kBStride + 16 * np + tr_col);
          mma_bf16(pv[2 * np], pa, vt[0], vt[1]);
          mma_bf16(pv[2 * np + 1], pa, vt[2], vt[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] += pv[n][e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= lv) continue;
      float* orow = out + ((size_t)b * lv + row[r]) * d_model + h * kDh + 2 * t;
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
      }
    }
  }

  if (HM) {
    const float fh = (float)heads;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= lv) continue;
      float* hrow = head_mean + ((size_t)b * lv + row[r]) * lk;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = 8 * n + 2 * t + c;
          if (j < lk) hrow[j] = hm[n][2 * r + c] / fh;
        }
    }
  }
}

// F = the product form (attn_common.cuh); NT = round16(lk) / 8, the key
// n-tiles (8 keys each) of this instance (2, 4, ..., 16); the launch's own
// count is round8(lk) / 8 (NT or NT - 1). HM = write the head mean; TRAIN =
// the training form. A lane's keys are 8 n + 2 t + c (n < NT, c in {0, 1}),
// bit 2 n + c of its key masks.
template <int F, int NT, bool HM, bool TRAIN>
__global__ void __launch_bounds__(kMaxWarps * 32, NT > 10 ? 2 : F == kFormBF16 ? kBlocksBF16 : 3)
aca_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ key_valid,
                     float* __restrict__ out, float* __restrict__ head_mean, int lv, int lk,
                     int heads, int nd, int tile_rows, float scale, TrainArgs tr) {
  extern __shared__ float4 smem4[];
  if constexpr (F == kFormBF16) {  // its own body, on the bf16 instruction (above)
    aca_bf16<NT, HM, TRAIN>(q, k, v, key_valid, out, head_mean, lv, lk, heads, nd, tile_rows,
                            scale, tr, reinterpret_cast<float*>(smem4));
  } else {
    float* stages = reinterpret_cast<float*>(smem4);
    const int stage_size = stage_floats(lk, tile_rows);
    const int lkp = round8(lk);
    const int nt = lkp >> 3;
    const int kk0 = nd >> 3;  // the first key tile that holds a non-dummy key

    const int b = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wrow = warp * 16;  // the warp's first row in the tile
    const int row0 = (int)blockIdx.x * tile_rows + wrow + g;
    const int row[2] = {row0, row0 + 8};  // this lane's rows (may be >= lv)
    const int d_model = heads * kDh;
    const float* qb = q + (size_t)b * lv * d_model;
    const float* kb = k + (size_t)b * lk * d_model;
    const float* vb = v + (size_t)b * lk * d_model;
    const bool drop = TRAIN && tr.threshold != 0u;

    // zero K's and V's padding rows once in each stage: P is 0 there, and 0
    // times stale shared memory could be NaN
    for (int i = threadIdx.x; i < 2 * 2 * (lkp - lk) * kKStride; i += blockDim.x) {
      const int per_stage = 2 * (lkp - lk) * kKStride;
      const int st = i / per_stage;
      const int e = i - st * per_stage;
      const int part = e / ((lkp - lk) * kKStride);  // 0: K, 1: V
      const int off = e - part * (lkp - lk) * kKStride;
      stages[st * stage_size + part * lkp * kKStride + lk * kKStride + off] = 0.f;
    }

    // this lane's keys: in range, and valid in batch row b
    uint32_t in_bits = 0u, ok_bits = 0u;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = 8 * n + 2 * t + c;
        if (j < lk) {
          in_bits |= 1u << (2 * n + c);
          if (key_valid[(size_t)b * lk + j] > 0.f) ok_bits |= 1u << (2 * n + c);
        }
      }

    float hm[NT][4];
    if (HM) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hm[n][e] = 0.f;
    }

    load_head(stages, qb, kb, vb, 0, (int)blockIdx.x * tile_rows, lv, lk, d_model, tile_rows);
    cp_async_commit();
    for (int h = 0; h < heads; ++h) {
      if (h + 1 < heads) {
        load_head(stages + ((h + 1) & 1) * stage_size, qb, kb, vb, h + 1,
                  (int)blockIdx.x * tile_rows, lv, lk, d_model, tile_rows);
      }
      cp_async_commit();
      cp_async_wait_all_but_newest();  // this thread's copies of head h landed
      __syncthreads();                 // and every other thread's
      const float* k_s = stages + (h & 1) * stage_size;
      const float* v_s = k_s + lkp * kKStride;
      const float* q_s = v_s + lkp * kKStride;

      // training form: this head's donor-row mask and dropout hashes
      uint32_t mask_bits[2] = {ok_bits, ok_bits};
      uint32_t drop_r[2] = {0u, 0u};
      if (TRAIN) {
        if (tr.donor_rows != nullptr) {
          const int d = tr.donor_rows[b * heads + h];
          uint32_t pad_bits = 0u;  // keys padded in the donor row
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int j = 8 * n + 2 * t + c;
              if (j < lk && tr.donor_key_valid[(size_t)d * lk + j] <= 0.f) pad_bits |= 1u << (2 * n + c);
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (tr.query_valid[(size_t)d * lv + min(row[r], lv - 1)] <= 0.f) {
              mask_bits[r] &= ~pad_bits;
            }
          }
        }
        if (drop) {
          const uint32_t drop_h = drop_head(drop_seed(tr.seed), b * heads + h);
          drop_r[0] = drop_row(drop_h, row[0]);
          drop_r[1] = drop_row(drop_h, row[1]);
        }
      }

      // S = (scale Q) K^T over the key tiles
      float s[NT][4];
      {
        FragA qf[kDh / 8];
        const float* q0 = q_s + (wrow + g) * kKStride + t;
        const float* q1 = q0 + 8 * kKStride;
#pragma unroll
        for (int ks = 0; ks < kDh / 8; ++ks) {
          qf[ks] = frag_a<F>(q0[8 * ks] * scale, q1[8 * ks] * scale, q0[8 * ks + 4] * scale,
                          q1[8 * ks + 4] * scale);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < nt) dot_form<F>(s[n], qf, k_s + (8 * n + g) * kKStride + t, 1.f);
        }
      }

      // masked keys to -1e30; the row max across the quad
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= nt) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          if (!((mask_bits[r] >> (2 * n + (e & 1))) & 1u)) s[n][e] = kMasked;
          mx[r] = fmaxf(mx[r], s[n][e]);
        }
      }
      float inv[2], l[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        l[r] = 0.f;
      }
      // e = exp2((s - m) log2 e) at keys in range (exactly 1 at the max), and
      // the row sums across the quad, in a fixed order
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= nt) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool in = (in_bits >> (2 * n + (e & 1))) & 1u;
          s[n][e] = in ? exp2_fast((s[n][e] - mx[r]) * kLog2e) : 0.f;
          l[r] += s[n][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / l[r];
        if (TRAIN && tr.lse != nullptr && t == 0 && row[r] < lv) {
          tr.lse[((size_t)b * heads + h) * lv + row[r]] = mx[r] + logf(l[r]);
        }
      }

      // P; the head mean takes it undropped, p.v dropped and 0 at the dummies
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= nt) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int j = 8 * n + 2 * t + (e & 1);
          const float p = s[n][e] * inv[r];
          if (HM) hm[n][e] += p;
          float pz = j >= nd ? p : 0.f;
          if (drop) pz *= drop_scale(drop_r[r], j, tr.threshold, tr.keep_scale);
          s[n][e] = pz;
        }
      }

      // O = P V: P from registers, V's key rows in the order 2t, 2t + 1; each
      // 64 keys' sum in fresh accumulators, added on the CUDA cores
      float o[kDh / 8][4];
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
      for (int c0 = 0; c0 < NT; c0 += kPvChunk) {
        float pv[kDh / 8][4];
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
        for (int kk = c0; kk < c0 + kPvChunk && kk < NT; ++kk) {
          if (kk < kk0 || kk >= nt) continue;
          const FragA pa = frag_a_from_c<F>(s[kk]);
          const float* vr = v_s + (8 * kk + 2 * t) * kKStride + g;
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
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= lv) continue;
        float* orow = out + ((size_t)b * lv + row[r]) * d_model + h * kDh + 2 * t;
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n) {
          *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
        }
      }
      __syncthreads();  // stage h & 1 is free for head h + 2
    }

    if (HM) {
      const float fh = (float)heads;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= lv) continue;
        float* hrow = head_mean + ((size_t)b * lv + row[r]) * lk;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = 8 * n + 2 * t + c;
            if (j < lk) hrow[j] = hm[n][2 * r + c] / fh;
          }
      }
    }
  }
}

template <int F, int NT, bool HM, bool TRAIN>
cudaError_t launch(const float* q, const float* k, const float* v, const float* key_valid,
                   float* out, float* head_mean, int batch, int lv, int lk, int heads, int nd,
                   float scale, const TrainArgs& tr, cudaStream_t stream) {
  // row tiles of up to kMaxWarps 16-row warp tiles, as even as they allow;
  // fewer warps a tile where that leaves the grid under 1.5 blocks an SM
  // (the flagship train shape: 64 batch rows of 75)
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int warp_tiles = (lv + 15) / 16;
  int tiles = 1;
  for (int most = kMaxWarps; most >= 1; --most) {
    tiles = (warp_tiles + most - 1) / most;
    if (2 * tiles * batch >= 3 * sms) break;
  }
  const int warps = (warp_tiles + tiles - 1) / tiles;
  const int tile_rows = warps * 16;
  const size_t smem = F == kFormBF16 ? (size_t)bf16_smem_bytes<NT>(lk, tile_rows)
                                     : sizeof(float) * 2 * stage_floats(lk, tile_rows);
  cudaError_t err = cudaFuncSetAttribute(aca_attention_kernel<F, NT, HM, TRAIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lv + tile_rows - 1) / tile_rows, batch);
  aca_attention_kernel<F, NT, HM, TRAIN><<<grid, warps * 32, smem, stream>>>(
      q, k, v, key_valid, out, head_mean, lv, lk, heads, nd, tile_rows, scale, tr);
  return cudaGetLastError();
}

template <int F, bool HM, bool TRAIN>
cudaError_t launch_nt(const float* q, const float* k, const float* v, const float* key_valid,
                      float* out, float* head_mean, int batch, int lv, int lk, int heads,
                      int nd, float scale, const TrainArgs& tr, cudaStream_t stream) {
#define ACA_LAUNCH(NT) \
  launch<F, NT, HM, TRAIN>(q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, tr, stream)
  switch ((lk + 15) / 16) {
    case 1: return ACA_LAUNCH(2);
    case 2: return ACA_LAUNCH(4);
    case 3: return ACA_LAUNCH(6);
    case 4: return ACA_LAUNCH(8);
    case 5: return ACA_LAUNCH(10);
    case 6: return ACA_LAUNCH(12);
    case 7: return ACA_LAUNCH(14);
    default: return ACA_LAUNCH(16);
  }
#undef ACA_LAUNCH
}

bool bad_shape(int batch, int lv, int lk, int heads, int head_dim, int nd) {
  return head_dim != kDh || lk < 1 || lk > kMaxKeys || nd < 0 || nd > lk || batch < 1 ||
         batch > 65535 || lv < 1 || heads < 1;
}

template <bool HM, bool TRAIN>
cudaError_t launch_form(int form, const float* q, const float* k, const float* v,
                        const float* key_valid, float* out, float* head_mean, int batch, int lv,
                        int lk, int heads, int nd, float scale, const TrainArgs& tr,
                        cudaStream_t stream) {
#define ACA_FORM(F) \
  launch_nt<F, HM, TRAIN>(q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, tr, stream)
  switch (form) {
    case kForm3xTF32: return ACA_FORM(kForm3xTF32);
    case kForm1xTF32: return ACA_FORM(kForm1xTF32);
    case kFormBF16: return ACA_FORM(kFormBF16);
    default: return cudaErrorInvalidValue;
  }
#undef ACA_FORM
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// q (B, Lv, H*Dh), k and v (B, Lk, H*Dh), key_valid (B, Lk), out
// (B, Lv, H*Dh), head_mean (B, Lv, Lk) or null; all f32, contiguous and
// 16-byte aligned. form: the products' form, 0 3xTF32, 1 1xTF32, 2 bf16
// (attn_common.cuh); any other value is refused.
int flashvtg_aca_attention_f32(const float* q, const float* k, const float* v,
                               const float* key_valid, float* out, float* head_mean, int batch,
                               int lv, int lk, int heads, int head_dim, int nd, float scale,
                               int form, void* stream) {
  if (bad_shape(batch, lv, lk, heads, head_dim, nd)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const TrainArgs none = {nullptr, nullptr, nullptr, nullptr, nullptr, 0u, 1.f};
  if (head_mean != nullptr) {
    return (int)launch_form<true, false>(form, q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, none, s);
  }
  return (int)launch_form<false, false>(form, q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, none, s);
}

// The training form: as above, plus lse (B, H, Lv), attention dropout
// (seed a uint32 in device memory, read by the kernel; threshold =
// floor(p * 2^24), keep_scale = 1 / (1 - p); threshold 0 = none, and then
// seed may be null)
// and the donor-row mask (the donor tables query_valid (G, Lv) and
// donor_key_valid (G, Lk) f32 and donor_rows (B, H) int32 in [0, G), or all
// three null; G = B in one process, the global batch under data
// parallelism), and the form as above.
int flashvtg_aca_attention_train_f32(const float* q, const float* k, const float* v,
                                     const float* key_valid, const float* query_valid,
                                     const float* donor_key_valid, const int* donor_rows,
                                     float* out, float* head_mean,
                                     float* lse, int batch, int lv, int lk, int heads,
                                     int head_dim, int nd, float scale, const unsigned* seed,
                                     unsigned threshold, float keep_scale, int form,
                                     void* stream) {
  if (bad_shape(batch, lv, lk, heads, head_dim, nd) || lse == nullptr ||
      (donor_rows == nullptr) != (query_valid == nullptr) ||
      (donor_rows == nullptr) != (donor_key_valid == nullptr) ||
      (threshold != 0u && seed == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const TrainArgs tr = {query_valid, donor_key_valid, donor_rows, lse,
                        seed,        threshold,       keep_scale};
  if (head_mean != nullptr) {
    return (int)launch_form<true, true>(form, q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, tr, s);
  }
  return (int)launch_form<false, true>(form, q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, tr, s);
}

}  // extern "C"
