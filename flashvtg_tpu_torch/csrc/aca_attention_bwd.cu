// Backward of the fused ACA / short self-attention (aca_attention.cu), for
// Hopper (sm_90a): every product on the tensor cores in 3xTF32
// (f32-accurate) or 1xTF32 (both on mma.sync.m16n8k8) or bf16 (on
// m16n8k16; the forward's form), the query rows split over blocks.
//
// Replaces: the VJP that JAX's library Pallas flash_attention brings with it
// (its short form, scripts/bench_flash.py:50-74), which the JAX train step
// reaches through jax.grad of every ACA layer
// (flashvtg_tpu/models/transformer.py:80-128) and every self-attention layer
// over up to 128 keys (transformer.py:236-264).
//
// What it computes, for batch row b, head h, query row i and key j, from the
// forward's inputs, its row log-sum-exp lse[b, h, i], the gradient dO of
// out and dHM of the head mean (optional):
//   P_ij  = exp(scale q_i . k_j - lse_i)        (0 where masked)
//   z_ij  = the forward's dropout scale (attn_dropout.cuh), recomputed
//   dP_ij = [j >= nd] z_ij (dO_i . v_j) + dHM_ij / H
//   dS_ij = P_ij (dP_ij - sum_k P_ik dP_ik)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = sum_i dS_ij (scale q_i)
//   dv_j  = sum_i P_ij z_ij dO_i  for j >= nd, 0 for the dummies
// The masks are the forward's: invalid keys, and the donor-row mask
// (!query_valid[d, i] && !donor_key_valid[d, j], d = donor_rows[b, h], rows
// of the donor tables).
//
// What bounds it: bytes, at every shape the model gives it
// (chip_smoke.py:attention_bound, dot products at 3xTF32's 165 TFLOP/s): at
// the TACoS train shape (B=32, H=8, Lv 2048, Lk 75, 35 dummies) it reads q,
// dO, the head-mean gradient and lse and writes dq (~0.23 GB, 0.07 ms at
// 3.35 TB/s) against ~8 GFLOP of dot products over the valid pairs (0.05
// ms); at the flagship train shape (B=64, Lv 75, Lk 42) 0.008 ms. The
// design:
//  * the query rows are split over blocks: a block owns one (b, h) and one
//    chunk of rows (ops/aca.py:bwd_tiling: row tiles of 16 W rows, W =
//    max(5, key tiles of 16), about 256 rows a chunk; TACoS train: 7 chunks
//    of 4 tiles of 80 rows, 1,792 blocks; the flagship's 75 rows: one tile
//    of 80, not 64 + 11). The grid runs the 8 heads of one (b, chunk) side
//    by side (blockIdx.x = h), so the head-mean gradient tile, which every
//    head reads, comes from L2 after the first;
//  * K and V of the head sit in shared memory for the whole block, keys
//    padded to a multiple of 8 (the mma n-tile); per row tile, Q and dO come
//    in by cp.async (no room for a second stage: two blocks of 100 KB an SM
//    at Lk 75; prefetching the next tile into registers instead spilled and
//    ran slower on the card);
//  * a warp owns 16 query rows: S = (scale Q) K^T with the forward's helper
//    and order (dot_form, so s is bit-equal to the forward's) and dO V^T
//    (skipped for key tiles of dummies only, where z = 0) go to mma
//    accumulators (the head-mean gradient at the lane's positions is
//    loaded before them, its latency hidden behind the products);
//    P = exp2((s - lse) log2 e) (exactly 1 at a row with one valid key),
//    dP, and the row sum D = sum_k P dP by quad shuffles run on the C
//    fragments, and dS = P (dP - D) takes D from the very terms it
//    subtracts, so it is exactly 0 at such a row;
//  * dq = dS K takes dS as its A operand from the C fragments (fresh
//    accumulators per 32 keys, added on the CUDA cores: the tensor core's
//    f32 sums truncate) and is written once per row;
//  * dk = dS^T (scale q) and dv = (P z)^T dO need dS^T and (P z)^T as A
//    operands: the warps put dS and P z in shared memory, and after a
//    barrier warp w takes key tile w (16 keys) over the tile's rows, fresh
//    accumulators per 16 rows added to its registers;
//  * dk and dv are partial sums per chunk: with one chunk the block writes
//    them; with more, into a workspace (2, B, H, chunks, Lk, 32) that the
//    wrapper allocates, and a second pass sums the chunks in their order.
//    No float atomics anywhere: two launches agree bit for bit.
// Why 3xTF32 is the f32 parity mode, and what the 1xTF32 and bf16 forms
// are: see aca_attention.cu and attn_common.cuh. The chunk-sum pass has no
// product and no form.
//
// The bf16 form has a body of its own (aca_bwd_bf16 below), on the bf16
// instruction mma.sync.m16n8k16 from bf16 tiles in shared memory, every
// operand rounded to bf16 once, where it is staged. Its row tiles, chunks
// and chunk-sum pass are the other forms' (ops/aca.py:bwd_tiling does not
// depend on the form); what holds it is latency at few warps an SM, so it
// trades a little recomputation for registers and runs 3 blocks an SM
// (kBlocksBF16; 15 warps at Lk <= 80, against 2 blocks of the f32 forms):
//  * K and V of the head as bf16 tiles of round16(lk) rows, once a block;
//    per row tile, bf16(q) (the B operand of dk, which takes the unscaled q
//    and multiplies by scale at the end) and dO, loaded through registers
//    and stored rounded; the A operand of S, bf16(scale q), straight from
//    device memory into registers (frag_a16_rows), while the tile lands;
//  * S = (scale Q) K^T and dO V^T by attn_common.cuh dot_bf16, K and V read
//    as stored by ldmatrix: the forward's helper and operands, so s and P
//    are the forward's bit for bit (exactly 1 at a row with one valid key);
//  * two passes over the key n-tiles: the first takes dP (dO V^T, the
//    dropout scale, the head-mean gradient; an n-tile of dummies only takes
//    no product and no hash), P z to shared memory in bf16 and D = sum P dP;
//    the second recomputes S and P (the same products in the same order)
//    and takes dS = P (dP - D), to registers and to shared memory in bf16
//    (the bits its A operands round it to anyway): P is never held beside
//    dP;
//  * dq = dS K: dS from two adjacent C tiles as the A operand, K by
//    ldmatrix.trans; two k16 steps (32 keys) a fresh accumulator set;
//  * warp w reads dS^T and (P z)^T of key tile w by ldmatrix.trans, Q and
//    dO by ldmatrix.trans as B operands: dk and dv take one k16 step per 16
//    query rows, each in fresh accumulators, and wait between row tiles in
//    a stash in shared memory (f32), not in registers (~74 KB a block at
//    Lk 75, against the f32 forms' ~100 KB);
//  * the masks, z, dP, D, dS = P (dP - D) and the order of every sum are
//    the other forms'.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "attn_dropout.cuh"

namespace {

constexpr int kMinWarps = 5;  // warps per block at least: 80-row tiles
constexpr int kMaxKeys = 128;
constexpr int kDqChunk = 4;      // key n-tiles (32 keys) per fresh dq accumulator set

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// warps of a block for NT key n-tiles: one 16-key tile of dk / dv per warp
__host__ __device__ constexpr int warps_for(int nt) {
  return nt / 2 > kMinWarps ? nt / 2 : kMinWarps;
}

struct Operands {
  const float* q;
  const float* k;
  const float* v;
  const float* key_valid;
  const float* query_valid;      // donor table (G, Lv) with donor_rows, else null
  const float* donor_key_valid;  // donor table (G, Lk) with donor_rows, else null
  const int* donor_rows;         // (B, H), rows of the donor tables
  const float* lse;
  const float* d_out;
  const float* d_head_mean;  // null: the head mean gets no gradient
  float* dq;
  float* dk;
  float* dv;
  float* ws;  // (2, B, H, chunks, Lk, 32) partial dk and dv; null with one chunk
  int batch, lv, lk, heads, nd, chunks, chunk_rows;
  float scale;
  const uint32_t* seed;  // device memory, attn_dropout.cuh; null without dropout
  uint32_t threshold;
  float keep_scale;
};

// Shared memory of one block, in floats: K and V (round8(lk) rows), the Q
// and dO tile (tile_rows rows), all rows kKStride floats; then dS and P z
// (tile_rows rows of round16(lk) + 4 floats: the A-fragment loads of dS^T
// hit 32 distinct banks).
__host__ __device__ constexpr int smem_floats(int lk, int tile_rows) {
  return 2 * (round8(lk) + tile_rows) * kKStride + 2 * tile_rows * (round16(lk) + 4);
}

// ---- the bf16 form on mma.sync.m16n8k16 (attn_common.cuh) -------------------
//
// The same kernel on bf16 tiles in shared memory (the design: this file's
// header).

constexpr int kBlocksBF16 = 3;  // blocks an SM of the bf16 body at NT <= 10

// Shared memory of the bf16 body, in bytes: K and V (8 NT rows, whole k16
// steps of dq), the tile's bf16(q) (the B operand of dk) and dO, all rows
// kBStride bf16; dS and P z in bf16, tile rows of 8 NT + 8 (an odd number of
// 16-byte chunks: the ldmatrix.trans reads of dS^T and (P z)^T hit distinct
// banks); and the key-tile warps' dk and dv between row tiles, f32.
template <int NT>
__host__ __device__ constexpr int bf16_smem_bytes() {
  return (int)sizeof(uint16_t) *
             ((2 * 8 * NT + 2 * 16 * warps_for(NT)) * kBStride +
              2 * 16 * warps_for(NT) * (8 * NT + 8)) +
         (int)sizeof(float4) * (NT / 2) * 8 * 32;
}

template <int NT>
__device__ __forceinline__ void aca_bwd_bf16(const Operands& a, unsigned char* smem) {
  constexpr int kWarps = warps_for(NT);
  constexpr int kTileRows = 16 * kWarps;
  constexpr int kKeyTiles = NT / 2;
  constexpr int kKeys = 8 * NT;
  constexpr int kPs = kKeys + 8;  // dS / P z row stride, bf16 elements
  constexpr int kVecs = kTileRows * (kDh / 4) / (kWarps * 32);  // float4 a thread of a tile
  static_assert(kDqChunk % 2 == 0, "whole k16 steps of dq a chunk");
  const int lv = a.lv, lk = a.lk, nd = a.nd;
  const int lkp = round8(lk);
  const int nt = lkp >> 3;
  uint16_t* k_s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* v_s = k_s + kKeys * kBStride;
  uint16_t* q_s = v_s + kKeys * kBStride;
  uint16_t* do_s = q_s + kTileRows * kBStride;
  uint16_t* ds_s = do_s + kTileRows * kBStride;
  uint16_t* pz_s = ds_s + kTileRows * kPs;
  float4* stash = reinterpret_cast<float4*>(pz_s + kTileRows * kPs);

  const int h = blockIdx.x;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * a.heads + h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d_model = a.heads * kDh;
  const size_t col0 = (size_t)h * kDh;
  const int c_begin = chunk * a.chunk_rows;
  const int c_end = min(lv, c_begin + a.chunk_rows);
  // ldmatrix rows: as stored (K, V for S, dO V^T), and transposed or as an
  // A operand, 8-row halves
  const int ld_row = lane & 7, ld_col = 8 * (lane >> 3);
  const int tr_row = 8 * ((lane >> 3) & 1) + (lane & 7), tr_col = 8 * (lane >> 4);

  // K and V of this head in bf16, rounded once a block, rows past lk zero;
  // dS and P z zero at the n-tile past round8(lk), if any
  for (int i = threadIdx.x; i < kKeys * (kDh / 4); i += blockDim.x) {
    const int j = i >> 3;
    const int c = (i & 7) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (j < lk) {
      const size_t g0 = ((size_t)b * lk + j) * d_model + col0 + c;
      x = ld4(a.k + g0);
      y = ld4(a.v + g0);
    }
    st_bf16x4(k_s + j * kBStride + c, x);
    st_bf16x4(v_s + j * kBStride + c, y);
  }
  if (lkp < kKeys) {
    for (int i = threadIdx.x; i < kTileRows * 8; i += blockDim.x) {
      const int r = i >> 3;
      const int c = lkp + (i & 7);
      ds_s[r * kPs + c] = 0;
      pz_s[r * kPs + c] = 0;
    }
  }

  // this lane's keys: valid in batch row b, and padded in the donor row
  uint32_t ok_bits = 0u, pad_bits = 0u;
  const float* qvalid_d = nullptr;
  if (a.donor_rows != nullptr) {
    const int d = a.donor_rows[bh];
    qvalid_d = a.query_valid + (size_t)d * lv;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = 8 * n + 2 * t + c;
        if (j < lk && a.donor_key_valid[(size_t)d * lk + j] <= 0.f) pad_bits |= 1u << (2 * n + c);
      }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 8 * n + 2 * t + c;
      if (j < lk && a.key_valid[(size_t)b * lk + j] > 0.f) ok_bits |= 1u << (2 * n + c);
    }
  const uint32_t drop_h = drop_head(drop_seed(a.seed), bh);
  const float inv_heads = 1.f / (float)a.heads;

  const int wrow = warp * 16;
  for (int r0 = c_begin; r0 < c_end; r0 += kTileRows) {
    // the warp's rows: their lse, masks and dropout hashes, and the A
    // operand of S, bf16(scale q) of its 16 rows from device memory (rows
    // past lv read row lv - 1), read before the tile's stores and barrier
    // so that their latency hides behind them
    const int row[2] = {r0 + wrow + g, r0 + wrow + g + 8};
    float lse_r[2];
    uint32_t mask_bits[2], drop_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool live = row[r] < c_end;
      lse_r[r] = live ? a.lse[(size_t)bh * lv + row[r]] : 0.f;
      mask_bits[r] = live ? ok_bits : 0u;
      if (live && qvalid_d != nullptr && qvalid_d[row[r]] <= 0.f) mask_bits[r] &= ~pad_bits;
      drop_r[r] = a.threshold != 0u ? drop_row(drop_h, row[r]) : 0u;
    }

    // the Q and dO tile in bf16, rounded once where staged: bf16(q) (dk's B
    // operand: dk takes the unscaled q and multiplies by scale at the end)
    // and dO; rows past lv read row lv - 1 and get P = 0
    uint32_t qf[kDh / 16][4];
    {
      float4 x[kVecs], y[kVecs];
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int i = threadIdx.x + kWarps * 32 * u;
        const size_t g0 = ((size_t)b * lv + min(r0 + (i >> 3), lv - 1)) * d_model + col0 + (i & 7) * 4;
        x[u] = ld4(a.q + g0);
        y[u] = ld4(a.d_out + g0);
      }
      const int rc[2] = {min(row[0], lv - 1), min(row[1], lv - 1)};
      frag_a16_rows(qf, a.q + ((size_t)b * lv + rc[0]) * d_model + col0 + 2 * t,
                    (size_t)(rc[1] - rc[0]) * d_model, a.scale);
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int i = threadIdx.x + kWarps * 32 * u;
        const int off = (i >> 3) * kBStride + (i & 7) * 4;
        st_bf16x4(q_s + off, x[u]);
        st_bf16x4(do_s + off, y[u]);
      }
    }
    __syncthreads();

    if (r0 + wrow < c_end) {  // the warp's rows hold a live one
      uint32_t of[kDh / 16][4];  // the warp's 16 rows of dO, the A operand of dO V^T
#pragma unroll
      for (int ks = 0; ks < kDh / 16; ++ks) {
        ldsm_x4(of[ks], do_s + (wrow + tr_row) * kBStride + 16 * ks + tr_col);
      }
      // P of key n-tile n: S = (scale Q) K^T by dot_bf16, the forward's
      // helper and operands, so that s is the forward's bit for bit, then
      // exp2((s - lse) log2 e), 0 where masked. Both passes below take it
      // here, the same products in the same order: the second recomputes it
      // (two products and four exp2 an n-tile) rather than hold NT x 4 more
      // registers, so that the kernel runs 3 blocks an SM without spills
      const auto p_tile = [&](int n, float (&p)[4]) {
        uint32_t kf[4];
        ldsm_x4(kf, k_s + (8 * n + ld_row) * kBStride + ld_col);
        float sn[4];
        dot_bf16(sn, qf, kf);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (mask_bits[e >> 1] >> (2 * n + (e & 1))) & 1u;
          p[e] = ok ? exp2_fast((sn[e] - lse_r[e >> 1]) * kLog2e) : 0.f;
        }
      };

      // first pass, per key n-tile: dO V^T (skipped for an n-tile of dummies
      // only, where z = 0) and the head-mean gradient: dP in dp, P z to
      // shared memory in bf16, and this lane's share of D = sum_k P dP; dP
      // 0 past round8(lk)
      float dp[NT][4];
      float d_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
          continue;
        }
        float dov[4] = {0.f, 0.f, 0.f, 0.f}, z[4] = {0.f, 0.f, 0.f, 0.f};
        if (8 * n + 8 > nd) {  // an n-tile of dummies only: z = 0, no product, no hash
          uint32_t vf[4];
          ldsm_x4(vf, v_s + (8 * n + ld_row) * kBStride + ld_col);
          dot_bf16(dov, of, vf);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 8 * n + 2 * t + (e & 1);
            z[e] = j < nd ? 0.f
                   : a.threshold != 0u ? drop_scale(drop_r[e >> 1], j, a.threshold, a.keep_scale)
                                       : 1.f;
          }
        }
        float p[4], pz[4];
        p_tile(n, p);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int j = 8 * n + 2 * t + (e & 1);
          const bool ok = (mask_bits[r] >> (2 * n + (e & 1))) & 1u;
          const float dhm = a.d_head_mean != nullptr && ok
                                ? __ldg(a.d_head_mean + ((size_t)b * lv + row[r]) * lk + j)
                                : 0.f;
          const float dpf = z[e] * dov[e] + dhm * inv_heads;
          d_sum[r] += p[e] * dpf;
          dp[n][e] = dpf;
          pz[e] = p[e] * z[e];
        }
        uint16_t* pw = pz_s + (wrow + g) * kPs + 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(pw) = pack_bf16(pz[0], pz[1]);
        *reinterpret_cast<uint32_t*>(pw + 8 * kPs) = pack_bf16(pz[2], pz[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        d_sum[r] += __shfl_xor_sync(0xffffffffu, d_sum[r], 1);
        d_sum[r] += __shfl_xor_sync(0xffffffffu, d_sum[r], 2);
      }

      // second pass: dS = P (dP - D) in dp and to shared memory in bf16 (the
      // bits that dq's A operand rounds it to)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= nt) continue;
        float p[4];
        p_tile(n, p);
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = p[e] * (dp[n][e] - d_sum[e >> 1]);
        uint16_t* dw = ds_s + (wrow + g) * kPs + 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(dw) = pack_bf16(dp[n][0], dp[n][1]);
        *reinterpret_cast<uint32_t*>(dw + 8 * kPs) = pack_bf16(dp[n][2], dp[n][3]);
      }

      // dq = dS K: dS from two adjacent C tiles, a k16 step per 16 keys, K
      // read transposed; each 32 keys' sum in fresh accumulators, added on
      // the CUDA cores
      float dq[kDh / 8][4];
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
      for (int c0 = 0; c0 < NT / 2; c0 += kDqChunk / 2) {
        float pdq[kDh / 8][4];
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pdq[n][e] = 0.f;
#pragma unroll
        for (int kk = c0; kk < c0 + kDqChunk / 2 && kk < NT / 2; ++kk) {
          if (2 * kk >= nt) continue;
          uint32_t da[4];
          frag_a16_from_c(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
          for (int np = 0; np < kDh / 16; ++np) {
            uint32_t kt[4];
            ldsm_x4_trans(kt, k_s + (16 * kk + tr_row) * kBStride + 16 * np + tr_col);
            mma_bf16(pdq[2 * np], da, kt[0], kt[1]);
            mma_bf16(pdq[2 * np + 1], da, kt[2], kt[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[n][e] += pdq[n][e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= c_end) continue;
        float* o = a.dq + ((size_t)b * lv + row[r]) * d_model + col0 + 2 * t;
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n) {
          *reinterpret_cast<float2*>(o + 8 * n) =
              make_float2(dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
        }
      }
    }
    __syncthreads();  // every warp's dS and P z are in

    // dk += dS^T Q and dv += (P z)^T dO for key tile `warp`: the A operands
    // dS^T and (P z)^T by ldmatrix.trans of the stored rows, Q and dO read
    // transposed as B operands; one k16 step per 16 rows (the warps' rows
    // past the chunk are never read), each in fresh accumulators added to
    // dk and dv on the CUDA cores. dk and dv wait between row tiles in the
    // stash (this warp's own slots: no barrier), not in registers, which
    // the S and dq phases need: 3 blocks an SM without spills
    if (warp < kKeyTiles) {
      float dk[kDh / 8][4], dv[kDh / 8][4];
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        const float4 sk = r0 == c_begin ? make_float4(0.f, 0.f, 0.f, 0.f)
                                        : stash[(warp * 8 + n) * 32 + lane];
        const float4 sv = r0 == c_begin ? make_float4(0.f, 0.f, 0.f, 0.f)
                                        : stash[(warp * 8 + 4 + n) * 32 + lane];
        dk[n][0] = sk.x, dk[n][1] = sk.y, dk[n][2] = sk.z, dk[n][3] = sk.w;
        dv[n][0] = sv.x, dv[n][1] = sv.y, dv[n][2] = sv.z, dv[n][3] = sv.w;
      }
      const int a_row = (lane & 7) + 8 * (lane >> 4);
      const int a_col = 16 * warp + 8 * ((lane >> 3) & 1);
#pragma unroll 1
      for (int rg = 0; rg < kTileRows && r0 + rg < c_end; rg += 16) {
        uint32_t da[4], pa[4];
        ldsm_x4_trans(da, ds_s + (rg + a_row) * kPs + a_col);
        ldsm_x4_trans(pa, pz_s + (rg + a_row) * kPs + a_col);
#pragma unroll
        for (int np = 0; np < kDh / 16; ++np) {
          const int off = (rg + tr_row) * kBStride + 16 * np + tr_col;
          uint32_t qt[4], ot[4];
          ldsm_x4_trans(qt, q_s + off);
          ldsm_x4_trans(ot, do_s + off);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int n = 2 * np + half;
            float pdk[4] = {0.f, 0.f, 0.f, 0.f}, pdv[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(pdk, da, qt[2 * half], qt[2 * half + 1]);
            mma_bf16(pdv, pa, ot[2 * half], ot[2 * half + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dk[n][e] += pdk[e];
              dv[n][e] += pdv[e];
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        stash[(warp * 8 + n) * 32 + lane] = make_float4(dk[n][0], dk[n][1], dk[n][2], dk[n][3]);
        stash[(warp * 8 + 4 + n) * 32 + lane] =
            make_float4(dv[n][0], dv[n][1], dv[n][2], dv[n][3]);
      }
    }
    __syncthreads();  // the tile's buffers are free for the next one
  }

  // dk and dv of the warp's keys: written, or the chunk's partial sums
  if (warp < kKeyTiles) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = 16 * warp + g + 8 * r;
      if (key >= lk) continue;
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        const float4 sk = stash[(warp * 8 + n) * 32 + lane];
        const float4 sv = stash[(warp * 8 + 4 + n) * 32 + lane];
        const float2 k2 = r == 0 ? make_float2(sk.x, sk.y) : make_float2(sk.z, sk.w);
        const float2 v2 = r == 0 ? make_float2(sv.x, sv.y) : make_float2(sv.z, sv.w);
        const int c = 8 * n + 2 * t;
        if (a.chunks == 1) {
          const size_t g0 = ((size_t)b * lk + key) * d_model + col0 + c;
          *reinterpret_cast<float2*>(a.dk + g0) = make_float2(k2.x * a.scale, k2.y * a.scale);
          *reinterpret_cast<float2*>(a.dv + g0) = v2;
        } else {
          const size_t part = (size_t)a.batch * a.heads * a.chunks * lk * kDh;
          const size_t w0 = (((size_t)bh * a.chunks + chunk) * lk + key) * kDh + c;
          *reinterpret_cast<float2*>(a.ws + w0) = k2;
          *reinterpret_cast<float2*>(a.ws + part + w0) = v2;
        }
      }
    }
  }
}

// F = the product form (attn_common.cuh); NT = round16(lk) / 8, the key
// n-tiles of the instance (2, 4, ..., 16); the launch's own count is
// round8(lk) / 8 (NT or NT - 1). A lane's keys in the S phase are
// 8 n + 2 t + c, bit 2 n + c of its key masks.
template <int F, int NT>
__global__ void __launch_bounds__(warps_for(NT) * 32,
                                  NT > 10 ? 1 : F == kFormBF16 ? kBlocksBF16 : 2)
aca_attention_bwd_kernel(const Operands a) {
  constexpr int kWarps = warps_for(NT);
  constexpr int kTileRows = 16 * kWarps;
  constexpr int kKeyTiles = NT / 2;
  extern __shared__ float4 smem4[];
  if constexpr (F == kFormBF16) {  // its own body, on the bf16 instruction (above)
    aca_bwd_bf16<NT>(a, reinterpret_cast<unsigned char*>(smem4));
  } else {
    const int lv = a.lv, lk = a.lk, nd = a.nd;
    const int lkp = round8(lk);
    const int nt = lkp >> 3;
    const int ps = round16(lk) + 4;  // dS / P z row stride
    float* k_s = reinterpret_cast<float*>(smem4);
    float* v_s = k_s + lkp * kKStride;
    float* q_s = v_s + lkp * kKStride;
    float* do_s = q_s + kTileRows * kKStride;
    float* ds_s = do_s + kTileRows * kKStride;
    float* pz_s = ds_s + kTileRows * ps;

    const int h = blockIdx.x;
    const int chunk = blockIdx.y;
    const int b = blockIdx.z;
    const int bh = b * a.heads + h;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int d_model = a.heads * kDh;
    const size_t col0 = (size_t)h * kDh;
    const int c_begin = chunk * a.chunk_rows;
    const int c_end = min(lv, c_begin + a.chunk_rows);

    // K and V of this head, rows past lk zero; dS and P z zero past round8(lk)
    for (int i = threadIdx.x; i < lkp * (kDh / 4); i += blockDim.x) {
      const int j = i >> 3;
      const int c = (i & 7) * 4;
      if (j < lk) {
        const size_t g0 = ((size_t)b * lk + j) * d_model + col0 + c;
        cp_async16(k_s + j * kKStride + c, a.k + g0);
        cp_async16(v_s + j * kKStride + c, a.v + g0);
      } else {
        st4(k_s + j * kKStride + c, make_float4(0.f, 0.f, 0.f, 0.f));
        st4(v_s + j * kKStride + c, make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
    for (int i = threadIdx.x; i < kTileRows * (ps - lkp); i += blockDim.x) {
      const int r = i / (ps - lkp);
      const int c = lkp + i - r * (ps - lkp);
      ds_s[r * ps + c] = 0.f;
      pz_s[r * ps + c] = 0.f;
    }

    // this lane's keys: valid in batch row b, and padded in the donor row
    uint32_t ok_bits = 0u, pad_bits = 0u;
    const float* qvalid_d = nullptr;
    if (a.donor_rows != nullptr) {
      const int d = a.donor_rows[bh];
      qvalid_d = a.query_valid + (size_t)d * lv;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = 8 * n + 2 * t + c;
          if (j < lk && a.donor_key_valid[(size_t)d * lk + j] <= 0.f) pad_bits |= 1u << (2 * n + c);
        }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = 8 * n + 2 * t + c;
        if (j < lk && a.key_valid[(size_t)b * lk + j] > 0.f) ok_bits |= 1u << (2 * n + c);
      }
    const uint32_t drop_h = drop_head(drop_seed(a.seed), bh);
    const float inv_heads = 1.f / (float)a.heads;

    // this warp's key tile of dk and dv (keys 16 warp + g and + 8)
    float dk[kDh / 8][4], dv[kDh / 8][4];
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[n][e] = 0.f;
        dv[n][e] = 0.f;
      }

    for (int r0 = c_begin; r0 < c_end; r0 += kTileRows) {
      // the Q and dO tile; rows past lv read row lv - 1 and get P = 0
      for (int i = threadIdx.x; i < kTileRows * (kDh / 4); i += blockDim.x) {
        const int r = i >> 3;
        const int c = (i & 7) * 4;
        const size_t g0 = ((size_t)b * lv + min(r0 + r, lv - 1)) * d_model + col0 + c;
        cp_async16(q_s + r * kKStride + c, a.q + g0);
        cp_async16(do_s + r * kKStride + c, a.d_out + g0);
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();

      const int wrow = warp * 16;
      if (r0 + wrow < c_end) {  // the warp's rows hold a live one
        const int row[2] = {r0 + wrow + g, r0 + wrow + g + 8};
        float lse_r[2];
        uint32_t mask_bits[2], drop_r[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool live = row[r] < c_end;
          lse_r[r] = live ? a.lse[(size_t)bh * lv + row[r]] : 0.f;
          mask_bits[r] = live ? ok_bits : 0u;
          if (live && qvalid_d != nullptr && qvalid_d[row[r]] <= 0.f) mask_bits[r] &= ~pad_bits;
          drop_r[r] = a.threshold != 0u ? drop_row(drop_h, row[r]) : 0u;
        }

        // the head-mean gradient at the lane's (row, key) positions, loaded
        // first so that its latency hides behind the products
        float dp[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n >= nt) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool ok = (mask_bits[r] >> (2 * n + (e & 1))) & 1u;
            dp[n][e] = a.d_head_mean != nullptr && ok
                           ? a.d_head_mean[((size_t)b * lv + row[r]) * lk + 8 * n + 2 * t + (e & 1)]
                           : 0.f;
          }
        }

        // S = (scale Q) K^T, as the forward
        float s[NT][4];
        FragA f[kDh / 8];
        {
          const float* q0 = q_s + (wrow + g) * kKStride + t;
          const float* q1 = q0 + 8 * kKStride;
#pragma unroll
          for (int ks = 0; ks < kDh / 8; ++ks) {
            f[ks] = frag_a<F>(q0[8 * ks] * a.scale, q1[8 * ks] * a.scale, q0[8 * ks + 4] * a.scale,
                           q1[8 * ks + 4] * a.scale);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (n < nt) dot_form<F>(s[n], f, k_s + (8 * n + g) * kKStride + t, 1.f);
          }
          const float* o0 = do_s + (wrow + g) * kKStride + t;
          const float* o1 = o0 + 8 * kKStride;
#pragma unroll
          for (int ks = 0; ks < kDh / 8; ++ks) {
            f[ks] = frag_a<F>(o0[8 * ks], o1[8 * ks], o0[8 * ks + 4], o1[8 * ks + 4]);
          }
        }

        // per key tile: dO V^T, then P in s, dP in dp, P z to shared memory,
        // and this lane's share of D
        float d_sum[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n >= nt) continue;
          float dov[4] = {0.f, 0.f, 0.f, 0.f};  // z is 0 at the dummies
          if (8 * n + 8 > nd) dot_form<F>(dov, f, v_s + (8 * n + g) * kKStride + t, 1.f);
          float pz[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int j = 8 * n + 2 * t + (e & 1);
            const bool ok = (mask_bits[r] >> (2 * n + (e & 1))) & 1u;
            const float p = ok ? exp2_fast((s[n][e] - lse_r[r]) * kLog2e) : 0.f;
            const float z = j < nd ? 0.f
                            : a.threshold != 0u ? drop_scale(drop_r[r], j, a.threshold, a.keep_scale)
                                                : 1.f;
            const float dpf = z * dov[e] + dp[n][e] * inv_heads;
            d_sum[r] += p * dpf;
            s[n][e] = p;
            dp[n][e] = dpf;
            pz[e] = p * z;
          }
          float* pw = pz_s + (wrow + g) * ps + 8 * n + 2 * t;
          *reinterpret_cast<float2*>(pw) = make_float2(pz[0], pz[1]);
          *reinterpret_cast<float2*>(pw + 8 * ps) = make_float2(pz[2], pz[3]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          d_sum[r] += __shfl_xor_sync(0xffffffffu, d_sum[r], 1);
          d_sum[r] += __shfl_xor_sync(0xffffffffu, d_sum[r], 2);
        }

        // dS = P (dP - D) in dp and to shared memory
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n >= nt) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - d_sum[e >> 1]);
          float* dw = ds_s + (wrow + g) * ps + 8 * n + 2 * t;
          *reinterpret_cast<float2*>(dw) = make_float2(dp[n][0], dp[n][1]);
          *reinterpret_cast<float2*>(dw + 8 * ps) = make_float2(dp[n][2], dp[n][3]);
        }

        // dq = dS K: dS from registers, K's key rows in the order 2t, 2t + 1;
        // each 32 keys' sum in fresh accumulators, added on the CUDA cores
        float dq[kDh / 8][4];
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
        for (int c0 = 0; c0 < NT; c0 += kDqChunk) {
          float pdq[kDh / 8][4];
#pragma unroll
          for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pdq[n][e] = 0.f;
#pragma unroll
          for (int kk = c0; kk < c0 + kDqChunk && kk < NT; ++kk) {
            if (kk >= nt) continue;
            const FragA da = frag_a_from_c<F>(dp[kk]);
            const float* kr = k_s + (8 * kk + 2 * t) * kKStride + g;
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
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (row[r] >= c_end) continue;
          float* o = a.dq + ((size_t)b * lv + row[r]) * d_model + col0 + 2 * t;
#pragma unroll
          for (int n = 0; n < kDh / 8; ++n) {
            *reinterpret_cast<float2*>(o + 8 * n) =
                make_float2(dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
          }
        }
      } else {
        // rows past the chunk: dS and P z 0, so that no stale value reaches dk, dv
        for (int i = lane; i < 16 * lkp; i += 32) {
          const int r = wrow + i / lkp;
          const int c = i - (i / lkp) * lkp;
          ds_s[r * ps + c] = 0.f;
          pz_s[r * ps + c] = 0.f;
        }
      }
      __syncthreads();  // every warp's dS and P z are in

      // dk += dS^T Q and dv += (P z)^T dO for key tile `warp`: the A operand
      // from shared memory, its k slots t and t + 4 the query rows 2t and
      // 2t + 1 of each 8 (so that the B loads of Q and dO, rows 2t, 2t + 1 and
      // column g, hit distinct banks); fresh accumulators per 16 rows
      if (warp < kKeyTiles) {
        const int key0 = 16 * warp + g;
#pragma unroll 1
        for (int rg = 0; rg < kTileRows && r0 + rg < c_end; rg += 16) {
          float pdk[kDh / 8][4], pdv[kDh / 8][4];
#pragma unroll
          for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pdk[n][e] = 0.f;
              pdv[n][e] = 0.f;
            }
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int ra = rg + 8 * ks + 2 * t;  // rows ra (slot t) and ra + 1 (slot t + 4)
            const float* d0 = ds_s + ra * ps + key0;
            const float* p0 = pz_s + ra * ps + key0;
            const FragA da = frag_a<F>(d0[0], d0[8], d0[ps], d0[ps + 8]);
            const FragA pa = frag_a<F>(p0[0], p0[8], p0[ps], p0[ps + 8]);
            const float* qr = q_s + ra * kKStride + g;
            const float* orr = do_s + ra * kKStride + g;
#pragma unroll
            for (int n = 0; n < kDh / 8; ++n) {
              mma_form<F>(pdk[n], da, frag_b<F>(qr[8 * n], qr[kKStride + 8 * n]));
              mma_form<F>(pdv[n], pa, frag_b<F>(orr[8 * n], orr[kKStride + 8 * n]));
            }
          }
#pragma unroll
          for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dk[n][e] += pdk[n][e];
              dv[n][e] += pdv[n][e];
            }
        }
      }
      __syncthreads();  // the tile's buffers are free for the next one
    }

    // dk and dv of the warp's keys: written, or the chunk's partial sums
    if (warp < kKeyTiles) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = 16 * warp + g + 8 * r;
        if (key >= lk) continue;
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n) {
          const int c = 8 * n + 2 * t;
          if (a.chunks == 1) {
            const size_t g0 = ((size_t)b * lk + key) * d_model + col0 + c;
            *reinterpret_cast<float2*>(a.dk + g0) =
                make_float2(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
            *reinterpret_cast<float2*>(a.dv + g0) = make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
          } else {
            const size_t part = (size_t)a.batch * a.heads * a.chunks * lk * kDh;
            const size_t w0 = (((size_t)bh * a.chunks + chunk) * lk + key) * kDh + c;
            *reinterpret_cast<float2*>(a.ws + w0) = make_float2(dk[n][2 * r], dk[n][2 * r + 1]);
            *reinterpret_cast<float2*>(a.ws + part + w0) =
                make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
          }
        }
      }
    }
  }
}

// The second pass with more than one chunk: dk and dv of one (b, key,
// column) each, the chunks' partial sums added in chunk order.
__global__ void __launch_bounds__(256)
aca_attention_bwd_reduce_kernel(const Operands a) {
  const int d_model = a.heads * kDh;
  const size_t total = (size_t)a.batch * a.lk * d_model;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int col = (int)(idx % d_model);
  const size_t bj = idx / d_model;
  const int j = (int)(bj % a.lk);
  const int b = (int)(bj / a.lk);
  const int h = col / kDh;
  const int c = col - h * kDh;
  const size_t part = (size_t)a.batch * a.heads * a.chunks * a.lk * kDh;
  const float* w = a.ws + ((size_t)(b * a.heads + h) * a.chunks * a.lk + j) * kDh + c;
  const size_t step = (size_t)a.lk * kDh;
  float sk = 0.f, sv = 0.f;
  for (int ch = 0; ch < a.chunks; ++ch) {
    sk += w[ch * step];
    sv += w[part + ch * step];
  }
  a.dk[idx] = sk * a.scale;
  a.dv[idx] = sv;
}

template <int F, int NT>
cudaError_t launch(Operands a, cudaStream_t stream) {
  constexpr int kTileRows = 16 * warps_for(NT);
  // chunks of whole row tiles, as ops/aca.py:bwd_tiling computes them
  const int tiles = (a.lv + kTileRows - 1) / kTileRows;
  a.chunk_rows = kTileRows * ((tiles + a.chunks - 1) / a.chunks);
  if (a.chunks < 1 || (a.chunks - 1) * a.chunk_rows >= a.lv || a.chunks > 65535 ||
      (a.chunks > 1) != (a.ws != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = F == kFormBF16 ? (size_t)bf16_smem_bytes<NT>()
                                     : sizeof(float) * smem_floats(a.lk, kTileRows);
  cudaError_t err = cudaFuncSetAttribute(
      aca_attention_bwd_kernel<F, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  aca_attention_bwd_kernel<F, NT><<<dim3(a.heads, a.chunks, a.batch), warps_for(NT) * 32,
                                    smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.chunks == 1) return err;
  const size_t total = (size_t)a.batch * a.lk * a.heads * kDh;
  aca_attention_bwd_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_nt(const Operands& a, cudaStream_t s) {
  switch (round16(a.lk) / 16) {
    case 1: return launch<F, 2>(a, s);
    case 2: return launch<F, 4>(a, s);
    case 3: return launch<F, 6>(a, s);
    case 4: return launch<F, 8>(a, s);
    case 5: return launch<F, 10>(a, s);
    case 6: return launch<F, 12>(a, s);
    case 7: return launch<F, 14>(a, s);
    default: return launch<F, 16>(a, s);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// q, d_out, dq (B, Lv, H*Dh); k, v, dk, dv (B, Lk, H*Dh); key_valid (B, Lk);
// the donor tables query_valid (G, Lv) and donor_key_valid (G, Lk) f32 and
// donor_rows (B, H) int32 in [0, G), or all three null; lse
// (B, H, Lv) from the training forward; d_head_mean (B, Lv, Lk) or null;
// workspace (2, B, H, chunks, Lk, Dh) f32 scratch when chunks > 1, else
// null, with chunks from ops/aca.py:bwd_tiling; threshold = floor(p * 2^24)
// (0 = no dropout), keep_scale = 1 / (1 - p), seed the forward's (device
// memory; null without dropout); form
// the products' form, 0 3xTF32, 1 1xTF32, 2 bf16 (attn_common.cuh), any
// other value refused. f32, contiguous and 16-byte aligned.
int flashvtg_aca_attention_bwd_f32(const float* q, const float* k, const float* v,
                                   const float* key_valid, const float* query_valid,
                                   const float* donor_key_valid, const int* donor_rows,
                                   const float* lse,
                                   const float* d_out, const float* d_head_mean, float* dq,
                                   float* dk, float* dv, float* workspace, int batch, int lv,
                                   int lk, int heads, int head_dim, int nd, int chunks,
                                   float scale, const unsigned* seed, unsigned threshold,
                                   float keep_scale, int form, void* stream) {
  if (head_dim != kDh || lk < 1 || lk > kMaxKeys || nd < 0 || nd > lk || batch < 1 ||
      batch > 65535 || lv < 1 || heads < 1 || heads > 65535 ||
      (donor_rows == nullptr) != (query_valid == nullptr) ||
      (donor_rows == nullptr) != (donor_key_valid == nullptr) ||
      (threshold != 0u && seed == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Operands a = {q,     k,           v,     key_valid,  query_valid, donor_key_valid,
                      donor_rows, lse,   d_out, d_head_mean, dq,          dk,
                      dv,    workspace,   batch, lv,         lk,          heads,
                      nd,    chunks,      0,     scale,      seed,        threshold,
                      keep_scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case kForm3xTF32: return (int)launch_nt<kForm3xTF32>(a, s);
    case kForm1xTF32: return (int)launch_nt<kForm1xTF32>(a, s);
    case kFormBF16: return (int)launch_nt<kFormBF16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
