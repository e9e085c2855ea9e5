// Backward of the fused ACA / short self-attention (aca_attention.cu), for
// Hopper (sm_90a), f32 on CUDA cores.
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
// (!query_valid[d, i] && !key_valid[d, j], d = donor_rows[b, h]).
//
// What bounds it: at the TACoS train shape (B=32, H=8, Lq 2048 video rows,
// Lk 75 keys, 35 dummies) it does five products of Lq x Lk x 32 per (b, h)
// (q.k and dO.v recomputed, dq, dk, dv): ~12.6 GFLOP, ~0.19 ms at 67 TFLOP/s
// f32, against ~0.13 GB of inputs and outputs (~0.04 ms at 3.35 TB/s): bound
// by operations. The design keeps every sum inside one block, so it needs
// no atomics and launches agree bit for bit:
//  * Lk <= 128, so a block owns one (b, h) and all of its keys: K and V of
//    the head sit in shared memory (rows padded to 36 floats) for the whole
//    kernel, and the block loops over query tiles of 64 rows;
//  * per tile, a warp owns 8 rows and a lane keys lane + 32 t (as the
//    forward): q.k and dO.v land in registers, P, dP and the row sum
//    sum_k P dP follow with warp shuffles, and P z and dS go to shared
//    memory;
//  * dq: a lane owns one row and 8 of its 32 columns and sums dS k over the
//    keys, then writes its row (each query row of a head belongs to one
//    block);
//  * dk and dv: a thread owns one key and 16 columns of both, summed in
//    registers over every query tile, and written once at the end.
// No tensor cores and no TF32: this is the f32 parity mode.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "attn_dropout.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTileRows = kRowsPerWarp * kWarps;  // query rows per tile
constexpr int kMaxKeys = 128;

// Shared memory in floats: K and V (32 KPL rows each, padded), the scaled Q
// tile and the dO tile, then P z and dS (tile rows x (32 KPL + 4)).
__host__ __device__ constexpr int smem_floats(int kpl) {
  return 2 * 32 * kpl * kKStride + 2 * kTileRows * kDh +
         2 * kTileRows * (32 * kpl + 4);
}

struct Operands {
  const float* q;
  const float* k;
  const float* v;
  const float* key_valid;
  const float* query_valid;  // with donor_rows, else null
  const int* donor_rows;
  const float* lse;
  const float* d_out;
  const float* d_head_mean;  // null: the head mean gets no gradient
  float* dq;
  float* dk;
  float* dv;
  int lv, lk, heads, nd;
  float scale;
  uint32_t seed, threshold;
  float keep_scale;
};

template <int KPL>
__global__ void __launch_bounds__(kWarps * 32, 1)
aca_attention_bwd_kernel(const Operands a) {
  constexpr int kKeys = 32 * KPL;
  constexpr int kPStride = kKeys + 4;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kKeys * kKStride;
  float* q_s = v_s + kKeys * kKStride;
  float* do_s = q_s + kTileRows * kDh;
  float* pz_s = do_s + kTileRows * kDh;
  float* ds_s = pz_s + kTileRows * kPStride;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int bh = b * a.heads + h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wrow = warp * kRowsPerWarp;
  const int lv = a.lv, lk = a.lk, nd = a.nd;
  const int d_model = a.heads * kDh;
  const size_t col0 = (size_t)h * kDh;

  // K and V of this head, rows past lk zero
  for (int i = threadIdx.x; i < kKeys * (kDh / 4); i += blockDim.x) {
    const int j = i >> 3;
    const int c = (i & 7) * 4;
    float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
    if (j < lk) {
      const size_t g = ((size_t)b * lk + j) * d_model + col0 + c;
      kk = ld4(a.k + g);
      vv = ld4(a.v + g);
    }
    st4(k_s + j * kKStride + c, kk);
    st4(v_s + j * kKStride + c, vv);
  }

  // this lane's keys in the q.k phase, with the donor row's key padding
  bool key_ok[KPL], kpad_d[KPL];
  const float* qvalid_d = nullptr;
  int d = 0;
  if (a.donor_rows != nullptr) {
    d = a.donor_rows[bh];
    qvalid_d = a.query_valid + (size_t)d * lv;
  }
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int j = lane + 32 * t;
    key_ok[t] = j < lk && a.key_valid[(size_t)b * lk + j] > 0.f;
    kpad_d[t] = qvalid_d != nullptr && j < lk && a.key_valid[(size_t)d * lk + j] <= 0.f;
  }
  const uint32_t drop_h = drop_head(a.seed, bh);
  const float inv_heads = 1.f / (float)a.heads;

  // dk / dv phase: key kj, columns kc .. kc + 15
  const int kj = threadIdx.x >> 1;
  const int kc = (threadIdx.x & 1) * 16;
  float acc_dk[16], acc_dv[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    acc_dk[c] = 0.f;
    acc_dv[c] = 0.f;
  }
  // dq phase: row wrow + pr, columns pc .. pc + 7
  const int pr = lane >> 2;
  const int pc = (lane & 3) * 8;

  for (int row0 = 0; row0 < lv; row0 += kTileRows) {
    // the Q tile (scaled, as the forward) and the dO tile; rows past lv
    // read row lv - 1 and get P = 0
    for (int i = threadIdx.x; i < kTileRows * (kDh / 4); i += blockDim.x) {
      const int r = i >> 3;
      const int c = (i & 7) * 4;
      const size_t g = ((size_t)b * lv + min(row0 + r, lv - 1)) * d_model + col0 + c;
      st4(q_s + r * kDh + c, scaled(ld4(a.q + g), a.scale));
      st4(do_s + r * kDh + c, ld4(a.d_out + g));
    }
    __syncthreads();

    // q.k and dO.v: 8 rows x KPL keys per lane
    float s[kRowsPerWarp][KPL], dpv[kRowsPerWarp][KPL];
    qk_dov<KPL>(q_s + wrow * kDh, do_s + wrow * kDh, k_s, v_s, s, dpv);

    // P, dP, dS per row
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + wrow + r;
      const bool live = row < lv;
      const float lse = live ? a.lse[(size_t)bh * lv + row] : 0.f;
      const bool qpad = qvalid_d != nullptr && live && qvalid_d[row] <= 0.f;
      const uint32_t drop_r = drop_row(drop_h, row);
      float p[KPL], pz[KPL], dp[KPL];
      float rowsum = 0.f;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        const bool ok = live && key_ok[t] && !(qpad && kpad_d[t]);
        p[t] = ok ? expf(s[r][t] - lse) : 0.f;
        const float z = j < nd ? 0.f
                        : a.threshold != 0u ? drop_scale(drop_r, j, a.threshold, a.keep_scale)
                                            : 1.f;
        pz[t] = p[t] * z;
        dp[t] = z * dpv[r][t];
        if (a.d_head_mean != nullptr && ok) {
          dp[t] += a.d_head_mean[((size_t)b * lv + row) * lk + j] * inv_heads;
        }
        rowsum += p[t] * dp[t];
      }
      rowsum = warp_sum(rowsum);
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        pz_s[(wrow + r) * kPStride + j] = pz[t];
        ds_s[(wrow + r) * kPStride + j] = p[t] * (dp[t] - rowsum);
      }
    }
    __syncwarp();

    // dq: one row, 8 columns per lane, over the keys
    {
      float acc[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = 0.f;
      const float* dsrow = ds_s + (wrow + pr) * kPStride;
      for (int j = 0; j < lk; ++j) {
        const float g = dsrow[j];
        axpy4(acc, g, ld4(k_s + j * kKStride + pc));
        axpy4(acc + 4, g, ld4(k_s + j * kKStride + pc + 4));
      }
      const int row = row0 + wrow + pr;
      if (row < lv) {
        float* o = a.dq + ((size_t)b * lv + row) * d_model + col0 + pc;
        st4(o, scaled(make_float4(acc[0], acc[1], acc[2], acc[3]), a.scale));
        st4(o + 4, scaled(make_float4(acc[4], acc[5], acc[6], acc[7]), a.scale));
      }
    }
    __syncthreads();  // every warp's P z and dS are in

    // dk, dv: one key, 16 columns per thread, over the tile's rows
    if (kj < lk) {
      const int rows = min(kTileRows, lv - row0);
      for (int i = 0; i < rows; ++i) {
        const float g = ds_s[i * kPStride + kj];
        const float w = pz_s[i * kPStride + kj];
#pragma unroll
        for (int c = 0; c < 16; c += 4) {
          axpy4(acc_dk + c, g, ld4(q_s + i * kDh + kc + c));
          axpy4(acc_dv + c, w, ld4(do_s + i * kDh + kc + c));
        }
      }
    }
    __syncthreads();  // the tile's buffers are free for the next one
  }

  if (kj < lk) {
    const size_t g = ((size_t)b * lk + kj) * d_model + col0 + kc;
#pragma unroll
    for (int c = 0; c < 16; c += 4) {
      st4(a.dk + g + c, make_float4(acc_dk[c], acc_dk[c + 1], acc_dk[c + 2], acc_dk[c + 3]));
      st4(a.dv + g + c, make_float4(acc_dv[c], acc_dv[c + 1], acc_dv[c + 2], acc_dv[c + 3]));
    }
  }
}

template <int KPL>
cudaError_t launch(const Operands& a, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(KPL);
  cudaError_t err = cudaFuncSetAttribute(
      aca_attention_bwd_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  aca_attention_bwd_kernel<KPL><<<dim3(a.heads, batch), kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// q, d_out, dq (B, Lv, H*Dh); k, v, dk, dv (B, Lk, H*Dh); key_valid (B, Lk);
// query_valid (B, Lv) f32 and donor_rows (B, H) int32, or both null; lse
// (B, H, Lv) from the training forward; d_head_mean (B, Lv, Lk) or null;
// threshold = floor(p * 2^24) (0 = no dropout), keep_scale = 1 / (1 - p),
// seed as the forward's. f32, contiguous and 16-byte aligned.
int flashvtg_aca_attention_bwd_f32(const float* q, const float* k, const float* v,
                                   const float* key_valid, const float* query_valid,
                                   const int* donor_rows, const float* lse,
                                   const float* d_out, const float* d_head_mean,
                                   float* dq, float* dk, float* dv, int batch, int lv,
                                   int lk, int heads, int head_dim, int nd, float scale,
                                   unsigned seed, unsigned threshold, float keep_scale,
                                   void* stream) {
  if (head_dim != kDh || lk < 1 || lk > kMaxKeys || nd < 0 || nd > lk || batch < 1 ||
      batch > 65535 || lv < 1 || heads < 1 || heads > 65535 ||
      (donor_rows == nullptr) != (query_valid == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Operands a = {q,  k,  v,  key_valid, query_valid, donor_rows, lse,   d_out,
                      d_head_mean, dq, dk, dv, lv, lk, heads, nd, scale, seed,
                      threshold, keep_scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch ((lk + 31) / 32) {
    case 1: return (int)launch<1>(a, batch, s);
    case 2: return (int)launch<2>(a, batch, s);
    case 3: return (int)launch<3>(a, batch, s);
    default: return (int)launch<4>(a, batch, s);
  }
}

}  // extern "C"
