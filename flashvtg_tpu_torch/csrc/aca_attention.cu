// Fused masked attention with dummy-dropping values and a fused head mean,
// for Hopper (sm_90a), f32 on CUDA cores.
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
// What bounds it: at the flagship eval shapes (B=256, Lv=75, Lk=42, H=8,
// Dh=32) it moves ~65 MB (q, k, v, out, head_mean once each) and does
// ~1.45 GFLOP of f32 products (q.k and p.v), so bytes and operations bound
// it about equally on an H100 (~19 us at 3.35 TB/s, ~22 us at 67 TFLOP/s).
// The products are small (Lk <= 128 keys of 32 floats), so the kernel is
// held back by what a simple one feeds its FMAs with: shared-memory loads
// (one 128-byte wavefront a cycle per SM against four warp-wide FMAs),
// load latency, and too few warps in flight. The design, as a small GEMM:
//  * a block owns one batch row and a tile of up to 40 query rows, and loops
//    over the heads; one head's K, V and Q tile are staged in shared memory
//    by coalesced 16-byte cp.async copies, each input read once per block,
//    in two stages: the next head's copies fly while this head computes;
//  * q.k: a warp owns 8 query rows and a lane owns keys lane + 32 t, so a
//    lane keeps 8 x KPL dot products in registers; each 16-byte K load
//    (rows padded to 36 floats: eight lanes on eight rows hit 32 distinct
//    banks) serves 8 rows, each broadcast Q load serves KPL keys; the warp
//    scales its Q rows once in shared memory, not in the inner loop;
//  * the softmax runs on those registers with warp shuffles; the head-mean
//    sums stay in the same registers across heads (one thread owns a
//    (row, key) for every head: a fixed summation order, no atomics, a
//    deterministic map);
//  * p.v: a lane owns one of the warp's rows and 8 of the 32 output columns;
//    each 16-byte P load serves 4 keys and each V load 8 rows (broadcast);
//    P rows are padded to 32 t + 4 floats so the 8 rows hit distinct banks;
//  * for Lk <= 96 the registers are capped so that four blocks of five warps
//    fit an SM: the flagship ACA grid (2 x 256 blocks) runs in one wave.
// The (B, H, Lv, Lk) logits and probabilities never leave the SM. No tensor
// cores and no TF32: this is the f32 parity mode.
//
// Training form (flashvtg_aca_attention_train_f32, template TRAIN; the eval
// entry point compiles without it, unchanged): it also writes the row
// log-sum-exp lse[b, h, i] = max + log(sum) for the backward kernel
// (aca_attention_bwd.cu); it multiplies the probabilities that feed p.v by
// the attention-dropout scale (attn_dropout.cuh, the hash evaluated in
// registers), while the head mean keeps them undropped, as
// transformer.py:117-127; and it takes the reference's misaligned train mask
// (transformer.py:34-48, 107-116): with donor rows, (i, j) of (b, h) is also
// masked where !query_valid[d, i] && !key_valid[d, j], d = donor_rows[b, h].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "attn_dropout.cuh"

namespace {

constexpr int kMaxWarps = 5;
constexpr int kMaxTileRows = kRowsPerWarp * kMaxWarps;
constexpr int kMaxKeys = 128;
constexpr float kMasked = -1e30f;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// One head's staged inputs, in floats: K (lk x kKStride), V (round4(lk) x
// kDh, the rows past lk zero), the Q tile (tile_rows x kDh).
__host__ __device__ constexpr int stage_floats(int lk, int tile_rows) {
  return lk * kKStride + round4(lk) * kDh + tile_rows * kDh;
}

// Shared memory of one block, in floats: two stages (the next head loads
// while this one computes), then P (tile_rows x (32 KPL + 4)). Every part
// starts 16-byte aligned.
__host__ __device__ constexpr int smem_floats(int lk, int kpl, int tile_rows) {
  return 2 * stage_floats(lk, tile_rows) + tile_rows * (32 * kpl + 4);
}

// Starts the copies of head h's K, V and Q tile into `stage`. Tile rows past
// lv copy row lv - 1: they are computed and never written back.
__device__ __forceinline__ void load_head(float* stage, const float* qb,
                                          const float* kb, const float* vb,
                                          int h, int row0, int lv, int lk,
                                          int d_model, int tile_rows) {
  float* k_s = stage;
  float* v_s = k_s + lk * kKStride;
  float* q_s = v_s + round4(lk) * kDh;
  for (int i = threadIdx.x; i < lk * (kDh / 4); i += blockDim.x) {
    const int j = i >> 3;
    const int c = (i & 7) * 4;
    const size_t g = (size_t)j * d_model + h * kDh + c;
    cp_async16(k_s + j * kKStride + c, kb + g);
    cp_async16(v_s + j * kDh + c, vb + g);
  }
  for (int i = threadIdx.x; i < tile_rows * (kDh / 4); i += blockDim.x) {
    const int r = i >> 3;
    const int c = (i & 7) * 4;
    const int row = min(row0 + r, lv - 1);
    cp_async16(q_s + r * kDh + c, qb + (size_t)row * d_model + h * kDh + c);
  }
}

// What the training form takes beside the eval operands: null pointers and
// threshold 0 switch each part off.
struct TrainArgs {
  const float* query_valid;  // (B, Lv), with donor_rows
  const int* donor_rows;     // (B, H)
  float* lse;                // (B, H, Lv)
  uint32_t seed;
  uint32_t threshold;  // attn_dropout.cuh; 0 = no dropout
  float keep_scale;    // 1 / (1 - p)
};

// KPL = keys per lane = ceil(Lk / 32); HM = write the head mean; TRAIN = the
// training form.
template <int KPL, bool HM, bool TRAIN>
__global__ void __launch_bounds__(kMaxWarps * 32, (KPL <= 3 && !TRAIN) ? 4 : 2)
aca_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ key_valid,
                     float* __restrict__ out, float* __restrict__ head_mean,
                     int lv, int lk, int heads, int nd, int tile_rows,
                     float scale, TrainArgs tr) {
  constexpr int kPStride = 32 * KPL + 4;
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  const int stage_size = stage_floats(lk, tile_rows);
  float* p_s = stages + 2 * stage_size;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * tile_rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wrow = warp * kRowsPerWarp;  // the warp's first row in the tile
  const int d_model = heads * kDh;
  const float* qb = q + (size_t)b * lv * d_model;
  const float* kb = k + (size_t)b * lk * d_model;
  const float* vb = v + (size_t)b * lk * d_model;

  // zero V's padding rows once in each stage: p.v reads keys in fours
  for (int i = threadIdx.x; i < 2 * (round4(lk) - lk) * kDh; i += blockDim.x) {
    const int st = i / ((round4(lk) - lk) * kDh);
    const int e = i - st * (round4(lk) - lk) * kDh;
    stages[st * stage_size + lk * kKStride + lk * kDh + e] = 0.f;
  }

  // keys of this lane in the q.k phase; past lk they read key lk - 1 and
  // are dropped from the softmax
  bool key_ok[KPL];
  bool in_range[KPL];
  int key_off[KPL];
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int j = lane + 32 * t;
    in_range[t] = j < lk;
    key_ok[t] = in_range[t] && key_valid[(size_t)b * lk + j] > 0.f;
    key_off[t] = (in_range[t] ? j : lk - 1) * kKStride;
  }

  float hm[kRowsPerWarp][KPL];
  if (HM) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int t = 0; t < KPL; ++t) hm[r][t] = 0.f;
  }

  // p.v phase: row wrow + pr, columns pc .. pc + 7
  const int pr = lane >> 2;
  const int pc = (lane & 3) * 8;
  const int j_first = nd & ~3;  // P is 0 at the dummies below nd

  load_head(stages, qb, kb, vb, 0, row0, lv, lk, d_model, tile_rows);
  cp_async_commit();
  for (int h = 0; h < heads; ++h) {
    if (h + 1 < heads) {
      load_head(stages + ((h + 1) & 1) * stage_size, qb, kb, vb, h + 1, row0,
                lv, lk, d_model, tile_rows);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();  // this thread's copies of head h landed
    __syncthreads();                 // and every other thread's
    const float* k_s = stages + (h & 1) * stage_size;
    const float* v_s = k_s + lk * kKStride;
    float* q_s = stages + (h & 1) * stage_size + lk * kKStride + round4(lk) * kDh;

    // training form: this head's donor row and dropout hash
    bool kpad_d[KPL];
    const float* qvalid_d = nullptr;
    uint32_t drop_h = 0;
#pragma unroll
    for (int t = 0; t < KPL; ++t) kpad_d[t] = false;
    if (TRAIN) {
      if (tr.donor_rows != nullptr) {
        const int d = tr.donor_rows[b * heads + h];
        qvalid_d = tr.query_valid + (size_t)d * lv;
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          kpad_d[t] = in_range[t] && key_valid[(size_t)d * lk + lane + 32 * t] <= 0.f;
        }
      }
      drop_h = drop_head(tr.seed, b * heads + h);
    }

    // the warp scales its own 8 rows of q before the dot product
    for (int i = lane * 4; i < kRowsPerWarp * kDh; i += 128) {
      float4 x = ld4(q_s + wrow * kDh + i);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      st4(q_s + wrow * kDh + i, x);
    }
    __syncwarp();

    // q.k: 8 rows x KPL keys per lane
    float s[kRowsPerWarp][KPL];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int t = 0; t < KPL; ++t) s[r][t] = 0.f;
#pragma unroll
    for (int d = 0; d < kDh; d += 4) {
      float4 kk[KPL];
#pragma unroll
      for (int t = 0; t < KPL; ++t) kk[t] = ld4(k_s + key_off[t] + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = ld4(q_s + (wrow + r) * kDh + d);
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          float a = s[r][t];
          a = fmaf(qq.x, kk[t].x, a);
          a = fmaf(qq.y, kk[t].y, a);
          a = fmaf(qq.z, kk[t].z, a);
          a = fmaf(qq.w, kk[t].w, a);
          s[r][t] = a;
        }
      }
    }

    // softmax per row; P keeps the non-dummy probabilities
    float* pw = p_s + wrow * kPStride;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row_r = row0 + wrow + r;  // may be >= lv: computed, not written
      bool qpad = false;
      if (TRAIN && qvalid_d != nullptr) qpad = qvalid_d[min(row_r, lv - 1)] <= 0.f;
      float mx = kMasked;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        if (!key_ok[t] || (TRAIN && qpad && kpad_d[t])) s[r][t] = kMasked;
        mx = fmaxf(mx, s[r][t]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        s[r][t] = in_range[t] ? expf(s[r][t] - mx) : 0.f;
        sum += s[r][t];
      }
      const float total = warp_sum(sum);
      const float inv_sum = 1.f / total;
      uint32_t drop_r = 0;
      if (TRAIN) {
        if (tr.lse != nullptr && lane == 0 && row_r < lv) {
          tr.lse[((size_t)b * heads + h) * lv + row_r] = mx + logf(total);
        }
        drop_r = drop_row(drop_h, row_r);
      }
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        const float p = s[r][t] * inv_sum;
        if (HM) hm[r][t] += p;
        float pv = p;  // the probability p.v reads: dropped in training
        if (TRAIN && tr.threshold != 0u) {
          pv *= drop_scale(drop_r, j, tr.threshold, tr.keep_scale);
        }
        pw[r * kPStride + j] = j >= nd ? pv : 0.f;
      }
    }
    __syncwarp();

    // p.v: one row, 8 columns per lane, keys in fours
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    const float* prow = pw + pr * kPStride;
    for (int j = j_first; j < round4(lk); j += 4) {
      const float4 pp = ld4(prow + j);
      const float pj[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 va = ld4(v_s + (j + u) * kDh + pc);
        const float4 vc = ld4(v_s + (j + u) * kDh + pc + 4);
        acc[0] = fmaf(pj[u], va.x, acc[0]);
        acc[1] = fmaf(pj[u], va.y, acc[1]);
        acc[2] = fmaf(pj[u], va.z, acc[2]);
        acc[3] = fmaf(pj[u], va.w, acc[3]);
        acc[4] = fmaf(pj[u], vc.x, acc[4]);
        acc[5] = fmaf(pj[u], vc.y, acc[5]);
        acc[6] = fmaf(pj[u], vc.z, acc[6]);
        acc[7] = fmaf(pj[u], vc.w, acc[7]);
      }
    }
    const int row = row0 + wrow + pr;
    if (row < lv) {
      float* o = out + ((size_t)b * lv + row) * d_model + h * kDh + pc;
      st4(o, make_float4(acc[0], acc[1], acc[2], acc[3]));
      st4(o + 4, make_float4(acc[4], acc[5], acc[6], acc[7]));
    }
    __syncthreads();  // stage h & 1 is free for head h + 2
  }

  if (HM) {
    const float fh = (float)heads;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + wrow + r;
      if (row >= lv) break;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        if (in_range[t]) {
          head_mean[((size_t)b * lv + row) * lk + lane + 32 * t] = hm[r][t] / fh;
        }
      }
    }
  }
}

template <int KPL, bool HM, bool TRAIN>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* key_valid, float* out, float* head_mean,
                   int batch, int lv, int lk, int heads, int nd, float scale,
                   const TrainArgs& tr, cudaStream_t stream) {
  // tiles of up to 40 rows, as even as 8-row warps allow
  const int tiles = (lv + kMaxTileRows - 1) / kMaxTileRows;
  const int warps = ((lv + tiles - 1) / tiles + kRowsPerWarp - 1) / kRowsPerWarp;
  const int tile_rows = warps * kRowsPerWarp;
  const size_t smem = sizeof(float) * smem_floats(lk, KPL, tile_rows);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        aca_attention_kernel<KPL, HM, TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((lv + tile_rows - 1) / tile_rows, batch);
  aca_attention_kernel<KPL, HM, TRAIN><<<grid, warps * 32, smem, stream>>>(
      q, k, v, key_valid, out, head_mean, lv, lk, heads, nd, tile_rows, scale, tr);
  return cudaGetLastError();
}

template <bool HM, bool TRAIN>
cudaError_t launch_kpl(int kpl, const float* q, const float* k, const float* v,
                       const float* key_valid, float* out, float* head_mean,
                       int batch, int lv, int lk, int heads, int nd, float scale,
                       const TrainArgs& tr, cudaStream_t stream) {
  switch (kpl) {
    case 1: return launch<1, HM, TRAIN>(q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, tr, stream);
    case 2: return launch<2, HM, TRAIN>(q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, tr, stream);
    case 3: return launch<3, HM, TRAIN>(q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, tr, stream);
    default: return launch<4, HM, TRAIN>(q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, tr, stream);
  }
}

bool bad_shape(int batch, int lv, int lk, int heads, int head_dim, int nd) {
  return head_dim != kDh || lk < 1 || lk > kMaxKeys || nd < 0 || nd > lk ||
         batch < 1 || batch > 65535 || lv < 1 || heads < 1;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// q (B, Lv, H*Dh), k and v (B, Lk, H*Dh), key_valid (B, Lk), out
// (B, Lv, H*Dh), head_mean (B, Lv, Lk) or null; all f32, contiguous and
// 16-byte aligned.
int flashvtg_aca_attention_f32(const float* q, const float* k, const float* v,
                               const float* key_valid, float* out,
                               float* head_mean, int batch, int lv, int lk,
                               int heads, int head_dim, int nd, float scale,
                               void* stream) {
  if (bad_shape(batch, lv, lk, heads, head_dim, nd)) return (int)cudaErrorInvalidValue;
  const int kpl = (lk + 31) / 32;
  cudaStream_t s = (cudaStream_t)stream;
  const TrainArgs none = {nullptr, nullptr, nullptr, 0u, 0u, 1.f};
  if (head_mean != nullptr) {
    return (int)launch_kpl<true, false>(kpl, q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, none, s);
  }
  return (int)launch_kpl<false, false>(kpl, q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, none, s);
}

// The training form: as above, plus lse (B, H, Lv), attention dropout
// (threshold = floor(p * 2^24), keep_scale = 1 / (1 - p); threshold 0 = none)
// and the donor-row mask (query_valid (B, Lv) f32 and donor_rows (B, H)
// int32, or both null).
int flashvtg_aca_attention_train_f32(const float* q, const float* k, const float* v,
                                     const float* key_valid, const float* query_valid,
                                     const int* donor_rows, float* out,
                                     float* head_mean, float* lse, int batch, int lv,
                                     int lk, int heads, int head_dim, int nd,
                                     float scale, unsigned seed, unsigned threshold,
                                     float keep_scale, void* stream) {
  if (bad_shape(batch, lv, lk, heads, head_dim, nd) || lse == nullptr ||
      (donor_rows == nullptr) != (query_valid == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int kpl = (lk + 31) / 32;
  cudaStream_t s = (cudaStream_t)stream;
  const TrainArgs tr = {query_valid, donor_rows, lse, seed, threshold, keep_scale};
  if (head_mean != nullptr) {
    return (int)launch_kpl<true, true>(kpl, q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, tr, s);
  }
  return (int)launch_kpl<false, true>(kpl, q, k, v, key_valid, out, head_mean, batch, lv, lk, heads, nd, scale, tr, s);
}

}  // extern "C"
