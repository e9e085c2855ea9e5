// Memory-linear masked self-attention over any number of keys, for Hopper
// (sm_90a), f32 on CUDA cores.
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
// logits nor a (B, H, L, chunk) slab exists in device memory: a block's
// logits and probabilities for one key tile live in registers and shared
// memory only.
//
// What bounds it: at the TACoS encoder shape (B=8, H=8, L=2048, Dh=32) the
// work is 4 * B * H * L * L_valid * Dh FLOP for q.k plus p.v, 34.4 GFLOP with
// every key valid: 0.51 ms at 67 TFLOP/s f32. It moves q, k, v, the mask and
// out once, ~67 MB: 0.02 ms at 3.35 TB/s. So it is bound by operations, and
// a simple kernel is held back by how it feeds its FMAs. The design, as the
// ACA kernel (aca_attention.cu) tiled over keys:
//  * a block owns one (batch row, head) and a tile of 64 query rows (eight
//    warps of 8 rows); the scaled Q tile stays in shared memory, and the K
//    and V tiles of 128 keys are staged by 16-byte cp.async copies in two
//    stages: the next tile's copies fly while this one computes;
//  * a key tile whose keys are all masked is skipped (the block reads the
//    mask once and keeps a bit per tile), so ragged batches pay for the keys
//    they hold;
//  * q.k: a lane owns keys lane + 32 t of the tile (t < 4) for the warp's 8
//    rows: 32 logits in registers; each 16-byte K load (rows padded to 36
//    floats, so eight lanes on eight rows hit 32 distinct banks) serves 8
//    rows, each broadcast Q load serves 4 keys;
//  * the online softmax runs on those registers: the tile max with warp
//    shuffles, each lane's share of the row sum kept apart and summed across
//    the warp once at the end (a fixed order: launches agree bit for bit);
//  * p.v: a lane owns one of the warp's rows and 8 of the 32 output columns;
//    each 16-byte P load serves 4 keys and each V load 8 rows (broadcast).
// No tensor cores and no TF32: this is the f32 parity mode.
//
// Training form (flashvtg_flash_attention_train_f32, template TRAIN; the
// eval entry point compiles without it, unchanged): it also writes the row
// log-sum-exp lse[b, h, i] = m + log(l) for the backward
// (flash_attention_bwd.cu), and multiplies each probability that feeds p.v
// by the attention-dropout scale (attn_dropout.cuh, evaluated in registers
// inside the tile loop); the row sum l keeps the undropped probabilities.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "attn_dropout.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTileRows = kRowsPerWarp * kWarps;  // query rows per block
constexpr int kKPL = 4;                           // keys per lane per tile
constexpr int kTileKeys = 32 * kKPL;
constexpr int kMaxTiles = 32;  // one bit each in the block's tile mask
constexpr int kMaxLen = kTileKeys * kMaxTiles;
constexpr int kPStride = kTileKeys + 4;

// Shared memory, in floats: Q tile, two stages of (K, V), then P.
constexpr int kQFloats = kTileRows * kDh;
constexpr int kStageFloats = kTileKeys * kKStride + kTileKeys * kDh;
constexpr int kPFloats = kTileRows * kPStride;
constexpr int kSmemBytes = sizeof(float) * (kQFloats + 2 * kStageFloats + kPFloats);

// Starts the copies of key tile `tile` (head h) into `stage`. Key rows past
// len are zero-filled with plain stores: p.v multiplies them by a zero P,
// and a zero times stale shared memory could be NaN.
__device__ __forceinline__ void load_tile(float* stage, const float* kb,
                                          const float* vb, int tile, int len,
                                          int d_model, int h) {
  float* k_s = stage;
  float* v_s = stage + kTileKeys * kKStride;
  const int j0 = tile * kTileKeys;
  for (int i = threadIdx.x; i < kTileKeys * (kDh / 4); i += blockDim.x) {
    const int r = i >> 3;
    const int c = (i & 7) * 4;
    const int j = j0 + r;
    if (j < len) {
      const size_t g = (size_t)j * d_model + h * kDh + c;
      cp_async16(k_s + r * kKStride + c, kb + g);
      cp_async16(v_s + r * kDh + c, vb + g);
    } else {
      st4(k_s + r * kKStride + c, make_float4(0.f, 0.f, 0.f, 0.f));
      st4(v_s + r * kDh + c, make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}

// the next set bit of `mask` at or after `from`, or -1
__device__ __forceinline__ int next_tile(unsigned mask, int from) {
  if (from >= kMaxTiles) return -1;
  const unsigned rest = mask & (0xffffffffu << from);
  return rest ? __ffs(rest) - 1 : -1;
}

template <bool TRAIN>
__global__ void __launch_bounds__(kWarps * 32, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ key_valid,
                       float* __restrict__ out, int len, int heads,
                       float scale, float* __restrict__ lse, uint32_t seed,
                       uint32_t threshold, float keep_scale) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* stages = q_s + kQFloats;
  float* p_s = stages + 2 * kStageFloats;
  __shared__ unsigned tile_mask;

  const int row0 = blockIdx.x * kTileRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wrow = warp * kRowsPerWarp;  // the warp's first row in the tile
  const int d_model = heads * kDh;
  const float* qb = q + (size_t)b * len * d_model;
  const float* kb = k + (size_t)b * len * d_model;
  const float* vb = v + (size_t)b * len * d_model;
  const float* mb = key_valid + (size_t)b * len;
  const int n_tiles = (len + kTileKeys - 1) / kTileKeys;
  const uint32_t drop_h = TRAIN ? drop_head(seed, b * heads + h) : 0u;

  // one bit per key tile that holds at least one valid key
  if (threadIdx.x == 0) tile_mask = 0u;
  __syncthreads();
  for (int t = warp; t < n_tiles; t += kWarps) {
    bool any = false;
#pragma unroll
    for (int u = 0; u < kKPL; ++u) {
      const int j = t * kTileKeys + lane + 32 * u;
      any |= j < len && mb[j] > 0.f;
    }
    if (__any_sync(0xffffffffu, any) && lane == 0) atomicOr(&tile_mask, 1u << t);
  }

  // the Q tile; rows past len copy row len - 1, computed and never written
  for (int i = threadIdx.x; i < kTileRows * (kDh / 4); i += blockDim.x) {
    const int r = i >> 3;
    const int c = (i & 7) * 4;
    const int row = min(row0 + r, len - 1);
    cp_async16(q_s + r * kDh + c, qb + (size_t)row * d_model + h * kDh + c);
  }
  __syncthreads();
  const unsigned mask = tile_mask;

  // online softmax state of the warp's 8 rows, the same in every lane; each
  // lane keeps its own keys' share of the row sums
  float m[kRowsPerWarp];
  float l_part[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l_part[r] = 0.f;
  }
  // p.v phase: row wrow + pr, columns pc .. pc + 7
  const int pr = lane >> 2;
  const int pc = (lane & 3) * 8;
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  float* pw = p_s + wrow * kPStride;
  const float* q_w = q_s + wrow * kDh;

  int tile = next_tile(mask, 0);
  if (tile >= 0) load_tile(stages, kb, vb, tile, len, d_model, h);
  cp_async_commit();  // with the Q tile
  for (int it = 0; tile >= 0; ++it) {
    const int next = next_tile(mask, tile + 1);
    if (next >= 0) {
      load_tile(stages + ((it + 1) & 1) * kStageFloats, kb, vb, next, len,
                d_model, h);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();  // this thread's copies of `tile` landed
    __syncthreads();                 // and every other thread's
    if (it == 0) {
      // the warp scales its own 8 rows of q once, before the dot products
      for (int i = lane * 4; i < kRowsPerWarp * kDh; i += 128) {
        float4 x = ld4(q_s + wrow * kDh + i);
        x.x *= scale;
        x.y *= scale;
        x.z *= scale;
        x.w *= scale;
        st4(q_s + wrow * kDh + i, x);
      }
      __syncwarp();
    }
    const float* k_s = stages + (it & 1) * kStageFloats;
    const float* v_s = k_s + kTileKeys * kKStride;

    bool key_ok[kKPL];
#pragma unroll
    for (int u = 0; u < kKPL; ++u) {
      const int j = tile * kTileKeys + lane + 32 * u;
      key_ok[u] = j < len && mb[j] > 0.f;
    }

    // q.k: 8 rows x 4 keys per lane
    float s[kRowsPerWarp][kKPL];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int u = 0; u < kKPL; ++u) s[r][u] = 0.f;
#pragma unroll
    for (int d = 0; d < kDh; d += 4) {
      float4 kk[kKPL];
#pragma unroll
      for (int u = 0; u < kKPL; ++u) kk[u] = ld4(k_s + (lane + 32 * u) * kKStride + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = ld4(q_w + r * kDh + d);
#pragma unroll
        for (int u = 0; u < kKPL; ++u) {
          float a = s[r][u];
          a = fmaf(qq.x, kk[u].x, a);
          a = fmaf(qq.y, kk[u].y, a);
          a = fmaf(qq.z, kk[u].z, a);
          a = fmaf(qq.w, kk[u].w, a);
          s[r][u] = a;
        }
      }
    }

    // online softmax: the tile holds a valid key, so every row's new max is
    // finite; masked keys get P = 0 exactly
    float alpha_pr = 1.f;  // the rescale of row pr, for this lane's p.v
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kKPL; ++u) {
        if (key_ok[u]) mx = fmaxf(mx, s[r][u]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float alpha = expf(m[r] - m_new);  // 0 on the first tile
      m[r] = m_new;
      float sum = 0.f;
      const uint32_t drop_r =
          TRAIN && threshold != 0u ? drop_row(drop_h, row0 + wrow + r) : 0u;
#pragma unroll
      for (int u = 0; u < kKPL; ++u) {
        const float p = key_ok[u] ? expf(s[r][u] - m_new) : 0.f;
        sum += p;
        float pv = p;  // the probability p.v reads: dropped in training
        if (TRAIN && threshold != 0u) {
          pv *= drop_scale(drop_r, tile * kTileKeys + lane + 32 * u, threshold, keep_scale);
        }
        pw[r * kPStride + lane + 32 * u] = pv;
      }
      l_part[r] = l_part[r] * alpha + sum;
      if (r == pr) alpha_pr = alpha;
    }
    __syncwarp();

    // p.v: one row, 8 columns per lane, keys in fours
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] *= alpha_pr;
    const float* prow = pw + pr * kPStride;
#pragma unroll 4
    for (int j = 0; j < kTileKeys; j += 4) {
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
    __syncthreads();  // this stage and P are free for the tile after next
    tile = next;
  }
  cp_async_wait_all();  // a block with no valid key never waited for its Q

  // the row sums across the warp, in a fixed order
  float l_pr = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float l = warp_sum(l_part[r]);
    if (r == pr) l_pr = l;
    if (TRAIN && lane == 0 && row0 + wrow + r < len) {
      lse[((size_t)b * heads + h) * len + row0 + wrow + r] = m[r] + logf(l);
    }
  }
  const float inv = l_pr > 0.f ? 1.f / l_pr : 0.f;  // no valid key: zeros
  const int row = row0 + wrow + pr;
  if (row < len) {
    float* o = out + ((size_t)b * len + row) * d_model + h * kDh + pc;
    st4(o, make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv));
    st4(o + 4, make_float4(acc[4] * inv, acc[5] * inv, acc[6] * inv, acc[7] * inv));
  }
}

template <bool TRAIN>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* key_valid, float* out, int batch, int len,
                   int heads, int head_dim, float scale, float* lse, uint32_t seed,
                   uint32_t threshold, float keep_scale, cudaStream_t stream) {
  if (head_dim != kDh || len < 1 || len > kMaxLen || batch < 1 ||
      batch > 65535 || heads < 1 || heads > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_kernel<TRAIN>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((len + kTileRows - 1) / kTileRows, heads, batch);
  flash_attention_kernel<TRAIN><<<grid, kWarps * 32, kSmemBytes, stream>>>(
      q, k, v, key_valid, out, len, heads, scale, lse, seed, threshold, keep_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// q, k, v and out (B, L, H*Dh), key_valid (B, L); all f32, contiguous and
// 16-byte aligned; 1 <= L <= 4096, Dh = 32.
int flashvtg_flash_attention_f32(const float* q, const float* k, const float* v,
                                 const float* key_valid, float* out, int batch,
                                 int len, int heads, int head_dim, float scale,
                                 void* stream) {
  return (int)launch<false>(q, k, v, key_valid, out, batch, len, heads, head_dim, scale,
                            nullptr, 0u, 0u, 1.f, (cudaStream_t)stream);
}

// The training form: as above, plus lse (B, H, L) and attention dropout
// (threshold = floor(p * 2^24), keep_scale = 1 / (1 - p); threshold 0 = none).
int flashvtg_flash_attention_train_f32(const float* q, const float* k, const float* v,
                                       const float* key_valid, float* out, float* lse,
                                       int batch, int len, int heads, int head_dim,
                                       float scale, unsigned seed, unsigned threshold,
                                       float keep_scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch<true>(q, k, v, key_valid, out, batch, len, heads, head_dim, scale,
                           lse, seed, threshold, keep_scale, (cudaStream_t)stream);
}

}  // extern "C"
