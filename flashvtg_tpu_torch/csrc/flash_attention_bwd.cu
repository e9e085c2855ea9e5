// Memory-linear backward of the masked self-attention (flash_attention.cu),
// for Hopper (sm_90a), f32 on CUDA cores: the FlashAttention-2 backward.
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
//   dk_j  = sum_i dS_ij (scale q_i)
//   dv_j  = sum_i P_ij z_ij dO_i
// Probabilities are recomputed from q, k and lse and never stored: the
// (B, H, L, L) tensor never exists in device memory. A batch row with no
// valid key gets zeros everywhere, as the forward gives it zeros.
//
// What bounds it: at the TACoS train shape (B=32, H=8, L=2048, Dh=32, every
// key valid) the work is 10 B H L^2 Dh = 343.6 GFLOP (q.k and dO.v
// recomputed, dq, dk and dv): 5.13 ms at 67 TFLOP/s f32, against ~0.4 GB of
// inputs and outputs (0.12 ms at 3.35 TB/s): bound by operations. The
// design is the forward's, split in two kernels so that every sum stays in
// one block (no float atomics; launches agree bit for bit):
//  * pre-pass: one warp per (b, i) row computes D for every head;
//  * dk/dv: a block owns (b, h) and a tile of 64 keys (skipped, and written
//    as zeros, when all 64 are masked), keeps K and V of the tile in shared
//    memory and loops over all query tiles of 64 rows (every query row,
//    padded rows included, takes part in the loss); per query tile a warp
//    owns 8 rows and a lane keys lane and lane + 32: q.k and dO.v in
//    registers, P z and dS to shared memory; then a thread owns one key and
//    8 columns of dk and dv, summed in registers over every query tile;
//  * dq: a block owns (b, h) and a tile of 64 query rows, keeps the Q and dO
//    tile in shared memory and loops over the 128-key tiles that hold a
//    valid key (one bit per tile, as the forward); dS goes to shared memory
//    and a lane sums one row's 8 columns of dS k in registers.
// This recomputes q.k and dO.v in both kernels: 14 B H L^2 Dh FLOP in all
// against the 10 of the bound. No tensor cores and no TF32: this is the f32
// parity mode.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "attn_dropout.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTileRows = kRowsPerWarp * kWarps;  // query rows per tile
constexpr int kKvKeys = 64;                       // keys per dk/dv block
constexpr int kDqKeys = 128;                      // keys per dq tile
constexpr int kMaxTiles = 32;                     // of 128 keys: L <= 4096
constexpr int kMaxLen = kDqKeys * kMaxTiles;

struct Operands {
  const float* q;
  const float* k;
  const float* v;
  const float* key_valid;
  const float* lse;
  const float* d_out;
  const float* delta;  // (B, H, L), the pre-pass
  float* dq;
  float* dk;
  float* dv;
  int len, heads;
  float scale;
  uint32_t seed, threshold;
  float keep_scale;
};

// D[b, h, i] = dO[b, i, h] . O[b, i, h]: one warp per (b, i), a lane 8
// columns, the four lanes of a head summed with shuffles
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

// Loads the Q tile (scaled) and the dO tile of rows row0 .. row0 + 63, rows
// past len reading row len - 1 (they get P = 0), plus their lse and D.
__device__ __forceinline__ void load_query_tile(const Operands& a, float* q_s, float* do_s,
                                                float* lse_s, float* delta_s, int b,
                                                int h, int row0) {
  const int d_model = a.heads * kDh;
  for (int i = threadIdx.x; i < kTileRows * (kDh / 4); i += blockDim.x) {
    const int r = i >> 3;
    const int c = (i & 7) * 4;
    const size_t g = ((size_t)b * a.len + min(row0 + r, a.len - 1)) * d_model + h * kDh + c;
    st4(q_s + r * kDh + c, scaled(ld4(a.q + g), a.scale));
    st4(do_s + r * kDh + c, ld4(a.d_out + g));
  }
  for (int r = threadIdx.x; r < kTileRows; r += blockDim.x) {
    const int row = min(row0 + r, a.len - 1);
    const size_t g = ((size_t)b * a.heads + h) * a.len + row;
    lse_s[r] = a.lse[g];
    delta_s[r] = a.delta[g];
  }
}

// Loads `keys` rows of K and V from key j0 (rows past len zero).
__device__ __forceinline__ void load_key_tile(const Operands& a, float* k_s, float* v_s,
                                              int b, int h, int j0, int keys) {
  const int d_model = a.heads * kDh;
  for (int i = threadIdx.x; i < keys * (kDh / 4); i += blockDim.x) {
    const int r = i >> 3;
    const int c = (i & 7) * 4;
    float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
    if (j0 + r < a.len) {
      const size_t g = ((size_t)b * a.len + j0 + r) * d_model + h * kDh + c;
      kk = ld4(a.k + g);
      vv = ld4(a.v + g);
    }
    st4(k_s + r * kKStride + c, kk);
    st4(v_s + r * kKStride + c, vv);
  }
}

// For the warp's 8 rows and this lane's KPL keys (lane + 32 t of the tile at
// j0): P z and dS, written to shared memory with row stride `stride`.
template <int KPL>
__device__ __forceinline__ void probs_and_grads(const Operands& a, const float* q_s,
                                                const float* do_s, const float* k_s,
                                                const float* v_s, const float* lse_s,
                                                const float* delta_s, const bool* key_ok,
                                                uint32_t drop_h, int row0, int j0,
                                                float* pz_s, float* ds_s, int stride) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wrow = warp * kRowsPerWarp;
  float s[kRowsPerWarp][KPL], dpv[kRowsPerWarp][KPL];
  qk_dov<KPL>(q_s + wrow * kDh, do_s + wrow * kDh, k_s, v_s, s, dpv);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + wrow + r;
    const bool live = row < a.len;
    const float lse = lse_s[wrow + r];
    const float dd = delta_s[wrow + r];
    const uint32_t drop_r = a.threshold != 0u ? drop_row(drop_h, row) : 0u;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int jl = lane + 32 * t;
      const float p = live && key_ok[t] ? expf(s[r][t] - lse) : 0.f;
      const float z =
          a.threshold != 0u ? drop_scale(drop_r, j0 + jl, a.threshold, a.keep_scale) : 1.f;
      if (pz_s != nullptr) pz_s[(wrow + r) * stride + jl] = p * z;
      ds_s[(wrow + r) * stride + jl] = p * (z * dpv[r][t] - dd);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32, 2)
flash_bwd_dkdv_kernel(const Operands a) {
  constexpr int kPStride = kKvKeys + 4;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kKvKeys * kKStride;
  float* q_s = v_s + kKvKeys * kKStride;
  float* do_s = q_s + kTileRows * kDh;
  float* pz_s = do_s + kTileRows * kDh;
  float* ds_s = pz_s + kTileRows * kPStride;
  float* lse_s = ds_s + kTileRows * kPStride;
  float* delta_s = lse_s + kTileRows;
  __shared__ int any_valid;

  const int j0 = blockIdx.x * kKvKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int d_model = a.heads * kDh;
  const float* mb = a.key_valid + (size_t)b * a.len;

  bool key_ok[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = j0 + lane + 32 * t;
    key_ok[t] = j < a.len && mb[j] > 0.f;
  }
  if (threadIdx.x == 0) any_valid = 0;
  __syncthreads();
  if (threadIdx.x < 32 && __any_sync(0xffffffffu, key_ok[0] || key_ok[1]) && lane == 0) {
    any_valid = 1;
  }
  __syncthreads();

  // dk / dv phase: key kj of the tile, columns kc .. kc + 7
  const int kj = threadIdx.x >> 2;
  const int kc = (threadIdx.x & 3) * 8;
  float acc_dk[8], acc_dv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    acc_dk[c] = 0.f;
    acc_dv[c] = 0.f;
  }

  if (any_valid) {
    load_key_tile(a, k_s, v_s, b, h, j0, kKvKeys);
    const uint32_t drop_h = drop_head(a.seed, b * a.heads + h);
    for (int row0 = 0; row0 < a.len; row0 += kTileRows) {
      load_query_tile(a, q_s, do_s, lse_s, delta_s, b, h, row0);
      __syncthreads();
      probs_and_grads<2>(a, q_s, do_s, k_s, v_s, lse_s, delta_s, key_ok, drop_h, row0, j0,
                         pz_s, ds_s, kPStride);
      __syncthreads();
      const int rows = min(kTileRows, a.len - row0);
      for (int i = 0; i < rows; ++i) {
        const float g = ds_s[i * kPStride + kj];
        const float w = pz_s[i * kPStride + kj];
#pragma unroll
        for (int c = 0; c < 8; c += 4) {
          axpy4(acc_dk + c, g, ld4(q_s + i * kDh + kc + c));
          axpy4(acc_dv + c, w, ld4(do_s + i * kDh + kc + c));
        }
      }
      __syncthreads();  // the tile's buffers are free for the next one
    }
  }

  if (j0 + kj < a.len) {
    const size_t g = ((size_t)b * a.len + j0 + kj) * d_model + h * kDh + kc;
#pragma unroll
    for (int c = 0; c < 8; c += 4) {
      st4(a.dk + g + c, make_float4(acc_dk[c], acc_dk[c + 1], acc_dk[c + 2], acc_dk[c + 3]));
      st4(a.dv + g + c, make_float4(acc_dv[c], acc_dv[c + 1], acc_dv[c + 2], acc_dv[c + 3]));
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32, 2)
flash_bwd_dq_kernel(const Operands a) {
  constexpr int kPStride = kDqKeys + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kTileRows * kDh;
  float* k_s = do_s + kTileRows * kDh;
  float* v_s = k_s + kDqKeys * kKStride;
  float* ds_s = v_s + kDqKeys * kKStride;
  float* lse_s = ds_s + kTileRows * kPStride;
  float* delta_s = lse_s + kTileRows;
  __shared__ unsigned tile_mask;

  const int row0 = blockIdx.x * kTileRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wrow = warp * kRowsPerWarp;
  const int d_model = a.heads * kDh;
  const float* mb = a.key_valid + (size_t)b * a.len;
  const int n_tiles = (a.len + kDqKeys - 1) / kDqKeys;

  // one bit per 128-key tile that holds a valid key
  if (threadIdx.x == 0) tile_mask = 0u;
  __syncthreads();
  for (int t = warp; t < n_tiles; t += kWarps) {
    bool any = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = t * kDqKeys + lane + 32 * u;
      any |= j < a.len && mb[j] > 0.f;
    }
    if (__any_sync(0xffffffffu, any) && lane == 0) atomicOr(&tile_mask, 1u << t);
  }
  load_query_tile(a, q_s, do_s, lse_s, delta_s, b, h, row0);
  __syncthreads();
  const unsigned mask = tile_mask;
  const uint32_t drop_h = drop_head(a.seed, b * a.heads + h);

  // row wrow + pr, columns pc .. pc + 7
  const int pr = lane >> 2;
  const int pc = (lane & 3) * 8;
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (!(mask & (1u << tile))) continue;
    const int j0 = tile * kDqKeys;
    load_key_tile(a, k_s, v_s, b, h, j0, kDqKeys);
    __syncthreads();
    bool key_ok[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = j0 + lane + 32 * t;
      key_ok[t] = j < a.len && mb[j] > 0.f;
    }
    probs_and_grads<4>(a, q_s, do_s, k_s, v_s, lse_s, delta_s, key_ok, drop_h, row0, j0,
                       nullptr, ds_s, kPStride);
    __syncwarp();
    const float* dsrow = ds_s + (wrow + pr) * kPStride;
#pragma unroll 4
    for (int j = 0; j < kDqKeys; ++j) {
      const float g = dsrow[j];
      axpy4(acc, g, ld4(k_s + j * kKStride + pc));
      axpy4(acc + 4, g, ld4(k_s + j * kKStride + pc + 4));
    }
    __syncthreads();  // K, V and dS are free for the next tile
  }

  const int row = row0 + wrow + pr;
  if (row < a.len) {
    float* o = a.dq + ((size_t)b * a.len + row) * d_model + h * kDh + pc;
    st4(o, scaled(make_float4(acc[0], acc[1], acc[2], acc[3]), a.scale));
    st4(o + 4, scaled(make_float4(acc[4], acc[5], acc[6], acc[7]), a.scale));
  }
}

constexpr int kDkdvSmem =
    sizeof(float) * (2 * kKvKeys * kKStride + 2 * kTileRows * kDh +
                     2 * kTileRows * (kKvKeys + 4) + 2 * kTileRows);
constexpr int kDqSmem =
    sizeof(float) * (2 * kTileRows * kDh + 2 * kDqKeys * kKStride +
                     kTileRows * (kDqKeys + 4) + 2 * kTileRows);

}  // namespace

extern "C" {

// Launches the pre-pass, the dk/dv kernel and the dq kernel on `stream` and
// returns cudaGetLastError() (0 = launched). q, k, v, out, d_out, dq, dk, dv
// (B, L, H*Dh); key_valid (B, L); lse and delta (B, H, L), delta scratch
// that the pre-pass fills; threshold = floor(p * 2^24) (0 = no dropout),
// keep_scale = 1 / (1 - p), seed as the forward's. f32, contiguous and
// 16-byte aligned; 1 <= L <= 4096, Dh = 32.
int flashvtg_flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                                     const float* key_valid, const float* out,
                                     const float* lse, const float* d_out, float* delta,
                                     float* dq, float* dk, float* dv, int batch, int len,
                                     int heads, int head_dim, float scale, unsigned seed,
                                     unsigned threshold, float keep_scale, void* stream) {
  if (head_dim != kDh || len < 1 || len > kMaxLen || batch < 1 || batch > 65535 ||
      heads < 1 || heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = batch * len;
  flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, s>>>(out, d_out, delta, rows, len, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const Operands a = {q, k, v, key_valid, lse, d_out, delta, dq, dk, dv,
                      len, heads, scale, seed, threshold, keep_scale};
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<<<dim3((len + kKvKeys - 1) / kKvKeys, heads, batch), kWarps * 32,
                          kDkdvSmem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDqSmem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<<<dim3((len + kTileRows - 1) / kTileRows, heads, batch), kWarps * 32,
                        kDqSmem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
