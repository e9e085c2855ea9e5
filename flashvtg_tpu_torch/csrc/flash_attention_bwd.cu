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
// atomics; launches agree bit for bit), on mma.sync.m16n8k8 at the 3xTF32
// and 1xTF32 forms (the bf16 form: below):
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
// The bf16 form has bodies of its own (dkdv_bf16, dq_bf16) on Hopper's
// warpgroup product, wgmma, fed by TMA (attn_common.cuh, last section):
//  * its pre-pass (flash_bwd_stage_kernel) also rounds scale q, q and dO to
//    bf16 once, into (B, L, H * 32) copies that the wrapper allocates, and
//    k and v unless the training forward's copies of them are handed over
//    (flash_attention.cu rounds them alike, for its own TMA copies); no
//    block rounds an f32 operand in its product loop (on mma.sync each key
//    block rounded every query row of its head again);
//  * a block is one warpgroup: 64 query rows (dq) or 64 keys (dk/dv), the M
//    of wgmma.m64nNk16. Its fixed operands (scale Q and dO; K and V) come by
//    TMA once, the streamed ones (the dq kernel's 128-key K and V tiles that
//    hold a valid key; the dk/dv kernel's 64-row scale Q, Q and dO tiles)
//    through a ring of TMA stages, one mbarrier a stage, the copies issued
//    by one thread kDqStages / kKvStages tiles ahead; the dk/dv stage's lse,
//    D' and row hashes come by cp.async beside them;
//  * S = (scale Q) K^T and dP = dO V^T (S^T and dP^T in the dk/dv kernel,
//    K and V as A) for 32 keys (query rows) at a time are wgmma from shared
//    memory on 64-byte-swizzled tiles, each k16 step in a fresh accumulator
//    added on the CUDA cores: the sums of attn_common.cuh dot_bf16, which
//    the forward (flash_attention.cu, on wgmma too) takes its S by, so the
//    forward's S, the dq kernel's S and the dk/dv kernel's S^T agree bit
//    for bit, and so do dP and dP^T; D' sums the very terms the dk/dv
//    kernel forms, and dS' = P (z dP - D') is exactly 0 over a batch row
//    with one valid key (P = 1 there), so dk is exactly 0, as at the f32
//    forms;
//  * P z and dS (dS^T) feed dq += dS K (dv += (P z)^T dO, dk += dS^T Q) as
//    A operands from registers, K (dO, Q) read transposed from the same
//    tiles; the sums run in the wgmma accumulators across the whole loop
//    (truncating f32 accumulation: far inside the bf16 form's band);
//  * no float atomics: launches agree bit for bit. A batch row with no
//    valid key still gets zeros everywhere (P = 0).

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

// ---- the bf16 form on Hopper's warpgroup products (attn_common.cuh) ---------
//
// The same two kernels on wgmma, one warpgroup (four warps) a block, from
// bf16 tiles that TMA copies into shared memory (the design: this file's
// head). The element-wise work, the masks, the dropout and the D' sums are
// the f32 forms'; the accumulator's layout is the m16n8 C layout (a warp's
// 16 rows, n-tiles of 8 columns), so their indices are those forms' too.

constexpr int kSub = 32;        // keys (dq) or query rows (dk/dv) a product's N
constexpr int kDqStages = 2;    // 128-key tiles of K and V in flight, dq kernel
constexpr int kKvStages = 3;    // 64-row tiles of scale Q, Q and dO in flight, dk/dv kernel
constexpr int kBlocksBF16 = 3;  // blocks an SM (__launch_bounds__), both kernels
static_assert(kDqChunk == kSub && kQTile == kBoxRows && kKvKeys == kBoxRows,
              "a dq chunk is one mask word and one product's N; a query stage one box");

// the pre-pass's bf16 copies, (B, L, H * 32) each: what the TMA maps read
struct StagedBF16 {
  uint16_t* qs;  // bf16(scale q): S and S^T, as the forward rounds it
  uint16_t* q;   // bf16(q): dk
  uint16_t* k;
  uint16_t* v;
  uint16_t* d_out;
};

// their TMA maps (attn_common.cuh tma_load_3d), boxes of 32 x kBoxRows x 1
struct TileMaps {
  CUtensorMap qs, q, k, v, d_out;
};

// The bf16 form's pre-pass, in place of flash_bwd_delta_kernel: D as that
// kernel sums it, and the bf16 copies of scale q, q and dO, and with KV of
// k and v, rounded once here (each product kernel's block would otherwise
// round its tiles again: every query row once a key block). Without KV the
// training forward's pre-pass (flash_attention.cu flash_fwd_stage_kernel)
// wrote st.k and st.v already, by the same st_bf16x8.
template <bool KV>
__global__ void __launch_bounds__(256)
flash_bwd_stage_kernel(const Operands a, const float* __restrict__ out, const StagedBF16 st,
                       int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int b = row / a.len;
  const int i = row - b * a.len;
  const int d_model = a.heads * kDh;
  for (int base = 0; base < d_model; base += 256) {
    const int c = base + lane * 8;
    float s = 0.f;
    if (c < d_model) {
      const size_t g = (size_t)row * d_model + c;
      const float4 d0 = ld4(a.d_out + g), d1 = ld4(a.d_out + g + 4);
      s = dot4(ld4(out + g), d0, 0.f);
      s = dot4(ld4(out + g + 4), d1, s);
      const float4 q0 = ld4(a.q + g), q1 = ld4(a.q + g + 4);
      st_bf16x8(st.qs + g, q0, q1, a.scale);
      st_bf16x8(st.q + g, q0, q1, 1.f);
      if (KV) {
        st_bf16x8(st.k + g, ld4(a.k + g), ld4(a.k + g + 4), 1.f);
        st_bf16x8(st.v + g, ld4(a.v + g), ld4(a.v + g + 4), 1.f);
      }
      st_bf16x8(st.d_out + g, d0, d1, 1.f);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (c < d_model && (lane & 3) == 0) {
      a.delta[((size_t)b * a.heads + c / kDh) * a.len + i] = s;
    }
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the lse, D' and dropout row hashes of query rows row0 .. row0 + kQTile - 1
// into `s` (rows past len read row len - 1), as load_query_stage's
__device__ __forceinline__ void load_query_scalars(const Operands& a, unsigned char* s, int b,
                                                   int h, int row0, uint32_t drop_h) {
  float* lse_s = reinterpret_cast<float*>(s);
  float* d_s = lse_s + kQTile;
  uint32_t* rh_s = reinterpret_cast<uint32_t*>(d_s + kQTile);
  for (int r = threadIdx.x; r < kQTile; r += blockDim.x) {
    const size_t g = ((size_t)b * a.heads + h) * a.len + min(row0 + r, a.len - 1);
    cp_async4(lse_s + r, a.lse + g);
    cp_async4(d_s + r, a.delta + g);
    rh_s[r] = a.threshold != 0u ? drop_row(drop_h, row0 + r) : 0u;
  }
}

// a dk/dv stage: scale Q, Q and dO tiles (64 rows), then the scalars
constexpr int kKvStageBytes = 3 * kTileBytes + 1024;
// a dq stage: K and V tiles of kDqKeys rows (two boxes each)
constexpr int kDqStageBytes = 2 * (kDqKeys / kBoxRows) * kTileBytes;

// TMA copies of the 128-key tile `tile` of head h into a dq stage
__device__ __forceinline__ void copy_kv_tile(const TileMaps& m, unsigned char* stage,
                                             uint64_t* bar, int h, int tile, int b) {
  constexpr int kBoxes = kDqKeys / kBoxRows;
  mbar_expect_tx(bar, kDqStageBytes);
#pragma unroll
  for (int i = 0; i < kBoxes; ++i) {
    const int r = tile * kDqKeys + i * kBoxRows;
    tma_load_3d(stage + i * kTileBytes, &m.k, h * kDh, r, b, bar);
    tma_load_3d(stage + (kBoxes + i) * kTileBytes, &m.v, h * kDh, r, b, bar);
  }
}

// TMA copies of the 64 query rows from row0 of head h into a dk/dv stage
__device__ __forceinline__ void copy_query_tile(const TileMaps& m, unsigned char* stage,
                                                uint64_t* bar, int h, int row0, int b) {
  mbar_expect_tx(bar, 3 * kTileBytes);
  tma_load_3d(stage, &m.qs, h * kDh, row0, b, bar);
  tma_load_3d(stage + kTileBytes, &m.q, h * kDh, row0, b, bar);
  tma_load_3d(stage + 2 * kTileBytes, &m.d_out, h * kDh, row0, b, bar);
}

// S = a b^T and dP = c d^T over the head dim, 64 rows of a (c) by 32 of b
// (d), K-major tiles: each k16 step in a fresh accumulator, the two added
// on the CUDA cores as attn_common.cuh dot_bf16 adds them, so S is the
// forward's S bit for bit and a transposed call (S^T = K Q^T) gives S^T.
// S and dP are two commit groups: on_s(s) (the probabilities) runs on the
// CUDA cores while the dP products are still in flight.
template <class OnS>
__device__ __forceinline__ void dot_pair_wgmma(float (&s)[16], float (&dp)[16], uint64_t a,
                                               uint64_t b, uint64_t c, uint64_t d, OnS on_s) {
  float s1[16], dp1[16];
  wgmma_fence();
  wgmma_n32_ss(s, a, b);
  wgmma_n32_ss(s1, a + 2, b + 2);  // the second k16 step: 32 bytes on, 2 in the address field
  wgmma_commit();
  wgmma_n32_ss(dp, c, d);
  wgmma_n32_ss(dp1, c + 2, d + 2);
  wgmma_commit();
  wgmma_wait<1>();  // S's group (groups complete in order)
  wgmma_hold(s);
  wgmma_hold(s1);
#pragma unroll
  for (int e = 0; e < 16; ++e) s[e] += s1[e];
  on_s(s);
  wgmma_wait<0>();
  wgmma_hold(dp);
  wgmma_hold(dp1);
#pragma unroll
  for (int e = 0; e < 16; ++e) dp[e] += dp1[e];
}

__device__ __forceinline__ void dkdv_bf16(const Operands& a, const TileMaps& maps,
                                          unsigned char* smem) {
  unsigned char* base = align1024(smem);
  unsigned char* k_t = base;
  unsigned char* v_t = base + kTileBytes;
  unsigned char* ring = base + 2 * kTileBytes;
  // [0] K and V, [1 + s] stage s
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kKvStages * kKvStageBytes);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d_model = a.heads * kDh;
  const float* mb = a.key_valid + (size_t)b * a.len;
  const int k0 = (int)blockIdx.x * kKvKeys;
  // this lane's keys, its accumulator rows: key[0] and key[1] = key[0] + 8
  const int key0 = k0 + warp * 16 + g;
  const int key[2] = {key0, key0 + 8};
  const bool key_ok[2] = {key[0] < a.len && mb[key[0]] > 0.f,
                          key[1] < a.len && mb[key[1]] > 0.f};

  float dk[16], dv[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    dk[e] = 0.f;
    dv[e] = 0.f;
  }

  if (__syncthreads_or(key_ok[0] || key_ok[1])) {
    const int n_q = (a.len + kQTile - 1) / kQTile;
    const uint32_t drop_h = drop_head(drop_seed(a.seed), b * a.heads + h);
    if (threadIdx.x == 0) {
      for (int i = 0; i <= kKvStages; ++i) mbar_init(bars + i, 1);
      mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bars, 2 * kTileBytes);
      tma_load_3d(k_t, &maps.k, h * kDh, k0, b, bars);
      tma_load_3d(v_t, &maps.v, h * kDh, k0, b, bars);
      for (int s = 0; s < kKvStages && s < n_q; ++s) {
        copy_query_tile(maps, ring + s * kKvStageBytes, bars + 1 + s, h, s * kQTile, b);
      }
    }
#pragma unroll
    for (int s = 0; s < kKvStages; ++s) {
      if (s < n_q) {
        load_query_scalars(a, ring + s * kKvStageBytes + 3 * kTileBytes, b, h, s * kQTile,
                           drop_h);
      }
      cp_async_commit();  // one group a stage, empty or not
    }
    const uint64_t kd = wgmma_desc(k_t, kDescKMajor), vd = wgmma_desc(v_t, kDescKMajor);
    mbar_wait(bars, 0);

    for (int qt = 0; qt < n_q; ++qt) {
      const int stage = qt % kKvStages;
      unsigned char* cur = ring + stage * kKvStageBytes;
      const unsigned char* qs_t = cur;
      const unsigned char* q_t = cur + kTileBytes;
      const unsigned char* do_t = cur + 2 * kTileBytes;
      const float* lse_s = reinterpret_cast<const float*>(cur + 3 * kTileBytes);
      const float* d_s = lse_s + kQTile;
      const uint32_t* rh_s = reinterpret_cast<const uint32_t*>(d_s + kQTile);
      cp_async_wait<kKvStages - 1>();
      __syncthreads();  // every thread's scalars of this stage are in place
      mbar_wait(bars + 1 + stage, (qt / kKvStages) & 1);

#pragma unroll 1
      for (int sub = 0; sub < kQTile; sub += kSub) {
        // S^T = K (scale Q)^T and dP^T = V dO^T: 64 keys x kSub query rows;
        // P^T in place of S^T while dP^T is in flight. This lane's query
        // rows are 2t, 2t + 1 of each 8 (li, li + 1 in the stage)
        float st[16], dpt[16];
        dot_pair_wgmma(st, dpt, kd, wgmma_desc(qs_t + sub * kRowBytes, kDescKMajor), vd,
                       wgmma_desc(do_t + sub * kRowBytes, kDescKMajor), [&](float (&p)[16]) {
#pragma unroll
          for (int n = 0; n < kSub / 8; ++n) {
            const int li = sub + 8 * n + 2 * t;
            const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + li);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = e & 1;   // which of the two rows
              const int r = e >> 1;  // which of the two keys
              const bool live = key_ok[r] && qt * kQTile + li + c < a.len;
              p[4 * n + e] =
                  live ? exp2_fast((p[4 * n + e] - (c ? lse2.y : lse2.x)) * kLog2e) : 0.f;
            }
          }
        });

        // P^T z and dS^T in place
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n) {
          const int li = sub + 8 * n + 2 * t;
          const float2 d2 = *reinterpret_cast<const float2*>(d_s + li);
          const uint2 rh2 = *reinterpret_cast<const uint2*>(rh_s + li);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = e & 1;
            const int r = e >> 1;
            const float p = st[4 * n + e];
            const float z =
                a.threshold != 0u
                    ? drop_scale(c ? rh2.y : rh2.x, key[r], a.threshold, a.keep_scale)
                    : 1.f;
            st[4 * n + e] = p * z;
            dpt[4 * n + e] = p * (z * dpt[4 * n + e] - (c ? d2.y : d2.x));
          }
        }

        // dv += (P z)^T dO and dk += dS^T Q over the kSub rows: A from
        // registers, dO and Q read transposed (MN-major), a k16 step per 16
        // rows, dv and dk accumulated across every stage
        uint32_t pa[kSub / 16][4], da[kSub / 16][4];
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) {
          acc_to_a(pa[kk], st, kk);
          acc_to_a(da[kk], dpt, kk);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) {
          const int r0 = (sub + 16 * kk) * kRowBytes;
          wgmma_n32_rs(dv, pa[kk], wgmma_desc(do_t + r0, kDescMNMajor));
          wgmma_n32_rs(dk, da[kk], wgmma_desc(q_t + r0, kDescMNMajor));
        }
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_hold(dv);
        wgmma_hold(dk);
      }

      __syncthreads();  // every warp is done with this stage: refill it
      const int fill = qt + kKvStages;
      if (threadIdx.x == 0 && fill < n_q) {
        fence_proxy_async();
        copy_query_tile(maps, cur, bars + 1 + stage, h, fill * kQTile, b);
      }
      if (fill < n_q) {
        load_query_scalars(a, cur + 3 * kTileBytes, b, h, fill * kQTile, drop_h);
      }
      cp_async_commit();
    }
    cp_async_wait_all();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.len) continue;
    const size_t g0 = ((size_t)b * a.len + key[r]) * d_model + h * kDh + 2 * t;
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      const int e = 4 * n + 2 * r;
      *reinterpret_cast<float2*>(a.dk + g0 + 8 * n) =
          make_float2(dk[e] * a.scale, dk[e + 1] * a.scale);
      *reinterpret_cast<float2*>(a.dv + g0 + 8 * n) = make_float2(dv[e], dv[e + 1]);
    }
  }
}

__device__ __forceinline__ void dq_bf16(const Operands& a, const TileMaps& maps,
                                        unsigned char* smem, uint32_t* key_bits,
                                        unsigned* tile_mask) {
  unsigned char* base = align1024(smem);
  unsigned char* qs_t = base;
  unsigned char* do_t = base + kTileBytes;
  unsigned char* ring = base + 2 * kTileBytes;
  // [0] scale Q and dO, [1 + s] stage s
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kDqStages * kDqStageBytes);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d_model = a.heads * kDh;
  const int q0 = (int)blockIdx.x * kDqRows;
  // this lane's query rows, its accumulator rows
  const int row0 = q0 + warp * 16 + g;
  const int row[2] = {row0, row0 + 8};

  build_key_mask(key_bits, tile_mask, a.key_valid + (size_t)b * a.len, a.len);
  const unsigned mask = *tile_mask;
  if (threadIdx.x == 0 && mask != 0u) {
    for (int i = 0; i <= kDqStages; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  int ahead = next_tile(mask, 0);  // the next tile to copy (thread 0's)
  if (threadIdx.x == 0 && mask != 0u) {
    mbar_expect_tx(bars, 2 * kTileBytes);
    tma_load_3d(qs_t, &maps.qs, h * kDh, q0, b, bars);
    tma_load_3d(do_t, &maps.d_out, h * kDh, q0, b, bars);
    for (int s = 0; s < kDqStages && ahead >= 0; ++s) {
      copy_kv_tile(maps, ring + s * kDqStageBytes, bars + 1 + s, h, ahead, b);
      ahead = next_tile(mask, ahead + 1);
    }
  }

  // the rows' lse, D and dropout hashes
  float lse_r[2], dd[2];
  uint32_t drop_r[2] = {0u, 0u};
  {
    const uint32_t drop_h = drop_head(drop_seed(a.seed), b * a.heads + h);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t gi = ((size_t)b * a.heads + h) * a.len + min(row[r], a.len - 1);
      lse_r[r] = a.lse[gi];
      dd[r] = a.delta[gi];
      if (a.threshold != 0u) drop_r[r] = drop_row(drop_h, row[r]);
    }
  }
  const bool live[2] = {row[0] < a.len, row[1] < a.len};

  float dq[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) dq[e] = 0.f;
  float d_sum[2] = {0.f, 0.f};  // this lane's share of D' = rowsum(P z dP)
  const uint64_t qd = wgmma_desc(qs_t, kDescKMajor), od = wgmma_desc(do_t, kDescKMajor);
  if (mask != 0u) mbar_wait(bars, 0);

  int tile = next_tile(mask, 0);
  for (int it = 0; tile >= 0; ++it) {
    const int stage = it % kDqStages;
    unsigned char* k_t = ring + stage * kDqStageBytes;
    unsigned char* v_t = k_t + kDqStageBytes / 2;
    mbar_wait(bars + 1 + stage, (it / kDqStages) & 1);

#pragma unroll 1
    for (int c0 = 0; c0 < kDqKeys; c0 += kSub) {
      const int j0 = tile * kDqKeys + c0;
      const uint32_t word = key_bits[j0 >> 5];
      if (word == 0u) continue;  // the same in every warp
      // S = (scale Q) K^T and dP = dO V^T for the chunk's kSub keys; P in
      // place of S while dP is in flight
      float s[16], dp[16];
      dot_pair_wgmma(s, dp, qd, wgmma_desc(k_t + c0 * kRowBytes, kDescKMajor), od,
                     wgmma_desc(v_t + c0 * kRowBytes, kDescKMajor), [&](float (&p)[16]) {
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n) {
          const uint32_t bits = word >> (n * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool ok = live[r] && ((bits >> (e & 1)) & 1u);
            p[4 * n + e] = ok ? exp2_fast((p[4 * n + e] - lse_r[r]) * kLog2e) : 0.f;
          }
        }
      });

      // dS in place of P
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = s[4 * n + e];
          const float z =
              a.threshold != 0u
                  ? drop_scale(drop_r[r], j0 + 8 * n + 2 * t + (e & 1), a.threshold, a.keep_scale)
                  : 1.f;
          d_sum[r] += p * (z * dp[4 * n + e]);
          s[4 * n + e] = p * (z * dp[4 * n + e] - dd[r]);
        }
      }

      // dq += dS K: dS from registers, a k16 step per 16 keys, K read
      // transposed (MN-major); dq accumulates across every chunk
      uint32_t da[kSub / 16][4];
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) acc_to_a(da[kk], s, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        wgmma_n32_rs(dq, da[kk], wgmma_desc(k_t + (c0 + 16 * kk) * kRowBytes, kDescMNMajor));
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(dq);
    }

    __syncthreads();  // every warp is done with this stage: refill it
    if (threadIdx.x == 0 && ahead >= 0) {
      fence_proxy_async();
      copy_kv_tile(maps, k_t, bars + 1 + stage, h, ahead, b);
      ahead = next_tile(mask, ahead + 1);
    }
    tile = next_tile(mask, tile + 1);
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
      const int e = 4 * n + 2 * r;
      *reinterpret_cast<float2*>(o + 8 * n) = make_float2(dq[e] * a.scale, dq[e + 1] * a.scale);
    }
  }
}

// F = the product form (attn_common.cuh), as in the dq kernel
template <int F>
__global__ void __launch_bounds__(kWarps * 32, F == kFormBF16 ? kBlocksBF16 : 3)
flash_bwd_dkdv_kernel(const Operands a, const __grid_constant__ TileMaps maps) {
  extern __shared__ float4 smem4[];
  if constexpr (F == kFormBF16) {  // its own body, on wgmma (above)
    dkdv_bf16(a, maps, reinterpret_cast<unsigned char*>(smem4));
  } else {
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
}

template <int F>
__global__ void __launch_bounds__(kWarps * 32, F == kFormBF16 ? kBlocksBF16 : 3)
flash_bwd_dq_kernel(const Operands a, const __grid_constant__ TileMaps maps) {
  extern __shared__ float4 smem4[];
  __shared__ uint32_t key_bits[kMaskWords];
  __shared__ unsigned tile_mask;
  if constexpr (F == kFormBF16) {  // its own body, on wgmma (above)
    dq_bf16(a, maps, reinterpret_cast<unsigned char*>(smem4), key_bits, &tile_mask);
  } else {
    float* stages = reinterpret_cast<float*>(smem4);
    constexpr int kStageFloats = 2 * kDqKeys * kKStride;

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
}

// shared memory a block: the bf16 bodies' tiles start on a 1024-byte
// boundary that they find themselves (the first 1024 bytes are slack), the
// mbarriers after the tiles
template <int F>
constexpr int kDkdvSmem = F == kFormBF16
                              ? 1024 + 2 * kTileBytes + kKvStages * kKvStageBytes +
                                    8 * (1 + kKvStages)
                              : (int)sizeof(float) * 2 * kQStageFloats;
template <int F>
constexpr int kDqSmem = F == kFormBF16
                            ? 1024 + 2 * kTileBytes + kDqStages * kDqStageBytes +
                                  8 * (1 + kDqStages)
                            : (int)sizeof(float) * 2 * 2 * kDqKeys * kKStride;

// the dq kernel, then the dk/dv kernel, which reads the D' the dq kernel
// leaves in a.delta (`maps` read by the bf16 instances only)
template <int F>
cudaError_t launch_products(const Operands& a, const TileMaps& maps, int batch,
                            cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem<F>);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<F>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<F><<<dim3((a.len + kDqRows - 1) / kDqRows, a.heads, batch), kWarps * 32,
                           kDqSmem<F>, s>>>(a, maps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem<F>);
  if (err != cudaSuccess) return err;
  if constexpr (F == kFormBF16) {  // kBlocksBF16 blocks of 48 KB an SM
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<F>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dkdv_kernel<F><<<dim3((a.len + kKvKeys - 1) / kKvKeys, a.heads, batch),
                             kWarps * 32, kDkdvSmem<F>, s>>>(a, maps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the pre-pass, the dq kernel and the dk/dv kernel on `stream` and
// returns cudaGetLastError() (0 = launched), or kTensorMapError plus the
// CUresult of a TMA map that did not encode. q, k, v, out, d_out, dq, dk, dv
// (B, L, H*Dh); key_valid (B, L); lse and delta (B, H, L), delta scratch
// (the pre-pass writes D there, the dq kernel D'); at the bf16 form the
// pre-pass's bf16 copies of scale q, q, k, v and dO (B, L, H*Dh), scratch
// the caller allocates (null at the other forms), and stage_kv: 1 = the
// pre-pass writes the k and v copies too, 0 = they hold the training
// forward's copies of the same k and v already (flash_attention.cu
// flashvtg_flash_attention_stage_bf16); threshold = floor(p *
// 2^24) (0 = no dropout), keep_scale = 1 / (1 - p), seed the forward's (device
// memory; null without dropout);
// form the products' form, 0 3xTF32, 1 1xTF32, 2 bf16 (attn_common.cuh),
// any other value refused. f32, contiguous and 16-byte aligned;
// 1 <= L <= 4096, Dh = 32.
int flashvtg_flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                                     const float* key_valid, const float* out,
                                     const float* lse, const float* d_out, float* delta,
                                     float* dq, float* dk, float* dv, uint16_t* qs_bf16,
                                     uint16_t* q_bf16, uint16_t* k_bf16, uint16_t* v_bf16,
                                     uint16_t* d_out_bf16, int stage_kv, int batch, int len,
                                     int heads, int head_dim, float scale,
                                     const unsigned* seed, unsigned threshold,
                                     float keep_scale, int form, void* stream) {
  const StagedBF16 st = {qs_bf16, q_bf16, k_bf16, v_bf16, d_out_bf16};
  if (head_dim != kDh || len < 1 || len > kMaxLen || batch < 1 || batch > 65535 ||
      heads < 1 || heads > 65535 || form < kForm3xTF32 || form > kFormBF16 ||
      (threshold != 0u && seed == nullptr) ||
      (form == kFormBF16 && (!st.qs || !st.q || !st.k || !st.v || !st.d_out))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = batch * len;
  const Operands a = {q, k, v, key_valid, lse, d_out, delta, dq, dk, dv,
                      len, heads, scale, seed, threshold, keep_scale};
  if (form == kFormBF16) {
    // the pre-pass first: a runtime launch makes the device's primary
    // context current on this thread (autograd's device thread may have
    // none yet), which cuTensorMapEncodeTiled below needs
    if (stage_kv) {
      flash_bwd_stage_kernel<true><<<(rows + 7) / 8, 256, 0, s>>>(a, out, st, rows);
    } else {
      flash_bwd_stage_kernel<false><<<(rows + 7) / 8, 256, 0, s>>>(a, out, st, rows);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    TileMaps maps;
    const uint16_t* src[5] = {st.qs, st.q, st.k, st.v, st.d_out};
    CUtensorMap* dst[5] = {&maps.qs, &maps.q, &maps.k, &maps.v, &maps.d_out};
    for (int i = 0; i < 5; ++i) {
      const CUresult r = encode_rows(encode, dst[i], src[i], batch, len, heads);
      if (r != CUDA_SUCCESS) return kTensorMapError + (int)r;
    }
    return (int)launch_products<kFormBF16>(a, maps, batch, s);
  }
  flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, s>>>(out, d_out, delta, rows, len, heads);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const TileMaps none{};
  return (int)(form == kForm1xTF32 ? launch_products<kForm1xTF32>(a, none, batch, s)
                                   : launch_products<kForm3xTF32>(a, none, batch, s));
}

}  // extern "C"
