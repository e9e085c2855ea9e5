// Memory-linear masked self-attention over any number of keys, for Hopper
// (sm_90a): the products on the tensor cores in 3xTF32 (f32-accurate),
// 1xTF32 (both on mma.sync.m16n8k8) or bf16 (on Hopper's warpgroup product
// wgmma), as the precision dial asks.
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
// The bf16 form has a body of its own (flash_bf16 below), on Hopper's
// warpgroup product wgmma from bf16 K and V tiles that TMA copies
// (attn_common.cuh, last section):
//  * a pre-pass (flash_fwd_stage_kernel, launched by the same entry just
//    before the kernel) rounds k and v to bf16 once, into (B, L, H * 32)
//    copies that the wrapper allocates; the training form hands them to the
//    backward, whose pre-pass then rounds only scale q, q and dO. On
//    mma.sync every 64-row block rounded its head's whole K and V itself,
//    through registers (32 blocks a head at L 2048);
//  * a block is one warpgroup: 64 query rows, the M of wgmma.m64nNk16. The
//    128-key K and V tiles that hold a valid key come through a ring of
//    kStagesBF16 TMA stages (64-byte swizzle, one mbarrier a stage), the
//    copies issued by one thread; a tile with no valid key is never copied;
//  * S = (scale Q) K^T for 64 keys (two mask words) at a time is wgmma with
//    bf16(scale q) in registers as A and K's tile as the K-major B, each
//    k16 step in a fresh accumulator added on the CUDA cores: the sums of
//    attn_common.cuh dot_bf16, which the backward's kernels take S by, so
//    at a row's only key lse = m = s exactly and the backward's P is
//    exactly 1 there;
//  * O += P V is wgmma with P from registers (acc_to_a) and V's tile as the
//    MN-major B; O stays in the wgmma accumulators across the whole loop,
//    rescaled by alpha between products (truncating f32 accumulation, as
//    the backward's dq, dk and dv: far inside the bf16 form's band), so a
//    chunk takes no adds on the CUDA cores;
//  * the products are asynchronous: a chunk's P V runs while the next
//    chunk's S is issued, and one wait ends both (kStagesBF16, kChunkBF16
//    below: two stages, 64-key chunks read fastest on the card). Issuing the
//    next chunk's S before this chunk's softmax, to overlap the two, read
//    slower at every shape (PERF.md §6): it holds two more S
//    accumulators, which cost a block an SM at 64-key chunks, and the other
//    blocks' warps already fill the tensor cores' gaps;
//  * a chunk whose keys are all valid skips the mask's bit tests.
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
constexpr int kMinBlocksBF16 = 4;       // the same, for the bf16 form's body
constexpr int kTileRows = 16 * kWarps;  // query rows per block
constexpr int kTileKeys = 128;          // keys per staged tile (one bit of the tile mask)
constexpr int kChunk = 64;              // keys per S fragment set, 32 or 64
static_assert(kChunk == 32 || kChunk == 64, "a chunk is one or two mask words");
constexpr int kChunkTiles = kChunk / 8;
constexpr int kMaxLen = kTileKeys * (kMaskWords / 4);

constexpr int kStageFloats = 2 * kTileKeys * kKStride;  // K, V

// ---- the bf16 form on Hopper's warpgroup products (attn_common.cuh) ---------
//
// The same kernel on wgmma, one warpgroup (the four warps) a block, from the
// pre-pass's bf16 K and V that TMA copies (the design: this file's header).
// The accumulator's layout is the m16n8 C layout (a warp's 16 rows, n-tiles
// of 8 keys), so the mask bits, the online softmax, the dropout index and
// the lse write are the f32 forms', on s[4 n + e] for their s[n][e].

constexpr int kStagesBF16 = 2;  // 128-key K and V tiles in flight (the TMA ring)
constexpr int kChunkBF16 = 64;  // keys a chunk: the N of S's products, two mask words
static_assert(kChunkBF16 == 64, "S is m64n64k16 (attn_common.cuh wgmma_n64_rs_k)");
constexpr int kSAcc = kChunkBF16 / 2;  // S's accumulator registers a thread
constexpr int kKvBoxes = kTileKeys / kBoxRows;               // TMA boxes a tile, each tensor
constexpr int kKvStageBytes = 2 * kKvBoxes * kTileBytes;     // K, then V: 16 KB
// shared memory a bf16 block: the ring on a 1024-byte boundary that the
// block finds itself (the first 1024 bytes are slack), the mbarriers after it
constexpr int kSmemBF16 = 1024 + kStagesBF16 * kKvStageBytes + 8 * kStagesBF16;

// the TMA maps of the pre-pass's bf16 k and v (attn_common.cuh encode_rows)
struct KvMaps {
  CUtensorMap k, v;
};

// The pre-pass of the bf16 form: k and v rounded to bf16 once, into the
// (B, L, H * 32) copies that the TMA maps read, by st_bf16x8 as the
// backward's pre-pass rounds them (a thread eight values of each)
__global__ void __launch_bounds__(256)
flash_fwd_stage_kernel(const float* __restrict__ k, const float* __restrict__ v,
                       uint16_t* __restrict__ k_bf16, uint16_t* __restrict__ v_bf16,
                       size_t n8) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const size_t g = 8 * i;
  st_bf16x8(k_bf16 + g, ld4(k + g), ld4(k + g + 4), 1.f);
  st_bf16x8(v_bf16 + g, ld4(v + g), ld4(v + g + 4), 1.f);
}

// TMA copies of the 128-key tile `tile` of head h into a stage: K's boxes,
// then V's
__device__ __forceinline__ void copy_kv(const KvMaps& m, unsigned char* stage, uint64_t* bar,
                                        int h, int tile, int b) {
  mbar_expect_tx(bar, kKvStageBytes);
#pragma unroll
  for (int i = 0; i < kKvBoxes; ++i) {
    const int r = tile * kTileKeys + i * kBoxRows;
    tma_load_3d(stage + i * kTileBytes, &m.k, h * kDh, r, b, bar);
    tma_load_3d(stage + (kKvBoxes + i) * kTileBytes, &m.v, h * kDh, r, b, bar);
  }
}

// whether the chunk of keys from j0 holds a valid key (its mask words)
__device__ __forceinline__ bool chunk_live(const uint32_t* key_bits, int j0) {
  uint32_t any = 0u;
#pragma unroll
  for (int w = 0; w < kChunkBF16 / 32; ++w) any |= key_bits[(j0 >> 5) + w];
  return any != 0u;
}

// Moves the chunk cursor (tile, its place `it` in the walk of tiles that
// hold a valid key, first key c0 in the tile) to the first chunk at or after
// it with a valid key; tile -1 past the last. Every tile of the walk has one.
__device__ __forceinline__ void seek_chunk(const uint32_t* key_bits, unsigned mask, int& tile,
                                           int& it, int& c0) {
  while (tile >= 0) {
    for (; c0 < kTileKeys; c0 += kChunkBF16) {
      if (chunk_live(key_bits, tile * kTileKeys + c0)) return;
    }
    tile = next_tile(mask, tile + 1);
    ++it;
    c0 = 0;
  }
}

// S = (scale Q) K^T for the chunk of keys at k_t: each k16 step in a
// fresh accumulator, sa and sb, added on the CUDA cores once both are done
// (attn_common.cuh dot_bf16's sums, the backward's S); one commit group
__device__ __forceinline__ void issue_s(float (&sa)[kSAcc], float (&sb)[kSAcc],
                                        const uint32_t (&qf)[kDh / 16][4],
                                        const unsigned char* k_t) {
  const uint64_t kd = wgmma_desc(k_t, kDescKMajor);
  wgmma_fence();
  wgmma_n64_rs_k(sa, qf[0], kd);
  wgmma_n64_rs_k(sb, qf[1], kd + 2);  // the second k16 step: 32 bytes on
  wgmma_commit();
}

template <bool TRAIN>
__device__ __forceinline__ void flash_bf16(const float* __restrict__ q,
                                           const float* __restrict__ key_valid,
                                           float* __restrict__ out, int len, int heads,
                                           float scale, float* __restrict__ lse,
                                           const uint32_t* __restrict__ seed,
                                           uint32_t threshold, float keep_scale,
                                           const KvMaps& maps, unsigned char* smem,
                                           uint32_t* key_bits, unsigned* tile_mask) {
  unsigned char* ring = align1024(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStagesBF16 * kKvStageBytes);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d_model = heads * kDh;
  const size_t head0 = (size_t)b * len * d_model + h * kDh;
  const bool drop = TRAIN && threshold != 0u;
  const int row0 = (int)blockIdx.x * kTileRows + warp * 16 + g;
  const int row[2] = {row0, row0 + 8};

  build_key_mask(key_bits, tile_mask, key_valid + (size_t)b * len, len);
  const unsigned mask = *tile_mask;
  if (threadIdx.x == 0 && mask != 0u) {
    for (int i = 0; i < kStagesBF16; ++i) mbar_init(full + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  int ahead = next_tile(mask, 0);  // the next tile to copy (thread 0's)
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStagesBF16 && ahead >= 0; ++i) {
      copy_kv(maps, ring + i * kKvStageBytes, full + i, h, ahead, b);
      ahead = next_tile(mask, ahead + 1);
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
  float o[16];  // O, the P V accumulator across the whole loop
#pragma unroll
  for (int e = 0; e < 16; ++e) o[e] = 0.f;
  uint32_t pa[kChunkBF16 / 16][4];  // P, the A operand of P V
  bool pv = false;  // a P V product in flight
  int pv_it = 0;    // the tile (its place in the walk) that it reads

  int tile = next_tile(mask, 0), it = 0, c0 = 0;
  seek_chunk(key_bits, mask, tile, it, c0);
  while (tile >= 0) {
    const int stage = it % kStagesBF16;
    const unsigned char* k_t = ring + stage * kKvStageBytes;
    const unsigned char* v_t = k_t + kKvStageBytes / 2;

    // S for the chunk's keys; its wait also ends the last chunk's P V, which
    // ran while this S was issued
    if (!pv || it != pv_it) mbar_wait(full + stage, (it / kStagesBF16) & 1);
    float sa[kSAcc], sb[kSAcc];
    issue_s(sa, sb, qf, k_t + c0 * kRowBytes);
    wgmma_wait<0>();
    wgmma_hold(sa);
    wgmma_hold(sb);
    if (pv) {
      wgmma_hold(o);
      wgmma_hold_a(pa);
      if (it != pv_it) {
        __syncthreads();  // every warp is done with the last tile: refill its stage
        if (threadIdx.x == 0 && ahead >= 0) {
          fence_proxy_async();
          const int done = pv_it % kStagesBF16;
          copy_kv(maps, ring + done * kKvStageBytes, full + done, h, ahead, b);
          ahead = next_tile(mask, ahead + 1);
        }
      }
    }
    float s[kSAcc];
#pragma unroll
    for (int e = 0; e < kSAcc; ++e) s[e] = sa[e] + sb[e];

    // masked keys to -inf (a chunk of valid keys alone, the common one,
    // skips the bit tests), then the chunk's row max across the quad
    const int j0 = tile * kTileKeys + c0;
    uint32_t words[kChunkBF16 / 32], all = 0xffffffffu;
#pragma unroll
    for (int w = 0; w < kChunkBF16 / 32; ++w) all &= words[w] = key_bits[(j0 >> 5) + w];
    float mx[2] = {-INFINITY, -INFINITY};
    if (all != 0xffffffffu) {  // the same in every warp
#pragma unroll
      for (int n = 0; n < kChunkBF16 / 8; ++n) {
        const uint32_t bits = words[n >> 2] >> ((n & 3) * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!((bits >> (e & 1)) & 1u)) s[4 * n + e] = -INFINITY;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kSAcc; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2_fast((m[r] - m_use[r]) * kLog2e);
      m[r] = m_new;
      l[r] *= alpha[r];
    }

    // P (0 at masked keys), the row sums, and the probabilities P V reads
#pragma unroll
    for (int n = 0; n < kChunkBF16 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = exp2_fast((s[4 * n + e] - m_use[r]) * kLog2e);
        l[r] += p;
        s[4 * n + e] = drop ? p * drop_scale(drop_r[r], j0 + 8 * n + 2 * t + (e & 1),
                                             threshold, keep_scale)
                            : p;
      }
    }

#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }

    // O += P V: P from registers, a k16 step per 16 keys, V's tile read
    // transposed (MN-major); in flight into the next chunk's S
#pragma unroll
    for (int kk = 0; kk < kChunkBF16 / 16; ++kk) acc_to_a(pa[kk], s, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunkBF16 / 16; ++kk) {
      wgmma_n32_rs(o, pa[kk], wgmma_desc(v_t + (c0 + 16 * kk) * kRowBytes, kDescMNMajor));
    }
    wgmma_commit();
    pv = true;
    pv_it = it;
    c0 += kChunkBF16;
    seek_chunk(key_bits, mask, tile, it, c0);
  }
  if (pv) {  // the last P V
    wgmma_wait<0>();
    wgmma_hold(o);
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
          make_float2(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
    if (TRAIN && t == 0) lse[((size_t)b * heads + h) * len + row[r]] = m[r] + logf(l[r]);
  }
}

template <int F>
constexpr int kSmemBytes = F == kFormBF16 ? kSmemBF16 : (int)sizeof(float) * 2 * kStageFloats;

// F = the product form (attn_common.cuh); TRAIN = the training form; `maps`
// read by the bf16 instances only
template <int F, bool TRAIN>
__global__ void __launch_bounds__(kWarps * 32, F == kFormBF16 ? kMinBlocksBF16 : kMinBlocks)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ key_valid,
                       float* __restrict__ out, int len, int heads,
                       float scale, float* __restrict__ lse,
                       const uint32_t* __restrict__ seed, uint32_t threshold,
                       float keep_scale, const __grid_constant__ KvMaps maps) {
  extern __shared__ float4 smem4[];
  __shared__ uint32_t key_bits[kMaskWords];
  __shared__ unsigned tile_mask;
  if constexpr (F == kFormBF16) {  // its own body, on wgmma (above)
    flash_bf16<TRAIN>(q, key_valid, out, len, heads, scale, lse, seed, threshold, keep_scale,
                      maps, reinterpret_cast<unsigned char*>(smem4), key_bits, &tile_mask);
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
                   int heads, float scale, float* lse, const uint32_t* seed,
                   uint32_t threshold, float keep_scale, const KvMaps& maps,
                   cudaStream_t stream) {
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
      q, k, v, key_valid, out, len, heads, scale, lse, seed, threshold, keep_scale, maps);
  return cudaGetLastError();
}

// the bf16 form's pre-pass over (batch, len, heads * 32) k and v
cudaError_t launch_stage(const float* k, const float* v, uint16_t* k_bf16, uint16_t* v_bf16,
                         int batch, int len, int heads, cudaStream_t stream) {
  const size_t n8 = (size_t)batch * len * heads * (kDh / 8);
  flash_fwd_stage_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, stream>>>(k, v, k_bf16,
                                                                          v_bf16, n8);
  return cudaGetLastError();
}

// the launch at `form`: returns a cudaError_t, or kTensorMapError plus the
// CUresult of a TMA map (bf16 form) that did not encode
template <bool TRAIN>
int launch_form(int form, const float* q, const float* k, const float* v,
                const float* key_valid, float* out, uint16_t* k_bf16, uint16_t* v_bf16,
                int batch, int len, int heads, int head_dim, float scale, float* lse,
                const uint32_t* seed, uint32_t threshold, float keep_scale,
                cudaStream_t stream) {
  if (head_dim != kDh || len < 1 || len > kMaxLen || batch < 1 ||
      batch > 65535 || heads < 1 || heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  KvMaps maps{};
  if (form == kFormBF16) {
    if (k_bf16 == nullptr || v_bf16 == nullptr) return (int)cudaErrorInvalidValue;
    // the pre-pass first: it writes the copies that the maps below read, and
    // its runtime launch makes the device's primary context current on this
    // thread (autograd's device thread may have none yet), which
    // cuTensorMapEncodeTiled needs
    const cudaError_t err = launch_stage(k, v, k_bf16, v_bf16, batch, len, heads, stream);
    if (err != cudaSuccess) return (int)err;
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    CUresult r = encode_rows(encode, &maps.k, k_bf16, batch, len, heads);
    if (r == CUDA_SUCCESS) r = encode_rows(encode, &maps.v, v_bf16, batch, len, heads);
    if (r != CUDA_SUCCESS) return kTensorMapError + (int)r;
  }
#define FLASH_FORM(F)                                                                       \
  (int)launch<F, TRAIN>(q, k, v, key_valid, out, batch, len, heads, scale, lse, seed,       \
                        threshold, keep_scale, maps, stream)
  switch (form) {
    case kForm3xTF32: return FLASH_FORM(kForm3xTF32);
    case kForm1xTF32: return FLASH_FORM(kForm1xTF32);
    case kFormBF16: return FLASH_FORM(kFormBF16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_FORM
}

}  // namespace

extern "C" {

// The bf16 form's pre-pass alone (the entries below launch it themselves
// at the bf16 form): k and v (B, L, H*Dh) f32 rounded to bf16 into k_bf16
// and v_bf16 (the same shape), as the backward takes them over
// (flash_attention_bwd.cu, stage_kv 0). All contiguous and 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int flashvtg_flash_attention_stage_bf16(const float* k, const float* v, uint16_t* k_bf16,
                                        uint16_t* v_bf16, int batch, int len, int heads,
                                        void* stream) {
  if (k == nullptr || v == nullptr || k_bf16 == nullptr || v_bf16 == nullptr || len < 1 ||
      len > kMaxLen || batch < 1 || batch > 65535 || heads < 1 || heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_stage(k, v, k_bf16, v_bf16, batch, len, heads, (cudaStream_t)stream);
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// kTensorMapError plus the CUresult of a TMA map that did not encode.
// q, k, v and out (B, L, H*Dh), key_valid (B, L); all f32, contiguous and
// 16-byte aligned; 1 <= L <= 4096, Dh = 32. form: the products' form, 0
// 3xTF32, 1 1xTF32, 2 bf16 (attn_common.cuh); any other value is refused.
// At the bf16 form k_bf16 and v_bf16 (B, L, H*Dh) are scratch the caller
// allocates: the pre-pass, launched first, writes bf16 copies of k and v
// there, which the kernel reads in their place (and the backward may take
// over); the other forms pass null.
int flashvtg_flash_attention_f32(const float* q, const float* k, const float* v,
                                 const float* key_valid, float* out, uint16_t* k_bf16,
                                 uint16_t* v_bf16, int batch, int len, int heads,
                                 int head_dim, float scale, int form, void* stream) {
  return launch_form<false>(form, q, k, v, key_valid, out, k_bf16, v_bf16, batch, len, heads,
                            head_dim, scale, nullptr, nullptr, 0u, 1.f, (cudaStream_t)stream);
}

// The training form: as above, plus lse (B, H, L) and attention dropout
// (seed a uint32 in device memory, read by the kernel; threshold =
// floor(p * 2^24), keep_scale = 1 / (1 - p); threshold 0 = none, and then
// seed may be null).
int flashvtg_flash_attention_train_f32(const float* q, const float* k, const float* v,
                                       const float* key_valid, float* out, float* lse,
                                       uint16_t* k_bf16, uint16_t* v_bf16,
                                       int batch, int len, int heads, int head_dim,
                                       float scale, const unsigned* seed, unsigned threshold,
                                       float keep_scale, int form, void* stream) {
  if (lse == nullptr || (threshold != 0u && seed == nullptr)) return (int)cudaErrorInvalidValue;
  return launch_form<true>(form, q, k, v, key_valid, out, k_bf16, v_bf16, batch, len, heads,
                           head_dim, scale, lse, seed, threshold, keep_scale,
                           (cudaStream_t)stream);
}

}  // extern "C"
