// Counter-based keep mask for attention dropout, evaluated in registers.
//
// keep(b, h, i, j) is a pure function of (seed, b * H + h, i, j): a 32-bit
// integer hash, no state and no memory traffic, so a kernel can recompute
// the mask of any probability in its backward pass instead of storing it.
// flashvtg_tpu_torch/ops/attn_dropout.py evaluates the same hash with torch
// integer ops; the two agree mask for mask.
//
//   mix32(x)   = x ^= x >> 16; x *= 0x7feb352d; x ^= x >> 15;
//                x *= 0x2c1b3c6d; x ^= x >> 16          (all mod 2^32)
//   head(s, bh) = mix32(s ^ mix32(bh))
//   row(hd, i)  = mix32(hd + i)
//   keep        = (mix32(row ^ (j * 0x27d4eb2d)) >> 8) >= threshold
//
// threshold = floor(p * 2^24), so a key survives with probability 1 - p up
// to 2^-24; a survivor is scaled by 1 / (1 - p), as nn.Dropout scales it.
// The seed lives in device memory (a uint32 the caller draws on the card)
// and is read once where a block starts its head: a captured CUDA graph
// then takes each replay's new seed.
// Both multipliers are odd and below 2^31, so the torch version's int64
// products never overflow.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t drop_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x2c1b3c6du;
  x ^= x >> 16;
  return x;
}

// the call's seed from device memory; null (no dropout) reads 0
__device__ __forceinline__ uint32_t drop_seed(const uint32_t* seed) {
  return seed != nullptr ? __ldg(seed) : 0u;
}

// the hash of one (batch row, head): computed once per head
__device__ __forceinline__ uint32_t drop_head(uint32_t seed, int bh) {
  return drop_mix32(seed ^ drop_mix32((uint32_t)bh));
}

// the hash of query row i of that head: computed once per row
__device__ __forceinline__ uint32_t drop_row(uint32_t head, int i) {
  return drop_mix32(head + (uint32_t)i);
}

// 1 / (1 - p) where key j of the row survives, else 0
__device__ __forceinline__ float drop_scale(uint32_t row, int j,
                                            uint32_t threshold, float keep_scale) {
  return (drop_mix32(row ^ ((uint32_t)j * 0x27d4eb2du)) >> 8) >= threshold ? keep_scale
                                                                           : 0.f;
}
