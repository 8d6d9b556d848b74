// Counter-based sampling RNG, device copy of wavenet_tpu_torch/ops/rng.py
// (and of the JAX package's ops/rng.py): a murmur3 finalizer over uint32,
// keyed by (per-row seed, global decode step, class).  The integer bits
// must equal the plain version's exactly; all arithmetic is unsigned, so
// every right shift is logical.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t wn_mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// uint32 hash of (seed, step t, class q).
__device__ __forceinline__ uint32_t wn_counter_bits(int32_t seed, int32_t t,
                                                    int32_t q) {
  const uint32_t cls = (uint32_t)q;
  const uint32_t h = (uint32_t)seed * 0x9E3779B9u
                   + (uint32_t)t * 0x7F4A7C15u + cls;
  return wn_mix(wn_mix(h) + cls);
}

// Uniform f32 in (0, 1): (bits >> 8) * 2^-24 + 1e-12, each op rounded in
// f32 as the reference does (the product is exact: a power-of-two scale).
__device__ __forceinline__ float wn_counter_uniform(int32_t seed, int32_t t,
                                                    int32_t q) {
  const uint32_t bits = wn_counter_bits(seed, t, q);
  return __fadd_rn(__fmul_rn((float)(bits >> 8), 1.0f / 16777216.0f),
                   1e-12f);
}

// Gumbel(0, 1) noise for Gumbel-max sampling: -log(-log(u)), IEEE logf.
__device__ __forceinline__ float wn_counter_gumbel(int32_t seed, int32_t t,
                                                   int32_t q) {
  return -logf(-logf(wn_counter_uniform(seed, t, q)));
}
