// The counter-based random stream shared by the kernels of this directory.
//
// The device side of ../counter_rng.py, and of the JAX kernel's `_uniform_sw`
// (mh_tpu/kernels/fused_mh.py:357-402) with the `draw_block` base
// (:1403-1408): every value is a pure function of (seed, counter, flat
// index), so any thread can draw any value and a kernel's draws equal the
// plain PyTorch version's bit for bit.

#pragma once

#include <cstdint>

// triple32-style mixing on uint32 (wrapping multiplies, logical shifts)
static __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 17;
  x *= 0xED5AD4BBu;
  x ^= x >> 11;
  x *= 0xAC4C1B51u;
  x ^= x >> 15;
  x *= 0x31848BABu;
  x ^= x >> 14;
  return x;
}

// 23 random bits: mix(mix(flat ^ base)) >> 9, base = seed * 0x9E3779B9 ^ counter * 0x85EBCA6B
static __device__ __forceinline__ uint32_t counter_bits(uint32_t seed, uint32_t counter,
                                                        uint32_t flat) {
  const uint32_t base = (seed * 0x9E3779B9u) ^ (counter * 0x85EBCA6Bu);
  return mix32(mix32(flat ^ base)) >> 9;
}

// The fused kernel's uniform in (0, 1) for (seed, global chain, draw counter, lane)
static __device__ __forceinline__ float mh_uniform(uint32_t seed, uint32_t chain,
                                                   uint32_t counter, uint32_t lane) {
  const uint32_t bits = counter_bits(seed, counter, chain * 128u + lane);
  return static_cast<float>(bits) * 1.1920928955078125e-07f + 1e-7f;  // 2^-23
}
