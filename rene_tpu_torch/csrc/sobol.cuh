// The Sobol sampler's per-lane math (K-sobol): the padded, Owen-scrambled
// (0,2)-sequence draws of the path kernels under `Sampler "sobol"`.
// Mirrors rene_tpu_torch/ops/sobol.py, which mirrors rene_tpu/ops/sobol.py
// and the megakernel's `ld2` / `sob_pixkey`
// (rene_tpu/integrators/pallas_path.py:1697-1720). Integer XOR, AND,
// shifts and 32-bit multiply-adds, and the mantissa bitcast; the bit
// reversal is one `__brev` on the card and the shift-mask ladder under a
// host compiler (the CPU tests build these headers with g++). A draw pair
// costs ~100 integer operations and no memory access.
#pragma once
#include <stdint.h>

// the draw slots of a bounce (pallas_path.py:1700-1701)
#define SLOT_CAM 0u
#define SLOT_BSDF 1u
#define SLOT_COIN 2u
#define SLOT_NEE1 3u
#define SLOT_NEE2 4u
#define SLOT_RR 5u
#define SLOT_MISC 6u

__device__ __forceinline__ uint32_t reverse32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __brev(x);
#else
  x = ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
  x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
  x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
  return (x << 16) | (x >> 16);
#endif
}

// finalizer-style hash (xxhash/murmur avalanche constants)
__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// Laine-Karras style hash: a per-seed permutation of the low bits
__device__ __forceinline__ uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

__device__ __forceinline__ uint32_t owen_scramble(uint32_t v, uint32_t seed) {
  return reverse32(laine_karras(reverse32(v), seed));
}

// dimension 2 of Sobol for an index < 2^16, a 32-bit fraction: the
// direction numbers of x+1, MSB-aligned, are d_0 = 2^31 and
// d_b = d_{b-1} ^ (d_{b-1} >> 1)
__device__ __forceinline__ uint32_t sobol2_16(uint32_t idx) {
  uint32_t y = 0u, d = 0x80000000u;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if ((idx >> b) & 1u) y ^= d;
    d ^= d >> 1;
  }
  return y;
}

// the Owen-scrambled (0,2) point of sample `idx` (< 2^16) under `key`, as
// two 32-bit fractions (ops/sobol.py ld2_bits)
__device__ __forceinline__ void ld2_bits(uint32_t idx, uint32_t key,
                                         uint32_t& u, uint32_t& v) {
  const uint32_t sidx =
      reverse32(laine_karras(reverse32(idx), hash_u32(key ^ 0x9E3779B9u)))
      & 0xFFFFu;
  u = owen_scramble(reverse32(sidx), hash_u32(key));
  v = owen_scramble(sobol2_16(sidx), hash_u32(key ^ 0x6A09E667u));
}

__device__ __forceinline__ float sobol_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// a pixel's scrambling key from its index px + py * W and the seed
__device__ __forceinline__ uint32_t sob_pixkey(uint32_t pid, uint32_t seed) {
  return hash_u32(pid ^ (seed * 0x85EBCA6Bu));
}

// the draw pair of decision (depth, slot) of sample `idx` of the pixel
// keyed by `pixkey`
__device__ __forceinline__ void ld2(uint32_t idx, uint32_t pixkey,
                                    uint32_t depth, uint32_t slot, float& u,
                                    float& v) {
  uint32_t ub, vb;
  ld2_bits(idx & 0xFFFFu,
           pixkey ^ (depth * 0x9E3779B9u) ^ (slot * 0x632BE59Bu), ub, vb);
  u = sobol_unit(ub);
  v = sobol_unit(vb);
}

// where a bounce's Sobol pairs are drawn: the lane's sample index, its
// pixel key and the path depth
struct SobolAt {
  uint32_t idx, key, depth;
};

__device__ __forceinline__ void ld2(const SobolAt& a, uint32_t slot, float& u,
                                    float& v) {
  ld2(a.idx, a.key, a.depth, slot, u, v);
}
