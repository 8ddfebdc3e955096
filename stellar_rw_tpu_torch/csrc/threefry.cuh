// jax.random's threefry-2x32 streams as __device__ code, shared by the walk
// kernels (walk.cu, resident_walk.cu, cdf_walk.cu) and the trainer's draws
// (trainer_draws.cu). Bit for bit the host version in ops/prng.py.

#pragma once

#include <cstdint>

namespace srw {

__device__ __forceinline__ uint32_t rotl(uint32_t v, int d) {
  return (v << d) | (v >> (32 - d));
}

// One threefry-2x32 block (20 rounds), the schedule of XLA's threefry2x32.
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t c0, uint32_t c1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#define SRW_MIX(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
  SRW_MIX(13) SRW_MIX(15) SRW_MIX(26) SRW_MIX(6)
  x0 += k1; x1 += ks2 + 1u;
  SRW_MIX(17) SRW_MIX(29) SRW_MIX(16) SRW_MIX(24)
  x0 += ks2; x1 += k0 + 2u;
  SRW_MIX(13) SRW_MIX(15) SRW_MIX(26) SRW_MIX(6)
  x0 += k0; x1 += k1 + 3u;
  SRW_MIX(17) SRW_MIX(29) SRW_MIX(16) SRW_MIX(24)
  x0 += k1; x1 += ks2 + 4u;
  SRW_MIX(13) SRW_MIX(15) SRW_MIX(26) SRW_MIX(6)
  x0 += ks2; x1 += k0 + 5u;
#undef SRW_MIX
  return make_uint2(x0, x1);
}

// Element idx of jax.random.uniform(key, shape, float32).
__device__ __forceinline__ float uniform_at(uint2 key, uint32_t idx) {
  const uint2 o = threefry(key.x, key.y, 0u, idx);
  return __uint_as_float(((o.x ^ o.y) >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace srw
