// Threefry-2x32 (20 rounds) and jax.random's uniform draw on the device, bit
// for bit those of utils/prng.py and of jax.random with
// jax_threefry_partitionable (the default since jax 0.5): element i of a
// draw hashes the counter (hi(i), lo(i)) under the key and XORs the two
// output words; U in [0, 1) takes the top 23 bits as the mantissa of a float
// in [1, 2), minus 1.  fused_frontend.cu draws its frames and dropout.cu its
// keep masks with it.

#pragma once

#include <stdint.h>

namespace lpm {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (jax._src.prng._threefry2x32_lowering).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                              uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

// jax.random.uniform(key, shape, float32).ravel()[i]: the hash of counter
// (hi(i), lo(i)), its two words XORed, as a float in [0, 1).
__device__ __forceinline__ float threefry_uniform(uint32_t k0, uint32_t k1, long long i) {
  const uint2 h = threefry2x32(k0, k1, (uint32_t)((unsigned long long)i >> 32), (uint32_t)i);
  return __uint_as_float(((h.x ^ h.y) >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace lpm
