// Dropout with flax's keep masks, drawn on the card from a threefry key.
//
// Replaces no pallas_call: the JAX package trains the transformer family
// with flax's two dropouts, which XLA fuses with jax.random.bernoulli's
// threefry bits:
//  - flax.linen.Dropout (flax/linen/stochastic.py:98-107, the FFN dropout of
//    learnablepoolingmethods_tpu/models/attention.py:49): keep =
//    bernoulli(key, keep_prob, x.shape), y = select(keep, x / keep_prob, 0)
//    with the division in x's dtype (mode 0);
//  - the attention-weight dropout of flax.linen.attention
//    .dot_product_attention_weights (flax/linen/attention.py:151-161): keep
//    = bernoulli(key, keep_prob, [1, 1, F, F]) broadcast over batch and
//    heads, y = w · (keep.astype(dtype) / keep_prob), the multiplier formed
//    in w's dtype (mode 1).
// keep[m] = U(key, m) < keep_prob, U the draw of threefry.cuh, so the mask is
// bit for bit jax.random.bernoulli's (mode "low").  Both rules are linear in
// x with the same mask, so the backward is the same launch on the cotangent.
//
// y[r·P + m] = op(x[r·P + m], keep[m]) for every row r < rows and mask index
// m < P: P = the mask's size (x's size for mode 0, F·F for the attention
// weights [B, H, F, F], rows = B·H).  keep[m] hashes index offset + m: a rank
// of a mesh that holds rows R … of the global batch passes R·(the mask's
// size a row), so its mask is its share of the global mask, bit for bit.
//
// What bounds it: the bytes, read x once and write y once (2 × 157 MB for
// the FFN output of config 5 at B=256, F=300, D=1024 in bf16, about 0.094
// ms at 3.35 TB/s), and, close behind, the hash: about 90 integer
// operations per mask element (20 rounds of add, rotate and xor, five key
// injections), 7 G operations for that tensor, 0.10 ms at the 67 T/s of the
// card's CUDA cores.
//
// Design: the mask is regenerated from the key's two words in the backward,
// not stored: storing it would write n bytes in the forward and read them
// in the backward (a quarter more traffic for bf16) and hold them in memory
// from the forward to the backward.  Each thread hashes kVec consecutive
// mask indices once and walks the rows r = blockIdx.y, blockIdx.y +
// gridDim.y, ...: the attention's [F, F] mask is hashed gridDim.y times, not
// B·H times, and the FFN's (one row) once.  With P % kVec == 0 and aligned
// pointers a thread moves its kVec elements as one 8-byte (bf16) or 16-byte
// (f32) access.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace lpm {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kTargetBlocks = 132 * 8;  // eight blocks an SM of the H100

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// mode 0: select(keep, x / scale, 0); mode 1: x · (keep ? scale : 0).  In
// f32, correctly rounded, as PyTorch and XLA compute a bf16 op and round it.
__device__ __forceinline__ float drop(float x, bool keep, float scale, int mode) {
  if (mode == 0) return keep ? __fdiv_rn(x, scale) : 0.0f;
  return __fmul_rn(x, keep ? scale : 0.0f);
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long rows, long long period,
               uint32_t k0, uint32_t k1, float keep_prob, float scale, int mode, long long offset) {
  const long long m0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (m0 >= period) return;
  bool keep[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    keep[j] = m0 + j < period && threefry_uniform(k0, k1, offset + m0 + j) < keep_prob;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long base = r * period + m0;
    if (kAligned) {
      if (sizeof(T) == 4) {
        float4 v = *reinterpret_cast<const float4*>(x + base);
        v.x = drop(v.x, keep[0], scale, mode);
        v.y = drop(v.y, keep[1], scale, mode);
        v.z = drop(v.z, keep[2], scale, mode);
        v.w = drop(v.w, keep[3], scale, mode);
        *reinterpret_cast<float4*>(y + base) = v;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(x + base);
        const uint32_t w[2] = {v.x, v.y};
        uint32_t out[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float lo = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[h] & 0xffffu)));
          const float hi = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[h] >> 16)));
          const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(drop(lo, keep[2 * h], scale, mode)));
          const uint32_t b =
              __bfloat16_as_ushort(__float2bfloat16_rn(drop(hi, keep[2 * h + 1], scale, mode)));
          out[h] = a | (b << 16);
        }
        *reinterpret_cast<uint2*>(y + base) = make_uint2(out[0], out[1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (m0 + j < period) y[base + j] = from_f32<T>(drop(to_f32(x[base + j]), keep[j], scale, mode));
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long rows, long long period, uint32_t k0, uint32_t k1,
           float keep_prob, float scale, int mode, long long offset, cudaStream_t s) {
  const long long per_block = (long long)kThreads * kVec;
  const long long gx = (period + per_block - 1) / per_block;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  long long gy = (kTargetBlocks + gx - 1) / gx;
  gy = gy < rows ? gy : rows;
  gy = gy < 65535 ? gy : 65535;
  const dim3 grid((unsigned int)gx, (unsigned int)(gy > 0 ? gy : 1));
  const bool aligned = period % kVec == 0 && (uintptr_t)x % (kVec * sizeof(T)) == 0 &&
                       (uintptr_t)y % (kVec * sizeof(T)) == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (aligned)
    dropout_kernel<T, true><<<grid, kThreads, 0, s>>>(xt, yt, rows, period, k0, k1, keep_prob,
                                                      scale, mode, offset);
  else
    dropout_kernel<T, false><<<grid, kThreads, 0, s>>>(xt, yt, rows, period, k0, k1, keep_prob,
                                                       scale, mode, offset);
  return (int)cudaGetLastError();
}

}  // namespace lpm

using namespace lpm;

extern "C" {

// x, y: rows·period elements, f32 (bf16 = 0) or bf16 (bf16 = 1), contiguous;
// (k0, k1): the key's words; keep_prob: f32(1 − rate); scale: keep_prob in
// x's dtype (mode 0) or 1 / that in x's dtype (mode 1), widened to f32.
int lpm_dropout(const void* x, void* y, long long rows, long long period, unsigned int k0,
                unsigned int k1, float keep_prob, float scale, int mode, int bf16, long long offset,
                void* stream) {
  if (rows <= 0 || period <= 0) return 0;
  if (offset < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, y, rows, period, k0, k1, keep_prob, scale, mode, offset, s);
  return launch<float>(x, y, rows, period, k0, k1, keep_prob, scale, mode, offset, s);
}

}  // extern "C"
