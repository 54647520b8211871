// Dropout with flax's keep masks, drawn on the card from a threefry key, the
// mask kept as bits from the forward for the backward.
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
// bit for bit jax.random.bernoulli's (mode "low").  U = (h >> 9) · 2⁻²³ for
// the hash's xor h, so the test is h ≤ 512·⌈keep_prob · 2²³⌉ − 1, exactly.
//
// y[r·P + m] = op(x[r·P + m], keep[m]) for every row r < rows and mask index
// m < P: P = the mask's size (x's size for mode 0, F·F for the attention
// weights [B, H, F, F], rows = B·H).  keep[m] hashes index offset + m: a rank
// of a mesh that holds rows R … of the global batch passes R·(the mask's
// size a row), so its mask is its share of the global mask, bit for bit.
// Both rules are linear in x with the same mask, so the backward is the
// same rule on the cotangent.
//
// Two launches of one kernel:
//  - the forward (kHash) hashes the mask and writes it as bits, word w bit
//    b = keep[32·w + b] (ceil(P / 32) uint32, bits past P zero: 9.6 MB at
//    config 5's FFN output, 11 KB for the attention's [1, 1, 300, 300]),
//    which the wrapper allocates and the autograd function keeps from the
//    forward to the backward; --use_remat's recomputed forward hashes again;
//  - the backward (!kHash) reads the bits and applies the rule to the
//    cotangent, with no hash.
//
// What bounds them, at config 5's FFN output [76,800, 1024] bf16 (B=256,
// F=300): the backward by its bytes (2 B in, 2 B out, 1/8 B of mask an
// element: 0.097 ms at 3.35 TB/s); the forward by the hash, about 80 integer
// instructions a mask element (20 rounds of add, rotate and xor, five key
// injections, the two first adds, the draw's xor and compare, the bit),
// counted against the H100 data sheet's 128 integer instructions a clock an
// SM (64 on the ALU pipe, 64 more as IMAD forms on the FMA pipe) at 132 SMs
// × 1.98 GHz: 82 × 76.8 M / (128 × 132 × 1.98 G) = 0.19 ms (chip_smoke.py
// #dropout_bound); its bytes, 0.10 ms with the bits, are below.
//
// The hash keeps threefry.cuh's rounds: ptxas issues each round as IADD3 or
// IMAD.IADD (it moves some adds to the FMA pipe itself), a funnel-shift SHF
// and a LOP3; the bf16 forward's SASS holds about twice as many ALU-pipe
// integer instructions as FMA-pipe ones (chip_smoke.py's dropout line,
// sass_integer_pipes, from kernel_build.sass_opcodes).  A form that wrote
// every add as v·one + c and three rotations a hash as lo(x·2^r) +
// hi(x·2^r), with `one` and 2^r kernel parameters so that ptxas kept them
// as IMADs (about 38 FMA-pipe and 41 ALU-pipe instructions a mask element
// in its SASS), ran no faster on the card: the split that the data sheet
// allows did not show, so the shorter form stays (PERF.md).  What
// the forward gains is the integer draw (h ≤ keep_max, no float) and its
// loads in flight under the hash; the backward's gain is the hash it no
// longer runs.
//
// Design: a block takes a tile of 8,192 consecutive mask indices, 32 a
// thread (eight hashes in flight, one word of bits a thread), puts the
// tile's 256 words in shared memory (the forward from its hashes, the
// backward from the bits buffer) and then applies them to the tile's
// elements of the rows r = blockIdx.y, blockIdx.y + gridDim.y, ..., 16
// bytes a thread at a time when P and the pointers allow (kAligned), a
// row's four (bf16) or eight (f32) vectors a thread loaded at once, the
// first row's before the hash (so the loads' latency hides under it): the
// attention's [F, F] mask is hashed gridDim.y times, not B·H times, and the
// FFN's (one row) once.  The forward's blocks of blockIdx.y = 0 write the
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace lpm {

constexpr int kThreads = 256;
constexpr int kTile = 32 * kThreads;      // mask indices a block: one word a thread
constexpr int kIlp = 8;                   // hashes a thread keeps in flight
constexpr int kTargetBlocks = 132 * 8;    // eight blocks an SM of the H100

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

// threefry2x32's two words' xor for counter (hi, lo) (threefry.cuh's
// rounds and injections; ptxas gives each round an IADD3, a funnel-shift
// SHF and a LOP3)
__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1, uint32_t hi, uint32_t lo) {
  const uint2 h = threefry2x32(k0, k1, hi, lo);
  return h.x ^ h.y;
}

// 16 bytes of x (16 / sizeof(T) elements) under the mask's bits from bit 0
// of keep
template <typename T>
__device__ __forceinline__ uint4 drop16(uint4 v, uint32_t keep, float scale, int mode) {
  uint32_t* p = reinterpret_cast<uint32_t*>(&v);
  if (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = __float_as_uint(drop(__uint_as_float(p[e]), keep >> e & 1u, scale, mode));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = __bfloat162float(__ushort_as_bfloat16((unsigned short)(p[e] & 0xffffu)));
      const float hi = __bfloat162float(__ushort_as_bfloat16((unsigned short)(p[e] >> 16)));
      const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(drop(lo, keep >> (2 * e) & 1u, scale, mode)));
      const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(drop(hi, keep >> (2 * e + 1) & 1u, scale, mode)));
      p[e] = a | (b << 16);
    }
  }
  return v;
}

template <typename T, bool kAligned, bool kHash>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, uint32_t* bits, long long rows,
               long long period, uint32_t k0, uint32_t k1, uint32_t keep_max, float scale, int mode,
               long long offset) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPer = kTile / (kThreads * kVec);  // 16-byte vectors a thread a row
  __shared__ uint32_t words[kThreads];
  const long long tile = (long long)blockIdx.x * kTile;
  const long long w = tile / 32 + threadIdx.x;  // this thread's word
  const long long m0 = tile + 32LL * threadIdx.x;
  const int n = (int)(period - tile < kTile ? period - tile : kTile);  // the tile's mask indices
  // a row's vectors, all loads in flight at once; the first row's before
  // the hash, which hides their latency
  uint4 v[kPer];
  auto load_row = [&](long long r) {
    const T* xr = x + r * period + tile;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int o = (p * kThreads + threadIdx.x) * kVec;
      if (o < n) v[p] = __ldcs(reinterpret_cast<const uint4*>(xr + o));
    }
  };
  long long r = blockIdx.y;
  if (kAligned && r < rows) load_row(r);
  uint32_t word = 0;
  if (kHash) {
    // the counters offset + m0 + q: one high word for the thread's 32 unless
    // its low word wraps among them
    const unsigned long long base = (unsigned long long)(offset + m0);
    const uint32_t lo0 = (uint32_t)base, hi0 = (uint32_t)(base >> 32);
    const bool wraps = lo0 > 0xFFFFFFFFu - 31u;
    for (int q = 0; q < 32 && m0 + q < period; q += kIlp) {
      uint32_t h[kIlp];
#pragma unroll
      for (int j = 0; j < kIlp; ++j)
        h[j] = threefry_xor(k0, k1, wraps ? (uint32_t)((base + q + j) >> 32) : hi0, lo0 + (uint32_t)(q + j));
#pragma unroll
      for (int j = 0; j < kIlp; ++j) word |= (uint32_t)(h[j] <= keep_max) << (q + j);
    }
    if (m0 < period && period - m0 < 32) word &= (1u << (int)(period - m0)) - 1u;  // no bit past the mask
    if (bits && blockIdx.y == 0 && m0 < period) bits[w] = word;
  } else if (m0 < period) {
    word = bits[w];
  }
  words[threadIdx.x] = word;
  __syncthreads();
  for (; r < rows; r += gridDim.y) {
    T* yr = y + r * period + tile;
    if (kAligned) {
      if (r != blockIdx.y) load_row(r);
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int o = (p * kThreads + threadIdx.x) * kVec;
        if (o < n)
          __stcs(reinterpret_cast<uint4*>(yr + o), drop16<T>(v[p], words[o >> 5] >> (o & 31), scale, mode));
      }
    } else {
      const T* xr = x + r * period + tile;
      for (int o = threadIdx.x; o < n; o += kThreads)
        yr[o] = from_f32<T>(drop(to_f32(xr[o]), words[o >> 5] >> (o & 31) & 1u, scale, mode));
    }
  }
}

template <typename T, bool kHash>
int launch(const void* x, void* y, uint32_t* bits, long long rows, long long period, uint32_t k0,
           uint32_t k1, uint32_t keep_max, float scale, int mode, long long offset, cudaStream_t s) {
  const long long gx = (period + kTile - 1) / kTile;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  long long gy = (kTargetBlocks + gx - 1) / gx;
  gy = gy < rows ? gy : rows;
  gy = gy < 65535 ? gy : 65535;
  const dim3 grid((unsigned int)gx, (unsigned int)(gy > 0 ? gy : 1));
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = period % kVec == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (aligned)
    dropout_kernel<T, true, kHash><<<grid, kThreads, 0, s>>>(xt, yt, bits, rows, period, k0, k1, keep_max,
                                                             scale, mode, offset);
  else
    dropout_kernel<T, false, kHash><<<grid, kThreads, 0, s>>>(xt, yt, bits, rows, period, k0, k1, keep_max,
                                                              scale, mode, offset);
  return (int)cudaGetLastError();
}

}  // namespace lpm

using namespace lpm;

extern "C" {

// x, y: rows·period elements, f32 (bf16 = 0) or bf16 (bf16 = 1), contiguous;
// bits: ceil(period / 32) uint32, written by the forward (from_bits = 0,
// hashing the key's words (k0, k1); null: not written) or read by the
// backward (from_bits = 1; the key is not used); keep_prob: f32(1 − rate)
// in (0, 1]; scale: keep_prob in x's dtype (mode 0) or 1 / that in x's dtype
// (mode 1), widened to f32.
int lpm_dropout(const void* x, void* y, void* bits, long long rows, long long period, unsigned int k0,
                unsigned int k1, float keep_prob, float scale, int mode, int bf16, long long offset,
                int from_bits, void* stream) {
  if (rows <= 0 || period <= 0) return 0;
  if (offset < 0 || !(keep_prob > 0.0f && keep_prob <= 1.0f) || (from_bits && !bits))
    return (int)cudaErrorInvalidValue;
  // keep ⇔ (h >> 9) < ⌈keep_prob · 2²³⌉ ⇔ h ≤ 512·⌈keep_prob · 2²³⌉ − 1 (exact in double)
  const unsigned long long bound = (unsigned long long)ceil((double)keep_prob * 8388608.0);
  const uint32_t keep_max = (uint32_t)(bound * 512ULL - 1ULL);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* b = static_cast<uint32_t*>(bits);
  if (bf16)
    return from_bits ? launch<__nv_bfloat16, false>(x, y, b, rows, period, k0, k1, keep_max, scale, mode, offset, s)
                     : launch<__nv_bfloat16, true>(x, y, b, rows, period, k0, k1, keep_max, scale, mode, offset, s);
  return from_bits ? launch<float, false>(x, y, b, rows, period, k0, k1, keep_max, scale, mode, offset, s)
                   : launch<float, true>(x, y, b, rows, period, k0, k1, keep_max, scale, mode, offset, s);
}

}  // extern "C"
