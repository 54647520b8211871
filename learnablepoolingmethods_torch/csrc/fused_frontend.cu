// Fused inference front end: uint8 frames [B, F, DT], frame counts [B] and a
// threefry key → S sampled frames per video → bf16 NetVLAD descriptors rgb
// [B, d_rgb, k_rgb] and audio [B, d_aud, k_aud].
//
// Replaces the TPU kernel learnablepoolingmethods_tpu/ops/fused_frontend.py
// #netvlad_frontend_fused (kernel body _make_kernel), which per video
// dequantizes all F frames in VMEM, ℓ2-normalises each frame over all DT
// columns, applies the folded input BN, picks the S sampled rows with a
// one-hot matmul on the MXU and runs both NetVLADs.
//
// What bounds it here: at Willow shapes (B=512, S=30) the kernel must move
// about 18 MB of sampled uint8 rows in and 285 MB of bf16 descriptors out
// (about 90 µs at 3.35 TB/s), and do 8.6 GFLOP of logits plus 8.6 GFLOP of
// aggregation (17 µs at 989 TFLOP/s of bf16 tensor cores: X is exact in
// bf16, and A splits into bf16 terms at f32 accuracy), so the bytes are the
// bound.  At S=300 the operations are (about 173 µs).  The NetVLAD chain
// runs on tensor cores with one aggregation pass (netvlad_tc.cuh); PERF.md
// has the numbers of each run.
//
// Design:
//  - Each warp draws its own frame index: floor(U·min(nf, F)) clamped to
//    F−1, with U = jax.random.uniform(key, (B, S))[b, s] computed by the
//    threefry2x32 hash of counter (0, b·S + s) (jax_threefry_partitionable;
//    threefry.cuh), bit for bit the index that utils/prng.py and the JAX
//    package draw.  A rank of a mesh that holds rows row_offset … of the
//    global batch hashes counters (row_offset + b)·S + s, its rows' share
//    of the global draw.  The host passes only the key's two words; drawing U
//    there cost each batch host time the device then waited for (PERF.md).
//  - Sampling is a direct gather: ℓ2 and BN act row by row, so normalising
//    only the S sampled rows gives the same rows as normalising all F and
//    then selecting.  One warp per sampled row (eight a block) loads the
//    1152-byte row as 16-byte vectors, reduces Σx² over all DT columns (rgb
//    and audio stay coupled in the norm) by shuffles, and writes the row,
//    normalised, BN'd and rounded to bf16 once, into a [B·S, DT] scratch
//    tensor (35 MB at B=512, S=30).  (A 128-thread block per row, as the
//    first port had it, left 56 of its threads idle on a 72-vector row.)
//  - Both NetVLADs then run the bf16 chain (run_netvlad<bf16>, netvlad_tc.cuh:
//    the logits and softmax as one tensor-core GEMM over all B·S rows, then
//    one aggregation pass per video in a thread-block cluster) on column
//    slices of that scratch tensor: rgb on columns [0, d_rgb), audio on
//    [d_rgb, DT), with row stride DT.  No f32 [B, D, K] tensor is stored.
//  - Everything runs on the caller's stream; the host function returns
//    cudaGetLastError() after the last launch.

#include "netvlad_tc.cuh"
#include "threefry.cuh"

namespace lpm {

constexpr int kPrepThreads = 256;  // one warp per sampled row, 8 rows a block
constexpr int kPrepRows = kPrepThreads / 32;

__device__ __forceinline__ float deq(uint32_t q, float scale, float bias) {
  return __fadd_rn(__fmul_rn((float)q, scale), bias);
}

// The frame sampled for row b·S + s: floor(U·min(nf, F)) clamped to F−1,
// U the row's jax.random.uniform draw (top 23 bits as a mantissa in [1, 2)).
__device__ __forceinline__ int sample_frame(uint32_t k0, uint32_t k1, long long row, int nf,
                                            int F) {
  const float u = threefry_uniform(k0, k1, row);
  return min((int)__fmul_rn(u, (float)min(nf, F)), F - 1);
}

// One warp per sampled row (b, s): draw the frame, gather, dequantize,
// per-frame ℓ2 over DT columns, folded input BN, one rounding to bf16.
template <bool kVec>
__global__ void __launch_bounds__(kPrepThreads)
frontend_prep_kernel(const uint8_t* __restrict__ x, uint32_t k0, uint32_t k1,
                     const int32_t* __restrict__ num_frames,
                     const float* __restrict__ in_scale, const float* __restrict__ in_bias,
                     __nv_bfloat16* __restrict__ xs, long long rows, int F, int DT, int S,
                     float deq_scale, float deq_bias, long long draw0) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kPrepRows + (threadIdx.x >> 5);  // b·S + s
  if (row >= rows) return;
  const int b = (int)(row / S);
  const int f = sample_frame(k0, k1, draw0 + row, num_frames[b], F);
  __nv_bfloat16* dst = xs + row * DT;
  const uint8_t* src = x + ((long long)b * F + f) * DT;

  float ss = 0.f;
  if (kVec) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    for (int v = lane; v < DT / 16; v += 32) {
      const uint4 q = src4[v];
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float t = deq((w[j >> 2] >> (8 * (j & 3))) & 0xffu, deq_scale, deq_bias);
        ss = fmaf(t, t, ss);
      }
    }
  } else {
    for (int c = lane; c < DT; c += 32) {
      const float t = deq(src[c], deq_scale, deq_bias);
      ss = fmaf(t, t, ss);
    }
  }
  const float inv = rsqrtf(fmaxf(warp_sum(ss), kEps));

  if (kVec) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    for (int v = lane; v < DT / 16; v += 32) {
      const uint4 q = src4[v];
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
      uint32_t packed[8];
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const int c = v * 16 + j;
        const float t0 = deq((w[j >> 2] >> (8 * (j & 3))) & 0xffu, deq_scale, deq_bias);
        const float t1 =
            deq((w[(j + 1) >> 2] >> (8 * ((j + 1) & 3))) & 0xffu, deq_scale, deq_bias);
        const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(t0, inv), in_scale[c]), in_bias[c]);
        const float y1 =
            __fadd_rn(__fmul_rn(__fmul_rn(t1, inv), in_scale[c + 1]), in_bias[c + 1]);
        const __nv_bfloat162 h = __floats2bfloat162_rn(y0, y1);
        packed[j >> 1] = *reinterpret_cast<const uint32_t*>(&h);
      }
      dst4[2 * v] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst4[2 * v + 1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
  } else {
    for (int c = lane; c < DT; c += 32) {
      const float t = deq(src[c], deq_scale, deq_bias);
      dst[c] = __float2bfloat16_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(t, inv), in_scale[c]), in_bias[c]));
    }
  }
}

}  // namespace lpm

extern "C" int lpm_netvlad_frontend(
    const void* x, unsigned int k0, unsigned int k1, const void* num_frames,
    const void* in_scale, const void* in_bias,
    const void* c_rgb, const void* s_rgb, const void* b_rgb, const void* c2_rgb,
    const void* c_aud, const void* s_aud, const void* b_aud, const void* c2_aud,
    void* out_rgb, void* out_aud, void* ws_x, void* ws_a_rgb, void* ws_a_aud,
    void* ws_colsq_rgb, void* ws_colsq_aud, int B, int F, int DT, int S, int d_rgb,
    int k_rgb, int d_aud, int k_aud, float deq_scale, float deq_bias, long long row_offset,
    void* stream) {
  using bf16 = __nv_bfloat16;
  if (B < 1 || F < 1 || S < 1 || d_rgb < 1 || d_aud < 1 || d_rgb + d_aud != DT || row_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * S;
  const unsigned blocks = (unsigned)((rows + lpm::kPrepRows - 1) / lpm::kPrepRows);
  const bool vec = (DT % 16) == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(ws_x) % 16) == 0;
  const uint8_t* xu = static_cast<const uint8_t*>(x);
  const int32_t* nf = static_cast<const int32_t*>(num_frames);
  const float* isc = static_cast<const float*>(in_scale);
  const float* ibi = static_cast<const float*>(in_bias);
  bf16* xs = static_cast<bf16*>(ws_x);
  if (vec)
    lpm::frontend_prep_kernel<true><<<blocks, lpm::kPrepThreads, 0, st>>>(
        xu, k0, k1, nf, isc, ibi, xs, rows, F, DT, S, deq_scale, deq_bias, row_offset * S);
  else
    lpm::frontend_prep_kernel<false><<<blocks, lpm::kPrepThreads, 0, st>>>(
        xu, k0, k1, nf, isc, ibi, xs, rows, F, DT, S, deq_scale, deq_bias, row_offset * S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = lpm::run_netvlad<bf16>(
      xs, DT, static_cast<const bf16*>(c_rgb), static_cast<const float*>(s_rgb),
      static_cast<const float*>(b_rgb), static_cast<const float*>(c2_rgb),
      static_cast<bf16*>(out_rgb), static_cast<float*>(ws_a_rgb),
      static_cast<float*>(ws_colsq_rgb), B, S, d_rgb, k_rgb, st);
  if (err != cudaSuccess) return (int)err;
  err = lpm::run_netvlad<bf16>(
      xs + d_rgb, DT, static_cast<const bf16*>(c_aud), static_cast<const float*>(s_aud),
      static_cast<const float*>(b_aud), static_cast<const float*>(c2_aud),
      static_cast<bf16*>(out_aud), static_cast<float*>(ws_a_aud),
      static_cast<float*>(ws_colsq_aud), B, S, d_aud, k_aud, st);
  return (int)err;
}
