// Fused SoftDBoW histogram on prepared frames: x [B, S, D] (bf16 or f32,
// rows of stride ldx) → the raw histogram [B, K] f32,
//
//     bow[b, k] = Σ_s softmax_k(X[b, s]·C · scale + bias)
//
// with the assignment BN folded into scale/bias and C [D, K] in x's type.
// The caller ℓ2-normalises the [B, K] result.
//
// Replaces the TPU kernel learnablepoolingmethods_tpu/ops/softdbow_pallas.py
// #softdbow_fused (kernel body _kernel), which keeps the [S, K] soft
// assignment of one video in VMEM instead of [B, S, K] in HBM.
//
// What bounds it here: at the SoftDBoW-4096 rgb shape (B=512, S=30,
// D=1024, K=4096) it reads 31 MB of frames and 8 MB of C and writes 8 MB
// (14 µs at 3.35 TB/s) for 129 GFLOP of logits (130 µs at 989 TFLOP/s of
// bf16 tensor cores): the products bound it.  This simple version does
// them as f32 FMAs on the CUDA cores, and twice (below), far above that.
//
// Design: K = 4096 is far above what one block can hold a row of for
// several rows at once, and each frame's softmax needs its max and sum
// over all K before it adds to the histogram.  So two passes over
// 128-cluster tiles, grid (K/128, B), one video per block, its S rows in
// 32-row chunks:
//  1. softdbow_stats_kernel: each block computes its tile of logits and
//     writes, per row, the tile's max and Σ exp(logit − max) to [B·S, K/128]
//     scratch;
//  2. softdbow_hist_kernel: each block combines those K/128 partials per row
//     in a fixed order into the row's max and softmax denominator, recomputes
//     its tile of logits with the same code, and sums the probabilities over
//     the video's rows into bow[b, its 128 clusters].
// A block owns all rows of its video for its clusters, so no sum crosses
// blocks: no float atomics, and two runs give the same bits (the TPU
// kernel's frame split instead accumulates into a revisited output block).
// The logits are products of x's type summed in f32, as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "netvlad_core.cuh"

namespace lpm {

constexpr int kBowRows = 32;        // frame rows per chunk, 4 per warp
constexpr int kBowClusters = 128;   // clusters per block, 4 per lane
constexpr int kBowNJ = kBowClusters / 32;
constexpr int kBowDepth = 32;       // D chunk staged in shared memory
constexpr int kBowXPitch = kBowRows + 4;

struct BowSmem {
  __align__(16) float xs[kBowDepth][kBowXPitch];  // transposed x chunk
  float cs[kBowDepth][kBowClusters];
};

// Logits of rows row0 .. row0+rows−1 (rows <= 32, all of one video) for
// clusters k0 + lane + 32j: thread (warp w, lane l) holds rows 4w..4w+3 in
// v[r][j], −inf for a cluster at or past K.
template <typename T>
__device__ __forceinline__ void bow_logits(const T* __restrict__ x, long long ldx,
                                           long long row0, int rows,
                                           const T* __restrict__ c,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, int k0, int D, int K,
                                           BowSmem& sm, float v[4][kBowNJ]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[4][kBowNJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kBowNJ; ++j) acc[r][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kBowDepth) {
    for (int i = tid; i < kBowRows * kBowDepth; i += kThreads) {
      const int r = i / kBowDepth, dd = i % kBowDepth;
      const int d = d0 + dd;
      sm.xs[dd][r] = (r < rows && d < D) ? to_float(x[(row0 + r) * ldx + d]) : 0.f;
    }
    for (int i = tid; i < kBowDepth * kBowClusters; i += kThreads) {
      const int dd = i / kBowClusters, kk = i % kBowClusters;
      const int d = d0 + dd, k = k0 + kk;
      sm.cs[dd][kk] = (d < D && k < K) ? to_float(c[(long long)d * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < kBowDepth; ++dd) {
      const float4 xv = *reinterpret_cast<const float4*>(&sm.xs[dd][warp * 4]);
#pragma unroll
      for (int j = 0; j < kBowNJ; ++j) {
        const float cv = sm.cs[dd][lane + 32 * j];
        acc[0][j] = fmaf(xv.x, cv, acc[0][j]);
        acc[1][j] = fmaf(xv.y, cv, acc[1][j]);
        acc[2][j] = fmaf(xv.z, cv, acc[2][j]);
        acc[3][j] = fmaf(xv.w, cv, acc[3][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kBowNJ; ++j) {
    const int k = k0 + lane + 32 * j;
    const float sc = k < K ? scale[k] : 0.f, bi = k < K ? bias[k] : 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      v[r][j] = k < K ? __fadd_rn(__fmul_rn(acc[r][j], sc), bi) : -INFINITY;
  }
}

// Pass 1: per row and cluster tile, the tile's max and Σ exp(logit − max)
// into tmax/tsum [B·S, KT] (KT = gridDim.x).
template <typename T>
__global__ void __launch_bounds__(kThreads)
softdbow_stats_kernel(const T* __restrict__ x, long long ldx, const T* __restrict__ c,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      float* __restrict__ tmax, float* __restrict__ tsum, int S, int D, int K) {
  __shared__ BowSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kt = blockIdx.x, nkt = gridDim.x, b = blockIdx.y;
  for (int s0 = 0; s0 < S; s0 += kBowRows) {
    const int rows = min(kBowRows, S - s0);
    const long long row0 = (long long)b * S + s0;
    float v[4][kBowNJ];
    bow_logits<T>(x, ldx, row0, rows, c, scale, bias, kt * kBowClusters, D, K, sm, v);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBowNJ; ++j) m = fmaxf(m, v[r][j]);
      m = warp_max(m);
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < kBowNJ; ++j) e += expf(v[r][j] - m);
      e = warp_sum(e);
      const int row = warp * 4 + r;
      if (lane == 0 && row < rows) {
        tmax[(row0 + row) * nkt + kt] = m;
        tsum[(row0 + row) * nkt + kt] = e;
      }
    }
  }
}

// Pass 2: the softmax of each row from the pass-1 partials, summed over the
// video's rows into bow[b, kt·128 ...].
template <typename T>
__global__ void __launch_bounds__(kThreads)
softdbow_hist_kernel(const T* __restrict__ x, long long ldx, const T* __restrict__ c,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const float* __restrict__ tmax, const float* __restrict__ tsum,
                     float* __restrict__ bow, int S, int D, int K) {
  __shared__ BowSmem sm;
  __shared__ float row_max[kBowRows], row_sum[kBowRows];
  __shared__ float red[8][kBowClusters];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kt = blockIdx.x, nkt = gridDim.x, b = blockIdx.y;
  const int k0 = kt * kBowClusters;
  float hist[kBowNJ];
#pragma unroll
  for (int j = 0; j < kBowNJ; ++j) hist[j] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kBowRows) {
    const int rows = min(kBowRows, S - s0);
    const long long row0 = (long long)b * S + s0;
    __syncthreads();  // every warp is done with the last chunk's row_max/row_sum
    if (tid < rows) {
      const float* pm = tmax + (row0 + tid) * nkt;
      const float* ps = tsum + (row0 + tid) * nkt;
      float m = -INFINITY;
      for (int t = 0; t < nkt; ++t) m = fmaxf(m, pm[t]);
      float z = 0.f;
      for (int t = 0; t < nkt; ++t) z += ps[t] * expf(pm[t] - m);
      row_max[tid] = m;
      row_sum[tid] = z;
    }
    // bow_logits synchronises before it reads shared memory, which also
    // publishes row_max and row_sum
    float v[4][kBowNJ];
    bow_logits<T>(x, ldx, row0, rows, c, scale, bias, k0, D, K, sm, v);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = warp * 4 + r;
      if (row < rows) {
        const float m = row_max[row], z = row_sum[row];
#pragma unroll
        for (int j = 0; j < kBowNJ; ++j) hist[j] += __fdiv_rn(expf(v[r][j] - m), z);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kBowNJ; ++j) red[warp][lane + 32 * j] = hist[j];
  __syncthreads();
  if (tid < kBowClusters && k0 + tid < K) {
    float q = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) q += red[w][tid];
    bow[(long long)b * K + k0 + tid] = q;
  }
}

// Both passes.  ws_max and ws_sum each hold B·S·⌈K/128⌉ floats, scratch
// allocated by the caller.
template <typename T>
cudaError_t run_softdbow(const T* x, long long ldx, const T* c, const float* scale,
                         const float* bias, float* bow, float* ws_max, float* ws_sum, int B,
                         int S, int D, int K, cudaStream_t stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || K < 1) return cudaErrorInvalidValue;
  const dim3 grid((K + kBowClusters - 1) / kBowClusters, B);
  softdbow_stats_kernel<T><<<grid, kThreads, 0, stream>>>(x, ldx, c, scale, bias, ws_max,
                                                          ws_sum, S, D, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  softdbow_hist_kernel<T><<<grid, kThreads, 0, stream>>>(x, ldx, c, scale, bias, ws_max,
                                                         ws_sum, bow, S, D, K);
  return cudaGetLastError();
}

}  // namespace lpm

extern "C" int lpm_softdbow_fused(const void* x, long long ldx, int x_is_bf16, const void* c,
                                  const void* scale, const void* bias, void* bow, void* ws_max,
                                  void* ws_sum, int B, int S, int D, int K, void* stream) {
  cudaError_t err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* out = static_cast<float*>(bow);
  float* wm = static_cast<float*>(ws_max);
  float* ws = static_cast<float*>(ws_sum);
  if (x_is_bf16) {
    using bf16 = __nv_bfloat16;
    err = lpm::run_softdbow<bf16>(static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(c),
                                  sc, bi, out, wm, ws, B, S, D, K, st);
  } else {
    err = lpm::run_softdbow<float>(static_cast<const float*>(x), ldx,
                                   static_cast<const float*>(c), sc, bi, out, wm, ws, B, S, D,
                                   K, st);
  }
  return (int)err;
}
