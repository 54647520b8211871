// NetVLAD core shared by the two inference kernels (netvlad_fused.cu and
// fused_frontend.cu): for each video b of a batch, from frames X_b [S, D]
// (bf16 or f32, row stride ldx) it computes
//
//     A      = softmax(X_b·C · scale + bias)          [S, K]  f32
//     a_sum  = Σ_s A                                  [K]
//     vlad   = X_bᵀ·A − a_sum ⊙ C₂                    [D, K]  f32
//     vlad   = vlad · rsqrt(max(Σ_d vlad², 1e-12))    (intra-ℓ2 per cluster)
//     out_b  = vlad · rsqrt(max(Σ vlad², 1e-12))      (global ℓ2), cast to T
//
// The TPU kernels keep one video's whole f32 [D, K] aggregate (1 MB at
// D=1024, K=256) and C₂ in VMEM and walk the batch as a sequential grid.
// A Hopper block has at most 227 KB of shared memory and blocks run in no
// order, so the chain is cut into three launches that need no ordering
// between blocks:
//
//  1. logits_softmax_kernel: one GEMM over all B·S frame rows (C is shared
//     by every video), 32 rows × all K columns per block, with the row
//     softmax as its epilogue; writes A [B·S, K] f32 (30 KB per video at
//     S=30, K=256).
//  2. aggregate_kernel<false>: grid (K/32, B); each block owns 32 clusters
//     of one video, streams X_b and A_b through shared memory in 32-sample
//     chunks and 64-row descriptor chunks, and writes Σ_d vlad² for its
//     clusters.  No f32 [B, D, K] tensor ever reaches device memory.
//  3. aggregate_kernel<true>: the same tiles recompute vlad and write the
//     normalised descriptor.  The global norm needs every cluster of the
//     video, which other blocks own; after the intra-ℓ2, Σ vlad² equals
//     Σ_k colsq_k · rsqrt(max(colsq_k, ε))², so each block forms it from
//     the [B, K] sums of pass 2 alone.
//
// Rounding follows the TPU kernel: the logits are products of the input
// type with an f32 sum, the aggregation reads X as f32 with A in f32, and
// the descriptor is rounded to T only at the end.  The f32 training kernels
// (netvlad_train.cu) run the same aggregation with kRoundA, which rounds A
// to T before the product, as ops/netvlad_train.py#_fwd_kernel does; a_sum
// still sums the unrounded A.  Products and sums are
// plain f32 FMAs; the kernels move few bytes, so the FMA and shared-memory
// issue rates bound them (see PERF.md).  The f32 inference and training
// kernels use this code, and NetFV (netfv_fused.cu) its logits in f32 and
// its two-pass shape of the aggregation in both types;
// run_netvlad<__nv_bfloat16>, the bf16 inference chain, is specialised on
// tensor cores in netvlad_tc.cuh, which the bf16 training kernels and
// NetFV's bf16 logits use too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lpm {

constexpr float kEps = 1e-12f;
constexpr int kThreads = 256;  // every kernel below runs 8 warps a block
constexpr int kMaxClusters = 512;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v, or v rounded to T and widened back when kRound is set
template <typename T, bool kRound>
__device__ __forceinline__ float round_to(float v) {
  return kRound ? to_float(from_float<T>(v)) : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------- logits --

constexpr int kLogitRows = 32;               // frame rows per block (4 per warp)
constexpr int kLogitDepth = 32;              // D chunk staged in shared memory
constexpr int kXPitch = kLogitRows + 4;      // transposed x tile pitch (16 B rows)

// Thread (warp w, lane l) accumulates rows 4w..4w+3 for clusters l + 32j,
// j < NJ, so the softmax of a row is a reduction inside one warp.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
logits_softmax_kernel(const T* __restrict__ x, long long ldx, const T* __restrict__ c,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      float* __restrict__ a, long long M, int D, int K) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kLogitDepth][kXPitch]
  float* cs = xs + kLogitDepth * kXPitch;       // [kLogitDepth][K]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * kLogitRows;

  float acc[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kLogitDepth) {
    for (int i = tid; i < kLogitRows * kLogitDepth; i += kThreads) {
      const int r = i / kLogitDepth, dd = i % kLogitDepth;
      const long long row = row0 + r;
      const int d = d0 + dd;
      xs[dd * kXPitch + r] = (row < M && d < D) ? to_float(x[row * ldx + d]) : 0.f;
    }
    for (int i = tid; i < kLogitDepth * K; i += kThreads) {
      const int dd = i / K, k = i - dd * K;
      const int d = d0 + dd;
      cs[i] = d < D ? to_float(c[(long long)d * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < kLogitDepth; ++dd) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[dd * kXPitch + warp * 4]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int k = lane + 32 * j;
        const float cv = k < K ? cs[dd * K + k] : 0.f;
        acc[0][j] = fmaf(xv.x, cv, acc[0][j]);
        acc[1][j] = fmaf(xv.y, cv, acc[1][j]);
        acc[2][j] = fmaf(xv.z, cv, acc[2][j]);
        acc[3][j] = fmaf(xv.w, cv, acc[3][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long row = row0 + warp * 4 + r;
    float v[NJ];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = lane + 32 * j;
      v[j] = k < K ? __fadd_rn(__fmul_rn(acc[r][j], scale[k]), bias[k]) : -INFINITY;
      m = fmaxf(m, v[j]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = lane + 32 * j;
      v[j] = k < K ? expf(v[j] - m) : 0.f;
      s += v[j];
    }
    s = warp_sum(s);
    if (row < M) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int k = lane + 32 * j;
        if (k < K) a[row * K + k] = v[j] / s;
      }
    }
  }
}

// ------------------------------------------------------------- aggregate --

constexpr int kAggClusters = 32;  // clusters per block, one per lane
constexpr int kAggRows = 64;      // descriptor rows per chunk, 8 per warp
constexpr int kAggSamples = 32;   // samples staged per chunk

// Pass kWrite=false writes colsq[b, k] = Σ_d vlad[d, k]²; pass kWrite=true
// reads the whole colsq[b, :] row and writes out[b] = the normalised vlad.
// kRoundA rounds A to T where it enters the product (not in a_sum).
template <typename T, bool kWrite, bool kRoundA = false>
__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const T* __restrict__ x, long long ldx, const float* __restrict__ a,
                 const float* __restrict__ c2, float* __restrict__ colsq,
                 T* __restrict__ out, int S, int D, int K) {
  __shared__ float a_s[kAggSamples][kAggClusters];
  __shared__ __align__(16) float x_s[kAggSamples][kAggRows];
  __shared__ float red[8][kAggClusters];
  __shared__ float asum_s[kAggClusters];
  __shared__ float tot_s[8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kAggClusters;
  const int k = k0 + lane;
  const bool kvalid = k < K;
  const long long row0 = (long long)b * S;

  float p = 0.f;
  if (kvalid)
    for (int s = warp; s < S; s += 8) p += a[(row0 + s) * K + k];
  red[warp][lane] = p;
  float t = 0.f;
  if (kWrite) {
    for (int kk = tid; kk < K; kk += kThreads) {
      const float cq = colsq[(long long)b * K + kk];
      const float r = rsqrtf(fmaxf(cq, kEps));
      t += cq * r * r;
    }
    t = warp_sum(t);
    if (lane == 0) tot_s[warp] = t;
  }
  __syncthreads();
  if (warp == 0) {
    float q = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) q += red[w][lane];
    asum_s[lane] = q;
  }
  __syncthreads();
  const float asum = asum_s[lane];
  float r_k = 0.f, inv_tot = 0.f;
  if (kWrite) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) tot += tot_s[w];
    inv_tot = rsqrtf(fmaxf(tot, kEps));
    r_k = kvalid ? rsqrtf(fmaxf(colsq[(long long)b * K + k], kEps)) : 0.f;
  }

  float cs_part = 0.f;
  for (int d0 = 0; d0 < D; d0 += kAggRows) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int s0 = 0; s0 < S; s0 += kAggSamples) {
      const int sn = min(kAggSamples, S - s0);
      for (int i = tid; i < kAggSamples * kAggClusters; i += kThreads) {
        const int s = i / kAggClusters, kk = i % kAggClusters;
        a_s[s][kk] = (s < sn && k0 + kk < K)
                         ? round_to<T, kRoundA>(a[(row0 + s0 + s) * K + k0 + kk])
                         : 0.f;
      }
      for (int i = tid; i < kAggSamples * kAggRows; i += kThreads) {
        const int s = i / kAggRows, dd = i % kAggRows;
        const int d = d0 + dd;
        x_s[s][dd] = (s < sn && d < D) ? to_float(x[(row0 + s0 + s) * ldx + d]) : 0.f;
      }
      __syncthreads();
      for (int s = 0; s < sn; ++s) {
        const float av = a_s[s][lane];
        const float4 xa = *reinterpret_cast<const float4*>(&x_s[s][warp * 8]);
        const float4 xb = *reinterpret_cast<const float4*>(&x_s[s][warp * 8 + 4]);
        acc[0] = fmaf(xa.x, av, acc[0]);
        acc[1] = fmaf(xa.y, av, acc[1]);
        acc[2] = fmaf(xa.z, av, acc[2]);
        acc[3] = fmaf(xa.w, av, acc[3]);
        acc[4] = fmaf(xb.x, av, acc[4]);
        acc[5] = fmaf(xb.y, av, acc[5]);
        acc[6] = fmaf(xb.z, av, acc[6]);
        acc[7] = fmaf(xb.w, av, acc[7]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = d0 + warp * 8 + i;
      if (kvalid && d < D) {
        const float v = __fsub_rn(acc[i], __fmul_rn(asum, c2[(long long)d * K + k]));
        if (kWrite) {
          out[((long long)b * D + d) * K + k] =
              from_float<T>(__fmul_rn(__fmul_rn(v, r_k), inv_tot));
        } else {
          cs_part = fmaf(v, v, cs_part);
        }
      }
    }
  }

  if (!kWrite) {
    red[warp][lane] = cs_part;
    __syncthreads();
    if (warp == 0 && kvalid) {
      float q = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) q += red[w][lane];
      colsq[(long long)b * K + k] = q;
    }
  }
}

// ---------------------------------------------------------------- launch --

template <typename T, int NJ>
cudaError_t launch_logits(const T* x, long long ldx, const T* c, const float* scale,
                          const float* bias, float* a, long long M, int D, int K,
                          cudaStream_t stream) {
  const size_t smem = (size_t)(kLogitDepth * kXPitch + kLogitDepth * K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(logits_softmax_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((M + kLogitRows - 1) / kLogitRows);
  logits_softmax_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(x, ldx, c, scale, bias, a,
                                                                  M, D, K);
  return cudaGetLastError();
}

// The softmax assignment A [M, K] f32 of M frame rows, K <= kMaxClusters.
template <typename T>
cudaError_t launch_softmax_assignment(const T* x, long long ldx, const T* c,
                                      const float* scale, const float* bias, float* a,
                                      long long M, int D, int K, cudaStream_t stream) {
  const int nj = (K + 31) / 32;
  if (nj <= 1) return launch_logits<T, 1>(x, ldx, c, scale, bias, a, M, D, K, stream);
  if (nj <= 2) return launch_logits<T, 2>(x, ldx, c, scale, bias, a, M, D, K, stream);
  if (nj <= 4) return launch_logits<T, 4>(x, ldx, c, scale, bias, a, M, D, K, stream);
  if (nj <= 8) return launch_logits<T, 8>(x, ldx, c, scale, bias, a, M, D, K, stream);
  return launch_logits<T, 16>(x, ldx, c, scale, bias, a, M, D, K, stream);
}

// The three launches for one modality.  ws_a holds B·S·K floats and
// ws_colsq B·K floats; both are scratch allocated by the caller.  (The
// bf16 specialisation in netvlad_tc.cuh needs B·⌈D/1024⌉·K for ws_colsq.)
template <typename T>
cudaError_t run_netvlad(const T* x, long long ldx, const T* c, const float* scale,
                        const float* bias, const float* c2, T* out, float* ws_a,
                        float* ws_colsq, int B, int S, int D, int K, cudaStream_t stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || K < 1 || K > kMaxClusters)
    return cudaErrorInvalidValue;
  const long long M = (long long)B * S;
  cudaError_t err = launch_softmax_assignment<T>(x, ldx, c, scale, bias, ws_a, M, D, K, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + kAggClusters - 1) / kAggClusters, B);
  aggregate_kernel<T, false><<<grid, kThreads, 0, stream>>>(x, ldx, ws_a, c2, ws_colsq, out,
                                                            S, D, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  aggregate_kernel<T, true><<<grid, kThreads, 0, stream>>>(x, ldx, ws_a, c2, ws_colsq, out,
                                                           S, D, K);
  return cudaGetLastError();
}

}  // namespace lpm
