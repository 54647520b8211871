// NetVLAD aggregation for training: forward and backward of
//
//     A   = softmax(L)                              [F, K]  f32
//     S   = Σ_F A                                   [K]
//     V₁  = Xᵀ·round_T(A) − S ⊙ C₂                  [D, K]  f32 sums
//     V₂  = V₁ · rsqrt(max(Σ_D V₁², 1e-12))         (intra-ℓ2 per cluster)
//     V₃  = V₂ · rsqrt(max(Σ V₂², 1e-12))           (global ℓ2), cast to T
//
// for each video of a batch, with X [B, F, D] in T (bf16 or f32), the
// post-BN assignment logits L [B, F, K] f32 and C₂ [D, K] f32.
//
// Replaces the TPU kernels of learnablepoolingmethods_tpu/ops/netvlad_train.py:
// _forward_impl (kernel body _fwd_kernel) and _backward_impl (_bwd_kernel).
// Both hold one video's whole [D, K] block in VMEM per step of a sequential
// grid; the backward recomputes A and V from the residuals (X, L, C₂), and
// accumulates dC₂ over the batch by revisiting one output block.
//
// What bounds them here: at Willow shapes (B=256, S=30, rgb D=1024 K=256 and
// audio D=128 K=128, X in bf16) the forward must read 16 MB of frames and
// 8 MB of logits and write 138 MB of descriptors; the backward reads those
// inputs plus the 138 MB cotangent and writes dX, dL and dC₂.  Their products
// (about 4.3 and 12.8 GFLOP) would take a few µs on the tensor cores, so the
// bytes are the bound (chip_smoke.py derives the exact figures).  This
// simple version does its products as f32 FMAs on the CUDA cores, far above
// that bound (PERF.md has the times).
//
// Design.  A Hopper block has 227 KB of shared memory and blocks run in no
// order, so one video's f32 [1024, 256] block (1 MB) does not fit and no
// block may wait on another.  Each chain is cut into launches on one stream:
//
// forward (3 launches):
//  1. softmax_rows_kernel: A = softmax(L) for all B·F rows, one warp a row.
//  2. aggregate_kernel<T, false, true> (netvlad_core.cuh): per 32-cluster
//     tile of a video, Σ_D V₁² with A rounded to T in the product.
//  3. aggregate_kernel<T, true, true>: the tiles again, written normalised.
//
// backward (7 launches); every cross-tile sum is a separate pass over small
// scratch tensors, summed in a fixed order, so a run is deterministic:
//  1. softmax_rows_kernel, as above.
//  2. bwd_stats_kernel: per (32 clusters, 64 rows, video) tile, recompute V₁
//     and write the partial sums Σ V₁² and Σ V₁·dV₃ over the tile's rows.
//  3. bwd_scalars_kernel: per video, sum those partials into c_k = Σ_D V₁²
//     and p_k = Σ_D V₁·dV₃, then 1/‖V₁‖_k, 1/‖V₂‖_F, Σ(V₃⊙dV₃) and the
//     column term Σ_D V₂⊙dV₂ = c·g·(p_k − c·g·Σ(V₃⊙dV₃)·c_k), with
//     c = rsqrt(max(c_k, ε)) and g = 1/‖V₂‖_F.
//  4. bwd_dv1_kernel: per (32 clusters, 64 rows) tile and group of videos,
//     recompute V₁ and form dV₂ and dV₁ element by element as the TPU kernel
//     does; write dV₁ rounded to T [B, D, K], the partial sums of dV₁⊙C₂
//     for dS, and, summed over the group's videos in order, −dV₁⊙S.
//  5. bwd_dlogits_kernel: per 32 frames of a video, dA = X·round_T(dV₁) + dS
//     and the softmax VJP dL = A⊙(dA − Σ_K A⊙dA) as the epilogue (a row's K
//     values sit in one warp).
//  6. bwd_dx_kernel: dX = round_T(A)·round_T(dV₁)ᵀ per (32 frames, 64
//     columns) tile, written in T.
//  7. sum_groups_kernel: dC₂ = the groups' partials, summed in group order.
//
// Rounding follows the TPU kernels: A and dV₁ enter the products rounded to
// T, every sum is f32, every ε is max(·, 1e-12) under an rsqrt, and dL and
// dC₂ are f32.

#include "netvlad_core.cuh"

namespace lpm {

// ---------------------------------------------------------------- softmax --

// One warp per row of K <= 32·NJ logits.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
softmax_rows_kernel(const float* __restrict__ logits, float* __restrict__ a, long long M, int K) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  float v[NJ];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int k = lane + 32 * j;
    v[j] = k < K ? logits[row * K + k] : -INFINITY;
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
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int k = lane + 32 * j;
    if (k < K) a[row * K + k] = v[j] / s;
  }
}

// ------------------------------------------------------- V₁ tile recompute --

struct TileSmem {
  float a_s[kAggSamples][kAggClusters];
  __align__(16) float x_s[kAggSamples][kAggRows];
  float red[8][kAggClusters];
  float asum_s[kAggClusters];
};

// S_k = Σ_F A[f, k] of video row0/F for this thread's cluster k (0 if k >= K).
__device__ __forceinline__ float cluster_sum(const float* __restrict__ a, long long row0, int F,
                                             int K, int k, TileSmem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float p = 0.f;
  if (k < K)
    for (int s = warp; s < F; s += 8) p += a[(row0 + s) * K + k];
  sm.red[warp][lane] = p;
  __syncthreads();
  if (warp == 0) {
    float q = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) q += sm.red[w][lane];
    sm.asum_s[lane] = q;
  }
  __syncthreads();
  return sm.asum_s[lane];
}

// acc[i] = Σ_F X[f, d0 + 8w + i] · round_T(A[f, k0 + lane]) for warp w: one
// 64-row × 32-cluster tile of Xᵀ·A of the video whose rows start at row0.
template <typename T>
__device__ __forceinline__ void tile_xta(const T* __restrict__ x, const float* __restrict__ a,
                                         long long row0, int F, int D, int K, int k0, int d0,
                                         TileSmem& sm, float acc[8]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < F; s0 += kAggSamples) {
    const int sn = min(kAggSamples, F - s0);
    for (int i = tid; i < kAggSamples * kAggClusters; i += kThreads) {
      const int s = i / kAggClusters, kk = i % kAggClusters;
      sm.a_s[s][kk] = (s < sn && k0 + kk < K)
                          ? round_to<T, true>(a[(row0 + s0 + s) * K + k0 + kk])
                          : 0.f;
    }
    for (int i = tid; i < kAggSamples * kAggRows; i += kThreads) {
      const int s = i / kAggRows, dd = i % kAggRows;
      const int d = d0 + dd;
      sm.x_s[s][dd] = (s < sn && d < D) ? to_float(x[(row0 + s0 + s) * D + d]) : 0.f;
    }
    __syncthreads();
    for (int s = 0; s < sn; ++s) {
      const float av = sm.a_s[s][lane];
      const float4 xa = *reinterpret_cast<const float4*>(&sm.x_s[s][warp * 8]);
      const float4 xb = *reinterpret_cast<const float4*>(&sm.x_s[s][warp * 8 + 4]);
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
}

// Sum of v over the 8 warps for this lane's cluster, into out if the
// calling lane of warp 0 owns a valid cluster.
__device__ __forceinline__ void warps_sum_store(float v, float* out, bool valid, TileSmem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  sm.red[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && valid) {
    float q = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) q += sm.red[w][lane];
    *out = q;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- backward --

// grid (⌈K/32⌉, ⌈D/64⌉, B): partial Σ V₁² and Σ V₁·dV₃ over the tile's rows,
// at colsq_part / p_part [B, ⌈D/64⌉, K].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_stats_kernel(const T* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ c2, const T* __restrict__ dv3,
                 float* __restrict__ colsq_part, float* __restrict__ p_part, int F, int D, int K) {
  __shared__ TileSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z, k0 = blockIdx.x * kAggClusters, d0 = blockIdx.y * kAggRows;
  const int k = k0 + lane;
  const bool kvalid = k < K;
  const long long row0 = (long long)b * F;
  const float asum = cluster_sum(a, row0, F, K, k, sm);
  float acc[8];
  tile_xta<T>(x, a, row0, F, D, K, k0, d0, sm, acc);
  float cs = 0.f, p = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = d0 + warp * 8 + i;
    if (kvalid && d < D) {
      const float v1 = __fsub_rn(acc[i], __fmul_rn(asum, c2[(long long)d * K + k]));
      cs = fmaf(v1, v1, cs);
      p = fmaf(v1, to_float(dv3[((long long)b * D + d) * K + k]), p);
    }
  }
  const long long slot = ((long long)b * gridDim.y + blockIdx.y) * K + k;
  warps_sum_store(cs, colsq_part + slot, kvalid, sm);
  warps_sum_store(p, p_part + slot, kvalid, sm);
}

// grid (B): per-video scalars from the partials (see the head of the file).
// inv_c, qk [B, K]; vid [B, 2] = (1/‖V₂‖_F, Σ V₃⊙dV₃).
__global__ void __launch_bounds__(kThreads)
bwd_scalars_kernel(const float* __restrict__ colsq_part, const float* __restrict__ p_part,
                   float* __restrict__ inv_c, float* __restrict__ qk, float* __restrict__ vid,
                   int n_rows, int K) {
  __shared__ float cs_s[kMaxClusters], p_s[kMaxClusters];
  __shared__ float red[2][8];
  __shared__ float ig_s, g3_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  float tot = 0.f, gp = 0.f;
  for (int k = tid; k < K; k += kThreads) {
    float cs = 0.f, p = 0.f;
    for (int j = 0; j < n_rows; ++j) {
      const long long slot = ((long long)b * n_rows + j) * K + k;
      cs += colsq_part[slot];
      p += p_part[slot];
    }
    const float ic = rsqrtf(fmaxf(cs, kEps));
    cs_s[k] = cs;
    p_s[k] = p;
    inv_c[(long long)b * K + k] = ic;
    tot += cs * ic * ic;
    gp += ic * p;
  }
  tot = warp_sum(tot);
  gp = warp_sum(gp);
  if (lane == 0) {
    red[0][warp] = tot;
    red[1][warp] = gp;
  }
  __syncthreads();
  if (tid == 0) {
    float t = 0.f, g = 0.f;
    for (int w = 0; w < 8; ++w) {
      t += red[0][w];
      g += red[1][w];
    }
    const float ig = rsqrtf(fmaxf(t, kEps));
    ig_s = ig;
    g3_s = ig * g;
    vid[2 * b] = ig;
    vid[2 * b + 1] = ig * g;
  }
  __syncthreads();
  const float ig = ig_s, g3 = g3_s;
  for (int k = tid; k < K; k += kThreads) {
    const float ic = inv_c[(long long)b * K + k];
    const float cg = ic * ig;
    qk[(long long)b * K + k] = cg * (p_s[k] - cg * g3 * cs_s[k]);
  }
}

// grid (⌈K/32⌉, ⌈D/64⌉, n_groups): dV₁ per element for videos
// [g·per_group, (g+1)·per_group); writes dv1 [B, D, K] in T, ds_part
// [B, ⌈D/64⌉, K] = Σ_rows dV₁⊙C₂ and dc2_part [n_groups, D, K] = Σ_videos −dV₁⊙S.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dv1_kernel(const T* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ c2, const T* __restrict__ dv3,
               const float* __restrict__ inv_c, const float* __restrict__ qk,
               const float* __restrict__ vid, T* __restrict__ dv1,
               float* __restrict__ ds_part, float* __restrict__ dc2_part, int B, int F, int D,
               int K, int per_group) {
  __shared__ TileSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kAggClusters, d0 = blockIdx.y * kAggRows;
  const int k = k0 + lane;
  const bool kvalid = k < K;
  const int b_begin = blockIdx.z * per_group, b_end = min(B, b_begin + per_group);
  float c2v[8], dc2acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = d0 + warp * 8 + i;
    c2v[i] = (kvalid && d < D) ? c2[(long long)d * K + k] : 0.f;
    dc2acc[i] = 0.f;
  }
  for (int b = b_begin; b < b_end; ++b) {
    const long long row0 = (long long)b * F;
    const float asum = cluster_sum(a, row0, F, K, k, sm);
    float acc[8];
    tile_xta<T>(x, a, row0, F, D, K, k0, d0, sm, acc);
    const float ic = kvalid ? inv_c[(long long)b * K + k] : 0.f;
    const float q = kvalid ? qk[(long long)b * K + k] : 0.f;
    const float ig = vid[2 * b], g3 = vid[2 * b + 1];
    float dsp = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = d0 + warp * 8 + i;
      if (kvalid && d < D) {
        const long long at = ((long long)b * D + d) * K + k;
        const float v1 = __fsub_rn(acc[i], __fmul_rn(asum, c2v[i]));
        const float v2 = v1 * ic;
        const float v3 = v2 * ig;
        const float dv2 = (to_float(dv3[at]) - v3 * g3) * ig;
        const float g1 = (dv2 - v2 * q) * ic;
        dc2acc[i] += -g1 * asum;
        dsp = fmaf(g1, c2v[i], dsp);
        dv1[at] = from_float<T>(g1);
      }
    }
    warps_sum_store(dsp, ds_part + ((long long)b * gridDim.y + blockIdx.y) * K + k, kvalid, sm);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = d0 + warp * 8 + i;
    if (kvalid && d < D) dc2_part[((long long)blockIdx.z * D + d) * K + k] = dc2acc[i];
  }
}

// grid (⌈F/32⌉, B): dL for 32 frames of one video; thread (warp w, lane l)
// owns frames 4w..4w+3 and clusters l + 32j, j < NJ, as logits_softmax_kernel.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
bwd_dlogits_kernel(const T* __restrict__ x, const T* __restrict__ dv1,
                   const float* __restrict__ a, const float* __restrict__ ds_part,
                   float* __restrict__ dl, int F, int D, int K, int n_rows) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kLogitDepth][kXPitch]
  float* vs = xs + kLogitDepth * kXPitch;       // [kLogitDepth][K]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, f0 = blockIdx.x * kLogitRows;
  const long long row0 = (long long)b * F;

  float acc[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kLogitDepth) {
    for (int i = tid; i < kLogitRows * kLogitDepth; i += kThreads) {
      const int r = i / kLogitDepth, dd = i % kLogitDepth;
      const int f = f0 + r, d = d0 + dd;
      xs[dd * kXPitch + r] = (f < F && d < D) ? to_float(x[(row0 + f) * D + d]) : 0.f;
    }
    for (int i = tid; i < kLogitDepth * K; i += kThreads) {
      const int dd = i / K, kk = i - dd * K;
      const int d = d0 + dd;
      vs[i] = d < D ? to_float(dv1[((long long)b * D + d) * K + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < kLogitDepth; ++dd) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[dd * kXPitch + warp * 4]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kk = lane + 32 * j;
        const float vv = kk < K ? vs[dd * K + kk] : 0.f;
        acc[0][j] = fmaf(xv.x, vv, acc[0][j]);
        acc[1][j] = fmaf(xv.y, vv, acc[1][j]);
        acc[2][j] = fmaf(xv.z, vv, acc[2][j]);
        acc[3][j] = fmaf(xv.w, vv, acc[3][j]);
      }
    }
    __syncthreads();
  }

  float ds[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int kk = lane + 32 * j;
    float s = 0.f;
    if (kk < K)
      for (int jj = 0; jj < n_rows; ++jj) s += ds_part[((long long)b * n_rows + jj) * K + kk];
    ds[j] = -s;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int f = f0 + warp * 4 + r;
    const bool fvalid = f < F;
    float av[NJ], da[NJ];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kk = lane + 32 * j;
      av[j] = (fvalid && kk < K) ? a[(row0 + f) * K + kk] : 0.f;
      da[j] = acc[r][j] + ds[j];
      s = fmaf(av[j], da[j], s);
    }
    s = warp_sum(s);
    if (fvalid) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kk = lane + 32 * j;
        if (kk < K) dl[(row0 + f) * K + kk] = av[j] * (da[j] - s);
      }
    }
  }
}

constexpr int kDxRows = 32, kDxCols = 64, kDxDepth = 32;
constexpr int kDxPitch = kDxCols + 4;  // 16-byte rows, 4-way bank conflicts on the transposed store

// grid (⌈D/64⌉, ⌈F/32⌉, B): dX tile = round_T(A)·round_T(dV₁)ᵀ; thread t
// owns frame t/8 and columns 8·(t%8) .. +7 of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const float* __restrict__ a, const T* __restrict__ dv1, T* __restrict__ dx, int F,
              int D, int K) {
  __shared__ float a_s[kDxRows][kDxDepth + 1];
  __shared__ __align__(16) float v_s[kDxDepth][kDxPitch];
  const int tid = threadIdx.x;
  const int b = blockIdx.z, f0 = blockIdx.y * kDxRows, d0 = blockIdx.x * kDxCols;
  const int fl = tid / 8, dg = (tid % 8) * 8;
  const long long row0 = (long long)b * F;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kDxDepth) {
    for (int i = tid; i < kDxRows * kDxDepth; i += kThreads) {
      const int r = i / kDxDepth, kk = i % kDxDepth;
      a_s[r][kk] = (f0 + r < F && k0 + kk < K)
                       ? round_to<T, true>(a[(row0 + f0 + r) * K + k0 + kk])
                       : 0.f;
    }
    for (int i = tid; i < kDxCols * kDxDepth; i += kThreads) {
      const int dd = i / kDxDepth, kk = i % kDxDepth;
      v_s[kk][dd] = (d0 + dd < D && k0 + kk < K)
                        ? to_float(dv1[((long long)b * D + d0 + dd) * K + k0 + kk])
                        : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDxDepth; ++kk) {
      const float av = a_s[fl][kk];
      const float4 va = *reinterpret_cast<const float4*>(&v_s[kk][dg]);
      const float4 vb = *reinterpret_cast<const float4*>(&v_s[kk][dg + 4]);
      acc[0] = fmaf(av, va.x, acc[0]);
      acc[1] = fmaf(av, va.y, acc[1]);
      acc[2] = fmaf(av, va.z, acc[2]);
      acc[3] = fmaf(av, va.w, acc[3]);
      acc[4] = fmaf(av, vb.x, acc[4]);
      acc[5] = fmaf(av, vb.y, acc[5]);
      acc[6] = fmaf(av, vb.z, acc[6]);
      acc[7] = fmaf(av, vb.w, acc[7]);
    }
    __syncthreads();
  }
  const int f = f0 + fl;
  if (f < F) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = d0 + dg + i;
      if (d < D) dx[(row0 + f) * D + d] = from_float<T>(acc[i]);
    }
  }
}

// out[i] = Σ_g part[g, i] in group order.
__global__ void __launch_bounds__(kThreads)
sum_groups_kernel(const float* __restrict__ part, float* __restrict__ out, int n_groups,
                  long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int g = 0; g < n_groups; ++g) s += part[(long long)g * n + i];
  out[i] = s;
}

// ---------------------------------------------------------------- launch --

inline cudaError_t launch_softmax(const float* logits, float* a, long long M, int K,
                                  cudaStream_t st) {
  const unsigned grid = (unsigned)((M + kThreads / 32 - 1) / (kThreads / 32));
  const int nj = (K + 31) / 32;
  if (nj <= 1)
    softmax_rows_kernel<1><<<grid, kThreads, 0, st>>>(logits, a, M, K);
  else if (nj <= 2)
    softmax_rows_kernel<2><<<grid, kThreads, 0, st>>>(logits, a, M, K);
  else if (nj <= 4)
    softmax_rows_kernel<4><<<grid, kThreads, 0, st>>>(logits, a, M, K);
  else if (nj <= 8)
    softmax_rows_kernel<8><<<grid, kThreads, 0, st>>>(logits, a, M, K);
  else
    softmax_rows_kernel<16><<<grid, kThreads, 0, st>>>(logits, a, M, K);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_dlogits(const T* x, const T* dv1, const float* a, const float* ds_part,
                           float* dl, int B, int F, int D, int K, int n_rows, cudaStream_t st) {
  const size_t smem = (size_t)(kLogitDepth * kXPitch + kLogitDepth * K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(bwd_dlogits_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kLogitRows - 1) / kLogitRows, B);
  bwd_dlogits_kernel<T, NJ><<<grid, kThreads, smem, st>>>(x, dv1, a, ds_part, dl, F, D, K,
                                                          n_rows);
  return cudaGetLastError();
}

inline bool shape_ok(int B, int F, int D, int K) {
  return B >= 1 && B <= 65535 && F >= 1 && D >= 1 && K >= 1 && K <= kMaxClusters;
}

template <typename T>
cudaError_t train_forward(const T* x, const float* logits, const float* c2, T* out, float* ws_a,
                          float* ws_colsq, int B, int F, int D, int K, cudaStream_t st) {
  if (!shape_ok(B, F, D, K)) return cudaErrorInvalidValue;
  cudaError_t err = launch_softmax(logits, ws_a, (long long)B * F, K, st);
  if (err != cudaSuccess) return err;
  const dim3 grid((K + kAggClusters - 1) / kAggClusters, B);
  aggregate_kernel<T, false, true><<<grid, kThreads, 0, st>>>(x, D, ws_a, c2, ws_colsq, out, F,
                                                              D, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  aggregate_kernel<T, true, true><<<grid, kThreads, 0, st>>>(x, D, ws_a, c2, ws_colsq, out, F,
                                                             D, K);
  return cudaGetLastError();
}

struct BwdScratch {
  float* a;          // [B·F, K]
  float* colsq;      // [B, ⌈D/64⌉, K]
  float* p;          // [B, ⌈D/64⌉, K]
  float* inv_c;      // [B, K]
  float* qk;         // [B, K]
  float* vid;        // [B, 2]
  float* ds;         // [B, ⌈D/64⌉, K]
  float* dc2;        // [n_groups, D, K]
};

template <typename T>
cudaError_t train_backward(const T* x, const float* logits, const float* c2, const T* dv3, T* dx,
                           float* dl, float* dc2, T* ws_dv1, const BwdScratch& ws, int B, int F,
                           int D, int K, int n_groups, cudaStream_t st) {
  if (!shape_ok(B, F, D, K) || n_groups < 1 || n_groups > B) return cudaErrorInvalidValue;
  const int per_group = (B + n_groups - 1) / n_groups;
  const int n_rows = (D + kAggRows - 1) / kAggRows;
  const int k_tiles = (K + kAggClusters - 1) / kAggClusters;
  cudaError_t err = launch_softmax(logits, ws.a, (long long)B * F, K, st);
  if (err != cudaSuccess) return err;
  bwd_stats_kernel<T><<<dim3(k_tiles, n_rows, B), kThreads, 0, st>>>(x, ws.a, c2, dv3, ws.colsq,
                                                                     ws.p, F, D, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_scalars_kernel<<<B, kThreads, 0, st>>>(ws.colsq, ws.p, ws.inv_c, ws.qk, ws.vid, n_rows, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dv1_kernel<T><<<dim3(k_tiles, n_rows, n_groups), kThreads, 0, st>>>(
      x, ws.a, c2, dv3, ws.inv_c, ws.qk, ws.vid, ws_dv1, ws.ds, ws.dc2, B, F, D, K, per_group);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nj = (K + 31) / 32;
  if (nj <= 1)
    err = launch_dlogits<T, 1>(x, ws_dv1, ws.a, ws.ds, dl, B, F, D, K, n_rows, st);
  else if (nj <= 2)
    err = launch_dlogits<T, 2>(x, ws_dv1, ws.a, ws.ds, dl, B, F, D, K, n_rows, st);
  else if (nj <= 4)
    err = launch_dlogits<T, 4>(x, ws_dv1, ws.a, ws.ds, dl, B, F, D, K, n_rows, st);
  else if (nj <= 8)
    err = launch_dlogits<T, 8>(x, ws_dv1, ws.a, ws.ds, dl, B, F, D, K, n_rows, st);
  else
    err = launch_dlogits<T, 16>(x, ws_dv1, ws.a, ws.ds, dl, B, F, D, K, n_rows, st);
  if (err != cudaSuccess) return err;
  const dim3 gdx((D + kDxCols - 1) / kDxCols, (F + kDxRows - 1) / kDxRows, B);
  bwd_dx_kernel<T><<<gdx, kThreads, 0, st>>>(ws.a, ws_dv1, dx, F, D, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = (long long)D * K;
  sum_groups_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(ws.dc2, dc2,
                                                                                   n_groups, n);
  return cudaGetLastError();
}

}  // namespace lpm

extern "C" int lpm_netvlad_train_forward(const void* x, int x_is_bf16, const void* logits,
                                         const void* c2, void* out, void* ws_a, void* ws_colsq,
                                         int B, int F, int D, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(logits);
  const float* cc2 = static_cast<const float*>(c2);
  float* wa = static_cast<float*>(ws_a);
  float* wc = static_cast<float*>(ws_colsq);
  if (x_is_bf16) {
    using bf16 = __nv_bfloat16;
    return (int)lpm::train_forward<bf16>(static_cast<const bf16*>(x), l, cc2,
                                         static_cast<bf16*>(out), wa, wc, B, F, D, K, st);
  }
  return (int)lpm::train_forward<float>(static_cast<const float*>(x), l, cc2,
                                        static_cast<float*>(out), wa, wc, B, F, D, K, st);
}

extern "C" int lpm_netvlad_train_backward(const void* x, int x_is_bf16, const void* logits,
                                          const void* c2, const void* dv3, void* dx, void* dl,
                                          void* dc2, void* ws_dv1, void* ws_a, void* ws_colsq,
                                          void* ws_p, void* ws_inv_c, void* ws_qk, void* ws_vid,
                                          void* ws_ds, void* ws_dc2, int B, int F, int D, int K,
                                          int n_groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const lpm::BwdScratch ws{static_cast<float*>(ws_a),     static_cast<float*>(ws_colsq),
                           static_cast<float*>(ws_p),     static_cast<float*>(ws_inv_c),
                           static_cast<float*>(ws_qk),    static_cast<float*>(ws_vid),
                           static_cast<float*>(ws_ds),    static_cast<float*>(ws_dc2)};
  const float* l = static_cast<const float*>(logits);
  const float* cc2 = static_cast<const float*>(c2);
  float* dlf = static_cast<float*>(dl);
  float* dc2f = static_cast<float*>(dc2);
  if (x_is_bf16) {
    using bf16 = __nv_bfloat16;
    return (int)lpm::train_backward<bf16>(static_cast<const bf16*>(x), l, cc2,
                                          static_cast<const bf16*>(dv3), static_cast<bf16*>(dx),
                                          dlf, dc2f, static_cast<bf16*>(ws_dv1), ws, B, F, D, K,
                                          n_groups, st);
  }
  return (int)lpm::train_backward<float>(static_cast<const float*>(x), l, cc2,
                                         static_cast<const float*>(dv3), static_cast<float*>(dx),
                                         dlf, dc2f, static_cast<float*>(ws_dv1), ws, B, F, D, K,
                                         n_groups, st);
}
