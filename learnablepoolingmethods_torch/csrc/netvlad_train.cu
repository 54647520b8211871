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
// (about 4.3 and 12.8 GFLOP) take a few µs on the tensor cores, so the
// bytes are the bound (chip_smoke.py derives the exact figures).
//
// bf16 (the main path), on tensor cores; the products' operands are bf16
// and their sums f32, which are exactly the TPU kernel's rounding points:
//
// forward (2 launches):
//  1. softmax_rows_kernel: A = softmax(L) for all B·F rows, one warp a row.
//  2. netvlad_tc.cuh's aggregation with A rounded to bf16 once (kSplitA
//     false: one mma where inference takes A_hi + A_lo), rows of stride D:
//     the one-pass cluster kernel where a video's blocks fit a portable
//     cluster (Willow's rgb 8 blocks, audio 1), else the two-pass kernel.
//
// backward (4 launches, 5 past a portable cluster):
//  1. softmax_rows_kernel, as above.
//  2. tc_bwd_kernel<.., 0>: per video, Xᵀ·round(A) once on tensor cores into
//     registers (the forward's tiling: a warp holds 64 rows × 32 clusters),
//     then two sweeps over the tile.  The first forms V₁ = acc − S⊙C₂ and
//     per cluster c_k = Σ_D V₁², p_k = Σ_D V₁·dV₃, Σ_D dV₃·C₂ and
//     Σ_D V₁·C₂ (C₂ read through L2, dV₃ from device memory, both in the
//     fragments' layout).  The video's blocks form a thread-block cluster:
//     each publishes Σ_k c_k/‖V₁‖_k² and Σ_k p_k/‖V₁‖_k, and every block
//     reads them in rank order through distributed shared memory, so all
//     see the same 1/‖V₂‖_F and Σ(V₃⊙dV₃).  Per cluster then
//     q_k = Σ_D V₂⊙dV₂ = c·g·(p_k − c·g·Σ(V₃⊙dV₃)·c_k) (c = 1/‖V₁‖_k,
//     g = 1/‖V₂‖_F), and dS's Σ_D dV₁·C₂ from the two column sums, so the
//     second sweep needs no C₂: it reads the block's dV₃ slice again, now
//     from L2 (64 KB a block for rgb), forms dV₂ and dV₁ element by
//     element, writes dV₁ rounded to bf16 once to a scratch [B, D, K], and
//     adds −dV₁⊙S into an f32 [rows, clusters] accumulator in shared memory
//     (128 KB at rgb) that the block keeps over all its videos.  The
//     clusters are persistent, as many as fit the card at once: cluster y
//     walks videos y, y + G, ..., so group y's dC₂ partial holds a fixed
//     set of videos, summed in order.  Past a portable cluster (K > 256 at
//     D = 1024, or D > 1024) two passes, tc_bwd_kernel<.., 1> writing c_k
//     and p_k partials to [B, dchunks, K] and tc_bwd_kernel<.., 2>
//     recomputing Xᵀ·round(A) and summing every partial of its video in a
//     fixed order.  What holds it back: one 512-thread block an SM (its
//     tile takes half the register file, its accumulator most of the shared
//     memory) runs one video's loads, reductions, cluster barrier and
//     stores at a time, at about 40 µs a video for rgb (PERF.md).
//  3. tc_bwd_gemm_kernel: per 32 frames of a video, streaming round(dV₁)
//     through a cp.async ring in 32-row stages, once: dA = X·round(dV₁) on
//     mma.sync (the block holds a row's whole K), and for each stage the
//     [32 frames × 32 columns] of dX = round(A)·round(dV₁)ᵀ, written in bf16;
//     then dA + dS and the softmax VJP dL = A⊙(dA − Σ_K A⊙dA) as the
//     epilogue, the row sums over the warps in a fixed order.  dX's sum over
//     K is whole inside the block, so no cross-block reduction of dX is
//     needed: this is the design with a bf16 scratch of round(dV₁) (142 MB
//     at Willow rgb, B=256), against reducing f32 [F, D] partials of dX
//     across the cluster's blocks (PERF.md has the times).
//  4. sum_groups_kernel: dC₂ = the G groups' partials, summed in group order.
//
// So a video's Xᵀ·A is computed once (twice past a portable cluster), dV₃
// crosses device memory once, every product runs on tensor cores, and no
// float atomics are used: two launches give the same bits.
//
// f32 (the 1e-5 checks): the first port's FMA code, as ROADMAP's rule for
// every redesign keeps it.  A Hopper block has 227 KB of shared memory and
// blocks run in no order, so each chain is cut into launches on one stream:
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

#include "netvlad_tc.cuh"

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

// ------------------------------------------------ bf16 on tensor cores --

// dC₂ partial slots of the bf16 backward: at most min(B, 2²² / (D·K))
// groups of videos (16 MB of f32 slots; 16 at Willow rgb, 256 at audio,
// B=256), and for the one-pass kernel at most the clusters that fit the
// card at once (launch_tc_bwd).  ops/netvlad_train.py#train_geometry
// mirrors the first bound, which sizes the scratch.
constexpr long long kDc2SlotFloats = 1ll << 22;

__host__ __device__ inline int train_groups(int B, int D, int K) {
  long long g = kDc2SlotFloats / ((long long)D * K);
  if (g < 1) g = 1;
  return (int)(g < B ? g : B);
}

// n8 tiles of clusters per warp in tc_bwd_gemm_kernel: 8 warps × 8·NT ≥ K
__host__ __device__ inline int gemm_nt(int K) { return K <= 64 ? 1 : K <= 128 ? 2 : K <= 256 ? 4 : 8; }

struct BwSmem {
  int xpitch, apitch, dc2, stage, total;  // xpitch bf16, apitch f32; the rest bytes
};

__host__ __device__ inline BwSmem bw_smem(const TaGeometry& geo) {
  BwSmem s;
  s.xpitch = 64 * geo.ds + 8;
  s.apitch = geo.kc + 4;
  s.dc2 = (int)sizeof(float) * 64 * geo.ds * geo.kc;
  s.stage = (int)sizeof(bf16) * kTpSamples * s.xpitch + (int)sizeof(float) * kTpSamples * s.apitch;
  // then floats: red, red2, red3, red4 [ds][kc], asum, ic, q [kc], wsum [2][16], tot [2][2],
  // peer [8][2]
  s.total = s.dc2 + kTpStages * s.stage +
            (int)sizeof(float) * (4 * geo.ds * geo.kc + 3 * geo.kc + 2 * kTaMaxWarps + 4 +
                                  2 * kTaMaxCluster);
  return s;
}

// Clusters kk and kk + 1 of a row of a [rows, K] tensor at p + kk, or 0
// where ok0 / ok1 is false (past the rows or clusters of the block); kVec:
// K % 8 == 0 and p 8-byte aligned, so ok0 implies ok1 and one paired load
template <bool kVec>
__device__ __forceinline__ float2 pair_f32(const float* __restrict__ p, bool ok0, bool ok1) {
  if (kVec) return ok0 ? __ldg(reinterpret_cast<const float2*>(p)) : make_float2(0.f, 0.f);
  return make_float2(ok0 ? __ldg(p) : 0.f, ok1 ? __ldg(p + 1) : 0.f);
}

template <bool kVec>
__device__ __forceinline__ float2 pair_bf16(const bf16* __restrict__ p, bool ok0, bool ok1) {
  if (kVec)
    return ok0 ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p)) : make_float2(0.f, 0.f);
  return make_float2(ok0 ? __bfloat162float(p[0]) : 0.f, ok1 ? __bfloat162float(p[1]) : 0.f);
}

// p, opaque to the compiler: the address arithmetic of a video's loads is
// not hoisted out of the video loop (32 addresses a thread held across
// videos spilled hundreds of bytes)
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// A compiler barrier: memory accesses are not moved across it, so the
// first sweep's loads (C₂ and dV₃) of one 8-cluster column of a warp's
// tile are in flight at a time beside the 64 accumulators, under the
// 128-register cap; the second sweep's (dV₃ alone) all fly together
__device__ __forceinline__ void column_barrier() { asm volatile("" ::: "memory"); }

// The backward's V₁ pass.  Grid (ktiles, G, dchunks), geo.threads threads;
// kPass 0: one pass, clusters of ktiles blocks (dchunks == 1); kPass 1:
// c_k and p_k partials to colsq, pk [B, dchunks, K]; kPass 2: the same
// tiles again, the partials summed in a fixed order, then dV₁.  Passes 0
// and 2 write round(dV₁) to dv1 [B, D, K], Σ_rows dV₁·C₂ to ds [B, dchunks,
// K] and group blockIdx.y's Σ_videos −dV₁⊙S to dc2_part [G, D, K].  The
// fragment layout and the ring are tc_aggregate_cluster_kernel's.
template <bool kAsync, int kPass>
__global__ void __launch_bounds__(32 * kTaMaxWarps, 1)
tc_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ a, const float* __restrict__ c2,
              const bf16* __restrict__ dv3, bf16* __restrict__ dv1, float* __restrict__ colsq,
              float* __restrict__ pk, float* __restrict__ ds, float* __restrict__ dc2_part, int B,
              int S, int D, int K, TaGeometry geo) {
  extern __shared__ float4 bw_smem4[];
  const BwSmem sm = bw_smem(geo);
  char* base = reinterpret_cast<char*>(bw_smem4);
  float* dc2s = reinterpret_cast<float*>(base);  // Σ_videos −dV₁⊙S [64·ds][kc], swizzled as tp_c2_index
  char* ring = base + sm.dc2;                    // stages of X [16][xpitch] bf16, A [16][apitch] f32
  float* red = reinterpret_cast<float*>(ring + kTpStages * sm.stage);  // [ds][kc]
  float* red2 = red + geo.ds * geo.kc;                                 // [ds][kc]
  float* red3 = red2 + geo.ds * geo.kc;                                // [ds][kc]
  float* red4 = red3 + geo.ds * geo.kc;                                // [ds][kc]
  float* asum_s = red4 + geo.ds * geo.kc;
  float* ic_s = asum_s + geo.kc;
  float* q_s = ic_s + geo.kc;
  float* wsum = q_s + geo.kc;              // [2][16]
  float* tot_s = wsum + 2 * kTaMaxWarps;   // [video parity][2]: this block's partials
  float* peer = tot_s + 4;                 // [ktiles][2]: the cluster's partials of this video

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthreads = geo.threads;
  const int g = lane >> 2, t = lane & 3;
  const int dslab = warp % geo.ds, cslab = warp / geo.ds;
  const int kc = geo.kc, k0 = blockIdx.x * kc, kn = min(kc, K - k0);
  const int dc = blockIdx.z, d_lo = dc * kTaChunkRows, dn = min(64 * geo.ds, D - d_lo);
  const int first = blockIdx.y, stride = gridDim.y;
  const int nch = (S + kTpSamples - 1) / kTpSamples;
  const int nv = (B - first + stride - 1) / stride;
  const int total = nv * nch;
  const int part = tid / kc, col = tid % kc;  // a_sum: part ∈ [0, ds)

  // this thread's rows of the tile are dd0 + 16·mi + 8·hr, its clusters
  // cslab·32 + 8·ni + 2t (+1): the mma fragments' entries, which it alone
  // reads and writes in dc2s
  const int dd0 = dslab * 64 + g;
  if (kPass != 1)
    for (int i = tid; i < 64 * geo.ds * kc; i += nthreads) dc2s[i] = 0.f;

  const int xs_row = tid / (8 * geo.ds), xc = (tid % (8 * geo.ds)) * 8;
  const int as_row = tid / (8 * geo.cs), ac = (tid % (8 * geo.cs)) * 4;
  auto load = [&](int j) {
    bf16* xs = reinterpret_cast<bf16*>(ring + (j % kTpStages) * sm.stage);
    float* as = reinterpret_cast<float*>(xs + kTpSamples * sm.xpitch);
    const long long row0 = (long long)(first + (j / nch) * stride) * S;
    const int s0 = (j % nch) * kTpSamples, width = 64 * geo.ds;
    if (kAsync) {
      for (int s = xs_row; s < kTpSamples; s += 4 * geo.cs) {
        const bool ok = s0 + s < S && xc < dn;
        cp_async_16(smem_addr(xs + s * sm.xpitch + xc),
                    ok ? x + (row0 + s0 + s) * D + d_lo + xc : x, ok ? 16 : 0);
      }
      for (int s = as_row; s < kTpSamples; s += 4 * geo.ds) {
        const bool ok = s0 + s < S && ac < kn;
        cp_async_16(smem_addr(as + s * sm.apitch + ac), ok ? a + (row0 + s0 + s) * K + k0 + ac : a,
                    ok ? 16 : 0);
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int i = tid; i < kTpSamples * width; i += nthreads) {
        const int s = i / width, dd = i % width;
        xs[s * sm.xpitch + dd] = s0 + s < S && dd < dn ? x[(row0 + s0 + s) * D + d_lo + dd] : zero;
      }
      for (int i = tid; i < kTpSamples * kc; i += nthreads) {
        const int s = i / kc, kk = i % kc;
        as[s * sm.apitch + kk] = s0 + s < S && kk < kn ? a[(row0 + s0 + s) * K + k0 + kk] : 0.f;
      }
    }
  };

  const int a_row = (lane & 7) + ((lane >> 4) & 1) * 8, a_col = ((lane >> 3) & 1) * 8;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  for (int s = 0; s < kTpStages - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  const float* const c2r0 = c2 + ((long long)d_lo + dd0) * K + k0;
  int j = 0;
  for (int v = 0; v < nv; ++v) {
    const int b = first + v * stride;
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    float asum = 0.f;

    // acc = Xᵀ·round(A), one mma per fragment: A rounded to bf16 once
    for (int q = 0; q < nch; ++q, ++j) {
      cp_async_wait<kTpStages - 2>();
      __syncthreads();
      if (j + kTpStages - 1 < total) load(j + kTpStages - 1);
      cp_async_commit();
      const bf16* xs = reinterpret_cast<const bf16*>(ring + (j % kTpStages) * sm.stage);
      const float* as = reinterpret_cast<const float*>(xs + kTpSamples * sm.xpitch);
      for (int s = part; s < kTpSamples; s += geo.ds) asum += as[s * sm.apitch + col];
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(af[mi],
                          smem_addr(xs + a_row * sm.xpitch + dslab * 64 + 16 * mi + a_col));
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* ap = as + cslab * 32 + 8 * ni + g;
        const uint32_t b01 = pack_bf16(ap[(2 * t) * sm.apitch], ap[(2 * t + 1) * sm.apitch]);
        const uint32_t b23 = pack_bf16(ap[(2 * t + 8) * sm.apitch], ap[(2 * t + 9) * sm.apitch]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16_16816(acc[mi][ni], af[mi], b01, b23);
      }
    }

    red[part * kc + col] = asum;
    __syncthreads();
    if (tid < kc) {
      float parts[kTaMaxWarps];
#pragma unroll
      for (int p = 0; p < kTaMaxWarps; ++p) parts[p] = p < geo.ds ? red[p * kc + tid] : 0.f;
      asum_s[tid] = tree_sum16(parts);
    }
    __syncthreads();

    // V₁ = acc − S⊙C₂ in place (0 outside the block's rows and clusters);
    // per cluster Σ_rows V₁² → red, Σ_rows V₁·dV₃ → red2, and for dS
    // Σ_rows dV₃·C₂ → red3, Σ_rows V₁·C₂ → red4
    const float* c2r = opaque(c2r0);
    const bf16* dv3r = dv3 + ((long long)b * D + d_lo + dd0) * K + k0;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int kk = cslab * 32 + 8 * ni + 2 * t;
      const float as0 = asum_s[kk], as1 = asum_s[kk + 1];
      float cs0 = 0.f, cs1 = 0.f, p0 = 0.f, p1 = 0.f, e0 = 0.f, e1 = 0.f, f0 = 0.f, f1 = 0.f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const bool row = dd0 + 16 * mi + 8 * hr < dn;
          const bool ok0 = row && kk < kn, ok1 = row && kk + 1 < kn;
          const int off = (16 * mi + 8 * hr) * K + kk;
          float* vv = &acc[mi][ni][2 * hr];
          const float2 c = pair_f32<kAsync>(c2r + off, ok0, ok1);
          vv[0] = ok0 ? __fsub_rn(vv[0], __fmul_rn(as0, c.x)) : 0.f;
          vv[1] = ok1 ? __fsub_rn(vv[1], __fmul_rn(as1, c.y)) : 0.f;
          cs0 = fmaf(vv[0], vv[0], cs0);
          cs1 = fmaf(vv[1], vv[1], cs1);
          const float2 w = pair_bf16<kAsync>(dv3r + off, ok0, ok1);
          p0 = fmaf(vv[0], w.x, p0);
          p1 = fmaf(vv[1], w.y, p1);
          if (kPass != 1) {
            e0 = fmaf(w.x, c.x, e0);
            e1 = fmaf(w.y, c.y, e1);
            f0 = fmaf(vv[0], c.x, f0);
            f1 = fmaf(vv[1], c.y, f1);
          }
        }
      column_barrier();
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
        cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
        p0 += __shfl_xor_sync(0xffffffffu, p0, o);
        p1 += __shfl_xor_sync(0xffffffffu, p1, o);
        if (kPass != 1) {
          e0 += __shfl_xor_sync(0xffffffffu, e0, o);
          e1 += __shfl_xor_sync(0xffffffffu, e1, o);
          f0 += __shfl_xor_sync(0xffffffffu, f0, o);
          f1 += __shfl_xor_sync(0xffffffffu, f1, o);
        }
      }
      if (g == 0) {
        red[dslab * kc + kk] = cs0;
        red[dslab * kc + kk + 1] = cs1;
        red2[dslab * kc + kk] = p0;
        red2[dslab * kc + kk + 1] = p1;
        if (kPass != 1) {
          red3[dslab * kc + kk] = e0;
          red3[dslab * kc + kk + 1] = e1;
          red4[dslab * kc + kk] = f0;
          red4[dslab * kc + kk + 1] = f1;
        }
      }
    }
    __syncthreads();

    float c_own = 0.f, p_own = 0.f;  // thread tid < kn: cluster k0 + tid
    if (kPass != 2 && tid < kn) {
      float r1[kTaMaxWarps], r2[kTaMaxWarps];
#pragma unroll
      for (int p = 0; p < kTaMaxWarps; ++p) {
        r1[p] = p < geo.ds ? red[p * kc + tid] : 0.f;
        r2[p] = p < geo.ds ? red2[p * kc + tid] : 0.f;
      }
      c_own = tree_sum16(r1);
      p_own = tree_sum16(r2);
    }
    if (kPass == 1) {
      if (tid < kn) {
        const long long at = ((long long)b * gridDim.z + dc) * K + k0 + tid;
        colsq[at] = c_own;
        pk[at] = p_own;
      }
      continue;  // the next video's first __syncthreads orders the reuse of red
    }

    // the video's Σ_k c_k·ic_k² and Σ_k ic_k·p_k
    float tot, gp;
    if (kPass == 0) {
      float ccon = 0.f, pcon = 0.f;
      if (tid < kn) {
        const float ic = rsqrtf(fmaxf(c_own, kEps));
        ic_s[tid] = ic;
        ccon = c_own * ic * ic;
        pcon = ic * p_own;
      }
      ccon = warp_sum(ccon);
      pcon = warp_sum(pcon);
      if (lane == 0) {
        wsum[warp] = ccon;
        wsum[kTaMaxWarps + warp] = pcon;
      }
      __syncthreads();
      if (tid == 0) {
        float sc = 0.f, sp = 0.f;
        for (int w = 0; w < (kc + 31) / 32; ++w) {
          sc += wsum[w];
          sp += wsum[kTaMaxWarps + w];
        }
        tot_s[2 * (v & 1)] = sc;
        tot_s[2 * (v & 1) + 1] = sp;
      }
      // as in tc_aggregate_cluster_kernel: one cluster barrier a video
      cluster.sync();
      if (tid < 2 * geo.ktiles)
        peer[tid] = *cluster.map_shared_rank(tot_s + 2 * (v & 1) + (tid & 1), tid >> 1);
      __syncthreads();
      tot = 0.f;
      gp = 0.f;
      for (int r = 0; r < geo.ktiles; ++r) {
        tot += peer[2 * r];
        gp += peer[2 * r + 1];
      }
    } else {
      // every block of the video forms the same sums from the pass-1
      // partials, in the same order; its own clusters' c_k, p_k → red, red2
      float qc = 0.f, qp = 0.f;
      for (int k = tid; k < K; k += nthreads) {
        float c = 0.f, p = 0.f;
        for (int h = 0; h < gridDim.z; ++h) {
          c += colsq[((long long)b * gridDim.z + h) * K + k];
          p += pk[((long long)b * gridDim.z + h) * K + k];
        }
        const float ic = rsqrtf(fmaxf(c, kEps));
        qc += c * ic * ic;
        qp += ic * p;
        if (k >= k0 && k < k0 + kn) {
          ic_s[k - k0] = ic;
          red[k - k0] = c;
          red2[k - k0] = p;
        }
      }
      qc = warp_sum(qc);
      qp = warp_sum(qp);
      if (lane == 0) {
        wsum[warp] = qc;
        wsum[kTaMaxWarps + warp] = qp;
      }
      __syncthreads();
      tot = 0.f;
      gp = 0.f;
      for (int w = 0; w < nthreads / 32; ++w) {
        tot += wsum[w];
        gp += wsum[kTaMaxWarps + w];
      }
      if (tid < kn) {
        c_own = red[tid];
        p_own = red2[tid];
      }
    }
    const float ig = rsqrtf(fmaxf(tot, kEps)), g3 = ig * gp;
    if (tid < kn) {
      // q_k = Σ_D V₂⊙dV₂, and Σ_rows dV₁·C₂ from the column sums:
      // c·(Σ dV₂·C₂ − q·Σ V₂·C₂) with Σ dV₂·C₂ = g·(Σ dV₃·C₂ − g·G·c·Σ V₁·C₂)
      const float ic = ic_s[tid], cg = ic * ig;
      const float q = cg * (p_own - cg * g3 * c_own);
      q_s[tid] = q;
      float r3[kTaMaxWarps], r4[kTaMaxWarps];
#pragma unroll
      for (int p = 0; p < kTaMaxWarps; ++p) {
        r3[p] = p < geo.ds ? red3[p * kc + tid] : 0.f;
        r4[p] = p < geo.ds ? red4[p * kc + tid] : 0.f;
      }
      const float e = tree_sum16(r3), f = tree_sum16(r4);
      ds[((long long)b * gridDim.z + dc) * K + k0 + tid] =
          ic * (ig * (e - ig * g3 * ic * f) - q * ic * f);
    }
    __syncthreads();

    // dV₂ = (dV₃ − V₃·Σ(V₃⊙dV₃))·g, dV₁ = (dV₂ − V₂·q_k)·c per element;
    // round(dV₁) → dv1, −dV₁·S → dc2s
    bf16* dv1r = dv1 + ((long long)b * D + d_lo + dd0) * K + k0;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int kk = cslab * 32 + 8 * ni + 2 * t;
      const bool in0 = kk < kn, in1 = kk + 1 < kn;
      const float ic0 = in0 ? ic_s[kk] : 0.f, ic1 = in1 ? ic_s[kk + 1] : 0.f;
      const float q0 = in0 ? q_s[kk] : 0.f, q1 = in1 ? q_s[kk + 1] : 0.f;
      const float as0 = asum_s[kk], as1 = asum_s[kk + 1];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int dd = dd0 + 16 * mi + 8 * hr;
          const bool row = dd < dn;
          const bool ok0 = row && in0, ok1 = row && in1;
          const int off = (16 * mi + 8 * hr) * K + kk;
          const float* vv = &acc[mi][ni][2 * hr];
          const float2 w = pair_bf16<kAsync>(dv3r + off, ok0, ok1);
          const float v20 = vv[0] * ic0, v21 = vv[1] * ic1;
          const float dv20 = (w.x - v20 * ig * g3) * ig, dv21 = (w.y - v21 * ig * g3) * ig;
          const float g10 = ok0 ? (dv20 - v20 * q0) * ic0 : 0.f;
          const float g11 = ok1 ? (dv21 - v21 * q1) * ic1 : 0.f;
          float2* acc2 = reinterpret_cast<float2*>(dc2s + tp_c2_index(dd, kk, kc));
          const float2 old = *acc2;
          *acc2 = make_float2(old.x + -g10 * as0, old.y + -g11 * as1);
          bf16* o = dv1r + off;
          if (kAsync) {
            if (ok0) *reinterpret_cast<uint32_t*>(o) = pack_bf16(g10, g11);
          } else {
            if (ok0) o[0] = __float2bfloat16_rn(g10);
            if (ok1) o[1] = __float2bfloat16_rn(g11);
          }
        }
    }
  }
  cp_async_wait<0>();
  if (kPass != 1) {
    // each thread wrote only its own fragments' entries of dc2s
    float* part_out = dc2_part + ((long long)blockIdx.y * D + d_lo + dd0) * K + k0;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int kk = cslab * 32 + 8 * ni + 2 * t;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int dd = dd0 + 16 * mi + 8 * hr;
          if (dd >= dn || kk >= kn) continue;
          const float2 val = *reinterpret_cast<const float2*>(dc2s + tp_c2_index(dd, kk, kc));
          float* o = part_out + (16 * mi + 8 * hr) * K + kk;
          if (kAsync) {
            *reinterpret_cast<float2*>(o) = val;
          } else {
            o[0] = val.x;
            if (kk + 1 < kn) o[1] = val.y;
          }
        }
    }
  }
  if (kPass == 0) cluster.sync();  // no block leaves while another may still read its partials
}

// dA/dL and dX from round(dV₁): 32 frames of one video a block, 8 warps.
constexpr int kGxRows = 32;    // frames a block (two m16 tiles)
constexpr int kGxDepth = 32;   // D rows of round(dV₁) (and X columns) a ring stage
constexpr int kGxStages = 3;
constexpr int kGxThreads = 256;
constexpr int kGxXPitch = kGxDepth + 8;  // bf16, an odd number of 16-byte chunks

template <int NT>
struct GxShape {
  static constexpr int BN = 8 * 8 * NT;  // clusters a block (≥ K): 8 warps × NT n8 tiles
  static constexpr int Pitch = BN + 8;   // bf16 rows of the dV₁ stage and of round(A)
  static constexpr int Stage = kGxRows * kGxXPitch + kGxDepth * Pitch;  // bf16
  static constexpr size_t Smem = sizeof(bf16) * (kGxStages * Stage + kGxRows * Pitch);
};

// Grid (⌈F/32⌉, B).  Stage s holds X [32 frames][32 columns d] and round(dV₁)
// [32 rows d][BN clusters] of columns d ∈ [32s, 32s + 32).  Per stage:
//  - dA += X·round(dV₁): warp w owns clusters [8·NT·w, 8·NT·(w+1)) of all 32
//    frames, X entering through ldmatrix, dV₁ through ldmatrix.trans;
//  - dX of the stage's 32 columns = round(A)·round(dV₁)ᵀ over all K: warp w
//    owns frames 16·(w % 2) .. +16 and columns 8·(w / 2) .. +8, round(A)
//    from its [32][BN] bf16 tile, dV₁ through ldmatrix (rows d are the
//    product's n); written in bf16 as soon as the stage is done.
// Epilogue: dA + dS (dS_k = −Σ of the dchunks partials of ds, in order) and
// dL = A⊙(dA − Σ_K A⊙dA), A f32; a row's K values lie in the quads of the
// 8 warps, summed by shuffles and then over the warps in order.
template <bool kAsync, int NT>
__global__ void __launch_bounds__(kGxThreads)
tc_bwd_gemm_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                   const bf16* __restrict__ dv1, const float* __restrict__ ds,
                   bf16* __restrict__ dx, float* __restrict__ dl, int F, int D, int K,
                   int dchunks) {
  using Sh = GxShape<NT>;
  extern __shared__ float4 gx_smem4[];
  bf16* ring = reinterpret_cast<bf16*>(gx_smem4);
  bf16* ar = ring + kGxStages * Sh::Stage;  // round(A) [32][Pitch]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, f0 = blockIdx.x * kGxRows, rows = min(kGxRows, F - f0);
  const long long row0 = (long long)b * F + f0;
  const bf16* vb = dv1 + (long long)b * D * K;

  for (int i = tid; i < kGxRows * Sh::BN; i += kGxThreads) {
    const int r = i / Sh::BN, kk = i % Sh::BN;
    ar[r * Sh::Pitch + kk] = __float2bfloat16_rn(r < rows && kk < K ? a[(row0 + r) * K + kk] : 0.f);
  }

  const int nk = (D + kGxDepth - 1) / kGxDepth;
  auto load = [&](int step) {
    bf16* xs = ring + (step % kGxStages) * Sh::Stage;
    bf16* vs = xs + kGxRows * kGxXPitch;
    const int d0 = step * kGxDepth;
    if (kAsync) {
      for (int i = tid; i < kGxRows * (kGxDepth / 8); i += kGxThreads) {
        const int r = i / (kGxDepth / 8), cc = (i % (kGxDepth / 8)) * 8;
        const bool ok = r < rows && d0 + cc < D;
        cp_async_16(smem_addr(xs + r * kGxXPitch + cc), ok ? x + (row0 + r) * D + d0 + cc : x,
                    ok ? 16 : 0);
      }
      for (int i = tid; i < kGxDepth * (Sh::BN / 8); i += kGxThreads) {
        const int r = i / (Sh::BN / 8), cc = (i % (Sh::BN / 8)) * 8;
        const bool ok = d0 + r < D && cc < K;
        cp_async_16(smem_addr(vs + r * Sh::Pitch + cc), ok ? vb + (long long)(d0 + r) * K + cc : vb,
                    ok ? 16 : 0);
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int i = tid; i < kGxRows * kGxDepth; i += kGxThreads) {
        const int r = i / kGxDepth, dd = i % kGxDepth;
        xs[r * kGxXPitch + dd] = r < rows && d0 + dd < D ? x[(row0 + r) * D + d0 + dd] : zero;
      }
      for (int i = tid; i < kGxDepth * Sh::BN; i += kGxThreads) {
        const int r = i / Sh::BN, kk = i % Sh::BN;
        vs[r * Sh::Pitch + kk] = d0 + r < D && kk < K ? vb[(long long)(d0 + r) * K + kk] : zero;
      }
    }
  };

  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3), b_col = (lane >> 4) * 8;
  const int xm = warp & 1, xn = warp >> 1;  // this warp's dX tile

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int s = 0; s < kGxStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < nk; ++step) {
    cp_async_wait<kGxStages - 2>();
    __syncthreads();  // this step's stage (and round(A)) landed for all; the one loaded next was freed
    if (step + kGxStages - 1 < nk) load(step + kGxStages - 1);
    cp_async_commit();
    const bf16* xs = ring + (step % kGxStages) * Sh::Stage;
    const bf16* vs = xs + kGxRows * kGxXPitch;
#pragma unroll
    for (int ks = 0; ks < kGxDepth / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], smem_addr(xs + (16 * mi + a_row) * kGxXPitch + 16 * ks + a_col));
#pragma unroll
      for (int np = 0; np < NT / 2 + (NT & 1); ++np) {
        uint32_t r[4];
        if (NT == 1) {  // one 8-wide tile: the x4 reads 16 columns, the upper 8 again
          ldmatrix_x4_trans(r, smem_addr(vs + (16 * ks + b_row) * Sh::Pitch + warp * 8 + (b_col & 7)));
        } else {
          ldmatrix_x4_trans(r, smem_addr(vs + (16 * ks + b_row) * Sh::Pitch + warp * 8 * NT +
                                         16 * np + b_col));
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16_16816(acc[mi][2 * np], af[mi], r[0], r[1]);
          if (2 * np + 1 < NT) mma_bf16_16816(acc[mi][(2 * np + 1) % NT], af[mi], r[2], r[3]);
        }
      }
    }
    float ax[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k2 = 0; k2 < Sh::BN; k2 += 32) {
      uint32_t a0[4], a1[4], bv[4];
      ldmatrix_x4(a0, smem_addr(ar + (16 * xm + a_row) * Sh::Pitch + k2 + a_col));
      ldmatrix_x4(a1, smem_addr(ar + (16 * xm + a_row) * Sh::Pitch + k2 + 16 + a_col));
      ldmatrix_x4(bv, smem_addr(vs + (8 * xn + (lane & 7)) * Sh::Pitch + k2 + (lane >> 3) * 8));
      mma_bf16_16816(ax, a0, bv[0], bv[1]);
      mma_bf16_16816(ax, a1, bv[2], bv[3]);
    }
    const int d = step * kGxDepth + 8 * xn + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * xm + g + 8 * hr;
      if (r >= rows || d >= D) continue;
      bf16* o = dx + (row0 + r) * D + d;
      if (kAsync) {  // D % 8 == 0
        *reinterpret_cast<uint32_t*>(o) = pack_bf16(ax[2 * hr], ax[2 * hr + 1]);
      } else {
        o[0] = __float2bfloat16_rn(ax[2 * hr]);
        if (d + 1 < D) o[1] = __float2bfloat16_rn(ax[2 * hr + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the row sums below

  float* red = reinterpret_cast<float*>(gx_smem4);  // [8 warps][32 rows]
  float dsk[NT][2];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = warp * 8 * NT + 8 * ni + 2 * t + e;
      float s = 0.f;
      if (k < K)
        for (int h = 0; h < dchunks; ++h) s += ds[((long long)b * dchunks + h) * K + k];
      dsk[ni][e] = -s;
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * mi + g + 8 * hr;
      float s = 0.f;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int k = warp * 8 * NT + 8 * ni + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& da = acc[mi][ni][2 * hr + e];
          da += dsk[ni][e];
          const float av = r < rows && k + e < K ? a[(row0 + r) * K + k + e] : 0.f;
          s = fmaf(av, da, s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) red[warp * kGxRows + r] = s;
    }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * mi + g + 8 * hr;
      if (r >= rows) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kGxThreads / 32; ++w) s += red[w * kGxRows + r];
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int k = warp * 8 * NT + 8 * ni + 2 * t;
        const float* ap = a + (row0 + r) * K + k;
        float* o = dl + (row0 + r) * K + k;
        if (kAsync) {  // K % 8 == 0: both or neither of k, k + 1 in range
          if (k < K) {
            const float2 av = *reinterpret_cast<const float2*>(ap);
            *reinterpret_cast<float2*>(o) = make_float2(av.x * (acc[mi][ni][2 * hr] - s),
                                                        av.y * (acc[mi][ni][2 * hr + 1] - s));
          }
        } else {
          if (k < K) o[0] = ap[0] * (acc[mi][ni][2 * hr] - s);
          if (k + 1 < K) o[1] = ap[1] * (acc[mi][ni][2 * hr + 1] - s);
        }
      }
    }
}


// The shape's tiling, as train_forward_tc and train_backward_tc pick it.
struct TrainGeometry {
  TaGeometry agg;  // the aggregation's (tc_geometry), forward and backward alike
  int groups;      // dC₂ partial slots (train_groups)
  int gemm_nt;     // n8 tiles a warp in tc_bwd_gemm_kernel
};

inline TrainGeometry train_geometry(int B, int D, int K) {
  return TrainGeometry{tc_geometry(D, K), train_groups(B, D, K), gemm_nt(K)};
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Forward, bf16: the softmax, then the one- or two-pass aggregation with A
// rounded once.  ws_colsq holds B·dchunks·K floats (two passes).
inline cudaError_t train_forward_tc(const bf16* x, const float* logits, const float* c2, bf16* out,
                                    float* ws_a, float* ws_colsq, int B, int F, int D, int K,
                                    cudaStream_t st) {
  if (!shape_ok(B, F, D, K)) return cudaErrorInvalidValue;
  cudaError_t err = launch_softmax(logits, ws_a, (long long)B * F, K, st);
  if (err != cudaSuccess) return err;
  const TaGeometry geo = tc_geometry(D, K);
  const bool vec = aligned16(x) && aligned16(out) && D % 8 == 0 && K % 8 == 0;
  if (geo.one_pass)
    return vec ? launch_tc_aggregate_cluster<true, false>(x, D, ws_a, c2, out, B, F, D, K, geo, st)
               : launch_tc_aggregate_cluster<false, false>(x, D, ws_a, c2, out, B, F, D, K, geo, st);
  err = vec ? launch_tc_aggregate<true, 1, false>(x, D, ws_a, c2, ws_colsq, out, B, F, D, K, geo, st)
            : launch_tc_aggregate<false, 1, false>(x, D, ws_a, c2, ws_colsq, out, B, F, D, K, geo, st);
  if (err != cudaSuccess) return err;
  return vec ? launch_tc_aggregate<true, 2, false>(x, D, ws_a, c2, ws_colsq, out, B, F, D, K, geo, st)
             : launch_tc_aggregate<false, 2, false>(x, D, ws_a, c2, ws_colsq, out, B, F, D, K, geo,
                                                    st);
}

// The V₁ pass over G groups of videos: tg.groups, and for the one-pass
// cluster kernel at most as many clusters as fit the card at once
// (cudaOccupancyMaxActiveClusters), so that no cluster waits for a second
// wave; *groups = G, the dC₂ slots written.
template <bool kAsync, int kPass>
cudaError_t launch_tc_bwd(const bf16* x, const float* a, const float* c2, const bf16* dv3,
                          bf16* dv1, float* colsq, float* pk, float* ds, float* dc2_part, int B,
                          int F, int D, int K, const TrainGeometry& tg, int* groups,
                          cudaStream_t st) {
  const TaGeometry& geo = tg.agg;
  const BwSmem sm = bw_smem(geo);
  auto kernel = tc_bwd_kernel<kAsync, kPass>;
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, sm.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kPass == 0 ? geo.ktiles : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(geo.ktiles, 1, geo.dchunks);
  cfg.blockDim = dim3(geo.threads);
  cfg.dynamicSmemBytes = sm.total;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int g = tg.groups;
  if (kPass == 0) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    if (clusters < g) g = clusters;
  }
  *groups = g;
  cfg.gridDim.y = g;
  err = cudaLaunchKernelEx(&cfg, kernel, x, a, c2, dv3, dv1, colsq, pk, ds, dc2_part, B, F, D, K,
                           geo);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kAsync, int NT>
cudaError_t launch_tc_bwd_gemm(const bf16* x, const float* a, const bf16* dv1, const float* ds,
                               bf16* dx, float* dl, int B, int F, int D, int K, int dchunks,
                               cudaStream_t st) {
  using Sh = GxShape<NT>;
  const void* kernel = (const void*)tc_bwd_gemm_kernel<kAsync, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::Smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kGxRows - 1) / kGxRows, B);
  tc_bwd_gemm_kernel<kAsync, NT><<<grid, kGxThreads, Sh::Smem, st>>>(x, a, dv1, ds, dx, dl, F, D, K,
                                                                     dchunks);
  return cudaGetLastError();
}

template <bool kAsync>
cudaError_t launch_tc_bwd_gemm_k(const bf16* x, const float* a, const bf16* dv1, const float* ds,
                                 bf16* dx, float* dl, int B, int F, int D, int K, int dchunks,
                                 cudaStream_t st) {
  switch (gemm_nt(K)) {
    case 1: return launch_tc_bwd_gemm<kAsync, 1>(x, a, dv1, ds, dx, dl, B, F, D, K, dchunks, st);
    case 2: return launch_tc_bwd_gemm<kAsync, 2>(x, a, dv1, ds, dx, dl, B, F, D, K, dchunks, st);
    case 4: return launch_tc_bwd_gemm<kAsync, 4>(x, a, dv1, ds, dx, dl, B, F, D, K, dchunks, st);
    default: return launch_tc_bwd_gemm<kAsync, 8>(x, a, dv1, ds, dx, dl, B, F, D, K, dchunks, st);
  }
}

// Backward, bf16 (see the head of the file).  Scratch: ws.a [B·F, K];
// ws.colsq, ws.p, ws.ds [B, dchunks, K]; ws.dc2 [n_groups ≥ groups, D, K];
// ws_dv1 [B, D, K] bf16.  ws.inv_c, ws.qk and ws.vid are the f32 chain's.
inline cudaError_t train_backward_tc(const bf16* x, const float* logits, const float* c2,
                                     const bf16* dv3, bf16* dx, float* dl, float* dc2,
                                     bf16* ws_dv1, const BwdScratch& ws, int B, int F, int D, int K,
                                     int n_groups, cudaStream_t st) {
  const TrainGeometry tg = train_geometry(B, D, K);
  if (!shape_ok(B, F, D, K) || n_groups < tg.groups) return cudaErrorInvalidValue;
  cudaError_t err = launch_softmax(logits, ws.a, (long long)B * F, K, st);
  if (err != cudaSuccess) return err;
  int groups = tg.groups;
  const bool vec = aligned16(x) && aligned16(dv3) && aligned16(dx) && aligned16(ws_dv1) &&
                   D % 8 == 0 && K % 8 == 0;
  if (tg.agg.one_pass) {
    err = vec ? launch_tc_bwd<true, 0>(x, ws.a, c2, dv3, ws_dv1, ws.colsq, ws.p, ws.ds, ws.dc2, B,
                                       F, D, K, tg, &groups, st)
              : launch_tc_bwd<false, 0>(x, ws.a, c2, dv3, ws_dv1, ws.colsq, ws.p, ws.ds, ws.dc2, B,
                                        F, D, K, tg, &groups, st);
  } else {
    err = vec ? launch_tc_bwd<true, 1>(x, ws.a, c2, dv3, ws_dv1, ws.colsq, ws.p, ws.ds, ws.dc2, B,
                                       F, D, K, tg, &groups, st)
              : launch_tc_bwd<false, 1>(x, ws.a, c2, dv3, ws_dv1, ws.colsq, ws.p, ws.ds, ws.dc2, B,
                                        F, D, K, tg, &groups, st);
    if (err != cudaSuccess) return err;
    err = vec ? launch_tc_bwd<true, 2>(x, ws.a, c2, dv3, ws_dv1, ws.colsq, ws.p, ws.ds, ws.dc2, B,
                                       F, D, K, tg, &groups, st)
              : launch_tc_bwd<false, 2>(x, ws.a, c2, dv3, ws_dv1, ws.colsq, ws.p, ws.ds, ws.dc2, B,
                                        F, D, K, tg, &groups, st);
  }
  if (err != cudaSuccess) return err;
  err = vec ? launch_tc_bwd_gemm_k<true>(x, ws.a, ws_dv1, ws.ds, dx, dl, B, F, D, K,
                                         tg.agg.dchunks, st)
            : launch_tc_bwd_gemm_k<false>(x, ws.a, ws_dv1, ws.ds, dx, dl, B, F, D, K,
                                          tg.agg.dchunks, st);
  if (err != cudaSuccess) return err;
  const long long n = (long long)D * K;
  sum_groups_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(ws.dc2, dc2,
                                                                                   groups, n);
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
    return (int)lpm::train_forward_tc(static_cast<const bf16*>(x), l, cc2, static_cast<bf16*>(out),
                                      wa, wc, B, F, D, K, st);
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
    return (int)lpm::train_backward_tc(static_cast<const bf16*>(x), l, cc2,
                                       static_cast<const bf16*>(dv3), static_cast<bf16*>(dx), dlf,
                                       dc2f, static_cast<bf16*>(ws_dv1), ws, B, F, D, K, n_groups,
                                       st);
  }
  return (int)lpm::train_backward<float>(static_cast<const float*>(x), l, cc2,
                                         static_cast<const float*>(dv3), static_cast<float*>(dx),
                                         dlf, dc2f, static_cast<float*>(ws_dv1), ws, B, F, D, K,
                                         n_groups, st);
}

// The bf16 chains' tiling of a (B, D, K) shape, as train_geometry picks it:
// out[0..8] = ds, cs, kc, ktiles, dchunks, one_pass, threads, groups, gemm_nt.
extern "C" void lpm_netvlad_train_geometry(int B, int D, int K, int* out) {
  const lpm::TrainGeometry g = lpm::train_geometry(B, D, K);
  const int v[9] = {g.agg.ds, g.agg.cs, g.agg.kc, g.agg.ktiles, g.agg.dchunks, g.agg.one_pass,
                    g.agg.threads, g.groups, g.gemm_nt};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}
