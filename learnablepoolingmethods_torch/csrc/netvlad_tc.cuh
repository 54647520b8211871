// The bf16 NetVLAD inference chain on tensor cores, shared by both
// inference kernels (netvlad_fused.cu and fused_frontend.cu through
// run_netvlad<__nv_bfloat16> in netvlad_core.cuh); the bf16 training
// forward (netvlad_train.cu) runs its aggregation with kSplitA false, A
// rounded to bf16 once in one mma, and its backward reuses the one-pass
// kernel's tiling, ring and cluster exchange.  It computes what
// netvlad_core.cuh's head comment states, for each video b of frames X_b
// [S, D] bf16 (row stride ldx):
//
//     A      = softmax(X_b·C · scale + bias)          [S, K]  f32
//     a_sum  = Σ_s A                                  [K]
//     vlad   = X_bᵀ·A − a_sum ⊙ C₂                    [D, K]  f32
//     out_b  = global-ℓ2(intra-ℓ2(vlad)), one rounding to bf16
//
// What bounds it on an H100: at Willow rgb shapes (B=512, S=30, D=1024,
// K=256) the 268 MB bf16 output is most of the bytes (80 µs at 3.35 TB/s);
// the logits and the aggregation are 8 GFLOP each (16 µs at 989 TFLOP/s).
// The first port's FMA code (netvlad_core.cuh, kept for f32) was 28× that
// bound; its aggregation ran twice.  netfv_fused.cu's bf16 chain takes the
// logits launch below and the cluster kernel's helpers.
//
// Two launches (three for the two-pass shapes):
//
//  1. tc_logits_kernel: the logits as a GEMM [BM rows, D] × [D, K] on
//     tensor cores (mma.sync m16n8k16 from ldmatrix, f32 accumulators), fed
//     by a three-stage cp.async ring of 32-deep X and C tiles.  One block
//     holds a row's whole K (≤ kMaxClusters), so the softmax is the
//     epilogue: the folded BN on the f32 fragments (__fmul_rn, __fadd_rn),
//     the row max and Σ exp reduced over the quad by shuffles and over the
//     four column warps through shared memory in a fixed order, one IEEE
//     division.  A is written once, f32 [B·S, K].  Rows are tiled across
//     videos (BM = 64, or 32 at K > 256), so C is read once per 64 rows, not
//     once per 32 as the FMA kernel restaged it.
//
//  2. the aggregation: per (video, cluster tile) the f32 tile vlad [D, KC]
//     = X_bᵀ·A_b on tensor cores.  Warps tile it as 64 rows × 32 clusters
//     each (64 accumulators a thread; up to 16 warps, so a block holds
//     D ≤ 1024 rows).  The contraction runs over the samples in stages of a
//     two-stage ring: X rows by cp.async, entering as the mma's A operand
//     through ldmatrix.trans (X is exact in bf16); A as f32, summed into
//     a_sum (the unrounded A, in a fixed order) and split into A_hi =
//     bf16(A) and A_lo = bf16(A − A_hi), two mma's into one f32 accumulator,
//     so A keeps about 2⁻¹⁷ of relative accuracy.  Samples past S are
//     zero-filled.  Then vlad − a_sum·C₂ (C₂ f32, __fsub_rn/__fmul_rn as the
//     FMA kernel), Σ_d vlad² per cluster by shuffles and a fixed-order sum
//     over the row warps.
//
//     One pass (tc_aggregate_cluster_kernel, the shapes of every main path;
//     kept because it takes about half the two-pass kernels' time on the same
//     rows, 0.604 against 1.132 ms for the Willow rgb+audio pair at B=512,
//     S=30 on an H100 80GB HBM3 at 700 W, PERF.md): the K/KC blocks of a
//     video form a thread-block cluster (at most 8, the portable size:
//     K ≤ 256 at D = 1024, K ≤ 512 at D ≤ 512).  Each
//     block publishes Σ_k colsq_k·rsqrt(max(colsq_k, ε))² over its clusters
//     in shared memory; after cluster.sync() every block reads the cluster's
//     partials in rank order through distributed shared memory, so all see
//     the same total, scales its registers once, and writes its tile once.
//     The clusters are persistent (as many as fit the card, each walking
//     every gridDim.y-th video), and a block's two-stage ring of 16-sample
//     X/A stages runs on into the next video, so those loads overlap this
//     video's epilogue: a video's compute is short (2 GFLOP at S=30 for the
//     whole batch), and with one 512-thread block an SM (its f32 tile takes
//     half the register file) the per-video chain of loads, reductions,
//     cluster sync and stores is what the time is made of (PERF.md).  A
//     enters the ring as f32 (cp.async) and is split into its bf16
//     fragments in registers.  The tile is stored from registers: a 4×4
//     transpose inside each quad gives every lane 8 consecutive clusters,
//     one 16-byte store, in the d-major [B, D, K] layout.
//
//     Two passes (tc_aggregate_kernel; other shapes: K/KC > 8 or D > 1024,
//     or on request, to time both designs): pass 1 writes each block's colsq
//     to [B, ⌈D/1024⌉, K], pass 2 recomputes the tile, reads every partial of
//     its video in a fixed order, and stages its bf16 tile through shared
//     memory into 16-byte stores.  The shape alone picks the kernel
//     (tc_geometry, mirrored by ops/netvlad_fused.py#aggregation_geometry);
//     nothing falls back.  No float atomics anywhere: two runs give the
//     same bits.
//
// Rows or C not 16-byte aligned, or ldx, D or K not a multiple of 8 (the
// small checks' shapes), take 2-byte loads and stores on the same tiles.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "netvlad_core.cuh"
#include "tensor_core.cuh"

namespace lpm {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- logits --

constexpr int kTlDepth = 32;  // D per ring stage
constexpr int kTlStages = 3;
constexpr int kTlThreads = 256;  // 8 warps: 2 along rows × 4 along clusters
constexpr int kTlXPitch = kTlDepth + 8;  // bf16, an odd number of 16-byte chunks

template <int MT, int NT>
struct TlShape {
  static constexpr int BM = 2 * 16 * MT;  // rows per block
  static constexpr int BN = 4 * 8 * NT;   // clusters per block (≥ K)
  static constexpr int CPitch = BN + 8;
  static constexpr int Stage = BM * kTlXPitch + kTlDepth * CPitch;  // bf16
  static constexpr size_t Smem = sizeof(bf16) * kTlStages * Stage;
};

// Ring stage: X rows [row0, row0+rows) × [d0, d0+32) → xs [BM][40];
// C rows [d0, d0+32) × [0, BN) → cs [32][BN+8]; zero past rows, D and K.
template <bool kAsync, int BM, int BN>
__device__ __forceinline__ void tl_load_stage(const bf16* __restrict__ x, long long ldx,
                                              long long row0, int rows,
                                              const bf16* __restrict__ c, int d0, int D, int K,
                                              bf16* xs, bf16* cs) {
  constexpr int CPitch = BN + 8;
  if (kAsync) {
    for (int i = threadIdx.x; i < BM * (kTlDepth / 8); i += kTlThreads) {
      const int r = i / (kTlDepth / 8), cc = (i % (kTlDepth / 8)) * 8;
      const bool ok = r < rows && d0 + cc < D;
      cp_async_16(smem_addr(xs + r * kTlXPitch + cc), ok ? x + (row0 + r) * ldx + d0 + cc : x,
                  ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < kTlDepth * (BN / 8); i += kTlThreads) {
      const int r = i / (BN / 8), cc = (i % (BN / 8)) * 8;
      const bool ok = d0 + r < D && cc < K;
      cp_async_16(smem_addr(cs + r * CPitch + cc), ok ? c + (long long)(d0 + r) * K + cc : c,
                  ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < BM * kTlDepth; i += kTlThreads) {
      const int r = i / kTlDepth, dd = i % kTlDepth;
      xs[r * kTlXPitch + dd] = r < rows && d0 + dd < D ? x[(row0 + r) * ldx + d0 + dd] : zero;
    }
    for (int i = threadIdx.x; i < kTlDepth * BN; i += kTlThreads) {
      const int r = i / BN, kk = i % BN;
      cs[r * CPitch + kk] = d0 + r < D && kk < K ? c[(long long)(d0 + r) * K + kk] : zero;
    }
  }
}

// Grid ⌈M/BM⌉: rows [row0, row0+BM) of X · C, the folded BN, the softmax
// over K, A → a [M, K] f32.  acc[mi][ni][e] is row wm·16·MT + 16mi + g +
// 8·(e/2), cluster wn·8·NT + 8ni + 2t + e%2 for warp (wm, wn), lane 4g + t.
template <bool kAsync, int MT, int NT>
__global__ void __launch_bounds__(kTlThreads)
tc_logits_kernel(const bf16* __restrict__ x, long long ldx, const bf16* __restrict__ c,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 float* __restrict__ a, long long M, int D, int K) {
  using Sh = TlShape<MT, NT>;
  extern __shared__ float4 tl_smem4[];
  bf16* ring = reinterpret_cast<bf16*>(tl_smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)blockIdx.x * Sh::BM;
  const int rows = (int)min((long long)Sh::BM, M - row0);
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3), b_col = (lane >> 4) * 8;

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int nk = (D + kTlDepth - 1) / kTlDepth;
  auto load = [&](int step) {
    bf16* xs = ring + (step % kTlStages) * Sh::Stage;
    tl_load_stage<kAsync, Sh::BM, Sh::BN>(x, ldx, row0, rows, c, step * kTlDepth, D, K, xs,
                                          xs + Sh::BM * kTlXPitch);
  };
  for (int s = 0; s < kTlStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();  // one group per step, empty or not, so the wait below is uniform
  }
  for (int step = 0; step < nk; ++step) {
    cp_async_wait<kTlStages - 2>();
    __syncthreads();  // this step's stage landed for all; the one loaded next was freed
    if (step + kTlStages - 1 < nk) load(step + kTlStages - 1);
    cp_async_commit();
    const bf16* xs = ring + (step % kTlStages) * Sh::Stage;
    const bf16* cs = xs + Sh::BM * kTlXPitch;
#pragma unroll
    for (int ks = 0; ks < kTlDepth / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(af[mi], smem_addr(xs + (wm * 16 * MT + 16 * mi + a_row) * kTlXPitch +
                                      16 * ks + a_col));
#pragma unroll
      for (int np = 0; np < NT / 2 + (NT & 1); ++np) {
        uint32_t r[4];
        if (NT == 1) {  // one 8-wide tile: the x4 reads 16 columns, the upper 8 of the pitch pad
          ldmatrix_x4_trans(
              r, smem_addr(cs + (16 * ks + b_row) * Sh::CPitch + wn * 8 + (b_col & 7)));
        } else {
          ldmatrix_x4_trans(r, smem_addr(cs + (16 * ks + b_row) * Sh::CPitch + wn * 8 * NT +
                                         16 * np + b_col));
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16_16816(acc[mi][2 * np], af[mi], r[0], r[1]);
          if (2 * np + 1 < NT) mma_bf16_16816(acc[mi][(2 * np + 1) % NT], af[mi], r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the row reductions below

  // folded BN; −inf past K
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int k = wn * 8 * NT + 8 * ni + 2 * t;
    const float sc0 = k < K ? scale[k] : 0.f, bi0 = k < K ? bias[k] : 0.f;
    const float sc1 = k + 1 < K ? scale[k + 1] : 0.f, bi1 = k + 1 < K ? bias[k + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float* v = &acc[mi][ni][2 * hr];
        v[0] = k < K ? __fadd_rn(__fmul_rn(v[0], sc0), bi0) : -INFINITY;
        v[1] = k + 1 < K ? __fadd_rn(__fmul_rn(v[1], sc1), bi1) : -INFINITY;
      }
  }
  // a row's K logits lie in the 4 lanes of a quad in each of the 4 warps wn
  float* red = reinterpret_cast<float*>(tl_smem4);  // [2][4 wn][BM rows]
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float m = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        m = fmaxf(m, fmaxf(acc[mi][ni][2 * hr], acc[mi][ni][2 * hr + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (t == 0) red[wn * Sh::BM + wm * 16 * MT + 16 * mi + g + 8 * hr] = m;
    }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm * 16 * MT + 16 * mi + g + 8 * hr;
      const float m = fmaxf(fmaxf(red[r], red[Sh::BM + r]),
                            fmaxf(red[2 * Sh::BM + r], red[3 * Sh::BM + r]));
      float e = 0.f;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        acc[mi][ni][2 * hr] = expf(acc[mi][ni][2 * hr] - m);
        acc[mi][ni][2 * hr + 1] = expf(acc[mi][ni][2 * hr + 1] - m);
        e += acc[mi][ni][2 * hr] + acc[mi][ni][2 * hr + 1];
      }
      e += __shfl_xor_sync(0xffffffffu, e, 1);
      e += __shfl_xor_sync(0xffffffffu, e, 2);
      if (t == 0) red[(4 + wn) * Sh::BM + r] = e;
    }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm * 16 * MT + 16 * mi + g + 8 * hr;
      if (r >= rows) continue;
      const float* rs = red + 4 * Sh::BM + r;
      const float s = ((rs[0] + rs[Sh::BM]) + rs[2 * Sh::BM]) + rs[3 * Sh::BM];
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int k = wn * 8 * NT + 8 * ni + 2 * t;
        if (k >= K) continue;
        float* dst = a + (row0 + r) * K + k;
        const float a0 = acc[mi][ni][2 * hr] / s, a1 = acc[mi][ni][2 * hr + 1] / s;
        if (kAsync) {  // K % 8 == 0
          *reinterpret_cast<float2*>(dst) = make_float2(a0, a1);
        } else {
          dst[0] = a0;
          if (k + 1 < K) dst[1] = a1;
        }
      }
    }
}

template <bool kAsync, int MT, int NT>
cudaError_t launch_tc_logits(const bf16* x, long long ldx, const bf16* c, const float* scale,
                             const float* bias, float* a, long long M, int D, int K,
                             cudaStream_t stream) {
  using Sh = TlShape<MT, NT>;
  const void* kernel = (const void*)tc_logits_kernel<kAsync, MT, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Sh::Smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((M + Sh::BM - 1) / Sh::BM);
  tc_logits_kernel<kAsync, MT, NT><<<grid, kTlThreads, Sh::Smem, stream>>>(x, ldx, c, scale,
                                                                           bias, a, M, D, K);
  return cudaGetLastError();
}

template <bool kAsync>
cudaError_t launch_tc_logits_k(const bf16* x, long long ldx, const bf16* c, const float* scale,
                               const float* bias, float* a, long long M, int D, int K,
                               cudaStream_t stream) {
  if (K <= 32) return launch_tc_logits<kAsync, 2, 1>(x, ldx, c, scale, bias, a, M, D, K, stream);
  if (K <= 64) return launch_tc_logits<kAsync, 2, 2>(x, ldx, c, scale, bias, a, M, D, K, stream);
  if (K <= 128) return launch_tc_logits<kAsync, 2, 4>(x, ldx, c, scale, bias, a, M, D, K, stream);
  if (K <= 256) return launch_tc_logits<kAsync, 2, 8>(x, ldx, c, scale, bias, a, M, D, K, stream);
  return launch_tc_logits<kAsync, 1, 16>(x, ldx, c, scale, bias, a, M, D, K, stream);
}

// ------------------------------------------------------------- aggregate --

constexpr int kTaSamples = 32;  // samples per ring stage (two k16 steps)
constexpr int kTaMaxWarps = 16;
constexpr int kTaMaxCluster = 8;  // the portable cluster size
constexpr int kTaChunkRows = 64 * kTaMaxWarps;  // D rows one block holds

// How a (D, K) shape is tiled: ds 64-row slabs × cs 32-cluster slabs of
// warps a block (ds·cs ≤ 16), kc = 32·cs clusters a block, ktiles blocks a
// video along K, dchunks blocks along D; one pass when a video's blocks fit
// one portable cluster.  ops/netvlad_fused.py#aggregation_geometry mirrors it.
struct TaGeometry {
  int ds, cs, kc, ktiles, dchunks, one_pass, threads;
};

__host__ __device__ inline TaGeometry tc_geometry(int D, int K) {
  TaGeometry geo;
  const int slabs = (D + 63) / 64;
  geo.dchunks = (slabs + kTaMaxWarps - 1) / kTaMaxWarps;
  geo.ds = slabs < kTaMaxWarps ? slabs : kTaMaxWarps;
  const int kslabs = (K + 31) / 32;
  geo.cs = kTaMaxWarps / geo.ds < kslabs ? kTaMaxWarps / geo.ds : kslabs;
  geo.kc = 32 * geo.cs;
  geo.ktiles = (K + geo.kc - 1) / geo.kc;
  geo.one_pass = geo.dchunks == 1 && geo.ktiles <= kTaMaxCluster;
  geo.threads = 32 * geo.ds * geo.cs;
  return geo;
}

struct TaSmem {
  int xpitch, apitch, ring, out, total;  // bf16 pitches; byte sizes and offsets
};

__host__ __device__ inline TaSmem ta_smem(const TaGeometry& geo) {
  TaSmem s;
  s.xpitch = 64 * geo.ds + 8;
  s.apitch = geo.kc + 8;
  s.ring = (int)sizeof(bf16) * kTaSamples * (2 * s.xpitch + 2 * s.apitch);  // X ×2 stages, A hi+lo
  s.out = (int)sizeof(bf16) * 64 * geo.ds * s.apitch;
  const int big = s.ring > s.out ? s.ring : s.out;
  // then floats: red [ds][kc], asum [kc], rk [kc], wsum [16], tot [1]
  s.total = big + (int)sizeof(float) * (geo.ds * geo.kc + 2 * geo.kc + kTaMaxWarps + 4);
  return s;
}


// The warp's 64 × 32 tile, vlad − a_sum·C₂ in place (zero outside the dn
// rows and kn clusters), and its Σ over the warp's rows of vlad² per
// cluster, written by lanes 0–3 to red[dslab][cluster] (the caller sums the
// row slabs in order).  c2_at(dd, kk) returns C₂ of tile row dd, clusters
// kk and kk + 1; it is called at every (dd, kk) of the tile, without a
// branch around it, so that the loads issue together.
template <typename C2At>
__device__ __forceinline__ void ta_center(float (&acc)[4][4][4], const float* asum_s, C2At c2_at,
                                          int dslab, int cslab, int dn, int kn, int kc,
                                          float* red) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int kk = cslab * 32 + 8 * ni + 2 * t;
    const float as0 = asum_s[kk], as1 = asum_s[kk + 1];
    float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int dd = dslab * 64 + 16 * mi + g + 8 * hr;
        float* v = &acc[mi][ni][2 * hr];
        const float2 c = c2_at(dd, kk);  // safe at every (dd, kk) of the tile
        const bool row = dd < dn;
        v[0] = row && kk < kn ? __fsub_rn(v[0], __fmul_rn(as0, c.x)) : 0.f;
        v[1] = row && kk + 1 < kn ? __fsub_rn(v[1], __fmul_rn(as1, c.y)) : 0.f;
        cs0 = fmaf(v[0], v[0], cs0);
        cs1 = fmaf(v[1], v[1], cs1);
      }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
      cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
    }
    if (g == 0) {
      red[dslab * kc + kk] = cs0;
      red[dslab * kc + kk + 1] = cs1;
    }
  }
}

// Pass kMode 1 writes colsq [B, dchunks, K], the Σ_d vlad² of each block's
// clusters over its D rows; pass kMode 2 recomputes the tile, forms every
// cluster's norm and the video's total from those partials in a fixed order,
// and writes the tile.  Grid (ktiles, B, dchunks), geo.threads threads.
// kSplitA: A enters as A_hi + A_lo (two mma's); without it A is rounded to
// bf16 once (one mma), as the training forward rounds it.
template <bool kAsync, int kMode, bool kSplitA = true>
__global__ void __launch_bounds__(32 * kTaMaxWarps, 1)
tc_aggregate_kernel(const bf16* __restrict__ x, long long ldx, const float* __restrict__ a,
                    const float* __restrict__ c2, float* __restrict__ colsq,
                    bf16* __restrict__ out, int S, int D, int K, TaGeometry geo) {
  extern __shared__ float4 ta_smem4[];
  const TaSmem sm = ta_smem(geo);
  char* base = reinterpret_cast<char*>(ta_smem4);
  bf16* xs0 = reinterpret_cast<bf16*>(base);             // [2][32][xpitch]
  bf16* ahi = xs0 + 2 * kTaSamples * sm.xpitch;          // [32][apitch]
  bf16* alo = ahi + kTaSamples * sm.apitch;              // [32][apitch]
  bf16* os = reinterpret_cast<bf16*>(base);              // [64·ds][apitch], after the loop
  float* red = reinterpret_cast<float*>(base + (sm.ring > sm.out ? sm.ring : sm.out));
  float* asum_s = red + geo.ds * geo.kc;
  float* rk_s = asum_s + geo.kc;
  float* wsum = rk_s + geo.kc;
  float* tot_s = wsum + kTaMaxWarps;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthreads = geo.threads;
  const int dslab = warp % geo.ds, cslab = warp / geo.ds;
  const int kt = blockIdx.x, b = blockIdx.y, dc = blockIdx.z;
  const int k0 = kt * geo.kc, kn = min(geo.kc, K - k0);
  const int d_lo = dc * kTaChunkRows, dn = min(64 * geo.ds, D - d_lo);
  const long long srow0 = (long long)b * S;
  const int part = tid / geo.kc, col = tid % geo.kc;  // a_sum: part ∈ [0, ds)

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float asum_part = 0.f;

  const int nchunks = (S + kTaSamples - 1) / kTaSamples;
  auto load_x = [&](int chunk) {
    bf16* xs = xs0 + (chunk & 1) * kTaSamples * sm.xpitch;
    const int s0 = chunk * kTaSamples;
    const int width = 64 * geo.ds;
    if (kAsync) {
      for (int i = tid; i < kTaSamples * (width / 8); i += nthreads) {
        const int s = i / (width / 8), cc = (i % (width / 8)) * 8;
        const bool ok = s0 + s < S && cc < dn;
        cp_async_16(smem_addr(xs + s * sm.xpitch + cc),
                    ok ? x + (srow0 + s0 + s) * ldx + d_lo + cc : x, ok ? 16 : 0);
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int i = tid; i < kTaSamples * width; i += nthreads) {
        const int s = i / width, dd = i % width;
        xs[s * sm.xpitch + dd] =
            s0 + s < S && dd < dn ? x[(srow0 + s0 + s) * ldx + d_lo + dd] : zero;
      }
    }
  };

  const int a_row = (lane & 7) + ((lane >> 4) & 1) * 8, a_col = ((lane >> 3) & 1) * 8;
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3), b_col = (lane >> 4) * 8;

  load_x(0);
  cp_async_commit();
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    // A of this chunk: f32 → a_sum (thread (part, col) takes samples ≡ part
    // mod ds, in order) and the bf16 hi/lo split; zero past S and K
    const int s0 = chunk * kTaSamples;
    for (int i = tid; i < kTaSamples * geo.kc; i += nthreads) {
      const int s = i / geo.kc, kk = i % geo.kc;
      float v = 0.f;
      if (s0 + s < S && kk < kn) v = a[(srow0 + s0 + s) * K + k0 + kk];
      asum_part += v;
      const bf16 hi = __float2bfloat16_rn(v);
      ahi[s * sm.apitch + kk] = hi;
      if (kSplitA) alo[s * sm.apitch + kk] = __float2bfloat16_rn(v - __bfloat162float(hi));
    }
    if (chunk + 1 < nchunks) load_x(chunk + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // X of this chunk and its A for everyone
    const bf16* xs = xs0 + (chunk & 1) * kTaSamples * sm.xpitch;
#pragma unroll
    for (int ks = 0; ks < kTaSamples / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(af[mi], smem_addr(xs + (16 * ks + a_row) * sm.xpitch + dslab * 64 +
                                            16 * mi + a_col));
#pragma unroll
      for (int half = 0; half < (kSplitA ? 2 : 1); ++half) {
        const bf16* as = half ? alo : ahi;
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(
              r, smem_addr(as + (16 * ks + b_row) * sm.apitch + cslab * 32 + 16 * np + b_col));
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_bf16_16816(acc[mi][2 * np], af[mi], r[0], r[1]);
            mma_bf16_16816(acc[mi][2 * np + 1], af[mi], r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();  // frees this chunk's X stage and the A tiles
  }
  cp_async_wait<0>();

  // a_sum over the parts in order
  red[part * geo.kc + col] = asum_part;
  __syncthreads();
  if (tid < geo.kc) {
    float q = 0.f;
    for (int p = 0; p < geo.ds; ++p) q += red[p * geo.kc + tid];
    asum_s[tid] = q;
  }
  __syncthreads();
  ta_center(acc, asum_s,
            [&](int dd, int kk) {
              const float* p = c2 + (long long)min(d_lo + dd, D - 1) * K + k0;
              return make_float2(p[min(kk, kn - 1)], p[min(kk + 1, kn - 1)]);
            },
            dslab, cslab, dn, kn, geo.kc, red);
  __syncthreads();

  // colsq of this block's clusters (over its D rows), in slab order
  if (kMode == 1) {
    if (tid < kn) {
      float cq = 0.f;
      for (int p = 0; p < geo.ds; ++p) cq += red[p * geo.kc + tid];
      colsq[((long long)b * geo.dchunks + dc) * K + k0 + tid] = cq;
    }
    return;
  }

  // pass 2: every block of the video forms the same total from the pass-1
  // partials, in the same order
  float q = 0.f;
  for (int k = tid; k < K; k += nthreads) {
    float c = 0.f;
    for (int p = 0; p < geo.dchunks; ++p) c += colsq[((long long)b * geo.dchunks + p) * K + k];
    const float r = rsqrtf(fmaxf(c, kEps));
    q += c * r * r;
    if (k >= k0 && k < k0 + kn) rk_s[k - k0] = r;
  }
  q = warp_sum(q);
  if (lane == 0) wsum[warp] = q;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < nthreads / 32; ++w) s += wsum[w];
    tot_s[0] = s;
  }
  __syncthreads();
  const float inv_tot = rsqrtf(fmaxf(tot_s[0], kEps));

  // scale, round to bf16 once, stage the tile [64·ds][kc] in shared memory
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int kk = cslab * 32 + 8 * ni + 2 * t;
    const float r0 = kk < kn ? rk_s[kk] : 0.f, r1 = kk + 1 < kn ? rk_s[kk + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int dd = dslab * 64 + 16 * mi + g + 8 * hr;
        const float* v = &acc[mi][ni][2 * hr];
        *reinterpret_cast<uint32_t*>(os + dd * sm.apitch + kk) =
            pack_bf16(__fmul_rn(__fmul_rn(v[0], r0), inv_tot),
                      __fmul_rn(__fmul_rn(v[1], r1), inv_tot));
      }
  }
  __syncthreads();
  // the tile's rows, 8 clusters (16 bytes) a thread where K allows
  bf16* ob = out + ((long long)b * D + d_lo) * K + k0;
  if (kAsync) {  // K % 8 == 0, so kn % 8 == 0 and the rows' 16-byte chunks are aligned
    const int per_row = kn / 8;
    for (int i = tid; i < dn * per_row; i += nthreads) {
      const int dd = i / per_row, cc = (i % per_row) * 8;
      *reinterpret_cast<uint4*>(ob + (long long)dd * K + cc) =
          *reinterpret_cast<const uint4*>(os + dd * sm.apitch + cc);
    }
  } else {
    for (int i = tid; i < dn * kn; i += nthreads) {
      const int dd = i / kn, kk = i % kn;
      ob[(long long)dd * K + kk] = os[dd * sm.apitch + kk];
    }
  }
}

// ------------------------------------------------ one pass, persistent --

constexpr int kTpSamples = 16;  // samples per ring stage (one k16 step)
constexpr int kTpStages = 2;
constexpr int kTpOutPitch = 32 + 8;  // bf16: a warp's 16 × 32 output staging tile

struct TpSmem {
  int xpitch, apitch, c2, stage, out, total;  // xpitch bf16, apitch f32; the rest bytes
};

__host__ __device__ inline TpSmem tp_smem(const TaGeometry& geo) {
  TpSmem s;
  s.xpitch = 64 * geo.ds + 8;
  s.apitch = geo.kc + 4;  // ≡ 4 mod 32: rows 2t of a fragment fall on distinct banks
  s.c2 = (int)sizeof(float) * 64 * geo.ds * geo.kc;
  s.stage = (int)sizeof(bf16) * kTpSamples * s.xpitch + (int)sizeof(float) * kTpSamples * s.apitch;
  s.out = (int)sizeof(bf16) * (geo.threads / 32) * 16 * kTpOutPitch;
  // then floats: red [ds][kc], asum [kc], rk [kc], wsum [16], tot [2 + 8]
  s.total = s.c2 + kTpStages * s.stage + s.out +
            (int)sizeof(float) * (geo.ds * geo.kc + 2 * geo.kc + kTaMaxWarps + 2 + kTaMaxCluster);
  return s;
}

// C₂ of tile row dd, cluster kk in the block's [64·ds][kc] f32 copy: the
// 8-column groups of a row are XOR-swizzled by dd % 4, so the float2 reads
// of a half-warp (rows g < 4, four lanes a row) hit 32 distinct banks
__device__ __forceinline__ int tp_c2_index(int dd, int kk, int kc) {
  return dd * kc + (kk ^ ((dd & 3) << 3));
}

// Σ of 16 values as a fixed pairwise tree
__device__ __forceinline__ float tree_sum16(float (&r)[16]) {
#pragma unroll
  for (int w = 8; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) r[i] += r[i + w];
  return r[0];
}

// One pass, persistent: clusters of geo.ktiles blocks (blockIdx.x = the
// cluster tile) walk the videos blockIdx.y, blockIdx.y + gridDim.y, ...
// Each block keeps its C₂ tile in shared memory for every video, and its
// two-stage ring of 16-sample X and A stages runs on from one video's last
// stage into the next video's, so the next video's first loads overlap this
// one's epilogue.  Threads tid < kc sum a_sum of their cluster, a fixed tree
// over each stage's 16 samples, the stages in order.  Each block publishes
// its clusters' Σ colsq·r² per video; after cluster.sync() every block reads
// the partials in rank order, scales its registers, and each warp stores its
// tile 16 rows at a time through a small shared staging tile, one 16-byte
// row piece of 8 clusters a lane.  kSplitA as in tc_aggregate_kernel.
template <bool kAsync, bool kSplitA = true>
__global__ void __launch_bounds__(32 * kTaMaxWarps, 1)
tc_aggregate_cluster_kernel(const bf16* __restrict__ x, long long ldx,
                            const float* __restrict__ a, const float* __restrict__ c2,
                            bf16* __restrict__ out, int B, int S, int D, int K, TaGeometry geo) {
  extern __shared__ float4 tp_smem4[];
  const TpSmem sm = tp_smem(geo);
  char* base = reinterpret_cast<char*>(tp_smem4);
  float* c2s = reinterpret_cast<float*>(base);  // [64·ds][kc], swizzled
  char* ring = base + sm.c2;                    // stages of X [16][xpitch] bf16, A [16][apitch] f32
  bf16* ostage = reinterpret_cast<bf16*>(ring + kTpStages * sm.stage);  // [warp][16][40]
  float* red = reinterpret_cast<float*>(ring + kTpStages * sm.stage + sm.out);
  float* asum_s = red + geo.ds * geo.kc;
  float* rk_s = asum_s + geo.kc;
  float* wsum = rk_s + geo.kc;
  float* tot_s = wsum + kTaMaxWarps;  // [0..1] this block's partial (by video parity)
  float* peer = tot_s + 2;            // [ktiles] the cluster's partials of this video

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthreads = geo.threads;
  const int g = lane >> 2, t = lane & 3;
  const int dslab = warp % geo.ds, cslab = warp / geo.ds;
  const int kc = geo.kc, k0 = blockIdx.x * kc, kn = min(kc, K - k0);
  const int dn = min(64 * geo.ds, D);
  const int first = blockIdx.y, stride = gridDim.y;
  const int nch = (S + kTpSamples - 1) / kTpSamples;
  const int nv = (B - first + stride - 1) / stride;
  const int total = nv * nch;
  const int part = tid / kc, col = tid % kc;  // a_sum: part ∈ [0, ds)

  for (int i = tid; i < 64 * geo.ds * kc; i += nthreads) {
    const int dd = i / kc, kk = i % kc;
    c2s[tp_c2_index(dd, kk, kc)] = dd < dn && kk < kn ? c2[(long long)dd * K + k0 + kk] : 0.f;
  }

  // a thread's 16-byte pieces of a stage: X rows xs_row + m·4cs, columns
  // xc..xc+7 (a row holds 8·ds pieces, and nthreads = 32·ds·cs is a multiple
  // of it), A rows as_row + m·4ds, clusters ac..ac+3 (8·cs pieces a row)
  const int xs_row = tid / (8 * geo.ds), xc = (tid % (8 * geo.ds)) * 8;
  const int as_row = tid / (8 * geo.cs), ac = (tid % (8 * geo.cs)) * 4;

  // stage j of the ring: video first + (j / nch)·stride, samples 16·(j % nch)
  // ...; zero past S, D and K
  auto load = [&](int j) {
    bf16* xs = reinterpret_cast<bf16*>(ring + (j % kTpStages) * sm.stage);
    float* as = reinterpret_cast<float*>(xs + kTpSamples * sm.xpitch);
    const long long row0 = (long long)(first + (j / nch) * stride) * S;
    const int s0 = (j % nch) * kTpSamples, width = 64 * geo.ds;
    if (kAsync) {
      for (int s = xs_row; s < kTpSamples; s += 4 * geo.cs) {
        const bool ok = s0 + s < S && xc < dn;
        cp_async_16(smem_addr(xs + s * sm.xpitch + xc), ok ? x + (row0 + s0 + s) * ldx + xc : x,
                    ok ? 16 : 0);
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
        xs[s * sm.xpitch + dd] = s0 + s < S && dd < dn ? x[(row0 + s0 + s) * ldx + dd] : zero;
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
    cp_async_commit();  // one group per stage, empty or not, so the wait below is uniform
  }
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
    float asum = 0.f;  // thread (part, col): cluster k0 + col, samples ≡ part mod ds, in order

    for (int q = 0; q < nch; ++q, ++j) {
      cp_async_wait<kTpStages - 2>();
      __syncthreads();  // stage j landed for everyone; the stage loaded next was freed at j − 1
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
        // B fragment (samples 2t, 2t+1 | 2t+8, 2t+9; cluster g) of A = hi + lo
        const float* ap = as + cslab * 32 + 8 * ni + g;
        const float v0 = ap[(2 * t) * sm.apitch], v1 = ap[(2 * t + 1) * sm.apitch];
        const float v2 = ap[(2 * t + 8) * sm.apitch], v3 = ap[(2 * t + 9) * sm.apitch];
        const __nv_bfloat162 h01 = __floats2bfloat162_rn(v0, v1), h23 = __floats2bfloat162_rn(v2, v3);
        const uint32_t hi01 = *reinterpret_cast<const uint32_t*>(&h01);
        const uint32_t hi23 = *reinterpret_cast<const uint32_t*>(&h23);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16_16816(acc[mi][ni], af[mi], hi01, hi23);
        if (kSplitA) {
          const uint32_t lo01 = pack_bf16(v0 - __low2float(h01), v1 - __high2float(h01));
          const uint32_t lo23 = pack_bf16(v2 - __low2float(h23), v3 - __high2float(h23));
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) mma_bf16_16816(acc[mi][ni], af[mi], lo01, lo23);
        }
      }
    }

    // epilogue: a_sum over the parts (a fixed tree), the centring and
    // Σ_d vlad² per cluster
    red[part * kc + col] = asum;
    __syncthreads();
    if (tid < kc) {
      float parts[kTaMaxWarps];
#pragma unroll
      for (int p = 0; p < kTaMaxWarps; ++p) parts[p] = p < geo.ds ? red[p * kc + tid] : 0.f;
      asum_s[tid] = tree_sum16(parts);
    }
    __syncthreads();
    ta_center(acc, asum_s,
              [&](int dd, int kk) {
                return *reinterpret_cast<const float2*>(c2s + tp_c2_index(dd, kk, kc));
              },
              dslab, cslab, dn, kn, kc, red);
    __syncthreads();
    float contrib = 0.f;
    if (tid < kn) {
      float slabs[kTaMaxWarps];
#pragma unroll
      for (int p = 0; p < kTaMaxWarps; ++p) slabs[p] = p < geo.ds ? red[p * kc + tid] : 0.f;
      const float cq = tree_sum16(slabs);
      const float r = rsqrtf(fmaxf(cq, kEps));
      rk_s[tid] = r;
      contrib = cq * r * r;
    }
    contrib = warp_sum(contrib);
    if (lane == 0) wsum[warp] = contrib;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < (kc + 31) / 32; ++w) s += wsum[w];
      tot_s[v & 1] = s;
    }
    // every block's partial of video v is published; a block that reads
    // them below reaches video v + 2's write of the same slot only after
    // every block has passed video v + 1's sync, so one sync a video does
    cluster.sync();
    if (tid < geo.ktiles) peer[tid] = *cluster.map_shared_rank(tot_s + (v & 1), tid);
    __syncthreads();
    float tot = 0.f;
    for (int r = 0; r < geo.ktiles; ++r) tot += peer[r];
    const float inv_tot = rsqrtf(fmaxf(tot, kEps));

    // scale, round to bf16 once, store
    float rr[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int kk = cslab * 32 + 8 * ni + 2 * t;
      rr[ni][0] = kk < kn ? rk_s[kk] : 0.f;
      rr[ni][1] = kk + 1 < kn ? rk_s[kk + 1] : 0.f;
    }
    // the warp's 64 × 32 tile, 16 rows at a time: fragments → its staging
    // tile in shared memory → 16-byte pieces of 8 clusters to the output
    bf16* ob = out + ((long long)b * D + dslab * 64) * K + k0 + cslab * 32;
    bf16* os = ostage + warp * 16 * kTpOutPitch;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          *reinterpret_cast<uint32_t*>(os + (g + 8 * hr) * kTpOutPitch + 8 * ni + 2 * t) =
              pack_bf16(__fmul_rn(__fmul_rn(acc[mi][ni][2 * hr], rr[ni][0]), inv_tot),
                        __fmul_rn(__fmul_rn(acc[mi][ni][2 * hr + 1], rr[ni][1]), inv_tot));
      __syncwarp();
      const int rows = min(16, dn - (dslab * 64 + 16 * mi));
      if (kAsync) {  // K % 8 == 0: a piece of 8 clusters is all in or all out
#pragma unroll
        for (int i = lane; i < 64; i += 32) {
          const int r = i >> 2, cc = (i & 3) * 8;
          if (r < rows && cslab * 32 + cc < kn)
            *reinterpret_cast<uint4*>(ob + (long long)(16 * mi + r) * K + cc) =
                *reinterpret_cast<const uint4*>(os + r * kTpOutPitch + cc);
        }
      } else {
        for (int i = lane; i < 16 * 32; i += 32) {
          const int r = i >> 5, cc = i & 31;
          if (r < rows && cslab * 32 + cc < kn)
            ob[(long long)(16 * mi + r) * K + cc] = os[r * kTpOutPitch + cc];
        }
      }
      __syncwarp();  // the staging tile is free for the next 16 rows
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // no block leaves while another may still read its partials
}

// ---------------------------------------------------------------- launch --

template <bool kAsync, int kMode, bool kSplitA = true>
cudaError_t launch_tc_aggregate(const bf16* x, long long ldx, const float* a, const float* c2,
                                float* colsq, bf16* out, int B, int S, int D, int K,
                                const TaGeometry& geo, cudaStream_t stream) {
  const TaSmem sm = ta_smem(geo);
  const void* kernel = (const void*)tc_aggregate_kernel<kAsync, kMode, kSplitA>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm.total);
  if (err != cudaSuccess) return err;
  tc_aggregate_kernel<kAsync, kMode, kSplitA>
      <<<dim3(geo.ktiles, B, geo.dchunks), geo.threads, sm.total, stream>>>(x, ldx, a, c2, colsq,
                                                                           out, S, D, K, geo);
  return cudaGetLastError();
}

// As many clusters as fit the card at once (cudaOccupancyMaxActiveClusters),
// at most one per video.
template <bool kAsync, bool kSplitA = true>
cudaError_t launch_tc_aggregate_cluster(const bf16* x, long long ldx, const float* a,
                                        const float* c2, bf16* out, int B, int S, int D, int K,
                                        const TaGeometry& geo, cudaStream_t stream) {
  const TpSmem sm = tp_smem(geo);
  auto kernel = tc_aggregate_cluster_kernel<kAsync, kSplitA>;
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, sm.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.ktiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(geo.ktiles, 1, 1);
  cfg.blockDim = dim3(geo.threads);
  cfg.dynamicSmemBytes = sm.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(geo.ktiles, clusters < B ? clusters : B, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, x, ldx, a, c2, out, B, S, D, K, geo);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The bf16 chain: logits + softmax into ws_a [B·S, K] f32, then the one-
// or two-pass aggregation (two_pass forces the latter, for timing the two
// designs on one shape).  ws_colsq holds B·dchunks·K floats (two passes).
inline cudaError_t run_netvlad_tc(const bf16* x, long long ldx, const bf16* c, const float* scale,
                                  const float* bias, const float* c2, bf16* out, float* ws_a,
                                  float* ws_colsq, int B, int S, int D, int K, bool two_pass,
                                  cudaStream_t stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || K < 1 || K > kMaxClusters)
    return cudaErrorInvalidValue;
  const long long M = (long long)B * S;
  const uintptr_t xb = reinterpret_cast<uintptr_t>(x);
  const bool vec = xb % 16 == 0 && ldx % 8 == 0 && D % 8 == 0 && K % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaError_t err = vec ? launch_tc_logits_k<true>(x, ldx, c, scale, bias, ws_a, M, D, K, stream)
                        : launch_tc_logits_k<false>(x, ldx, c, scale, bias, ws_a, M, D, K, stream);
  if (err != cudaSuccess) return err;
  const TaGeometry geo = tc_geometry(D, K);
  if (geo.one_pass && !two_pass)
    return vec ? launch_tc_aggregate_cluster<true>(x, ldx, ws_a, c2, out, B, S, D, K, geo, stream)
               : launch_tc_aggregate_cluster<false>(x, ldx, ws_a, c2, out, B, S, D, K, geo, stream);
  err = vec ? launch_tc_aggregate<true, 1>(x, ldx, ws_a, c2, ws_colsq, out, B, S, D, K, geo, stream)
            : launch_tc_aggregate<false, 1>(x, ldx, ws_a, c2, ws_colsq, out, B, S, D, K, geo,
                                            stream);
  if (err != cudaSuccess) return err;
  return vec ? launch_tc_aggregate<true, 2>(x, ldx, ws_a, c2, ws_colsq, out, B, S, D, K, geo,
                                            stream)
             : launch_tc_aggregate<false, 2>(x, ldx, ws_a, c2, ws_colsq, out, B, S, D, K, geo,
                                             stream);
}

// The bf16 instantiation of netvlad_core.cuh's run_netvlad takes this chain;
// the f32 one keeps the FMA kernels there.
template <>
inline cudaError_t run_netvlad<bf16>(const bf16* x, long long ldx, const bf16* c,
                                     const float* scale, const float* bias, const float* c2,
                                     bf16* out, float* ws_a, float* ws_colsq, int B, int S, int D,
                                     int K, cudaStream_t stream) {
  return run_netvlad_tc(x, ldx, c, scale, bias, c2, out, ws_a, ws_colsq, B, S, D, K, false,
                        stream);
}

}  // namespace lpm
