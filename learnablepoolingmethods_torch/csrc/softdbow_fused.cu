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
// bf16 tensor cores): the products bound it.
//
// Both instantiations: K = 4096 is far above what one block can hold a row
// of for several rows at once, and each frame's softmax needs its max and
// sum over all K before it adds to the histogram.  So the logits are formed
// over 128-cluster tiles, each tile's per-row max and Σ exp(logit − max)
// go to [B·S, ⌈K/128⌉] scratch (ws_max, ws_sum), and a later pass combines
// those partials per row in a fixed order into the row's max and softmax
// denominator before it sums exp(logit − max)/denominator over each
// video's rows into bow[b, k].  Every sum has one owner and a fixed order:
// no float atomics, and two runs give the same bits (the TPU kernel's frame
// split instead accumulates into a revisited output block).  The logits are
// products of x's type summed in f32, as on the TPU.
//
// bf16 (every main path), three launches:
//  1. softdbow_logits_kernel, grid (⌈K/128⌉, ⌈B·S/128⌉): the logits as a
//     tiled GEMM [128 rows, D] × [D, 128 clusters] on tensor cores,
//     mma.sync m16n8k16 with f32 accumulators (bf16 products are exact in
//     f32, so this is the f32 instantiation's sum in another order), fed by
//     ldmatrix from a three-stage cp.async ring of 64-deep X and C tiles;
//     the scale and bias in the epilogue on the f32 fragments; the logits
//     written once to ws_logits [B·S, K] f32 and the tile partials to
//     ws_max/ws_sum.  Rows are tiled across videos, so each 256 KB C tile is
//     read once per 128 frame rows (120 times at B=512, S=30), not once per
//     video.  Rows whose stride or start is not 16-byte aligned, or D or K
//     not a multiple of 8 (the small checks' shapes), take synchronous
//     2-byte loads into the same tiles instead of cp.async;
//  2. softdbow_combine_kernel: one thread a row combines its partials into
//     (max, 1/denominator), in place;
//  3. softdbow_hist_from_logits_kernel: one thread per (video, cluster)
//     streams the video's logits back, in row order, as exp(logit − max)
//     times 1/denominator (the f32 kernel divides: one f32 rounding apart).
// The logits are kept, not recomputed: 252 MB at the rgb shape, written and
// read once (0.15 ms at the HBM rate), where a second GEMM pass would cost
// what the first does, about 0.6 ms for the rgb and audio calls of a batch
// on an H100 SXM at 700 W (chip_smoke.py's lf_profile; the GEMM runs near
// what L2 can feed at 128×128 tiles, about 2 GB of X and C tile reads a
// pass).  At S=300 the scratch is ten times larger (2.5 GB at B=512).
//
// f32 (softdbow_stats_kernel / softdbow_hist_kernel, the first port's code,
// unchanged): f32 FMAs on the CUDA cores, since TF32 tensor cores would miss
// the 1e-5 check; grid (K/128, B), one video per block, its S rows in 32-row
// chunks; the logits computed twice (stats pass, then histogram pass), no
// ws_logits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "netvlad_core.cuh"
#include "tensor_core.cuh"

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

// ------------------------------------------------ bf16: tensor cores --

constexpr int kTcRows = 128;     // frame rows per block of the logits pass
constexpr int kTcDepth = 64;     // D per ring stage
constexpr int kTcStages = 3;
constexpr int kTcThreads = 256;  // 8 warps: 2 along rows (64 each) × 4 along clusters (32 each)
constexpr int kTcXPitch = kTcDepth + 8;      // bf16, an odd number of 16-byte chunks
constexpr int kTcCPitch = kBowClusters + 8;  // bf16
constexpr int kTcStage = kTcRows * kTcXPitch + kTcDepth * kTcCPitch;        // bf16 per stage
constexpr size_t kTcSmemBytes = sizeof(__nv_bfloat16) * kTcStages * kTcStage;  // 107,520

// One ring stage: X rows [row0, row0 + rows) × columns [d0, d0 + 64) → xs
// [128][72], C rows [d0, d0 + 64) × clusters [k0, k0 + 128) → cs [64][136];
// zero past rows, D and K.  kAsync: 16-byte cp.async (x and c 16-byte
// aligned, ldx, D and K multiples of 8, so a chunk is all in or all out);
// otherwise 2-byte loads.
template <bool kAsync>
__device__ __forceinline__ void tc_load_stage(const __nv_bfloat16* __restrict__ x, long long ldx,
                                              long long row0, int rows,
                                              const __nv_bfloat16* __restrict__ c, int k0, int d0,
                                              int D, int K, __nv_bfloat16* xs,
                                              __nv_bfloat16* cs) {
  if (kAsync) {
    for (int i = threadIdx.x; i < kTcRows * (kTcDepth / 8); i += kTcThreads) {
      const int r = i / (kTcDepth / 8), cc = (i % (kTcDepth / 8)) * 8;
      const bool ok = r < rows && d0 + cc < D;
      cp_async_16(smem_addr(xs + r * kTcXPitch + cc), ok ? x + (row0 + r) * ldx + d0 + cc : x,
                  ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < kTcDepth * (kBowClusters / 8); i += kTcThreads) {
      const int r = i / (kBowClusters / 8), cc = (i % (kBowClusters / 8)) * 8;
      const bool ok = d0 + r < D && k0 + cc < K;
      cp_async_16(smem_addr(cs + r * kTcCPitch + cc),
                  ok ? c + (long long)(d0 + r) * K + k0 + cc : c, ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < kTcRows * kTcDepth; i += kTcThreads) {
      const int r = i / kTcDepth, dd = i % kTcDepth;
      xs[r * kTcXPitch + dd] = r < rows && d0 + dd < D ? x[(row0 + r) * ldx + d0 + dd] : zero;
    }
    for (int i = threadIdx.x; i < kTcDepth * kBowClusters; i += kTcThreads) {
      const int r = i / kBowClusters, kk = i % kBowClusters;
      cs[r * kTcCPitch + kk] =
          d0 + r < D && k0 + kk < K ? c[(long long)(d0 + r) * K + k0 + kk] : zero;
    }
  }
}

// Pass 1, grid (⌈K/128⌉, ⌈B·S/128⌉): X rows [row0, row0 + 128) · C[:, k0 :
// k0 + 128) as a GEMM in f32 through the cp.async ring (acc[mi][ni][e] is
// row wm·64 + 16mi + g + 8·(e / 2), cluster wn·32 + 8ni + 2t + e % 2 for
// warp (wm, wn), lane 4g + t), then the folded BN; writes the logits to
// logits [B·S, K] and each row's tile max and Σ exp(logit − max) to
// tmax/tsum [B·S, ⌈K/128⌉].
template <bool kAsync>
__global__ void __launch_bounds__(kTcThreads, 2)
softdbow_logits_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                       const __nv_bfloat16* __restrict__ c, const float* __restrict__ scale,
                       const float* __restrict__ bias, float* __restrict__ logits,
                       float* __restrict__ tmax, float* __restrict__ tsum, long long BS, int D,
                       int K) {
  extern __shared__ float4 tc_smem4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(tc_smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x, nkt = gridDim.x, k0 = kt * kBowClusters;
  const long long row0 = (long long)blockIdx.y * kTcRows;
  const int rows = (int)min((long long)kTcRows, BS - row0);
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3), b_col = (lane >> 4) * 8;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int nk = (D + kTcDepth - 1) / kTcDepth;
  auto load = [&](int step) {
    __nv_bfloat16* xs = ring + (step % kTcStages) * kTcStage;
    tc_load_stage<kAsync>(x, ldx, row0, rows, c, k0, step * kTcDepth, D, K, xs,
                          xs + kTcRows * kTcXPitch);
  };
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();  // one group per step, empty or not, so the wait below is uniform
  }
  for (int step = 0; step < nk; ++step) {
    cp_async_wait<kTcStages - 2>();  // this thread's copies of this step have landed
    __syncthreads();                 // and everyone's; the stage loaded next was freed at step − 1
    if (step + kTcStages - 1 < nk) load(step + kTcStages - 1);
    cp_async_commit();
    const __nv_bfloat16* xs = ring + (step % kTcStages) * kTcStage;
    const __nv_bfloat16* cs = xs + kTcRows * kTcXPitch;
#pragma unroll
    for (int ks = 0; ks < kTcDepth / 16; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi],
                    smem_addr(xs + (wm * 64 + 16 * mi + a_row) * kTcXPitch + 16 * ks + a_col));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, smem_addr(cs + (16 * ks + b_row) * kTcCPitch + wn * 32 + 16 * np + b_col));
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the row reduction below

  // the folded BN, −inf past K, in place; the logits of real rows and
  // clusters to device memory (two neighbours at a time where K is even)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int k = k0 + wn * 32 + 8 * ni + 2 * t;  // and k + 1
    const float sc0 = k < K ? scale[k] : 0.f, bi0 = k < K ? bias[k] : 0.f;
    const float sc1 = k + 1 < K ? scale[k + 1] : 0.f, bi1 = k + 1 < K ? bias[k + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float* v = &acc[mi][ni][2 * hr];
        v[0] = k < K ? __fadd_rn(__fmul_rn(v[0], sc0), bi0) : -INFINITY;
        v[1] = k + 1 < K ? __fadd_rn(__fmul_rn(v[1], sc1), bi1) : -INFINITY;
        const int r = wm * 64 + 16 * mi + g + 8 * hr;
        if (r >= rows || k >= K) continue;
        float* dst = logits + (row0 + r) * K + k;
        if (kAsync) {  // K % 8 == 0
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          dst[0] = v[0];
          if (k + 1 < K) dst[1] = v[1];
        }
      }
  }

  // a row's 128 logits lie in the 4 lanes of a quad in each of the 4 warps
  // wn: max over the quad by shuffles, over the warps through shared memory
  // in a fixed order, then Σ exp the same way
  float* red = reinterpret_cast<float*>(tc_smem4);  // [2][4 wn][128 rows]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float m = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        m = fmaxf(m, fmaxf(acc[mi][ni][2 * hr], acc[mi][ni][2 * hr + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (t == 0) red[wn * kTcRows + wm * 64 + 16 * mi + g + 8 * hr] = m;
    }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm * 64 + 16 * mi + g + 8 * hr;
      const float m = fmaxf(fmaxf(red[r], red[kTcRows + r]),
                            fmaxf(red[2 * kTcRows + r], red[3 * kTcRows + r]));
      float e = 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        e += expf(acc[mi][ni][2 * hr] - m) + expf(acc[mi][ni][2 * hr + 1] - m);
      e += __shfl_xor_sync(0xffffffffu, e, 1);
      e += __shfl_xor_sync(0xffffffffu, e, 2);
      if (t == 0) red[(4 + wn) * kTcRows + r] = e;
    }
  __syncthreads();
  if (tid < rows) {
    const float* rm = red + tid;
    const float* rs = red + 4 * kTcRows + tid;
    tmax[(row0 + tid) * nkt + kt] =
        fmaxf(fmaxf(rm[0], rm[kTcRows]), fmaxf(rm[2 * kTcRows], rm[3 * kTcRows]));
    tsum[(row0 + tid) * nkt + kt] = ((rs[0] + rs[kTcRows]) + rs[2 * kTcRows]) + rs[3 * kTcRows];
  }
}

// Between the passes, one thread a row: the row's max m over its tiles'
// maxima and z = Σ_tiles sum·exp(max − m) in tile order, written over the
// row's first partials as (m, 1/z).
__global__ void softdbow_combine_kernel(float* __restrict__ tmax, float* __restrict__ tsum,
                                        long long rows, int nkt) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float* pm = tmax + row * nkt;
  float* ps = tsum + row * nkt;
  float m = -INFINITY;
  for (int i = 0; i < nkt; ++i) m = fmaxf(m, pm[i]);
  float z = 0.f;
  for (int i = 0; i < nkt; ++i) z += ps[i] * expf(pm[i] - m);
  pm[0] = m;
  ps[0] = 1.f / z;
}

// Pass 2, grid (⌈K/128⌉, ⌈B/2⌉), 256 threads: thread (part, col) sums
// exp(logit − m)·(1/z) over the S rows of video 2·blockIdx.y + part, in row
// order, into bow[b, k0 + col].  A warp reads 32 neighbouring logits of a row.
__global__ void __launch_bounds__(kTcThreads)
softdbow_hist_from_logits_kernel(const float* __restrict__ logits, const float* __restrict__ tmax,
                                 const float* __restrict__ tsum, float* __restrict__ bow, int B,
                                 int S, int K) {
  const int col = threadIdx.x & (kBowClusters - 1), part = threadIdx.x >> 7;
  const int k = blockIdx.x * kBowClusters + col, b = blockIdx.y * 2 + part, nkt = gridDim.x;
  if (b >= B || k >= K) return;
  const long long row0 = (long long)b * S;
  float q = 0.f;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const long long row = row0 + s;
    q += expf(logits[row * K + k] - tmax[row * nkt]) * tsum[row * nkt];
  }
  bow[(long long)b * K + k] = q;
}

template <bool kAsync>
cudaError_t run_softdbow_tc(const __nv_bfloat16* x, long long ldx, const __nv_bfloat16* c,
                            const float* scale, const float* bias, float* bow, float* ws_max,
                            float* ws_sum, float* ws_logits, int B, int S, int D, int K,
                            cudaStream_t stream) {
  const long long rows = (long long)B * S;
  const int nkt = (K + kBowClusters - 1) / kBowClusters;
  if ((rows + kTcRows - 1) / kTcRows > 65535) return cudaErrorInvalidValue;
  const void* kernel = (const void*)softdbow_logits_kernel<kAsync>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kTcSmemBytes);
  if (err == cudaSuccess)  // room for two blocks an SM
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  softdbow_logits_kernel<kAsync>
      <<<dim3(nkt, (unsigned)((rows + kTcRows - 1) / kTcRows)), kTcThreads, kTcSmemBytes, stream>>>(
          x, ldx, c, scale, bias, ws_logits, ws_max, ws_sum, rows, D, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  softdbow_combine_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(ws_max, ws_sum, rows,
                                                                               nkt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  softdbow_hist_from_logits_kernel<<<dim3(nkt, (B + 1) / 2), kTcThreads, 0, stream>>>(
      ws_logits, ws_max, ws_sum, bow, B, S, K);
  return cudaGetLastError();
}

// ws_max and ws_sum each hold B·S·⌈K/128⌉ floats, ws_logits B·S·K.
cudaError_t run_softdbow(const __nv_bfloat16* x, long long ldx, const __nv_bfloat16* c,
                         const float* scale, const float* bias, float* bow, float* ws_max,
                         float* ws_sum, float* ws_logits, int B, int S, int D, int K,
                         cudaStream_t stream) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(c);
  if (base % 16 == 0 && ldx % 8 == 0 && D % 8 == 0 && K % 8 == 0)
    return run_softdbow_tc<true>(x, ldx, c, scale, bias, bow, ws_max, ws_sum, ws_logits, B, S, D,
                                 K, stream);
  return run_softdbow_tc<false>(x, ldx, c, scale, bias, bow, ws_max, ws_sum, ws_logits, B, S, D, K,
                                stream);
}

// Both f32 passes.  ws_max and ws_sum each hold B·S·⌈K/128⌉ floats, scratch
// allocated by the caller.
cudaError_t run_softdbow(const float* x, long long ldx, const float* c, const float* scale,
                         const float* bias, float* bow, float* ws_max, float* ws_sum, int B,
                         int S, int D, int K, cudaStream_t stream) {
  using T = float;
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

// ws_logits: B·S·K floats of scratch for bf16 x, unused (may be null) for f32.
extern "C" int lpm_softdbow_fused(const void* x, long long ldx, int x_is_bf16, const void* c,
                                  const void* scale, const void* bias, void* bow, void* ws_max,
                                  void* ws_sum, void* ws_logits, int B, int S, int D, int K,
                                  void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* out = static_cast<float*>(bow);
  float* wm = static_cast<float*>(ws_max);
  float* ws = static_cast<float*>(ws_sum);
  if (x_is_bf16) {
    using bf16 = __nv_bfloat16;
    err = lpm::run_softdbow(static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(c), sc, bi,
                            out, wm, ws, static_cast<float*>(ws_logits), B, S, D, K, st);
  } else {
    err = lpm::run_softdbow(static_cast<const float*>(x), ldx, static_cast<const float*>(c), sc,
                            bi, out, wm, ws, B, S, D, K, st);
  }
  return (int)err;
}
