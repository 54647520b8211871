// The native runner: each model's fast route (uint8 frames or video-level
// features → top-k classes) with no Python and no libtorch in its execution
// path, for export_model.py's with_stablehlo artifact (native_manifest.txt +
// weights.bin, the route's arrays as its kernels read them).
// core/native_runtime.py binds it in-process through ctypes;
// native/serving_main.cc links it into lpm_serve.
//
// It takes the place of the JAX package's native runtime
// (learnablepoolingmethods_tpu/core/native_runtime.py over
// native/stablehlo_runner.cc, which runs the exported StableHLO module of
// make_predict_step with XLA's PJRT CPU client).  The card's machine has
// neither XLA nor StableHLO, so this runner runs each route's own steps
// instead, one batch on one stream of the runner's:
//
//   fast_netvlad_frontend  NetVLADModelLF: row 1 (fused_frontend.cu) draws,
//       stages and pools both modalities; the hidden FC as two products;
//       hidden_sum ((rgb + audio) + b); the gated MoE tail.
//   video_logistic  LogisticModel, f32: row_l2 of the input (the predict
//       step's preprocess_input), SGEMM, bias_sigmoid.
//   video_moe  MoeModel, f32: row_l2, the gate and expert SGEMMs,
//       moe_combine.
//   fast_dbof  DbofModel (ops/fast_dbof.py): frame_stage (iid frames, or one
//       window a video: the manifest's sampling line), the cluster product
//       (input and cluster BNs folded into it), bias_relu6, frame_pool
//       (average or max), the hidden product, bias_relu6 to bf16, the MoE.
//   fast_lf_netrvlad, fast_lf_softdbow, fast_lf_netfv, fast_lf_nextvlad
//       (ops/fast_lf.py): frame_stage with the folded input BN; a modality's
//       pooling: row 2 (netvlad_fused.cu, zero centres), row 6
//       (softdbow_fused.cu) then row_l2, row 5 (netfv_fused.cu: fv1 and fv2),
//       or NeXtVLAD's products (the expansion, written as bf16 by cuBLAS,
//       the group gate and the assignment, nextvlad_assign, a batched
//       product per video,
//       nextvlad_residual, row_l2 with the folded vlad_bn); the hidden FC's
//       products (NetFV: fv1's and fv2's rows apart); hidden_sum
//       (b + modality 0 + modality 1); the gated MoE tail.
//   The gated MoE tail: the gating product on the rounded h, gating, the
//   MoE's gate and expert products, moe_combine; every route then topk.
//
// Rows 1, 2, 5 and 6 are compiled into this library and nowhere else
// (ops/kernel_build.py LIBRARY_PARTS): their Python wrappers call them here
// too.  The JAX package leaves the products and the element-wise steps to
// XLA; so cuBLAS computes the products here (bf16 × bf16 → f32, or rounded
// once to bf16 from the f32 sum for NeXtVLAD's expansion, or f32 with TF32
// off for the two video-level routes), and the rest are small hand kernels.  What
// bounds them: each reads its inputs and writes its outputs once (bytes;
// at B=256, V=3862 moe_combine moves 20 MB, about 6 µs at 3.35 TB/s).
// They are simple first: one thread an element for the element-wise ones
// (grid-stride), one warp a row for frame_stage, row_l2 and
// nextvlad_assign, one block a (video, cluster) for nextvlad_residual, and
// for topk one block a row that keeps the row in shared memory and takes k
// rounds of a block-wide argmax, each round over the entries that order
// after the previous pick.  chip_smoke.py holds each against its plain
// version (ops/native_tail.py) and times it beside its bound.
//
// Arithmetic that the gate against the torch route needs: the sigmoid is
// 1 / (1 + expf(−x)) and the softmax exp(x − max) / Σ, each with expf (not
// __expf), as PyTorch computes them on the card; products and sums round
// where the route rounds (__fmul_rn / __fadd_rn keep nvcc from fusing them);
// the bf16 dequantize rounds after its multiply and after its add, as
// PyTorch's bf16 arithmetic does.
//
// The C API takes no CUDA or torch types; errors come back as strings.  The
// runner counts its own launches of each kernel (lpm_runner_launches); the
// Python wrappers' counters never see them.

#include <cublas_v2.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include "native_manifest.h"
#include "threefry.cuh"

extern "C" int lpm_netvlad_frontend(
    const void* x, unsigned int k0, unsigned int k1, const void* num_frames,
    const void* in_scale, const void* in_bias,
    const void* c_rgb, const void* s_rgb, const void* b_rgb, const void* c2_rgb,
    const void* c_aud, const void* s_aud, const void* b_aud, const void* c2_aud,
    void* out_rgb, void* out_aud, void* ws_x, void* ws_a_rgb, void* ws_a_aud,
    void* ws_colsq_rgb, void* ws_colsq_aud, int B, int F, int DT, int S, int d_rgb,
    int k_rgb, int d_aud, int k_aud, float deq_scale, float deq_bias, long long row_offset,
    void* stream);
extern "C" int lpm_netvlad_fused(const void* x, long long ldx, int x_is_bf16, const void* c,
                                 const void* scale, const void* bias, const void* c2,
                                 void* out, void* ws_a, void* ws_colsq, int B, int S, int D,
                                 int K, int two_pass, void* stream);
extern "C" int lpm_softdbow_fused(const void* x, long long ldx, int x_is_bf16, const void* c,
                                  const void* scale, const void* bias, void* bow, void* ws_max,
                                  void* ws_sum, void* ws_logits, int B, int S, int D, int K,
                                  void* stream);
extern "C" int lpm_netfv_fused(const void* x, long long ldx, int x_is_bf16, const void* c,
                               const void* scale, const void* bias, const void* c2,
                               const void* covar, void* out1, void* out2, void* ws_a,
                               void* ws_colsq, int B, int S, int D, int K, void* stream);

namespace lpm_native {

using bf16 = __nv_bfloat16;

// ops/fused_frontend.py's DEQ_SCALE and DEQ_BIAS, rounded to f32 as ctypes
// rounds the Python floats
constexpr float kDeqScale = static_cast<float>(4.0 / 255.0);
constexpr float kDeqBias = static_cast<float>(4.0 / 512.0 - 2.0);
constexpr float kEps = 1e-12f;           // ops/normalize.py's ε on Σx²
constexpr int kMaxClusters = 512;        // netvlad_core.cuh kMaxClusters (rows 1, 2, 5)
constexpr int kEwThreads = 256;
constexpr int kRowThreads = 256;         // one warp a row, 8 rows a block
constexpr int kRowsPerBlock = kRowThreads / 32;
constexpr int kResidualThreads = 128;
constexpr int kTopkThreads = 256;
constexpr int kMaxTopkSmem = 232448;  // an H100 block's dynamic shared memory at most
constexpr int kMaxParts = 4;          // hidden_sum's products (NetFV: fv1, fv2 of two modalities)
constexpr int kMaxMods = 2;

// the counted launches, in lpm_runner_launches' names
enum Counter {
  kFrontend, kNetvladFused, kSoftdbowFused, kNetfvFused, kFrameStage, kBiasSigmoid, kBiasRelu6,
  kFramePool, kRowL2, kNextvladAssign, kNextvladResidual, kHiddenSum, kGating,
  kMoeCombine, kTopk, kNumCounters
};
const char* const kCounterNames[kNumCounters] = {
    "netvlad_frontend", "netvlad_fused", "softdbow_fused", "netfv_fused", "frame_stage",
    "bias_sigmoid", "bias_relu6", "frame_pool", "row_l2", "nextvlad_assign",
    "nextvlad_residual", "hidden_sum", "gating", "moe_combine", "topk"};

// kRoutes' order (native_manifest.h)
enum Route { kNetvlad, kLogistic, kMoe, kDbof, kNetrvlad, kSoftdbow, kNetfv, kNextvlad };

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ long long grid_start() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long grid_step() { return (long long)gridDim.x * blockDim.x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// h = the products p[0..n) taken `group` at a time (a modality's, summed
// left to right), then bias + G_0 + G_1 … (bias_first: the LF routes) or
// (G_0 + G_1 …) + bias (Willow's); and h rounded to bf16.  rows × H entries.
__global__ void hidden_sum_kernel(const float* __restrict__ p0, const float* __restrict__ p1,
                                  const float* __restrict__ p2, const float* __restrict__ p3,
                                  int n_parts, int group, int bias_first,
                                  const float* __restrict__ bias, float* __restrict__ h,
                                  bf16* __restrict__ hb, long long n, int H) {
  const float* parts[kMaxParts] = {p0, p1, p2, p3};
  for (long long i = grid_start(); i < n; i += grid_step()) {
    const float b = bias[(int)(i % H)];
    float acc = b;
    for (int g = 0; g < n_parts; g += group) {
      float s = parts[g][i];
      for (int j = 1; j < group; ++j) s = __fadd_rn(s, parts[g + j][i]);
      acc = (bias_first || g > 0) ? __fadd_rn(acc, s) : s;
    }
    if (!bias_first) acc = __fadd_rn(acc, b);
    h[i] = acc;
    hb[i] = __float2bfloat16_rn(acc);
  }
}

// out = bf16(h · σ(gates · g_scale[col] + g_bias[col]))
__global__ void gating_kernel(const float* __restrict__ gates, const float* __restrict__ h,
                              const float* __restrict__ g_scale, const float* __restrict__ g_bias,
                              bf16* __restrict__ out, long long n, int H) {
  for (long long i = grid_start(); i < n; i += grid_step()) {
    const int c = (int)(i % H);
    const float g = __fadd_rn(__fmul_rn(gates[i], g_scale[c]), g_bias[c]);
    out[i] = __float2bfloat16_rn(__fmul_rn(h[i], sigmoid(g)));
  }
}

// ga [B, (M+1)·V] and ea [B, M·V] keep class v's mixture m in column m·V + v;
// probs[b, v] = Σ_{m<M} softmax_m(ga[b, :, v]) · σ(ea[b, m, v] + eb[m·V + v])
__global__ void moe_combine_kernel(const float* __restrict__ ga, const float* __restrict__ ea,
                                   const float* __restrict__ eb, float* __restrict__ probs, int B,
                                   int M, int V) {
  const long long n = (long long)B * V;
  for (long long i = grid_start(); i < n; i += grid_step()) {
    const long long b = i / V;
    const int v = (int)(i % V);
    const float* g = ga + b * (M + 1) * V + v;
    const float* e = ea + b * M * V + v;
    float mx = g[0];
    for (int m = 1; m <= M; ++m) mx = fmaxf(mx, g[(long long)m * V]);
    float sum = 0.f;
    for (int m = 0; m <= M; ++m) sum = __fadd_rn(sum, expf(__fsub_rn(g[(long long)m * V], mx)));
    float p = 0.f;
    for (int m = 0; m < M; ++m) {
      const float pm = __fdiv_rn(expf(__fsub_rn(g[(long long)m * V], mx)), sum);
      const float sg = sigmoid(__fadd_rn(e[(long long)m * V], eb[(long long)m * V + v]));
      p = __fadd_rn(p, __fmul_rn(pm, sg));
    }
    probs[i] = p;
  }
}

// A total order of (score, index) as one integer, larger first: the score's
// order (NaN above +inf, −0 equal to +0, as a stable descending sort puts
// them), then the lower index.
__device__ __forceinline__ unsigned long long topk_key(float v, int i) {
  uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);
  u = isnan(v) ? 0xffffffffu : ((u & 0x80000000u) ? ~u : (u | 0x80000000u));
  return ((unsigned long long)u << 32) | (0xffffffffu - (uint32_t)i);
}

__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, off);
    x = y > x ? y : x;
  }
  return x;
}

// One block a row: the row in shared memory, then k rounds of a block-wide
// max of topk_key over the entries whose key is below the previous pick's.
__global__ void __launch_bounds__(kTopkThreads)
topk_kernel(const float* __restrict__ probs, float* __restrict__ values,
            int32_t* __restrict__ indices, int V, int k) {
  extern __shared__ float row[];
  __shared__ unsigned long long partial[kTopkThreads / 32];
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < V; i += kTopkThreads) row[i] = probs[b * V + i];
  __syncthreads();
  unsigned long long prev = 0;
  for (int r = 0; r < k; ++r) {
    unsigned long long best = 0;
    for (int i = threadIdx.x; i < V; i += kTopkThreads) {
      const unsigned long long key = topk_key(row[i], i);
      if ((r == 0 || key < prev) && key > best) best = key;
    }
    best = warp_max_key(best);
    if (lane == 0) partial[warp] = best;
    __syncthreads();
    best = lane < kTopkThreads / 32 ? partial[lane] : 0;
    best = warp_max_key(best);
    __syncthreads();  // every warp has read partial before the next round writes it
    if (threadIdx.x == 0) {
      const int idx = (int)(0xffffffffu - (uint32_t)(best & 0xffffffffu));
      values[b * k + r] = row[idx];
      indices[b * k + r] = idx;
    }
    prev = best;
  }
}

// One warp a sampled row (b, s): the frame drawn from the key (iid:
// floor(U·min(nf, F)) clamped to F−1 with U the draw of counter b·S + s, as
// fused_frontend.cu draws it; window: the start floor(U·(max(nf − S, 0) + 1))
// with U the draw of counter b, frame min(start + s, nf − 1) clipped to
// [0, F)), its uint8 row dequantized in bf16 (rounded after the multiply and
// after the add), ℓ2 over the DT columns in f32, rounded to bf16, and with
// in_scale the folded input BN in f32 and one more rounding.
__global__ void __launch_bounds__(kRowThreads)
frame_stage_kernel(const uint8_t* __restrict__ x, uint32_t k0, uint32_t k1,
                   const int32_t* __restrict__ num_frames, const float* __restrict__ in_scale,
                   const float* __restrict__ in_bias, bf16* __restrict__ out, long long rows,
                   int F, int DT, int S, int window, float deq_scale, float deq_bias) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);  // b·S + s
  if (row >= rows) return;
  const long long b = row / S;
  const int s = (int)(row % S);
  const int nf = min(num_frames[b], F);
  int f;
  if (window) {
    const float u = lpm::threefry_uniform(k0, k1, b);
    const int start = (int)__fmul_rn(u, __fadd_rn((float)max(nf - S, 0), 1.0f));
    f = max(0, min(min(start + s, nf - 1), F - 1));
  } else {
    const float u = lpm::threefry_uniform(k0, k1, row);
    f = min((int)__fmul_rn(u, (float)nf), F - 1);
  }
  const float qs = round_bf16(deq_scale), qb = round_bf16(deq_bias);
  const uint8_t* src = x + (b * F + f) * DT;
  bf16* dst = out + row * DT;
  float ss = 0.f;
  for (int c = lane; c < DT; c += 32) {
    const float t = round_bf16(__fadd_rn(round_bf16(__fmul_rn((float)src[c], qs)), qb));
    ss = __fadd_rn(ss, __fmul_rn(t, t));
  }
  const float inv = rsqrtf(fmaxf(warp_sum(ss), kEps));
  for (int c = lane; c < DT; c += 32) {
    const float t = round_bf16(__fadd_rn(round_bf16(__fmul_rn((float)src[c], qs)), qb));
    float y = __fmul_rn(t, inv);
    if (in_scale) y = __fadd_rn(__fmul_rn(round_bf16(y), in_scale[c]), in_bias[c]);
    dst[c] = __float2bfloat16_rn(y);
  }
}

// out = act(y + bias[col]): kRelu6 clip(·, 0, 6), else σ; f32 (in place:
// out_f32 may be y) and/or bf16 out
template <bool kRelu6>
__global__ void bias_act_kernel(const float* y, const float* __restrict__ bias, float* out_f32,
                                bf16* __restrict__ out_bf16, long long n, int N) {
  for (long long i = grid_start(); i < n; i += grid_step()) {
    const float v = __fadd_rn(y[i], bias[(int)(i % N)]);
    const float a = kRelu6 ? fminf(fmaxf(v, 0.f), 6.f) : sigmoid(v);
    if (out_f32) out_f32[i] = a;
    if (out_bf16) out_bf16[i] = __float2bfloat16_rn(a);
  }
}

// out[b, c] = bf16(max or mean over s of act[b·S + s, c]); the mean is the
// sum times factor, as PyTorch's mean kernel scales its sum
__global__ void frame_pool_kernel(const float* __restrict__ act, bf16* __restrict__ out, int B,
                                  int S, int C, int max_pool, float factor) {
  const long long n = (long long)B * C;
  for (long long i = grid_start(); i < n; i += grid_step()) {
    const long long b = i / C;
    const int c = (int)(i % C);
    const float* p = act + b * S * C + c;
    float v = p[0];
    for (int s = 1; s < S; ++s)
      v = max_pool ? fmaxf(v, p[(long long)s * C]) : __fadd_rn(v, p[(long long)s * C]);
    out[i] = __float2bfloat16_rn(max_pool ? v : __fmul_rn(v, factor));
  }
}

// One warp a row of n: y = x · rsqrt(max(Σx², ε)), with scale the affine
// y · scale[j] + bias[j] (j = (row mod arows)·n + col), f32 and/or bf16 out
__global__ void __launch_bounds__(kRowThreads)
row_l2_kernel(const float* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, int arows, float* __restrict__ out_f32,
              bf16* __restrict__ out_bf16, long long rows, int n) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* src = x + row * n;
  float ss = 0.f;
  for (int c = lane; c < n; c += 32) ss = __fadd_rn(ss, __fmul_rn(src[c], src[c]));
  const float inv = rsqrtf(fmaxf(warp_sum(ss), kEps));
  const long long a0 = scale ? (row % arows) * n : 0;
  for (int c = lane; c < n; c += 32) {
    float y = __fmul_rn(src[c], inv);
    if (scale) y = __fadd_rn(__fmul_rn(y, scale[a0 + c]), bias[a0 + c]);
    if (out_f32) out_f32[row * n + c] = y;
    if (out_bf16) out_bf16[row * n + c] = __float2bfloat16_rn(y);
  }
}

// One warp a (frame row r, group g): the logits prod[r, g·K + k] · scale +
// bias, their softmax over K, times σ(gprod[r, g]); f32 and bf16 out, rows
// r·G + g of [R·G, K]
__global__ void __launch_bounds__(kRowThreads)
nextvlad_assign_kernel(const float* __restrict__ prod, const float* __restrict__ scale,
                       const float* __restrict__ bias, const float* __restrict__ gprod,
                       float* __restrict__ assign, bf16* __restrict__ assign_bf16, long long rows,
                       int G, int K) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);  // r·G + g
  if (row >= rows) return;
  const int g = (int)(row % G);
  const float* p = prod + row * K;  // [R, G·K] row r, group g = element (r·G + g)·K
  const float* sc = scale + (long long)g * K;
  const float* bi = bias + (long long)g * K;
  float mx = -INFINITY;
  for (int k = lane; k < K; k += 32) mx = fmaxf(mx, __fadd_rn(__fmul_rn(p[k], sc[k]), bi[k]));
  mx = warp_max(mx);
  float sum = 0.f;
  for (int k = lane; k < K; k += 32)
    sum = __fadd_rn(sum, expf(__fsub_rn(__fadd_rn(__fmul_rn(p[k], sc[k]), bi[k]), mx)));
  sum = warp_sum(sum);
  const float alpha = sigmoid(gprod[row]);
  for (int k = lane; k < K; k += 32) {
    const float e = expf(__fsub_rn(__fadd_rn(__fmul_rn(p[k], sc[k]), bi[k]), mx));
    const float a = __fmul_rn(__fdiv_rn(e, sum), alpha);
    assign[row * K + k] = a;
    assign_bf16[row * K + k] = __float2bfloat16_rn(a);
  }
}

// One block a (video b, cluster k): Σ_r assign[b·SG + r, k] over the video's
// S·G rows, then out[b, k, :] = agg[b, k, :] − Σ · c2[k, :] (out may be agg)
__global__ void __launch_bounds__(kResidualThreads)
nextvlad_residual_kernel(const float* agg, const float* __restrict__ assign,
                         const float* __restrict__ c2, float* out, int SG, int K, int Dp) {
  __shared__ float partial[kResidualThreads / 32];
  const long long b = blockIdx.x / K;
  const int k = (int)(blockIdx.x % K);
  float s = 0.f;
  for (int r = threadIdx.x; r < SG; r += kResidualThreads)
    s = __fadd_rn(s, assign[(b * SG + r) * K + k]);
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = s;
  __syncthreads();
  float asum = 0.f;
  for (int w = 0; w < kResidualThreads / 32; ++w) asum = __fadd_rn(asum, partial[w]);
  const long long base = (b * K + k) * Dp;
  for (int d = threadIdx.x; d < Dp; d += kResidualThreads)
    out[base + d] = __fsub_rn(agg[base + d], __fmul_rn(asum, c2[(long long)k * Dp + d]));
}

unsigned ew_blocks(long long n) {
  const long long blocks = (n + kEwThreads - 1) / kEwThreads;
  return (unsigned)(blocks < 4096 ? (blocks < 1 ? 1 : blocks) : 4096);
}

unsigned row_blocks(long long rows) {
  return (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

cudaError_t launch_hidden_sum(const float* const* parts, int n_parts, int group, int bias_first,
                              const float* bias, float* h, bf16* hb, long long rows, int H,
                              cudaStream_t st) {
  if (rows < 1 || H < 1 || n_parts < 1 || n_parts > kMaxParts || group < 1 ||
      n_parts % group)
    return cudaErrorInvalidValue;
  const float* p[kMaxParts] = {nullptr, nullptr, nullptr, nullptr};
  for (int i = 0; i < n_parts; ++i) p[i] = parts[i];
  const long long n = rows * H;
  hidden_sum_kernel<<<ew_blocks(n), kEwThreads, 0, st>>>(p[0], p[1], p[2], p[3], n_parts, group,
                                                         bias_first, bias, h, hb, n, H);
  return cudaGetLastError();
}

cudaError_t launch_gating(const float* gates, const float* h, const float* g_scale,
                          const float* g_bias, bf16* out, long long rows, int H, cudaStream_t st) {
  if (rows < 1 || H < 1) return cudaErrorInvalidValue;
  const long long n = rows * H;
  gating_kernel<<<ew_blocks(n), kEwThreads, 0, st>>>(gates, h, g_scale, g_bias, out, n, H);
  return cudaGetLastError();
}

cudaError_t launch_moe_combine(const float* ga, const float* ea, const float* eb, float* probs,
                               int B, int M, int V, cudaStream_t st) {
  if (B < 1 || M < 1 || V < 1) return cudaErrorInvalidValue;
  moe_combine_kernel<<<ew_blocks((long long)B * V), kEwThreads, 0, st>>>(ga, ea, eb, probs, B, M,
                                                                         V);
  return cudaGetLastError();
}

cudaError_t launch_topk(const float* probs, float* values, int32_t* indices, int B, int V, int k,
                        cudaStream_t st) {
  const long long smem = (long long)V * sizeof(float);
  if (B < 1 || V < 1 || k < 1 || k > V || smem > kMaxTopkSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)topk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topk_kernel<<<B, kTopkThreads, smem, st>>>(probs, values, indices, V, k);
  return cudaGetLastError();
}

cudaError_t launch_frame_stage(const uint8_t* x, uint32_t k0, uint32_t k1, const int32_t* nf,
                               const float* in_scale, const float* in_bias, bf16* out, int B,
                               int F, int DT, int S, int window, float deq_scale,
                               float deq_bias, cudaStream_t st) {
  if (B < 1 || F < 1 || DT < 1 || S < 1 || (in_scale == nullptr) != (in_bias == nullptr))
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * S;
  frame_stage_kernel<<<row_blocks(rows), kRowThreads, 0, st>>>(
      x, k0, k1, nf, in_scale, in_bias, out, rows, F, DT, S, window, deq_scale, deq_bias);
  return cudaGetLastError();
}

cudaError_t launch_bias_act(bool relu6, const float* y, const float* bias, float* out_f32,
                            bf16* out_bf16, long long rows, int N, cudaStream_t st) {
  if (rows < 1 || N < 1 || (!out_f32 && !out_bf16)) return cudaErrorInvalidValue;
  const long long n = rows * N;
  if (relu6)
    bias_act_kernel<true><<<ew_blocks(n), kEwThreads, 0, st>>>(y, bias, out_f32, out_bf16, n, N);
  else
    bias_act_kernel<false><<<ew_blocks(n), kEwThreads, 0, st>>>(y, bias, out_f32, out_bf16, n, N);
  return cudaGetLastError();
}

cudaError_t launch_frame_pool(const float* act, bf16* out, int B, int S, int C, int max_pool,
                              cudaStream_t st) {
  if (B < 1 || S < 1 || C < 1) return cudaErrorInvalidValue;
  const long long n = (long long)B * C;
  const float factor = (float)n / (float)(n * S);
  frame_pool_kernel<<<ew_blocks(n), kEwThreads, 0, st>>>(act, out, B, S, C, max_pool, factor);
  return cudaGetLastError();
}

cudaError_t launch_row_l2(const float* x, const float* scale, const float* bias, int arows,
                          float* out_f32, bf16* out_bf16, long long rows, int n,
                          cudaStream_t st) {
  if (rows < 1 || n < 1 || (!out_f32 && !out_bf16) || (scale == nullptr) != (bias == nullptr) ||
      (scale && (arows < 1 || rows % arows)))
    return cudaErrorInvalidValue;
  row_l2_kernel<<<row_blocks(rows), kRowThreads, 0, st>>>(x, scale, bias, arows, out_f32,
                                                           out_bf16, rows, n);
  return cudaGetLastError();
}

cudaError_t launch_nextvlad_assign(const float* prod, const float* scale, const float* bias,
                                   const float* gprod, float* assign, bf16* assign_bf16,
                                   long long R, int G, int K, cudaStream_t st) {
  if (R < 1 || G < 1 || K < 1) return cudaErrorInvalidValue;
  const long long rows = R * G;
  nextvlad_assign_kernel<<<row_blocks(rows), kRowThreads, 0, st>>>(prod, scale, bias, gprod,
                                                                     assign, assign_bf16, rows, G,
                                                                     K);
  return cudaGetLastError();
}

cudaError_t launch_nextvlad_residual(const float* agg, const float* assign, const float* c2,
                                     float* out, int B, int SG, int K, int Dp, cudaStream_t st) {
  if (B < 1 || SG < 1 || K < 1 || Dp < 1) return cudaErrorInvalidValue;
  nextvlad_residual_kernel<<<(unsigned)((long long)B * K), kResidualThreads, 0, st>>>(
      agg, assign, c2, out, SG, K, Dp);
  return cudaGetLastError();
}

// row-major C[M, N] (row stride ldc) = A[M, K] (row stride lda) · B[K, N]
// (row stride ldb), A and B of `type` (bf16 or f32), summed in f32 (no
// TF32); C of `ctype`: f32, or bf16 rounded once from the f32 sum (the
// handle's math mode keeps cuBLAS from reducing a split sum in bf16).
// cuBLAS is column-major: the row-major buffers are Cᵀ, Aᵀ and Bᵀ there, so
// it computes Cᵀ = Bᵀ · Aᵀ.
cublasStatus_t gemm(cublasHandle_t h, cudaDataType type, const void* a, long long lda,
                    const void* b, long long ldb, void* c, cudaDataType ctype, long long ldc,
                    long long M, long long N, long long K) {
  const float one = 1.f, zero = 0.f;
  return cublasGemmEx(h, CUBLAS_OP_N, CUBLAS_OP_N, (int)N, (int)M, (int)K, &one, b, type, (int)ldb,
                      a, type, (int)lda, &zero, c, ctype, (int)ldc, CUBLAS_COMPUTE_32F,
                      CUBLAS_GEMM_DEFAULT);
}

cublasStatus_t gemm_bf16(cublasHandle_t h, const bf16* a, const bf16* b, float* c, long long M,
                         long long N, long long K) {
  return gemm(h, CUDA_R_16BF, a, K, b, N, c, CUDA_R_32F, N, M, N, K);
}

cublasStatus_t gemm_f32(cublasHandle_t h, const float* a, const float* b, float* c, long long M,
                        long long N, long long K) {
  return gemm(h, CUDA_R_32F, a, K, b, N, c, CUDA_R_32F, N, M, N, K);
}

// One LOUPE modality: its columns of the frames, its arrays, its buffers.
struct Mod {
  int d = 0, k = 0, off = 0, g = 0, dp = 0, width = 0;  // width: NeXtVLAD's λ·D
  const bf16 *cluster = nullptr, *w1 = nullptr, *w2 = nullptr, *wg = nullptr, *wa = nullptr;
  const float *scale = nullptr, *bias = nullptr, *c2 = nullptr, *covar = nullptr,
              *vscale = nullptr, *vbias = nullptr;
  bf16 *out1 = nullptr, *out2 = nullptr, *bow_b = nullptr, *xt = nullptr, *assign_b = nullptr,
       *vlad = nullptr;
  float *bow = nullptr, *ws_a = nullptr, *ws_colsq = nullptr, *ws_max = nullptr,
        *ws_sum = nullptr, *ws_logits = nullptr, *gp = nullptr, *lp = nullptr,
        *assign = nullptr, *agg = nullptr;
};

struct Runner {
  Manifest m;
  Route route = kNetvlad;
  int device = 0;
  int B = 0, F = 0, DT = 0, S = 0, H = 0, V = 0, M = 0, k = 0, C = 0, n_mods = 0, n_parts = 0;
  Mod mods[kMaxMods];
  cudaStream_t stream = nullptr;
  cublasHandle_t blas = nullptr;
  char* weights = nullptr;  // every array, each at a 256-byte boundary
  std::map<std::string, char*> w;
  char* ws = nullptr;       // the batch's workspaces
  char* pinned = nullptr;
  std::vector<std::pair<void**, size_t>> parts_ws;  // workspace pointer → bytes
  // inputs on the card
  void* x = nullptr;  // u8 [B, F, DT] or f32 [B, DT]
  int32_t* nf = nullptr;
  size_t in_bytes = 0;
  // shared buffers
  bf16 *xs = nullptr, *vlad_rgb = nullptr, *vlad_aud = nullptr, *hb = nullptr, *hg = nullptr,
       *pooled = nullptr;
  float *ws_a_rgb = nullptr, *ws_a_aud = nullptr, *ws_cs_rgb = nullptr, *ws_cs_aud = nullptr,
        *xn = nullptr, *act = nullptr, *hh = nullptr, *h = nullptr, *gates = nullptr,
        *ga = nullptr, *ea = nullptr, *probs = nullptr, *values = nullptr;
  float* contrib[kMaxParts] = {nullptr, nullptr, nullptr, nullptr};
  int32_t* indices = nullptr;
  // pinned staging on the host
  void* px = nullptr;
  int32_t* pnf = nullptr;
  float *pvalues = nullptr, *pprobs = nullptr;
  int32_t* pindices = nullptr;
  std::mutex mu;  // one batch at a time
  std::atomic<long long> launches[kNumCounters];

  Runner() {
    for (auto& c : launches) c.store(0);
  }

  template <typename T>
  const T* W(const std::string& name) const {
    auto it = w.find(name);
    return it == w.end() ? nullptr : reinterpret_cast<const T*>(it->second);
  }

  template <typename T>
  void need_ws(T** ptr, size_t elems) {
    parts_ws.emplace_back(reinterpret_cast<void**>(ptr), elems * sizeof(T));
  }

  void count(Counter c) { launches[c]++; }

  ~Runner() {
    if (device >= 0) cudaSetDevice(device);
    if (blas) cublasDestroy(blas);
    if (stream) cudaStreamDestroy(stream);
    cudaFree(weights);
    cudaFree(ws);
    cudaFreeHost(pinned);
  }
};

bool cuda_ok(cudaError_t e, const char* what, std::string* err) {
  if (e == cudaSuccess) return true;
  *err = std::string(what) + ": " + cudaGetErrorString(e);
  return false;
}

bool blas_ok(cublasStatus_t s, const char* what, std::string* err) {
  if (s == CUBLAS_STATUS_SUCCESS) return true;
  *err = std::string(what) + ": " + cublasGetStatusString(s);
  return false;
}

std::string dims_str(const std::vector<int64_t>& d) {
  std::string s = "[";
  for (size_t i = 0; i < d.size(); ++i) s += (i ? ", " : "") + std::to_string(d[i]);
  return s + "]";
}

// The shapes of weights.bin's arrays: each array a route reads must be in
// the manifest with its dtype, and of the shape `want` (−1: any extent,
// which the caller reads back from the returned spec).
struct ShapeCheck {
  const Manifest& m;
  std::string* err;
  bool ok = true;

  const ArraySpec* get(const std::string& name, const char* tag, std::vector<int64_t> want) {
    if (!ok) return nullptr;
    const ArraySpec* a = m.weight(name);
    if (!a || a->tag != tag) {
      *err = std::string("weights.bin lacks ") + tag + " array " + name;
      ok = false;
      return nullptr;
    }
    bool same = a->dims.size() == want.size();
    for (size_t i = 0; same && i < want.size(); ++i) same = want[i] < 0 || want[i] == a->dims[i];
    if (!same) {
      *err = name + " has shape " + dims_str(a->dims) + ", expected " + dims_str(want);
      ok = false;
      return nullptr;
    }
    return a;
  }

  int64_t dim(const std::string& name, const char* tag, std::vector<int64_t> want, int axis) {
    const ArraySpec* a = get(name, tag, want);
    return a ? a->dims[axis] : 0;
  }

  bool fail(const std::string& msg) {
    if (ok) *err = msg;
    ok = false;
    return false;
  }
};

// the gated MoE tail's arrays (every LOUPE route's and Willow's)
void check_tail(ShapeCheck& c, Runner* r) {
  const int64_t H = r->H, M = r->M;
  c.get("hidden_b", "f32", {H});
  c.get("gate_w", "bf16", {H, H});
  c.get("g_scale", "f32", {H});
  c.get("g_bias", "f32", {H});
  if (c.ok && (M < 1 || c.dim("experts_bias", "f32", {-1}, 0) % M != 0))
    c.fail("moe_num_mixtures must be positive and divide experts_bias's length");
  r->V = c.ok ? (int)(c.dim("experts_bias", "f32", {-1}, 0) / M) : 0;
  c.get("gates_kernel", "bf16", {H, (M + 1) * r->V});
  c.get("experts_kernel", "bf16", {H, M * r->V});
}

// The route's arrays against one another, the manifest's lines and its
// batch; sizes the runner's dimensions.
bool check_shapes(Runner* r, std::string* err) {
  const Manifest& m = r->m;
  ShapeCheck c{m, err};
  r->DT = m.total_size();
  r->B = m.batch_size;
  r->F = m.max_frames;
  r->S = m.iterations;
  r->M = m.moe_num_mixtures;
  const int64_t DT = r->DT;
  const bool video = kRoutes[r->route].video_level;
  if (video != (m.frame_features == 0))
    return c.fail(std::string("route ") + m.route + " reads " +
                  (video ? "video-level" : "frame-level") + " features, the manifest's are not");
  if (!video && r->S < 1) return c.fail("iterations must be positive");
  if (r->B > 65535) return c.fail("the runner takes at most 65535 videos a batch");
  switch (r->route) {
    case kNetvlad: {
      const int64_t dr = c.dim("rgb/cluster", "bf16", {-1, -1}, 0),
                    kr = c.dim("rgb/cluster", "bf16", {-1, -1}, 1),
                    da = c.dim("aud/cluster", "bf16", {-1, -1}, 0),
                    ka = c.dim("aud/cluster", "bf16", {-1, -1}, 1);
      r->H = (int)c.dim("gate_w", "bf16", {-1, -1}, 0);
      const int64_t H = r->H;
      c.get("in_scale", "f32", {DT});
      c.get("in_bias", "f32", {DT});
      for (const char* mod : {"rgb", "aud"}) {
        const int64_t d = mod[0] == 'r' ? dr : da, k = mod[0] == 'r' ? kr : ka;
        c.get(std::string(mod) + "/scale", "f32", {k});
        c.get(std::string(mod) + "/bias", "f32", {k});
        c.get(std::string(mod) + "/c2", "f32", {d, k});
      }
      c.get("w_rgb", "bf16", {dr * kr, H});
      c.get("w_aud", "bf16", {da * ka, H});
      check_tail(c, r);
      if (c.ok && (dr + da != DT || kr > kMaxClusters || ka > kMaxClusters))
        c.fail("the route needs the two NetVLADs' widths to sum to the features' (" +
               std::to_string(dr) + " + " + std::to_string(da) + " vs " + std::to_string(DT) +
               ") and K <= 512");
      r->mods[0].d = (int)dr;
      r->mods[0].k = (int)kr;
      r->mods[1].d = (int)da;
      r->mods[1].k = (int)ka;
      r->n_mods = 2;
      break;
    }
    case kLogistic:
      r->V = (int)c.dim("fc/bias", "f32", {-1}, 0);
      c.get("fc/kernel", "f32", {DT, r->V});
      break;
    case kMoe: {
      if (r->M < 1 || c.dim("experts_bias", "f32", {-1}, 0) % r->M != 0)
        return c.fail("moe_num_mixtures must be positive and divide experts_bias's length");
      r->V = (int)(c.dim("experts_bias", "f32", {-1}, 0) / r->M);
      c.get("gates_kernel", "f32", {DT, (int64_t)(r->M + 1) * r->V});
      c.get("experts_kernel", "f32", {DT, (int64_t)r->M * r->V});
      break;
    }
    case kDbof: {
      r->C = (int)c.dim("cluster_w", "bf16", {DT, -1}, 1);
      r->H = (int)c.dim("hidden_w", "bf16", {r->C, -1}, 1);
      c.get("cluster_b", "f32", {r->C});
      c.get("hidden_b", "f32", {r->H});
      if (c.ok && (r->M < 1 || c.dim("experts_bias", "f32", {-1}, 0) % r->M != 0))
        return c.fail("moe_num_mixtures must be positive and divide experts_bias's length");
      r->V = c.ok ? (int)(c.dim("experts_bias", "f32", {-1}, 0) / r->M) : 0;
      c.get("gates_kernel", "bf16", {r->H, (int64_t)(r->M + 1) * r->V});
      c.get("experts_kernel", "bf16", {r->H, (int64_t)r->M * r->V});
      break;
    }
    default: {  // the LOUPE four
      r->n_mods = m.weight("mods/1/cluster") ? 2 : 1;
      r->H = (int)c.dim("gate_w", "bf16", {-1, -1}, 0);
      const int64_t H = r->H;
      c.get("in_scale", "f32", {DT});
      c.get("in_bias", "f32", {DT});
      int off = 0;
      if (r->route == kNextvlad && (int)m.nextvlad_groups.size() != r->n_mods)
        return c.fail("nextvlad_groups has " + std::to_string(m.nextvlad_groups.size()) +
                      " values for " + std::to_string(r->n_mods) + " modalities");
      for (int i = 0; i < r->n_mods && c.ok; ++i) {
        Mod& md = r->mods[i];
        const std::string p = "mods/" + std::to_string(i) + "/";
        md.d = (int)c.dim(p + "cluster", "bf16", {-1, -1}, 0);
        md.off = off;
        off += md.d;
        if (r->route == kNextvlad) {
          md.width = (int)c.dim(p + "cluster", "bf16", {-1, -1}, 1);
          md.g = m.nextvlad_groups[i];
          md.k = (int)c.dim(p + "c2", "f32", {-1, -1}, 0);
          md.dp = (int)c.dim(p + "c2", "f32", {-1, -1}, 1);
          if (c.ok && (md.width != m.nextvlad_expansion * md.d || md.width != md.g * md.dp))
            return c.fail(p + "cluster's width " + std::to_string(md.width) +
                          " is not nextvlad_expansion · D = groups · D′");
          const int64_t gk = (int64_t)md.g * md.k;
          c.get(p + "scale", "f32", {gk});
          c.get(p + "bias", "f32", {gk});
          c.get(p + "wg", "bf16", {md.width, md.g});
          c.get(p + "wa", "bf16", {md.width, gk});
          c.get(p + "vscale", "f32", {(int64_t)md.k * md.dp});
          c.get(p + "vbias", "f32", {(int64_t)md.k * md.dp});
          c.get(p + "w1", "bf16", {(int64_t)md.k * md.dp, H});
          continue;
        }
        md.k = (int)c.dim(p + "cluster", "bf16", {-1, -1}, 1);
        const int64_t d = md.d, k = md.k;
        c.get(p + "scale", "f32", {k});
        c.get(p + "bias", "f32", {k});
        if (r->route == kSoftdbow) {
          c.get(p + "w1", "bf16", {k, H});
          continue;
        }
        if (c.ok && k > kMaxClusters) return c.fail(p + "cluster has more than 512 clusters");
        c.get(p + "c2", "f32", {d, k});
        c.get(p + "w1", "bf16", {d * k, H});
        if (r->route == kNetfv) {
          c.get(p + "covar", "f32", {d, k});
          c.get(p + "w2", "bf16", {d * k, H});
        }
      }
      if (c.ok && off != DT)
        return c.fail("the modalities' widths sum to " + std::to_string(off) + ", the features' to " +
                      std::to_string(DT));
      check_tail(c, r);
      r->n_parts = r->n_mods * (r->route == kNetfv ? 2 : 1);
      break;
    }
  }
  if (!c.ok) return false;
  r->k = m.top_k < r->V ? m.top_k : r->V;
  const int64_t B = r->B;
  const bool calls =
      video ? (m.call_inputs.size() == 1 && m.call_inputs[0].tag == "f32" &&
               m.call_inputs[0].dims == std::vector<int64_t>{B, DT})
            : (m.call_inputs.size() == 2 && m.call_inputs[0].tag == "u8" &&
               m.call_inputs[0].dims == std::vector<int64_t>{B, r->F, DT} &&
               m.call_inputs[1].tag == "s32" && m.call_inputs[1].dims == std::vector<int64_t>{B});
  const bool outs = m.outputs.size() == 2 && m.outputs[0].tag == "f32" &&
                    m.outputs[0].dims == std::vector<int64_t>{B, r->k} &&
                    m.outputs[1].tag == "s32" && m.outputs[1].dims == m.outputs[0].dims;
  if (!calls || !outs)
    return c.fail(std::string("manifest call inputs or outputs are not (") +
                  (video ? "f32 [B, DT]" : "u8 [B, F, DT], s32 [B]") +
                  ") → (f32 [B, k], s32 [B, k])");
  if ((int64_t)r->V * sizeof(float) > kMaxTopkSmem) return c.fail("the vocabulary is over topk's row");
  return true;
}

// the workspaces of the route's batch (ops/*_fused.py's wrappers' sizes
// for rows 1, 2, 5 and 6), and the pointers into the uploaded arrays
void plan(Runner* r) {
  const long long B = r->B, S = r->S, DT = r->DT, H = r->H, V = r->V, M = r->M;
  auto dchunks = [](long long d) { return ((d + 63) / 64 + 15) / 16; };  // aggregation_geometry
  const bool video = kRoutes[r->route].video_level;
  r->in_bytes = video ? B * DT * 4 : B * r->F * DT;
  r->need_ws(reinterpret_cast<uint8_t**>(&r->x), r->in_bytes);
  if (!video) r->need_ws(&r->nf, B);
  r->need_ws(&r->probs, B * V);
  r->need_ws(&r->values, B * r->k);
  r->need_ws(&r->indices, B * r->k);
  const bool tail = r->route != kLogistic && r->route != kMoe;
  if (tail) {
    r->need_ws(&r->ga, B * (M + 1) * V);
    r->need_ws(&r->ea, B * M * V);
  }
  if (r->route == kNetvlad || r->route >= kNetrvlad) {
    r->need_ws(&r->h, B * H);
    r->need_ws(&r->hb, B * H);
    r->need_ws(&r->gates, B * H);
    r->need_ws(&r->hg, B * H);
  }
  switch (r->route) {
    case kNetvlad: {
      const Mod &rg = r->mods[0], &au = r->mods[1];
      r->need_ws(&r->vlad_rgb, B * rg.d * rg.k);
      r->need_ws(&r->vlad_aud, B * au.d * au.k);
      r->need_ws(&r->xs, B * S * DT);
      r->need_ws(&r->ws_a_rgb, B * S * rg.k);
      r->need_ws(&r->ws_a_aud, B * S * au.k);
      r->need_ws(&r->ws_cs_rgb, B * dchunks(rg.d) * rg.k);
      r->need_ws(&r->ws_cs_aud, B * dchunks(au.d) * au.k);
      r->need_ws(&r->contrib[0], B * H);
      r->need_ws(&r->contrib[1], B * H);
      break;
    }
    case kLogistic:
    case kMoe:
      r->need_ws(&r->xn, B * DT);
      if (r->route == kMoe) {
        r->need_ws(&r->ga, B * (M + 1) * V);
        r->need_ws(&r->ea, B * M * V);
      }
      break;
    case kDbof:
      r->need_ws(&r->xs, B * S * DT);
      r->need_ws(&r->act, B * S * r->C);
      r->need_ws(&r->pooled, B * r->C);
      r->need_ws(&r->hh, B * H);
      r->need_ws(&r->hg, B * H);
      break;
    default: {
      r->need_ws(&r->xs, B * S * DT);
      for (int i = 0; i < r->n_parts; ++i) r->need_ws(&r->contrib[i], B * H);
      for (int i = 0; i < r->n_mods; ++i) {
        Mod& md = r->mods[i];
        const long long d = md.d, k = md.k;
        if (r->route == kNetrvlad) {
          r->need_ws(&md.out1, B * d * k);
          r->need_ws(&md.ws_a, B * S * k);
          r->need_ws(&md.ws_colsq, B * dchunks(d) * k);
        } else if (r->route == kNetfv) {
          r->need_ws(&md.out1, B * d * k);
          r->need_ws(&md.out2, B * d * k);
          r->need_ws(&md.ws_a, B * S * k);
          r->need_ws(&md.ws_colsq, 2 * B * k);
        } else if (r->route == kSoftdbow) {
          const long long tiles = (k + 127) / 128;  // softdbow_fused.py CLUSTER_TILE
          r->need_ws(&md.bow, B * k);
          r->need_ws(&md.bow_b, B * k);
          r->need_ws(&md.ws_max, B * S * tiles);
          r->need_ws(&md.ws_sum, B * S * tiles);
          r->need_ws(&md.ws_logits, B * S * k);
        } else {  // NeXtVLAD
          const long long rows = B * S, gk = (long long)md.g * k;
          r->need_ws(&md.xt, rows * md.width);
          r->need_ws(&md.gp, rows * md.g);
          r->need_ws(&md.lp, rows * gk);
          r->need_ws(&md.assign, rows * gk);
          r->need_ws(&md.assign_b, rows * gk);
          r->need_ws(&md.agg, B * k * md.dp);
          r->need_ws(&md.vlad, B * k * md.dp);
        }
      }
    }
  }
}

// the device pointers of a LOUPE route's modality arrays
void bind_mods(Runner* r) {
  for (int i = 0; i < r->n_mods; ++i) {
    Mod& md = r->mods[i];
    const std::string p = "mods/" + std::to_string(i) + "/";
    md.cluster = r->W<bf16>(p + "cluster");
    md.scale = r->W<float>(p + "scale");
    md.bias = r->W<float>(p + "bias");
    md.c2 = r->W<float>(p + "c2");
    md.covar = r->W<float>(p + "covar");
    md.w1 = r->W<bf16>(p + "w1");
    md.w2 = r->W<bf16>(p + "w2");
    md.wg = r->W<bf16>(p + "wg");
    md.wa = r->W<bf16>(p + "wa");
    md.vscale = r->W<float>(p + "vscale");
    md.vbias = r->W<float>(p + "vbias");
  }
}

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

bool load(Runner* r, const std::string& dir, std::string* err) {
  if (!LoadManifest(dir, &r->m, err)) return false;
  r->route = static_cast<Route>(r->m.route_index);
  if (!check_shapes(r, err)) return false;

  const std::string path = dir + "/weights.bin";
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    *err = "cannot read " + path;
    return false;
  }
  fseek(f, 0, SEEK_END);
  const long long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size != r->m.weight_bytes()) {
    fclose(f);
    *err = "weights.bin has " + std::to_string(size) + " bytes, the manifest accounts for " +
           std::to_string(r->m.weight_bytes()) + " — re-export the artifact";
    return false;
  }
  std::vector<char> blob(size);
  const bool read = fread(blob.data(), 1, size, f) == (size_t)size;
  fclose(f);
  if (!read) {
    *err = "short read of " + path;
    return false;
  }

  if (!cuda_ok(cudaSetDevice(r->device), "cudaSetDevice", err)) return false;
  if (!cuda_ok(cudaStreamCreateWithFlags(&r->stream, cudaStreamNonBlocking), "stream", err))
    return false;
  if (!blas_ok(cublasCreate(&r->blas), "cublasCreate", err) ||
      !blas_ok(cublasSetStream(r->blas, r->stream), "cublasSetStream", err) ||
      !blas_ok(cublasSetMathMode(r->blas, (cublasMath_t)(CUBLAS_DEFAULT_MATH |
                                                           CUBLAS_MATH_DISALLOW_REDUCED_PRECISION_REDUCTION)),
               "cublasSetMathMode", err))
    return false;

  size_t total = 0;
  std::vector<size_t> offsets;
  for (const auto& a : r->m.weights) {
    offsets.push_back(total);
    total += align256(a.bytes());
  }
  if (!cuda_ok(cudaMalloc(&r->weights, total), "cudaMalloc(weights)", err)) return false;
  for (size_t i = 0; i < r->m.weights.size(); ++i) {
    const ArraySpec& a = r->m.weights[i];
    r->w[a.name] = r->weights + offsets[i];
    if (!cuda_ok(cudaMemcpy(r->weights + offsets[i], blob.data() + a.offset, a.bytes(),
                            cudaMemcpyHostToDevice),
                 "upload of the weights", err))
      return false;
  }
  bind_mods(r);

  plan(r);
  size_t ws_bytes = 0;
  for (const auto& p : r->parts_ws) ws_bytes += align256(p.second);
  if (!cuda_ok(cudaMalloc(&r->ws, ws_bytes), "cudaMalloc(workspaces)", err)) return false;
  size_t off = 0;
  for (const auto& p : r->parts_ws) {
    *p.first = r->ws + off;
    off += align256(p.second);
  }
  const long long B = r->B, k = r->k, V = r->V;
  const std::pair<void**, size_t> pin[] = {
      {&r->px, r->in_bytes},
      {reinterpret_cast<void**>(&r->pnf), (size_t)(B * 4)},
      {reinterpret_cast<void**>(&r->pvalues), (size_t)(B * k * 4)},
      {reinterpret_cast<void**>(&r->pindices), (size_t)(B * k * 4)},
      {reinterpret_cast<void**>(&r->pprobs), (size_t)(B * V * 4)},
  };
  size_t pin_bytes = 0;
  for (const auto& p : pin) pin_bytes += align256(p.second);
  if (!cuda_ok(cudaMallocHost(&r->pinned, pin_bytes), "cudaMallocHost(staging)", err)) return false;
  off = 0;
  for (const auto& p : pin) {
    *p.first = r->pinned + off;
    off += align256(p.second);
  }
  return true;
}

// The gated MoE tail from the hidden FC's products: hidden_sum, the gating
// product and gating, then moe (→ probs).
bool moe(Runner* r, const bf16* hidden, std::string* err) {
  const long long B = r->B, M = r->M, V = r->V, H = r->H;
  const char* what = "MoE gate product";
  cublasStatus_t s = gemm_bf16(r->blas, hidden, r->W<bf16>("gates_kernel"), r->ga, B,
                               (M + 1) * V, H);
  if (s == CUBLAS_STATUS_SUCCESS) {
    what = "MoE expert product";
    s = gemm_bf16(r->blas, hidden, r->W<bf16>("experts_kernel"), r->ea, B, M * V, H);
  }
  if (!blas_ok(s, what, err)) return false;
  if (!cuda_ok(launch_moe_combine(r->ga, r->ea, r->W<float>("experts_bias"), r->probs, r->B, r->M,
                                  r->V, r->stream),
               "moe_combine", err))
    return false;
  r->count(kMoeCombine);
  return true;
}

bool gated_tail(Runner* r, bool bias_first, std::string* err) {
  const long long B = r->B, H = r->H;
  const int n_parts = r->route == kNetvlad ? 2 : r->n_parts;
  const int group = r->route == kNetfv ? 2 : 1;
  if (!cuda_ok(launch_hidden_sum(r->contrib, n_parts, group, bias_first, r->W<float>("hidden_b"),
                                 r->h, r->hb, B, r->H, r->stream),
               "hidden_sum", err))
    return false;
  r->count(kHiddenSum);
  if (!blas_ok(gemm_bf16(r->blas, r->hb, r->W<bf16>("gate_w"), r->gates, B, H, H),
               "gating product", err))
    return false;
  if (!cuda_ok(launch_gating(r->gates, r->h, r->W<float>("g_scale"), r->W<float>("g_bias"), r->hg,
                             B, r->H, r->stream),
               "gating", err))
    return false;
  r->count(kGating);
  return moe(r, r->hg, err);
}

bool run_netvlad(Runner* r, std::string* err) {
  const Mod &rg = r->mods[0], &au = r->mods[1];
  const int rc = lpm_netvlad_frontend(
      r->x, r->m.key0, r->m.key1, r->nf, r->W<float>("in_scale"), r->W<float>("in_bias"),
      r->W<bf16>("rgb/cluster"), r->W<float>("rgb/scale"), r->W<float>("rgb/bias"),
      r->W<float>("rgb/c2"), r->W<bf16>("aud/cluster"), r->W<float>("aud/scale"),
      r->W<float>("aud/bias"), r->W<float>("aud/c2"), r->vlad_rgb, r->vlad_aud, r->xs,
      r->ws_a_rgb, r->ws_a_aud, r->ws_cs_rgb, r->ws_cs_aud, r->B, r->F, r->DT, r->S, rg.d, rg.k,
      au.d, au.k, kDeqScale, kDeqBias, 0, r->stream);
  if (!cuda_ok((cudaError_t)rc, "netvlad_frontend", err)) return false;
  r->count(kFrontend);
  if (!blas_ok(gemm_bf16(r->blas, r->vlad_rgb, r->W<bf16>("w_rgb"), r->contrib[0], r->B, r->H,
                         (long long)rg.d * rg.k),
               "hidden FC (rgb)", err) ||
      !blas_ok(gemm_bf16(r->blas, r->vlad_aud, r->W<bf16>("w_aud"), r->contrib[1], r->B, r->H,
                         (long long)au.d * au.k),
               "hidden FC (audio)", err))
    return false;
  return gated_tail(r, false, err);
}

bool run_video(Runner* r, std::string* err) {
  const long long B = r->B, DT = r->DT, V = r->V, M = r->M;
  const float* x = static_cast<const float*>(r->x);
  if (!cuda_ok(launch_row_l2(x, nullptr, nullptr, 0, r->xn, nullptr, B, r->DT, r->stream), "row_l2",
               err))
    return false;
  r->count(kRowL2);
  if (r->route == kLogistic) {
    if (!blas_ok(gemm_f32(r->blas, r->xn, r->W<float>("fc/kernel"), r->probs, B, V, DT),
                 "logistic product", err))
      return false;
    if (!cuda_ok(launch_bias_act(false, r->probs, r->W<float>("fc/bias"), r->probs, nullptr, B,
                                 r->V, r->stream),
                 "bias_sigmoid", err))
      return false;
    r->count(kBiasSigmoid);
    return true;
  }
  if (!blas_ok(gemm_f32(r->blas, r->xn, r->W<float>("gates_kernel"), r->ga, B, (M + 1) * V, DT),
               "MoE gate product", err) ||
      !blas_ok(gemm_f32(r->blas, r->xn, r->W<float>("experts_kernel"), r->ea, B, M * V, DT),
               "MoE expert product", err))
    return false;
  if (!cuda_ok(launch_moe_combine(r->ga, r->ea, r->W<float>("experts_bias"), r->probs, r->B, r->M,
                                  r->V, r->stream),
               "moe_combine", err))
    return false;
  r->count(kMoeCombine);
  return true;
}

bool frames(Runner* r, bool affine, std::string* err) {
  const bool window = r->m.sampling == "window";
  if (!cuda_ok(launch_frame_stage(static_cast<const uint8_t*>(r->x), r->m.key0, r->m.key1, r->nf,
                                  affine ? r->W<float>("in_scale") : nullptr,
                                  affine ? r->W<float>("in_bias") : nullptr, r->xs, r->B, r->F,
                                  r->DT, r->S, window ? 1 : 0, kDeqScale, kDeqBias, r->stream),
               "frame_stage", err))
    return false;
  r->count(kFrameStage);
  return true;
}

bool run_dbof(Runner* r, std::string* err) {
  const long long B = r->B, S = r->S, DT = r->DT, C = r->C, H = r->H;
  if (!frames(r, false, err)) return false;
  if (!blas_ok(gemm_bf16(r->blas, r->xs, r->W<bf16>("cluster_w"), r->act, B * S, C, DT),
               "cluster product", err))
    return false;
  if (!cuda_ok(launch_bias_act(true, r->act, r->W<float>("cluster_b"), r->act, nullptr, B * S,
                               r->C, r->stream),
               "bias_relu6 (cluster)", err))
    return false;
  r->count(kBiasRelu6);
  if (!cuda_ok(launch_frame_pool(r->act, r->pooled, r->B, r->S, r->C,
                                 r->m.dbof_pooling_method == "max" ? 1 : 0, r->stream),
               "frame_pool", err))
    return false;
  r->count(kFramePool);
  if (!blas_ok(gemm_bf16(r->blas, r->pooled, r->W<bf16>("hidden_w"), r->hh, B, H, C),
               "hidden product", err))
    return false;
  if (!cuda_ok(launch_bias_act(true, r->hh, r->W<float>("hidden_b"), nullptr, r->hg, B, r->H,
                               r->stream),
               "bias_relu6 (hidden)", err))
    return false;
  r->count(kBiasRelu6);
  return moe(r, r->hg, err);
}

// One NeXtVLAD modality's product of the hidden FC into out.
bool nextvlad(Runner* r, Mod& md, float* out, std::string* err) {
  const long long B = r->B, S = r->S, rows = B * S, H = r->H, gk = (long long)md.g * md.k;
  const long long sg = S * md.g;
  if (!blas_ok(gemm(r->blas, CUDA_R_16BF, r->xs + md.off, r->DT, md.cluster, md.width, md.xt,
                    CUDA_R_16BF, md.width, rows, md.width, md.d),
               "NeXtVLAD expansion", err))
    return false;
  if (!blas_ok(gemm_bf16(r->blas, md.xt, md.wg, md.gp, rows, md.g, md.width),
               "NeXtVLAD group gate", err) ||
      !blas_ok(gemm_bf16(r->blas, md.xt, md.wa, md.lp, rows, gk, md.width),
               "NeXtVLAD assignment", err))
    return false;
  if (!cuda_ok(launch_nextvlad_assign(md.lp, md.scale, md.bias, md.gp, md.assign, md.assign_b,
                                      rows, md.g, md.k, r->stream),
               "nextvlad_assign", err))
    return false;
  r->count(kNextvladAssign);
  // agg[b] [K, D′] = assign[b]ᵀ [K, S·G] · X[b] [S·G, D′] (X: the video's
  // rows of xt read as S·G rows of D′); column-major Cᵀ = X_colᵀ · A: bf16
  // products summed in f32, as JAX's einsum with preferred_element_type=f32
  const float one = 1.f, zero = 0.f;
  if (!blas_ok(cublasGemmStridedBatchedEx(r->blas, CUBLAS_OP_N, CUBLAS_OP_T, md.dp, md.k, (int)sg,
                                          &one, md.xt, CUDA_R_16BF, md.dp, sg * md.dp,
                                          md.assign_b, CUDA_R_16BF, md.k, sg * md.k, &zero,
                                          md.agg, CUDA_R_32F, md.dp, (long long)md.k * md.dp,
                                          (int)B, CUBLAS_COMPUTE_32F, CUBLAS_GEMM_DEFAULT),
               "NeXtVLAD aggregation", err))
    return false;
  if (!cuda_ok(launch_nextvlad_residual(md.agg, md.assign, md.c2, md.agg, r->B, (int)sg, md.k,
                                        md.dp, r->stream),
               "nextvlad_residual", err))
    return false;
  r->count(kNextvladResidual);
  if (!cuda_ok(launch_row_l2(md.agg, md.vscale, md.vbias, md.k, nullptr, md.vlad, B * md.k, md.dp,
                             r->stream),
               "row_l2 (NeXtVLAD)", err))
    return false;
  r->count(kRowL2);
  return blas_ok(gemm_bf16(r->blas, md.vlad, md.w1, out, B, H, (long long)md.k * md.dp),
                 "hidden FC", err);
}

bool run_lf(Runner* r, std::string* err) {
  const long long B = r->B, H = r->H;
  if (!frames(r, true, err)) return false;
  int part = 0;
  for (int i = 0; i < r->n_mods; ++i) {
    Mod& md = r->mods[i];
    const bf16* x = r->xs + md.off;
    const long long dk = (long long)md.d * md.k;
    int rc = 0;
    switch (r->route) {
      case kNetrvlad:
        rc = lpm_netvlad_fused(x, r->DT, 1, md.cluster, md.scale, md.bias, md.c2, md.out1, md.ws_a,
                               md.ws_colsq, r->B, r->S, md.d, md.k, 0, r->stream);
        if (!cuda_ok((cudaError_t)rc, "netvlad_fused", err)) return false;
        r->count(kNetvladFused);
        if (!blas_ok(gemm_bf16(r->blas, md.out1, md.w1, r->contrib[part++], B, H, dk), "hidden FC",
                     err))
          return false;
        break;
      case kNetfv:
        rc = lpm_netfv_fused(x, r->DT, 1, md.cluster, md.scale, md.bias, md.c2, md.covar, md.out1,
                             md.out2, md.ws_a, md.ws_colsq, r->B, r->S, md.d, md.k, r->stream);
        if (!cuda_ok((cudaError_t)rc, "netfv_fused", err)) return false;
        r->count(kNetfvFused);
        if (!blas_ok(gemm_bf16(r->blas, md.out1, md.w1, r->contrib[part++], B, H, dk),
                     "hidden FC (fv1)", err) ||
            !blas_ok(gemm_bf16(r->blas, md.out2, md.w2, r->contrib[part++], B, H, dk),
                     "hidden FC (fv2)", err))
          return false;
        break;
      case kSoftdbow:
        rc = lpm_softdbow_fused(x, r->DT, 1, md.cluster, md.scale, md.bias, md.bow, md.ws_max,
                                md.ws_sum, md.ws_logits, r->B, r->S, md.d, md.k, r->stream);
        if (!cuda_ok((cudaError_t)rc, "softdbow_fused", err)) return false;
        r->count(kSoftdbowFused);
        if (!cuda_ok(launch_row_l2(md.bow, nullptr, nullptr, 0, nullptr, md.bow_b, B, md.k,
                                   r->stream),
                     "row_l2 (SoftDBoW)", err))
          return false;
        r->count(kRowL2);
        if (!blas_ok(gemm_bf16(r->blas, md.bow_b, md.w1, r->contrib[part++], B, H, md.k),
                     "hidden FC", err))
          return false;
        break;
      default:
        if (!nextvlad(r, md, r->contrib[part++], err)) return false;
    }
  }
  return gated_tail(r, true, err);
}

// One batch: the route's inputs on the host (features u8 [B, F, DT] and
// num_frames s32 [B], or features f32 [B, DT]) → values/indices [B, k] (or
// probs [B, V]) on the host.
bool forward(Runner* r, const void* features, const void* num_frames, float* values,
             int32_t* indices, float* probs, std::string* err) {
  std::lock_guard<std::mutex> lock(r->mu);
  const long long B = r->B, V = r->V, k = r->k;
  const bool video = kRoutes[r->route].video_level;
  cudaStream_t st = r->stream;
  if (!features || (!video && !num_frames)) {
    *err = video ? "no features" : "a frame-level route needs the features and the frame counts";
    return false;
  }
  if (!cuda_ok(cudaSetDevice(r->device), "cudaSetDevice", err)) return false;
  memcpy(r->px, features, r->in_bytes);
  if (!cuda_ok(cudaMemcpyAsync(r->x, r->px, r->in_bytes, cudaMemcpyHostToDevice, st), "H2D", err))
    return false;
  if (!video) {
    memcpy(r->pnf, num_frames, B * 4);
    if (!cuda_ok(cudaMemcpyAsync(r->nf, r->pnf, B * 4, cudaMemcpyHostToDevice, st), "H2D", err))
      return false;
  }
  bool ok;
  switch (r->route) {
    case kNetvlad: ok = run_netvlad(r, err); break;
    case kLogistic:
    case kMoe: ok = run_video(r, err); break;
    case kDbof: ok = run_dbof(r, err); break;
    default: ok = run_lf(r, err);
  }
  if (!ok) return false;

  if (probs) {
    if (!cuda_ok(cudaMemcpyAsync(r->pprobs, r->probs, B * V * 4, cudaMemcpyDeviceToHost, st), "D2H",
                 err))
      return false;
  } else {
    if (!cuda_ok(launch_topk(r->probs, r->values, r->indices, r->B, r->V, r->k, st), "topk", err))
      return false;
    r->count(kTopk);
    if (!cuda_ok(cudaMemcpyAsync(r->pvalues, r->values, B * k * 4, cudaMemcpyDeviceToHost, st),
                 "D2H", err) ||
        !cuda_ok(cudaMemcpyAsync(r->pindices, r->indices, B * k * 4, cudaMemcpyDeviceToHost, st),
                 "D2H", err))
      return false;
  }
  if (!cuda_ok(cudaStreamSynchronize(st), "the batch", err)) return false;
  if (probs) {
    memcpy(probs, r->pprobs, B * V * 4);
  } else {
    memcpy(values, r->pvalues, B * k * 4);
    memcpy(indices, r->pindices, B * k * 4);
  }
  return true;
}

// The buffers of the last batch that lpm_runner_read copies out: the hidden
// layer h (f32 [B, H]) and its products (part/<i>, f32 [B, H] each) where
// the route has them, and a NeXtVLAD modality's steps (mods/<i>/xt bf16
// [B·S, λD], assign f32 [B·S·G, K], residual f32 [B, K, D′], vlad bf16
// [B, K·D′]).
std::vector<std::pair<std::string, std::pair<const void*, size_t>>> buffers(const Runner* r) {
  std::vector<std::pair<std::string, std::pair<const void*, size_t>>> out;
  const size_t B = r->B, S = r->S, H = r->H;
  if (!r->h) return out;
  out.push_back({"h", {r->h, B * H * 4}});
  const int n_parts = r->route == kNetvlad ? 2 : r->n_parts;
  for (int i = 0; i < n_parts; ++i) out.push_back({"part/" + std::to_string(i), {r->contrib[i], B * H * 4}});
  if (r->route != kNextvlad) return out;
  for (int i = 0; i < r->n_mods; ++i) {
    const Mod& md = r->mods[i];
    const std::string p = "mods/" + std::to_string(i) + "/";
    const size_t rows = B * S, gk = (size_t)md.g * md.k, kd = (size_t)md.k * md.dp;
    out.push_back({p + "xt", {md.xt, rows * md.width * 2}});
    out.push_back({p + "assign", {md.assign, rows * gk * 4}});
    out.push_back({p + "residual", {md.agg, B * kd * 4}});
    out.push_back({p + "vlad", {md.vlad, B * kd * 2}});
  }
  return out;
}

void set_err(const std::string& msg, char* err, long long cap) {
  if (!err || cap <= 0) return;
  snprintf(err, (size_t)cap, "%s", msg.c_str());
}

}  // namespace lpm_native

using lpm_native::Runner;
using lpm_native::bf16;

extern "C" {

// Loads export_dir's native artifact on CUDA device `device`: parses the
// manifest, checks the route's arrays, uploads the weights once, allocates
// the manifest's batch's workspaces and pinned staging.  → a handle, or
// NULL with *err set.
void* lpm_runner_load(const char* export_dir, int device, char* err, long long err_cap) {
  auto* r = new Runner();
  r->device = device;
  std::string msg;
  if (!lpm_native::load(r, export_dir, &msg)) {
    lpm_native::set_err(msg, err, err_cap);
    delete r;
    return nullptr;
  }
  return r;
}

// One batch of the manifest's size: features u8 [B, F, DT] and num_frames
// s32 [B] (a frame-level route), or features f32 [B, DT] and num_frames NULL
// (a video-level route) → values f32 [B, k], indices s32 [B, k], all host
// memory.  0 on success; else 1 with *err set.
int lpm_runner_run(void* handle, const void* features, const void* num_frames, void* values,
                   void* indices, char* err, long long err_cap) {
  std::string msg;
  if (lpm_native::forward(static_cast<Runner*>(handle), features, num_frames,
                          static_cast<float*>(values), static_cast<int32_t*>(indices), nullptr,
                          &msg))
    return 0;
  lpm_native::set_err(msg, err, err_cap);
  return 1;
}

// As lpm_runner_run, to the class probabilities f32 [B, V] (no top-k).
int lpm_runner_probs(void* handle, const void* features, const void* num_frames, void* probs,
                     char* err, long long err_cap) {
  std::string msg;
  if (lpm_native::forward(static_cast<Runner*>(handle), features, num_frames, nullptr, nullptr,
                          static_cast<float*>(probs), &msg))
    return 0;
  lpm_native::set_err(msg, err, err_cap);
  return 1;
}

// The runner's launches of `name` (kCounterNames) since it loaded or was
// reset; −1 for another name.
long long lpm_runner_launches(void* handle, const char* name) {
  auto* r = static_cast<Runner*>(handle);
  for (int i = 0; i < lpm_native::kNumCounters; ++i)
    if (strcmp(name, lpm_native::kCounterNames[i]) == 0) return r->launches[i].load();
  return -1;
}

void lpm_runner_reset_launches(void* handle) {
  for (auto& c : static_cast<Runner*>(handle)->launches) c.store(0);
}

// Copies the last batch's buffer `name` (lpm_native::buffers) to host dst of
// cap bytes, for tracing a route against its torch version.  → its bytes,
// or −1 for a name the route does not have, a smaller cap or a failed copy.
long long lpm_runner_read(void* handle, const char* name, void* dst, long long cap) {
  auto* r = static_cast<Runner*>(handle);
  std::lock_guard<std::mutex> lock(r->mu);
  for (const auto& b : lpm_native::buffers(r)) {
    if (b.first != name) continue;
    const long long bytes = (long long)b.second.second;
    if (bytes > cap || cudaSetDevice(r->device) != cudaSuccess ||
        cudaMemcpy(dst, b.second.first, bytes, cudaMemcpyDeviceToHost) != cudaSuccess)
      return -1;
    return bytes;
  }
  return -1;
}

void lpm_runner_destroy(void* handle) { delete static_cast<Runner*>(handle); }

// The hand kernels alone, on device pointers and the caller's stream
// (ops/native_tail.py's wrappers); each returns a cudaError_t.
int lpm_hidden_sum(const void* p0, const void* p1, const void* p2, const void* p3, int n_parts,
                   int group, int bias_first, const void* bias, void* h, void* hb, long long rows,
                   int H, void* stream) {
  const float* parts[lpm_native::kMaxParts] = {
      static_cast<const float*>(p0), static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const float*>(p3)};
  return (int)lpm_native::launch_hidden_sum(parts, n_parts, group, bias_first,
                                            static_cast<const float*>(bias), static_cast<float*>(h),
                                            static_cast<bf16*>(hb), rows, H,
                                            static_cast<cudaStream_t>(stream));
}

int lpm_gating(const void* gates, const void* h, const void* g_scale, const void* g_bias,
               void* out, long long rows, int H, void* stream) {
  return (int)lpm_native::launch_gating(
      static_cast<const float*>(gates), static_cast<const float*>(h),
      static_cast<const float*>(g_scale), static_cast<const float*>(g_bias),
      static_cast<bf16*>(out), rows, H, static_cast<cudaStream_t>(stream));
}

int lpm_moe_combine(const void* ga, const void* ea, const void* experts_bias, void* probs, int B,
                    int M, int V, void* stream) {
  return (int)lpm_native::launch_moe_combine(
      static_cast<const float*>(ga), static_cast<const float*>(ea),
      static_cast<const float*>(experts_bias), static_cast<float*>(probs), B, M, V,
      static_cast<cudaStream_t>(stream));
}

int lpm_topk(const void* probs, void* values, void* indices, int B, int V, int k, void* stream) {
  return (int)lpm_native::launch_topk(static_cast<const float*>(probs), static_cast<float*>(values),
                                      static_cast<int32_t*>(indices), B, V, k,
                                      static_cast<cudaStream_t>(stream));
}

int lpm_frame_stage(const void* x, unsigned int k0, unsigned int k1, const void* num_frames,
                    const void* in_scale, const void* in_bias, void* out, int B, int F, int DT,
                    int S, int window, float deq_scale, float deq_bias, void* stream) {
  return (int)lpm_native::launch_frame_stage(
      static_cast<const uint8_t*>(x), k0, k1, static_cast<const int32_t*>(num_frames),
      static_cast<const float*>(in_scale), static_cast<const float*>(in_bias),
      static_cast<bf16*>(out), B, F, DT, S, window, deq_scale, deq_bias,
      static_cast<cudaStream_t>(stream));
}

int lpm_bias_sigmoid(const void* y, const void* bias, void* out, long long rows, int N,
                     void* stream) {
  return (int)lpm_native::launch_bias_act(false, static_cast<const float*>(y),
                                          static_cast<const float*>(bias), static_cast<float*>(out),
                                          nullptr, rows, N, static_cast<cudaStream_t>(stream));
}

int lpm_bias_relu6(const void* y, const void* bias, void* out_f32, void* out_bf16, long long rows,
                   int N, void* stream) {
  return (int)lpm_native::launch_bias_act(true, static_cast<const float*>(y),
                                          static_cast<const float*>(bias),
                                          static_cast<float*>(out_f32), static_cast<bf16*>(out_bf16),
                                          rows, N, static_cast<cudaStream_t>(stream));
}

int lpm_frame_pool(const void* act, void* out, int B, int S, int C, int max_pool, void* stream) {
  return (int)lpm_native::launch_frame_pool(static_cast<const float*>(act), static_cast<bf16*>(out),
                                            B, S, C, max_pool, static_cast<cudaStream_t>(stream));
}

int lpm_row_l2(const void* x, const void* scale, const void* bias, int arows, void* out_f32,
               void* out_bf16, long long rows, int n, void* stream) {
  return (int)lpm_native::launch_row_l2(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), arows, static_cast<float*>(out_f32),
      static_cast<bf16*>(out_bf16), rows, n, static_cast<cudaStream_t>(stream));
}

int lpm_nextvlad_assign(const void* prod, const void* scale, const void* bias, const void* gprod,
                        void* assign, void* assign_bf16, long long R, int G, int K, void* stream) {
  return (int)lpm_native::launch_nextvlad_assign(
      static_cast<const float*>(prod), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(gprod),
      static_cast<float*>(assign), static_cast<bf16*>(assign_bf16), R, G, K,
      static_cast<cudaStream_t>(stream));
}

int lpm_nextvlad_residual(const void* agg, const void* assign, const void* c2, void* out, int B,
                          int SG, int K, int Dp, void* stream) {
  return (int)lpm_native::launch_nextvlad_residual(
      static_cast<const float*>(agg), static_cast<const float*>(assign),
      static_cast<const float*>(c2), static_cast<float*>(out), B, SG, K, Dp,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
