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
//   fast_transformer  TransformerEncoderModel (ops/fast_transformer.py, bf16):
//       frame_stage with no draw (every frame, and the key mask); the input
//       projection and bias_act; each encoder layer: the fused QKV product
//       and bias_act, row 7 (masked_attention.cu), the out-projection and
//       bias_act, residual_layernorm, FFN1 and bias_act with ReLU, FFN2 and
//       bias_act, residual_layernorm; masked_mean over the valid frames;
//       the hidden FC; hidden_sum; the gated MoE tail.
//   fast_attn_netvlad  AttentionNetVLADModel: the same encoder, its last
//       residual_layernorm times the key mask (pad rows zeroed); row 2
//       (netvlad_fused.cu) with the vlad module's centres; the hidden FC;
//       hidden_sum; the gated MoE tail.
//   frame_logistic  FrameLevelLogisticModel, f32: frame_stage with no draw
//       (dequantized in f32, the predict step's preprocess_input),
//       masked_mean over num_frames, SGEMM, bias_sigmoid.
//   attention_pooling  AttentionPoolingModel, f32 (the flax graph's
//       arithmetic; no fast route exists): frame_stage with no draw in f32,
//       the input projection and bias_act, the key/value SGEMM,
//       pool_attention (Q learned queries over every frame; their
//       projection made once at load), the output projection, the hidden
//       FC, each with bias_act; the gating product and gating (f32 out);
//       the MoE in f32.
//   rnn_lstm, rnn_gru  LstmModel, GruModel, f32: frame_stage with no draw in
//       f32; a layer: one SGEMM x·W_i over every frame, then for the LSTM
//       per frame the SGEMM h·W_h and lstm_cell, for the GRU one gru_layer
//       launch over every frame (W_h kept in shared memory, a grid barrier a
//       step) (the steps' outputs, the next layer's input, and the final
//       carry at each row's last frame); the MoE in f32 on the top layer's
//       carry.
//   The gated MoE tail: the gating product on the rounded h, gating, the
//   MoE's gate and expert products, moe_combine; every route then topk.
//
// Rows 1, 2, 5, 6 and 7 are compiled into this library and nowhere else
// (ops/kernel_build.py LIBRARY_PARTS): their Python wrappers call them here
// too.  The JAX package leaves the products and the element-wise steps to
// XLA; so cuBLAS computes the products here (bf16 × bf16 → f32, or rounded
// once to bf16 from the f32 sum for NeXtVLAD's expansion, or f32 with TF32
// off for the f32 routes), and the rest are small hand kernels.  What
// bounds them: each reads its inputs and writes its outputs once (bytes;
// at B=256, V=3862 moe_combine moves 23.7 MB, about 7.1 µs at 3.35 TB/s).
// They are simple first: one thread an element for the element-wise ones
// (grid-stride) and for masked_mean (a (video, column), over the frames),
// a block a tile of 1,024 columns of a row for hidden_sum and gating (a
// float4 or two of each input a thread, every load before the math),
// two adjacent classes a thread on a 2-D grid for moe_combine,
// one warp a row for row_l2, nextvlad_assign and residual_layernorm and
// for frame_stage (a row read once as 4-byte words; the sampled rows in one
// wave, a few a warp, the next row's loads in flight), one block
// a (tile of 32 clusters, video) for nextvlad_residual (coalesced column
// sums in a fixed order, then float4 streams of agg and c2), and
// for topk one block a row that reads each entry once and selects in one
// pass (topk_select_kernel; k rounds of a block-wide argmax past its k or
// row, topk_rounds_kernel); one thread a (row, unit) for the RNN cells (gru_layer:
// a persistent cluster of two blocks a tile of 128 rows × 32 units,
// gru_layer_kernel), one
// block a (video, head, 64 queries) for pool_attention (an online softmax
// over cp.async tiles of 32 frames, register micro-tiles on the CUDA cores).  chip_smoke.py holds each against its plain
// version (ops/native_tail.py) and times it beside its bound.
//
// Arithmetic that the gate against the torch route needs: the sigmoid is
// 1 / (1 + expf(−x)) and the softmax exp(x − max) / Σ, each with expf (not
// __expf), as PyTorch computes them on the card (pool_attention's online
// softmax divides Σ exp(x − m)·v by Σ exp(x − m) once, at the end); products and sums round
// where the route rounds (__fmul_rn / __fadd_rn keep nvcc from fusing them);
// the bf16 dequantize rounds after its multiply and after its add, as
// PyTorch's bf16 arithmetic does.
//
// The C API takes no CUDA or torch types; errors come back as strings.  The
// runner counts its own launches of each kernel (lpm_runner_launches); the
// Python wrappers' counters never see them.

#include <cublas_v2.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include "native_manifest.h"
#include "tensor_core.cuh"
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
extern "C" int lpm_masked_attention(const void* qkv, const void* mask, void* out, int is_bf16,
                                    int B, int F, int H, int hd, void* stream);

namespace lpm_native {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

// ops/fused_frontend.py's DEQ_SCALE and DEQ_BIAS, rounded to f32 as ctypes
// rounds the Python floats
constexpr float kDeqScale = static_cast<float>(4.0 / 255.0);
constexpr float kDeqBias = static_cast<float>(4.0 / 512.0 - 2.0);
constexpr float kEps = 1e-12f;           // ops/normalize.py's ε on Σx²
constexpr float kLnEps = 1e-6f;          // ops/native_tail.py LN_EPS (the fast path's LayerNorm)
constexpr int kMaxHeadDim = 128;         // masked_attention.cu kAttnMaxHd
constexpr int kMaxClusters = 512;        // netvlad_core.cuh kMaxClusters (rows 1, 2, 5)
constexpr int kEwThreads = 256;
constexpr int kRowThreads = 256;         // one warp a row, 8 rows a block
constexpr int kRowsPerBlock = kRowThreads / 32;
constexpr int kStageThreads = 256;      // frame_stage: 8 warps a block
constexpr int kStageWarps = kStageThreads / 32;
constexpr int kStageWords = 9;          // the word path's 4-byte words a lane of a row
constexpr int kStageDT = 32 * 4 * kStageWords;  // the word path's row: 1152 bytes
constexpr int kResidualThreads = 256;   // nextvlad_residual: 8 warps over a video's rows
constexpr int kResidualWarps = kResidualThreads / 32;
constexpr int kResidualTile = 32;       // clusters a block, one a lane
constexpr int kMoeThreads = 128;       // moe_combine: two classes a thread
constexpr int kTopkThreads = 256;
constexpr int kTopkWarps = kTopkThreads / 32;
constexpr int kTopkFastK = 64;         // the block select's k at most
constexpr int kTopkPerSmall = 16;      // the block select's entries a thread: V ≤ 4,096
constexpr int kTopkPerLarge = 64;      // or V ≤ 16,384
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory at most
constexpr int kMaxParts = 4;          // hidden_sum's products (NetFV: fv1, fv2 of two modalities)
constexpr int kHiddenThreads = 128;   // hidden_sum: a block's threads
constexpr int kHiddenVecs = 2;        // hidden_sum: the float4s a thread takes of each input a row
constexpr int kHiddenTile = 4 * kHiddenThreads * kHiddenVecs;  // a block's columns of a row (both)
constexpr int kGatingThreads = 256;   // gating: a block's threads
constexpr int kGatingVecs = 1;        // gating: one float4 of each input a thread a row
static_assert(4 * kGatingThreads * kGatingVecs == kHiddenTile, "gating takes hidden_sum's tiles");
constexpr int kMaxMods = 2;
constexpr int kPoolThreads = 256;
constexpr int kPoolTile = 32;              // frames a key (and value) tile
constexpr int kPoolRows = 64;              // queries a block
constexpr int kPoolMaxHd = 128;            // head width at most
constexpr int kPoolPitch = kPoolMaxHd + 8; // floats a query, key or value row in shared memory
constexpr int kPoolPPitch = kPoolRows + 8; // floats a frame's row of weights
constexpr int kGruThreads = 256;
constexpr int kGruRows = 128;               // a tile's rows (videos)
constexpr int kGruUnits = 32;               // a tile's hidden units, each with its three gates
constexpr int kGruCols = 3 * kGruUnits;     // W_h's columns of a tile, gate-major: g·32 + unit
constexpr int kGruRowGroups = 16;           // a thread's rows: rg + 16·i
constexpr int kGruRowsPerThread = kGruRows / kGruRowGroups;
constexpr int kGruChunk = 16;               // k a ring stage holds
constexpr int kGruStageH = kGruRows * kGruChunk;       // a stage's h floats, [row][16]
constexpr int kGruWPitch = kGruChunk + 4;   // floats a column of a streamed stage's W_h
constexpr int kGruStages = 4;

// the counted launches, in lpm_runner_launches' names
enum Counter {
  kFrontend, kNetvladFused, kSoftdbowFused, kNetfvFused, kMaskedAttention, kFrameStage,
  kBiasSigmoid, kBiasRelu6, kFramePool, kRowL2, kNextvladAssign, kNextvladResidual, kBiasAct,
  kResidualLayernorm, kMaskedMean, kHiddenSum, kGating, kMoeCombine, kTopk, kLstmCell, kGruCell,
  kPoolAttention, kGruLayer, kNumCounters
};
const char* const kCounterNames[kNumCounters] = {
    "netvlad_frontend", "netvlad_fused", "softdbow_fused", "netfv_fused", "masked_attention",
    "frame_stage", "bias_sigmoid", "bias_relu6", "frame_pool", "row_l2", "nextvlad_assign",
    "nextvlad_residual", "bias_act", "residual_layernorm", "masked_mean", "hidden_sum",
    "gating", "moe_combine", "topk", "lstm_cell", "gru_cell", "pool_attention", "gru_layer"};

// kRoutes' order (native_manifest.h)
enum Route {
  kNetvlad, kLogistic, kMoe, kDbof, kNetrvlad, kSoftdbow, kNetfv, kNextvlad, kTransformer,
  kAttnNetvlad, kFrameLogistic, kAttnPool, kLstm, kGru
};
// bias_act_kernel's activations
enum Act { kActSigmoid, kActRelu6, kActRelu, kActNone };

bool attention_route(Route r) { return r == kTransformer || r == kAttnNetvlad; }
bool rnn_route(Route r) { return r == kLstm || r == kGru; }
// the routes of the models with no fast route that end in the MoE (f32)
bool flax_moe_route(Route r) { return r == kAttnPool || rnn_route(r); }
// the routes that read every frame (no draw: S = F)
bool all_frames_route(Route r) {
  return attention_route(r) || r == kFrameLogistic || flax_moe_route(r);
}
// the routes that end in hidden_sum and the gated MoE tail
bool gated_route(Route r) { return r == kNetvlad || (r >= kNetrvlad && r <= kAttnNetvlad); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

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

// The gated tail's element-wise steps on [rows, H] f32 (ops/native_tail.py
// hidden_sum_plain, gating_plain).  Each is bound by bytes: at B=256, H=1024
// hidden_sum moves 3.67 MB on Willow's two products (1.10 µs at 3.35 TB/s)
// and gating 2.63 MB (0.78 µs); the route's products come straight from
// cuBLAS and sit in the L2.  At a few µs the time is a thread's latency,
// not the rate: a block takes kHiddenTile columns of one row (the row from
// blockIdx.y, rows past the grid's by stride; no division), thread t of T
// the columns 4q … 4q + 3 of q = blockIdx.x · kHiddenTile / 4 + j · T + t
// for j < V, and every load of its row is issued before the first add
// (tests/test_torch_native_tail.py models the map).  hidden_sum takes T =
// 128, V = 2; gating, whose expf and division make each entry's chain the
// longer, T = 256, V = 1 (on one H100 at B=256, H=1024: gating 0.0020
// against 0.0022 ms the other way round, hidden_sum 0.0017 either way).
// On the vector path (H % 4 = 0, every f32 pointer on 16 bytes, a bf16
// output on 8) each is one float4 of each input, the f32 output a float4
// store and the bf16 one four roundings in 8 bytes; the scalar path takes
// the same columns one at a time, those below H.  The arithmetic is the
// first draft's, in its order, so both read bit for bit as before: the
// sums by __fadd_rn in the route's order, the gating's product then its
// sum (no FMA), the sigmoid with expf and an IEEE division.
template <bool kVec>
__device__ __forceinline__ void load_cols(float (&d)[4], const float* __restrict__ src, int c, int H) {
  if (kVec) {
    const float4 v = c < H ? __ldg(reinterpret_cast<const float4*>(src + c)) : make_float4(0.f, 0.f, 0.f, 0.f);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = c + e < H ? __ldg(src + c + e) : 0.f;
  }
}

// y to f32 (f) and/or rounded to bf16 (b), the columns c … c + 3 below H
template <bool kVec>
__device__ __forceinline__ void store_cols(float* __restrict__ f, bf16* __restrict__ b, const float (&y)[4], int c,
                                           int H) {
  if (kVec) {
    if (c >= H) return;
    if (f) *reinterpret_cast<float4*>(f + c) = make_float4(y[0], y[1], y[2], y[3]);
    if (b) *reinterpret_cast<uint2*>(b + c) = make_uint2(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e >= H) break;
      if (f) f[c + e] = y[e];
      if (b) b[c + e] = __float2bfloat16_rn(y[e]);
    }
  }
}

template <int kThreads>
__device__ __forceinline__ int tile_col(int j) {
  return 4 * (blockIdx.x * (kHiddenTile / 4) + j * kThreads + threadIdx.x);
}

struct HiddenSumArgs {
  const float* p[kMaxParts];
  const float* bias;
  float* h;
  bf16* hb;
  long long rows;
  int H;
};

// h = the products p[0..kParts) taken kGroup at a time (a modality's,
// summed left to right), then bias + G_0 + G_1 … (kBiasFirst: the LF
// routes) or (G_0 + G_1 …) + bias (Willow's, the transformer's); and h
// rounded to bf16
template <int kParts, int kGroup, bool kBiasFirst, bool kVec>
__global__ void __launch_bounds__(kHiddenThreads) hidden_sum_kernel(const HiddenSumArgs a) {
  for (long long r = blockIdx.y; r < a.rows; r += gridDim.y) {
    const long long row = r * a.H;
    float p[kHiddenVecs][kParts][4], b[kHiddenVecs][4];
#pragma unroll
    for (int j = 0; j < kHiddenVecs; ++j) {
      load_cols<kVec>(b[j], a.bias, tile_col<kHiddenThreads>(j), a.H);
#pragma unroll
      for (int i = 0; i < kParts; ++i) load_cols<kVec>(p[j][i], a.p[i] + row, tile_col<kHiddenThreads>(j), a.H);
    }
#pragma unroll
    for (int j = 0; j < kHiddenVecs; ++j) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float acc = b[j][e];
#pragma unroll
        for (int g = 0; g < kParts; g += kGroup) {
          float s = p[j][g][e];
#pragma unroll
          for (int i = 1; i < kGroup; ++i) s = __fadd_rn(s, p[j][g + i][e]);
          acc = (kBiasFirst || g > 0) ? __fadd_rn(acc, s) : s;
        }
        y[e] = kBiasFirst ? acc : __fadd_rn(acc, b[j][e]);
      }
      store_cols<kVec>(a.h + row, a.hb + row, y, tile_col<kHiddenThreads>(j), a.H);
    }
  }
}

// out = h · σ(gates · g_scale[col] + g_bias[col]), rounded to bf16 (kBf16)
// and/or f32 (kF32)
template <bool kBf16, bool kF32, bool kVec>
__global__ void __launch_bounds__(kGatingThreads)
gating_kernel(const float* __restrict__ gates, const float* __restrict__ h, const float* __restrict__ g_scale,
              const float* __restrict__ g_bias, bf16* __restrict__ out, float* __restrict__ out_f32, long long rows,
              int H) {
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long row = r * H;
    float x[kGatingVecs][4], hv[kGatingVecs][4], s[kGatingVecs][4], t[kGatingVecs][4];
#pragma unroll
    for (int j = 0; j < kGatingVecs; ++j) {
      load_cols<kVec>(x[j], gates + row, tile_col<kGatingThreads>(j), H);
      load_cols<kVec>(hv[j], h + row, tile_col<kGatingThreads>(j), H);
      load_cols<kVec>(s[j], g_scale, tile_col<kGatingThreads>(j), H);
      load_cols<kVec>(t[j], g_bias, tile_col<kGatingThreads>(j), H);
    }
#pragma unroll
    for (int j = 0; j < kGatingVecs; ++j) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = __fmul_rn(hv[j][e], sigmoid(__fadd_rn(__fmul_rn(x[j][e], s[j][e]), t[j][e])));
      store_cols<kVec>(kF32 ? out_f32 + row : nullptr, kBf16 ? out + row : nullptr, y,
                       tile_col<kGatingThreads>(j), H);
    }
  }
}

// The MoE combine (ops/native_tail.py#moe_combine_plain).  ga [B, (M+1)·V]
// and ea [B, M·V] keep class v's mixture m in column m·V + v;
// probs[b, v] = Σ_{m<M} softmax_m(ga[b, :, v]) · σ(ea[b, m, v] + eb[m·V + v]).
// Bound by bytes (at B=256, V=3862, M=2: 23.7 MB, 7.1 µs at 3.35 TB/s): a
// block of kMoeThreads takes 2·kMoeThreads classes of one row (the row from
// blockIdx.y, no division), a thread two adjacent classes with 8-byte loads
// where V is even (every row then starts on 8 bytes) and scalar loads else,
// every gate, expert and bias load of its M mixtures issued before the
// math.  Each exp is computed once (M from 1 to 4, in registers; a larger
// M takes moe_combine_any_kernel, the loop form, which computes each
// numerator's exp again).  The operation order, which NATIVE_ROUTE_GATES
// (chip_smoke.py) holds against the torch routes: the max, Σ exp in
// mixture order, each term's IEEE division, the sum over m in order.
template <int kM>
__device__ __forceinline__ float moe_mix(const float (&g)[kM + 1], const float (&e)[kM]) {
  float mx = g[0];
#pragma unroll
  for (int m = 1; m <= kM; ++m) mx = fmaxf(mx, g[m]);
  float ex[kM + 1], sum = 0.f;
#pragma unroll
  for (int m = 0; m <= kM; ++m) {
    ex[m] = expf(__fsub_rn(g[m], mx));
    sum = __fadd_rn(sum, ex[m]);
  }
  float p = 0.f;
#pragma unroll
  for (int m = 0; m < kM; ++m) p = __fadd_rn(p, __fmul_rn(__fdiv_rn(ex[m], sum), sigmoid(e[m])));
  return p;
}

template <int kM, bool kVec>
__global__ void __launch_bounds__(kMoeThreads)
moe_combine_kernel(const float* __restrict__ ga, const float* __restrict__ ea,
                   const float* __restrict__ eb, float* __restrict__ probs, int B, int V) {
  const int v = 2 * (blockIdx.x * kMoeThreads + threadIdx.x);
  if (v >= V) return;
  const bool pair = v + 1 < V;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const float* g = ga + b * (kM + 1) * V + v;
    const float* e = ea + b * kM * V + v;
    float g0[kM + 1], g1[kM + 1], e0[kM], e1[kM], b0[kM], b1[kM];
    if (kVec) {
#pragma unroll
      for (int m = 0; m <= kM; ++m) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(g + (long long)m * V));
        g0[m] = x.x;
        g1[m] = x.y;
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(e + (long long)m * V));
        const float2 y = __ldg(reinterpret_cast<const float2*>(eb + (long long)m * V + v));
        e0[m] = x.x;
        e1[m] = x.y;
        b0[m] = y.x;
        b1[m] = y.y;
      }
    } else {
#pragma unroll
      for (int m = 0; m <= kM; ++m) {
        g0[m] = __ldg(g + (long long)m * V);
        g1[m] = pair ? __ldg(g + (long long)m * V + 1) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        e0[m] = __ldg(e + (long long)m * V);
        e1[m] = pair ? __ldg(e + (long long)m * V + 1) : 0.f;
        b0[m] = __ldg(eb + (long long)m * V + v);
        b1[m] = pair ? __ldg(eb + (long long)m * V + v + 1) : 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      e0[m] = __fadd_rn(e0[m], b0[m]);
      e1[m] = __fadd_rn(e1[m], b1[m]);
    }
    const float p0 = moe_mix<kM>(g0, e0), p1 = moe_mix<kM>(g1, e1);
    float* out = probs + b * V + v;
    if (kVec) {
      *reinterpret_cast<float2*>(out) = make_float2(p0, p1);
    } else {
      out[0] = p0;
      if (pair) out[1] = p1;
    }
  }
}

// any M: the loop form, two classes a thread by scalar loads
__global__ void __launch_bounds__(kMoeThreads)
moe_combine_any_kernel(const float* __restrict__ ga, const float* __restrict__ ea,
                       const float* __restrict__ eb, float* __restrict__ probs, int B, int M,
                       int V) {
  const int v0 = 2 * (blockIdx.x * kMoeThreads + threadIdx.x);
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    for (int v = v0; v < V && v < v0 + 2; ++v) {
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
      probs[b * V + v] = p;
    }
  }
}

// The top-k (ops/topk.py#top_k_exact: jax.lax.top_k's order).  A score's
// total-order key, larger first: its bits with the sign bit set where it
// was clear and every bit flipped where it was set, so −NaN < −inf < … <
// −0 < +0 < … < +inf < +NaN, NaNs by payload; topk_value inverts it, so
// values come back bit for bit.
__device__ __forceinline__ uint32_t topk_order(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float topk_value(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
// (score, index) as one integer, unique in a row, larger first: the total
// order, then the lower index.  Every key is above 0 (an index is below 2³¹).
__device__ __forceinline__ unsigned long long topk_key(uint32_t o, int i) {
  return ((unsigned long long)o << 32) | (0xffffffffu - (uint32_t)i);
}

__device__ __forceinline__ void topk_write(unsigned long long key, float* values,
                                           int32_t* indices, long long at) {
  values[at] = topk_value((uint32_t)(key >> 32));
  indices[at] = (int32_t)(0xffffffffu - (uint32_t)key);
}

__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, off);
    x = y > x ? y : x;
  }
  return x;
}

// The block select, for k ≤ kTopkFastK and V ≤ kTopkThreads·kPer.  Bound
// by bytes (at B=256, V=3862: 3.95 MB, 1.2 µs at 3.35 TB/s), so it reads
// each entry once and selects in one pass, where k rounds (below) chain k
// block-wide reductions.  One block a row, coalesced: thread t holds entries
// t + kTopkThreads·j as keys in registers (an index past V: a key below
// every entry's).  Then:
//   1. each lane's largest key; each warp sorts its 32 (bitonic, shuffles);
//   2. θ, the k-th largest of the block's lane maxima: each lane's rank is
//      its place in its warp's list plus, for every other warp, the count
//      of that list above it (a binary search in shared memory); the lane
//      of rank k − 1 writes θ.  The keys are unique, so exactly k lanes hold
//      a key ≥ θ, and the entries ≥ θ, at least k, are at most k·kPer;
//   3. those lanes gather their entries ≥ θ into shared memory;
//   4. each candidate's rank is the count of candidates above it; those of
//      rank < k write their value and index there.
// Three __syncthreads, no dynamic shared memory.
template <int kPer>
__global__ void __launch_bounds__(kTopkThreads)
topk_select_kernel(const float* __restrict__ probs, float* __restrict__ values,
                   int32_t* __restrict__ indices, int V, int k) {
  __shared__ unsigned long long lists[kTopkWarps][32];
  __shared__ unsigned long long cand[kTopkFastK * kPer];
  __shared__ unsigned long long theta;
  __shared__ int n_cand;
  const long long b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* row = probs + b * V;
  uint32_t o[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = t + j * kTopkThreads;
    o[j] = i < V ? topk_order(__ldg(row + i)) : 0u;
  }
  unsigned long long mine = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned long long key = topk_key(o[j], t + j * kTopkThreads);
    mine = key > mine ? key : mine;
  }
  // 1. the warp's lane maxima, sorted descending
  unsigned long long m = mine;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride; stride >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, m, stride);
      const bool larger = ((lane & stride) == 0) == ((lane & size) == 0);
      m = larger ? (other > m ? other : m) : (other < m ? other : m);
    }
  }
  lists[warp][lane] = m;
  if (t == 0) n_cand = 0;
  __syncthreads();
  // 2. θ
  int rank = lane;
#pragma unroll
  for (int w = 0; w < kTopkWarps; ++w) {
    if (w == warp) continue;
    const unsigned long long* list = lists[w];
    int p = 0;
#pragma unroll
    for (int s = 16; s; s >>= 1) p += list[p + s - 1] > m ? s : 0;
    rank += p + (list[p] > m);
  }
  if (rank == k - 1) theta = m;
  __syncthreads();
  // 3. the candidates
  const unsigned long long th = theta;
  if (mine >= th) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const unsigned long long key = topk_key(o[j], t + j * kTopkThreads);
      if (key >= th) cand[atomicAdd(&n_cand, 1)] = key;
    }
  }
  __syncthreads();
  // 4. their ranks
  const int n = n_cand;
  for (int c = t; c < n; c += kTopkThreads) {
    const unsigned long long key = cand[c];
    int r = 0;
    for (int c2 = 0; c2 < n; ++c2) r += cand[c2] > key;
    if (r < k) topk_write(key, values, indices, b * k + r);
  }
}

// Any V and k (a k above kTopkFastK, or a row past the block select's
// registers): k rounds of a block-wide max of the key over the entries
// below the previous pick, each round reading the row from the caches.
__global__ void __launch_bounds__(kTopkThreads)
topk_rounds_kernel(const float* __restrict__ probs, float* __restrict__ values,
                   int32_t* __restrict__ indices, int V, int k) {
  __shared__ unsigned long long partial[kTopkWarps];
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = probs + b * V;
  unsigned long long prev = 0;
  for (int r = 0; r < k; ++r) {
    unsigned long long best = 0;
    for (int i = threadIdx.x; i < V; i += kTopkThreads) {
      const unsigned long long key = topk_key(topk_order(__ldg(row + i)), i);
      if ((r == 0 || key < prev) && key > best) best = key;
    }
    best = warp_max_key(best);
    if (lane == 0) partial[warp] = best;
    __syncthreads();
    best = warp_max_key(lane < kTopkWarps ? partial[lane] : 0);
    __syncthreads();  // every warp has read partial before the next round writes it
    if (threadIdx.x == 0) topk_write(best, values, indices, b * k + r);
    prev = best;
  }
}

// frame_stage: a staged route's frames (the sampled mode: each video's S
// frames drawn from the key, iid or one window) or every frame (the all-frames
// modes), each uint8 row of DT dequantized, ℓ2 over the row in f32 and written
// out; it replaces no pallas_call (XLA fuses ops/fast_lf.py:305-319,
// ops/fast_transformer.py:280-290 and core/step.py:38-44 in the JAX package).
// What bounds it: bytes (at B=256, F=300, S=30, DT=1152: 26.5 MB sampled with
// the affine, 265 MB for every frame in bf16, 442 MB in f32; 7.9, 79 and 132
// µs at 3.35 TB/s).  Its design: a warp takes every W-th row (W the grid's
// warps, so the grid sweeps the rows in order: every frame a row a warp, block
// after block; the sampled rows in one wave, a few a warp); its lanes resolve
// the sources of 32 of its rows at a time (lane i the draw and num_frames of
// its i-th, or the key mask) and hand each out with a shuffle; on the word
// path (DT = kStageDT, 4-byte aligned rows) a lane loads its 9 words of a row
// (words l + 32·j: 128 contiguous bytes a warp-load) before any math, the next
// row's words in flight under the current row's math, and dequantizes them
// once into registers (bytes to exact floats by their bits, the bf16
// dequantize as two bf16x2 FMAs of one rounding each); Σx² in one warp sum;
// out as 8-byte (4 × bf16) or 16-byte (4 × f32) stores; the affine by float4.
// Any other DT or alignment takes the byte path in the same entry point: a
// lane the columns l + 32·j, read twice.
enum StageMode { kStageSampled, kStageAllBf16, kStageAllF32 };

struct StageArgs {
  const uint8_t* x;
  const int32_t* num_frames;
  const float* in_scale;  // the sampled mode's folded input BN, or null
  const float* in_bias;
  bf16* out_bf16;
  float* out_f32;
  float* mask;            // the all-frames modes' key mask, or null
  int rows, F, DT, S, window;
  uint32_t k0, k1;
  float deq_scale, deq_bias;
};

// byte i of w as an exact float: the bits 0x4B0000XX are 2²³ + XX
__device__ __forceinline__ float byte_f32(uint32_t w, int i) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)), 8388608.0f);
}
// a·b + c on two bf16 pairs, one rounding each
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }
constexpr uint32_t kBf16x2One = 0x3F803F80u, kBf16x2NegZero = 0x80008000u;

// The source row of staged row `row` (b·F + f), and in the all-frames modes
// its key mask f < num_frames[b]: iid, floor(U·min(nf, F)) clamped to F − 1
// with U the draw of counter b·S + s, as fused_frontend.cu draws it;
// window, the start floor(U·(max(nf − S, 0) + 1)) with U the draw of
// counter b, frame min(start + s, nf − 1) clipped to [0, F)
template <int kMode>
__device__ __forceinline__ int stage_source(const StageArgs& a, int row) {
  if (kMode != kStageSampled) {
    if (a.mask) {
      const int b = row / a.F;
      a.mask[row] = row - b * a.F < a.num_frames[b] ? 1.f : 0.f;
    }
    return row;
  }
  const int b = row / a.S, s = row - b * a.S;
  const int nf = min(a.num_frames[b], a.F);
  int f;
  if (a.window) {
    const float u = lpm::threefry_uniform(a.k0, a.k1, b);
    const int start = (int)__fmul_rn(u, __fadd_rn((float)max(nf - a.S, 0), 1.0f));
    f = max(0, min(min(start + s, nf - 1), a.F - 1));
  } else {
    const float u = lpm::threefry_uniform(a.k0, a.k1, row);
    f = min((int)__fmul_rn(u, (float)nf), a.F - 1);
  }
  return b * a.F + f;
}

// the dequantize's constants: f32 (kStageAllF32) as given, else rounded
// to bf16 (and as bf16 pairs)
struct StageDeq {
  float qs, qb;
  uint32_t qs2, qb2;
  template <int kMode>
  __device__ static StageDeq make(const StageArgs& a) {
    const bool f32 = kMode == kStageAllF32;
    const float qs = f32 ? a.deq_scale : round_bf16(a.deq_scale);
    const float qb = f32 ? a.deq_bias : round_bf16(a.deq_bias);
    return {qs, qb, pack_bf16x2(qs, qs), pack_bf16x2(qb, qb)};
  }
};

// the four values of word w: in f32 v·qs + qb; in bf16 bf16(bf16(v·qs) + qb)
// (v exact in bf16; each FMA's product or sum exact in f32 before its one
// rounding), bit for bit the byte path's
template <int kMode>
__device__ __forceinline__ void stage_deq4(uint32_t w, const StageDeq& q, float (&v)[4]) {
  if (kMode == kStageAllF32) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __fadd_rn(__fmul_rn(byte_f32(w, e), q.qs), q.qb);
    return;
  }
  uint32_t lo = pack_bf16x2(byte_f32(w, 0), byte_f32(w, 1));
  uint32_t hi = pack_bf16x2(byte_f32(w, 2), byte_f32(w, 3));
  lo = bf16x2_fma(bf16x2_fma(lo, q.qs2, kBf16x2NegZero), kBf16x2One, q.qb2);
  hi = bf16x2_fma(bf16x2_fma(hi, q.qs2, kBf16x2NegZero), kBf16x2One, q.qb2);
  v[0] = bf16_lo(lo);
  v[1] = bf16_hi(lo);
  v[2] = bf16_lo(hi);
  v[3] = bf16_hi(hi);
}

// the word path's loads of source row src: lane l the words l + 32·j
template <int kW>
__device__ __forceinline__ void stage_load(const uint8_t* x, int src, int lane, uint32_t (&w)[kW]) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(x + (size_t)src * (32 * 4 * kW)) + lane;
#pragma unroll
  for (int j = 0; j < kW; ++j) w[j] = __ldg(p + 32 * j);
}

// one row from its words: dequantized once, Σx² (a lane's 4·kW values in
// order, then the warp's butterfly), x · rsqrt(max(Σ, ε)), out
template <int kMode, int kW>
__device__ __forceinline__ void stage_words(const uint32_t (&w)[kW], const StageArgs& a, const StageDeq& q,
                                            int row, int lane) {
  float v[kW][4];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    stage_deq4<kMode>(w[j], q, v[j]);
#pragma unroll
    for (int e = 0; e < 4; ++e) ss = __fadd_rn(ss, __fmul_rn(v[j][e], v[j][e]));
  }
  const float inv = rsqrtf(fmaxf(warp_sum(ss), kEps));
  const size_t base = (size_t)row * (32 * 4 * kW);
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const int c = 4 * (lane + 32 * j);
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = __fmul_rn(v[j][e], inv);
    if (kMode == kStageAllF32) {
      *reinterpret_cast<float4*>(a.out_f32 + base + c) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      if (kMode == kStageSampled && a.in_scale) {
        const float4 s = __ldg(reinterpret_cast<const float4*>(a.in_scale + c));
        const float4 t = __ldg(reinterpret_cast<const float4*>(a.in_bias + c));
        y[0] = __fadd_rn(__fmul_rn(round_bf16(y[0]), s.x), t.x);
        y[1] = __fadd_rn(__fmul_rn(round_bf16(y[1]), s.y), t.y);
        y[2] = __fadd_rn(__fmul_rn(round_bf16(y[2]), s.z), t.z);
        y[3] = __fadd_rn(__fmul_rn(round_bf16(y[3]), s.w), t.w);
      }
      *reinterpret_cast<uint2*>(a.out_bf16 + base + c) =
          make_uint2(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]));
    }
  }
}

// one row on the byte path: lane l the columns l + 32·j, read for Σx² and
// again to write, the same dequantize and arithmetic
template <int kMode>
__device__ void stage_byte_row(const StageArgs& a, const StageDeq& q, int src, int row, int lane) {
  const uint8_t* x = a.x + (size_t)src * a.DT;
  auto deq = [&](int c) {
    const float v = x[c];
    return kMode == kStageAllF32 ? __fadd_rn(__fmul_rn(v, q.qs), q.qb)
                                 : round_bf16(__fadd_rn(round_bf16(__fmul_rn(v, q.qs)), q.qb));
  };
  float ss = 0.f;
  for (int c = lane; c < a.DT; c += 32) {
    const float t = deq(c);
    ss = __fadd_rn(ss, __fmul_rn(t, t));
  }
  const float inv = rsqrtf(fmaxf(warp_sum(ss), kEps));
  const size_t base = (size_t)row * a.DT;
  for (int c = lane; c < a.DT; c += 32) {
    float y = __fmul_rn(deq(c), inv);
    if (kMode == kStageAllF32) {
      a.out_f32[base + c] = y;
    } else {
      if (kMode == kStageSampled && a.in_scale)
        y = __fadd_rn(__fmul_rn(round_bf16(y), a.in_scale[c]), a.in_bias[c]);
      a.out_bf16[base + c] = __float2bfloat16_rn(y);
    }
  }
}

// kW > 0: the word path (DT = 128·kW); 0: the byte path
template <int kMode, int kW>
__global__ void __launch_bounds__(kStageThreads) frame_stage_kernel(const StageArgs a) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kStageWarps;
  const long long warp = (long long)blockIdx.x * kStageWarps + (threadIdx.x >> 5);
  const StageDeq q = StageDeq::make<kMode>(a);
  // the warp's rows warp + i·warps (the grid sweeps the rows in order), 32
  // at a time: lane i resolves the i-th's source
  for (long long r0 = warp; r0 < a.rows; r0 += 32 * warps) {
    const int n = (int)min(32LL, (a.rows - r0 + warps - 1) / warps);
    const int src = lane < n ? stage_source<kMode>(a, (int)(r0 + lane * warps)) : 0;
    if constexpr (kW > 0) {
      uint32_t cur[kW], next[kW];
      stage_load(a.x, __shfl_sync(0xffffffffu, src, 0), lane, cur);
      for (int i = 0; i < n; ++i) {
        if (i + 1 < n) stage_load(a.x, __shfl_sync(0xffffffffu, src, i + 1), lane, next);
        stage_words<kMode, kW>(cur, a, q, (int)(r0 + i * warps), lane);
#pragma unroll
        for (int j = 0; j < kW; ++j) cur[j] = next[j];
      }
    } else {
      for (int i = 0; i < n; ++i)
        stage_byte_row<kMode>(a, q, __shfl_sync(0xffffffffu, src, i), (int)(r0 + i * warps), lane);
    }
  }
}

// out = act(y + bias[col]) (Act: σ, clip(·, 0, 6), ReLU or none); f32 (in
// place: out_f32 may be y) and/or bf16 out
template <int kAct>
__global__ void bias_act_kernel(const float* y, const float* __restrict__ bias, float* out_f32,
                                bf16* __restrict__ out_bf16, long long n, int N) {
  for (long long i = grid_start(); i < n; i += grid_step()) {
    const float v = __fadd_rn(y[i], bias[(int)(i % N)]);
    const float a = kAct == kActRelu6  ? fminf(fmaxf(v, 0.f), 6.f)
                    : kAct == kActRelu ? (v > 0.f || isnan(v) ? v : 0.f)
                    : kAct == kActNone ? v
                                       : sigmoid(v);
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

// One warp a row of D: x = a + b in f32 (two bf16 rows), LayerNorm with
// mean = Σx · inv_d, var = Σx² · inv_d − mean² (no clamp) and
// rsqrt(var + 1e-6), then · scale + bias, rounded to bf16; with mask, that
// rounding times mask[row].  out may be a (each lane writes the columns it
// read, after the row's sums).
__global__ void __launch_bounds__(kRowThreads)
residual_layernorm_kernel(const bf16* a, const bf16* __restrict__ b,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          const float* __restrict__ mask, bf16* out, long long rows, int D,
                          float inv_d) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* pa = a + row * D;
  const bf16* pb = b + row * D;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float x = __fadd_rn(__bfloat162float(pa[c]), __bfloat162float(pb[c]));
    s = __fadd_rn(s, x);
    ss = __fadd_rn(ss, __fmul_rn(x, x));
  }
  const float mean = __fmul_rn(warp_sum(s), inv_d);
  const float var = __fsub_rn(__fmul_rn(warp_sum(ss), inv_d), __fmul_rn(mean, mean));
  const float r = rsqrtf(__fadd_rn(var, kLnEps));
  const float m = mask ? mask[row] : 1.f;
  for (int c = lane; c < D; c += 32) {
    const float x = __fadd_rn(__bfloat162float(pa[c]), __bfloat162float(pb[c]));
    float y = round_bf16(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), r), scale[c]), bias[c]));
    if (mask) y = __fmul_rn(y, m);
    out[row * D + c] = __float2bfloat16_rn(y);
  }
}

// One thread a (video b, column c): Σ x[b, f, c] in f32 over the valid
// frames f < min(num_frames[b], F) in frame order, over max(n, 1): n the
// count of valid frames (count_valid) or num_frames[b] itself; f32 or bf16
// out.
template <typename T>
__global__ void masked_mean_kernel(const T* __restrict__ x, const int32_t* __restrict__ num_frames,
                                   float* __restrict__ out_f32, bf16* __restrict__ out_bf16, int B,
                                   int F, int C, int count_valid) {
  const long long n = (long long)B * C;
  for (long long i = grid_start(); i < n; i += grid_step()) {
    const long long b = i / C;
    const int c = (int)(i % C);
    const int nf = num_frames[b];
    const int valid = max(0, min(nf, F));
    const T* p = x + b * F * C + c;
    float s = 0.f;
    for (int f = 0; f < valid; ++f) s = __fadd_rn(s, to_f32(p[(long long)f * C]));
    const float y = __fdiv_rn(s, fmaxf((float)(count_valid ? valid : nf), 1.f));
    if (out_f32) out_f32[i] = y;
    if (out_bf16) out_bf16[i] = __float2bfloat16_rn(y);
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

// nextvlad_residual: out[b, k, :] = agg[b, k, :] − (Σ_r assign[b·SG + r, k])
// · c2[k, :] over a video's S·G rows (out may be agg); it replaces no
// pallas_call (XLA fuses ops/fast_lf.py:264-265).  What bounds it:
// bytes (at NeXtVLAD-128 rgb, B=256: 98.7 MB, 29.5 µs at 3.35 TB/s).  Its
// design: a block a (tile of kResidualTile clusters, video) on a 2-D grid;
// lane l sums column k0 + l and warp w the rows w, w + 8, … in order, so a
// row's 32 floats come in one 128-byte load; the eight warps' partial sums
// are added in warp order in shared memory (no atomics: the same bits
// every run); then the tile's rows of agg and c2, contiguous, stream
// through as float4 (scalar where D′ % 4 ≠ 0 or a base is not 16-byte
// aligned), each element read by the thread that writes it.
__global__ void __launch_bounds__(kResidualThreads)
nextvlad_residual_kernel(const float* agg, const float* __restrict__ assign,
                         const float* __restrict__ c2, float* out, int B, int SG, int K, int Dp,
                         int vec) {
  __shared__ float partial[kResidualWarps][kResidualTile];
  __shared__ float asum[kResidualTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kResidualTile;
  const int nk = min(kResidualTile, K - k0);
  const int n = nk * Dp;  // the tile's entries of a video
  const float* ct = c2 + (size_t)k0 * Dp;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    float s = 0.f;
    if (lane < nk) {
      const float* col = assign + (size_t)b * SG * K + k0 + lane;
#pragma unroll 6
      for (int r = warp; r < SG; r += kResidualWarps) s = __fadd_rn(s, __ldg(col + (size_t)r * K));
    }
    partial[warp][lane] = s;
    __syncthreads();
    if (warp == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kResidualWarps; ++w) t = __fadd_rn(t, partial[w][lane]);
      asum[lane] = t;
    }
    __syncthreads();
    const size_t base = ((size_t)b * K + k0) * Dp;
    const float* at = agg + base;
    float* ot = out + base;
    if (vec) {
      for (int i = threadIdx.x; 4 * i < n; i += kResidualThreads) {
        const float t = asum[4 * i / Dp];  // a float4 stays in one cluster's row (D′ % 4 = 0)
        const float4 x = *reinterpret_cast<const float4*>(at + 4 * i);
        const float4 c = __ldg(reinterpret_cast<const float4*>(ct + 4 * i));
        *reinterpret_cast<float4*>(ot + 4 * i) =
            make_float4(__fsub_rn(x.x, __fmul_rn(t, c.x)), __fsub_rn(x.y, __fmul_rn(t, c.y)),
                        __fsub_rn(x.z, __fmul_rn(t, c.z)), __fsub_rn(x.w, __fmul_rn(t, c.w)));
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kResidualThreads)
        ot[i] = __fsub_rn(at[i], __fmul_rn(asum[i / Dp], ct[i]));
    }
    __syncthreads();  // asum and partial are rewritten for the next video
  }
}

// The carry index of a row: min(num_frames, F) − 1 mod F, as flax's
// _select_last_carry reads x[seq_lengths − 1] (a row of no frames takes the
// carry after frame F − 1).
__device__ __forceinline__ int last_frame(int nf, int F) {
  const int n = (min(nf, F) - 1) % F;
  return n < 0 ? n + F : n;
}

// One step t of flax's OptimizedLSTMCell for every row, f32: one thread a
// (row b, unit j); the gates (hw + b_h) + pre in the order i, f, g, o (pre:
// row b at b·ld_pre, the step's x·W_i), c′ = σ(f)·c + σ(i)·tanh(g), h′ =
// σ(o)·tanh(c′), each product and sum rounded as PyTorch's element-wise ops
// round them.  h′ to h_out, to seq (row b at b·ld_seq) and, where t is the
// row's last frame, to carry.  c_out may be c_in.  It replaces no
// pallas_call: flax's cell runs in XLA's lax.scan (JAX
// models/frame_level.py:263-269).  Bytes bound it (the step's two [B, 4H]
// products in, h and c out: about 3 µs at B=256, H=1024 and 3.35 TB/s); a
// thread reads its unit's four gates from each product, coalesced across a
// warp.
__global__ void lstm_cell_kernel(const float* __restrict__ pre, long long ld_pre,
                                 const float* __restrict__ hw, const float* __restrict__ b_h,
                                 const float* c_in, float* c_out, float* __restrict__ h_out,
                                 float* __restrict__ seq, long long ld_seq,
                                 float* __restrict__ carry, const int32_t* __restrict__ nf, int B,
                                 int F, int H, int t) {
  const long long n = (long long)B * H;
  for (long long i = grid_start(); i < n; i += grid_step()) {
    const long long b = i / H;
    const int j = (int)(i % H);
    const float* p = pre + b * ld_pre + j;
    const float* w = hw + b * 4 * H + j;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) z[g] = __fadd_rn(__fadd_rn(w[g * H], b_h[g * H + j]), p[g * H]);
    const float c = __fadd_rn(__fmul_rn(sigmoid(z[1]), c_in[i]), __fmul_rn(sigmoid(z[0]), tanhf(z[2])));
    const float h = __fmul_rn(sigmoid(z[3]), tanhf(c));
    c_out[i] = c;
    h_out[i] = h;
    if (seq) seq[b * ld_seq + j] = h;
    if (carry && t == last_frame(nf[b], F)) carry[i] = h;
  }
}

// One step t of flax's GRUCell for every row, f32, as lstm_cell: r, z =
// σ((pre + b_i) + hw), n = tanh((pre_n + b_in) + r·(hw_n + b_hn)), h′ =
// (1 − z)·n + z·h.  h_out may be h_in.  It replaces no pallas_call (JAX
// models/frame_level.py:284-290, XLA); bytes bound it, as lstm_cell.
__global__ void gru_cell_kernel(const float* __restrict__ pre, long long ld_pre,
                                const float* __restrict__ hw, const float* __restrict__ b_i,
                                const float* __restrict__ b_hn, const float* h_in, float* h_out,
                                float* __restrict__ seq, long long ld_seq, float* __restrict__ carry,
                                const int32_t* __restrict__ nf, int B, int F, int H, int t) {
  const long long n = (long long)B * H;
  for (long long i = grid_start(); i < n; i += grid_step()) {
    const long long b = i / H;
    const int j = (int)(i % H);
    const float* p = pre + b * ld_pre + j;
    const float* w = hw + b * 3 * H + j;
    const float r = sigmoid(__fadd_rn(__fadd_rn(p[0], b_i[j]), w[0]));
    const float z = sigmoid(__fadd_rn(__fadd_rn(p[H], b_i[H + j]), w[H]));
    const float nn = tanhf(__fadd_rn(__fadd_rn(p[2 * H], b_i[2 * H + j]),
                                     __fmul_rn(r, __fadd_rn(w[2 * H], b_hn[j]))));
    const float h = __fadd_rn(__fmul_rn(__fsub_rn(1.f, z), nn), __fmul_rn(z, h_in[i]));
    h_out[i] = h;
    if (seq) seq[b * ld_seq + j] = h;
    if (carry && t == last_frame(nf[b], F)) carry[i] = h;
  }
}

// One GRU layer over every frame, f32, in one cooperative launch: flax's
// nn.RNN(nn.GRUCell) (JAX models/frame_level.py:276-290, lax.scan in XLA,
// no pallas_call) from a zero state, given pre = x·W_i [B, F, 3H] (row b at
// b·ld_pre_b, step t at t·ld_pre_t).  Step t: hw = h_{t−1}·W_h by f32 FMA in
// a fixed order (no atomics: each of a cluster's two blocks sums its half
// of k in increasing k, then hw = sum₀ + sum₁; hw = 0 at t = 0), then
// gru_cell_kernel's arithmetic; h_t to seq (row b at b·ld_seq_b, step t at
// t·ld_seq_t), to carry where t is the row's last_frame (no carry: carry and
// nf null), and to the ping-pong state hbuf [2][B][Hp] (Hp = H rounded up
// to 4, columns H … Hp − 1 kept 0) that step t + 1 reads after a grid
// barrier.
//
// Bound: operations, 2·B·H·3H a step on the CUDA cores (24 µs at B=256,
// H=1024 and 67 TFLOP/s, 7.2 ms a layer of 300 frames); its bytes (W_h once,
// pre and seq once: 1.3 GB a layer, 0.38 ms) are far below.  It replaces the
// per-frame pair of a cuBLAS SGEMM and gru_cell, which read W_h (12.6 MB)
// from L2 each step, wrote hw to memory and read it back, and left two
// launch gaps a step.  Besides the FMA, a step is paced by the L2 → SM
// traffic of h (a block of 128 rows and all of k would read 512 KB a step,
// 64 MB over the card), by the shared memory's 32 lane-values a clock
// against 128 FMA, and by the cell's loads; tools/torch_gru_layer_phases.py
// times each phase on the card (PERF.md: the k loop's shared-memory loads
// now lead).  Design:
//  - a tile is 128 rows × 32 units with their three gates (96 columns of
//    W_h), taken by a cluster of two blocks that split k in halves: a block
//    reads 256 KB of h a step (32 MB over the card), and its slice of W_h
//    [96 × H/2] (192 KB at H=1024) stays in shared memory for the whole
//    layer (kResident); at most one block an SM, every block resident
//    (cooperative launch), one tile a cluster at B=256, H=1024 (64
//    clusters);
//  - each thread keeps 8 rows (rg + 16·i) × 2 units (v, v + 16) × 3 gates =
//    48 accumulators: 14 loads of shared memory for 48 FMA a k (a thread of
//    8 rows × 3 columns, 11 loads for 24 FMA, left the FMA units waiting);
//  - after the k loop each block hands its partner, through distributed
//    shared memory, its sums of the units the partner finishes (block r of
//    the cluster finishes units v + 16r), and finishes 8 rows × 1 unit a
//    thread: hw = sum₀ + sum₁, then the cell;
//  - h_{t−1} streams through a four-stage cp.async ring of [128 × 16]
//    chunks (16-byte .cg copies, from L2 only: hbuf changes between steps),
//    one __syncthreads a stage; float4s of h and W_h along k, a quarter-warp
//    reading one row of h (a broadcast) and eight units' W_h (pitch Kh + 4
//    floats: distinct banks);
//  - the cell's x·W_i is prefetched from HBM into L2 at the step's start;
//    it and the cell's other inputs (h_{t−1} of the thread's unit, the
//    biases, num_frames) are loaded after the k loop, all in flight at once
//    under the exchange (held in registers through the loop, they left too
//    few for the loop's loads);
//  - cooperative_groups' grid.sync() between steps (header-only since CUDA
//    11: the build needs no -rdc), cluster.sync() around the exchange;
//  - a shape whose clusters outnumber the resident ones, or whose slice of
//    W_h does not fit (Kh > 512), streams W_h's [96 × 16] chunk beside h's
//    through the same ring (4-byte copies, transposed to k-major), each
//    cluster walking its tiles in turn each step (!kResident).
template <bool kResident>
__global__ void __launch_bounds__(kGruThreads, 1)
gru_layer_kernel(const float* __restrict__ pre, long long ld_pre_b, long long ld_pre_t,
                 const float* __restrict__ w_h, const float* __restrict__ b_i,
                 const float* __restrict__ b_hn, float* hbuf, float* __restrict__ seq,
                 long long ld_seq_b, long long ld_seq_t, float* __restrict__ carry,
                 const int32_t* __restrict__ nf, int B, int F, int H, int Hp, int Kh) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStageFloats = kGruStageH + (kResident ? 0 : kGruCols * kGruWPitch);
  const int w_pitch = kResident ? Kh + 4 : kGruWPitch;
  float* ring = smem + (kResident ? kGruCols * w_pitch : 0);
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();           // this block's half of k
  const int cluster_id = blockIdx.x / 2, clusters = gridDim.x / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int v = (warp & 1) * 8 + (lane & 7);            // units v and v + 16 of the tile
  const int rg = (warp >> 1) * 4 + (lane >> 3);         // rows rg + 16·i
  const int unit_tiles = (H + kGruUnits - 1) / kGruUnits;
  const int tiles = (B + kGruRows - 1) / kGruRows * unit_tiles;
  const int kbase = rank * Kh, nstages = Kh / kGruChunk;
  const long long G3 = 3LL * H;

  if (kResident && cluster_id < tiles) {
    // the tile's 96 columns of W_h over this block's half of k, k-major, by
    // 4-byte copies all in flight at once; rows k ≥ H and units j ≥ H zero
    const int j0 = (cluster_id % unit_tiles) * kGruUnits;
    for (int idx = threadIdx.x; idx < Kh * kGruCols; idx += kGruThreads) {
      const int kk = idx / kGruCols, c = idx % kGruCols, j = j0 + c % kGruUnits, k = kbase + kk;
      const bool in = k < H && j < H;
      lpm::cp_async_4(lpm::smem_addr(smem + c * w_pitch + kk),
                      in ? w_h + (long long)k * G3 + (long long)(c / kGruUnits) * H + j : w_h, in ? 4 : 0);
    }
    lpm::cp_async_commit();
    lpm::cp_async_wait<0>();
    __syncthreads();
  }
  for (int t = 0; t < F; ++t) {
    const float* h_prev = hbuf + (long long)((t + 1) & 1) * B * Hp;
    float* h_next = hbuf + (long long)(t & 1) * B * Hp;
    for (int tile = cluster_id; tile < tiles; tile += clusters) {
      const int row0 = tile / unit_tiles * kGruRows;
      const int j0 = tile % unit_tiles * kGruUnits;
      const int j = j0 + v + 16 * rank;  // the unit whose cell this thread finishes
      const bool unit = j < H;
      // the cells' x·W_i, from HBM into L2 while the k loop runs
#pragma unroll
      for (int i = 0; i < kGruRowsPerThread; ++i) {
        const long long b = row0 + rg + kGruRowGroups * i;
        if (b < B && unit)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(pre + b * ld_pre_b + t * ld_pre_t + (long long)g * H + j));
      }
      // the cells' other inputs, loaded all at once (after the k loop, whose
      // loads need the registers; their latency under the exchange)
      float xin[kGruRowsPerThread][3], hp[kGruRowsPerThread], bias[4];
      int frames[kGruRowsPerThread];
      auto load_cells = [&]() {
#pragma unroll
        for (int g = 0; g < 3; ++g) bias[g] = unit ? __ldg(b_i + g * H + j) : 0.f;
        bias[3] = unit ? __ldg(b_hn + j) : 0.f;
#pragma unroll
        for (int i = 0; i < kGruRowsPerThread; ++i) {
          const long long b = row0 + rg + kGruRowGroups * i;
          const bool live = b < B && unit;
#pragma unroll
          for (int g = 0; g < 3; ++g)
            xin[i][g] = live ? __ldcs(pre + b * ld_pre_b + t * ld_pre_t + (long long)g * H + j) : 0.f;
          hp[i] = live && t > 0 ? __ldcg(h_prev + b * Hp + j) : 0.f;
          frames[i] = live && carry ? __ldg(nf + b) : 0;
        }
      };
      // acc[i][2g + s]: row rg + 16·i, gate g of unit v + 16·s
      float acc[kGruRowsPerThread][6];
#pragma unroll
      for (int i = 0; i < kGruRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[i][c] = 0.f;
      if (t > 0) {
        // this thread's two 16-byte pieces of each stage's h chunk: rows
        // tid/4 and tid/4 + 64, k 4·(tid % 4) … + 3, addresses fixed for the
        // step and advanced by a stage's k
        static_assert(kGruStageH / 4 == 2 * kGruThreads, "two 16-byte copies a thread a stage");
        const int r0 = threadIdx.x >> 2, kq = kbase + 4 * (threadIdx.x & 3);
        const bool in0 = row0 + r0 < B, in1 = row0 + r0 + kGruRows / 2 < B;
        const float* src0 = in0 ? h_prev + (long long)(row0 + r0) * Hp + kq : h_prev;
        const float* src1 = in1 ? h_prev + (long long)(row0 + r0 + kGruRows / 2) * Hp + kq : h_prev;
        const uint32_t dst0 = lpm::smem_addr(ring + 4 * threadIdx.x);
        auto load_stage = [&](int m, int s) {
          const int k = m * kGruChunk;
          const uint32_t dst = dst0 + 4 * s * kStageFloats;
          const bool kin = kq + k < Hp;
          lpm::cp_async_16(dst, in0 && kin ? src0 + k : h_prev, in0 && kin ? 16 : 0);
          lpm::cp_async_16(dst + 4 * kGruStageH / 2, in1 && kin ? src1 + k : h_prev, in1 && kin ? 16 : 0);
          if (!kResident) {
            const int k0 = kbase + k;
            float* ws = ring + s * kStageFloats + kGruStageH;
            for (int e = threadIdx.x; e < kGruChunk * kGruCols; e += kGruThreads) {
              const int kk = e / kGruCols, c = e % kGruCols, jj = j0 + c % kGruUnits;
              const bool in = k0 + kk < H && jj < H;
              lpm::cp_async_4(lpm::smem_addr(ws + c * kGruWPitch + kk),
                              in ? w_h + (long long)(k0 + kk) * G3 + (long long)(c / kGruUnits) * H + jj : w_h,
                              in ? 4 : 0);
            }
          }
        };
#pragma unroll
        for (int s = 0; s < kGruStages - 1; ++s) {
          if (s < nstages) load_stage(s, s);
          lpm::cp_async_commit();
        }
        for (int m = 0; m < nstages; ++m) {
          lpm::cp_async_wait<kGruStages - 2>();  // stage m has landed
          __syncthreads();                       // for every thread; stage m − 1 is done with
          if (m + kGruStages - 1 < nstages) load_stage(m + kGruStages - 1, (m + kGruStages - 1) % kGruStages);
          lpm::cp_async_commit();
          const float* hs = ring + (m % kGruStages) * kStageFloats;
          const float* ws = kResident ? smem + m * kGruChunk : hs + kGruStageH;
#pragma unroll
          for (int q = 0; q < kGruChunk / 4; ++q) {
            float4 w[6];
#pragma unroll
            for (int c = 0; c < 6; ++c)
              w[c] = *reinterpret_cast<const float4*>(ws + ((c >> 1) * kGruUnits + v + 16 * (c & 1)) * w_pitch + 4 * q);
#pragma unroll
            for (int i = 0; i < kGruRowsPerThread; ++i) {
              const float4 h4 = *reinterpret_cast<const float4*>(hs + (rg + kGruRowGroups * i) * kGruChunk + 4 * q);
#pragma unroll
              for (int c = 0; c < 6; ++c) {
                acc[i][c] = fmaf(h4.x, w[c].x, acc[i][c]);
                acc[i][c] = fmaf(h4.y, w[c].y, acc[i][c]);
                acc[i][c] = fmaf(h4.z, w[c].z, acc[i][c]);
                acc[i][c] = fmaf(h4.w, w[c].w, acc[i][c]);
              }
            }
          }
        }
        load_cells();
        // the two halves' sums: each block writes into its partner's ring
        // ([i·3 + g][thread]) its sums of the units the partner finishes,
        // then hw = sum₀ + sum₁ into acc[i][2g]
        cluster.sync();  // both blocks are done with their rings
        float* remote = cluster.map_shared_rank(ring, rank ^ 1);
#pragma unroll
        for (int i = 0; i < kGruRowsPerThread; ++i)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            remote[(i * 3 + g) * kGruThreads + threadIdx.x] = rank == 0 ? acc[i][2 * g + 1] : acc[i][2 * g];
        cluster.sync();
#pragma unroll
        for (int i = 0; i < kGruRowsPerThread; ++i)
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const float other = ring[(i * 3 + g) * kGruThreads + threadIdx.x];
            acc[i][2 * g] = rank == 0 ? __fadd_rn(acc[i][2 * g], other) : __fadd_rn(other, acc[i][2 * g + 1]);
          }
        __syncthreads();  // the ring is free for the next tile's stages
      } else {
        load_cells();
      }
#pragma unroll
      for (int i = 0; i < kGruRowsPerThread; ++i) {
        const long long b = row0 + rg + kGruRowGroups * i;
        if (b >= B) continue;
        if (!unit) {
          if (j < Hp) h_next[b * Hp + j] = 0.f;
          continue;
        }
        const float r = sigmoid(__fadd_rn(__fadd_rn(xin[i][0], bias[0]), acc[i][0]));
        const float z = sigmoid(__fadd_rn(__fadd_rn(xin[i][1], bias[1]), acc[i][2]));
        const float n = tanhf(__fadd_rn(__fadd_rn(xin[i][2], bias[2]), __fmul_rn(r, __fadd_rn(acc[i][4], bias[3]))));
        const float h = __fadd_rn(__fmul_rn(__fsub_rn(1.f, z), n), __fmul_rn(z, hp[i]));
        h_next[b * Hp + j] = h;
        seq[b * ld_seq_b + t * ld_seq_t + j] = h;
        if (carry && t == last_frame(frames[i], F)) carry[b * H + j] = h;
      }
    }
    if (t + 1 < F) grid.sync();
  }
}

// pool_attention's block: the scaled queries [kPoolRows][kPoolPitch], two
// stages of a key tile and a value tile [kPoolTile][kPoolPitch] each, the
// tile's weights frame-major [kPoolTile][kPoolPPitch], and a rescale (then
// the softmax sum) a query.  It does not grow with F.
constexpr int kPoolSmemFloats =
    kPoolRows * kPoolPitch + 4 * kPoolTile * kPoolPitch + kPoolTile * kPoolPPitch + kPoolRows;
constexpr int kPoolSmem = 4 * kPoolSmemFloats;
static_assert(kPoolThreads == 256 && kPoolRows == 64 && kPoolTile == 32 && kPoolMaxHd == 128,
              "the micro-tiles below assume this block");

// Learned-query attention, f32: one block a (video b, head, 64 queries),
// of kPoolThreads.  out [B, Q, H·hd] = softmax(q·kᵀ / √hd, masked) · v per
// head, with q [Q, H·hd] the queries' projection with its bias, kv's row f
// the frame's key then value ([H·hd] each) and bkv their biases.  It
// replaces no pallas_call: flax's MultiHeadDotProductAttention runs in XLA
// (JAX models/attention.py:101-109), and row 7 takes only Lq = Lk.
//
// Bound: operations, 2·Q·hd multiply-adds a frame with weight for each
// (video, head) on the f32 CUDA cores (about 0.16 ms at
// AttentionPoolingModel's default width, B=256, on chip_smoke.py's frame
// counts); the keys and values of the valid frames are about 0.1 ms of
// bytes.  The design keeps the FMA units fed:
//  - one pass over tiles of 32 frames with an online softmax (a running max
//    m and sum l a query; the accumulators are rescaled by exp(m − m′) when
//    the max grows, and divided by l once at the end), so the block's
//    shared memory (111 KB) does not grow with F and two blocks share an SM;
//  - register micro-tiles: the logits 4 queries × 4 frames a thread over
//    every other 4 columns of d (a float4 of q and of k a step: 64 fmaf for 8
//    shared loads), the two halves of d summed by a shuffle; the weighted
//    sum 4 queries × 8 columns (32 fmaf for 3 float4 loads a frame); rows
//    padded to 136 floats, so a warp's loads hit distinct banks;
//  - the next tile's keys and values come by cp.async while this one is
//    used; each thread adds the bias to the elements it copied, once, by
//    __fadd_rn, when they land;
//  - the tiles wholly past valid = min(num_frames, F) are never read when
//    valid ≥ 1: their weights are exactly 0 (expf(−FLT_MAX − m) = 0).  A
//    video of no valid frame (every pad row of a served batch) reads all F
//    frames and attends to them uniformly, as flax does: its logits are
//    finfo(f32).min, never −inf, so m = −FLT_MAX and every weight is 1.
//    Frames past F in the last tile get −inf (weight 0), never 0/0.
// The weighted sum adds the frames in order; split-TF32 on mma.sync was not
// taken: the FMA core keeps the f32 route's arithmetic and its 1e-5 checks.
__global__ void __launch_bounds__(kPoolThreads, 2)
pool_attention_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                      const float* __restrict__ bkv, const int32_t* __restrict__ nf,
                      float* __restrict__ out, int F, int Q, int H, int hd, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // [kPoolRows][kPoolPitch], q / √hd
  float* kvs = qs + kPoolRows * kPoolPitch;           // [stage][key, value][kPoolTile][kPoolPitch]
  float* pt = kvs + 4 * kPoolTile * kPoolPitch;       // [kPoolTile][kPoolPPitch], weights of a tile
  float* qstat = pt + kPoolTile * kPoolPPitch;        // [kPoolRows]: this tile's rescale, then l
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, head = blockIdx.x % H, q0 = blockIdx.y * kPoolRows;
  const long long D = (long long)H * hd;
  const float* kvb = kv + (long long)b * F * 2 * D + (long long)head * hd;
  const float* bk = bkv + (long long)head * hd;
  const float scale = sqrtf((float)hd);
  const int valid = max(0, min(nf[b], F));
  const int lim = valid > 0 ? valid : F;  // the frames read
  const int n_tiles = (lim + kPoolTile - 1) / kPoolTile;
  const int hd8 = (hd + 7) & ~7;

  // a tile's keys and values (frames past lim and columns past hd are zero);
  // with `bias`, instead add the bias to the elements this thread copied
  auto tile_pass = [&](int t, bool bias) {
    float* ks = kvs + (t & 1) * 2 * kPoolTile * kPoolPitch;
    if (vec) {
      for (int c = tid; c < 2 * kPoolTile * (kPoolMaxHd / 4); c += kPoolThreads) {
        const int side = c / (kPoolTile * kPoolMaxHd / 4), rem = c % (kPoolTile * kPoolMaxHd / 4);
        const int r = rem / (kPoolMaxHd / 4), d = (rem % (kPoolMaxHd / 4)) * 4;
        const int f = t * kPoolTile + r;
        const bool in = f < lim && d < hd;
        float* dst = ks + (side * kPoolTile + r) * kPoolPitch + d;
        if (!bias) {
          lpm::cp_async_16(lpm::smem_addr(dst), in ? kvb + (long long)f * 2 * D + side * D + d : kvb, in ? 16 : 0);
        } else if (in) {
          const float4 x = *reinterpret_cast<float4*>(dst);
          const float4 y = __ldg(reinterpret_cast<const float4*>(bk + side * D + d));
          *reinterpret_cast<float4*>(dst) =
              make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y), __fadd_rn(x.z, y.z), __fadd_rn(x.w, y.w));
        }
      }
    } else {
      for (int c = tid; c < 2 * kPoolTile * kPoolMaxHd; c += kPoolThreads) {
        const int side = c / (kPoolTile * kPoolMaxHd), rem = c % (kPoolTile * kPoolMaxHd);
        const int r = rem / kPoolMaxHd, d = rem % kPoolMaxHd;
        const int f = t * kPoolTile + r;
        const bool in = f < lim && d < hd;
        float* dst = ks + (side * kPoolTile + r) * kPoolPitch + d;
        if (!bias)
          lpm::cp_async_4(lpm::smem_addr(dst), in ? kvb + (long long)f * 2 * D + side * D + d : kvb, in ? 4 : 0);
        else if (in)
          *dst = __fadd_rn(*dst, __ldg(bk + side * D + d));
      }
    }
    if (!bias) lpm::cp_async_commit();
  };
  tile_pass(0, false);
  for (int i = tid; i < kPoolRows * kPoolMaxHd; i += kPoolThreads) {
    const int r = i / kPoolMaxHd, d = i % kPoolMaxHd;
    qs[r * kPoolPitch + d] =
        q0 + r < Q && d < hd ? __fdiv_rn(q[(long long)(q0 + r) * D + (long long)head * hd + d], scale) : 0.f;
  }
  // the logits' micro-tile: queries lq + 16i, frames lf + 8j of the tile,
  // the columns 8m + 4h (h the lane's low bit; the other half in lane ^ 1)
  const int h = lane & 1, lq = 4 * (warp & 3) + (lane >> 3), lf = 4 * (warp >> 2) + ((lane >> 1) & 3);
  // the softmax: query sq, frames part + 4k of the tile
  const int sq = 8 * warp + (lane & 7), part = lane >> 3;
  float m_run = -INFINITY, l_run = 0.f;
  // the weighted sum: queries 4·vq + i, columns 4·vd + c and 64 + 4·vd + c
  const int vq = 4 * (warp & 3) + (lane >> 3), vd = 8 * (warp >> 2) + (lane & 7);
  float o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    lpm::cp_async_wait<0>();
    tile_pass(t, true);
    __syncthreads();  // tile t is in, with its bias; the last tile's readers are done
    if (t + 1 < n_tiles) tile_pass(t + 1, false);
    const float* ks = kvs + (t & 1) * 2 * kPoolTile * kPoolPitch;
    const float* vs = ks + kPoolTile * kPoolPitch;
    {  // logits → pt (frame-major), masked
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 4 * h; d < hd8; d += 8) {
        float4 a[4], k[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (lq + 16 * i) * kPoolPitch + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) k[j] = *reinterpret_cast<const float4*>(ks + (lf + 8 * j) * kPoolPitch + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, k[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, k[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, k[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, k[j].w, s[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // the even columns' sum first in both lanes, so both hold the same bits
          const float other = __shfl_xor_sync(0xffffffffu, s[i][j], 1);
          s[i][j] = h ? __fadd_rn(other, s[i][j]) : __fadd_rn(s[i][j], other);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = t * kPoolTile + lf + 8 * j;
#pragma unroll
        for (int i = 0; i < 4; ++i)  // lane h writes queries 2h, 2h + 1 of its four
          if (i >> 1 == h)
            pt[(lf + 8 * j) * kPoolPPitch + lq + 16 * i] = f >= F ? -INFINITY : f < valid ? s[i][j] : -FLT_MAX;
      }
    }
    __syncthreads();
    {  // the online softmax: the tile's max, its weights, the rescale
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < kPoolTile / 4; ++k) mx = fmaxf(mx, pt[(part + 4 * k) * kPoolPPitch + sq]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kPoolTile / 4; ++k) {
        float* p = pt + (part + 4 * k) * kPoolPPitch + sq;
        const float w = expf(__fsub_rn(*p, m_new));
        *p = w;
        sum = __fadd_rn(sum, w);
      }
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 8));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 16));
      const float alpha = expf(__fsub_rn(m_run, m_new));  // 0 on the first tile
      l_run = __fadd_rn(__fmul_rn(l_run, alpha), sum);
      m_run = m_new;
      if (part == 0) qstat[sq] = alpha;
    }
    __syncthreads();
    {  // the weighted sum over the tile's frames with weight
      const float4 al = *reinterpret_cast<const float4*>(qstat + 4 * vq);
      const float a4[4] = {al.x, al.y, al.z, al.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) o[i][c] = __fmul_rn(o[i][c], a4[i]);
      const int rows = min(kPoolTile, lim - t * kPoolTile);
      for (int r = 0; r < rows; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(pt + r * kPoolPPitch + 4 * vq);
        const float4 v0 = *reinterpret_cast<const float4*>(vs + r * kPoolPitch + 4 * vd);
        const float4 v1 = *reinterpret_cast<const float4*>(vs + r * kPoolPitch + 64 + 4 * vd);
        const float pw[4] = {p.x, p.y, p.z, p.w};
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) o[i][c] = fmaf(pw[i], vv[c], o[i][c]);
      }
    }
  }
  __syncthreads();  // the last tile's rescales are read
  if (part == 0) qstat[sq] = l_run;
  __syncthreads();
  const float4 l4 = *reinterpret_cast<const float4*>(qstat + 4 * vq);
  const float ls[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * vq + i;
    if (qi >= Q) continue;
    float* dst = out + ((long long)b * Q + qi) * D + (long long)head * hd;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = (c < 4 ? 0 : 64) + 4 * vd + (c & 3);
      if (d < hd) dst[d] = __fdiv_rn(o[i][c], ls[i]);
    }
  }
}

unsigned ew_blocks(long long n) {
  const long long blocks = (n + kEwThreads - 1) / kEwThreads;
  return (unsigned)(blocks < 4096 ? (blocks < 1 ? 1 : blocks) : 4096);
}

unsigned row_blocks(long long rows) {
  return (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

bool aligned_to(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// hidden_sum and gating: a block a tile of kHiddenTile columns of a row
dim3 hidden_grid(long long rows, int H) {
  return dim3((unsigned)((H + kHiddenTile - 1) / kHiddenTile), (unsigned)(rows < 65535 ? rows : 65535));
}

template <int kParts, int kGroup, bool kBiasFirst>
void hidden_sum_launch(const HiddenSumArgs& a, bool vec, cudaStream_t st) {
  if (vec)
    hidden_sum_kernel<kParts, kGroup, kBiasFirst, true><<<hidden_grid(a.rows, a.H), kHiddenThreads, 0, st>>>(a);
  else
    hidden_sum_kernel<kParts, kGroup, kBiasFirst, false><<<hidden_grid(a.rows, a.H), kHiddenThreads, 0, st>>>(a);
}

template <int kParts, int kGroup>
void hidden_sum_launch(const HiddenSumArgs& a, bool bias_first, bool vec, cudaStream_t st) {
  if (bias_first)
    hidden_sum_launch<kParts, kGroup, true>(a, vec, st);
  else
    hidden_sum_launch<kParts, kGroup, false>(a, vec, st);
}

constexpr int parts_key(int n_parts, int group) { return n_parts * 8 + group; }

// one instantiation a (n_parts, group, bias_first), on the vector path
// where H % 4 = 0 and every pointer is aligned for it
cudaError_t launch_hidden_sum(const float* const* parts, int n_parts, int group, int bias_first,
                              const float* bias, float* h, bf16* hb, long long rows, int H,
                              cudaStream_t st) {
  if (rows < 1 || H < 1 || n_parts < 1 || n_parts > kMaxParts || group < 1 ||
      n_parts % group)
    return cudaErrorInvalidValue;
  HiddenSumArgs a = {{nullptr, nullptr, nullptr, nullptr}, bias, h, hb, rows, H};
  bool vec = H % 4 == 0 && aligned_to(bias, 16) && aligned_to(h, 16) && aligned_to(hb, 8);
  for (int i = 0; i < n_parts; ++i) {
    a.p[i] = parts[i];
    vec = vec && aligned_to(parts[i], 16);
  }
  switch (parts_key(n_parts, group)) {
    case parts_key(1, 1): hidden_sum_launch<1, 1>(a, bias_first, vec, st); break;
    case parts_key(2, 1): hidden_sum_launch<2, 1>(a, bias_first, vec, st); break;
    case parts_key(2, 2): hidden_sum_launch<2, 2>(a, bias_first, vec, st); break;
    case parts_key(3, 1): hidden_sum_launch<3, 1>(a, bias_first, vec, st); break;
    case parts_key(3, 3): hidden_sum_launch<3, 3>(a, bias_first, vec, st); break;
    case parts_key(4, 1): hidden_sum_launch<4, 1>(a, bias_first, vec, st); break;
    case parts_key(4, 2): hidden_sum_launch<4, 2>(a, bias_first, vec, st); break;
    default: hidden_sum_launch<4, 4>(a, bias_first, vec, st);  // the checks leave only (4, 4)
  }
  return cudaGetLastError();
}

template <bool kBf16, bool kF32>
void gating_launch(const float* gates, const float* h, const float* g_scale, const float* g_bias, bf16* out,
                   float* out_f32, long long rows, int H, bool vec, cudaStream_t st) {
  if (vec)
    gating_kernel<kBf16, kF32, true><<<hidden_grid(rows, H), kGatingThreads, 0, st>>>(gates, h, g_scale, g_bias,
                                                                                        out, out_f32, rows, H);
  else
    gating_kernel<kBf16, kF32, false><<<hidden_grid(rows, H), kGatingThreads, 0, st>>>(gates, h, g_scale, g_bias,
                                                                                         out, out_f32, rows, H);
}

cudaError_t launch_gating(const float* gates, const float* h, const float* g_scale,
                          const float* g_bias, bf16* out, float* out_f32, long long rows, int H,
                          cudaStream_t st) {
  if (rows < 1 || H < 1 || (!out && !out_f32)) return cudaErrorInvalidValue;
  const bool vec = H % 4 == 0 && aligned_to(gates, 16) && aligned_to(h, 16) && aligned_to(g_scale, 16) &&
                   aligned_to(g_bias, 16) && aligned_to(out, 8) && aligned_to(out_f32, 16);
  if (out && out_f32)
    gating_launch<true, true>(gates, h, g_scale, g_bias, out, out_f32, rows, H, vec, st);
  else if (out)
    gating_launch<true, false>(gates, h, g_scale, g_bias, out, out_f32, rows, H, vec, st);
  else
    gating_launch<false, true>(gates, h, g_scale, g_bias, out, out_f32, rows, H, vec, st);
  return cudaGetLastError();
}

cudaError_t launch_lstm_cell(const float* pre, long long ld_pre, const float* hw, const float* b_h,
                             const float* c_in, float* c_out, float* h_out, float* seq,
                             long long ld_seq, float* carry, const int32_t* nf, int B, int F, int H,
                             int t, cudaStream_t st) {
  if (B < 1 || F < 1 || H < 1 || t < 0 || t >= F || ld_pre < 4LL * H || (seq && ld_seq < H) ||
      (carry && !nf))
    return cudaErrorInvalidValue;
  lstm_cell_kernel<<<ew_blocks((long long)B * H), kEwThreads, 0, st>>>(
      pre, ld_pre, hw, b_h, c_in, c_out, h_out, seq, ld_seq, carry, nf, B, F, H, t);
  return cudaGetLastError();
}

cudaError_t launch_gru_cell(const float* pre, long long ld_pre, const float* hw, const float* b_i,
                            const float* b_hn, const float* h_in, float* h_out, float* seq,
                            long long ld_seq, float* carry, const int32_t* nf, int B, int F, int H,
                            int t, cudaStream_t st) {
  if (B < 1 || F < 1 || H < 1 || t < 0 || t >= F || ld_pre < 3LL * H || (seq && ld_seq < H) ||
      (carry && !nf))
    return cudaErrorInvalidValue;
  gru_cell_kernel<<<ew_blocks((long long)B * H), kEwThreads, 0, st>>>(
      pre, ld_pre, hw, b_i, b_hn, h_in, h_out, seq, ld_seq, carry, nf, B, F, H, t);
  return cudaGetLastError();
}

// The ring of !kResident stages (h and W_h chunks), and the resident slice
// of W_h with the ring of h chunks, in bytes
size_t gru_streamed_smem() { return 4 * (size_t)kGruStages * (kGruStageH + kGruCols * kGruWPitch); }
size_t gru_resident_smem(int Kh) {
  return 4 * ((size_t)kGruCols * (Kh + 4) + (size_t)kGruStages * kGruStageH);
}

cudaError_t launch_gru_layer(const float* pre, long long ld_pre_b, long long ld_pre_t,
                             const float* w_h, const float* b_i, const float* b_hn, float* hbuf,
                             float* seq, long long ld_seq_b, long long ld_seq_t, float* carry,
                             const int32_t* nf, int B, int F, int H, cudaStream_t st) {
  if (B < 1 || F < 1 || H < 1 || ld_pre_t < 3LL * H || ld_pre_b < (long long)F * ld_pre_t ||
      ld_seq_t < H || ld_seq_b < (long long)F * ld_seq_t || !hbuf || !seq || (carry && !nf) ||
      reinterpret_cast<uintptr_t>(hbuf) % 16 != 0 || (long long)B * ((H + 3) / 4 * 4) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  static std::once_flag once;
  static cudaError_t configured = cudaSuccess;
  std::call_once(once, [] {
    for (const void* fn : {(const void*)gru_layer_kernel<true>, (const void*)gru_layer_kernel<false>}) {
      if (configured == cudaSuccess)
        configured = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    }
  });
  if (configured != cudaSuccess) return configured;
  int Hp = (H + 3) / 4 * 4;
  int Kh = ((H + 1) / 2 + kGruChunk - 1) / kGruChunk * kGruChunk;  // a block's half of k, padded
  const long long tiles =
      (long long)((B + kGruRows - 1) / kGruRows) * ((H + kGruUnits - 1) / kGruUnits);
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 2;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kGruThreads);
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  // the clusters that can be resident at once, one block an SM (asked
  // with the cluster's attribute alone)
  auto resident_clusters = [&](const void* fn, size_t smem, int* n) {
    cfg.gridDim = dim3(2 * (unsigned)tiles);
    cfg.dynamicSmemBytes = smem;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(n, fn, &cfg);
    cfg.numAttrs = 2;
    return err;
  };
  int fit = 0;
  bool resident = false;
  size_t smem = gru_resident_smem(Kh);
  cudaError_t e = cudaSuccess;
  if (smem <= (size_t)kMaxSmem) {
    e = resident_clusters((const void*)gru_layer_kernel<true>, smem, &fit);
    if (e != cudaSuccess) return e;
    resident = fit >= 1 && tiles <= fit;
  }
  if (!resident) {
    smem = gru_streamed_smem();
    e = resident_clusters((const void*)gru_layer_kernel<false>, smem, &fit);
    if (e != cudaSuccess) return e;
    if (fit < 1) return cudaErrorInvalidConfiguration;
  }
  cfg.gridDim = dim3(2 * (unsigned)(tiles < fit ? tiles : fit));
  cfg.dynamicSmemBytes = smem;
  return resident ? cudaLaunchKernelEx(&cfg, gru_layer_kernel<true>, pre, ld_pre_b, ld_pre_t, w_h, b_i, b_hn, hbuf,
                                       seq, ld_seq_b, ld_seq_t, carry, nf, B, F, H, Hp, Kh)
                  : cudaLaunchKernelEx(&cfg, gru_layer_kernel<false>, pre, ld_pre_b, ld_pre_t, w_h, b_i, b_hn, hbuf,
                                       seq, ld_seq_b, ld_seq_t, carry, nf, B, F, H, Hp, Kh);
}

cudaError_t launch_pool_attention(const float* q, const float* kv, const float* bkv,
                                  const int32_t* nf, float* out, int B, int F, int Q, int H, int hd,
                                  cudaStream_t st) {
  if (B < 1 || F < 1 || Q < 1 || H < 1 || hd < 1 || hd > kPoolMaxHd ||
      (long long)B * H > 0x7fffffffLL || (Q + kPoolRows - 1) / kPoolRows > 65535)
    return cudaErrorInvalidValue;
  static std::once_flag once;
  static cudaError_t configured = cudaSuccess;
  std::call_once(once, [] {
    configured = cudaFuncSetAttribute((const void*)pool_attention_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, kPoolSmem);
    if (configured == cudaSuccess)
      configured = cudaFuncSetAttribute((const void*)pool_attention_kernel,
                                        cudaFuncAttributePreferredSharedMemoryCarveout,
                                        (int)cudaSharedmemCarveoutMaxShared);
  });
  if (configured != cudaSuccess) return configured;
  // 16-byte copies where every row of a head starts on 16 bytes
  const int vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(kv) % 16 == 0;
  dim3 grid(B * H, (Q + kPoolRows - 1) / kPoolRows);
  pool_attention_kernel<<<grid, kPoolThreads, kPoolSmem, st>>>(q, kv, bkv, nf, out, F, Q, H, hd, vec);
  return cudaGetLastError();
}

template <int kM>
void moe_combine_launch(dim3 grid, bool vec, const float* ga, const float* ea, const float* eb,
                        float* probs, int B, int V, cudaStream_t st) {
  if (vec)
    moe_combine_kernel<kM, true><<<grid, kMoeThreads, 0, st>>>(ga, ea, eb, probs, B, V);
  else
    moe_combine_kernel<kM, false><<<grid, kMoeThreads, 0, st>>>(ga, ea, eb, probs, B, V);
}

cudaError_t launch_moe_combine(const float* ga, const float* ea, const float* eb, float* probs,
                               int B, int M, int V, cudaStream_t st) {
  if (B < 1 || M < 1 || V < 1) return cudaErrorInvalidValue;
  const int pairs = (V + 1) / 2;
  const dim3 grid((pairs + kMoeThreads - 1) / kMoeThreads, B < 65535 ? B : 65535);
  // 8-byte loads where every row of ga, ea and eb starts on 8 bytes
  const bool vec = V % 2 == 0 && (reinterpret_cast<uintptr_t>(ga) | reinterpret_cast<uintptr_t>(ea) |
                                  reinterpret_cast<uintptr_t>(eb) | reinterpret_cast<uintptr_t>(probs)) %
                                         8 == 0;
  switch (M) {
    case 1: moe_combine_launch<1>(grid, vec, ga, ea, eb, probs, B, V, st); break;
    case 2: moe_combine_launch<2>(grid, vec, ga, ea, eb, probs, B, V, st); break;
    case 3: moe_combine_launch<3>(grid, vec, ga, ea, eb, probs, B, V, st); break;
    case 4: moe_combine_launch<4>(grid, vec, ga, ea, eb, probs, B, V, st); break;
    default:
      moe_combine_any_kernel<<<grid, kMoeThreads, 0, st>>>(ga, ea, eb, probs, B, M, V);
  }
  return cudaGetLastError();
}

// the block select where k and the row fit it, else the rounds
cudaError_t launch_topk(const float* probs, float* values, int32_t* indices, int B, int V, int k,
                        cudaStream_t st) {
  if (B < 1 || V < 1 || k < 1 || k > V) return cudaErrorInvalidValue;
  if (k <= kTopkFastK && V <= kTopkThreads * kTopkPerSmall)
    topk_select_kernel<kTopkPerSmall><<<B, kTopkThreads, 0, st>>>(probs, values, indices, V, k);
  else if (k <= kTopkFastK && V <= kTopkThreads * kTopkPerLarge)
    topk_select_kernel<kTopkPerLarge><<<B, kTopkThreads, 0, st>>>(probs, values, indices, V, k);
  else
    topk_rounds_kernel<<<B, kTopkThreads, 0, st>>>(probs, values, indices, V, k);
  return cudaGetLastError();
}

// one launch of frame_stage_kernel<kMode, kW>: a row a warp for every frame
// (block after block); the sampled mode's rows in one wave of the blocks
// the card holds at once (found at the first launch), so that a warp draws
// for several rows at once and has its next row's loads in flight under
// the current row's math (on one H100 each grid was the faster for its
// mode: 0.092 against 0.100 ms for every frame in bf16, 0.0102 against
// 0.0121 for the sampled frames)
template <int kMode, int kW>
cudaError_t stage_launch(const StageArgs& a, cudaStream_t st) {
  long long blocks = ((long long)a.rows + kStageWarps - 1) / kStageWarps;
  if (kMode == kStageSampled) {
    static std::atomic<int> resident{0};
    int fit = resident.load();
    if (fit < 1) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, frame_stage_kernel<kMode, kW>,
                                                          kStageThreads, 0);
      if (e != cudaSuccess) return e;
      fit = sms * per_sm > 1 ? sms * per_sm : 1;
      resident.store(fit);
    }
    if (blocks > fit) blocks = fit;
  }
  frame_stage_kernel<kMode, kW><<<(unsigned)blocks, kStageThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// the word path where the row is kStageDT bytes and every pointer is
// aligned to its loads and stores, else the byte path
template <int kMode>
cudaError_t stage_dispatch(const StageArgs& a, cudaStream_t st) {
  const bool f32 = kMode == kStageAllF32;
  const bool words = a.DT == kStageDT && aligned_to(a.x, 4) &&
                     (f32 ? aligned_to(a.out_f32, 16) : aligned_to(a.out_bf16, 8)) &&
                     (!a.in_scale || (aligned_to(a.in_scale, 16) && aligned_to(a.in_bias, 16)));
  return words ? stage_launch<kMode, kStageWords>(a, st) : stage_launch<kMode, 0>(a, st);
}

cudaError_t launch_frame_stage(const uint8_t* x, uint32_t k0, uint32_t k1, const int32_t* nf,
                               const float* in_scale, const float* in_bias, bf16* out, int B,
                               int F, int DT, int S, int window, float deq_scale,
                               float deq_bias, cudaStream_t st) {
  // the rows and the source rows index in int
  if (B < 1 || F < 1 || DT < 1 || S < 1 || (in_scale == nullptr) != (in_bias == nullptr) ||
      (long long)B * (F > S ? F : S) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const StageArgs a = {x, nf, in_scale, in_bias, out, nullptr, nullptr, B * S, F, DT, S, window,
                       k0, k1, deq_scale, deq_bias};
  return stage_dispatch<kStageSampled>(a, st);
}

cudaError_t launch_frame_stage_all(const uint8_t* x, const int32_t* nf, bf16* out_bf16,
                                   float* out_f32, float* mask, int B, int F, int DT,
                                   float deq_scale, float deq_bias, cudaStream_t st) {
  if (B < 1 || F < 1 || DT < 1 || (!out_bf16) == (!out_f32) || (long long)B * F > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const StageArgs a = {x, nf, nullptr, nullptr, out_bf16, out_f32, mask, B * F, F, DT, F, 0,
                       0, 0, deq_scale, deq_bias};
  return out_f32 ? stage_dispatch<kStageAllF32>(a, st) : stage_dispatch<kStageAllBf16>(a, st);
}

cudaError_t launch_bias_act(int act, const float* y, const float* bias, float* out_f32,
                            bf16* out_bf16, long long rows, int N, cudaStream_t st) {
  if (rows < 1 || N < 1 || (!out_f32 && !out_bf16) || act < kActSigmoid || act > kActNone)
    return cudaErrorInvalidValue;
  const long long n = rows * N;
  const unsigned blocks = ew_blocks(n);
  switch (act) {
    case kActSigmoid:
      bias_act_kernel<kActSigmoid><<<blocks, kEwThreads, 0, st>>>(y, bias, out_f32, out_bf16, n, N);
      break;
    case kActRelu6:
      bias_act_kernel<kActRelu6><<<blocks, kEwThreads, 0, st>>>(y, bias, out_f32, out_bf16, n, N);
      break;
    case kActRelu:
      bias_act_kernel<kActRelu><<<blocks, kEwThreads, 0, st>>>(y, bias, out_f32, out_bf16, n, N);
      break;
    default:
      bias_act_kernel<kActNone><<<blocks, kEwThreads, 0, st>>>(y, bias, out_f32, out_bf16, n, N);
  }
  return cudaGetLastError();
}

cudaError_t launch_residual_layernorm(const bf16* a, const bf16* b, const float* scale,
                                      const float* bias, const float* mask, bf16* out,
                                      long long rows, int D, cudaStream_t st) {
  if (rows < 1 || D < 1) return cudaErrorInvalidValue;
  const float inv_d = (float)rows / (float)(rows * D);  // as PyTorch's mean scales its sum
  residual_layernorm_kernel<<<row_blocks(rows), kRowThreads, 0, st>>>(a, b, scale, bias, mask, out,
                                                                       rows, D, inv_d);
  return cudaGetLastError();
}

cudaError_t launch_masked_mean(const void* x, bool x_bf16, const int32_t* nf, float* out_f32,
                               bf16* out_bf16, int B, int F, int C, int count_valid,
                               cudaStream_t st) {
  if (B < 1 || F < 1 || C < 1 || (!out_f32) == (!out_bf16)) return cudaErrorInvalidValue;
  const unsigned blocks = ew_blocks((long long)B * C);
  if (x_bf16)
    masked_mean_kernel<bf16><<<blocks, kEwThreads, 0, st>>>(static_cast<const bf16*>(x), nf, out_f32,
                                                            out_bf16, B, F, C, count_valid);
  else
    masked_mean_kernel<float><<<blocks, kEwThreads, 0, st>>>(static_cast<const float*>(x), nf,
                                                             out_f32, out_bf16, B, F, C,
                                                             count_valid);
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
  const dim3 grid((K + kResidualTile - 1) / kResidualTile, B < 65535 ? B : 65535);
  const int vec = Dp % 4 == 0 && aligned_to(agg, 16) && aligned_to(c2, 16) && aligned_to(out, 16);
  nextvlad_residual_kernel<<<grid, kResidualThreads, 0, st>>>(agg, assign, c2, out, B, SG, K, Dp,
                                                              vec);
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

// One encoder layer's arrays (layers/<i>/…: ops/fast_transformer.py's prepare).
struct Layer {
  const bf16 *wqkv = nullptr, *wo = nullptr, *w1 = nullptr, *w2 = nullptr;
  const float *bqkv = nullptr, *bo = nullptr, *ln1_s = nullptr, *ln1_b = nullptr,
              *ln2_s = nullptr, *ln2_b = nullptr, *b1 = nullptr, *b2 = nullptr;
};

struct Runner {
  Manifest m;
  Route route = kNetvlad;
  int device = 0;
  int B = 0, F = 0, DT = 0, S = 0, H = 0, V = 0, M = 0, k = 0, C = 0, n_mods = 0, n_parts = 0;
  int D = 0, FF = 0, heads = 0, hd = 0, K = 0;  // the encoder's width, FFN width, heads; NetVLAD's K
  int Q = 0, L = 0;  // AttentionPoolingModel's queries; an RNN's layers (H: its cells)
  Mod mods[kMaxMods];
  std::vector<Layer> layers;
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
  // the routes that read every frame: the key mask [B, F]; the encoder's
  // f32 products (its widest: [B·F, max(3D, FF)]), its state hx, the fused
  // qkv, the attention's output att, a product's bf16 epilogue proj, the
  // FFN's hidden ffb (bf16 [B·F, ·]); the transformer's pool (pooled),
  // AttentionNetVLAD's vlad [B, D·K]; FrameLevelLogisticModel's f32 frames
  // (xn) and pool
  float *mask = nullptr, *prod = nullptr, *pooled_f32 = nullptr;
  bf16 *hx = nullptr, *qkv = nullptr, *att = nullptr, *proj = nullptr, *ffb = nullptr,
       *vlad = nullptr;
  // the f32 routes of the models with no fast route (xn: the frames):
  // AttentionPoolingModel's input projection xp [B·F, D], key/value product
  // kvp [B·F, 2D], queries' projection qproj [Q, D] (made at load),
  // attention patt [B, Q, D], output projection (pooled_f32, [B, Q·D]),
  // hidden layer h and gating product gates [B, H], gating's output gated;
  // an RNN layer's product x·W_i pre [B·F, G·H] and outputs seq [B·F, H]
  // (each layer's product reads the layer below's outputs before its cells
  // overwrite them, in stream order), state hs and cs [B, H], the step's
  // product hw [B, G·H], the final carry [B, H]
  float *xp = nullptr, *kvp = nullptr, *qproj = nullptr, *patt = nullptr, *gated = nullptr,
        *hs = nullptr, *cs = nullptr, *hw = nullptr, *carry = nullptr, *pre = nullptr,
        *seq = nullptr;
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

// the MoE head's arrays on `width` inputs (kernels of `tag`); sizes r->V
void check_moe(ShapeCheck& c, Runner* r, int64_t width, const char* tag) {
  const int64_t M = r->M;
  if (c.ok && (M < 1 || c.dim("experts_bias", "f32", {-1}, 0) % M != 0))
    c.fail("moe_num_mixtures must be positive and divide experts_bias's length");
  r->V = c.ok ? (int)(c.dim("experts_bias", "f32", {-1}, 0) / M) : 0;
  c.get("gates_kernel", tag, {width, (M + 1) * r->V});
  c.get("experts_kernel", tag, {width, M * r->V});
}

// the gated MoE tail's arrays (every LOUPE route's and Willow's, bf16; the
// pooling route's, f32)
void check_tail(ShapeCheck& c, Runner* r, const char* tag = "bf16") {
  const int64_t H = r->H;
  c.get("hidden_b", "f32", {H});
  c.get("gate_w", tag, {H, H});
  c.get("g_scale", "f32", {H});
  c.get("g_bias", "f32", {H});
  check_moe(c, r, H, tag);
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
  if (all_frames_route(r->route)) r->S = r->F;
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
    case kMoe:
      check_moe(c, r, DT, "f32");
      break;
    case kDbof: {
      r->C = (int)c.dim("cluster_w", "bf16", {DT, -1}, 1);
      r->H = (int)c.dim("hidden_w", "bf16", {r->C, -1}, 1);
      c.get("cluster_b", "f32", {r->C});
      c.get("hidden_b", "f32", {r->H});
      check_moe(c, r, r->H, "bf16");
      break;
    }
    case kAttnPool: {
      r->D = (int)c.dim("w_proj", "f32", {DT, -1}, 1);
      const int64_t D = r->D;
      r->heads = m.attention_heads;
      r->Q = m.attention_cluster_size;
      if (c.ok && D % r->heads != 0)
        return c.fail("attention_heads must divide the width " + std::to_string(D));
      r->hd = c.ok ? (int)(D / r->heads) : 0;
      if (c.ok && r->hd > kPoolMaxHd)
        return c.fail("pool_attention takes a head width of at most 128, not " +
                      std::to_string(r->hd));
      const int64_t Q = r->Q;
      c.get("b_proj", "f32", {D});
      c.get("queries", "f32", {Q, D});
      c.get("wq", "f32", {D, D});
      c.get("bq", "f32", {D});
      c.get("wkv", "f32", {D, 2 * D});
      c.get("bkv", "f32", {2 * D});
      c.get("wo", "f32", {D, D});
      c.get("bo", "f32", {D});
      r->H = (int)c.dim("hidden_w", "f32", {Q * D, -1}, 1);
      check_tail(c, r, "f32");
      break;
    }
    case kLstm:
    case kGru: {
      const int64_t G = r->route == kLstm ? 4 : 3;
      r->L = m.rnn_layers;
      r->H = m.rnn_cells;
      const int64_t H = r->H;
      for (int i = 0; i < r->L && c.ok; ++i) {
        const std::string p = "layers/" + std::to_string(i) + "/";
        c.get(p + "w_i", "f32", {i ? H : DT, G * H});
        c.get(p + "w_h", "f32", {H, G * H});
        if (r->route == kLstm) {
          c.get(p + "b_h", "f32", {G * H});
        } else {
          c.get(p + "b_i", "f32", {G * H});
          c.get(p + "b_hn", "f32", {H});
        }
      }
      if (c.ok && m.weight("layers/" + std::to_string(r->L) + "/w_i"))
        return c.fail("weights.bin holds more layers than rnn_layers (" + std::to_string(r->L) + ")");
      check_moe(c, r, H, "f32");
      break;
    }
    case kTransformer:
    case kAttnNetvlad: {
      r->D = (int)c.dim("w_proj", "bf16", {DT, -1}, 1);
      const int64_t D = r->D;
      c.get("b_proj", "f32", {D});
      const int L = m.transformer_layers;
      r->heads = m.attention_heads;
      if (c.ok && (L < 1 || r->heads < 1 || D % r->heads != 0))
        return c.fail("transformer_layers and attention_heads must be positive, and the heads "
                      "must divide the width " + std::to_string(D));
      r->hd = c.ok ? (int)(D / r->heads) : 0;
      if (c.ok && (r->hd < 8 || r->hd > kMaxHeadDim || r->hd % 8 != 0))
        return c.fail("head width " + std::to_string(r->hd) +
                      " must be a multiple of 8 in [8, 128] (row 7)");
      r->FF = (int)c.dim("layers/0/w1", "bf16", {D, -1}, 1);
      const int64_t FF = r->FF;
      for (int i = 0; i < L && c.ok; ++i) {
        const std::string p = "layers/" + std::to_string(i) + "/";
        c.get(p + "wqkv", "bf16", {D, 3 * D});
        c.get(p + "bqkv", "f32", {3 * D});
        c.get(p + "wo", "bf16", {D, D});
        c.get(p + "bo", "f32", {D});
        for (const char* ln : {"ln1_s", "ln1_b", "ln2_s", "ln2_b"}) c.get(p + ln, "f32", {D});
        c.get(p + "w1", "bf16", {D, FF});
        c.get(p + "b1", "f32", {FF});
        c.get(p + "w2", "bf16", {FF, D});
        c.get(p + "b2", "f32", {D});
      }
      if (c.ok && m.weight("layers/" + std::to_string(L) + "/wqkv"))
        return c.fail("weights.bin holds more encoder layers than transformer_layers (" +
                      std::to_string(L) + ")");
      int64_t in = D;
      if (r->route == kAttnNetvlad) {
        r->K = (int)c.dim("cluster", "bf16", {D, -1}, 1);
        const int64_t K = r->K;
        c.get("c_scale", "f32", {K});
        c.get("c_bias", "f32", {K});
        c.get("c2", "f32", {D, K});
        if (c.ok && K > kMaxClusters) return c.fail("cluster has more than 512 clusters");
        in = D * K;
      }
      r->H = (int)c.dim("hidden_w", "bf16", {in, -1}, 1);
      check_tail(c, r);
      r->n_parts = 1;
      break;
    }
    case kFrameLogistic:
      r->V = (int)c.dim("fc/bias", "f32", {-1}, 0);
      c.get("fc/kernel", "f32", {DT, r->V});
      break;
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
  if (r->route == kDbof || gated_route(r->route) || flax_moe_route(r->route)) {
    r->need_ws(&r->ga, B * (M + 1) * V);
    r->need_ws(&r->ea, B * M * V);
  }
  if (gated_route(r->route)) {
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
    case kTransformer:
    case kAttnNetvlad: {
      const long long R = B * S, D = r->D, FF = r->FF;  // S = F
      r->need_ws(&r->xs, R * DT);
      r->need_ws(&r->mask, R);
      r->need_ws(&r->prod, R * (3 * D > FF ? 3 * D : FF));
      r->need_ws(&r->hx, R * D);
      r->need_ws(&r->qkv, R * 3 * D);
      r->need_ws(&r->att, R * D);
      r->need_ws(&r->proj, R * D);
      r->need_ws(&r->ffb, R * FF);
      r->need_ws(&r->contrib[0], B * H);
      if (r->route == kTransformer) {
        r->need_ws(&r->pooled, B * D);
      } else {
        r->need_ws(&r->vlad, B * D * r->K);
        r->need_ws(&r->ws_a_rgb, R * r->K);
        r->need_ws(&r->ws_cs_rgb, B * dchunks(D) * r->K);
      }
      break;
    }
    case kFrameLogistic:
      r->need_ws(&r->xn, B * S * DT);
      r->need_ws(&r->pooled_f32, B * DT);
      break;
    case kAttnPool: {
      const long long R = B * S, D = r->D, Q = r->Q;  // S = F
      r->need_ws(&r->xn, R * DT);
      r->need_ws(&r->xp, R * D);
      r->need_ws(&r->kvp, R * 2 * D);
      r->need_ws(&r->qproj, Q * D);
      r->need_ws(&r->patt, B * Q * D);
      r->need_ws(&r->pooled_f32, B * Q * D);
      r->need_ws(&r->h, B * H);
      r->need_ws(&r->gates, B * H);
      r->need_ws(&r->gated, B * H);
      break;
    }
    case kLstm:
    case kGru: {
      const long long R = B * S, GH = (r->route == kLstm ? 4 : 3) * H;
      r->need_ws(&r->xn, R * DT);
      r->need_ws(&r->pre, R * GH);
      r->need_ws(&r->seq, R * H);
      if (r->route == kLstm) {
        r->need_ws(&r->hs, B * H);
        r->need_ws(&r->cs, B * H);
        r->need_ws(&r->hw, B * GH);
      } else {
        r->need_ws(&r->hs, 2 * B * ((H + 3) / 4 * 4));  // gru_layer's ping-pong state
      }
      r->need_ws(&r->carry, B * H);
      break;
    }
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

// the device pointers of an attention route's encoder layers
void bind_layers(Runner* r) {
  if (!attention_route(r->route)) return;
  r->layers.resize(r->m.transformer_layers);
  for (int i = 0; i < r->m.transformer_layers; ++i) {
    Layer& l = r->layers[i];
    const std::string p = "layers/" + std::to_string(i) + "/";
    l.wqkv = r->W<bf16>(p + "wqkv");
    l.bqkv = r->W<float>(p + "bqkv");
    l.wo = r->W<bf16>(p + "wo");
    l.bo = r->W<float>(p + "bo");
    l.ln1_s = r->W<float>(p + "ln1_s");
    l.ln1_b = r->W<float>(p + "ln1_b");
    l.ln2_s = r->W<float>(p + "ln2_s");
    l.ln2_b = r->W<float>(p + "ln2_b");
    l.w1 = r->W<bf16>(p + "w1");
    l.b1 = r->W<float>(p + "b1");
    l.w2 = r->W<bf16>(p + "w2");
    l.b2 = r->W<float>(p + "b2");
  }
}

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

bool pool_queries(Runner* r, std::string* err);

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
  bind_layers(r);

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
  return r->route != kAttnPool || pool_queries(r, err);
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

// The MoE head in f32 on x [B, K] (f32 kernels, TF32 off) → probs.
bool moe_f32(Runner* r, const float* x, long long K, std::string* err) {
  const long long B = r->B, M = r->M, V = r->V;
  if (!blas_ok(gemm_f32(r->blas, x, r->W<float>("gates_kernel"), r->ga, B, (M + 1) * V, K),
               "MoE gate product", err) ||
      !blas_ok(gemm_f32(r->blas, x, r->W<float>("experts_kernel"), r->ea, B, M * V, K),
               "MoE expert product", err))
    return false;
  if (!cuda_ok(launch_moe_combine(r->ga, r->ea, r->W<float>("experts_bias"), r->probs, r->B, r->M,
                                  r->V, r->stream),
               "moe_combine", err))
    return false;
  r->count(kMoeCombine);
  return true;
}

// y [rows, N] f32 + the array `bias` [N], in place (bias_act, no activation).
bool bias_add(Runner* r, float* y, const char* bias, long long rows, long long N, const char* what,
              std::string* err) {
  if (!cuda_ok(launch_bias_act(kActNone, y, r->W<float>(bias), y, nullptr, rows, (int)N, r->stream),
               what, err))
    return false;
  r->count(kBiasAct);
  return true;
}

// AttentionPoolingModel's query projection with its bias [Q, D]: it reads
// no input, so it is made once, at load.
bool pool_queries(Runner* r, std::string* err) {
  return blas_ok(gemm_f32(r->blas, r->W<float>("queries"), r->W<float>("wq"), r->qproj, r->Q, r->D,
                          r->D),
                 "query projection", err) &&
         bias_add(r, r->qproj, "bq", r->Q, r->D, "query projection", err) &&
         cuda_ok(cudaStreamSynchronize(r->stream), "query projection", err);
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
                             nullptr, B, r->H, r->stream),
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
  const long long B = r->B, DT = r->DT, V = r->V;
  const float* x = static_cast<const float*>(r->x);
  if (!cuda_ok(launch_row_l2(x, nullptr, nullptr, 0, r->xn, nullptr, B, r->DT, r->stream), "row_l2",
               err))
    return false;
  r->count(kRowL2);
  if (r->route == kLogistic) {
    if (!blas_ok(gemm_f32(r->blas, r->xn, r->W<float>("fc/kernel"), r->probs, B, V, DT),
                 "logistic product", err))
      return false;
    if (!cuda_ok(launch_bias_act(kActSigmoid, r->probs, r->W<float>("fc/bias"), r->probs, nullptr, B,
                                 r->V, r->stream),
                 "bias_sigmoid", err))
      return false;
    r->count(kBiasSigmoid);
    return true;
  }
  return moe_f32(r, r->xn, DT, err);
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
  if (!cuda_ok(launch_bias_act(kActRelu6, r->act, r->W<float>("cluster_b"), r->act, nullptr, B * S,
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
  if (!cuda_ok(launch_bias_act(kActRelu6, r->hh, r->W<float>("hidden_b"), nullptr, r->hg, B, r->H,
                               r->stream),
               "bias_relu6 (hidden)", err))
    return false;
  r->count(kBiasRelu6);
  return moe(r, r->hg, err);
}

// Every frame staged (bf16 out, or f32 out) and, with mask, the key mask.
bool frames_all(Runner* r, bf16* out_bf16, float* out_f32, float* mask, std::string* err) {
  if (!cuda_ok(launch_frame_stage_all(static_cast<const uint8_t*>(r->x), r->nf, out_bf16, out_f32,
                                      mask, r->B, r->F, r->DT, kDeqScale, kDeqBias, r->stream),
               "frame_stage", err))
    return false;
  r->count(kFrameStage);
  return true;
}

// A bf16 × bf16 product [rows, N] summed in f32 into r->prod, then
// bias_act's epilogue (+ bias, ReLU or none, one bf16 rounding) into out.
bool product_epilogue(Runner* r, const bf16* a, const bf16* w, const float* bias, int act,
                      bf16* out, long long rows, long long N, long long K, const char* what,
                      std::string* err) {
  if (!blas_ok(gemm_bf16(r->blas, a, w, r->prod, rows, N, K), what, err)) return false;
  if (!cuda_ok(launch_bias_act(act, r->prod, bias, nullptr, out, rows, (int)N, r->stream), what,
               err))
    return false;
  r->count(kBiasAct);
  return true;
}

bool residual_layernorm(Runner* r, const float* scale, const float* bias, const float* mask,
                        std::string* err) {
  if (!cuda_ok(launch_residual_layernorm(r->hx, r->proj, scale, bias, mask, r->hx,
                                         (long long)r->B * r->F, r->D, r->stream),
               "residual_layernorm", err))
    return false;
  r->count(kResidualLayernorm);
  return true;
}

// The attention routes' encoder (ops/fast_transformer.py#_encode): every
// frame staged and the key mask, the input projection, then each layer; the
// state ends in r->hx [B·F, D] bf16 (AttentionNetVLAD: pad rows times 0).
bool encoder(Runner* r, std::string* err) {
  const long long R = (long long)r->B * r->F, D = r->D, FF = r->FF;
  if (!frames_all(r, r->xs, nullptr, r->mask, err)) return false;
  if (!product_epilogue(r, r->xs, r->W<bf16>("w_proj"), r->W<float>("b_proj"), kActNone, r->hx, R,
                        D, r->DT, "input projection", err))
    return false;
  for (size_t i = 0; i < r->layers.size(); ++i) {
    const Layer& l = r->layers[i];
    const bool last = i + 1 == r->layers.size();
    if (!product_epilogue(r, r->hx, l.wqkv, l.bqkv, kActNone, r->qkv, R, 3 * D, D, "QKV product",
                          err))
      return false;
    if (!cuda_ok((cudaError_t)lpm_masked_attention(r->qkv, r->mask, r->att, 1, r->B, r->F,
                                                   r->heads, r->hd, r->stream),
                 "masked_attention", err))
      return false;
    r->count(kMaskedAttention);
    if (!product_epilogue(r, r->att, l.wo, l.bo, kActNone, r->proj, R, D, D, "out-projection",
                          err) ||
        !residual_layernorm(r, l.ln1_s, l.ln1_b, nullptr, err) ||
        !product_epilogue(r, r->hx, l.w1, l.b1, kActRelu, r->ffb, R, FF, D, "FFN1", err) ||
        !product_epilogue(r, r->ffb, l.w2, l.b2, kActNone, r->proj, R, D, FF, "FFN2", err) ||
        !residual_layernorm(r, l.ln2_s, l.ln2_b,
                            last && r->route == kAttnNetvlad ? r->mask : nullptr, err))
      return false;
  }
  return true;
}

bool run_attention(Runner* r, std::string* err) {
  const long long B = r->B, H = r->H, D = r->D;
  if (!encoder(r, err)) return false;
  if (r->route == kTransformer) {
    if (!cuda_ok(launch_masked_mean(r->hx, true, r->nf, nullptr, r->pooled, r->B, r->F, r->D, 1,
                                    r->stream),
                 "masked_mean", err))
      return false;
    r->count(kMaskedMean);
    if (!blas_ok(gemm_bf16(r->blas, r->pooled, r->W<bf16>("hidden_w"), r->contrib[0], B, H, D),
                 "hidden FC", err))
      return false;
  } else {
    const int rc = lpm_netvlad_fused(r->hx, D, 1, r->W<bf16>("cluster"), r->W<float>("c_scale"),
                                     r->W<float>("c_bias"), r->W<float>("c2"), r->vlad, r->ws_a_rgb,
                                     r->ws_cs_rgb, r->B, r->F, r->D, r->K, 0, r->stream);
    if (!cuda_ok((cudaError_t)rc, "netvlad_fused", err)) return false;
    r->count(kNetvladFused);
    if (!blas_ok(gemm_bf16(r->blas, r->vlad, r->W<bf16>("hidden_w"), r->contrib[0], B, H,
                           D * r->K),
                 "hidden FC", err))
      return false;
  }
  return gated_tail(r, false, err);
}

bool run_frame_logistic(Runner* r, std::string* err) {
  const long long B = r->B, DT = r->DT, V = r->V;
  if (!frames_all(r, nullptr, r->xn, nullptr, err)) return false;
  if (!cuda_ok(launch_masked_mean(r->xn, false, r->nf, r->pooled_f32, nullptr, r->B, r->F, r->DT,
                                  0, r->stream),
               "masked_mean", err))
    return false;
  r->count(kMaskedMean);
  if (!blas_ok(gemm_f32(r->blas, r->pooled_f32, r->W<float>("fc/kernel"), r->probs, B, V, DT),
               "logistic product", err))
    return false;
  if (!cuda_ok(launch_bias_act(kActSigmoid, r->probs, r->W<float>("fc/bias"), r->probs, nullptr, B,
                               r->V, r->stream),
               "bias_sigmoid", err))
    return false;
  r->count(kBiasSigmoid);
  return true;
}

// AttentionPoolingModel (f32): every frame staged in f32, the input
// projection, the key/value product, pool_attention against the queries'
// projection, the output projection, the hidden FC (each + its bias), the
// gating product and gating, the MoE.
bool run_pool(Runner* r, std::string* err) {
  const long long B = r->B, R = B * r->F, DT = r->DT, D = r->D, Q = r->Q, H = r->H;
  if (!frames_all(r, nullptr, r->xn, nullptr, err)) return false;
  if (!blas_ok(gemm_f32(r->blas, r->xn, r->W<float>("w_proj"), r->xp, R, D, DT), "input projection",
               err) ||
      !bias_add(r, r->xp, "b_proj", R, D, "input projection", err) ||
      !blas_ok(gemm_f32(r->blas, r->xp, r->W<float>("wkv"), r->kvp, R, 2 * D, D),
               "key/value product", err))
    return false;
  if (!cuda_ok(launch_pool_attention(r->qproj, r->kvp, r->W<float>("bkv"), r->nf, r->patt, r->B,
                                     r->F, r->Q, r->heads, r->hd, r->stream),
               "pool_attention", err))
    return false;
  r->count(kPoolAttention);
  if (!blas_ok(gemm_f32(r->blas, r->patt, r->W<float>("wo"), r->pooled_f32, B * Q, D, D),
               "output projection", err) ||
      !bias_add(r, r->pooled_f32, "bo", B * Q, D, "output projection", err) ||
      !blas_ok(gemm_f32(r->blas, r->pooled_f32, r->W<float>("hidden_w"), r->h, B, H, Q * D),
               "hidden FC", err) ||
      !bias_add(r, r->h, "hidden_b", B, H, "hidden FC", err) ||
      !blas_ok(gemm_f32(r->blas, r->h, r->W<float>("gate_w"), r->gates, B, H, H), "gating product",
               err))
    return false;
  if (!cuda_ok(launch_gating(r->gates, r->h, r->W<float>("g_scale"), r->W<float>("g_bias"), nullptr,
                             r->gated, B, r->H, r->stream),
               "gating", err))
    return false;
  r->count(kGating);
  return moe_f32(r, r->gated, H, err);
}

// LstmModel and GruModel (f32): every frame staged in f32; a layer: x·W_i
// over every frame (the frames, or the layer below's outputs seq) into pre,
// then the recurrence, which writes each step's h′ to the layer's outputs
// seq (the next layer's input) and the final carry at each row's last
// frame: for the LSTM, from a zeroed state, per frame t the product h·W_h
// and lstm_cell; for the GRU, one gru_layer launch over all frames.  The
// MoE on the top layer's carry.
bool run_rnn(Runner* r, std::string* err) {
  const bool lstm = r->route == kLstm;
  const long long B = r->B, F = r->F, R = B * F, H = r->H, GH = (lstm ? 4 : 3) * H;
  if (!frames_all(r, nullptr, r->xn, nullptr, err)) return false;
  for (int i = 0; i < r->L; ++i) {
    const std::string p = "layers/" + std::to_string(i) + "/";
    float *pre = r->pre, *seq = r->seq;
    if (!blas_ok(gemm_f32(r->blas, i ? seq : r->xn, r->W<float>(p + "w_i"), pre, R, GH, i ? H : r->DT),
                 "input product", err))
      return false;
    const float* w_h = r->W<float>(p + "w_h");
    if (!lstm) {
      if (!cuda_ok(launch_gru_layer(pre, F * GH, GH, w_h, r->W<float>(p + "b_i"), r->W<float>(p + "b_hn"),
                                    r->hs, seq, F * H, H, r->carry, r->nf, r->B, r->F, r->H, r->stream),
                   "gru_layer", err))
        return false;
      r->count(kGruLayer);
      continue;
    }
    if (!cuda_ok(cudaMemsetAsync(r->hs, 0, B * H * sizeof(float), r->stream), "zero state", err) ||
        !cuda_ok(cudaMemsetAsync(r->cs, 0, B * H * sizeof(float), r->stream), "zero state", err))
      return false;
    for (int t = 0; t < F; ++t) {
      if (!blas_ok(gemm_f32(r->blas, r->hs, w_h, r->hw, B, GH, H), "recurrent product", err) ||
          !cuda_ok(launch_lstm_cell(pre + t * GH, F * GH, r->hw, r->W<float>(p + "b_h"), r->cs, r->cs,
                                    r->hs, seq + t * H, F * H, r->carry, r->nf, r->B, r->F, r->H, t,
                                    r->stream),
                   "lstm_cell", err))
        return false;
      r->count(kLstmCell);
    }
  }
  return moe_f32(r, r->carry, H, err);
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
    case kTransformer:
    case kAttnNetvlad: ok = run_attention(r, err); break;
    case kFrameLogistic: ok = run_frame_logistic(r, err); break;
    case kAttnPool: ok = run_pool(r, err); break;
    case kLstm:
    case kGru: ok = run_rnn(r, err); break;
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
// the route has them; a NeXtVLAD modality's steps (mods/<i>/xt bf16
// [B·S, λD], assign f32 [B·S·G, K], residual f32 [B, K, D′], vlad bf16
// [B, K·D′]); an attention route's frames (bf16 [B·F, DT]), mask (f32
// [B, F]), its last layer's ffn1 (FFN1's output, bf16 [B·F, FF]) and ffn2
// (FFN2's, bf16 [B·F, D]), encoder (its output, bf16 [B·F, D]) and pooled
// (bf16 [B, D]) or vlad (bf16 [B, D·K]); FrameLevelLogisticModel's frames
// (f32 [B·F, DT]) and pooled (f32 [B, DT]); AttentionPoolingModel's frames
// (f32 [B·F, DT]), proj (the input projection, f32 [B·F, D]), kv (the
// key/value product, f32 [B·F, 2D]), att (pool_attention's output, f32 [B,
// Q·D]), pooled (the output projection, f32 [B, Q·D]), h and gated (f32
// [B, H]); an RNN's frames, pre/last (the top layer's x·W_i, f32 [B·F,
// G·H]),
// seq/last (the top layer's outputs, f32 [B·F, H]) and final (the carry,
// f32 [B, H]).
std::vector<std::pair<std::string, std::pair<const void*, size_t>>> buffers(const Runner* r) {
  std::vector<std::pair<std::string, std::pair<const void*, size_t>>> out;
  const size_t B = r->B, S = r->S, H = r->H, DT = r->DT, D = r->D;
  if (attention_route(r->route)) {
    out.push_back({"frames", {r->xs, B * S * DT * 2}});
    out.push_back({"mask", {r->mask, B * S * 4}});
    out.push_back({"ffn1", {r->ffb, B * S * r->FF * 2}});
    out.push_back({"ffn2", {r->proj, B * S * D * 2}});
    out.push_back({"encoder", {r->hx, B * S * D * 2}});
    if (r->route == kTransformer)
      out.push_back({"pooled", {r->pooled, B * D * 2}});
    else
      out.push_back({"vlad", {r->vlad, B * D * r->K * 2}});
  } else if (r->route == kFrameLogistic) {
    out.push_back({"frames", {r->xn, B * S * DT * 4}});
    out.push_back({"pooled", {r->pooled_f32, B * DT * 4}});
  } else if (r->route == kAttnPool) {
    const size_t QD = (size_t)r->Q * D;
    out.push_back({"frames", {r->xn, B * S * DT * 4}});
    out.push_back({"proj", {r->xp, B * S * D * 4}});
    out.push_back({"kv", {r->kvp, B * S * 2 * D * 4}});
    out.push_back({"att", {r->patt, B * QD * 4}});
    out.push_back({"pooled", {r->pooled_f32, B * QD * 4}});
    out.push_back({"h", {r->h, B * H * 4}});
    out.push_back({"gated", {r->gated, B * H * 4}});
    return out;
  } else if (rnn_route(r->route)) {
    const size_t GH = (r->route == kLstm ? 4 : 3) * H;
    out.push_back({"frames", {r->xn, B * S * DT * 4}});
    out.push_back({"pre/last", {r->pre, B * S * GH * 4}});
    out.push_back({"seq/last", {r->seq, B * S * H * 4}});
    out.push_back({"final", {r->carry, B * H * 4}});
    return out;
  }
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
               void* out_bf16, void* out_f32, long long rows, int H, void* stream) {
  return (int)lpm_native::launch_gating(
      static_cast<const float*>(gates), static_cast<const float*>(h),
      static_cast<const float*>(g_scale), static_cast<const float*>(g_bias),
      static_cast<bf16*>(out_bf16), static_cast<float*>(out_f32), rows, H,
      static_cast<cudaStream_t>(stream));
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

int lpm_frame_stage_all(const void* x, const void* num_frames, void* out_bf16, void* out_f32,
                        void* mask, int B, int F, int DT, float deq_scale, float deq_bias,
                        void* stream) {
  return (int)lpm_native::launch_frame_stage_all(
      static_cast<const uint8_t*>(x), static_cast<const int32_t*>(num_frames),
      static_cast<bf16*>(out_bf16), static_cast<float*>(out_f32), static_cast<float*>(mask), B, F,
      DT, deq_scale, deq_bias, static_cast<cudaStream_t>(stream));
}

int lpm_bias_act(const void* y, const void* bias, void* out_bf16, void* out_f32, int relu,
                 long long rows, int N, void* stream) {
  return (int)lpm_native::launch_bias_act(
      relu ? lpm_native::kActRelu : lpm_native::kActNone, static_cast<const float*>(y),
      static_cast<const float*>(bias), static_cast<float*>(out_f32), static_cast<bf16*>(out_bf16),
      rows, N, static_cast<cudaStream_t>(stream));
}

int lpm_residual_layernorm(const void* x, const void* y, const void* scale, const void* bias,
                           const void* mask, void* out, long long rows, int D, void* stream) {
  return (int)lpm_native::launch_residual_layernorm(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<bf16*>(out),
      rows, D, static_cast<cudaStream_t>(stream));
}

int lpm_masked_mean(const void* x, int x_is_bf16, const void* num_frames, void* out_f32,
                    void* out_bf16, int B, int F, int C, int count_valid, void* stream) {
  return (int)lpm_native::launch_masked_mean(
      x, x_is_bf16 != 0, static_cast<const int32_t*>(num_frames), static_cast<float*>(out_f32),
      static_cast<bf16*>(out_bf16), B, F, C, count_valid, static_cast<cudaStream_t>(stream));
}

int lpm_bias_sigmoid(const void* y, const void* bias, void* out, long long rows, int N,
                     void* stream) {
  return (int)lpm_native::launch_bias_act(lpm_native::kActSigmoid, static_cast<const float*>(y),
                                          static_cast<const float*>(bias), static_cast<float*>(out),
                                          nullptr, rows, N, static_cast<cudaStream_t>(stream));
}

int lpm_bias_relu6(const void* y, const void* bias, void* out_f32, void* out_bf16, long long rows,
                   int N, void* stream) {
  return (int)lpm_native::launch_bias_act(lpm_native::kActRelu6, static_cast<const float*>(y),
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

int lpm_lstm_cell(const void* pre, long long ld_pre, const void* hw, const void* b_h,
                  const void* c_in, void* c_out, void* h_out, void* seq, long long ld_seq,
                  void* carry, const void* num_frames, int B, int F, int H, int t, void* stream) {
  return (int)lpm_native::launch_lstm_cell(
      static_cast<const float*>(pre), ld_pre, static_cast<const float*>(hw),
      static_cast<const float*>(b_h), static_cast<const float*>(c_in), static_cast<float*>(c_out),
      static_cast<float*>(h_out), static_cast<float*>(seq), ld_seq, static_cast<float*>(carry),
      static_cast<const int32_t*>(num_frames), B, F, H, t, static_cast<cudaStream_t>(stream));
}

int lpm_gru_cell(const void* pre, long long ld_pre, const void* hw, const void* b_i,
                 const void* b_hn, const void* h_in, void* h_out, void* seq, long long ld_seq,
                 void* carry, const void* num_frames, int B, int F, int H, int t, void* stream) {
  return (int)lpm_native::launch_gru_cell(
      static_cast<const float*>(pre), ld_pre, static_cast<const float*>(hw),
      static_cast<const float*>(b_i), static_cast<const float*>(b_hn),
      static_cast<const float*>(h_in), static_cast<float*>(h_out), static_cast<float*>(seq), ld_seq,
      static_cast<float*>(carry), static_cast<const int32_t*>(num_frames), B, F, H, t,
      static_cast<cudaStream_t>(stream));
}

// One GRU layer over all F frames (gru_layer_kernel): hbuf is a scratch of
// 2·B·round_up(H, 4) f32 on 16 bytes; carry and num_frames may be null
// (no carry).
int lpm_gru_layer(const void* pre, long long ld_pre_b, long long ld_pre_t, const void* w_h,
                  const void* b_i, const void* b_hn, void* hbuf, void* seq, long long ld_seq_b,
                  long long ld_seq_t, void* carry, const void* num_frames, int B, int F, int H,
                  void* stream) {
  return (int)lpm_native::launch_gru_layer(
      static_cast<const float*>(pre), ld_pre_b, ld_pre_t, static_cast<const float*>(w_h),
      static_cast<const float*>(b_i), static_cast<const float*>(b_hn), static_cast<float*>(hbuf),
      static_cast<float*>(seq), ld_seq_b, ld_seq_t, static_cast<float*>(carry),
      static_cast<const int32_t*>(num_frames), B, F, H, static_cast<cudaStream_t>(stream));
}

int lpm_pool_attention(const void* q, const void* kv, const void* bkv, const void* num_frames,
                       void* out, int B, int F, int Q, int H, int hd, void* stream) {
  return (int)lpm_native::launch_pool_attention(
      static_cast<const float*>(q), static_cast<const float*>(kv), static_cast<const float*>(bkv),
      static_cast<const int32_t*>(num_frames), static_cast<float*>(out), B, F, Q, H, hd,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
