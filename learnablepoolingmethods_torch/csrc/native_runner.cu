// The native runner: the Willow fast route of NetVLADModelLF (uint8 frames
// → top-k classes) with no Python and no libtorch in its execution path,
// for export_model.py's with_stablehlo artifact (native_manifest.txt +
// weights.bin, the BN-folded arrays of ops/fast_infer.py#prepare_fast_params
// as its kernels read them).  core/native_runtime.py binds it in-process
// through ctypes; native/serving_main.cc links it into lpm_serve.
//
// It takes the place of the JAX package's native runtime
// (learnablepoolingmethods_tpu/core/native_runtime.py over
// native/stablehlo_runner.cc, which runs the exported StableHLO module with
// XLA's PJRT CPU client).  The card's machine has neither XLA nor StableHLO,
// so this runner runs the fast route's own steps instead.  One batch, on
// one stream of the runner's:
//
//   1. the batch's host arrays into pinned staging, one copy each to the card;
//   2. row 1, lpm_netvlad_frontend (fused_frontend.cu, compiled into this
//      library: no second copy of the kernel), drawing frames from the
//      manifest's sampling key at row offset 0, as the fast route does;
//   3. the hidden FC as two cuBLAS bf16 × bf16 → f32 products (rgb and
//      audio slices of the 278528 × 1024 weight);
//   4. hidden_sum: h = (h_rgb + h_aud) + hidden_b in f32, and h rounded
//      to bf16 (ops/fast_infer.py's order; JAX ops/fast_infer.py:272-276);
//   5. the gating product on the rounded h, then gating: ×g_scale + g_bias,
//      the sigmoid, h·σ, one rounding to bf16 (JAX ops/fast_infer.py:69-74);
//   6. the MoE's gate and expert products, then moe_combine: + experts_bias,
//      the softmax over each class's M+1 gate logits and Σ_m p_m·σ(e_m)
//      (JAX ops/fast_infer.py:76-85);
//   7. topk: exact top-k of each row, sorted descending, the lowest index
//      first among equal scores (jax.lax.top_k, JAX ops/topk.py);
//   8. the results back to pinned memory, one synchronisation, and into the
//      caller's arrays.
//
// The JAX package leaves the products and the element-wise tail to XLA; so
// cuBLAS computes the products here, and the tail is four small hand
// kernels.  What bounds them: each reads its f32 inputs and writes its
// outputs once (bytes; at B=256, V=3862 moe_combine moves 20 MB, about
// 6 µs at 3.35 TB/s).  They are simple first: one thread an element for the
// element-wise three (grid-stride), and for topk one block a row that keeps
// the row in shared memory and takes k rounds of a block-wide argmax, each
// round over the entries that order after the previous pick.  chip_smoke.py
// holds each against its plain version (ops/native_tail.py) and times it
// beside its bound.
//
// Arithmetic that the gate against the torch route needs: the sigmoid is
// 1 / (1 + expf(−x)) and the softmax exp(x − max) / Σ, each with expf (not
// __expf), as PyTorch computes them on the card; products and sums round
// where the route rounds (__fmul_rn / __fadd_rn keep nvcc from fusing them).
//
// The C API takes no CUDA or torch types; errors come back as strings.  The
// runner counts its own launches of row 1 and of each tail kernel
// (lpm_runner_launches); ops/fused_frontend.py's counter never sees them.

#include <cublas_v2.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "native_manifest.h"

extern "C" int lpm_netvlad_frontend(
    const void* x, unsigned int k0, unsigned int k1, const void* num_frames,
    const void* in_scale, const void* in_bias,
    const void* c_rgb, const void* s_rgb, const void* b_rgb, const void* c2_rgb,
    const void* c_aud, const void* s_aud, const void* b_aud, const void* c2_aud,
    void* out_rgb, void* out_aud, void* ws_x, void* ws_a_rgb, void* ws_a_aud,
    void* ws_colsq_rgb, void* ws_colsq_aud, int B, int F, int DT, int S, int d_rgb,
    int k_rgb, int d_aud, int k_aud, float deq_scale, float deq_bias, long long row_offset,
    void* stream);

namespace lpm_native {

using bf16 = __nv_bfloat16;

// ops/fused_frontend.py's DEQ_SCALE and DEQ_BIAS, rounded to f32 as ctypes
// rounds the Python floats
constexpr float kDeqScale = static_cast<float>(4.0 / 255.0);
constexpr float kDeqBias = static_cast<float>(4.0 / 512.0 - 2.0);
constexpr int kMaxClusters = 512;  // netvlad_core.cuh kMaxClusters
constexpr int kEwThreads = 256;
constexpr int kTopkThreads = 256;
constexpr int kMaxTopkSmem = 232448;  // an H100 block's dynamic shared memory at most

// the counted launches, in lpm_runner_launches' names
enum Counter { kFrontend, kHiddenSum, kGating, kMoeCombine, kTopk, kNumCounters };
const char* const kCounterNames[kNumCounters] = {"netvlad_frontend", "hidden_sum", "gating",
                                                 "moe_combine", "topk"};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ long long grid_start() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long grid_step() { return (long long)gridDim.x * blockDim.x; }

// h = (h_rgb + h_aud) + bias[col] and its bf16 rounding; rows × H entries
__global__ void hidden_sum_kernel(const float* __restrict__ h_rgb, const float* __restrict__ h_aud,
                                  const float* __restrict__ bias, float* __restrict__ h,
                                  bf16* __restrict__ hb, long long n, int H) {
  for (long long i = grid_start(); i < n; i += grid_step()) {
    const float v = __fadd_rn(__fadd_rn(h_rgb[i], h_aud[i]), bias[(int)(i % H)]);
    h[i] = v;
    hb[i] = __float2bfloat16_rn(v);
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

__device__ __forceinline__ unsigned long long warp_max(unsigned long long x) {
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
    best = warp_max(best);
    if (lane == 0) partial[warp] = best;
    __syncthreads();
    best = lane < kTopkThreads / 32 ? partial[lane] : 0;
    best = warp_max(best);
    __syncthreads();  // every warp has read partial before the next round writes it
    if (threadIdx.x == 0) {
      const int idx = (int)(0xffffffffu - (uint32_t)(best & 0xffffffffu));
      values[b * k + r] = row[idx];
      indices[b * k + r] = idx;
    }
    prev = best;
  }
}

unsigned ew_blocks(long long n) {
  const long long blocks = (n + kEwThreads - 1) / kEwThreads;
  return (unsigned)(blocks < 4096 ? (blocks < 1 ? 1 : blocks) : 4096);
}

cudaError_t launch_hidden_sum(const float* h_rgb, const float* h_aud, const float* bias, float* h,
                              bf16* hb, long long rows, int H, cudaStream_t st) {
  if (rows < 1 || H < 1) return cudaErrorInvalidValue;
  const long long n = rows * H;
  hidden_sum_kernel<<<ew_blocks(n), kEwThreads, 0, st>>>(h_rgb, h_aud, bias, h, hb, n, H);
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

// row-major C[M, N] (f32) = A[M, K] (bf16) · B[K, N] (bf16), summed in f32.
// cuBLAS is column-major: the row-major buffers are Cᵀ, Aᵀ and Bᵀ there,
// so it computes Cᵀ = Bᵀ · Aᵀ.
cublasStatus_t gemm_bf16(cublasHandle_t h, const bf16* a, const bf16* b, float* c, int M, int N,
                         int K) {
  const float one = 1.f, zero = 0.f;
  return cublasGemmEx(h, CUBLAS_OP_N, CUBLAS_OP_N, N, M, K, &one, b, CUDA_R_16BF, N, a,
                      CUDA_R_16BF, K, &zero, c, CUDA_R_32F, N, CUBLAS_COMPUTE_32F,
                      CUBLAS_GEMM_DEFAULT);
}

// the arrays of weights.bin by name, with their dtype and shape
struct WeightRule {
  const char* name;
  const char* tag;
};
const WeightRule kWeights[] = {
    {"in_scale", "f32"},     {"in_bias", "f32"},      {"rgb/cluster", "bf16"},
    {"rgb/scale", "f32"},    {"rgb/bias", "f32"},     {"rgb/c2", "f32"},
    {"aud/cluster", "bf16"}, {"aud/scale", "f32"},    {"aud/bias", "f32"},
    {"aud/c2", "f32"},       {"w_rgb", "bf16"},       {"w_aud", "bf16"},
    {"hidden_b", "f32"},     {"gate_w", "bf16"},      {"g_scale", "f32"},
    {"g_bias", "f32"},       {"gates_kernel", "bf16"}, {"experts_kernel", "bf16"},
    {"experts_bias", "f32"}};

struct Runner {
  Manifest m;
  int device = 0;
  int B = 0, F = 0, DT = 0, S = 0, H = 0, V = 0, M = 0, k = 0;
  int d_rgb = 0, k_rgb = 0, d_aud = 0, k_aud = 0;
  cudaStream_t stream = nullptr;
  cublasHandle_t blas = nullptr;
  char* weights = nullptr;  // every array, each at a 256-byte boundary
  std::vector<size_t> weight_offsets;
  char* ws = nullptr;  // the batch's workspaces
  char* pinned = nullptr;
  // workspaces on the card
  uint8_t* x = nullptr;
  int32_t* nf = nullptr;
  bf16 *vlad_rgb = nullptr, *vlad_aud = nullptr, *ws_x = nullptr, *hb = nullptr, *hg = nullptr;
  float *ws_a_rgb = nullptr, *ws_a_aud = nullptr, *ws_cs_rgb = nullptr, *ws_cs_aud = nullptr;
  float *h_rgb = nullptr, *h_aud = nullptr, *h = nullptr, *gates = nullptr, *ga = nullptr,
        *ea = nullptr, *probs = nullptr, *values = nullptr;
  int32_t* indices = nullptr;
  // pinned staging on the host
  uint8_t* px = nullptr;
  int32_t* pnf = nullptr;
  float *pvalues = nullptr, *pprobs = nullptr;
  int32_t* pindices = nullptr;
  std::mutex mu;  // one batch at a time
  std::atomic<long long> launches[kNumCounters];

  Runner() {
    for (auto& c : launches) c.store(0);
  }

  template <typename T>
  const T* w(int i) const {
    return reinterpret_cast<const T*>(weights + weight_offsets[i]);
  }

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

// the arrays' shapes against one another and the manifest's batch
bool check_shapes(Runner* r, std::string* err) {
  const Manifest& m = r->m;
  const ArraySpec* a[19];
  for (int i = 0; i < 19; ++i) {
    a[i] = m.weight(kWeights[i].name);
    if (!a[i] || a[i]->tag != kWeights[i].tag) {
      *err = std::string("weights.bin lacks ") + kWeights[i].tag + " array " + kWeights[i].name;
      return false;
    }
  }
  auto shape = [&](int i, std::vector<int64_t> want) {
    if (a[i]->dims == want) return true;
    *err = std::string(kWeights[i].name) + " has shape " + dims_str(a[i]->dims) + ", expected " +
           dims_str(want);
    return false;
  };
  if (a[2]->dims.size() != 2 || a[6]->dims.size() != 2 || a[13]->dims.size() != 2 ||
      a[18]->dims.size() != 1) {
    *err = "weights.bin: the cluster matrices and gate_w must be 2-d, experts_bias 1-d";
    return false;
  }
  r->d_rgb = (int)a[2]->dims[0];
  r->k_rgb = (int)a[2]->dims[1];
  r->d_aud = (int)a[6]->dims[0];
  r->k_aud = (int)a[6]->dims[1];
  r->H = (int)a[13]->dims[0];
  r->M = m.moe_num_mixtures;
  r->DT = m.total_size();
  r->B = m.batch_size;
  r->F = m.max_frames;
  r->S = m.iterations;
  if (r->M < 1 || a[18]->dims[0] % r->M != 0) {
    *err = "moe_num_mixtures must be positive and divide experts_bias's length";
    return false;
  }
  r->V = (int)(a[18]->dims[0] / r->M);
  r->k = m.top_k < r->V ? m.top_k : r->V;
  const int64_t dr = r->d_rgb, kr = r->k_rgb, da = r->d_aud, ka = r->k_aud, H = r->H, M = r->M,
                V = r->V, DT = r->DT;
  if (!(shape(0, {DT}) && shape(1, {DT}) && shape(3, {kr}) && shape(4, {kr}) &&
        shape(5, {dr, kr}) && shape(7, {ka}) && shape(8, {ka}) && shape(9, {da, ka}) &&
        shape(10, {dr * kr, H}) && shape(11, {da * ka, H}) && shape(12, {H}) &&
        shape(13, {H, H}) && shape(14, {H}) && shape(15, {H}) && shape(16, {H, (M + 1) * V}) &&
        shape(17, {H, M * V})))
    return false;
  if (m.frame_features != 1 || dr + da != DT || r->S < 1 || r->B > 65535 ||
      kr > kMaxClusters || ka > kMaxClusters) {
    *err = "the route needs frame-level features whose widths sum to the two NetVLADs' (" +
           std::to_string(dr) + " + " + std::to_string(da) + " vs " + std::to_string(DT) +
           "), iterations >= 1, batch <= 65535 and K <= 512";
    return false;
  }
  const bool calls = m.call_inputs.size() == 2 && m.call_inputs[0].tag == "u8" &&
                     m.call_inputs[0].dims == std::vector<int64_t>{r->B, r->F, DT} &&
                     m.call_inputs[1].tag == "s32" &&
                     m.call_inputs[1].dims == std::vector<int64_t>{r->B};
  const bool outs = m.outputs.size() == 2 && m.outputs[0].tag == "f32" &&
                    m.outputs[0].dims == std::vector<int64_t>{r->B, r->k} &&
                    m.outputs[1].tag == "s32" && m.outputs[1].dims == m.outputs[0].dims;
  if (!calls || !outs) {
    *err = "manifest call inputs or outputs are not (u8 [B, F, DT], s32 [B]) → (f32 [B, k], "
           "s32 [B, k])";
    return false;
  }
  return true;
}

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

bool load(Runner* r, const std::string& dir, std::string* err) {
  if (!LoadManifest(dir, &r->m, err)) return false;
  if (r->m.route != kRoute) {
    *err = "route " + r->m.route + " is not this runner's (" + kRoute + ")";
    return false;
  }
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
      !blas_ok(cublasSetStream(r->blas, r->stream), "cublasSetStream", err))
    return false;

  size_t total = 0;
  for (const auto& rule : kWeights) {
    r->weight_offsets.push_back(total);
    total += align256(r->m.weight(rule.name)->bytes());
  }
  if (!cuda_ok(cudaMalloc(&r->weights, total), "cudaMalloc(weights)", err)) return false;
  for (size_t i = 0; i < r->weight_offsets.size(); ++i) {
    const ArraySpec* a = r->m.weight(kWeights[i].name);
    if (!cuda_ok(cudaMemcpy(r->weights + r->weight_offsets[i], blob.data() + a->offset, a->bytes(),
                            cudaMemcpyHostToDevice),
                 "upload of the weights", err))
      return false;
  }

  // the workspaces of ops/fused_frontend.py#netvlad_frontend (:125-130), and
  // the tail's, for the manifest's batch; dchunks as aggregation_geometry
  const long long B = r->B, S = r->S, DT = r->DT, H = r->H, V = r->V, M = r->M, k = r->k;
  auto dchunks = [](long long d) { return ((d + 63) / 64 + 15) / 16; };
  struct Part {
    void** ptr;
    size_t bytes;
  } parts[] = {
      {(void**)&r->x, (size_t)(B * r->F * DT)},
      {(void**)&r->nf, (size_t)(B * 4)},
      {(void**)&r->vlad_rgb, (size_t)(B * r->d_rgb * r->k_rgb * 2)},
      {(void**)&r->vlad_aud, (size_t)(B * r->d_aud * r->k_aud * 2)},
      {(void**)&r->ws_x, (size_t)(B * S * DT * 2)},
      {(void**)&r->ws_a_rgb, (size_t)(B * S * r->k_rgb * 4)},
      {(void**)&r->ws_a_aud, (size_t)(B * S * r->k_aud * 4)},
      {(void**)&r->ws_cs_rgb, (size_t)(B * dchunks(r->d_rgb) * r->k_rgb * 4)},
      {(void**)&r->ws_cs_aud, (size_t)(B * dchunks(r->d_aud) * r->k_aud * 4)},
      {(void**)&r->h_rgb, (size_t)(B * H * 4)},
      {(void**)&r->h_aud, (size_t)(B * H * 4)},
      {(void**)&r->h, (size_t)(B * H * 4)},
      {(void**)&r->hb, (size_t)(B * H * 2)},
      {(void**)&r->gates, (size_t)(B * H * 4)},
      {(void**)&r->hg, (size_t)(B * H * 2)},
      {(void**)&r->ga, (size_t)(B * (M + 1) * V * 4)},
      {(void**)&r->ea, (size_t)(B * M * V * 4)},
      {(void**)&r->probs, (size_t)(B * V * 4)},
      {(void**)&r->values, (size_t)(B * k * 4)},
      {(void**)&r->indices, (size_t)(B * k * 4)},
  };
  size_t ws_bytes = 0;
  for (const auto& p : parts) ws_bytes += align256(p.bytes);
  if (!cuda_ok(cudaMalloc(&r->ws, ws_bytes), "cudaMalloc(workspaces)", err)) return false;
  size_t off = 0;
  for (const auto& p : parts) {
    *p.ptr = r->ws + off;
    off += align256(p.bytes);
  }
  struct Part pin[] = {
      {(void**)&r->px, (size_t)(B * r->F * DT)},
      {(void**)&r->pnf, (size_t)(B * 4)},
      {(void**)&r->pvalues, (size_t)(B * k * 4)},
      {(void**)&r->pindices, (size_t)(B * k * 4)},
      {(void**)&r->pprobs, (size_t)(B * V * 4)},
  };
  size_t pin_bytes = 0;
  for (const auto& p : pin) pin_bytes += align256(p.bytes);
  if (!cuda_ok(cudaMallocHost(&r->pinned, pin_bytes), "cudaMallocHost(staging)", err)) return false;
  off = 0;
  for (const auto& p : pin) {
    *p.ptr = r->pinned + off;
    off += align256(p.bytes);
  }
  return true;
}

// One batch: features [B, F, DT] u8 and num_frames [B] s32 on the host →
// values/indices [B, k] (or probs [B, V]) on the host.
bool forward(Runner* r, const void* features, const void* num_frames, float* values,
             int32_t* indices, float* probs, std::string* err) {
  std::lock_guard<std::mutex> lock(r->mu);
  const long long B = r->B, F = r->F, DT = r->DT, V = r->V, M = r->M, k = r->k;
  cudaStream_t st = r->stream;
  if (!cuda_ok(cudaSetDevice(r->device), "cudaSetDevice", err)) return false;
  memcpy(r->px, features, B * F * DT);
  memcpy(r->pnf, num_frames, B * 4);
  if (!cuda_ok(cudaMemcpyAsync(r->x, r->px, B * F * DT, cudaMemcpyHostToDevice, st), "H2D", err) ||
      !cuda_ok(cudaMemcpyAsync(r->nf, r->pnf, B * 4, cudaMemcpyHostToDevice, st), "H2D", err))
    return false;

  const int rc = lpm_netvlad_frontend(
      r->x, r->m.key0, r->m.key1, r->nf, r->w<float>(0), r->w<float>(1), r->w<bf16>(2),
      r->w<float>(3), r->w<float>(4), r->w<float>(5), r->w<bf16>(6), r->w<float>(7),
      r->w<float>(8), r->w<float>(9), r->vlad_rgb, r->vlad_aud, r->ws_x, r->ws_a_rgb,
      r->ws_a_aud, r->ws_cs_rgb, r->ws_cs_aud, r->B, r->F, r->DT, r->S, r->d_rgb, r->k_rgb,
      r->d_aud, r->k_aud, kDeqScale, kDeqBias, 0, st);
  if (!cuda_ok((cudaError_t)rc, "netvlad_frontend", err)) return false;
  r->launches[kFrontend]++;

  if (!blas_ok(gemm_bf16(r->blas, r->vlad_rgb, r->w<bf16>(10), r->h_rgb, r->B, r->H,
                         r->d_rgb * r->k_rgb),
               "hidden FC (rgb)", err) ||
      !blas_ok(gemm_bf16(r->blas, r->vlad_aud, r->w<bf16>(11), r->h_aud, r->B, r->H,
                         r->d_aud * r->k_aud),
               "hidden FC (audio)", err))
    return false;
  if (!cuda_ok(launch_hidden_sum(r->h_rgb, r->h_aud, r->w<float>(12), r->h, r->hb, B, r->H, st),
               "hidden_sum", err))
    return false;
  r->launches[kHiddenSum]++;

  if (!blas_ok(gemm_bf16(r->blas, r->hb, r->w<bf16>(13), r->gates, r->B, r->H, r->H),
               "gating product", err))
    return false;
  if (!cuda_ok(launch_gating(r->gates, r->h, r->w<float>(14), r->w<float>(15), r->hg, B, r->H, st),
               "gating", err))
    return false;
  r->launches[kGating]++;

  if (!blas_ok(gemm_bf16(r->blas, r->hg, r->w<bf16>(16), r->ga, r->B, (int)((M + 1) * V), r->H),
               "MoE gate product", err) ||
      !blas_ok(gemm_bf16(r->blas, r->hg, r->w<bf16>(17), r->ea, r->B, (int)(M * V), r->H),
               "MoE expert product", err))
    return false;
  if (!cuda_ok(launch_moe_combine(r->ga, r->ea, r->w<float>(18), r->probs, r->B, r->M, r->V, st),
               "moe_combine", err))
    return false;
  r->launches[kMoeCombine]++;

  if (probs) {
    if (!cuda_ok(cudaMemcpyAsync(r->pprobs, r->probs, B * V * 4, cudaMemcpyDeviceToHost, st), "D2H",
                 err))
      return false;
  } else {
    if (!cuda_ok(launch_topk(r->probs, r->values, r->indices, r->B, r->V, r->k, st), "topk", err))
      return false;
    r->launches[kTopk]++;
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

void set_err(const std::string& msg, char* err, long long cap) {
  if (!err || cap <= 0) return;
  snprintf(err, (size_t)cap, "%s", msg.c_str());
}

}  // namespace lpm_native

using lpm_native::Runner;

extern "C" {

// Loads export_dir's native artifact on CUDA device `device`: parses the
// manifest, uploads the weights once, allocates the manifest's batch's
// workspaces and pinned staging.  → a handle, or NULL with *err set.
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

// One batch of the manifest's size: features u8 [B, F, DT], num_frames s32
// [B] → values f32 [B, k], indices s32 [B, k], all host memory.  0 on
// success; else 1 with *err set.
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

// The runner's launches of `name` (netvlad_frontend, hidden_sum, gating,
// moe_combine, topk) since it loaded or was reset; −1 for another name.
long long lpm_runner_launches(void* handle, const char* name) {
  auto* r = static_cast<Runner*>(handle);
  for (int i = 0; i < lpm_native::kNumCounters; ++i)
    if (strcmp(name, lpm_native::kCounterNames[i]) == 0) return r->launches[i].load();
  return -1;
}

void lpm_runner_reset_launches(void* handle) {
  for (auto& c : static_cast<Runner*>(handle)->launches) c.store(0);
}

void lpm_runner_destroy(void* handle) { delete static_cast<Runner*>(handle); }

// The tail kernels alone, on device pointers and the caller's stream
// (ops/native_tail.py's wrappers); each returns a cudaError_t.
int lpm_hidden_sum(const void* h_rgb, const void* h_aud, const void* bias, void* h, void* hb,
                   long long rows, int H, void* stream) {
  return (int)lpm_native::launch_hidden_sum(
      static_cast<const float*>(h_rgb), static_cast<const float*>(h_aud),
      static_cast<const float*>(bias), static_cast<float*>(h), static_cast<__nv_bfloat16*>(hb),
      rows, H, static_cast<cudaStream_t>(stream));
}

int lpm_gating(const void* gates, const void* h, const void* g_scale, const void* g_bias,
               void* out, long long rows, int H, void* stream) {
  return (int)lpm_native::launch_gating(
      static_cast<const float*>(gates), static_cast<const float*>(h),
      static_cast<const float*>(g_scale), static_cast<const float*>(g_bias),
      static_cast<__nv_bfloat16*>(out), rows, H, static_cast<cudaStream_t>(stream));
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

}  // extern "C"
