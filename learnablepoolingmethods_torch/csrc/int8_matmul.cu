// Weight-only int8 matrix product (W8A16) for Hopper:
//
//   y[m, n] = (Σ_k bf16(x[m, k]) · bf16(q[k, n])) · s[n]  (+ b[n])     f32
//
// Replaces learnablepoolingmethods_tpu/ops/int8_matmul.py#matmul_wi8, which
// the JAX package leaves to XLA (no pallas_call): XLA fuses the s8 → bf16
// convert into the dot's operand stream, so no bf16 copy of the weight is
// written.  Here the int8 weight tiles come into shared memory by cp.async
// and are converted to bf16 on the way into the mma.sync m16n8k16
// fragments (csrc/tensor_core.cuh), summed in f32; the weight is never
// widened in global memory.
//
// The weight is stored n-major: wt [N, K] int8 (K contiguous), the [K, N]
// matrix of ops/int8_matmul.py#quantize_weight_int8 transposed once when
// the fast path is prepared, so that the two k-adjacent bytes of a B
// fragment are adjacent in shared memory.  x [M, K] bf16 row-major.
// K % 16 == 0 and N % 8 == 0 (the wrapper checks).
//
// Bound: operations at large M (2·M·K·N at 989 TFLOP/s: 0.278 ms for the
// Willow FC at M = 512), bytes at small M (the K·N int8 weight: 268 MB,
// about 0.08 ms at M = 32).
//
// Design.  A block of 128 threads (2 × 2 warps, 32 × 64 each) computes a
// 64 × 128 tile of y over a contiguous range of K, in steps of 64 through a
// three-stage cp.async ring.  Each step's int8 tile is converted once, one
// row of 64 bytes a thread, into a bf16 tile that both warps of a column
// read by ldmatrix, so no byte is converted twice in a block.  M ≤ 512 and N = 1024 give at most 64 output
// tiles for 132 SMs over K up to 262,144, so K is split: each split writes
// its f32 partial tile, and a second launch sums the splits in their order
// (a fixed order, no atomics) and applies the scale and the bias.  With one
// split the first launch writes y itself.  ops/int8_matmul.py#int8_geometry
// mirrors the split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace lpm {

constexpr int kBM = 64, kBN = 128, kBK = 64, kStages = 3, kThreads = 128;
constexpr int kApitch = kBK + 8;    // bf16 per A row in shared memory
constexpr int kBpitch = kBK + 16;   // bytes per B row in shared memory
constexpr int kHpitch = kBK + 8;    // bf16 per converted B row
constexpr int kAStage = kBM * kApitch * 2;
constexpr int kBStage = kBN * kBpitch;
constexpr int kSmem = kStages * (kAStage + kBStage) + kBN * kHpitch * 2;
static_assert(kBN == kThreads, "one thread converts one row of the B tile");

// a byte of a signed int8 as an exact f32: 2²³ + (v + 128) − (2²³ + 128)
__device__ __forceinline__ float s8_to_f(uint32_t byte) {
  return __uint_as_float(0x4B000000u | ((byte & 0xFFu) ^ 0x80u)) - 8388736.0f;
}

// four k-adjacent int8 (low byte first) → two registers of two bf16
__device__ __forceinline__ uint2 s8x4_to_bf16x4(uint32_t w) {
  return make_uint2(lpm::pack_bf16(s8_to_f(w), s8_to_f(w >> 8)),
                    lpm::pack_bf16(s8_to_f(w >> 16), s8_to_f(w >> 24)));
}

__global__ void __launch_bounds__(kThreads)
w8a16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wt,
             const float* __restrict__ scale, const float* __restrict__ bias,
             float* __restrict__ out, int M, int N, int K, int kb_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, split = blockIdx.z;
  const int kb_total = (K + kBK - 1) / kBK;
  const int kb0 = split * kb_per_split;
  const int kb1 = min(kb0 + kb_per_split, kb_total);
  const int nk = kb1 - kb0;

  auto a_stage = [&](int s) { return smem + s * kAStage; };
  auto b_stage = [&](int s) { return smem + kStages * kAStage + s * kBStage; };
  unsigned char* bh = smem + kStages * (kAStage + kBStage);  // the converted bf16 B tile

  auto load = [&](int kb, int s) {
    const int k0 = kb * kBK;
    unsigned char* as = a_stage(s);
    unsigned char* bs = b_stage(s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // A: 64 rows × 8 chunks of 8 bf16
      const int c = tid + i * kThreads, row = c >> 3, kc = (c & 7) * 8;
      const int m = m0 + row, k = k0 + kc;
      const bool in = m < M && k < K;
      const __nv_bfloat16* src = in ? x + (long long)m * K + k : x;
      lpm::cp_async_16(lpm::smem_addr(as + (row * kApitch + kc) * 2), src, in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // B: 128 rows (n) × 4 chunks of 16 int8
      const int c = tid + i * kThreads, row = c >> 2, kc = (c & 3) * 16;
      const int n = n0 + row, k = k0 + kc;
      const bool in = n < N && k < K;
      const int8_t* src = in ? wt + (long long)n * K + k : wt;
      lpm::cp_async_16(lpm::smem_addr(bs + row * kBpitch + kc), src, in ? 16 : 0);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(kb0 + s, s);
    lpm::cp_async_commit();
  }
  const int g = lane >> 2, t = lane & 3;
  for (int it = 0; it < nk; ++it) {
    // (the barrier below also keeps the previous step's readers of the
    // converted tile ahead of this step's conversion)
    lpm::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = it + kStages - 1;
    if (nxt < nk) load(kb0 + nxt, nxt % kStages);
    lpm::cp_async_commit();
    const unsigned char* as = a_stage(it % kStages);
    {  // this thread's row of the int8 tile → bf16 (k order kept)
      const uint4* src = reinterpret_cast<const uint4*>(b_stage(it % kStages) + tid * kBpitch);
      uint4* dst = reinterpret_cast<uint4*>(bh + tid * kHpitch * 2);
#pragma unroll
      for (int c = 0; c < kBK / 16; ++c) {
        const uint4 w = src[c];
        const uint2 q0 = s8x4_to_bf16x4(w.x), q1 = s8x4_to_bf16x4(w.y);
        const uint2 q2 = s8x4_to_bf16x4(w.z), q3 = s8x4_to_bf16x4(w.w);
        dst[2 * c] = make_uint4(q0.x, q0.y, q1.x, q1.y);
        dst[2 * c + 1] = make_uint4(q2.x, q2.y, q3.x, q3.y);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm * 32 + mt * 16 + (lane & 15);
        const int col = ks + (lane >> 4) * 8;
        lpm::ldmatrix_x4(a[mt], lpm::smem_addr(as + (row * kApitch + col) * 2));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
        // (n 8-15, k 8-15) of this pair of n8 tiles: b0, b1 of each
        const int i = lane >> 3;
        const int n = wn * 64 + np * 16 + (i >> 1) * 8 + (lane & 7);
        uint32_t b[4];
        lpm::ldmatrix_x4(b, lpm::smem_addr(bh + (n * kHpitch + ks + (i & 1) * 8) * 2));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          lpm::mma_bf16_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          lpm::mma_bf16_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  lpm::cp_async_wait<0>();

  const bool final_out = gridDim.z == 1;
  float* dst = final_out ? out : out + (long long)split * M * N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = n0 + wn * 64 + nt * 8 + 2 * t;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mt * 16 + g + 8 * h;
        if (m >= M) continue;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (final_out) {
          v0 = __fmul_rn(v0, scale[n]);
          v1 = __fmul_rn(v1, scale[n + 1]);
          if (bias != nullptr) {
            v0 = __fadd_rn(v0, bias[n]);
            v1 = __fadd_rn(v1, bias[n + 1]);
          }
        }
        *reinterpret_cast<float2*>(dst + (long long)m * N + n) = make_float2(v0, v1);
      }
    }
  }
}

// y = (Σ_s partial[s]) · scale (+ bias), the splits in their order
__global__ void splitk_reduce_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                                     const float* __restrict__ bias, float* __restrict__ out, int M,
                                     int N, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn) return;
  const int n = (int)(i % N);
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s = __fadd_rn(s, part[sp * mn + i]);
  s = __fmul_rn(s, scale[n]);
  if (bias != nullptr) s = __fadd_rn(s, bias[n]);
  out[i] = s;
}

}  // namespace lpm

using namespace lpm;

extern "C" {

// y [M, N] f32; partials [splits, M, N] f32 scratch (unused at one split);
// bias may be null.
int lpm_int8_matmul(const void* x, const void* wt, const void* scale, const void* bias, void* y,
                    void* partials, int M, int N, int K, int splits, int kb_per_split,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(w8a16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* first = splits == 1 ? static_cast<float*>(y) : static_cast<float*>(partials);
  w8a16_kernel<<<grid, kThreads, kSmem, s>>>(static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const int8_t*>(wt), sc, bi, first, M, N, K,
                                             kb_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long mn = (long long)M * N;
  splitk_reduce_kernel<<<(unsigned int)((mn + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partials), sc, bi, static_cast<float*>(y), M, N, splits);
  return (int)cudaGetLastError();
}

// the kernel's tile (BM, BN, BK) for ops/int8_matmul.py#int8_geometry
void lpm_int8_matmul_tile(int* out) {
  out[0] = kBM;
  out[1] = kBN;
  out[2] = kBK;
}

}  // extern "C"
