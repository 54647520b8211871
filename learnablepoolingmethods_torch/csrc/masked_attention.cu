// Masked multi-head self-attention over a fused QKV tensor: qkv [B, F, 3·D]
// (bf16 or f32, D = H·hd, q ‖ k ‖ v on the last axis) and mask [B, F] f32
// (1 = valid key) → out [B, F, D] in qkv's type, for every head h
//
//     out[b, :, h] = softmax(Q·Kᵀ/√hd + (1 − mask)·(−1e9)) · V     (rows of F)
//
// Replaces the TPU kernel learnablepoolingmethods_tpu/ops/fast_transformer.py
// #masked_attention_fused (kernel body _attention_kernel), which holds one
// whole video per grid step in VMEM (about 2.8 MB at F=300, D=1024, every
// head's [F, F] f32 logits among it).  On this card one head's [300, 300] f32
// logits alone are 360 KB, above the 227 KB a block may use, so this kernel
// does not carry that block over: it is a flash-style loop with an online
// softmax, and no [F, F] tensor ever reaches device memory.
//
// What bounds it: at B=256, F=300, D=1024, bf16, reading qkv once and writing
// the output once is 629 MB, 0.188 ms at 3.35 TB/s; the two products are
// 9.4e10 FLOP, 0.095 ms at 989 TFLOP/s of bf16 tensor cores.  So the bytes
// bound it.  This simple version reads each video's K and V once per query
// tile (5 times at F=300) and runs both products as f32 FMAs on the CUDA
// cores, so the FMA and shared-memory instruction rates, not the bytes, limit it.
// Tensor cores (mma.sync / wgmma), TMA loads and a pipelined K/V ring are
// left to the redesign.
//
// Design: one block per (query tile of 64 rows, head, video); 256 threads as
// 16 row groups × 16 lanes, each thread owning query rows g + 16i (i < 4).
//  1. The Q tile is read in place (row stride 3·D, no copies of q, k or v),
//     divided by √hd in f32 as the plain version does, and kept in shared
//     memory as f32.
//  2. For each tile of 64 keys: K and V into shared memory; each thread
//     forms its 4 × 4 logits (keys lane + 16j) as f32 FMAs over hd; the key
//     bias (1 − mask)·(−1e9) is added in f32 exactly as the reference adds
//     it; keys past F get −inf and so enter neither the max nor the sum.
//  3. Online softmax per row: the running max starts at −inf (not −1e9), so
//     a row whose keys are all masked ends with uniform weights over all F
//     keys, the mean of V, as the reference and flax give; the running sum
//     takes the unrounded exp; the accumulator [4 rows × 8 columns] is
//     rescaled by exp(m_old − m_new).  Key tiles are never skipped by
//     num_frames (that would change the all-masked answer).
//  4. P·V: the exp values are rounded to T where they enter the product (the
//     TPU kernel rounds the normalised weights instead: one bf16 rounding
//     either way; none for f32), summed in f32; at the end each row is
//     divided by its sum and rounded to T once.  Query rows past F are
//     computed on zeros and not stored.

#include "netvlad_core.cuh"

namespace lpm {

constexpr int kAttnRows = 64;                  // query rows per block
constexpr int kAttnKeys = 64;                  // keys per tile
constexpr int kAttnMaxHd = 128;                // the widest head
constexpr int kAttnThreads = 256;              // 16 row groups × 16 lanes
constexpr int kQKPitch = kAttnMaxHd + 4;       // float4 rows, 8 keys on distinct banks
constexpr int kVPitch = kAttnMaxHd;
constexpr int kPPitch = kAttnKeys + 4;
constexpr int kAttnSmemFloats =
    kAttnRows * kQKPitch + kAttnKeys * kQKPitch + kAttnKeys * kVPitch + kAttnRows * kPPitch +
    kAttnKeys;
constexpr size_t kAttnSmemBytes = sizeof(float) * kAttnSmemFloats;  // 118,016

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// Rows [r0, r0 + 64) of one head's hd columns (src points at column 0 of the
// head, rows ld apart) → dst [64][pitch] f32, each value divided by div;
// rows at or past F and columns at or past hd are zero.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, long long ld, int r0, int F,
                                          int hd, float div, float* dst, int pitch) {
  constexpr int kChunks = kAttnMaxHd / 8;
  for (int i = threadIdx.x; i < kAttnRows * kChunks; i += kAttnThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    float v[8];
    if (r0 + r < F && c < hd) {
      load8(src + (long long)(r0 + r) * ld + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    float* d = dst + r * pitch + c;
    *reinterpret_cast<float4*>(d) = make_float4(v[0] / div, v[1] / div, v[2] / div, v[3] / div);
    *reinterpret_cast<float4*>(d + 4) =
        make_float4(v[4] / div, v[5] / div, v[6] / div, v[7] / div);
  }
}

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
masked_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                        T* __restrict__ out, int F, int H, int hd, float sqrt_hd) {
  extern __shared__ float4 attn_smem4[];
  float* q_s = reinterpret_cast<float*>(attn_smem4);  // [64][kQKPitch]
  float* k_s = q_s + kAttnRows * kQKPitch;              // [64][kQKPitch]
  float* v_s = k_s + kAttnKeys * kQKPitch;              // [64][kVPitch]
  float* p_s = v_s + kAttnKeys * kVPitch;               // [64][kPPitch]
  float* neg_s = p_s + kAttnRows * kPPitch;             // [64]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kAttnRows, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd;
  const long long ld = 3LL * D;
  const T* video = qkv + (long long)b * F * ld + (long long)h * hd;
  const float* mrow = mask + (long long)b * F;

  load_tile(video, ld, q0, F, hd, sqrt_hd, q_s, kQKPitch);

  float m[4], l[4], o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < F; k0 += kAttnKeys) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile(video + D, ld, k0, F, hd, 1.f, k_s, kQKPitch);
    load_tile(video + 2 * D, ld, k0, F, hd, 1.f, v_s, kVPitch);
    if (tid < kAttnKeys) {
      const int key = k0 + tid;
      neg_s[tid] = key < F ? (1.f - mrow[key]) * -1e9f : -INFINITY;
    }
    __syncthreads();

    // logits of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&q_s[(ty + 16 * i) * kQKPitch + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * j) * kQKPitch + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // online softmax; a row's 16 lanes are one half of a warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += neg_s[tx + 16 * j];
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: every tile holds a key below F
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        p_s[(ty + 16 * i) * kPPitch + tx + 16 * j] = round_to<T, true>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    // P·V for columns tx·4 + e and 64 + tx·4 + e; P and V are zero past F
    const int nk = min(kAttnKeys, F - k0);
    for (int k = 0; k < nk; k += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&p_s[(ty + 16 * i) * kPPitch + k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vrow = &v_s[(k + kk) * kVPitch];
        const float4 va = *reinterpret_cast<const float4*>(vrow + tx * 4);
        const float4 vb = *reinterpret_cast<const float4*>(vrow + 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = kk == 0 ? pa[i].x : kk == 1 ? pa[i].y : kk == 2 ? pa[i].z : pa[i].w;
          o[i][0] = fmaf(p, va.x, o[i][0]);
          o[i][1] = fmaf(p, va.y, o[i][1]);
          o[i][2] = fmaf(p, va.z, o[i][2]);
          o[i][3] = fmaf(p, va.w, o[i][3]);
          o[i][4] = fmaf(p, vb.x, o[i][4]);
          o[i][5] = fmaf(p, vb.y, o[i][5]);
          o[i][6] = fmaf(p, vb.z, o[i][6]);
          o[i][7] = fmaf(p, vb.w, o[i][7]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= F) continue;
    T* dst = out + ((long long)b * F + row) * D + (long long)h * hd;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half * 64 + tx * 4;
      if (c >= hd) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = o[i][half * 4 + e] / l[i];
      store4(dst + c, v);
    }
  }
}

template <typename T>
cudaError_t run_masked_attention(const T* qkv, const float* mask, T* out, int B, int F, int H,
                                 int hd, cudaStream_t stream) {
  if (B < 1 || B > 65535 || F < 1 || H < 1 || H > 65535 || hd < 8 || hd > kAttnMaxHd || hd % 8)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(masked_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kAttnSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kAttnRows - 1) / kAttnRows, H, B);
  masked_attention_kernel<T><<<grid, kAttnThreads, kAttnSmemBytes, stream>>>(
      qkv, mask, out, F, H, hd, sqrtf((float)hd));
  return cudaGetLastError();
}

}  // namespace lpm

extern "C" int lpm_masked_attention(const void* qkv, const void* mask, void* out, int is_bf16,
                                    int B, int F, int H, int hd, void* stream) {
  cudaError_t err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    err = lpm::run_masked_attention<bf16>(static_cast<const bf16*>(qkv), m, static_cast<bf16*>(out),
                                          B, F, H, hd, st);
  } else {
    err = lpm::run_masked_attention<float>(static_cast<const float*>(qkv), m,
                                           static_cast<float*>(out), B, F, H, hd, st);
  }
  return (int)err;
}
