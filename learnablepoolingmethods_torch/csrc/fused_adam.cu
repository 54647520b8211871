// FusedAdam for Hopper: per-leaf norm clip, Adam and stochastic rounding of
// bf16 parameters and second moments, over every leaf of a model in two
// launches.
//
// Replaces learnablepoolingmethods_tpu/ops/fused_adam.py#FusedAdam.fused_apply,
// which the JAX package writes as one multi-output XLA fusion (no
// pallas_call).  For each leaf, with g32 = f32(g):
//
//   g32 *= min(1, clip / max(‖g32‖, 1e-20))                 (when clip > 0)
//   m32  = b1·m + (1 − b1)·g32
//   v32  = b2·ν + ((1 − b2)·g32)·g32
//   p32  = p − (lr·(m32·c1)) / (√(v32·c2) + ε)
//
// A bf16 leaf stores p and ν stochastically rounded (the low and the high 16
// bits of one Philox-4x32-10 word per element, keyed by (seed, count, leaf,
// element)) and m rounded to nearest; an f32 leaf stores all three exactly.
// Every product and sum is written __fmul_rn / __fadd_rn so that no fused
// multiply-add moves a value off the plain version's f32 result; division
// and the square root are IEEE (no --use_fast_math).
//
// Bound: bytes.  A bf16 parameter costs 16 B a step: the norm pass reads g
// (2 B), the update reads g, p, m, ν (8 B) and writes p, m, ν (6 B).
//
// Design.  The leaves are cut into chunks of kChunk elements; one block
// takes one chunk, and finds its leaf by a binary search of the device-side
// leaf table.  Launch 1 (clip only) sums g² of its chunk in a fixed order —
// thread t adds its elements r·2048 + 8t + j (r < 4, j < 8) in turn, then a
// halving tree over the 256 threads — and writes the chunk's partial; the
// last block of a leaf to finish (an integer counter, no float atomics)
// sums the leaf's partials in a fixed order (thread t a contiguous run,
// then the same tree) and writes the leaf's clip scale.  Launch 2 reads g,
// p, m and ν once, eight elements a thread at a time with 16-byte loads
// where the leaf is aligned (a scalar path otherwise and on the tail, in
// the same order), and writes p, m and ν once.
// ops/fused_adam.py#fused_adam_plain repeats this order exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lpm {

constexpr int kThreads = 256;
constexpr int kVec = 8;                         // elements per thread per row
constexpr int kRows = 4;                        // rows per chunk
constexpr int kChunk = kRows * kThreads * kVec; // 8192 elements
constexpr float kBf16Max = 3.38953139e38f;      // bf16 max, bits 0x7F7F0000

struct Leaf {
  const void* g;
  void* p;
  void* m;
  void* v;
  long long numel;
  long long chunk0;  // first chunk of this leaf
  int p_bf16;        // p, m, ν in bf16 (else f32)
  int g_bf16;        // g in bf16 (else f32)
  int aligned;       // every pointer 16-byte aligned
  int index;         // the leaf's position (keys its random bits)
};

__device__ __forceinline__ int find_leaf(const Leaf* leaves, int n, long long chunk) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].chunk0 <= chunk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Philox-4x32-10 (Salmon et al. 2011)
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float load_f(const void* base, int bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}

// eight consecutive values from i (16-byte loads; i is a multiple of 8)
__device__ __forceinline__ void load8(const void* base, int bf16, long long i, float out[8]) {
  if (bf16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
    const float4 a = f[0], b = f[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
}

// sum over the block's threads in the fixed halving order v[i] += v[i + s]
__device__ __forceinline__ float tree_sum(float x, float* red) {
  red[threadIdx.x] = x;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s >= 32; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  float v = threadIdx.x < 32 ? red[threadIdx.x] : 0.0f;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, s));
  }
  return v;  // valid in thread 0
}

// min(1, clip / max(√sumsq, 1e-20)) with NaN carried through, as
// jnp.maximum and jnp.minimum carry it (fmaxf and fminf drop it)
__device__ __forceinline__ float clip_scale(float sumsq, float clip) {
  const float norm = sqrtf(sumsq);
  const float q = clip / (norm != norm ? norm : fmaxf(norm, 1e-20f));
  return q != q ? q : fminf(1.0f, q);
}

// scales[leaf] = the leaf's clip scale, or with out_sumsq its Σg² itself
__global__ void __launch_bounds__(kThreads)
norm_kernel(const Leaf* __restrict__ leaves, int n_leaves, float* __restrict__ partials,
            unsigned int* __restrict__ counters, float* __restrict__ scales, float clip,
            int out_sumsq) {
  __shared__ float red[kThreads];
  __shared__ int last;
  const long long chunk = blockIdx.x;
  const int li = find_leaf(leaves, n_leaves, chunk);
  const Leaf leaf = leaves[li];
  const long long base = (chunk - leaf.chunk0) * kChunk;
  float acc = 0.0f;
  for (int r = 0; r < kRows; ++r) {
    const long long i0 = base + (long long)r * kThreads * kVec + threadIdx.x * kVec;
    float g[kVec];
    if (leaf.aligned && i0 + kVec <= leaf.numel) {
      load8(leaf.g, leaf.g_bf16, i0, g);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) g[j] = i0 + j < leaf.numel ? load_f(leaf.g, leaf.g_bf16, i0 + j) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc = __fadd_rn(acc, __fmul_rn(g[j], g[j]));
  }
  const float total = tree_sum(acc, red);
  if (threadIdx.x == 0) {
    partials[chunk] = total;
    __threadfence();
    const long long n_chunks = (leaf.numel + kChunk - 1) / kChunk;
    last = atomicAdd(&counters[li], 1u) == (unsigned int)(n_chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  // the leaf's last block: its partials in a fixed order
  __threadfence();
  const long long n_chunks = (leaf.numel + kChunk - 1) / kChunk;
  const long long run = (n_chunks + kThreads - 1) / kThreads;
  float s = 0.0f;
  for (long long j = 0; j < run; ++j) {
    const long long c = threadIdx.x * run + j;
    const float x = c < n_chunks ? *(volatile float*)&partials[leaf.chunk0 + c] : 0.0f;
    s = __fadd_rn(s, x);
  }
  const float sumsq = tree_sum(s, red);
  if (threadIdx.x == 0) {
    scales[li] = out_sumsq ? sumsq : clip_scale(sumsq, clip);
    counters[li] = 0u;  // ready for the next step
  }
}

__device__ __forceinline__ __nv_bfloat16 stochastic_round(float x, uint32_t bits) {
  if (!(fabsf(x) < kBf16Max)) return __float2bfloat16_rn(x);  // inf, nan, near max
  uint32_t u = __float_as_uint(x);
  u = (u + (bits & 0xFFFFu)) & 0xFFFF0000u;
  return __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
}

struct Consts {
  float lr, b1, omb1, b2, omb2, eps, c1, c2;
};

__global__ void __launch_bounds__(kThreads)
update_kernel(const Leaf* __restrict__ leaves, int n_leaves, const float* __restrict__ scales,
              Consts k, int clip, float clip_norm, int in_sumsq, int stochastic, uint2 key,
              uint32_t count) {
  const long long chunk = blockIdx.x;
  const int li = find_leaf(leaves, n_leaves, chunk);
  const Leaf leaf = leaves[li];
  const float scale = !clip ? 1.0f : in_sumsq ? clip_scale(scales[li], clip_norm) : scales[li];
  const long long base = (chunk - leaf.chunk0) * kChunk;
  for (int r = 0; r < kRows; ++r) {
    const long long i0 = base + (long long)r * kThreads * kVec + threadIdx.x * kVec;
    if (i0 >= leaf.numel) break;
    const bool vec = leaf.aligned && i0 + kVec <= leaf.numel;
    float g[kVec], p[kVec], m[kVec], v[kVec];
    if (vec) {
      load8(leaf.g, leaf.g_bf16, i0, g);
      load8(leaf.p, leaf.p_bf16, i0, p);
      load8(leaf.m, leaf.p_bf16, i0, m);
      load8(leaf.v, leaf.p_bf16, i0, v);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const bool in = i0 + j < leaf.numel;
        g[j] = in ? load_f(leaf.g, leaf.g_bf16, i0 + j) : 0.0f;
        p[j] = in ? load_f(leaf.p, leaf.p_bf16, i0 + j) : 0.0f;
        m[j] = in ? load_f(leaf.m, leaf.p_bf16, i0 + j) : 0.0f;
        v[j] = in ? load_f(leaf.v, leaf.p_bf16, i0 + j) : 0.0f;
      }
    }
    uint32_t bits[kVec];
    if (leaf.p_bf16 && stochastic) {
      // one Philox word per element: counter (element / 4, leaf, count)
      const unsigned long long q = (unsigned long long)i0 >> 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned long long qh = q + h;
        const uint4 w = philox(make_uint4((uint32_t)qh, (uint32_t)(qh >> 32), (uint32_t)leaf.index, count), key);
        bits[4 * h] = w.x; bits[4 * h + 1] = w.y; bits[4 * h + 2] = w.z; bits[4 * h + 3] = w.w;
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float g32 = clip ? __fmul_rn(g[j], scale) : g[j];
      m[j] = __fadd_rn(__fmul_rn(k.b1, m[j]), __fmul_rn(k.omb1, g32));
      v[j] = __fadd_rn(__fmul_rn(k.b2, v[j]), __fmul_rn(__fmul_rn(k.omb2, g32), g32));
      const float step = __fmul_rn(k.lr, __fmul_rn(m[j], k.c1)) / __fadd_rn(sqrtf(__fmul_rn(v[j], k.c2)), k.eps);
      p[j] = __fadd_rn(p[j], -step);
    }
    if (leaf.p_bf16) {
      __nv_bfloat16 po[kVec], mo[kVec], vo[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        mo[j] = __float2bfloat16_rn(m[j]);
        if (stochastic) {
          po[j] = stochastic_round(p[j], bits[j]);
          vo[j] = stochastic_round(v[j], bits[j] >> 16);
        } else {
          po[j] = __float2bfloat16_rn(p[j]);
          vo[j] = __float2bfloat16_rn(v[j]);
        }
      }
      __nv_bfloat16* pp = static_cast<__nv_bfloat16*>(leaf.p) + i0;
      __nv_bfloat16* mp = static_cast<__nv_bfloat16*>(leaf.m) + i0;
      __nv_bfloat16* vp = static_cast<__nv_bfloat16*>(leaf.v) + i0;
      if (vec) {
        *reinterpret_cast<uint4*>(pp) = *reinterpret_cast<const uint4*>(po);
        *reinterpret_cast<uint4*>(mp) = *reinterpret_cast<const uint4*>(mo);
        *reinterpret_cast<uint4*>(vp) = *reinterpret_cast<const uint4*>(vo);
      } else {
        for (int j = 0; j < kVec && i0 + j < leaf.numel; ++j) { pp[j] = po[j]; mp[j] = mo[j]; vp[j] = vo[j]; }
      }
    } else {
      float* pp = static_cast<float*>(leaf.p) + i0;
      float* mp = static_cast<float*>(leaf.m) + i0;
      float* vp = static_cast<float*>(leaf.v) + i0;
      if (vec) {
        reinterpret_cast<float4*>(pp)[0] = make_float4(p[0], p[1], p[2], p[3]);
        reinterpret_cast<float4*>(pp)[1] = make_float4(p[4], p[5], p[6], p[7]);
        reinterpret_cast<float4*>(mp)[0] = make_float4(m[0], m[1], m[2], m[3]);
        reinterpret_cast<float4*>(mp)[1] = make_float4(m[4], m[5], m[6], m[7]);
        reinterpret_cast<float4*>(vp)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(vp)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        for (int j = 0; j < kVec && i0 + j < leaf.numel; ++j) { pp[j] = p[j]; mp[j] = m[j]; vp[j] = v[j]; }
      }
    }
  }
}

}  // namespace lpm

using namespace lpm;

extern "C" {

// leaves: device table of n_leaves Leaf records (ops/fused_adam.py packs
// it); n_chunks: Σ ⌈numel / 8192⌉; partials [n_chunks] f32, counters
// [n_leaves] u32 (zero, and left zero), scales [n_leaves] f32: scratch.
// omb1 and omb2 are 1 − b1 and 1 − b2 rounded once from double, as the JAX
// package's Python-float constants are.
int lpm_fused_adam(const void* leaves, int n_leaves, long long n_chunks, void* partials,
                   void* counters, void* scales, float clip, float lr, float b1, float omb1,
                   float b2, float omb2, float eps, float c1, float c2, int stochastic,
                   unsigned long long seed,
                   unsigned int count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Leaf* table = static_cast<const Leaf*>(leaves);
  const int use_clip = clip > 0.0f;
  if (n_chunks <= 0) return 0;
  if (use_clip) {
    norm_kernel<<<(unsigned int)n_chunks, kThreads, 0, s>>>(
        table, n_leaves, static_cast<float*>(partials), static_cast<unsigned int*>(counters),
        static_cast<float*>(scales), clip, 0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  Consts k{lr, b1, omb1, b2, omb2, eps, c1, c2};
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  update_kernel<<<(unsigned int)n_chunks, kThreads, 0, s>>>(
      table, n_leaves, static_cast<const float*>(scales), k, use_clip, clip, 0, stochastic, key,
      count);
  return (int)cudaGetLastError();
}

// The two launches of lpm_fused_adam apart, for leaves split over ranks: the
// norm launch writes each leaf's Σg² into sumsq [n_leaves], the caller sums
// a split leaf's over its ranks, and the update launch forms each scale from
// sumsq (clip > 0) as the norm launch would.
int lpm_fused_adam_sumsq(const void* leaves, int n_leaves, long long n_chunks, void* partials,
                         void* counters, void* sumsq, void* stream) {
  if (n_chunks <= 0) return 0;
  norm_kernel<<<(unsigned int)n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), n_leaves, static_cast<float*>(partials),
      static_cast<unsigned int*>(counters), static_cast<float*>(sumsq), 0.0f, 1);
  return (int)cudaGetLastError();
}

int lpm_fused_adam_update(const void* leaves, int n_leaves, long long n_chunks, const void* sumsq,
                          float clip, float lr, float b1, float omb1, float b2, float omb2,
                          float eps, float c1, float c2, int stochastic, unsigned long long seed,
                          unsigned int count, void* stream) {
  if (n_chunks <= 0) return 0;
  Consts k{lr, b1, omb1, b2, omb2, eps, c1, c2};
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  update_kernel<<<(unsigned int)n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), n_leaves, static_cast<const float*>(sumsq), k, clip > 0.0f,
      clip, 1, stochastic, key, count);
  return (int)cudaGetLastError();
}

int lpm_fused_adam_chunk() { return kChunk; }

}  // extern "C"
