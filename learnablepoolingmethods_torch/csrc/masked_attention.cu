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
// logits alone are 360 KB, above the 227 KB a block may use, so neither
// instantiation carries that block over: each is a flash-style loop with an
// online softmax, and no [F, F] tensor ever reaches device memory.
//
// What bounds it: at B=256, F=300, D=1024, bf16, reading qkv once and writing
// the output once is 629 MB, 0.188 ms at 3.35 TB/s; the two products are
// 9.4e10 FLOP, 0.095 ms at 989 TFLOP/s of bf16 tensor cores.  So the bytes
// bound it.
//
// bf16 (every main path; masked_attention_mma_kernel below): both products
// on tensor cores, mma.sync m16n8k16 with f32 accumulators, fed by ldmatrix;
// key tiles stream through a two-stage cp.async ring of 32-key tiles, so the
// next tile's load overlaps this tile's products; Q, K and V stay bf16 in
// shared memory (52 KB a block at hd=128, four blocks an SM, where the f32
// tiles took 118 KB and one).  The grid walks a video's query tiles next to
// each other, so its K and V, read once or twice per query tile, come from
// L2 after the first.
//
// Its rounding points are the TPU kernel's (_attention_kernel): f32 logits
// (Q·Kᵀ of bf16 values summed in f32, times 1/√hd, plus the f32 key bias),
// the f32 row max m and the f32 sum l = Σ e of e = exp(logit − m), the
// weights w = e / l formed in f32 and rounded to bf16 where they enter P·V,
// f32 accumulation, and one rounding of the output.  Rounding the
// normalised w needs each row's m and l before the first P·V, so the key
// tiles are walked twice: a first pass forms only Q·Kᵀ and keeps the
// running max and sum (the sum rescaled by exp(m_old − m_new) as the max
// grows), and the second forms Q·Kᵀ again, then w and P·V.  The other
// design, the whole 64 × F f32 score tile kept in shared memory so that
// Q·Kᵀ is formed once, was not taken: it holds only while F ≤ 320 (80 KB,
// with Q, K and V beside it one or two blocks an SM instead of four), and
// every F past it would need this loop anyway; the second Q·Kᵀ costs a
// third more products and an L2 read of K, not device-memory bytes, which
// bound the kernel.  Q·Kᵀ is taken on bf16 Q and scaled after, where the
// f32 kernel scales Q first: the same f32 product up to its last bits; the
// exp is exp2f(x·log2 e), a few f32 ulps from expf, and w is e times the
// row's 1/l (one division a row, not one a weight), within an ulp of e / l:
// either moves a weight's bf16 rounding only where w lies within a few f32
// ulps of a rounding boundary.  hd is
// padded with zero columns to the next of 16, 32, 64 and 128 in shared
// memory (mma's depth is 16).  Where trouble was: the running max starts at
// −inf and masked keys take −1e9 added in f32, so a row with num_frames 0
// still comes out as the mean of V; a partial last key tile is zero-filled.
//
// f32 (masked_attention_kernel, the first port's code, unchanged): f32 FMAs
// on the CUDA cores, since TF32 tensor cores would miss the 1e-5 check;
// nothing is rounded, so dividing by the sum at the end differs from the
// reference's order by f32 rounding alone.
// One block per (query tile of 64 rows, head, video); 256 threads as
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
//  4. P·V: the exp values are summed in f32 (f32 only: nothing is rounded
//     where they enter the product); at the end each row is divided by its
//     sum.  Query rows past F are computed on zeros and not stored.

#include "netvlad_core.cuh"
#include "tensor_core.cuh"

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

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

// ------------------------------------------------ bf16: tensor cores --
//
// One block per (query tile of 64 rows, head, video), 4 warps, warp w owning
// query rows 16w..16w+15 of the tile.  Shared memory, bf16, rows of kHd + 8
// (52 KB at hd=128, so four blocks an SM): the Q tile, then two ring stages
// of (K tile, V tile) of 32 keys each.  The ring walks 2·ntiles steps: step
// i < ntiles brings key tile i's K alone (pass 1), step ntiles + i brings
// its K and V (pass 2), each into stage i mod 2.
//  1. Q and the first two steps' tiles go out as cp.async groups; rows at or
//     past F and columns at or past hd are zero-filled, so no stale shared
//     memory reaches a product (0 · 0 past F, where the weight is 0 too).
//  2. Per step: wait for its group, one barrier, S = Q·Kᵀ (Q's and K's
//     fragments by ldmatrix, K as the col-major B operand), S·(1/√hd) + key
//     bias in f32 (−inf past F, (1 − mask)·(−1e9) below it).  Pass 1: the
//     running row max m and sum l on the accumulator fragments (across the
//     4 lanes of a row by shuffles).  Pass 2: w = exp(S − m) · (1/l) in f32,
//     then O += W·V with W packed to bf16 in registers as the A operand and
//     V by ldmatrix.trans; a 16-key step wholly past F is skipped (its W and
//     V are 0); key tiles never are.  A barrier, then the step two ahead is
//     loaded into the stage just freed.
//  3. O rounded to bf16 into the warp's own rows of the freed ring, then
//     16-byte stores of the rows below F.
// Q's fragments are read again for every key tile rather than kept in
// registers: that holds the kernel to 128 registers a thread, and the four
// blocks an SM it allows hide the latency of each tile's chain of products,
// softmax and products, which is what bounds it at these sizes.

constexpr int kMmaRows = 64;      // query rows per block, 16 per warp
constexpr int kMmaKeys = 32;      // keys per ring tile
constexpr int kMmaThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// e^x for the softmax: exp2f(x·log2 e), MUFU.EX2 and a multiply (the
// difference x is formed first, so a −1e9 logit minus a −1e9 max is 0)
__device__ __forceinline__ float softmax_exp(float x) { return exp2f(x * kLog2e); }
template <int kHd>
constexpr size_t mma_attn_smem_bytes() {  // Q, then two stages of (K, V): 53,248 at 128
  return sizeof(__nv_bfloat16) * (kHd + 8) * (kMmaRows + 4 * kMmaKeys);
}

// rows [r0, r0 + kRows) of one head's columns [0, kHd) (src at the head's
// column 0, rows ld apart) → dst [kRows][kHd + 8], 16 bytes per cp.async;
// rows at or past F and columns at or past hd are zero-filled
template <int kHd, int kRows>
__device__ __forceinline__ void load_tile_async(const __nv_bfloat16* src, long long ld, int r0,
                                                int F, int hd, __nv_bfloat16* dst) {
  constexpr int kChunks = kHd / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r0 + r < F && c < hd;
    cp_async_16(smem_addr(dst + r * (kHd + 8) + c), ok ? src + (long long)(r0 + r) * ld + c : src,
                ok ? 16 : 0);
  }
}

template <int kHd>
__global__ void __launch_bounds__(kMmaThreads, 4)
masked_attention_mma_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ mask,
                            __nv_bfloat16* __restrict__ out, int F, int H, int hd,
                            float inv_sqrt_hd) {
  using bf16 = __nv_bfloat16;
  constexpr int kPitch = kHd + 8, kTile = kMmaKeys * kPitch;
  constexpr int kChunks = kHd / 8;   // 16-byte chunks of a row; also O's 8-wide column tiles
  constexpr int kNJ = kMmaKeys / 8;  // 8-key column tiles of S
  extern __shared__ float4 mma_attn_smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(mma_attn_smem4);
  bf16* kv_s = q_s + kMmaRows * kPitch;  // stage s: K at 2s·kTile, V one tile later
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd;
  const long long ld = 3LL * D;
  const bf16* video = qkv + (long long)b * F * ld + (long long)h * hd;
  const float* mrow = mask + (long long)b * F;
  const int ntiles = (F + kMmaKeys - 1) / kMmaKeys;
  const int nsteps = 2 * ntiles;  // pass 1: K of every tile; pass 2: K and V
  auto load_step = [&](int i) {
    bf16* dst = kv_s + (i & 1) * 2 * kTile;
    const int k0 = (i < ntiles ? i : i - ntiles) * kMmaKeys;
    load_tile_async<kHd, kMmaKeys>(video + D, ld, k0, F, hd, dst);
    if (i >= ntiles) load_tile_async<kHd, kMmaKeys>(video + 2 * D, ld, k0, F, hd, dst + kTile);
  };

  load_tile_async<kHd, kMmaRows>(video, ld, q0, F, hd, q_s);
  load_step(0);
  cp_async_commit();
  load_step(1);  // nsteps >= 2
  cp_async_commit();  // one group per stage, so the wait below is uniform

  // ldmatrix row and column of this lane: A (Q), B from K, B from V (trans)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  float o[kChunks][4];
#pragma unroll
  for (int n = 0; n < kChunks; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8

  for (int it = 0; it < nsteps; ++it) {
    const bool second = it >= ntiles;
    const int k0 = (second ? it - ntiles : it) * kMmaKeys;
    const bf16* k_s = kv_s + (it & 1) * 2 * kTile;
    const bf16* v_s = k_s + kTile;
    float bias[kNJ][2];  // keys k0 + 8j + 2t + e
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        bias[j][e] = key < F ? (1.f - __ldg(mrow + key)) * -1e9f : -INFINITY;
      }
    cp_async_wait<1>();  // this thread's copies of step it (and Q) have landed
    __syncthreads();     // and everyone's

    float s[kNJ][4];  // logits of rows g, g + 8 against keys k0 + 8j + 2t + (0, 1)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kHd / 16; ++ks) {
      uint32_t qa[4];
      ldmatrix_x4(qa, smem_addr(q_s + (warp * 16 + a_row) * kPitch + ks * 16 + a_col));
#pragma unroll
      for (int jp = 0; jp < kNJ / 2; ++jp) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_addr(k_s + (jp * 16 + k_row) * kPitch + ks * 16 + k_col));
        mma_bf16_16816(s[2 * jp], qa, kb[0], kb[1]);
        mma_bf16_16816(s[2 * jp + 1], qa, kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] * inv_sqrt_hd + bias[j][e & 1];

    if (!second) {
      // pass 1: running max and sum of rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * rh], s[j][2 * rh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rh], mx);  // finite: every tile holds a key below F
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          rs += softmax_exp(s[j][2 * rh] - m_new) + softmax_exp(s[j][2 * rh + 1] - m_new);
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[rh] = l[rh] * softmax_exp(m[rh] - m_new) + rs;
        m[rh] = m_new;
      }
    } else {
      // pass 2: w = e · (1/l) in f32, rounded to bf16 as the A operand of W·V
      const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = softmax_exp(s[j][e] - m[e >> 1]) * inv_l[e >> 1];
#pragma unroll
      for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
        if (k0 + 16 * kk >= F) break;
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < kHd / 16; ++dp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, smem_addr(v_s + (16 * kk + v_row) * kPitch + dp * 16 + v_col));
          mma_bf16_16816(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (it + 2 < nsteps) load_step(it + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // rows g, g + 8 of this warp: O rounded once, staged in the ring
  // (free after the last barrier; warp w its own rows 16w..16w+15), then
  // stored 16 bytes at a time
  bf16* o_s = kv_s + warp * 16 * kPitch;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh)
#pragma unroll
    for (int n = 0; n < kChunks; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o_s + (g + 8 * rh) * kPitch + 8 * n + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * rh], o[n][2 * rh + 1]);
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < F && c < hd)
      *reinterpret_cast<uint4*>(out + ((long long)b * F + row) * D + (long long)h * hd + c) =
          *reinterpret_cast<const uint4*>(o_s + r * kPitch + c);
  }
}

template <int kHd>
cudaError_t launch_masked_attention_mma(const __nv_bfloat16* qkv, const float* mask,
                                        __nv_bfloat16* out, int B, int F, int H, int hd,
                                        cudaStream_t stream) {
  constexpr size_t bytes = mma_attn_smem_bytes<kHd>();
  cudaError_t err = cudaFuncSetAttribute(masked_attention_mma_kernel<kHd>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)  // room for four blocks an SM
    err = cudaFuncSetAttribute(masked_attention_mma_kernel<kHd>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kMmaRows - 1) / kMmaRows, H, B);
  masked_attention_mma_kernel<kHd><<<grid, kMmaThreads, bytes, stream>>>(
      qkv, mask, out, F, H, hd, 1.f / sqrtf((float)hd));
  return cudaGetLastError();
}

cudaError_t run_masked_attention(const __nv_bfloat16* qkv, const float* mask, __nv_bfloat16* out,
                                 int B, int F, int H, int hd, cudaStream_t stream) {
  if (hd <= 16) return launch_masked_attention_mma<16>(qkv, mask, out, B, F, H, hd, stream);
  if (hd <= 32) return launch_masked_attention_mma<32>(qkv, mask, out, B, F, H, hd, stream);
  if (hd <= 64) return launch_masked_attention_mma<64>(qkv, mask, out, B, F, H, hd, stream);
  return launch_masked_attention_mma<128>(qkv, mask, out, B, F, H, hd, stream);
}

cudaError_t run_masked_attention(const float* qkv, const float* mask, float* out, int B, int F,
                                 int H, int hd, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(masked_attention_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kAttnSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kAttnRows - 1) / kAttnRows, H, B);
  masked_attention_kernel<float><<<grid, kAttnThreads, kAttnSmemBytes, stream>>>(
      qkv, mask, out, F, H, hd, sqrtf((float)hd));
  return cudaGetLastError();
}

}  // namespace lpm

extern "C" int lpm_masked_attention(const void* qkv, const void* mask, void* out, int is_bf16,
                                    int B, int F, int H, int hd, void* stream) {
  if (B < 1 || B > 65535 || F < 1 || H < 1 || H > 65535 || hd < 8 || hd > lpm::kAttnMaxHd ||
      hd % 8)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    err = lpm::run_masked_attention(static_cast<const bf16*>(qkv), m, static_cast<bf16*>(out), B,
                                    F, H, hd, st);
  } else {
    err = lpm::run_masked_attention(static_cast<const float*>(qkv), m, static_cast<float*>(out),
                                    B, F, H, hd, st);
  }
  return (int)err;
}
