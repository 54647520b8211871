// Weight-only int8 matrix product (W8A16) for Hopper:
//
//   y[m, n] = (Σ_k bf16(x[m, k]) · bf16(q[k, n])) · s[n]  (+ b[n])     f32
//
// Replaces learnablepoolingmethods_tpu/ops/int8_matmul.py#matmul_wi8, which
// the JAX package leaves to XLA (no pallas_call): XLA fuses the s8 → bf16
// convert into the dot's operand stream, so no bf16 copy of the weight is
// written.  Here the weight is converted in registers on its way into the
// tensor cores and never widened in memory.
//
// Bound: operations at large M (2·M·K·N at 989 TFLOP/s: 0.278 ms for the
// Willow FC at M = 512), bytes at small M (the K·N int8 weight: 268 MB,
// about 0.08 ms at M = 1 or 32).
//
// Design: yᵀ = Wᵀ · xᵀ on wgmma, the weight as its A operand from registers.
//  - The weight is stored n-major, wt [N, Kp] int8 with Kp = K rounded up to
//    64 (zeros past K), and each 64-deep block of a row permuted
//    (ops/int8_matmul.py#device_weight, K_ORDER): byte 16t + 4s + j holds
//    k = 16s + 2t + (j & 1) + 8(j >> 1), so that the thread of a warp with
//    t = lane % 4 finds its A fragments of all four k16 steps (k 2t, 2t+1,
//    2t+8, 2t+9 of rows g and g + 8, g = lane / 4) in one 16-byte load a row.
//  - A block is two consumer warpgroups and a producer warpgroup, which
//    hands its registers to the consumers (setmaxnreg); one of its threads
//    keeps a ring of kStages stages in flight by TMA
//    (cp.async.bulk.tensor, mbarriers with expected bytes): a stage is the
//    [256 rows of n, 64 of k] int8 weight tile (no swizzle) and the
//    [Nw rows of m, 64 of k] bf16 x tile (128-byte swizzle, wgmma's B
//    operand, K-major, read through a shared-memory descriptor).  TMA fills
//    what lies past M, N or K with zeros.
//  - Each consumer warpgroup owns 128 rows of n (two m64 tiles) × the
//    block's Nw batch columns: per stage each thread loads its four 16-byte
//    fragments, converts the int8 bytes to bf16 in registers (exact:
//    2²³-biased floats, then cvt), and issues 8 wgmma m64nNwk16; no
//    converted tile is written to shared memory.  One step's products stay
//    in flight while the next step's are issued, and the next stage's
//    fragments are loaded and converted meanwhile (two register sets).
//    Accumulation is f32.
//  - The batch lies on wgmma's N: Nw is the least of 8, 16, 32, 64, 128 that
//    holds M (128 past it), so B = 1 or 32 take a narrow tile.
//  - M ≤ 512 and N = 1024 give at most 16 output tiles for 132 SMs over K up
//    to 262,144, so K is split into ranges of kb_per_split steps (about
//    one block an SM, one wave): each split writes its f32 partial [M, N],
//    and a second launch sums the splits in their order (a fixed order, no
//    atomics, so a second call equals the first bit for bit) and applies the
//    scale, then the bias.  With one split the first launch writes y itself.
//    ops/int8_matmul.py#int8_geometry mirrors the tiles and the split
//    (lpm_int8_matmul_tile gives the library's).
// The weight stays wgmma's A operand from registers (not a converted,
// swizzled B tile in shared memory): nothing converted is written back, and
// a small batch takes a narrow N.  What bounds it now at B = 256 and 512 is
// the L2 → SM traffic: a block reads 32 KB of tiles a k-step for 4.2 MFLOP
// (x re-read by the four n tiles, the weight by the four m tiles), the
// least a block of 256 × 128 f32 accumulators can read; clusters that
// multicast the x tile would cut it; tried, they ran slower and some
// cluster launches were refused (PERF.md).
// x [M, K] bf16 row-major, K % 8 == 0, 16-byte aligned (the wrapper sees to
// it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "tensor_core.cuh"

namespace lpm {

constexpr int kBN = 256, kBK = 64, kStages = 6;
constexpr int kConsumers = 2;                       // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;    // + the producer warpgroup
// registers a thread after setmaxnreg: the producer gives its own to the
// consumers' accumulators (2 · 128 · 232 + 128 · 40 ≤ 65,536)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kWBytes = kBN * kBK;                  // an int8 weight tile
constexpr int kMaxNw = 128;
constexpr int kSms = 132;

template <int Nw>
__host__ __device__ constexpr int x_bytes() { return Nw * kBK * 2; }
template <int Nw>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + kStages * (x_bytes<Nw>() + kWBytes) + 2 * kStages * 8;
}

// a byte of a signed int8 as an exact f32: 2²³ + (v + 128) − (2²³ + 128)
__device__ __forceinline__ float s8_to_f(uint32_t byte) {
  return __uint_as_float(0x4B000000u | ((byte & 0xFFu) ^ 0x80u)) - 8388736.0f;
}

// bytes 0, 1 (and 2, 3) of a word → a register of two bf16, the lower byte low
__device__ __forceinline__ uint32_t s8_lo_bf16x2(uint32_t w) {
  return pack_bf16(s8_to_f(w), s8_to_f(w >> 8));
}
__device__ __forceinline__ uint32_t s8_hi_bf16x2(uint32_t w) {
  return pack_bf16(s8_to_f(w >> 16), s8_to_f(w >> 24));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a 2-D TMA copy of the box at (c0 innermost, c1) into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// the descriptor of a K-major bf16 tile of 128-byte rows, 128-byte swizzle
// (8-row groups 1024 bytes apart), starting at the byte address `addr`
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d[64 × Nw] += A[64 × 16] (bf16 fragments in registers) · B[16 × Nw]
// (the descriptor's tile), f32
template <int Nw>
__device__ __forceinline__ void wgmma_rs(float (&d)[Nw / 2], const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// a stage's A fragments of this thread: rows row0 + i·64 (+ 8), bytes
// 16t..16t+15 of each (all four k16 steps), int8 → bf16 in registers
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4][4], const unsigned char* wt, int row0, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 lo = *reinterpret_cast<const uint4*>(wt + (row0 + i * 64) * kBK + 16 * t);
    const uint4 hi = *reinterpret_cast<const uint4*>(wt + (row0 + i * 64 + 8) * kBK + 16 * t);
    const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w}, h[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      a[i][ks][0] = s8_lo_bf16x2(l[ks]);  // row g,     k 2t, 2t+1
      a[i][ks][1] = s8_lo_bf16x2(h[ks]);  // row g + 8, k 2t, 2t+1
      a[i][ks][2] = s8_hi_bf16x2(l[ks]);  // row g,     k 2t+8, 2t+9
      a[i][ks][3] = s8_hi_bf16x2(h[ks]);  // row g + 8, k 2t+8, 2t+9
    }
  }
}

// k-step `it`: its 8 products from `cur` (converted before) join the
// previous step's in flight; once those are done, that step's stage is
// released and its fragments' registers take the next stage's, converted
// while this step's products run
template <int Nw>
__device__ __forceinline__ void consume(float (&acc)[2][Nw / 2], uint32_t (&cur)[2][4][4],
                                        uint32_t (&nxt)[2][4][4], int it, int nk,
                                        unsigned char* xs, unsigned char* ws, uint64_t* full,
                                        uint64_t* empty, int row0, int t, int lane) {
  const int s = it % kStages;
  const uint32_t xaddr = smem_addr(xs + s * x_bytes<Nw>());
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < Nw / 2; ++r) fence_operand(acc[i][r]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 2; ++i) wgmma_rs<Nw>(acc[i], cur[i][ks], desc_sw128(xaddr + ks * 32));
  wgmma_commit();
  wgmma_wait<1>();  // the previous step's products are done
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) fence_reg(nxt[i][ks][r]);  // read by those products until here
  __syncwarp();
  if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
  if (it + 1 < nk) {
    const int s1 = (it + 1) % kStages;
    mbar_wait(&full[s1], ((it + 1) / kStages) & 1);
    __syncwarp();
    load_a(nxt, ws + s1 * kWBytes, row0, t);
  }
}

template <int Nw>
__global__ void __launch_bounds__(kThreads, 1)
w8a16_kernel(const __grid_constant__ CUtensorMap map_w, const __grid_constant__ CUtensorMap map_x,
             const float* __restrict__ scale, const float* __restrict__ bias, float* __restrict__ out,
             int M, int N, int K, int kb_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* xs = smem;                                  // [kStages][Nw][64] bf16, swizzled
  unsigned char* ws = xs + kStages * x_bytes<Nw>();          // [kStages][256][64] int8
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + kStages * kWBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * Nw, split = blockIdx.z;
  const int kb_total = (K + kBK - 1) / kBK;
  const int kb0 = split * kb_per_split;
  const int nk = min(kb0 + kb_per_split, kb_total) - kb0;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {  // the producer warpgroup: one thread issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers * 4 && lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], kWBytes + x_bytes<Nw>());
        const int k0 = (kb0 + it) * kBK;
        tma_load_2d(ws + s * kWBytes, &map_w, k0, n0, &full[s]);
        tma_load_2d(xs + s * x_bytes<Nw>(), &map_x, k0, m0, &full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
  float acc[2][Nw / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < Nw / 2; ++r) acc[i][r] = 0.0f;
  // this thread's weight rows in a tile: wg·128 + i·64 + wi·16 + g (+ 8)
  const int row0 = wg * 128 + wi * 16 + g;
  // two sets of A fragments: the next stage's are converted while the
  // products of this one run
  uint32_t a0[2][4][4], a1[2][4][4];
  if (nk > 0) {
    mbar_wait(&full[0], 0);
    __syncwarp();
    load_a(a0, ws, row0, t);
  }
  for (int it = 0; it < nk; it += 2) {
    consume<Nw>(acc, a0, a1, it, nk, xs, ws, full, empty, row0, t, lane);
    if (it + 1 < nk) consume<Nw>(acc, a1, a0, it + 1, nk, xs, ws, full, empty, row0, t, lane);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < Nw / 2; ++r) fence_operand(acc[i][r]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        fence_reg(a0[i][ks][r]);
        fence_reg(a1[i][ks][r]);
      }
  }

  // D fragment: acc[i][4j + r] is (n row g + 8(r >> 1), batch column 8j + 2t + (r & 1))
  const bool final_out = gridDim.z == 1;
  float* dst = final_out ? out : out + (long long)split * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + row0 + i * 64 + 8 * h;
      if (n >= N) continue;
      const float sc = final_out ? scale[n] : 1.0f;
      const float bi = final_out && bias != nullptr ? bias[n] : 0.0f;
#pragma unroll
      for (int j = 0; j < Nw / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int m = m0 + 8 * j + 2 * t + c;
          if (m >= M) continue;
          float v = acc[i][4 * j + 2 * h + c];
          if (final_out) {
            v = __fmul_rn(v, sc);
            if (bias != nullptr) v = __fadd_rn(v, bi);
          }
          dst[(long long)m * N + n] = v;
        }
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

// the least batch tile that holds M, the widest past it
int batch_tile(int M) {
  for (int nw = 8; nw < kMaxNw; nw *= 2)
    if (M <= nw) return nw;
  return kMaxNw;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no link to libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// a row-major [rows, cols] tensor's 2-D map with boxes of [box_rows, box_cols]
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base,
                long long rows, long long cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int Nw>
cudaError_t launch_w8a16(const CUtensorMap& map_w, const CUtensorMap& map_x, const float* sc,
                         const float* bi, float* first, int M, int N, int K, int splits,
                         int kb_per_split, cudaStream_t s) {
  static std::once_flag once;
  static cudaError_t configured = cudaSuccess;
  std::call_once(once, [] {
    configured = cudaFuncSetAttribute(w8a16_kernel<Nw>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem_bytes<Nw>());
  });
  if (configured != cudaSuccess) return configured;
  dim3 grid((N + kBN - 1) / kBN, (M + Nw - 1) / Nw, splits);
  w8a16_kernel<Nw><<<grid, kThreads, smem_bytes<Nw>(), s>>>(map_w, map_x, sc, bi, first, M, N, K,
                                                             kb_per_split);
  return cudaGetLastError();
}

}  // namespace lpm

using namespace lpm;

extern "C" {

// y [M, N] f32 = x [M, K] bf16 · the int8 weight wt [N, Kp] (device_weight's
// layout, Kp = K rounded up to 64) × scale (+ bias); partials [splits, M, N]
// f32 scratch (unused at one split); bias may be null.
int lpm_int8_matmul(const void* x, const void* wt, const void* scale, const void* bias, void* y,
                    void* partials, int M, int N, int K, int splits, int kb_per_split,
                    void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 != 0 || splits < 1 || kb_per_split < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wt) % 16 != 0 ||
      (long long)(splits - 1) * kb_per_split >= (K + kBK - 1) / kBK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw = batch_tile(M);
  const long long kp = (K + kBK - 1) / kBK * (long long)kBK;
  CUtensorMap map_w, map_x;
  if (!tensor_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wt, N, kp, kBN, kBK,
                  CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, nw, kBK,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* first = splits == 1 ? static_cast<float*>(y) : static_cast<float*>(partials);
  cudaError_t e;
  switch (nw) {
    case 8: e = launch_w8a16<8>(map_w, map_x, sc, bi, first, M, N, K, splits, kb_per_split, s); break;
    case 16: e = launch_w8a16<16>(map_w, map_x, sc, bi, first, M, N, K, splits, kb_per_split, s); break;
    case 32: e = launch_w8a16<32>(map_w, map_x, sc, bi, first, M, N, K, splits, kb_per_split, s); break;
    case 64: e = launch_w8a16<64>(map_w, map_x, sc, bi, first, M, N, K, splits, kb_per_split, s); break;
    default: e = launch_w8a16<128>(map_w, map_x, sc, bi, first, M, N, K, splits, kb_per_split, s);
  }
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long mn = (long long)M * N;
  splitk_reduce_kernel<<<(unsigned int)((mn + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partials), sc, bi, static_cast<float*>(y), M, N, splits);
  return (int)cudaGetLastError();
}

// the kernel's tiles for ops/int8_matmul.py#int8_geometry: the weight rows
// a block (kBN), the k-step (kBK), the widest batch tile, the SMs a wave
void lpm_int8_matmul_tile(int* out) {
  out[0] = kBN;
  out[1] = kBK;
  out[2] = kMaxNw;
  out[3] = kSms;
}

}  // extern "C"
