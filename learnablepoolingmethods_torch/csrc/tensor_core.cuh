// Warp-level tensor-core and asynchronous-copy primitives for the bf16
// kernels (masked_attention.cu, softdbow_fused.cu), as inline PTX for sm_90a:
//
//  - mma_bf16_16816: mma.sync.aligned.m16n8k16, bf16 operands, f32
//    accumulators.  Fragments, with g = lane / 4 and t = lane % 4:
//      A (16×16, row-major)  a0 (g, 2t..2t+1)   a1 (g+8, 2t..)
//                            a2 (g, 2t+8..)     a3 (g+8, 2t+8..)
//      B (16×8, k × n)       b0 (k 2t..2t+1, n g)   b1 (k 2t+8.., n g)
//      C (16×8)              c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..)
//    each 32-bit register holding two bf16 values, the lower column (or k)
//    in its low half;
//  - ldmatrix_x4 / ldmatrix_x4_trans: four 8×8 bf16 matrices from shared
//    memory, lanes 8i..8i+7 giving the row addresses of matrix i;
//  - cp_async_16: a 16-byte global → shared copy that bypasses the
//    registers and L1, with zero fill when src_bytes < 16 (0: no read);
//    cp_async_4 the same for 4 bytes (native_runner.cu's pool_attention
//    at a head width that is not a multiple of 4).
//
// Shared-memory tiles read by ldmatrix keep a row pitch of (width + 8) bf16,
// an odd number of 16-byte chunks, so the eight row addresses of one 8×8
// matrix fall on eight different 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace lpm {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// a 4-byte copy (cached at all levels), zero fill when src_bytes is 0
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two f32 values → one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace lpm
