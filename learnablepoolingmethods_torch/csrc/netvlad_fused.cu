// Fused NetVLAD on prepared frames: x [B, S, D] (bf16 or f32, rows of
// stride ldx) → [B, D, K] in x's type, with the assignment BN folded into
// scale/bias.
//
// Replaces the TPU kernel learnablepoolingmethods_tpu/ops/netvlad_pallas.py
// #netvlad_fused (kernel body _netvlad_kernel), which computes the whole
// chain for one video in VMEM per grid step.  The fast path's staged route
// (presampled input, fuse_frontend=False, or a compute dtype other than
// bf16) calls it once for rgb and once for audio.
//
// What bounds it here: at Willow rgb shapes (B=512, S=30, D=1024, K=256)
// it reads 31 MB of bf16 frames and writes 268 MB of bf16 descriptors
// (80 µs at 3.35 TB/s) while doing 8 GFLOP of logits and 8 GFLOP of
// aggregation (16 µs at 989 TFLOP/s of bf16 tensor cores, where the
// aggregation keeps f32 accuracy by splitting A into bf16 terms), so the
// bytes are the bound.  This simple version does its products as f32 FMAs
// on the CUDA cores, far above that bound.
//
// Design: the chain is cut into three launches (logits+softmax GEMM over
// all B·S rows, a per-cluster-tile pass that sums Σ_d vlad², and a pass
// that recomputes the tile and writes it normalised), so that no block
// waits on another and no f32 [B, D, K] tensor reaches device memory; see
// netvlad_core.cuh.  Strided rows let the caller pass the rgb and audio
// column slices of one [B, S, DT] tensor without a copy.

#include "netvlad_core.cuh"

extern "C" int lpm_netvlad_fused(const void* x, long long ldx, int x_is_bf16, const void* c,
                                 const void* scale, const void* bias, const void* c2,
                                 void* out, void* ws_a, void* ws_colsq, int B, int S, int D,
                                 int K, void* stream) {
  cudaError_t err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* cc2 = static_cast<const float*>(c2);
  float* wa = static_cast<float*>(ws_a);
  float* wc = static_cast<float*>(ws_colsq);
  if (x_is_bf16) {
    using bf16 = __nv_bfloat16;
    err = lpm::run_netvlad<bf16>(static_cast<const bf16*>(x), ldx,
                                 static_cast<const bf16*>(c), sc, bi, cc2,
                                 static_cast<bf16*>(out), wa, wc, B, S, D, K, st);
  } else {
    err = lpm::run_netvlad<float>(static_cast<const float*>(x), ldx,
                                  static_cast<const float*>(c), sc, bi, cc2,
                                  static_cast<float*>(out), wa, wc, B, S, D, K, st);
  }
  return (int)err;
}
