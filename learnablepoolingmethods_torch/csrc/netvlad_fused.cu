// Fused NetVLAD on prepared frames: x [B, S, D] (bf16 or f32, rows of
// stride ldx) → [B, D, K] in x's type, with the assignment BN folded into
// scale/bias.
//
// Replaces the TPU kernel learnablepoolingmethods_tpu/ops/netvlad_pallas.py
// #netvlad_fused (kernel body _netvlad_kernel), which computes the whole
// chain for one video in VMEM per grid step.  The fast path's staged route
// (presampled input, fuse_frontend=False, or a compute dtype other than
// bf16), NetRVLAD (zero C₂) and AttentionNetVLAD (F=300) call it.
//
// What bounds it here: at Willow rgb shapes (B=512, S=30, D=1024, K=256)
// it reads 31 MB of bf16 frames and writes 268 MB of bf16 descriptors
// (80 µs at 3.35 TB/s) while doing 8 GFLOP of logits and 8 GFLOP of
// aggregation (16 µs at 989 TFLOP/s of bf16 tensor cores, where the
// aggregation keeps f32 accuracy by splitting A into bf16 terms), so the
// bytes are the bound.
//
// bf16 (every main path): two launches on tensor cores, the logits with the
// softmax as epilogue and one aggregation pass per video in a thread-block
// cluster (two passes for shapes no portable cluster covers); see
// netvlad_tc.cuh.  f32: the first port's FMA code, three launches (logits,
// a pass that sums Σ_d vlad², a pass that recomputes and writes), since
// TF32 tensor cores would miss the 1e-5 check; see netvlad_core.cuh.
// Strided rows let the caller pass the rgb and audio column slices of one
// [B, S, DT] tensor without a copy.

#include "netvlad_tc.cuh"

// two_pass (bf16 only) forces the two-pass aggregation on a shape that the
// one-pass cluster kernel covers, to time both designs.  ws_colsq holds
// B·⌈D/1024⌉·K floats.
extern "C" int lpm_netvlad_fused(const void* x, long long ldx, int x_is_bf16, const void* c,
                                 const void* scale, const void* bias, const void* c2,
                                 void* out, void* ws_a, void* ws_colsq, int B, int S, int D,
                                 int K, int two_pass, void* stream) {
  cudaError_t err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* cc2 = static_cast<const float*>(c2);
  float* wa = static_cast<float*>(ws_a);
  float* wc = static_cast<float*>(ws_colsq);
  if (x_is_bf16) {
    using bf16 = __nv_bfloat16;
    err = lpm::run_netvlad_tc(static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(c), sc,
                              bi, cc2, static_cast<bf16*>(out), wa, wc, B, S, D, K,
                              two_pass != 0, st);
  } else {
    err = lpm::run_netvlad<float>(static_cast<const float*>(x), ldx,
                                  static_cast<const float*>(c), sc, bi, cc2,
                                  static_cast<float*>(out), wa, wc, B, S, D, K, st);
  }
  return (int)err;
}

// The bf16 aggregation's tiling of a (D, K) shape, as tc_geometry picks it:
// out[0..6] = ds, cs, kc, ktiles, dchunks, one_pass, threads.
extern "C" void lpm_netvlad_geometry(int D, int K, int* out) {
  const lpm::TaGeometry g = lpm::tc_geometry(D, K);
  const int v[7] = {g.ds, g.cs, g.kc, g.ktiles, g.dchunks, g.one_pass, g.threads};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}
