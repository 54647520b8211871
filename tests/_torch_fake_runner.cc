// A host-only stand-in for the native runner's C API
// (learnablepoolingmethods_torch/csrc/native_runner.cu), so that the CPU
// tests can build and drive the port's lpm_serve with g++ alone.  Each row's
// top-k is a fixed function of that row as the server parsed and padded it:
//
//   s    = the sum of the row's max_frames × width uint8 bytes, or for a
//          video-level artifact the sum of ⌊256 · x⌋ over its width f32
//          features (exact: 256 · x is x's exponent moved)
//   base = s mod 9973 + 17 · num_frames (no frame counts: 0)
//   classes[j] = (base + 7 j) mod 97,  scores[j] = base / 2¹⁴ − j / 64
//
// (exact in f32), so a row that is misparsed, mis-padded or answered to the
// wrong request shows; tests/test_torch_native_serve.py computes the same
// from the Python parser's rows.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include "native_manifest.h"

namespace {

struct Fake {
  int64_t batch = 0, row_elems = 0, k = 0;
  bool video_level = false;
  long long runs = 0;
};

}  // namespace

extern "C" {

void* lpm_runner_load(const char* export_dir, int /*device*/, char* err, long long err_cap) {
  lpm_native::Manifest m;
  std::string msg;
  if (!lpm_native::LoadManifest(export_dir, &m, &msg)) {
    snprintf(err, static_cast<size_t>(err_cap), "%s", msg.c_str());
    return nullptr;
  }
  auto* f = new Fake();
  f->batch = m.batch_size;
  f->video_level = m.frame_features == 0;
  f->row_elems = (f->video_level ? 1 : static_cast<int64_t>(m.max_frames)) * m.total_size();
  f->k = m.outputs[0].dims[1];
  return f;
}

int lpm_runner_run(void* handle, const void* features, const void* num_frames, void* values,
                   void* indices, char* /*err*/, long long /*err_cap*/) {
  auto* f = static_cast<Fake*>(handle);
  const auto* x = static_cast<const uint8_t*>(features);
  const auto* xf = static_cast<const float*>(features);
  const auto* nf = static_cast<const int32_t*>(num_frames);
  for (int64_t b = 0; b < f->batch; ++b) {
    int64_t s = 0;
    for (int64_t i = 0; i < f->row_elems; ++i) {
      const int64_t at = b * f->row_elems + i;
      s += f->video_level ? static_cast<int64_t>(std::floor(256.0f * xf[at])) : x[at];
    }
    s = ((s % 9973) + 9973) % 9973;
    const int64_t base = s + 17 * static_cast<int64_t>(nf ? nf[b] : 0);
    for (int64_t j = 0; j < f->k; ++j) {
      static_cast<int32_t*>(indices)[b * f->k + j] = static_cast<int32_t>((base + 7 * j) % 97);
      static_cast<float*>(values)[b * f->k + j] =
          static_cast<float>(base) / 16384.0f - static_cast<float>(j) / 64.0f;
    }
  }
  f->runs++;
  return 0;
}

}  // extern "C"
