// Kaggle-CSV line formatter (ref: inference.py#format_lines).
//
// The inference CLI writes its CSV through this formatter, which emits
// format_lines' bytes ("%.6f" scores, as Python's f"{v:.6f}": both
// correctly rounded double formatting) without a Python string per
// pair.  Compiled into one library with the record parser.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// fast integer → ascii; returns chars written
inline int write_int(char* out, int64_t v) {
  if (v == 0) {
    out[0] = '0';
    return 1;
  }
  char tmp[20];
  int n = 0;
  bool neg = v < 0;
  uint64_t u = neg ? -static_cast<uint64_t>(v) : static_cast<uint64_t>(v);
  while (u) {
    tmp[n++] = '0' + static_cast<char>(u % 10);
    u /= 10;
  }
  int w = 0;
  if (neg) out[w++] = '-';
  while (n) out[w++] = tmp[--n];
  return w;
}

}  // namespace

extern "C" {

// Format n rows of top-k predictions into CSV lines:
//   "<video_id>,<idx> <score> <idx> <score>...\n"
// video_ids: n * id_width bytes, NUL-padded.
// values:    n*k float32, indices: n*k int32.
// out:       caller buffer of out_cap bytes.
// Returns bytes written, or -1 if out_cap would be exceeded.
int64_t lpm_format_csv(int64_t n, int32_t k, const char* video_ids,
                       int32_t id_width, const float* values,
                       const int32_t* indices, char* out, int64_t out_cap) {
  // per-pair budget: 2 separators + int (<=11) + score (<=39 chars, i.e.
  // %.6f of |v| < ~1e32); larger magnitudes are rejected, not truncated
  constexpr int64_t kPairBudget = 56;
  constexpr int kScoreMax = 40;
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (pos + id_width + 2 + static_cast<int64_t>(k) * kPairBudget > out_cap)
      return -1;
    const char* vid = video_ids + i * id_width;
    int len = static_cast<int>(strnlen(vid, id_width));
    memcpy(out + pos, vid, len);
    pos += len;
    out[pos++] = ',';
    for (int32_t j = 0; j < k; ++j) {
      if (j) out[pos++] = ' ';
      pos += write_int(out + pos, indices[i * k + j]);
      out[pos++] = ' ';
      // %.6f of the float32 value promoted to double — matches Python's
      // f"{float(v):.6f}" (both correctly-rounded decimal of the double)
      int w = snprintf(out + pos, kScoreMax, "%.6f",
                       static_cast<double>(values[i * k + j]));
      if (w < 0 || w >= kScoreMax) return -2;  // would truncate: reject
      pos += w;
    }
    out[pos++] = '\n';
  }
  return pos;
}

}  // extern "C"
