// Native YT-8M TFRecord batch loader.
//
// The reference feeds TF's C++ kernels through queue runners
// (ref: readers.py + tf.TFRecordReader); this rebuild's equivalent native
// component parses TFRecord framing + the tf.Example / tf.SequenceExample
// wire format directly into the packed arrays that batches are sliced from:
//   frames     uint8  [N, max_frames, total_size]   (quantized, pad/truncate)
//   num_frames int32  [N]
//   labels     float  [N, num_classes]              (multi-hot)
//   video_ids  char   [N, id_width]                 (NUL-padded)
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).  The Python
// binding (learnablepoolingmethods_torch/data/native_loader.py) calls one
// file per invocation; ctypes releases the GIL for the call's duration, so
// a Python ThreadPool gets true multi-core parse parallelism.
//
// The wire-format logic mirrors the executable spec in
// learnablepoolingmethods_torch/data/tfrecord_io.py (same field numbers,
// same semantics); tests cross-validate all three parsers (this, the
// Python one, and TensorFlow's).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Span {
  const uint8_t* p;
  size_t n;
};

// --- varint / wire helpers -------------------------------------------------

inline bool read_varint(Span& s, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (s.n > 0) {
    uint8_t b = *s.p;
    s.p++;
    s.n--;
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// Iterate protobuf fields in a message span. Calls fn(field, wire, payload).
// wire 0 payload: 8-byte little varint value stored in val; wire 2: span.
template <typename Fn>
bool for_each_field(Span msg, Fn&& fn) {
  while (msg.n > 0) {
    uint64_t tag;
    if (!read_varint(msg, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 0x7);
    if (wire == 0) {
      uint64_t v;
      if (!read_varint(msg, &v)) return false;
      fn(field, wire, Span{reinterpret_cast<const uint8_t*>(&v), 8}, v);
    } else if (wire == 2) {
      uint64_t len;
      if (!read_varint(msg, &len) || len > msg.n) return false;
      fn(field, wire, Span{msg.p, static_cast<size_t>(len)}, 0);
      msg.p += len;
      msg.n -= len;
    } else if (wire == 5) {
      if (msg.n < 4) return false;
      fn(field, wire, Span{msg.p, 4}, 0);
      msg.p += 4;
      msg.n -= 4;
    } else if (wire == 1) {
      if (msg.n < 8) return false;
      fn(field, wire, Span{msg.p, 8}, 0);
      msg.p += 8;
      msg.n -= 8;
    } else {
      return false;
    }
  }
  return true;
}

// --- tf.train.Feature ------------------------------------------------------

struct FeatureView {
  std::vector<Span> bytes_list;
  std::vector<float> float_list;
  std::vector<int64_t> int64_list;
};

bool parse_feature(Span f, FeatureView* out) {
  return for_each_field(f, [&](uint32_t field, uint32_t wire, Span val, uint64_t iv) {
    if (field == 1 && wire == 2) {  // BytesList
      for_each_field(val, [&](uint32_t f2, uint32_t w2, Span v2, uint64_t) {
        if (f2 == 1 && w2 == 2) out->bytes_list.push_back(v2);
      });
    } else if (field == 2 && wire == 2) {  // FloatList
      for_each_field(val, [&](uint32_t f2, uint32_t w2, Span v2, uint64_t) {
        if (f2 == 1 && w2 == 2) {  // packed
          size_t cnt = v2.n / 4;
          size_t base = out->float_list.size();
          out->float_list.resize(base + cnt);
          memcpy(out->float_list.data() + base, v2.p, cnt * 4);
        } else if (f2 == 1 && w2 == 5) {
          float x;
          memcpy(&x, v2.p, 4);
          out->float_list.push_back(x);
        }
      });
    } else if (field == 3 && wire == 2) {  // Int64List
      for_each_field(val, [&](uint32_t f2, uint32_t w2, Span v2, uint64_t v) {
        if (f2 == 1 && w2 == 2) {  // packed varints
          Span inner = v2;
          uint64_t x;
          while (inner.n > 0 && read_varint(inner, &x))
            out->int64_list.push_back(static_cast<int64_t>(x));
        } else if (f2 == 1 && w2 == 0) {
          out->int64_list.push_back(static_cast<int64_t>(v));
        }
      });
    }
  });
}

// Find named entries in a Features map (field 1 = map entry {1: key, 2: Feature}).
template <typename Fn>
bool for_each_features_entry(Span features, Fn&& fn) {
  return for_each_field(features, [&](uint32_t field, uint32_t wire, Span val, uint64_t) {
    if (field == 1 && wire == 2) {
      Span key{nullptr, 0}, feat{nullptr, 0};
      for_each_field(val, [&](uint32_t f2, uint32_t w2, Span v2, uint64_t) {
        if (f2 == 1 && w2 == 2) key = v2;
        else if (f2 == 2 && w2 == 2) feat = v2;
      });
      if (key.p) fn(key, feat);
    }
  });
}

inline bool span_eq(Span s, const char* str) {
  size_t n = strlen(str);
  return s.n == n && memcmp(s.p, str, n) == 0;
}

void write_id(Span id, char* out, int32_t id_width) {
  size_t n = id.n < static_cast<size_t>(id_width) ? id.n : id_width;
  memset(out, 0, id_width);
  if (id.p) memcpy(out, id.p, n);
}

void write_labels(const std::vector<int64_t>& labels, float* out, int32_t num_classes) {
  memset(out, 0, sizeof(float) * num_classes);
  for (int64_t l : labels)
    if (l >= 0 && l < num_classes) out[l] = 1.0f;
}

// Feature-name layout shared by the file loops and the per-record entry
// points (the serving binary parses single HTTP-posted records).
struct FeatureSpec {
  std::vector<const char*> names;
  const int32_t* sizes;
  int32_t n_features;
  int32_t total_size;
};

FeatureSpec make_spec(const int32_t* feature_sizes, int32_t n_features,
                      const char* feature_names) {
  FeatureSpec spec;
  spec.sizes = feature_sizes;
  spec.n_features = n_features;
  spec.total_size = 0;
  spec.names.resize(n_features);
  const char* cur = feature_names;
  for (int i = 0; i < n_features; i++) {
    spec.names[i] = cur;
    cur += strlen(cur) + 1;
    spec.total_size += feature_sizes[i];
  }
  return spec;
}

// One SequenceExample record → zero-padded [max_frames, total] uint8 row.
// Returns min-over-features frame count (clamped to max_frames), 0 if the
// record has no recognized feature lists.
int32_t parse_frame_record(Span record, int32_t max_frames,
                           const FeatureSpec& spec, uint8_t* frames_out,
                           Span* id_out, std::vector<int64_t>* labels_out) {
  Span context{nullptr, 0}, feature_lists{nullptr, 0};
  for_each_field(record, [&](uint32_t field, uint32_t wire, Span val, uint64_t) {
    if (field == 1 && wire == 2) context = val;
    else if (field == 2 && wire == 2) feature_lists = val;
  });

  if (context.p) {
    for_each_features_entry(context, [&](Span key, Span feat) {
      if (span_eq(key, "id") || span_eq(key, "video_id")) {
        FeatureView fv;
        parse_feature(feat, &fv);
        if (!fv.bytes_list.empty() && id_out) *id_out = fv.bytes_list[0];
      } else if (span_eq(key, "labels")) {
        FeatureView fv;
        parse_feature(feat, &fv);
        if (labels_out) *labels_out = std::move(fv.int64_list);
      }
    });
  }

  memset(frames_out, 0, static_cast<size_t>(max_frames) * spec.total_size);
  // num_frames = min over ALL configured features, absent list -> 0 frames
  // (matches data/readers.py#YT8MFrameFeatureReader; a record missing one
  // configured modality masks out entirely rather than scoring on the other)
  std::vector<int32_t> counts(spec.n_features, 0);

  if (feature_lists.p) {
    // FeatureLists: field 1 = map entry {1: key, 2: FeatureList}
    for_each_field(feature_lists, [&](uint32_t field, uint32_t wire, Span val, uint64_t) {
      if (field != 1 || wire != 2) return;
      Span key{nullptr, 0}, flist{nullptr, 0};
      for_each_field(val, [&](uint32_t f2, uint32_t w2, Span v2, uint64_t) {
        if (f2 == 1 && w2 == 2) key = v2;
        else if (f2 == 2 && w2 == 2) flist = v2;
      });
      if (!key.p || !flist.p) return;
      int col = 0;
      int fi = -1;
      for (int i = 0; i < spec.n_features; i++) {
        if (span_eq(key, spec.names[i])) { fi = i; break; }
        col += spec.sizes[i];
      }
      if (fi < 0) return;
      const int32_t fsize = spec.sizes[fi];
      // FeatureList: repeated Feature (field 1), one per frame
      int32_t frame = 0;
      for_each_field(flist, [&](uint32_t f3, uint32_t w3, Span v3, uint64_t) {
        if (f3 != 1 || w3 != 2) return;
        if (frame >= max_frames) { frame++; return; }
        FeatureView fv;
        parse_feature(v3, &fv);
        if (!fv.bytes_list.empty() &&
            fv.bytes_list[0].n == static_cast<size_t>(fsize)) {
          memcpy(frames_out + static_cast<size_t>(frame) * spec.total_size + col,
                 fv.bytes_list[0].p, fsize);
        }
        frame++;
      });
      counts[fi] = frame < max_frames ? frame : max_frames;
    });
  }
  int32_t min_frames = spec.n_features > 0 ? counts[0] : 0;
  for (int i = 1; i < spec.n_features; i++)
    if (counts[i] < min_frames) min_frames = counts[i];
  return min_frames;
}

// One Example record → [total] float row (zero-filled for absent features).
void parse_video_record(Span record, const FeatureSpec& spec, float* feat_out,
                        Span* id_out, std::vector<int64_t>* labels_out) {
  Span features{nullptr, 0};
  for_each_field(record, [&](uint32_t field, uint32_t wire, Span val, uint64_t) {
    if (field == 1 && wire == 2) features = val;
  });

  memset(feat_out, 0, sizeof(float) * spec.total_size);
  if (!features.p) return;
  for_each_features_entry(features, [&](Span key, Span feat) {
    if (span_eq(key, "id") || span_eq(key, "video_id")) {
      FeatureView fv;
      parse_feature(feat, &fv);
      if (!fv.bytes_list.empty() && id_out) *id_out = fv.bytes_list[0];
      return;
    }
    if (span_eq(key, "labels")) {
      FeatureView fv;
      parse_feature(feat, &fv);
      if (labels_out) *labels_out = std::move(fv.int64_list);
      return;
    }
    int col = 0;
    for (int i = 0; i < spec.n_features; i++) {
      if (span_eq(key, spec.names[i])) {
        FeatureView fv;
        parse_feature(feat, &fv);
        size_t n = fv.float_list.size();
        if (n == static_cast<size_t>(spec.sizes[i]))
          memcpy(feat_out + col, fv.float_list.data(), n * 4);
        return;
      }
      col += spec.sizes[i];
    }
  });
}

}  // namespace

extern "C" {

// Parse a frame-level (SequenceExample) TFRecord file into packed arrays,
// starting at byte offset start_offset (0 = beginning; offsets come from
// lpm_chunk_offsets, which walks the framing).  feature_names: concatenated
// NUL-separated names, n_features of them.  Returns number of records
// written (<= max_records), or -1 on error.  The range form is what bounds
// the packed-cache build's memory: a shard parses in fixed-record chunks
// instead of one whole-file array (data/native_loader.py#iter_chunk_tasks).
int64_t lpm_parse_frame_file_range(
    const char* path, int64_t start_offset, int32_t max_frames,
    const int32_t* feature_sizes, int32_t n_features,
    const char* feature_names, int32_t num_classes, int64_t max_records,
    int32_t id_width, uint8_t* out_frames, int32_t* out_num_frames,
    float* out_labels, char* out_video_ids) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (start_offset > 0 && fseek(f, static_cast<long>(start_offset), SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }

  FeatureSpec spec = make_spec(feature_sizes, n_features, feature_names);
  std::vector<uint8_t> buf;
  int64_t count = 0;
  const size_t row_bytes = static_cast<size_t>(max_frames) * spec.total_size;

  while (count < max_records) {
    uint8_t header[12];
    if (fread(header, 1, 12, f) != 12) break;
    uint64_t length;
    memcpy(&length, header, 8);
    buf.resize(length);
    if (fread(buf.data(), 1, length, f) != length) break;
    uint8_t crc[4];
    if (fread(crc, 1, 4, f) != 4) break;

    Span record{buf.data(), static_cast<size_t>(length)};
    Span id{nullptr, 0};
    std::vector<int64_t> labels;
    out_num_frames[count] = parse_frame_record(
        record, max_frames, spec, out_frames + count * row_bytes, &id, &labels);
    write_labels(labels, out_labels + count * num_classes, num_classes);
    write_id(id, out_video_ids + count * id_width, id_width);
    count++;
  }
  fclose(f);
  return count;
}

// Whole-file form (start_offset = 0), kept as the stable entry point.
int64_t lpm_parse_frame_file(const char* path, int32_t max_frames,
                             const int32_t* feature_sizes, int32_t n_features,
                             const char* feature_names, int32_t num_classes,
                             int64_t max_records, int32_t id_width,
                             uint8_t* out_frames, int32_t* out_num_frames,
                             float* out_labels, char* out_video_ids) {
  return lpm_parse_frame_file_range(
      path, 0, max_frames, feature_sizes, n_features, feature_names,
      num_classes, max_records, id_width, out_frames, out_num_frames,
      out_labels, out_video_ids);
}

// Single SequenceExample blob (e.g. one HTTP-posted serving record) →
// zero-padded [max_frames, total] uint8 row + num_frames.  Returns 0, or
// -1 on malformed framing (absent features parse as zero rows, matching
// the file path's behavior).
int32_t lpm_parse_frame_record(const uint8_t* data, int64_t len,
                               int32_t max_frames,
                               const int32_t* feature_sizes,
                               int32_t n_features, const char* feature_names,
                               uint8_t* out_frames, int32_t* out_num_frames) {
  if (!data || len < 0) return -1;
  FeatureSpec spec = make_spec(feature_sizes, n_features, feature_names);
  Span record{data, static_cast<size_t>(len)};
  *out_num_frames =
      parse_frame_record(record, max_frames, spec, out_frames, nullptr, nullptr);
  return 0;
}

// Parse a video-level (Example) TFRecord file into packed arrays, starting
// at byte offset start_offset (see lpm_parse_frame_file_range).
int64_t lpm_parse_video_file_range(
    const char* path, int64_t start_offset, const int32_t* feature_sizes,
    int32_t n_features, const char* feature_names, int32_t num_classes,
    int64_t max_records, int32_t id_width, float* out_features,
    float* out_labels, char* out_video_ids) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (start_offset > 0 && fseek(f, static_cast<long>(start_offset), SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }

  FeatureSpec spec = make_spec(feature_sizes, n_features, feature_names);
  std::vector<uint8_t> buf;
  int64_t count = 0;
  while (count < max_records) {
    uint8_t header[12];
    if (fread(header, 1, 12, f) != 12) break;
    uint64_t length;
    memcpy(&length, header, 8);
    buf.resize(length);
    if (fread(buf.data(), 1, length, f) != length) break;
    uint8_t crc[4];
    if (fread(crc, 1, 4, f) != 4) break;

    Span record{buf.data(), static_cast<size_t>(length)};
    Span id{nullptr, 0};
    std::vector<int64_t> labels;
    parse_video_record(record, spec, out_features + count * spec.total_size,
                       &id, &labels);
    write_labels(labels, out_labels + count * num_classes, num_classes);
    write_id(id, out_video_ids + count * id_width, id_width);
    count++;
  }
  fclose(f);
  return count;
}

// Whole-file form (start_offset = 0), kept as the stable entry point.
int64_t lpm_parse_video_file(const char* path, const int32_t* feature_sizes,
                             int32_t n_features, const char* feature_names,
                             int32_t num_classes, int64_t max_records,
                             int32_t id_width, float* out_features,
                             float* out_labels, char* out_video_ids) {
  return lpm_parse_video_file_range(path, 0, feature_sizes, n_features,
                                    feature_names, num_classes, max_records,
                                    id_width, out_features, out_labels,
                                    out_video_ids);
}

// Byte offsets of chunk boundaries: out_offsets[i] is where record
// i*chunk_records starts (a framing-only fseek walk, no payload reads).
// Returns the number of chunks written (<= max_chunks; the record count is
// NOT returned — pair with lpm_count_records), or -1 on error.
int64_t lpm_chunk_offsets(const char* path, int64_t chunk_records,
                          int64_t* out_offsets, int64_t max_chunks) {
  if (chunk_records <= 0) return -1;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t count = 0, n_chunks = 0;
  int64_t pos = 0;
  uint8_t header[12];
  for (;;) {
    if (count % chunk_records == 0) {
      if (n_chunks == max_chunks) break;
      out_offsets[n_chunks++] = pos;
    }
    if (fread(header, 1, 12, f) != 12) break;
    uint64_t length;
    memcpy(&length, header, 8);
    if (fseek(f, static_cast<long>(length) + 4, SEEK_CUR) != 0) break;
    pos += 12 + static_cast<int64_t>(length) + 4;
    count++;
  }
  fclose(f);
  // drop a trailing boundary that has no records after it
  if (n_chunks > 0 && count % chunk_records == 0 && count / chunk_records < n_chunks)
    n_chunks--;
  return n_chunks;
}

// Single Example blob → [total] float feature row.  Returns 0, or -1 on
// malformed framing.
int32_t lpm_parse_video_record(const uint8_t* data, int64_t len,
                               const int32_t* feature_sizes,
                               int32_t n_features, const char* feature_names,
                               float* out_features) {
  if (!data || len < 0) return -1;
  FeatureSpec spec = make_spec(feature_sizes, n_features, feature_names);
  Span record{data, static_cast<size_t>(len)};
  parse_video_record(record, spec, out_features, nullptr, nullptr);
  return 0;
}

// Count records in a TFRecord file (for buffer sizing).
int64_t lpm_count_records(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t count = 0;
  uint8_t header[12];
  while (fread(header, 1, 12, f) == 12) {
    uint64_t length;
    memcpy(&length, header, 8);
    if (fseek(f, static_cast<long>(length) + 4, SEEK_CUR) != 0) break;
    count++;
  }
  fclose(f);
  return count;
}

}  // extern "C"
