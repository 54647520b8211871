// The native artifact's manifest (native_manifest.txt, written by
// export_model.py#_write_native_artifact), read by the runner
// (native_runner.cu) and by lpm_serve (native/serving_main.cc) without a
// JSON parser.  Plain C++: g++ compiles it into lpm_serve, nvcc into the
// runner.
//
// One line per fact, as the JAX package's manifest has them (model,
// batch_size, top_k, frame_features, max_frames, n_features, feature,
// n_call_inputs, call_input, n_outputs, output), and the port's own lines:
// the route (kRoutes), the lines that its route needs (kRoutes' lines:
// sampling_key, iterations, moe_num_mixtures, sampling, dbof_pooling_method,
// nextvlad_groups, nextvlad_expansion), n_weights and one named weight line
// per array of weights.bin, in the file's order:
//
//   weight <name> <f32|bf16> <ndim> <dims...>
//
// A JAX export's manifest has no route line, and its weight lines have no
// name: LoadManifest refuses it and says to re-export through the port.  An
// unknown route, or a route without a line it needs, is refused with the
// route's or the line's name.

#pragma once

#include <cstdint>
#include <fstream>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <vector>

namespace lpm_native {

// The runner's routes (core/native_runtime.py ROUTES and ROUTE_LINES): the
// route's name, whether it reads video-level features, and the port's lines
// that it needs beside the route line.
struct RouteSpec {
  const char* name;
  bool video_level;
  const char* lines[5];
};
constexpr RouteSpec kRoutes[] = {
    {"fast_netvlad_frontend", false, {"sampling_key", "iterations", "moe_num_mixtures"}},
    {"video_logistic", true, {}},
    {"video_moe", true, {"moe_num_mixtures"}},
    {"fast_dbof", false,
     {"sampling_key", "iterations", "moe_num_mixtures", "sampling", "dbof_pooling_method"}},
    {"fast_lf_netrvlad", false, {"sampling_key", "iterations", "moe_num_mixtures"}},
    {"fast_lf_softdbow", false, {"sampling_key", "iterations", "moe_num_mixtures"}},
    {"fast_lf_netfv", false, {"sampling_key", "iterations", "moe_num_mixtures"}},
    {"fast_lf_nextvlad", false,
     {"sampling_key", "iterations", "moe_num_mixtures", "nextvlad_groups", "nextvlad_expansion"}},
};
constexpr int kNumRoutes = sizeof(kRoutes) / sizeof(kRoutes[0]);

inline int64_t TagBytes(const std::string& tag) {
  if (tag == "f32" || tag == "s32") return 4;
  if (tag == "bf16") return 2;
  if (tag == "u8") return 1;
  return 0;
}

struct ArraySpec {
  std::string name;  // weight lines only
  std::string tag;
  std::vector<int64_t> dims;
  int64_t offset = 0;  // byte offset in weights.bin (weight lines only)
  int64_t elems() const {
    int64_t n = 1;
    for (int64_t d : dims) n *= d;
    return n;
  }
  int64_t bytes() const { return elems() * TagBytes(tag); }
};

struct Manifest {
  std::string model, route, sampling, dbof_pooling_method;
  int route_index = -1;  // into kRoutes
  int32_t batch_size = 0, top_k = 0, frame_features = 0, max_frames = 0;
  int32_t iterations = 0, moe_num_mixtures = 0, nextvlad_expansion = 0;
  uint32_t key0 = 0, key1 = 0;
  std::vector<int32_t> nextvlad_groups;  // one a modality
  std::vector<std::string> feature_names;
  std::vector<int32_t> feature_sizes;
  std::vector<ArraySpec> call_inputs, outputs, weights;
  std::set<std::string> lines;  // the keys of the lines read

  int32_t total_size() const {
    int32_t n = 0;
    for (int32_t s : feature_sizes) n += s;
    return n;
  }
  int64_t weight_bytes() const {
    int64_t n = 0;
    for (const auto& w : weights) n += w.bytes();
    return n;
  }
  const ArraySpec* weight(const std::string& name) const {
    for (const auto& w : weights)
      if (w.name == name) return &w;
    return nullptr;
  }
};

inline bool ParseArray(std::istringstream& in, ArraySpec* s) {
  int ndim = -1;
  if (!(in >> s->tag >> ndim) || TagBytes(s->tag) == 0 || ndim < 0 || ndim > 8) return false;
  s->dims.resize(ndim);
  for (auto& d : s->dims)
    if (!(in >> d) || d < 0) return false;
  std::string extra;
  return !(in >> extra);
}

// Reads export_dir/native_manifest.txt into *m; false with *err set when
// the file is missing, a line is malformed, a count disagrees with its
// lines, or the manifest is a JAX export's.
inline bool LoadManifest(const std::string& export_dir, Manifest* m, std::string* err) {
  const std::string path = export_dir + "/native_manifest.txt";
  std::ifstream f(path);
  if (!f) {
    *err = "cannot read " + path + " (export with with_stablehlo=True)";
    return false;
  }
  std::map<std::string, int64_t> counts;
  std::string line;
  int lineno = 0;
  int64_t offset = 0;
  while (std::getline(f, line)) {
    ++lineno;
    std::istringstream in(line);
    std::string key;
    if (!(in >> key)) continue;
    bool ok = true;
    if (lineno == 1) {
      int version = 0;
      ok = key == "lpm_native_manifest" && (in >> version) && version == 1;
    } else if (key == "model") {
      ok = static_cast<bool>(in >> m->model);
    } else if (key == "route") {
      ok = static_cast<bool>(in >> m->route);
    } else if (key == "batch_size") {
      ok = static_cast<bool>(in >> m->batch_size);
    } else if (key == "top_k") {
      ok = static_cast<bool>(in >> m->top_k);
    } else if (key == "frame_features") {
      ok = static_cast<bool>(in >> m->frame_features);
    } else if (key == "max_frames") {
      ok = static_cast<bool>(in >> m->max_frames);
    } else if (key == "iterations") {
      ok = static_cast<bool>(in >> m->iterations);
    } else if (key == "moe_num_mixtures") {
      ok = static_cast<bool>(in >> m->moe_num_mixtures);
    } else if (key == "sampling_key") {
      ok = static_cast<bool>(in >> m->key0 >> m->key1);
    } else if (key == "sampling") {
      ok = (in >> m->sampling) && (m->sampling == "iid" || m->sampling == "window");
    } else if (key == "dbof_pooling_method") {
      ok = (in >> m->dbof_pooling_method) &&
           (m->dbof_pooling_method == "average" || m->dbof_pooling_method == "max");
    } else if (key == "nextvlad_groups") {
      int32_t g = 0;
      while (in >> g) m->nextvlad_groups.push_back(g);
      ok = !m->nextvlad_groups.empty();
      for (int32_t v : m->nextvlad_groups) ok = ok && v > 0;
    } else if (key == "nextvlad_expansion") {
      ok = (in >> m->nextvlad_expansion) && m->nextvlad_expansion > 0;
    } else if (key == "feature") {
      std::string name;
      int32_t size = 0;
      ok = (in >> name >> size) && size > 0;
      m->feature_names.push_back(name);
      m->feature_sizes.push_back(size);
    } else if (key == "call_input" || key == "output") {
      ArraySpec s;
      ok = ParseArray(in, &s);
      (key == "output" ? m->outputs : m->call_inputs).push_back(s);
    } else if (key == "weight") {
      if (m->route.empty()) {
        *err = path + " has no route line: it is a JAX with_stablehlo export, which the port's " +
               "runner does not read; re-export it through learnablepoolingmethods_torch's " +
               "export_model(..., with_stablehlo=True)";
        return false;
      }
      ArraySpec s;
      ok = (in >> s.name) && ParseArray(in, &s);
      s.offset = offset;
      offset += s.bytes();
      m->weights.push_back(s);
    } else if (key == "n_features" || key == "n_call_inputs" || key == "n_outputs" ||
               key == "n_weights") {
      int64_t n = -1;
      ok = (in >> n) && n >= 0;
      counts[key] = n;
    } else {
      ok = false;
    }
    if (!ok) {
      *err = path + ":" + std::to_string(lineno) + ": malformed line '" + line + "'";
      return false;
    }
    m->lines.insert(key);
  }
  if (lineno == 0) {
    *err = path + " is empty";
    return false;
  }
  if (m->route.empty()) {
    *err = path + " has no route line: it is a JAX with_stablehlo export; re-export it through " +
           "learnablepoolingmethods_torch's export_model(..., with_stablehlo=True)";
    return false;
  }
  for (int i = 0; i < kNumRoutes; ++i)
    if (m->route == kRoutes[i].name) m->route_index = i;
  if (m->route_index < 0) {
    *err = path + ": unknown route '" + m->route + "'";
    return false;
  }
  for (const char* need : kRoutes[m->route_index].lines) {
    if (need && !m->lines.count(need)) {
      *err = path + ": route " + m->route + " needs the line '" + need + "'";
      return false;
    }
  }
  const std::pair<const char*, size_t> want[] = {
      {"n_features", m->feature_names.size()},
      {"n_call_inputs", m->call_inputs.size()},
      {"n_outputs", m->outputs.size()},
      {"n_weights", m->weights.size()}};
  for (const auto& w : want) {
    auto it = counts.find(w.first);
    if (it == counts.end() || it->second != static_cast<int64_t>(w.second)) {
      *err = path + ": " + w.first + " disagrees with its lines";
      return false;
    }
  }
  if (m->batch_size < 1 || m->max_frames < 1 || m->top_k < 1) {
    *err = path + ": batch_size, max_frames and top_k must be positive";
    return false;
  }
  return true;
}

}  // namespace lpm_native
