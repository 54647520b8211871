// lpm_serve: the port's native serving binary: no Python anywhere.
//
//   lpm_serve --export_dir=/path/to/export --port=8500 [--linger_ms=2] [--check]
//
// The port's copy of the JAX package's lpm_serve (native/serving_main.cc at
// the repository's root), with its HTTP contract: POST /predict with
// uint32-LE length-framed serialized records → {"predictions":
// [{"video_index", "classes", "scores"}]}, GET /healthz → ok, GET /statz →
// {"requests", "executes", "rows", "coalesced"}.  It loads an artifact
// exported with with_stablehlo=True by the port's export_model.py
// (native_manifest.txt + weights.bin) into the native runner
// (csrc/native_runner.cu: the Willow fast route on the card, cuBLAS and hand
// kernels) through the runner's C API, which takes no CUDA type: this file
// includes no CUDA header, and g++ compiles it alone
// (core/native_runtime.py#build_serving_binary links it with the runner).
// Records are parsed by the port's wire-format parser
// (native/tfrecord_reader.cc, lpm_parse_frame_record).  The whole request
// path is native: socket → proto parse → the runner on the card → JSON.
//
// Threading (the C++ twin of serving.py#BatchingQueue): one detached
// handler thread per connection does the socket I/O and record unframing
// and never touches the model; a single executor thread owns the runner,
// coalesces concurrent requests up to the artifact's batch size (lingering
// --linger_ms, 2 ms by default, for stragglers, like the Python queue's
// max_delay_ms), runs ONE padded batch, and sends each request its slice.
// The runner sets its device on whichever thread calls it.  A bounded queue
// answers 503 when full; SIGTERM stops accepting and drains what is queued
// and in flight before exiting 0.  --check loads everything, runs one batch
// of an empty record, prints its JSON and exits.  --port=0 takes a free
// port, which the readiness line names.
//
// It differs from the JAX package's binary in what serves a batch (the
// runner's C API in place of shr_* over a StableHLO module) and in taking
// frame-level artifacts only: the runner's route is frame-level (video-level
// models are ROADMAP item 14c).

#include <arpa/inet.h>
#include <csignal>
#include <poll.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include "native_manifest.h"

// --- extern C APIs from the sibling translation units ----------------------

extern "C" {
// the native runner (csrc/native_runner.cu)
void* lpm_runner_load(const char* export_dir, int device, char* err, long long err_cap);
int lpm_runner_run(void* handle, const void* features, const void* num_frames, void* values,
                   void* indices, char* err, long long err_cap);
// tfrecord_reader.cc
int32_t lpm_parse_frame_record(const uint8_t* data, int64_t len,
                               int32_t max_frames,
                               const int32_t* feature_sizes,
                               int32_t n_features, const char* feature_names,
                               uint8_t* out_frames, int32_t* out_num_frames);
}

namespace {

std::string PackNames(const std::vector<std::string>& names) {
  std::string out;
  for (const auto& n : names) {
    out += n;
    out += '\0';
  }
  return out;
}

// --- the loaded model ------------------------------------------------------

struct Server {
  lpm_native::Manifest m;
  void* handle = nullptr;
  std::string names_packed;
  int32_t total_size = 0;
  int32_t top_k = 0;  // the width of the outputs (min(top_k, vocabulary))

  // batch buffers, sized once (batches are serialized on the executor)
  std::vector<uint8_t> frames;
  std::vector<int32_t> num_frames;
  std::vector<float> values;
  std::vector<int32_t> indices;

  bool Load(const std::string& export_dir, std::string* err) {
    if (!lpm_native::LoadManifest(export_dir, &m, err)) return false;
    if (m.frame_features != 1 || m.outputs.size() != 2 || m.outputs[0].dims.size() != 2) {
      *err = "the manifest is not a frame-level artifact of the runner's route";
      return false;
    }
    names_packed = PackNames(m.feature_names);
    total_size = m.total_size();
    top_k = static_cast<int32_t>(m.outputs[0].dims[1]);
    char errbuf[4096] = {0};
    handle = lpm_runner_load(export_dir.c_str(), 0, errbuf, sizeof(errbuf));
    if (!handle) {
      *err = errbuf;
      return false;
    }
    frames.assign(static_cast<size_t>(m.batch_size) * RowBytes(), 0);
    num_frames.assign(m.batch_size, 0);
    values.assign(static_cast<size_t>(m.batch_size) * top_k, 0.f);
    indices.assign(static_cast<size_t>(m.batch_size) * top_k, 0);
    return true;
  }

  size_t RowBytes() const { return static_cast<size_t>(m.max_frames) * total_size; }

  // parse one serialized record into batch row `i`
  bool ParseOne(const uint8_t* rec, int64_t len, int32_t i, std::string* err) {
    if (lpm_parse_frame_record(rec, len, m.max_frames, m.feature_sizes.data(),
                               m.feature_sizes.size(), names_packed.c_str(),
                               frames.data() + i * RowBytes(), &num_frames[i]) != 0) {
      *err = "malformed record";
      return false;
    }
    return true;
  }

  // pad rows [n_used, B) by duplicating row src (the runner's batch is
  // fixed-size; extra rows are discarded after execution)
  void PadRows(int32_t n_used, int32_t src) {
    const size_t rb = RowBytes();
    for (int32_t i = n_used; i < m.batch_size; i++) {
      memcpy(frames.data() + i * rb, frames.data() + src * rb, rb);
      num_frames[i] = num_frames[src];
    }
  }

  // one batch through the runner: the batch buffers → values and indices
  bool ExecuteOnce(std::string* err) {
    char errbuf[4096] = {0};
    if (lpm_runner_run(handle, frames.data(), num_frames.data(), values.data(), indices.data(),
                       errbuf, sizeof(errbuf)) != 0) {
      *err = errbuf;
      return false;
    }
    return true;
  }

  // JSON entries for batch rows [row_start, row_start+n) with request-local
  // video_index values [idx_base, idx_base+n); appends to *json
  void FormatRows(std::string* json, int32_t row_start, size_t n,
                  size_t idx_base, bool* first) const {
    const int32_t k = top_k;
    char num[64];
    for (size_t i = 0; i < n; i++) {
      if (!*first) *json += ", ";
      *first = false;
      snprintf(num, sizeof(num), "{\"video_index\": %zu, \"classes\": [",
               idx_base + i);
      *json += num;
      const size_t r = row_start + i;
      for (int32_t j = 0; j < k; j++) {
        snprintf(num, sizeof(num), "%s%d", j ? ", " : "",
                 indices[r * k + j]);
        *json += num;
      }
      *json += "], \"scores\": [";
      for (int32_t j = 0; j < k; j++) {
        float v = values[r * k + j];
        // JSON has no NaN/Inf; a diverged checkpoint must not emit an
        // unparseable 200 body — null marks the broken score honestly
        if (std::isfinite(v)) {
          snprintf(num, sizeof(num), "%s%.6f", j ? ", " : "", v);
        } else {
          snprintf(num, sizeof(num), "%snull", j ? ", " : "");
        }
        *json += num;
      }
      *json += "]}";
    }
  }

  // records (spans into the request body) → JSON predictions, or "" + err.
  // Handles any record count by chunking into batch-size executions (the
  // solo path; concurrent sub-batch requests go through BatchHub instead).
  std::string Predict(const std::vector<std::pair<const uint8_t*, int64_t>>&
                          records,
                      std::string* err) {
    const int32_t B = m.batch_size;
    std::string json = "{\"predictions\": [";
    bool first = true;
    for (size_t start = 0; start < records.size();
         start += static_cast<size_t>(B)) {
      size_t n_real = records.size() - start;
      if (n_real > static_cast<size_t>(B)) n_real = B;
      for (size_t i = 0; i < n_real; i++) {
        if (!ParseOne(records[start + i].first, records[start + i].second,
                      i, err))
          return "";
      }
      PadRows(n_real, n_real - 1);
      if (!ExecuteOnce(err)) return "";
      FormatRows(&json, 0, n_real, start, &first);
    }
    json += "]}";
    return json;
  }
};

// --- minimal HTTP/1.1 ------------------------------------------------------

constexpr size_t kMaxBody = 64u << 20;

bool RecvRequest(int fd, std::string* head, std::vector<uint8_t>* body) {
  head->clear();
  body->clear();
  char buf[8192];
  size_t header_end = std::string::npos;
  std::string data;
  while (header_end == std::string::npos) {
    ssize_t n = recv(fd, buf, sizeof(buf), 0);
    if (n <= 0) return false;
    data.append(buf, n);
    header_end = data.find("\r\n\r\n");
    if (data.size() > kMaxBody) return false;
  }
  *head = data.substr(0, header_end);
  size_t content_len = 0;
  // case-insensitive Content-Length scan
  for (size_t pos = 0; (pos = data.find(':', pos)) != std::string::npos &&
                       pos < header_end;
       pos++) {
    size_t ls = data.rfind('\n', pos);
    ls = (ls == std::string::npos) ? 0 : ls + 1;
    std::string key = data.substr(ls, pos - ls);
    for (auto& c : key) c = tolower(c);
    if (key == "content-length") {
      content_len = strtoull(data.c_str() + pos + 1, nullptr, 10);
      break;
    }
  }
  if (content_len > kMaxBody) return false;
  std::string rest = data.substr(header_end + 4);
  body->assign(rest.begin(), rest.end());
  while (body->size() < content_len) {
    ssize_t n = recv(fd, buf, sizeof(buf), 0);
    if (n <= 0) return false;
    body->insert(body->end(), buf, buf + n);
  }
  body->resize(content_len);
  return true;
}

void SendResponse(int fd, int status, const char* status_text,
                  const std::string& content_type, const std::string& body) {
  char head[256];
  snprintf(head, sizeof(head),
           "HTTP/1.1 %d %s\r\nContent-Type: %s\r\nContent-Length: %zu\r\n"
           "Connection: close\r\n\r\n",
           status, status_text, content_type.c_str(), body.size());
  std::string out = head + body;
  size_t sent = 0;
  while (sent < out.size()) {
    ssize_t n = send(fd, out.data() + sent, out.size() - sent, 0);
    if (n <= 0) return;
    sent += n;
  }
}

// --- cross-request batching (the C++ twin of serving.py#BatchingQueue) -----
// (record unframing lives in BatchHub::HandleConn, offset-based; the
// serving.py#unframe_records convention applies: <4 trailing bytes are
// ignored, a record overrunning the body is a framing error)

struct PredictItem {
  int fd = -1;
  std::vector<uint8_t> body;  // owns the record bytes
  std::vector<std::pair<int64_t, int64_t>> recs;  // (offset, len) into body
};

struct BatchHub {
  Server* server = nullptr;
  int linger_ms = 2;  // how long to wait for stragglers (--linger_ms)
  std::mutex mu;
  std::condition_variable cv;
  std::deque<PredictItem> queue;
  std::atomic<uint64_t> stat_requests{0}, stat_executes{0}, stat_rows{0},
      stat_coalesced{0};
  std::atomic<int32_t> active_conns{0};
  // set UNDER mu before the batch leaves the queue: the graceful-shutdown
  // drain must see in-flight work, or main could destroy the stack-local
  // Server while the executor still dereferences it
  std::atomic<int32_t> busy{0};

  // bounded: the old one-request-at-a-time loop had implicit
  // backpressure; the queue must not grow without limit when clients
  // post faster than the executor drains (each item owns its body)
  static constexpr size_t kMaxQueued = 64;

  bool TrySubmit(PredictItem&& item) {
    {
      std::lock_guard<std::mutex> lk(mu);
      if (queue.size() >= kMaxQueued) return false;
      queue.push_back(std::move(item));
    }
    cv.notify_one();
    return true;
  }

  std::string Statz() {
    char buf[256];
    snprintf(buf, sizeof(buf),
             "{\"requests\": %llu, \"executes\": %llu, \"rows\": %llu, "
             "\"coalesced\": %llu}",
             (unsigned long long)stat_requests.load(),
             (unsigned long long)stat_executes.load(),
             (unsigned long long)stat_rows.load(),
             (unsigned long long)stat_coalesced.load());
    return buf;
  }

  static void Reply(int fd, int status, const char* text,
                    const std::string& body) {
    SendResponse(fd, status, text, "application/json", body);
    close(fd);
  }

  // The executor thread: owns the model scratch.  Takes one queued
  // request; if it fits in a sub-batch, lingers up to 2 ms (the Python
  // queue's max_delay_ms default) for more concurrent requests, packs
  // them into ONE fixed-batch execution, and sends every request its
  // slice.  Oversized requests run the chunked solo path.
  void Run() {
    const int32_t B = server->m.batch_size;
    while (true) {
      std::vector<PredictItem> batch;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return !queue.empty(); });
        busy.store(1);
        batch.push_back(std::move(queue.front()));
        queue.pop_front();
        if (static_cast<int64_t>(batch[0].recs.size()) < B) {
          auto deadline = std::chrono::steady_clock::now() +
                          std::chrono::milliseconds(linger_ms);
          size_t total = batch[0].recs.size();
          while (static_cast<int64_t>(total) < B) {
            if (queue.empty()) {
              if (cv.wait_until(lk, deadline) == std::cv_status::timeout)
                break;
              continue;
            }
            if (total + queue.front().recs.size() > static_cast<size_t>(B))
              break;
            total += queue.front().recs.size();
            batch.push_back(std::move(queue.front()));
            queue.pop_front();
          }
        }
      }
      Process(std::move(batch));
      busy.store(0);
    }
  }

  void Process(std::vector<PredictItem> batch) {
    const int32_t B = server->m.batch_size;
    std::string err;

    // oversized request → chunked solo path (never coalesced)
    if (batch.size() == 1 &&
        static_cast<int64_t>(batch[0].recs.size()) > B) {
      std::vector<std::pair<const uint8_t*, int64_t>> spans;
      spans.reserve(batch[0].recs.size());
      for (const auto& r : batch[0].recs)
        spans.emplace_back(batch[0].body.data() + r.first, r.second);
      std::string json = server->Predict(spans, &err);
      stat_executes += (batch[0].recs.size() + B - 1) / B;
      stat_rows += batch[0].recs.size();
      if (json.empty()) {
        Reply(batch[0].fd, 500, "Internal Server Error",
              std::string("{\"error\": \"") + err + "\"}");
      } else {
        Reply(batch[0].fd, 200, "OK", json);
      }
      return;
    }

    // pack all items' records into consecutive batch rows; a request
    // whose record fails to parse is answered 500 and excluded (its rows
    // are overwritten by the next item).  NOTE: the wire-format parser is
    // deliberately lenient (absent/garbled features parse as zero rows —
    // tfrecord_reader.cc), so via HTTP this branch is defensive depth,
    // reachable only through parser-contract violations
    struct Placed {
      size_t item;
      int32_t row_start;
      size_t n;
    };
    std::vector<Placed> placed;
    int32_t row = 0;
    for (size_t it = 0; it < batch.size(); it++) {
      const int32_t row0 = row;
      bool ok = true;
      for (const auto& r : batch[it].recs) {
        if (!server->ParseOne(batch[it].body.data() + r.first, r.second, row,
                              &err)) {
          ok = false;
          break;
        }
        row++;
      }
      if (!ok) {
        row = row0;
        Reply(batch[it].fd, 500, "Internal Server Error",
              std::string("{\"error\": \"") + err + "\"}");
        batch[it].fd = -1;
        continue;
      }
      placed.push_back({it, row0, batch[it].recs.size()});
    }
    if (placed.empty()) return;

    server->PadRows(row, row - 1);
    stat_executes += 1;
    stat_rows += row;
    if (batch.size() > 1) stat_coalesced += batch.size();

    if (!server->ExecuteOnce(&err)) {
      for (const auto& p : placed)
        Reply(batch[p.item].fd, 500, "Internal Server Error",
              std::string("{\"error\": \"") + err + "\"}");
      return;
    }
    for (const auto& p : placed) {
      std::string json = "{\"predictions\": [";
      bool first = true;
      server->FormatRows(&json, p.row_start, p.n, 0, &first);
      json += "]}";
      Reply(batch[p.item].fd, 200, "OK", json);
    }
  }

  // one detached thread per connection: socket I/O + unframing only —
  // the model is executor-owned
  void HandleConn(int fd) {
    std::string head;
    std::vector<uint8_t> body;
    if (!RecvRequest(fd, &head, &body)) {
      close(fd);
      active_conns--;
      return;
    }
    if (head.rfind("GET /healthz", 0) == 0) {
      SendResponse(fd, 200, "OK", "text/plain", "ok");
      close(fd);
    } else if (head.rfind("GET /statz", 0) == 0) {
      SendResponse(fd, 200, "OK", "application/json", Statz());
      close(fd);
    } else if (head.rfind("POST /predict", 0) == 0) {
      PredictItem item;
      item.fd = fd;
      item.body = std::move(body);
      size_t pos = 0;
      bool ok = true;
      while (pos + 4 <= item.body.size()) {
        uint32_t len;
        memcpy(&len, item.body.data() + pos, 4);
        pos += 4;
        if (pos + len > item.body.size()) {
          ok = false;
          break;
        }
        item.recs.emplace_back(pos, len);
        pos += len;
      }
      if (!ok || item.recs.empty()) {
        SendResponse(fd, 400, "Bad Request", "application/json",
                     "{\"error\": \"bad record framing\"}");
        close(fd);
      } else if (!TrySubmit(std::move(item))) {
        SendResponse(fd, 503, "Service Unavailable", "application/json",
                     "{\"error\": \"queue full\"}");
        close(fd);
      } else {
        stat_requests++;  // executor replies and closes
      }
    } else {
      SendResponse(fd, 404, "Not Found", "text/plain", "not found");
      close(fd);
    }
    active_conns--;
  }
};

}  // namespace

volatile sig_atomic_t g_stop = 0;

void HandleTerm(int) {
  // graceful stop: the accept loop polls with a 500 ms timeout and
  // re-checks this flag (close() does NOT wake a blocked accept() on
  // Linux); in-flight requests finish (executor drains its queue)
  g_stop = 1;
}

int main(int argc, char** argv) {
  // a client closing mid-response must EPIPE the send(), not kill the server
  signal(SIGPIPE, SIG_IGN);
  signal(SIGTERM, HandleTerm);
  signal(SIGINT, HandleTerm);
  std::string export_dir;
  int port = 8500;
  int linger_ms = 2;
  bool check_only = false;
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    if (a.rfind("--export_dir=", 0) == 0) export_dir = a.substr(13);
    else if (a.rfind("--port=", 0) == 0) port = atoi(a.c_str() + 7);
    else if (a.rfind("--linger_ms=", 0) == 0) linger_ms = atoi(a.c_str() + 12);
    else if (a == "--check") check_only = true;
    else {
      fprintf(stderr, "unknown arg: %s\n", a.c_str());
      return 2;
    }
  }
  if (export_dir.empty()) {
    fprintf(stderr,
            "usage: lpm_serve --export_dir=DIR [--port=8500] [--linger_ms=2] [--check]\n");
    return 2;
  }

  Server server;
  std::string err;
  if (!server.Load(export_dir, &err)) {
    fprintf(stderr, "load failed: %s\n", err.c_str());
    return 1;
  }
  fprintf(stderr, "loaded %s (model %s, route %s, batch %d, top_k %d)\n",
          export_dir.c_str(), server.m.model.c_str(), server.m.route.c_str(),
          server.m.batch_size, server.top_k);

  if (check_only) {
    // one empty record exercises parse → execute → format
    static const uint8_t dummy = 0;
    std::vector<std::pair<const uint8_t*, int64_t>> records = {{&dummy, 0}};
    std::string json = server.Predict(records, &err);
    if (json.empty()) {
      fprintf(stderr, "check failed: %s\n", err.c_str());
      return 1;
    }
    printf("%s\n", json.c_str());
    return 0;
  }

  int sfd = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(sfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr = {};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  if (bind(sfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(sfd, 16) != 0) {
    fprintf(stderr, "cannot bind :%d\n", port);
    return 1;
  }
  socklen_t addr_len = sizeof(addr);
  getsockname(sfd, reinterpret_cast<sockaddr*>(&addr), &addr_len);
  printf("lpm_serve: serving %s on :%d (batch %d)\n", export_dir.c_str(),
         ntohs(addr.sin_port), server.m.batch_size);
  fflush(stdout);

  // intentionally leaked: destroying a condition_variable/mutex with the
  // detached executor thread blocked on it at exit() is UB (can hang the
  // graceful-shutdown path); the OS reclaims everything at process exit
  static BatchHub& hub = *new BatchHub();
  hub.server = &server;
  hub.linger_ms = linger_ms;
  std::thread([] { hub.Run(); }).detach();  // the model-owning executor

  struct pollfd pfd = {sfd, POLLIN, 0};
  while (!g_stop) {
    int pr = poll(&pfd, 1, 500);
    if (pr <= 0) continue;  // timeout or EINTR → re-check g_stop
    int fd = accept(sfd, nullptr, nullptr);
    if (fd < 0) continue;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    // an idle connection ties up only its own handler thread, but still
    // bound it; shed load instead of spawning unbounded threads
    struct timeval tmo = {30, 0};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tmo, sizeof(tmo));
    // and a SEND timeout: replies go out on the single model-owning
    // executor thread — a client that stops reading must cost at most
    // 30 s, not wedge every other request forever
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tmo, sizeof(tmo));
    if (hub.active_conns.load() >= 256) {
      SendResponse(fd, 503, "Service Unavailable", "application/json",
                   "{\"error\": \"too many connections\"}");
      close(fd);
      continue;
    }
    hub.active_conns++;
    std::thread([fd] { hub.HandleConn(fd); }).detach();
  }
  // drain: let queued AND in-flight requests get their replies before
  // exiting (busy covers the batch the executor already popped)
  for (int i = 0; i < 300; i++) {
    {
      std::lock_guard<std::mutex> lk(hub.mu);
      if (hub.queue.empty() && hub.active_conns.load() == 0 &&
          hub.busy.load() == 0)
        break;
    }
    usleep(100 * 1000);
  }
  fprintf(stderr, "lpm_serve: stopped\n");
  return 0;
}
