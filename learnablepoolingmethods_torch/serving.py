"""Model serving (ref: learnablepoolingmethods_tpu/serving.py).

A small HTTP server over an exported artifact (``export_model.py``, the JAX
package's and the port's alike):

    python -m learnablepoolingmethods_torch.serving \\
        --export_dir=/path/to/export/step_1000 --port=8500 --fast_serve

    POST /predict           body: length-framed serialized records
                            (uint32-LE length ‖ record bytes, repeated)
    → {"predictions": [{"video_index": i,
                        "classes": [...k...], "scores": [...k...]}]}
    GET /healthz            → ok
    GET /statz              → the batching queue's counters

Batches are padded to a fixed serving batch size.  Concurrent requests are
coalesced by a ``BatchingQueue`` into full device batches behind one
dispatch thread, the main thread, which owns the device; handler threads
never touch torch.  ``--fast_serve`` serves through the model's fast path
(the CUDA kernels on the card, ``--int8_hidden`` the W8A16 hidden FC), the
default the model-forward route; ``--device=cpu`` runs the plain versions.
``--native_serve`` serves an export written with ``with_stablehlo=True``
through the native runner on the card (``core/native_runtime.py``: the
Willow fast route in CUDA C++, no torch in its execution path), at the
artifact's batch size; ``lpm_serve`` (``native/serving_main.cc``) serves
the same artifact with no Python at all.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import struct
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from learnablepoolingmethods_torch.data import fixtures
from learnablepoolingmethods_torch.cli_flags import add_flag
from learnablepoolingmethods_torch.export_model import load_exported_model, load_exported_native

log = logging.getLogger(__name__)

_U32 = struct.Struct("<I")

# the JAX serving CLI's flags (serving.py#define_flags there, with
# flags.py#define_int8_hidden_flag) and the port's --device:
# name → (default, help)
_FLAGS = {
    "export_dir": ("", "Exported model directory."),
    "port": (8500, "HTTP port."),
    "serving_batch_size": (32, "Fixed batch size."),
    "single_thread": (False, "Serve one request at a time on the main thread (no batching queue)."),
    "batch_linger_ms": (2.0, "How long the batching queue waits to coalesce concurrent requests "
                             "into one device batch."),
    "native_serve": (False, "Serve an export written with with_stablehlo=True through the native CUDA C++ "
                            "runner on the card, at the export's batch size."),
    "fast_serve": (False, "Serve through the BN-folded fast forward when the model has one; the "
                          "model-forward route otherwise."),
    "int8_hidden": (False, "Weight-only int8 hidden FC on the fast path."),
    "device": ("cuda", "Torch device: cuda (default), cuda:N or cpu."),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, (default, help) in _FLAGS.items():
        add_flag(p, name, default, help)
    return p


def frame_records(records: List[bytes]) -> bytes:
    """Client-side helper: length-frame records for the request body."""
    return b"".join(_U32.pack(len(r)) + r for r in records)


def unframe_records(body: bytes) -> List[bytes]:
    records, pos = [], 0
    while pos + 4 <= len(body):
        (ln,) = _U32.unpack_from(body, pos)
        pos += 4
        if pos + ln > len(body):
            raise ValueError("truncated record framing")
        records.append(body[pos:pos + ln])
        pos += ln
    return records


class ModelServer:
    """An export loaded for serving at a fixed batch size; ``predict`` and
    ``predict_pairs`` run on the caller's thread."""

    def __init__(self, export_dir: str, serving_batch_size: int = 32, fast_serve: bool = False,
                 int8_hidden: bool = False, native: bool = False, device="cuda"):
        if native:
            # the native runner (csrc/native_runner.cu) runs the export's
            # artifact with no torch in its execution path; its batch size
            # is the artifact's, so it overrides the flag
            if fast_serve or int8_hidden:
                raise ValueError(
                    "--native_serve serves the export's native artifact; it is "
                    "exclusive with --fast_serve/--int8_hidden (the JAX "
                    "package's rule; the runner has no int8 hidden FC)"
                )
            self.model = self.params = self.batch_stats = None
            self.mcfg, self.fcfg, native_batch, self._serve = load_exported_native(export_dir, device=device)
            if serving_batch_size != native_batch:
                log.info("native module batch size %d overrides --serving_batch_size=%d",
                         native_batch, serving_batch_size)
            self.batch_size = native_batch
            return
        (self.model, self.params, self.batch_stats,
         self.mcfg, self.fcfg, self._serve) = load_exported_model(
            export_dir, prefer_fast=fast_serve, int8_hidden=int8_hidden, device=device)
        self.batch_size = serving_batch_size

    def warmup(self):
        """Serve one batch at startup, so that the kernels are built and
        launched once before requests arrive (a build or launch error stops
        the server here)."""
        fcfg = self.fcfg
        if fcfg.frame_features:
            rec = fixtures.encode_frame_sequence_example(
                b"warmup", [0], np.zeros((1, fcfg.feature_sizes[0]), np.uint8),
                np.zeros((1, fcfg.feature_sizes[1]), np.uint8), feature_names=fcfg.feature_names)
        else:
            rec = fixtures.encode_video_example(
                b"warmup", [0], np.zeros(fcfg.feature_sizes[0], np.float32),
                np.zeros(fcfg.feature_sizes[1], np.float32), feature_names=fcfg.feature_names)
        self.predict([rec] * self.batch_size)

    def predict_pairs(self, records: List[bytes]):
        """→ [(classes, scores)] per record; chunks and pads to the fixed
        batch size (with the chunk's last record) internally."""
        out = []
        for start in range(0, len(records), self.batch_size):
            chunk = records[start:start + self.batch_size]
            pad = self.batch_size - len(chunk)
            indices, values = self._serve(chunk + [chunk[-1]] * pad)
            for i in range(len(chunk)):
                out.append((indices[i].tolist(), [round(float(v), 6) for v in values[i]]))
        return out

    def predict(self, records: List[bytes]):
        return [{"video_index": i, "classes": c, "scores": s}
                for i, (c, s) in enumerate(self.predict_pairs(records))]


class BatchingQueue:
    """Request coalescing behind ONE dispatch thread.

    Handler threads (ThreadingHTTPServer) never touch torch: they submit
    record lists and block on a Future.  The dispatch loop (run on the
    thread that owns the device, the main thread in :func:`serve_forever`)
    drains the queue, coalesces concurrent requests up to the batch size
    (lingering ``max_delay_ms`` for stragglers), serves them as one padded
    batch, and splits the results back per request.
    """

    _SHUTDOWN = object()

    # bounded: without a cap, a burst of requests (each handler thread
    # holding its record bytes) grows the queue without limit while the
    # dispatch loop drains at device speed
    MAX_QUEUED = 64

    def __init__(self, server: ModelServer, max_delay_ms: float = 2.0):
        self._server = server
        self._q: "queue.Queue" = queue.Queue(maxsize=self.MAX_QUEUED)
        self._linger = max_delay_ms / 1e3
        # counters, written only on the dispatch thread; GET /statz reads them
        self._stats = {"requests": 0, "executes": 0, "rows": 0, "coalesced": 0}

    def stats(self) -> dict:
        return dict(self._stats)

    def submit(self, records: List[bytes]) -> Future:
        """Raises queue.Full when the server is saturated: the handler turns
        that into a 503 instead of buffering without bound."""
        fut: Future = Future()
        self._q.put_nowait((records, fut))
        return fut

    def shutdown(self):
        self._q.put(self._SHUTDOWN)

    def run_forever(self):
        while self._run_one():
            pass
        # shutdown: nothing consumes the queue any more, so fail the
        # stragglers at once instead of leaving their handler threads to
        # wait out the Future's timeout
        while True:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is not self._SHUTDOWN:
                nxt[1].set_exception(RuntimeError("server shutting down"))

    def _run_one(self) -> bool:
        item = self._q.get()
        if item is self._SHUTDOWN:
            return False
        stop_after = False
        pending = [item]
        total = len(item[0])
        deadline = time.monotonic() + self._linger
        while total < self._server.batch_size:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is self._SHUTDOWN:
                # honoured after this batch; putting it back could block on
                # the full queue whose only consumer is this thread
                stop_after = True
                break
            pending.append(nxt)
            total += len(nxt[0])
        records = [r for recs, _ in pending for r in recs]
        self._stats["requests"] += len(pending)
        self._stats["rows"] += len(records)
        self._stats["executes"] += max(1, -(-len(records) // self._server.batch_size))
        if len(pending) > 1:
            self._stats["coalesced"] += len(pending)
        try:
            pairs = self._server.predict_pairs(records)
        except Exception as e:  # noqa: BLE001 — fail the requests, not the loop
            log.exception("serving a batch of %d requests failed", len(pending))
            for _, fut in pending:
                fut.set_exception(e)
            return not stop_after
        pos = 0
        for recs, fut in pending:
            fut.set_result([{"video_index": i, "classes": c, "scores": s}
                            for i, (c, s) in enumerate(pairs[pos:pos + len(recs)])])
            pos += len(recs)
        return not stop_after


def make_handler(server: ModelServer, batcher: Optional[BatchingQueue] = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # the logger instead of stderr
            log.debug("serving: " + fmt, *args)

        def _send(self, code: int, payload: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/statz" and batcher is not None:
                self._send(200, json.dumps(batcher.stats()).encode())
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            try:
                records = unframe_records(body)
                if not records:
                    raise ValueError("no records in request")
                if batcher is not None:
                    preds = batcher.submit(records).result(timeout=300)
                else:
                    preds = server.predict(records)
            except queue.Full:
                self._send(503, json.dumps({"error": "queue full"}).encode())
                return
            except Exception as e:  # noqa: BLE001 — report, don't crash the server
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            self._send(200, json.dumps({"predictions": preds}).encode())

    return Handler


def serve_forever(export_dir: str, port: int, serving_batch_size: int = 32, single_thread: bool = False,
                  batch_linger_ms: float = 2.0, fast_serve: bool = False, int8_hidden: bool = False,
                  native: bool = False, device="cuda"):
    """ThreadingHTTPServer accepts concurrent requests, the BatchingQueue
    coalesces them, and the dispatch loop runs on THIS (main) thread, which
    owns the device.  ``single_thread``: one request at a time, no
    queue."""
    model_server = ModelServer(export_dir, serving_batch_size, fast_serve=fast_serve,
                               int8_hidden=int8_hidden, native=native, device=device)
    log.info("warming up ...")
    model_server.warmup()
    if single_thread:
        httpd = HTTPServer(("0.0.0.0", port), make_handler(model_server))
        log.info("serving %s on :%d (batch %d, single-thread)", export_dir, port, model_server.batch_size)
        httpd.serve_forever()
        return
    batcher = BatchingQueue(model_server, max_delay_ms=batch_linger_ms)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(model_server, batcher))
    accept_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    accept_thread.start()
    log.info("serving %s on :%d (batch %d, batching queue, linger %.1f ms)",
             export_dir, port, model_server.batch_size, batch_linger_ms)
    try:
        batcher.run_forever()  # the device's dispatch loop, main thread
    finally:
        httpd.shutdown()


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.export_dir:
        raise ValueError("--export_dir is required")
    serve_forever(args.export_dir, args.port, args.serving_batch_size, single_thread=args.single_thread,
                  batch_linger_ms=args.batch_linger_ms, fast_serve=args.fast_serve,
                  int8_hidden=args.int8_hidden, native=args.native_serve, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
