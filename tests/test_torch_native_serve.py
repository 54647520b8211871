"""The port's lpm_serve (learnablepoolingmethods_torch/native/serving_main.cc)
on the CPU, test for test as tests/integration/test_native_serve_binary.py
holds the JAX package's: --check, HTTP, concurrent requests coalescing in
/statz, sustained mixed load, a graceful SIGTERM, and a 400 on a bad body and
a 404 on an unknown route.

The runner runs on the card only, so here g++ links the server and the
record parser with tests/_torch_fake_runner.cc, a host-only stand-in for the
runner's C API whose top-k is a fixed function of each row as the server
parsed it (its byte sum and frame count).  The oracle computes that function
from the Python parser's rows (export_model.py#parse_serialized_records):
classes equal, scores within the server's 1e-6 rounding.  The artifact is the
port's own export (with_stablehlo=True) of a small Willow-shaped model.
"""

import contextlib
import http.client
import json
import re
import signal
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest

from learnablepoolingmethods_torch import export_model as tem
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import native_runtime as nr
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.data import fixtures, tfrecord_io
from learnablepoolingmethods_torch.serving import frame_records

FAKE_RUNNER = Path(__file__).resolve().parent / "_torch_fake_runner.cc"
MAXF, B, TOP_K = 6, 4, 5
FCFG = FeatureConfig(("rgb", "audio"), (1024, 128), True, MAXF)
MCFG = ModelConfig(vocab_size=12, netvlad_cluster_size=4, netvlad_hidden_size=8, iterations=6)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(lpm_serve built against the stand-in, the export, 7 records)."""
    d = tmp_path_factory.mktemp("lpm_serve")
    binary = d / "lpm_serve"
    out = subprocess.run(nr.serving_binary_command(FAKE_RUNNER, binary), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tree = weights.init_variables_np(MCFG, FCFG, seed=0, model_name="NetVLADModelLF")
    export_dir = tem.export_model(str(d / "export"), "NetVLADModelLF", MCFG, FCFG, tree["params"],
                                  tree["batch_stats"], top_k=TOP_K, with_stablehlo=True, stablehlo_batch_size=B)
    data = str(d / "data.tfrecord")
    fixtures.write_frame_level_fixture(data, num_videos=7, num_classes=12, max_frames=MAXF + 3, seed=4)
    return str(binary), export_dir, list(tfrecord_io.read_tfrecords(data))


def expected(records):
    """The stand-in runner's (classes, scores) of each record's parsed row."""
    feats, nfs = tem.parse_serialized_records(FCFG, records)
    out = []
    for row, nf in zip(feats, nfs):
        base = int(row.astype(np.int64).sum()) % 9973 + 17 * int(nf)
        out.append(([(base + 7 * j) % 97 for j in range(TOP_K)], [base / 16384 - j / 64 for j in range(TOP_K)]))
    return out


def assert_answers(preds, records):
    assert len(preds) == len(records)
    for i, (p, (classes, scores)) in enumerate(zip(preds, expected(records))):
        assert p["video_index"] == i
        assert p["classes"] == classes
        np.testing.assert_allclose(p["scores"], scores, atol=1e-6)


@contextlib.contextmanager
def lpm_serve(binary, export_dir, *flags):
    """The server on a free port; → (process, port)."""
    proc = subprocess.Popen([binary, f"--export_dir={export_dir}", "--port=0", *flags],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        found = re.search(r"serving .* on :(\d+)", line)
        assert found, f"no readiness line: {line!r} (exit {proc.poll()})"
        yield proc, int(found.group(1))
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_check_mode(artifact):
    binary, export_dir, _ = artifact
    out = subprocess.run([binary, f"--export_dir={export_dir}", "--check"], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "route fast_netvlad_frontend" in out.stderr
    (pred,) = json.loads(out.stdout)["predictions"]
    assert pred["classes"] == [7 * j for j in range(TOP_K)]  # an empty record: no frames, zero bytes
    np.testing.assert_allclose(pred["scores"], [-j / 64 for j in range(TOP_K)], atol=1e-6)


def test_http_serving_matches_the_runner_on_the_parsed_rows(artifact):
    """Seven records in one request: two batches of four on the solo path,
    the second padded with its last record."""
    binary, export_dir, records = artifact
    with lpm_serve(binary, export_dir) as (_, port):
        assert request(port, "GET", "/healthz") == (200, b"ok")
        status, body = request(port, "POST", "/predict", frame_records(records))
        assert status == 200, body
        assert_answers(json.loads(body)["predictions"], records)
        status, body = request(port, "GET", "/statz")
        assert json.loads(body) == {"requests": 1, "executes": 2, "rows": 7, "coalesced": 0}


def test_bad_body_is_400_and_an_unknown_route_404(artifact):
    binary, export_dir, records = artifact
    with lpm_serve(binary, export_dir) as (_, port):
        assert request(port, "POST", "/predict", b"\xff\xff\xff\xff junk")[0] == 400
        assert request(port, "POST", "/predict", b"")[0] == 400
        assert request(port, "GET", "/nope")[0] == 404
        assert request(port, "POST", "/other", frame_records(records[:1]))[0] == 404
        status, body = request(port, "POST", "/predict", frame_records(records[:2]))  # still serving
        assert status == 200
        assert_answers(json.loads(body)["predictions"], records[:2])


def test_concurrent_requests_coalesce(artifact):
    """Four one-record posts at once with a 1 s linger share at most two
    executions, and each request gets its own row's answer."""
    binary, export_dir, records = artifact
    results = [None] * 4
    with lpm_serve(binary, export_dir, "--linger_ms=1000") as (_, port):
        def post(i):
            results[i] = request(port, "POST", "/predict", frame_records([records[i]]))

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, (status, body) in enumerate(results):
            assert status == 200, body
            assert_answers(json.loads(body)["predictions"], [records[i]])
        stats = json.loads(request(port, "GET", "/statz")[1])
    assert stats["requests"] == 4 and stats["rows"] == 4
    assert stats["executes"] <= 2 and stats["coalesced"] >= 2, stats


def test_sustained_mixed_load(artifact):
    """6 clients × 8 posts of 1 to 6 records (5 and 6 past the batch of 4,
    on the solo path) at the default 2 ms linger: every answer right."""
    binary, export_dir, records = artifact
    errors = []
    with lpm_serve(binary, export_dir) as (_, port):
        def client(tid):
            try:
                for j in range(8):
                    sel = [records[(tid + j + i) % len(records)] for i in range(1 + (tid + j) % 6)]
                    status, body = request(port, "POST", "/predict", frame_records(sel))
                    assert status == 200, body
                    assert_answers(json.loads(body)["predictions"], sel)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append((tid, repr(e)))

        threads = [threading.Thread(target=client, args=(t,)) for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert request(port, "GET", "/healthz") == (200, b"ok")
        assert json.loads(request(port, "GET", "/statz")[1])["requests"] == 48


def test_graceful_sigterm(artifact):
    binary, export_dir, _ = artifact
    with lpm_serve(binary, export_dir) as (proc, port):
        assert request(port, "GET", "/healthz") == (200, b"ok")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=35) == 0


def test_refuses_a_manifest_without_the_route(artifact, tmp_path):
    """A JAX with_stablehlo export's manifest (no route line, unnamed weight
    lines): the server does not load it and says to re-export."""
    binary, export_dir, _ = artifact
    lines = [line for line in Path(export_dir, nr.MANIFEST_FILE).read_text().splitlines()
             if line.split()[0] not in ("route", "sampling_key", "iterations", "moe_num_mixtures", "n_weights",
                                         "weight")]
    Path(tmp_path, nr.MANIFEST_FILE).write_text("\n".join(lines + ["n_weights 1", "weight f32 1 4"]) + "\n")
    out = subprocess.run([binary, f"--export_dir={tmp_path}", "--check"], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1
    assert "re-export" in out.stderr and "JAX with_stablehlo export" in out.stderr
