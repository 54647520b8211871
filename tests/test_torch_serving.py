"""The port's HTTP model server (serving.py), test for test as
tests/integration/test_serving.py holds the JAX package's: export a model,
serve it on the CPU, query it over a socket; and the same request body
answered alike by the JAX server and the port's (classes equal, scores
within 1e-5: both serve the f32 model-forward route)."""

import http.client
import json
import queue
import threading

import numpy as np
import pytest

from learnablepoolingmethods_torch import serving
from learnablepoolingmethods_torch import export_model as em
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.core.step import make_predict_step, preprocess_input
from learnablepoolingmethods_torch.data import fixtures, tfrecord_io
from learnablepoolingmethods_torch.models import create_model

VIDEO_FCFG = FeatureConfig(("mean_rgb", "mean_audio"), (6, 2))
FRAME_FCFG = FeatureConfig(("rgb", "audio"), (1024, 128), frame_features=True, max_frames=6)
NETVLAD = ModelConfig(vocab_size=12, netvlad_cluster_size=4, netvlad_hidden_size=8, iterations=6)


def _export_logistic(d, num_videos):
    data_path = str(d / "data.tfrecord")
    fixtures.write_video_level_fixture(data_path, num_videos=num_videos, num_classes=12, rgb_size=6,
                                       audio_size=2)
    mcfg = ModelConfig(vocab_size=12)
    tree = weights.init_variables_np(mcfg, VIDEO_FCFG, seed=0, model_name="LogisticModel")
    export_dir = em.export_model(str(d / "export"), "LogisticModel", mcfg, VIDEO_FCFG, tree["params"],
                                 tree["batch_stats"], top_k=4)
    return export_dir, data_path


def _serve_in_thread(handler):
    httpd = serving.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    export_dir, data_path = _export_logistic(tmp_path_factory.mktemp("serve"), 5)
    server = serving.ModelServer(export_dir, 4, device="cpu")
    httpd = _serve_in_thread(serving.make_handler(server))
    yield httpd.server_address[1], data_path, export_dir
    httpd.shutdown()
    httpd.server_close()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    return resp.status, resp.read()


def test_healthz(served):
    port, _, _ = served
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    assert resp.status == 200 and resp.read() == b"ok"


def test_predict_roundtrip(served):
    port, data_path, _ = served
    records = list(tfrecord_io.read_tfrecords(data_path))
    status, body = _post(port, "/predict", serving.frame_records(records))
    assert status == 200, body
    preds = json.loads(body)["predictions"]
    assert len(preds) == 5
    for i, p in enumerate(preds):
        assert p["video_index"] == i
        assert len(p["classes"]) == 4 and len(p["scores"]) == 4
        assert all(0.0 <= s <= 1.0 for s in p["scores"])
        assert p["scores"] == sorted(p["scores"], reverse=True)


def test_predict_bad_body_is_400(served):
    port, _, _ = served
    status, body = _post(port, "/predict", b"\xff\xff\xff\xff garbage")
    assert status == 400
    assert "error" in json.loads(body)


def test_unknown_route_404(served):
    port, _, _ = served
    status, _ = _post(port, "/nope", b"")
    assert status == 404


def test_same_body_same_answer_as_the_jax_server(served):
    """The JAX package's server on the same export (the port's) answers the
    same body with the same classes, scores within 1e-5."""
    from learnablepoolingmethods_tpu import serving as jax_serving

    port, data_path, export_dir = served
    body = serving.frame_records(list(tfrecord_io.read_tfrecords(data_path)))
    httpd = _serve_in_thread(jax_serving.make_handler(jax_serving.ModelServer(export_dir, 4)))
    try:
        want = json.loads(_post(httpd.server_address[1], "/predict", body)[1])["predictions"]
    finally:
        httpd.shutdown()
        httpd.server_close()
    got = json.loads(_post(port, "/predict", body)[1])["predictions"]
    assert [p["classes"] for p in got] == [p["classes"] for p in want]
    assert [p["video_index"] for p in got] == [p["video_index"] for p in want]
    np.testing.assert_allclose([p["scores"] for p in got], [p["scores"] for p in want], atol=1e-5)


@pytest.fixture(scope="module")
def served_batching(tmp_path_factory):
    """The default mode: ThreadingHTTPServer and the BatchingQueue's
    dispatch loop on a thread of its own."""
    export_dir, data_path = _export_logistic(tmp_path_factory.mktemp("serve_bq"), 6)
    server = serving.ModelServer(export_dir, 4, device="cpu")
    calls = {"n": 0}
    inner = server.predict_pairs

    def counting(records):
        calls["n"] += 1
        return inner(records)

    server.predict_pairs = counting
    batcher = serving.BatchingQueue(server, max_delay_ms=100.0)
    httpd = _serve_in_thread(serving.make_handler(server, batcher))
    dispatch = threading.Thread(target=batcher.run_forever, daemon=True)
    dispatch.start()
    yield httpd.server_address[1], data_path, calls
    batcher.shutdown()
    dispatch.join(timeout=30)
    assert not dispatch.is_alive()
    httpd.shutdown()
    httpd.server_close()


def test_concurrent_requests_coalesce(served_batching):
    """Four concurrent single-record requests are served correctly through
    the batching queue and coalesce into fewer batches; /statz counts
    them; each answer equals the combined request's."""
    port, data_path, calls = served_batching
    records = list(tfrecord_io.read_tfrecords(data_path))
    calls["n"] = 0
    results = [None] * 4
    errors = []

    def worker(i):
        try:
            status, body = _post(port, "/predict", serving.frame_records([records[i]]))
            assert status == 200, body
            results[i] = json.loads(body)["predictions"]
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    for preds in results:
        assert preds is not None and len(preds) == 1
        p = preds[0]
        assert p["video_index"] == 0
        assert len(p["classes"]) == 4 and p["scores"] == sorted(p["scores"], reverse=True)
    assert calls["n"] < 4, f"no coalescing happened ({calls['n']} dispatches)"

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/statz")
    stats = json.loads(conn.getresponse().read())
    assert stats["requests"] >= 4 and stats["rows"] >= 4
    assert stats["coalesced"] >= 2
    assert stats["executes"] <= stats["requests"]

    status, body = _post(port, "/predict", serving.frame_records(records[:4]))
    combined = json.loads(body)["predictions"]
    for i in range(4):
        assert results[i][0]["classes"] == combined[i]["classes"]
        np.testing.assert_allclose(results[i][0]["scores"], combined[i]["scores"], atol=1e-6)


def test_batching_queue_error_isolated(served_batching):
    """A malformed record fails its own request without killing the loop."""
    port, data_path, _ = served_batching
    status, body = _post(port, "/predict", serving.frame_records([b"garbage"]))
    assert status == 400
    records = list(tfrecord_io.read_tfrecords(data_path))
    status, body = _post(port, "/predict", serving.frame_records(records[:1]))
    assert status == 200, body


@pytest.fixture(scope="module")
def netvlad_export(tmp_path_factory):
    d = tmp_path_factory.mktemp("netvlad")
    tree = weights.init_variables_np(NETVLAD, FRAME_FCFG, seed=0)
    export_dir = em.export_model(str(d / "export"), "NetVLADModelLF", NETVLAD, FRAME_FCFG, tree["params"],
                                 tree["batch_stats"], top_k=3)
    rng = np.random.default_rng(0)
    rec = fixtures.encode_frame_sequence_example(b"v0", [1], rng.integers(0, 256, (6, 1024), dtype=np.uint8),
                                                 rng.integers(0, 256, (6, 128), dtype=np.uint8))
    return export_dir, rec, d


def test_fast_serve_netvlad(netvlad_export):
    """--fast_serve: a frame-level NetVLAD export served through the fast
    path (its plain versions on the CPU) returns valid top-k output and
    selects the fast path."""
    export_dir, rec, _ = netvlad_export
    server = serving.ModelServer(export_dir, 2, fast_serve=True, device="cpu")
    assert server.model is None  # the fast route serves
    out = server.predict([rec, rec])
    assert len(out) == 2
    for row in out:
        assert len(row["classes"]) == 3 and len(row["scores"]) == 3
        assert all(0 <= c < 12 for c in row["classes"])
        assert sorted(row["scores"], reverse=True) == row["scores"]


def test_fast_serve_int8_hidden(netvlad_export):
    """--int8_hidden: the same export served bf16-fast and int8-fast agrees
    within the quantization envelope; the flag raises without
    --fast_serve and on a model without the giant hidden FC."""
    export_dir, rec, d = netvlad_export
    out_bf16 = serving.ModelServer(export_dir, 2, fast_serve=True, device="cpu").predict([rec, rec])
    out_i8 = serving.ModelServer(export_dir, 2, fast_serve=True, int8_hidden=True,
                                 device="cpu").predict([rec, rec])
    for row8, row16 in zip(out_i8, out_bf16):
        assert len(row8["classes"]) == 3
        s8 = dict(zip(row8["classes"], row8["scores"]))
        s16 = dict(zip(row16["classes"], row16["scores"]))
        shared = set(s8) & set(s16)
        assert shared
        for c in shared:
            assert abs(s8[c] - s16[c]) < 5e-2

    with pytest.raises(ValueError, match="int8_hidden requires"):
        serving.ModelServer(export_dir, 2, fast_serve=False, int8_hidden=True, device="cpu")
    mcfg_d = ModelConfig(vocab_size=12, dbof_cluster_size=8, dbof_hidden_size=8, iterations=6)
    tree = weights.init_variables_np(mcfg_d, FRAME_FCFG, seed=0, model_name="DbofModel")
    export_d = em.export_model(str(d / "export_dbof"), "DbofModel", mcfg_d, FRAME_FCFG, tree["params"],
                               tree["batch_stats"], top_k=3)
    with pytest.raises(ValueError, match="int8_hidden requires"):
        em.load_exported_model(export_d, prefer_fast=True, int8_hidden=True, device="cpu")


@pytest.mark.parametrize("model_name,cfg_kw", [
    ("TransformerEncoderModel", dict(attention_hidden_size=16, attention_heads=2, transformer_layers=1,
                                     transformer_ff_size=24)),
    ("NeXtVLADModel", dict(nextvlad_cluster_size=8, nextvlad_hidden_size=16, iterations=6)),
])
def test_try_fast_predict_covers_new_models(model_name, cfg_kw):
    """_try_fast_predict selects the transformer and NeXtVLAD fast paths;
    their top-k is sorted probabilities, and the transformer's (which
    samples no frames) matches the model-forward route's within the bf16
    tolerance."""
    import torch

    mcfg = ModelConfig(vocab_size=12, presampled=False, **cfg_kw)
    tree = weights.init_variables_np(mcfg, FRAME_FCFG, seed=0, model_name=model_name)
    fast = em._try_fast_predict(model_name, mcfg, tree, 3, device="cpu")
    assert fast is not None, f"fast path not selected for {model_name}"
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.integers(0, 256, size=(2, 6, 1152), dtype=np.uint8))
    nf = torch.tensor([6, 3], dtype=torch.int32)
    vals, idxs = fast(feats, nf)
    assert vals.shape == (2, 3) and idxs.shape == (2, 3)
    v = vals.float().numpy()
    assert np.all(np.diff(v, axis=1) <= 1e-7)
    assert np.all((v >= 0) & (v <= 1))
    if model_name == "TransformerEncoderModel":
        model = create_model(model_name, mcfg, FRAME_FCFG.total_size)
        weights.load_flax_variables(model, tree)
        with torch.no_grad():
            probs = model(preprocess_input(feats), nf, training=False)["predictions"]
        want = np.sort(probs.numpy(), axis=1)[:, ::-1][:, :3]
        np.testing.assert_allclose(v, want, atol=3e-2)
        want_vals, _ = make_predict_step(model.eval(), mcfg, True, top_k=3)(feats, nf)
        np.testing.assert_allclose(v, want_vals.numpy(), atol=3e-2)


def test_native_serve_raises_naming_item_14b(served):
    """(Named for the refusal it held before item 14b landed.)
    --native_serve runs the native runner on the card: on the CPU the
    server and the CLI raise ValueError, and with --fast_serve JAX's
    ValueError (tests/test_torch_native_export.py has the rest)."""
    _, _, export_dir = served
    with pytest.raises(ValueError, match="runs on the card"):
        serving.ModelServer(export_dir, 4, native=True, device="cpu")
    with pytest.raises(ValueError, match="runs on the card"):
        serving.main([f"--export_dir={export_dir}", "--native_serve", "--device=cpu"])
    with pytest.raises(ValueError, match="exclusive with --fast_serve/--int8_hidden"):
        serving.ModelServer(export_dir, 4, native=True, fast_serve=True, device="cpu")
    with pytest.raises(ValueError, match="exclusive with --fast_serve/--int8_hidden"):
        serving.main([f"--export_dir={export_dir}", "--native_serve", "--fast_serve", "--device=cpu"])


class _Noop:
    batch_size = 4


def test_batching_queue_bounded():
    """submit() raises queue.Full at saturation (the handler's 503) instead
    of buffering without bound."""
    q = serving.BatchingQueue(_Noop())  # dispatch loop NOT running
    for _ in range(serving.BatchingQueue.MAX_QUEUED):
        q.submit([b"r"])
    with pytest.raises(queue.Full):
        q.submit([b"r"])


def test_batching_queue_shutdown_fails_stragglers():
    """Requests queued behind the shutdown sentinel get a clear exception,
    not a silent 300 s Future timeout."""
    q = serving.BatchingQueue(_Noop())
    q.shutdown()
    fut = q.submit([b"r"])
    q.run_forever()
    with pytest.raises(RuntimeError, match="shutting down"):
        fut.result(timeout=5)
