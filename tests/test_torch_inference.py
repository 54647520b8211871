"""Port ingest and inference CLI ≡ the JAX package on the same TFRecords."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import step as step_lib
from learnablepoolingmethods_tpu.data import fixtures as jfix
from learnablepoolingmethods_tpu.data.pipeline import batch_iterator as j_batch_iterator
from learnablepoolingmethods_tpu.data.readers import YT8MFrameFeatureReader as JReader
from learnablepoolingmethods_tpu.models import create_model
from learnablepoolingmethods_tpu.ops import fast_infer as jfi
from learnablepoolingmethods_tpu.utils.misc import format_lines as j_format_lines
from learnablepoolingmethods_torch import inference
from learnablepoolingmethods_torch.core.weights import save_variables_npz
from learnablepoolingmethods_torch.data import fixtures as tfix
from learnablepoolingmethods_torch.data.pipeline import batch_iterator
from learnablepoolingmethods_torch.data.readers import YT8MFrameFeatureReader
from learnablepoolingmethods_torch.utils.misc import InFlight, format_lines

CFG_KW = dict(vocab_size=20, iterations=6, netvlad_cluster_size=8, netvlad_hidden_size=16)


def test_fixture_writer_and_reader_match_jax(tmp_path):
    port_file, jax_file = str(tmp_path / "p.tfrecord"), str(tmp_path / "j.tfrecord")
    tfix.write_frame_level_fixture(port_file, 5, num_classes=50, max_frames=12, seed=3)
    jfix.write_frame_level_fixture(jax_file, 5, num_classes=50, max_frames=12, seed=3)
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    got = list(YT8MFrameFeatureReader(50, max_frames=8).read_file(port_file))
    want = list(JReader(50, max_frames=8).read_file(port_file))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype
    # padded final batch with a weights mask, as the JAX pipeline
    got_b = list(batch_iterator(YT8MFrameFeatureReader(50, max_frames=8), port_file, 3))
    want_b = list(j_batch_iterator(JReader(50, max_frames=8), port_file, 3))
    for g, w in zip(got_b, want_b):
        for key in ("features", "labels", "weights", "num_frames", "video_id"):
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))


def _frame_list(frames, change=None):
    """A FeatureList of one BytesList Feature a frame, the ``change`` frame
    index holding a second value and an unknown field after it."""
    out = b""
    for i, row in enumerate(frames):
        feature = tfix._feature_bytes([row.tobytes()] + ([b"x"] if i == change else []))
        out += tfix._len_delim(1, feature + (b"\x20\x07" if i == change else b""))
    return out


@pytest.mark.parametrize("change", [None, 0, 4])
def test_frame_reader_matches_jax_on_other_encodings(tmp_path, change):
    """Frames stored one BytesList value a Feature are read as one strided
    view; a FeatureList with a frame in another encoding (``change``: a
    second value and an unknown field) is decoded Feature by Feature.  The
    records match the JAX reader's either way."""
    rng = np.random.default_rng(5)
    path = str(tmp_path / "f.tfrecord")
    with open(path, "wb") as f:
        for v, n in enumerate((7, 1, 12)):
            rgb, audio = (rng.integers(0, 256, (n, d), dtype=np.uint8) for d in (1024, 128))
            lists = b"".join(tfix._len_delim(1, tfix._len_delim(1, name.encode()) + tfix._len_delim(2, body))
                             for name, body in (("rgb", _frame_list(rgb, change)), ("audio", _frame_list(audio))))
            context = tfix._features_map({"id": tfix._feature_bytes([f"v{v}".encode()]),
                                          "labels": tfix._feature_ints([v, 3 * v + 1])})
            tfix.write_tfrecord(f, tfix._len_delim(1, context) + tfix._len_delim(2, lists))
    got = list(YT8MFrameFeatureReader(50, max_frames=10).read_file(path))
    want = list(JReader(50, max_frames=10).read_file(path))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)


def test_shuffled_epochs_match_jax(tmp_path):
    """File-order shuffle, the bounded shuffle buffer and epochs draw from
    one ``random.Random(seed)`` in both packages: same batches, same order."""
    pattern = str(tmp_path / "in-*.tfrecord")
    for i in range(3):
        tfix.write_frame_level_fixture(str(tmp_path / f"in-{i}.tfrecord"), 4, num_classes=10,
                                       max_frames=3, seed=i)
    kw = dict(num_epochs=2, shuffle=True, shuffle_buffer=3, seed=7, pad_final_batch=False)
    got = list(batch_iterator(YT8MFrameFeatureReader(10, max_frames=3), pattern, 5, **kw))
    want = list(j_batch_iterator(JReader(10, max_frames=3), pattern, 5, **kw))
    assert [b["video_id"] for b in got] == [b["video_id"] for b in want]
    assert len(got) == 5 and len(got[-1]["video_id"]) == 4  # 24 videos, unpadded tail
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["features"], w["features"])


def test_format_lines_byte_identical(rng):
    vids = [b"abc", "def", b"g"]
    values = rng.random((3, 4)).astype(np.float32)
    indices = rng.integers(0, 3862, size=(3, 4))
    assert list(format_lines(vids, values, indices)) == list(j_format_lines(vids, values, indices))


def test_in_flight_keeps_fifo_order():
    pipe = InFlight(2)
    assert pipe.add(1) is None and pipe.add(2) == 1 and pipe.add(3) == 2
    assert list(pipe.drain()) == [3]


def _parse(csv_text):
    rows = csv_text.strip().split("\n")
    assert rows[0] == "VideoId,LabelConfidencePairs"
    out = {}
    for row in rows[1:]:
        vid, pairs = row.split(",")
        nums = pairs.split()
        out[vid] = ([int(i) for i in nums[::2]], np.array([float(v) for v in nums[1::2]]))
    return out


def test_cli_csv_matches_jax_fast_path(tmp_path, rng):
    """Videos of 1 to 12 frames: the port's CLI draws each batch's frames
    from fold_in(key(0), batch) bit for bit as the JAX CLI does, so its CSV
    (fused route, plain version on the CPU) equals the JAX fused route's
    (interpret mode) video by video."""
    data = str(tmp_path / "in-0.tfrecord")
    tfix.write_frame_level_fixture(data, 6, num_classes=20, max_frames=12, seed=5)
    feats = rng.integers(0, 256, size=(2, 4, 1152), dtype=np.uint8)
    jcfg = JModelConfig(**CFG_KW)
    variables = create_model("NetVLADModelLF", jcfg).init(
        {"params": jax.random.key(0), "sampling": jax.random.key(1)},
        step_lib.preprocess_input(jnp.asarray(feats)), num_frames=jnp.asarray([4, 4]),
        training=True,
    )
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    save_variables_npz(jax.tree.map(np.asarray, variables), str(tmp_path))

    out = str(tmp_path / "out.csv")
    n = inference.main([
        "--fast_infer", "--model=NetVLADModelLF", "--frame_features",
        "--feature_names=rgb,audio", "--feature_sizes=1024,128", "--max_frames=12",
        f"--input_data_pattern={data}", f"--train_dir={tmp_path}", f"--output_file={out}",
        "--batch_size=4", "--num_classes=20", "--iterations=6",
        "--netvlad_cluster_size=8", "--netvlad_hidden_size=16", "--top_k=5", "--device=cpu",
    ])
    assert n == 6

    jfp = jfi.prepare_fast_params(variables, jcfg)
    fast = jfi.build_fast_netvlad_inference(jcfg, top_k=5, use_pallas=True, pallas_interpret=True)
    lines = ["VideoId,LabelConfidencePairs\n"]
    for i, batch in enumerate(j_batch_iterator(JReader(20, max_frames=12), data, 4)):
        vals, idx = fast(jfp, jnp.asarray(batch["features"]), jnp.asarray(batch["num_frames"]),
                         jax.random.fold_in(jax.random.key(0), i))
        real = batch["weights"] > 0
        vids = [v for v, keep in zip(batch["video_id"], real) if keep]
        lines += j_format_lines(vids, np.asarray(vals)[real], np.asarray(idx)[real])
    want = _parse("".join(lines))
    with open(out) as f:
        got = _parse(f.read())
    assert got.keys() == want.keys() and len(got) == 6
    nfs = {t["video_id"].decode(): t["num_frames"] for t in tfix.write_frame_level_fixture(
        str(tmp_path / "again.tfrecord"), 6, num_classes=20, max_frames=12, seed=5)}
    assert max(nfs.values()) > 1  # the sampler's draws decide which frames are read
    for vid, (g_idx, g_val) in got.items():
        w_idx, w_val = want[vid]
        assert g_idx == w_idx, vid
        # same bf16 rounding points, f32 sums in another order, 6 printed decimals
        np.testing.assert_allclose(g_val, w_val, atol=1e-5)
        assert np.all(np.diff(g_val) <= 0)


def test_entry_point_defaults_to_cuda_and_refuses_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main([
            "--fast_infer", "--model=NetVLADModelLF", "--frame_features",
            f"--input_data_pattern={tmp_path}/none*", f"--output_file={tmp_path}/o.csv",
        ])
    # the model-forward route (without --fast_infer) defaults to the card too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main([f"--input_data_pattern={tmp_path}/x", f"--output_file={tmp_path}/o.csv"])
