"""The port's packed cache (``data/packed_cache.py``) ≡ the JAX package's:
the same files byte for byte, each package reading the other's cache, and
the same batches for the same seed (shuffled, sharded, padded)."""

import json
import os

import numpy as np
import pytest

from learnablepoolingmethods_tpu.data import packed_cache as jpacked
from learnablepoolingmethods_torch.data import fixtures, packed_cache, pipeline
from learnablepoolingmethods_torch.data.readers import YT8MAggregatedFeatureReader, YT8MFrameFeatureReader

V, SIZES, MAXF = 10, (6, 2), 7
FILES = ("features.npy", "num_frames.npy", "video_ids.npy", "label_indices.npy", "label_offsets.npy", "meta.json")
FRAME_KW = dict(frame_level=True, feature_sizes=SIZES, feature_names=("rgb", "audio"), num_classes=V,
                max_frames=MAXF, num_workers=2)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    d = tmp_path_factory.mktemp("packed")
    for i, (n, seed) in enumerate(((13, 5), (8, 6))):
        fixtures.write_frame_level_fixture(str(d / f"f-{i}.tfrecord"), n, num_classes=V, rgb_size=SIZES[0],
                                           audio_size=SIZES[1], max_frames=MAXF, seed=seed)
    data = str(d / "f-*.tfrecord")
    return {"data": data, "port": packed_cache.build_cache(data, str(d / "port"), **FRAME_KW),
            "jax": jpacked.build_cache(data, str(d / "jax"), **FRAME_KW)}


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and g["video_id"] == w["video_id"]
        for k in g:
            if k != "video_id":
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_cache_files_equal_a_jax_built_cache(caches):
    for name in FILES:
        with open(os.path.join(caches["port"], name), "rb") as a, open(os.path.join(caches["jax"], name), "rb") as b:
            assert a.read() == b.read(), name
    assert json.load(open(os.path.join(caches["port"], "meta.json")))["num_examples"] == 21


@pytest.mark.parametrize("kw", [
    dict(batch_size=8),
    dict(batch_size=8, num_epochs=2, shuffle=True, seed=3),
    dict(batch_size=4, num_epochs=2, shuffle=True, seed=3, shard_index=1, num_shards=2),
    dict(batch_size=8, pad_final_batch=False),
    dict(batch_size=21, shuffle=True, seed=0),
], ids=["in_order", "shuffled", "sharded", "unpadded", "one_batch"])
def test_batches_equal_jax_and_each_reads_the_others_cache(caches, kw):
    want = list(jpacked.packed_batch_iterator(caches["jax"], **kw))
    _assert_batches_equal(list(packed_cache.packed_batch_iterator(caches["port"], **kw)), want)
    _assert_batches_equal(list(packed_cache.packed_batch_iterator(caches["jax"], **kw)), want)
    _assert_batches_equal(list(jpacked.packed_batch_iterator(caches["port"], **kw)), want)
    rows = len(range(kw.get("shard_index", 0), 21, kw.get("num_shards", 1)))
    if kw.get("pad_final_batch", True) and rows % kw["batch_size"]:
        assert want[-1]["weights"].min() == 0 and want[-1]["video_id"][-1] == b""


def test_in_order_batches_equal_the_streaming_reader(caches):
    reader = YT8MFrameFeatureReader(V, SIZES, ("rgb", "audio"), MAXF)
    _assert_batches_equal(list(packed_cache.packed_batch_iterator(caches["port"], 8)),
                          list(pipeline.batch_iterator(reader, caches["data"], 8)))


def test_video_level_cache_equals_jax(tmp_path):
    data = str(tmp_path / "v.tfrecord")
    fixtures.write_video_level_fixture(data, 9, num_classes=V, rgb_size=SIZES[0], audio_size=SIZES[1])
    kw = dict(frame_level=False, feature_sizes=SIZES, num_classes=V)
    port = packed_cache.build_cache(data, str(tmp_path / "port"), **kw)
    jax_dir = jpacked.build_cache(data, str(tmp_path / "jax"), **kw)
    for name in set(FILES) - {"num_frames.npy"}:
        with open(os.path.join(port, name), "rb") as a, open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    assert not os.path.exists(os.path.join(port, "num_frames.npy"))
    reader = YT8MAggregatedFeatureReader(V, SIZES, ("mean_rgb", "mean_audio"))
    _assert_batches_equal(list(packed_cache.packed_batch_iterator(port, 4)),
                          list(pipeline.batch_iterator(reader, data, 4)))


def test_freshness_idempotence_and_the_builder_cli(caches, tmp_path, capsys):
    """A fresh cache (either package's) is reused untouched; another source
    makes it stale; the module's CLI builds what build_cache builds."""
    mtime = os.path.getmtime(os.path.join(caches["port"], "features.npy"))
    assert packed_cache.build_cache(caches["data"], caches["port"], **FRAME_KW) == caches["port"]
    assert os.path.getmtime(os.path.join(caches["port"], "features.npy")) == mtime
    assert packed_cache.is_fresh(caches["jax"], caches["data"]) and jpacked.is_fresh(caches["port"], caches["data"])
    assert packed_cache.wait_for_cache(caches["port"], caches["data"], timeout_s=1) == caches["port"]
    assert not packed_cache.is_fresh(caches["port"], caches["data"].replace("f-*", "f-0*"))
    assert not packed_cache.is_fresh(str(tmp_path / "none"), caches["data"])
    with pytest.raises(TimeoutError):
        packed_cache.wait_for_cache(str(tmp_path / "none"), caches["data"], timeout_s=0)
    out = str(tmp_path / "cli")
    packed_cache.main(["--input_pattern", caches["data"], "--output_dir", out, "--frame_features",
                       "--feature_sizes=6,2", "--num_classes=10", "--max_frames=7", "--num_workers=2"])
    assert json.loads(capsys.readouterr().out)["num_examples"] == 21
    for name in FILES:
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(caches["port"], name), "rb") as b:
            assert a.read() == b.read(), name


def test_a_truncated_source_fails_the_build_in_both_packages(caches, tmp_path):
    src = caches["data"].replace("*", "0")
    blob = open(src, "rb").read()
    cut = str(tmp_path / "cut.tfrecord")
    with open(cut, "wb") as f:
        f.write(blob[:-30])
    with pytest.raises(IOError, match="record count drifted"):
        packed_cache.build_cache(cut, str(tmp_path / "port"), **FRAME_KW)
    with pytest.raises(AssertionError, match="record count drifted"):
        jpacked.build_cache(cut, str(tmp_path / "jax"), **FRAME_KW)
    assert not os.path.exists(str(tmp_path / "port" / "meta.json"))
