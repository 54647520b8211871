"""Video-level input and the single-layer models of the port ≡ the JAX
package's, on the CPU: LogisticModel and MoeModel (as a top-level model)
against flax's forward within 1e-5 in f32; the video-level reader against
JAX's on the same files; the port's copies of the fixture writers write the
JAX writers' bytes; and the weight bridge carries the flax trees of
LogisticModel, MoeModel, FrameLevelLogisticModel and DbofModel across, its
NumPy init drawing the same key set and shapes as flax's init."""

import dataclasses
import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.data import fixtures as jfixtures
from learnablepoolingmethods_tpu.data import readers as jreaders
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.data import fixtures, readers
from learnablepoolingmethods_torch.models import create_model

KW = dict(vocab_size=31, moe_num_mixtures=3, dbof_cluster_size=24, dbof_hidden_size=12)
B, D = 7, 40


def _flax(name, x, frame=False, nf=None, cfg_kw=None):
    jmodel = jcreate(name, JModelConfig(**{**KW, **(cfg_kw or {})}))
    batch = {"features": x}
    if nf is not None:
        batch["num_frames"] = nf
    params, stats = jstep.init_model_variables(jmodel, batch, frame)
    return jmodel, jax.tree.map(np.asarray, {"params": params, "batch_stats": stats})


@pytest.mark.parametrize("name", ["LogisticModel", "MoeModel"])
def test_video_level_model_matches_flax(name, rng):
    x = rng.normal(scale=0.5, size=(B, D)).astype(np.float32)
    jmodel, tree = _flax(name, x)
    want = jmodel.apply(tree, jstep.preprocess_input(jnp.asarray(x)), training=False)["predictions"]
    port = weights.load_flax_variables(create_model(name, ModelConfig(**KW), D), tree)
    got = port(tstep.preprocess_input(torch.from_numpy(x)), training=False)["predictions"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_video_level_reader_matches_jax(tmp_path):
    path = str(tmp_path / "v-0.tfrecord")
    truth = fixtures.write_video_level_fixture(path, 9, num_classes=50, rgb_size=12, audio_size=4, seed=5)
    kw = dict(num_classes=50, feature_sizes=(12, 4))
    got = list(readers.YT8MAggregatedFeatureReader(**kw).read_file(path))
    want = list(jreaders.YT8MAggregatedFeatureReader(**kw).read_file(path))
    assert len(got) == len(want) == len(truth)
    for g, w, t in zip(got, want, truth):
        assert g["video_id"] == w["video_id"] == t["video_id"] and set(g) == set(w)
        np.testing.assert_array_equal(g["features"], w["features"])
        np.testing.assert_array_equal(g["features"], np.r_[t["mean_rgb"], t["mean_audio"]])
        np.testing.assert_array_equal(g["labels"], w["labels"])
    # make_reader picks by --frame_features, as flags.py#make_reader does
    fcfg = FeatureConfig(("mean_rgb", "mean_audio"), (12, 4), False)
    assert isinstance(readers.make_reader(fcfg, 50), readers.YT8MAggregatedFeatureReader)
    assert isinstance(readers.make_reader(dataclasses.replace(fcfg, frame_features=True), 50),
                      readers.YT8MFrameFeatureReader)


WRITERS = {
    "write_video_level_fixture": dict(num_videos=6, num_classes=40, rgb_size=8, audio_size=3, seed=2),
    "make_learnable_synthetic_video_level": dict(num_videos=10, num_classes=7, seed=3),
    "make_learnable_synthetic_frame_level": dict(num_videos=6, num_classes=40, rgb_size=9, audio_size=3,
                                                 max_frames=7, seed=7, label_threshold=2.0,
                                                 min_labels=3),
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_fixture_writer_writes_the_jax_bytes(tmp_path, writer):
    a, b = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    got = getattr(fixtures, writer)(a, **WRITERS[writer])
    want = getattr(jfixtures, writer)(b, **WRITERS[writer])
    assert filecmp.cmp(a, b, shallow=False)
    assert [t["labels"] for t in got] == [t["labels"] for t in want]


INIT_CASES = {
    "LogisticModel": ({}, False),
    "MoeModel": ({}, False),
    "FrameLevelLogisticModel": ({}, True),
    "DbofModel": ({}, True),
    "DbofModel-nobn": ({"dbof_add_batch_norm": False}, True),
}


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_init_variables_np_has_flax_keys_and_shapes(case, rng):
    name = case.split("-")[0]
    cfg_kw, frame = INIT_CASES[case]
    if frame:
        x = rng.integers(0, 256, size=(2, 5, D), dtype=np.uint8)
        _, tree = _flax(name, x, True, np.array([5, 2], np.int32), cfg_kw)
    else:
        _, tree = _flax(name, rng.normal(size=(2, D)).astype(np.float32))
    mcfg = ModelConfig(**KW, **cfg_kw)
    ours = weights.init_variables_np(mcfg, FeatureConfig(("rgb", "audio"), (D - 8, 8), frame),
                                     seed=0, model_name=name)
    shapes = jax.tree.map(np.shape, ours)
    assert shapes == jax.tree.map(np.shape, tree)
    # both trees load into the port's model, and the bridge's checks pass
    for t in (ours, tree):
        weights.load_flax_variables(create_model(name, mcfg, D), t)
        converted = weights.convert_flax_variables(t, mcfg, name)
        assert jax.tree.map(lambda a: tuple(a.shape), converted) == shapes


def test_convert_flax_variables_rejects_a_wrong_width(rng):
    x = rng.integers(0, 256, size=(2, 5, D), dtype=np.uint8)
    _, tree = _flax("DbofModel", x, True, np.array([5, 2], np.int32))
    with pytest.raises(ValueError, match="cluster_weights: shape"):
        weights.convert_flax_variables(tree, ModelConfig(**{**KW, "dbof_cluster_size": 8}), "DbofModel")
    _, tree = _flax("MoeModel", rng.normal(size=(2, D)).astype(np.float32))
    with pytest.raises(ValueError, match="gates_kernel"):
        weights.convert_flax_variables(tree, ModelConfig(**{**KW, "vocab_size": 30}), "MoeModel")
