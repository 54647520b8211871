"""Weight bridge: init_variables_np mirrors flax ``model.init``; the npz
round trip is lossless."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import step as step_lib
from learnablepoolingmethods_tpu.models import create_model
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import weights

BASE = dict(vocab_size=20, iterations=6, netvlad_cluster_size=8, netvlad_hidden_size=16)


def _shapes(tree):
    return {
        jax.tree_util.keystr(path): tuple(np.shape(leaf))
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


@pytest.mark.parametrize(
    "extra, sizes",
    [
        ({}, (1024, 128)),                                 # Willow layout, narrow
        ({}, (32, 8)),                                     # single pooling module
        ({"netvlad_relu": True, "gating": False}, (1024, 128)),  # hidden BN, no gating
    ],
)
def test_init_variables_np_matches_flax_init(rng, extra, sizes):
    kw = dict(BASE, **extra)
    feats = rng.integers(0, 256, size=(2, 6, sum(sizes)), dtype=np.uint8)
    model = create_model("NetVLADModelLF", JModelConfig(**kw, presampled=True))
    want = model.init(
        {"params": jax.random.key(0), "sampling": jax.random.key(1)},
        step_lib.preprocess_input(jnp.asarray(feats)), num_frames=jnp.asarray([6, 6]),
        training=True,
    )
    fcfg = FeatureConfig(("rgb", "audio"), sizes, True, 6)
    got = weights.init_variables_np(ModelConfig(**kw), fcfg, seed=0)
    assert _shapes(got) == _shapes({"params": want["params"], "batch_stats": want["batch_stats"]})
    for leaf in jax.tree_util.tree_leaves(got):
        assert leaf.dtype == np.float32


def test_init_variables_np_scales():
    mcfg = ModelConfig(**dict(BASE, netvlad_cluster_size=64, netvlad_hidden_size=64, vocab_size=500))
    tree = weights.init_variables_np(mcfg, FeatureConfig(("rgb", "audio"), (1024, 128), True), seed=1)
    p, s = tree["params"], tree["batch_stats"]
    # normal(1/√fan): a few thousand draws each, so 5 % holds with room
    np.testing.assert_allclose(np.std(p["hidden1_weights"]), 1 / np.sqrt(64), rtol=0.05)
    np.testing.assert_allclose(np.std(p["NetVLAD_0"]["cluster_weights"]), 1 / np.sqrt(1024), rtol=0.05)
    np.testing.assert_allclose(np.std(p["gating"]["gating_weights"]), 1 / np.sqrt(64), rtol=0.05)
    lim = np.sqrt(6 / (64 + 3 * 500))  # xavier-uniform bound of gates_kernel
    assert np.abs(p["MoeModel_0"]["gates_kernel"]).max() <= lim
    assert np.abs(p["MoeModel_0"]["gates_kernel"]).max() > 0.95 * lim
    assert not p["MoeModel_0"]["experts_bias"].any()
    np.testing.assert_array_equal(s["input_bn"]["var"], 1.0)
    np.testing.assert_array_equal(p["input_bn"]["scale"], 1.0)
    again = weights.init_variables_np(mcfg, FeatureConfig(("rgb", "audio"), (1024, 128), True), seed=1)
    np.testing.assert_array_equal(again["params"]["hidden1_weights"], p["hidden1_weights"])


@pytest.mark.parametrize("as_dir", [True, False])
def test_npz_round_trip_is_lossless(tmp_path, as_dir):
    mcfg = ModelConfig(**BASE)
    tree = weights.init_variables_np(mcfg, FeatureConfig(("rgb", "audio"), (1024, 128), True), seed=2)
    tree["batch_stats"]["input_bn"]["mean"] += np.float32(0.25)
    target = str(tmp_path) if as_dir else str(tmp_path / "w.npz")
    written = weights.save_variables_npz(tree, target)
    assert written.endswith("variables.npz" if as_dir else "w.npz")
    back = weights.load_variables_npz(target)
    assert _shapes(back) == _shapes(tree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree), jax.tree_util.tree_leaves(back)):
        assert b.dtype == a.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(b, a)
    with np.load(written) as data:
        assert "params/NetVLAD_0/cluster_weights" in data.files
