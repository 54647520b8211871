"""The port's LF models (NetRVLADModelLF, NetFVModelLF, SoftDbofModelLF,
NeXtVLADModel as nn.Modules) ≡ the JAX package's flax models on the CPU:
the inference forward and one training forward with the BN batch
statistics, from the same variables carried across by
core/weights.py#load_flax_variables.  The configuration is that of
tests/unit/test_fast_lf.py with a narrower hidden layer."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_torch import train
from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.models import create_model, list_models
from learnablepoolingmethods_torch.models.frame_level import lf_layout

LF = ["NetFVModelLF", "NetRVLADModelLF", "SoftDbofModelLF", "NeXtVLADModel"]
KW = dict(iterations=12, vocab_size=29, fv_cluster_size=8, rvlad_cluster_size=8, dbow_cluster_size=16,
          nextvlad_cluster_size=8, netvlad_hidden_size=32, fv_hidden_size=32, nextvlad_hidden_size=32,
          presampled=True)
B, F = 3, 12


def _flax(model_name, sizes=(1024, 128), extra=None, seed=0):
    """A flax model's variables with perturbed BN statistics, and uint8
    frames: (tree of NumPy arrays, frames, num_frames, flax model)."""
    rng = np.random.default_rng(seed)
    cfg = JModelConfig(**KW, **(extra or {}))
    model = jcreate(model_name, cfg)
    x_u8 = rng.integers(0, 256, size=(B, F, sum(sizes)), dtype=np.uint8)
    nf = rng.integers(4, F + 1, size=(B,)).astype(np.int32)
    params, stats = jstep.init_model_variables(model, {"features": x_u8, "num_frames": nf}, True)
    stats = jax.tree.map(lambda s: s + 0.05 * np.abs(rng.normal(size=s.shape)).astype(np.float32), stats)
    tree = jax.tree.map(np.asarray, {"params": params, "batch_stats": stats})
    return tree, x_u8, nf, model


def _port(model_name, tree, width, extra=None):
    cfg = ModelConfig(**KW, **(extra or {}))
    return weights.load_flax_variables(create_model(model_name, cfg, width), tree)


@pytest.mark.parametrize("model_name", LF)
def test_eval_forward_matches_flax(model_name):
    tree, x_u8, nf, model = _flax(model_name)
    x = jstep.preprocess_input(jnp.asarray(x_u8), jnp.float32)
    want = model.apply(tree, x, num_frames=jnp.asarray(nf), training=False)["predictions"]
    port = _port(model_name, tree, x_u8.shape[-1])
    got = port(tstep.preprocess_input(torch.from_numpy(x_u8)), torch.from_numpy(nf), training=False)
    # f32 throughout, sums in another order (tests/unit/test_fast_lf.py:79)
    np.testing.assert_allclose(got["predictions"].detach().numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("model_name", LF)
def test_training_forward_and_bn_statistics_match_flax(model_name):
    tree, x_u8, nf, model = _flax(model_name, seed=1)
    x = jstep.preprocess_input(jnp.asarray(x_u8), jnp.float32)
    out, mutated = model.apply(tree, x, num_frames=jnp.asarray(nf), training=True,
                               mutable=["batch_stats"])
    port = _port(model_name, tree, x_u8.shape[-1])
    got = port(tstep.preprocess_input(torch.from_numpy(x_u8)), torch.from_numpy(nf), training=True)
    np.testing.assert_allclose(got["predictions"].detach().numpy(), np.asarray(out["predictions"]),
                               atol=2e-4)
    got_stats = weights.state_dict_to_flax(port)["batch_stats"]
    want_stats = jax.tree.map(np.asarray, mutated["batch_stats"])
    assert jax.tree_util.tree_structure(got_stats) == jax.tree_util.tree_structure(want_stats)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_stats),
                            jax.tree_util.tree_leaves(got_stats)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=jax.tree_util.keystr(path))


def test_netfv_coupled_weights_and_single_module_match_flax():
    """--fv_couple_weights (σ from the cluster weights, covar_weights unused
    but present) on 40 columns, where one module pools them all."""
    extra = {"fv_couple_weights": True, "fv_coupling_factor": 0.5}
    tree, x_u8, nf, model = _flax("NetFVModelLF", sizes=(32, 8), extra=extra)
    assert "NetFV_1" not in tree["params"] and "covar_weights" in tree["params"]["NetFV_0"]
    x = jstep.preprocess_input(jnp.asarray(x_u8), jnp.float32)
    want = model.apply(tree, x, num_frames=jnp.asarray(nf), training=False)["predictions"]
    port = _port("NetFVModelLF", tree, 40, extra)
    got = port(tstep.preprocess_input(torch.from_numpy(x_u8)), torch.from_numpy(nf), training=False)
    np.testing.assert_allclose(got["predictions"].detach().numpy(), np.asarray(want), atol=2e-4)


def test_nextvlad_adjusts_its_groups_and_says_so(caplog):
    """λ·D = 20 on a 10-column audio input: G drops from 8 to 5, in both
    packages, with a warning."""
    tree, x_u8, nf, model = _flax("NeXtVLADModel", sizes=(1024, 10))
    assert tree["params"]["NeXtVLAD_1"]["group_attention_weights"].shape == (20, 5)
    layout = lf_layout("NeXtVLADModel", ModelConfig(**KW), 1034)
    assert [m.groups for m in layout] == [8, 5]
    with caplog.at_level(logging.WARNING):
        port = _port("NeXtVLADModel", tree, 1034)
    assert "groups adjusted 8 -> 5" in caplog.text
    x = jstep.preprocess_input(jnp.asarray(x_u8), jnp.float32)
    want = model.apply(tree, x, num_frames=jnp.asarray(nf), training=False)["predictions"]
    got = port(tstep.preprocess_input(torch.from_numpy(x_u8)), torch.from_numpy(nf), training=False)
    np.testing.assert_allclose(got["predictions"].detach().numpy(), np.asarray(want), atol=2e-4)


def test_registry_and_train_cli_name_what_is_not_ported(tmp_path):
    """The LF models train (tests/test_torch_train_zoo.py), and since items
    10b and 11 the train CLI takes the attention family and the RNNs too
    (tests/test_torch_train_attention_rnn.py): each builds its
    configuration, the model seeing every frame (not presampled)."""
    assert set(LF + ["NetVLADModelLF", "MoeModel"]) <= set(list_models())
    for name in ("TransformerEncoderModel", "AttentionNetVLADModel", "AttentionPoolingModel", "LstmModel",
                 "GruModel"):
        args = train.build_parser().parse_args([f"--model={name}", "--frame_features"])
        _, mcfg, _ = train.configs_from_args(args)
        assert name in list_models() and not mcfg.presampled
    for name in LF:
        args = train.build_parser().parse_args([f"--model={name}", "--frame_features"])
        _, mcfg, _ = train.configs_from_args(args)
        assert mcfg.presampled
