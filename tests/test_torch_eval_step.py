"""The port's eval and predict steps (core/step.py#make_eval_step,
#make_predict_step) ≡ the JAX package's for every registered model of the
port, at a small width on the CPU: the same variables (carried across by
core/weights.py#load_flax_variables), the same batch with two padding rows,
the same per-batch key.  The JAX step hands the key to the flax model as
its "sampling" RNG; the port gathers the frames that key draws in uint8, so
the probabilities agree to f32 summation order and the top-k indices are
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu import losses as jlosses
from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_torch import losses
from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.models import create_model, find_class_by_name, list_models
from learnablepoolingmethods_torch.utils import prng

KW = dict(vocab_size=29, iterations=6, netvlad_cluster_size=4, netvlad_hidden_size=16,
          fv_cluster_size=4, fv_hidden_size=16, rvlad_cluster_size=4, dbow_cluster_size=8,
          nextvlad_cluster_size=4, nextvlad_hidden_size=16, dbof_cluster_size=16,
          dbof_hidden_size=16, attention_hidden_size=16, attention_heads=2, transformer_ff_size=24,
          attention_cluster_size=3, lstm_cells=8, gru_cells=8)
VIDEO_LEVEL = ("LogisticModel", "MoeModel")
B, PAD, F, D, TOP_K = 6, 2, 10, 72, 5
BATCH_IDX = 3


def _batch(model_name, seed):
    """A batch as data/pipeline.py pads it: the last PAD rows are zeros with
    weight 0 (and num_frames 0)."""
    rng = np.random.default_rng(seed)
    n = B - PAD
    labels = np.zeros((B, KW["vocab_size"]), np.float32)
    labels[:n] = rng.random((n, KW["vocab_size"])) < 0.15
    batch = {"labels": labels, "weights": np.r_[np.ones(n), np.zeros(PAD)].astype(np.float32)}
    if model_name in VIDEO_LEVEL:
        x = rng.normal(scale=0.5, size=(B, D)).astype(np.float32)
    else:
        x = rng.integers(0, 256, size=(B, F, D), dtype=np.uint8)
        nf = np.r_[1, F, rng.integers(1, F + 1, size=n - 2), np.zeros(PAD)].astype(np.int32)
        batch["num_frames"] = nf
    x[n:] = 0
    batch["features"] = x
    return batch


@pytest.fixture(scope="module", params=list_models())
def both(request):
    """(model name, JAX model, variables as NumPy, port model, port config,
    batch) with BN statistics off their initial values."""
    name = request.param
    frame = name not in VIDEO_LEVEL
    batch = _batch(name, seed=len(name))
    jmodel = jcreate(name, JModelConfig(**KW))
    params, stats = jstep.init_model_variables(jmodel, batch, frame)
    rng = np.random.default_rng(1)
    stats = jax.tree.map(lambda s: s + 0.05 * np.abs(rng.normal(size=s.shape)).astype(np.float32), stats)
    tree = jax.tree.map(np.asarray, {"params": params, "batch_stats": stats})
    cfg = ModelConfig(**KW, presampled=frame and find_class_by_name(name).samples_frames)
    port = weights.load_flax_variables(create_model(name, cfg, D), tree).eval()
    return name, jmodel, tree, port, cfg, batch


def _key():
    return jax.random.fold_in(jax.random.key(0), BATCH_IDX), prng.fold_in(prng.key(0), BATCH_IDX)


def test_every_registered_model_is_covered():
    assert {"DbofModel", "LogisticModel", "MoeModel", "FrameLevelLogisticModel",
            "NetVLADModelLF"} <= set(list_models())


def test_eval_step_matches_jax(both):
    name, jmodel, tree, port, cfg, batch = both
    frame = name not in VIDEO_LEVEL
    jkey, tkey = _key()
    jcfg = JModelConfig(**KW)
    want = jstep.make_eval_step(jmodel, jlosses.CrossEntropyLoss(), jcfg, frame, top_k=TOP_K)(
        tree["params"], tree["batch_stats"], jax.tree.map(jnp.asarray, batch), jkey)
    got = tstep.make_eval_step(port, losses.CrossEntropyLoss(), cfg, frame, top_k=TOP_K)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, tkey)
    np.testing.assert_allclose(got["predictions"].numpy(), np.asarray(want["predictions"]), atol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    gp, wp = got["partials"], want["partials"]
    real = batch["weights"] > 0
    np.testing.assert_allclose(gp.topk_scores.numpy()[real], np.asarray(wp.topk_scores)[real], atol=1e-5)
    assert np.all(np.isneginf(gp.topk_scores.numpy()[~real]))
    for field in ("topk_labels", "num_positives", "hit_at_one_sum", "perr_sum", "weight_sum"):
        np.testing.assert_allclose(np.asarray(getattr(gp, field)), np.asarray(getattr(wp, field)),
                                   atol=1e-6, err_msg=field)


def test_predict_step_matches_jax(both):
    name, jmodel, tree, port, cfg, batch = both
    frame = name not in VIDEO_LEVEL
    jkey, tkey = _key()
    nf = batch.get("num_frames")
    w_vals, w_idx = jstep.make_predict_step(jmodel, JModelConfig(**KW), frame, top_k=TOP_K)(
        tree["params"], tree["batch_stats"], jnp.asarray(batch["features"]),
        None if nf is None else jnp.asarray(nf), jkey)
    g_vals, g_idx = tstep.make_predict_step(port, cfg, frame, top_k=TOP_K)(
        torch.from_numpy(batch["features"]), None if nf is None else torch.from_numpy(nf), tkey)
    np.testing.assert_allclose(g_vals.numpy(), np.asarray(w_vals), atol=1e-5)
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
