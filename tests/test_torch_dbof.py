"""DbofModel, FrameLevelLogisticModel and the DBoF fast path of the port ≡
the JAX package's, on the CPU.

- FrameLevelLogisticModel on batches with padded frames (nonzero after
  dequantize and ℓ2, so the mask must drop them) against flax's forward,
  within 1e-5 in f32;
- DbofModel with and without --dbof_add_batch_norm, max and average
  pooling, drawing its frames from a "sampling" key, against flax's
  forward within 1e-5 in f32;
- ops/fast_dbof.py's route against ops/fast_dbof.py of the JAX package
  (its jnp route) on the same frames, at tests/unit/test_fast_dbof.py's
  2e-4 in f32, and in bf16 where both round at the same points;
- frame_pooling and frame_mask against model_utils.py's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_tpu.models import model_utils as jutils
from learnablepoolingmethods_tpu.ops import fast_dbof as jfast
from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.models import model_utils
from learnablepoolingmethods_torch.ops import fast_dbof
from learnablepoolingmethods_torch.ops.fast_dispatch import get_fast_path
from learnablepoolingmethods_torch.utils import prng

KW = dict(vocab_size=23, iterations=7, dbof_cluster_size=32, dbof_hidden_size=16)
B, F, D = 5, 9, 24


def _frames(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(B, F, D), dtype=np.uint8)
    nf = np.r_[1, F, rng.integers(1, F, size=B - 2)].astype(np.int32)
    for row, n in enumerate(nf):
        x[row, n:] = 0  # padded in uint8, as the reader pads
    return x, nf


def _flax(name, cfg_kw, x, nf, seed=0):
    jmodel = jcreate(name, JModelConfig(**cfg_kw))
    params, stats = jstep.init_model_variables(jmodel, {"features": x, "num_frames": nf}, True, seed)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda s: s + 0.05 * np.abs(rng.normal(size=s.shape)).astype(np.float32), stats)
    return jmodel, jax.tree.map(np.asarray, {"params": params, "batch_stats": stats})


def test_frame_level_logistic_masks_the_padded_frames():
    x, nf = _frames(0)
    jmodel, tree = _flax("FrameLevelLogisticModel", KW, x, nf)
    xj = jstep.preprocess_input(jnp.asarray(x))
    assert float(jnp.abs(xj[0, 1:]).max()) > 0  # padded rows are not zero after ℓ2
    want = jmodel.apply(tree, xj, num_frames=jnp.asarray(nf), training=False)["predictions"]
    port = weights.load_flax_variables(create_model("FrameLevelLogisticModel", ModelConfig(**KW), D), tree)
    got = port(tstep.preprocess_input(torch.from_numpy(x)), torch.from_numpy(nf))["predictions"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("add_bn", [True, False])
@pytest.mark.parametrize("pooling", ["max", "average"])
def test_dbof_matches_flax(add_bn, pooling):
    cfg_kw = dict(KW, dbof_add_batch_norm=add_bn, dbof_pooling_method=pooling)
    x, nf = _frames(1)
    jmodel, tree = _flax("DbofModel", cfg_kw, x, nf, seed=2)
    assert ("input_bn" in tree["params"]) == add_bn and ("cluster_biases" in tree["params"]) != add_bn
    key = jax.random.key(5)
    want = jmodel.apply(tree, jstep.preprocess_input(jnp.asarray(x)), num_frames=jnp.asarray(nf),
                        training=False, rngs={"sampling": key})["predictions"]
    port = weights.load_flax_variables(create_model("DbofModel", ModelConfig(**cfg_kw), D), tree)
    # the flax model draws from make_rng("sampling"): flax_make_rng of the key
    got = port(tstep.preprocess_input(torch.from_numpy(x)), torch.from_numpy(nf),
               sampling_key=prng.flax_make_rng(prng.key(5)))["predictions"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("pooling", ["max", "average"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fast_dbof_matches_the_jax_route(pooling, dtype):
    cfg_kw = dict(KW, dbof_pooling_method=pooling)
    x, nf = _frames(3)
    _, tree = _flax("DbofModel", cfg_kw, x, nf, seed=4)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jcfg, cfg = JModelConfig(**cfg_kw), ModelConfig(**cfg_kw)
    jfp = jfast.prepare_fast_dbof_params(tree, jcfg, compute_dtype=jdt)
    want = jfast.build_fast_dbof_inference(jcfg, compute_dtype=jdt, return_probs=True)(
        jfp, jnp.asarray(x), jnp.asarray(nf), jax.random.key(9))
    fp = fast_dbof.prepare_fast_dbof_params(weights.convert_flax_variables(tree, cfg, "DbofModel"), cfg,
                                            compute_dtype=tdt, device="cpu")
    got = fast_dbof.build_fast_dbof_inference(cfg, compute_dtype=tdt, return_probs=True)(
        fp, torch.from_numpy(x), torch.from_numpy(nf), prng.key(9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=2e-4)
    if dtype == "bfloat16":
        # the registry's route is this one, top-k on the device
        path = get_fast_path("DbofModel")
        fp = path.prepare(weights.convert_flax_variables(tree, cfg, "DbofModel"), cfg, device="cpu")
        vals, _ = path.build(cfg, top_k=5)(fp, torch.from_numpy(x), torch.from_numpy(nf), prng.key(9))
        np.testing.assert_array_equal(vals.numpy(), torch.topk(got, 5).values.numpy())


def test_fast_dbof_refuses_what_the_jax_path_refuses():
    x, nf = _frames(4)
    _, tree = _flax("DbofModel", KW, x, nf)
    cfg = ModelConfig(**KW)
    tv = weights.convert_flax_variables(tree, cfg, "DbofModel")
    prepare = get_fast_path("DbofModel").prepare
    with pytest.raises(ValueError, match="dbof_add_batch_norm"):
        prepare(tv, dataclasses.replace(cfg, dbof_add_batch_norm=False), device="cpu")
    with pytest.raises(ValueError, match="nosample_random_frames"):
        prepare(tv, dataclasses.replace(cfg, sample_random_frames=False), device="cpu")
    # the JAX dispatch's wording: DBoF has no giant D·K hidden FC
    with pytest.raises(ValueError, match="int8_hidden is only supported on the models with the giant"):
        prepare(tv, cfg, int8_hidden=True, device="cpu")


@pytest.mark.parametrize("method", ["max", "average"])
def test_frame_pooling_and_mask_match_jax(method, rng):
    frames = rng.normal(size=(3, 6, 5)).astype(np.float32)
    # the mean's f32 sum may run in another order
    np.testing.assert_allclose(model_utils.frame_pooling(torch.from_numpy(frames), method).numpy(),
                               np.asarray(jutils.frame_pooling(jnp.asarray(frames), method)), rtol=1e-6)
    nf = np.array([0, 3, 6], np.int32)
    np.testing.assert_array_equal(model_utils.frame_mask(torch.from_numpy(nf), 6).numpy(),
                                  np.asarray(jutils.frame_mask(jnp.asarray(nf), 6)))
    with pytest.raises(ValueError, match="Unrecognized pooling"):
        model_utils.frame_pooling(torch.from_numpy(frames), "median")
