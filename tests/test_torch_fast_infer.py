"""Port fast path ≡ JAX fast path and flax model (NetVLADModelLF) on the CPU,
with the weights carried across by core/weights.py#convert_flax_variables.
The tiny config is that of tests/unit/test_fast_infer.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import step as step_lib
from learnablepoolingmethods_tpu.models import create_model
from learnablepoolingmethods_tpu.ops import fast_infer as jfi
from learnablepoolingmethods_tpu.ops.fused_frontend import sample_indices as j_sample_indices
from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.core.weights import convert_flax_variables
from learnablepoolingmethods_torch.ops import fast_infer as tfi
from learnablepoolingmethods_torch.ops.fast_dispatch import get_fast_path
from learnablepoolingmethods_torch.utils import prng

CFG_KW = dict(vocab_size=20, iterations=6, netvlad_cluster_size=8, netvlad_hidden_size=16)
JCFG = JModelConfig(**CFG_KW, presampled=True)
TCFG = ModelConfig(**CFG_KW, presampled=True)


def _init(cfg, feats_u8):
    model = create_model("NetVLADModelLF", cfg)
    x = step_lib.preprocess_input(jnp.asarray(feats_u8))
    variables = model.init(
        {"params": jax.random.key(0), "sampling": jax.random.key(1)},
        x, num_frames=jnp.full((feats_u8.shape[0],), feats_u8.shape[1]), training=True,
    )
    return model, variables


def _np_tree(tree):
    return jax.tree.map(np.asarray, {"params": tree["params"], "batch_stats": tree["batch_stats"]})


@pytest.fixture
def setup(rng):
    b, f = 2, 6
    feats_u8 = rng.integers(0, 256, size=(b, f, 1152), dtype=np.uint8)
    nf = np.array([f, f], np.int32)
    model, variables = _init(JCFG, feats_u8)
    # non-trivial BN stats so that folding is exercised (as test_fast_infer.py)
    bs = jax.tree.map(
        lambda a: a + 0.05 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape) / a.size,
        variables["batch_stats"],
    )
    variables = {"params": variables["params"], "batch_stats": bs}
    return model, variables, feats_u8, nf


def _port(variables, dtype):
    tv = convert_flax_variables(_np_tree(variables), TCFG)
    return tfi.prepare_fast_params(tv, TCFG, compute_dtype=dtype, device="cpu")


def _scatter(values, indices, v=20):
    out = np.zeros((values.shape[0], v), np.float32)
    out[np.arange(values.shape[0])[:, None], np.asarray(indices)] = np.asarray(values)
    return out


def test_convert_flax_variables(setup):
    _, variables, _, _ = setup
    tree = _np_tree(variables)
    tv = convert_flax_variables(tree, TCFG)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(tv))
    for path, leaf in flat_j:
        node = tv
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)
    with pytest.raises(ValueError, match="cluster_weights"):
        convert_flax_variables(tree, dataclasses.replace(TCFG, netvlad_cluster_size=16))


def test_fast_path_fp32_matches_model_and_jax(setup):
    model, variables, feats_u8, nf = setup
    x = step_lib.preprocess_input(jnp.asarray(feats_u8))
    want_model = np.asarray(
        model.apply(variables, x, num_frames=jnp.asarray(nf), training=False)["predictions"]
    )
    jfp = jfi.prepare_fast_params(variables, JCFG, compute_dtype=jnp.float32)
    jv, ji = jfi.build_fast_netvlad_inference(JCFG, use_pallas=False, compute_dtype=jnp.float32)(
        jfp, jnp.asarray(feats_u8), jnp.asarray(nf), jax.random.key(0), presampled=True
    )
    fast = tfi.build_fast_netvlad_inference(TCFG, top_k=20, compute_dtype=torch.float32)
    tv, ti = fast(
        _port(variables, torch.float32), torch.from_numpy(feats_u8), torch.from_numpy(nf),
        prng.key(0), presampled=True,
    )
    got = _scatter(tv.numpy(), ti.numpy())
    # fp32 end to end; the flax path sums in another order
    # (tests/unit/test_fast_infer.py:70's 2e-4)
    np.testing.assert_allclose(got, want_model, atol=2e-4)
    np.testing.assert_allclose(got, _scatter(np.asarray(jv), np.asarray(ji)), atol=2e-4)


@pytest.mark.parametrize("route", ["fused", "staged"])
def test_bf16_routes_match_jax_with_its_indices(setup, route):
    """bf16 uint8 input, unsampled: the fused front end (the CPU wrapper takes
    its plain version) against the JAX fused kernel in interpret mode, and the
    staged route against the JAX staged route, both drawing JAX's indices
    from the same key."""
    _, variables, feats_u8, nf = setup
    key = jax.random.key(3)
    idx = np.array(j_sample_indices(key, jnp.asarray(nf), feats_u8.shape[1], JCFG.iterations))
    got_idx = tfi.sample_indices(prng.key(3), torch.from_numpy(nf), feats_u8.shape[1], JCFG.iterations)
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    fused = route == "fused"
    jfp = jfi.prepare_fast_params(variables, JCFG, compute_dtype=jnp.bfloat16)
    want = jfi.build_fast_netvlad_inference(
        JCFG, use_pallas=fused, pallas_interpret=True, compute_dtype=jnp.bfloat16,
        return_probs=True,
    )(jfp, jnp.asarray(feats_u8), jnp.asarray(nf), key)
    got = tfi.build_fast_netvlad_inference(
        TCFG, use_kernels=fused, fuse_frontend=fused, return_probs=True
    )(_port(variables, torch.bfloat16), torch.from_numpy(feats_u8), torch.from_numpy(nf), prng.key(3))
    # bf16 rounding points are the same; f32 sums run in another order and
    # XLA may keep bf16 intermediates in f32 (test_fast_infer.py:141's 3e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-2)


def test_staged_kernel_route_equals_plain_route_on_cpu(setup):
    _, variables, feats_u8, nf = setup
    fp = _port(variables, torch.bfloat16)
    args = (fp, torch.from_numpy(feats_u8), torch.from_numpy(nf))
    outs = [
        tfi.build_fast_netvlad_inference(TCFG, use_kernels=k, fuse_frontend=False, return_probs=True)(
            *args, prng.key(7)
        )
        for k in (True, False)
    ]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_return_probs(setup):
    _, variables, feats_u8, nf = setup
    fp = _port(variables, torch.float32)
    args = (fp, torch.from_numpy(feats_u8), torch.from_numpy(nf), prng.key(0))
    probs = tfi.build_fast_netvlad_inference(TCFG, compute_dtype=torch.float32, return_probs=True)(
        *args, presampled=True
    )
    vals, idxs = tfi.build_fast_netvlad_inference(TCFG, top_k=5, compute_dtype=torch.float32)(
        *args, presampled=True
    )
    assert probs.shape == (2, 20) and vals.shape == idxs.shape == (2, 5)
    np.testing.assert_allclose(torch.gather(probs, 1, idxs).numpy(), vals.numpy(), atol=1e-6)
    assert torch.all(vals[:, :-1] >= vals[:, 1:])


def test_rejects_non_moe_classifier(rng):
    cfg_kw = dict(CFG_KW, video_level_classifier_model="LogisticModel")
    _, variables = _init(JModelConfig(**cfg_kw, presampled=True), rng.integers(0, 256, (2, 6, 1152), np.uint8))
    tcfg = ModelConfig(**cfg_kw)
    with pytest.raises(ValueError, match="MoeModel classifier"):
        tfi.prepare_fast_params(convert_flax_variables(_np_tree(variables), tcfg), tcfg, device="cpu")


def test_rejects_single_modality_layout(rng):
    _, variables = _init(JCFG, rng.integers(0, 256, (2, 6, 40), np.uint8))
    with pytest.raises(ValueError, match="two-modality"):
        tfi.prepare_fast_params(convert_flax_variables(_np_tree(variables), TCFG), TCFG, device="cpu")


def test_unported_options_and_models_name_their_roadmap_item(setup):
    _, variables, _, _ = setup
    tv = convert_flax_variables(_np_tree(variables), TCFG)
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        tfi.prepare_fast_params(tv, TCFG, int8_hidden=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        get_fast_path("DbofModel")
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        get_fast_path("AttentionNetVLADModel")
    with pytest.raises(ValueError, match="unknown model"):
        get_fast_path("NoSuchModel")
    assert get_fast_path("NetVLADModelLF").prepare(tv, TCFG, device="cpu")["w_rgb"].dtype == torch.bfloat16
