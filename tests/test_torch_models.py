"""The port's NetVLADModelLF (nn.Modules) ≡ the JAX package's flax model on
the CPU: the training forward, every parameter's gradient and the updated
BN statistics, from the same variables carried across by
core/weights.py#flax_to_state_dict.  JAX runs with
fused_train_aggregation=False (its fused model needs the TPU); the port runs
both routes, its fused one through the plain versions of the CUDA kernels."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.models.modules import BatchNorm

KW = dict(vocab_size=20, iterations=4, netvlad_cluster_size=8, netvlad_hidden_size=32, presampled=True)
B, S = 6, 4


def _jax_training_forward(rng, sizes, extra):
    x_u8 = rng.integers(0, 256, size=(B, S, sum(sizes)), dtype=np.uint8)
    cfg = JModelConfig(**KW, **extra)
    model = jcreate("NetVLADModelLF", cfg)
    x = jstep.preprocess_input(jnp.asarray(x_u8), jnp.dtype(cfg.compute_dtype))
    nf = jnp.full((B,), S)
    v = model.init({"params": jax.random.key(0), "sampling": jax.random.key(1)}, x, num_frames=nf,
                   training=True)
    # BN statistics away from their initial values, so that the update shows
    stats = jax.tree.map(lambda a: a + 0.1, v["batch_stats"])
    w = rng.normal(size=(B, KW["vocab_size"])).astype(np.float32)

    def loss(params):
        out, mutated = model.apply({"params": params, "batch_stats": stats}, x, num_frames=nf,
                                   training=True, mutable=["batch_stats"])
        return jnp.sum(out["predictions"] * w), (out["predictions"], mutated["batch_stats"])

    (_, (pred, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    tree = jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": stats})
    return x_u8, w, tree, np.asarray(pred), grads, new_stats


def _port_training_forward(x_u8, w, tree, cfg):
    model = weights.load_flax_variables(create_model("NetVLADModelLF", cfg, x_u8.shape[-1]), tree)
    x = tstep.preprocess_input(torch.from_numpy(x_u8), model.dtype)
    out = model(x, torch.full((B,), S), training=True)
    loss = torch.sum(out["predictions"] * torch.from_numpy(w))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    names = [n for n, _ in model.named_parameters()]
    return model, out["predictions"].detach(), dict(zip(names, grads))


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return np.asarray(tree, np.float32)


@pytest.mark.parametrize(
    "sizes, extra, fused",
    [
        ((1024, 16), {}, False),                       # rgb K=8 and audio K=4 NetVLADs
        ((1024, 16), {}, True),
        ((16, 8), {}, False),                          # one NetVLAD over all 24 columns
        ((16, 8), {}, True),
        ((1024, 16), {"netvlad_relu": True}, True),    # hidden BN and relu6
    ],
)
def test_training_forward_gradients_and_bn_stats_match_jax(rng, sizes, extra, fused):
    x_u8, w, tree, want_pred, want_grads, want_stats = _jax_training_forward(rng, sizes, extra)
    model, pred, grads = _port_training_forward(
        x_u8, w, tree, ModelConfig(**KW, **extra, fused_train_aggregation=fused))
    # f32 throughout; sums run in another order (1e-7 measured on predictions)
    np.testing.assert_allclose(pred.numpy(), want_pred, atol=1e-5)
    assert set(grads) == {".".join(k.key for k in path)
                          for path, _ in jax.tree_util.tree_leaves_with_path(want_grads)}
    for name, g in grads.items():
        want = _leaf(want_grads, name)
        # each leaf's gradient within 2e-5 of its largest entry (3e-6 measured)
        np.testing.assert_allclose(g.numpy(), want, atol=2e-5 * np.abs(want).max() + 1e-12, err_msg=name)
    got_stats = weights.state_dict_to_flax(model)["batch_stats"]
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(want_stats),
                                 jax.tree_util.tree_leaves(got_stats)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, err_msg=jax.tree_util.keystr(path))


def test_bf16_training_forward_is_close_to_jax(rng):
    """bf16 compute: the port's fused route rounds A to bf16 before XᵀA where
    the flax module keeps A in f32, so the predictions agree to the bf16
    rounding of the pooled descriptor feeding the hidden FC (4.4e-4 measured)."""
    x_u8, w, tree, want_pred, _, _ = _jax_training_forward(rng, (1024, 16), {"compute_dtype": "bfloat16"})
    _, pred, _ = _port_training_forward(
        x_u8, w, tree, ModelConfig(**KW, compute_dtype="bfloat16", fused_train_aggregation=True))
    np.testing.assert_allclose(pred.numpy(), want_pred, atol=3e-3)


@pytest.mark.parametrize("values", [np.array([0.0, 2.0]), np.linspace(-3, 5, 12)])
def test_batchnorm_is_flax_batchnorm(values):
    """Statistics over every axis but the last, the biased (fast) variance,
    running averages at flax's momentum 0.999 (torch's 0.001), ε = 1e-3.  A
    [0, 2] batch has biased variance 1, where torch's BatchNorm would store
    the unbiased 2."""
    x = np.stack([values, values[::-1] * 0.5], axis=-1).reshape(-1, 1, 2).astype(np.float32)
    flax_bn = fnn.BatchNorm(momentum=0.999, epsilon=1e-3)
    variables = flax_bn.init(jax.random.key(0), jnp.asarray(x), use_running_average=False)
    scale = np.array([1.5, 0.5], np.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray([0.1, -0.2])}
    want, mutated = flax_bn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    bn = BatchNorm(2)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.tensor([0.1, -0.2]))
    got = bn(torch.from_numpy(x), training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]), atol=1e-7)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(mutated["batch_stats"]["var"]), atol=1e-7)
    if len(values) == 2:
        np.testing.assert_allclose(bn.var.numpy()[0], 0.999 + 0.001 * 1.0, rtol=1e-6)
    # inference mode uses the running statistics and leaves them alone
    before = bn.var.clone()
    want_eval = flax_bn.apply({"params": params, "batch_stats": mutated["batch_stats"]},
                              jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(bn(torch.from_numpy(x), training=False).detach().numpy(),
                               np.asarray(want_eval), atol=1e-6)
    assert torch.equal(bn.var, before)


def test_state_dict_round_trip_keeps_the_flax_layout(rng):
    _, _, tree, _, _, _ = _jax_training_forward(rng, (1024, 16), {})
    model = weights.load_flax_variables(create_model("NetVLADModelLF", ModelConfig(**KW), 1040), tree)
    back = weights.state_dict_to_flax(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_registry_names_what_is_not_ported():
    cfg = ModelConfig(**KW)
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        create_model("DbofModel", cfg, 1152)
    with pytest.raises(ValueError, match="Unknown model"):
        create_model("NoSuchModel", cfg, 1152)
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        create_model("NetVLADModelLF", ModelConfig(**KW, param_dtype="bfloat16"), 1152)
    with pytest.raises(NotImplementedError, match="dimred"):
        create_model("NetVLADModelLF", ModelConfig(**KW, netvlad_dimred=64), 1152)


def test_model_samples_the_frames_jax_samples_without_a_sampling_rng(rng):
    """Without ``presampled`` and without a "sampling" RNG the flax model
    draws its frames from jax.random.key(0); the port's from prng.key(0),
    bit for bit the same, so the inference-mode predictions agree."""
    kw = dict(KW, presampled=False)
    x_u8 = rng.integers(0, 256, size=(B, 10, 1040), dtype=np.uint8)
    nf = np.array([1, 3, 10, 7, 10, 2], np.int32)
    model = jcreate("NetVLADModelLF", JModelConfig(**kw))
    x = jstep.preprocess_input(jnp.asarray(x_u8))
    v = model.init({"params": jax.random.key(0), "sampling": jax.random.key(1)}, x,
                   num_frames=jnp.asarray(nf), training=True)
    want = model.apply(v, x, num_frames=jnp.asarray(nf), training=False)["predictions"]
    tree = jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
    port = weights.load_flax_variables(create_model("NetVLADModelLF", ModelConfig(**kw), 1040), tree)
    got = port(tstep.preprocess_input(torch.from_numpy(x_u8)), torch.from_numpy(nf), training=False)
    np.testing.assert_allclose(got["predictions"].detach().numpy(), np.asarray(want), atol=1e-5)
