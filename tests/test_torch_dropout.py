"""flax's dropout in the port (ops/dropout.py, utils/prng.py) ≡ flax's on
the CPU: jax.random.bernoulli bit for bit, the keys that flax's make_rng
derives down a module path (every key the transformer family draws, read
from flax itself), and the plain version of the dropout kernel against
nn.Dropout and the attention-weight dropout, forward and backward, in f32
and bf16, bit for bit.  The CUDA kernel itself is held to the plain version
by chip_smoke.py on the card."""

from unittest import mock

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen.attention import dot_product_attention_weights

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.ops import dropout as tdropout
from learnablepoolingmethods_torch.utils import prng

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _words(key):
    return [int(w) for w in np.asarray(jax.random.key_data(key))]


@pytest.mark.parametrize("shape", [(1,), (7,), (1023,), (3, 5, 7), (1, 1, 9, 9), ((1 << 20) + 5,)])
@pytest.mark.parametrize("p", [0.9, 0.75, 0.5])
def test_bernoulli_is_jax_bernoulli(shape, p):
    for seed in (0, 123456):
        want = np.asarray(jax.random.bernoulli(jax.random.key(seed), p, shape))
        np.testing.assert_array_equal(prng.bernoulli(prng.key(seed), p, shape), want)


def test_flax_make_rng_follows_the_module_path():
    """A child scope appends its name, make_rng its counter (1, 2, …)."""

    class Probe(nn.Module):
        @nn.compact
        def __call__(self):
            return self.make_rng("dropout"), self.make_rng("dropout")

    class Mid(nn.Module):
        @nn.compact
        def __call__(self):
            return Probe(name="mha")(), Probe()()

    class Top(nn.Module):
        @nn.compact
        def __call__(self):
            return Mid(name="layer_0")(), self.make_rng("dropout")

    ((a, b), (c, _)), top = Top().apply({}, rngs={"dropout": jax.random.key(3)})
    key = prng.key(3)
    assert _words(a) == prng.flax_make_rng(key, 1, ("layer_0", "mha")).tolist()
    assert _words(b) == prng.flax_make_rng(key, 2, ("layer_0", "mha")).tolist()
    assert _words(c) == prng.flax_make_rng(key, 1, ("layer_0", "Probe_0")).tolist()
    assert _words(top) == prng.flax_make_rng(key, 1).tolist()


@pytest.mark.parametrize("name", ["TransformerEncoderModel", "AttentionNetVLADModel"])
def test_every_dropout_key_of_the_family_is_flaxs(name):
    """The keys and mask shapes that jax.random.bernoulli receives inside the
    flax model in training are, in order, the port's: per encoder layer the
    attention's [1, 1, F, F] from encoder/layer_<i>/mha and the FFN's
    [B, F, D] from encoder/layer_<i>/Dropout_0."""
    kw = dict(vocab_size=20, attention_hidden_size=16, attention_heads=2, transformer_ff_size=24,
              transformer_layers=2, netvlad_cluster_size=4, netvlad_hidden_size=12)
    b, f, sizes = 3, 7, (12, 4)
    tree = weights.init_variables_np(ModelConfig(**kw), FeatureConfig(("rgb", "audio"), sizes, True, f),
                                     seed=0, model_name=name)
    seen = []
    bernoulli = jax.random.bernoulli

    def spy(key, p, shape):
        seen.append((_words(key), tuple(shape)))
        return bernoulli(key, p, shape)

    x = np.random.default_rng(0).normal(size=(b, f, sum(sizes))).astype(np.float32)
    with mock.patch("jax.random.bernoulli", spy):
        jcreate(name, JModelConfig(**kw)).apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                                 num_frames=jnp.asarray([0, 3, f]), training=True,
                                                 rngs={"dropout": jax.random.key(9)}, mutable=["batch_stats"])
    key = prng.key(9)
    want = []
    for i in range(2):
        scope = ("encoder", f"layer_{i}")
        want += [(prng.flax_make_rng(key, 1, (*scope, "mha")).tolist(), (1, 1, f, f)),
                 (prng.flax_make_rng(key, 1, (*scope, "Dropout_0")).tolist(), (b, f, 16))]
    assert seen == want


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_plain_dropout_is_flax_dropout_forward_and_backward(dtype, rate):
    """mode div ≡ nn.Dropout: the values and the cotangent, bit for bit."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 11, 13)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    drop = nn.Dropout(rate, deterministic=False)
    fn = lambda v: drop.apply({}, v, rngs={"dropout": jax.random.key(4)})  # noqa: E731
    want, vjp = jax.vjp(fn, jnp.asarray(x, jdt))
    want_g = vjp(jnp.asarray(g, jdt))[0]

    key = prng.flax_make_rng(prng.key(4), 1)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = tdropout.dropout(xt, key, rate)
    got.backward(torch.from_numpy(g).to(tdt))
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(jnp.asarray(want_g, jnp.float32)))
    plain = tdropout.dropout_plain(xt.detach(), key, 1.0 - rate, x.shape)
    np.testing.assert_array_equal(plain.float().numpy(), got.detach().float().numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_dropout_is_the_attention_weight_dropout(dtype):
    """mode mul ≡ dot_product_attention_weights' dropout: one [1, 1, Lq, Lk]
    mask over batch and heads, w · (keep / keep_prob) in w's dtype; the
    cotangent the same multiplier's."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    q = jnp.asarray(rng.normal(size=(2, 9, 3, 4)), jdt)
    k = jnp.asarray(rng.normal(size=(2, 6, 3, 4)), jdt)
    w0 = dot_product_attention_weights(q, k, deterministic=True)
    w1 = dot_product_attention_weights(q, k, dropout_rng=jax.random.key(8), dropout_rate=0.1, deterministic=False)
    wt = torch.from_numpy(np.array(jnp.asarray(w0, jnp.float32))).to(tdt).requires_grad_(True)
    got = tdropout.dropout(wt, prng.key(8), 0.1, (1, 1, 9, 6), mode="mul")
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(jnp.asarray(w1, jnp.float32)))
    g = torch.from_numpy(rng.normal(size=tuple(wt.shape)).astype(np.float32)).to(tdt)
    got.backward(g)
    keep = torch.from_numpy(prng.bernoulli(prng.key(8), 0.9, (1, 1, 9, 6)))
    np.testing.assert_array_equal(wt.grad.float().numpy(),
                                  (g * (keep.to(tdt) / torch.tensor(0.9, dtype=tdt))).float().numpy())


def test_dropout_edges_and_shapes():
    """Rate 0 or no key: x itself; rate 1: zeros (flax's edge); a mask must
    be 1s then x's trailing dims; the kernel takes only CUDA tensors."""
    x = torch.randn(2, 3, 5)
    assert tdropout.dropout(x, prng.key(0), 0.0) is x
    assert tdropout.dropout(x, None, 0.3) is x
    assert torch.equal(tdropout.dropout(x, prng.key(0), 1.0), torch.zeros_like(x))
    assert tdropout._period(x, (1, 3, 5)) == 15 and tdropout._period(x, (1, 1, 1)) == 1
    with pytest.raises(ValueError, match="trailing dims"):
        tdropout._period(x, (2, 1, 5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdropout.dropout_kernel(x, prng.key(0), 0.9, x.shape)
    # kernel scale: keep_prob, or its reciprocal, in x's dtype
    assert tdropout._scale(0.9, "div", torch.bfloat16) == 0.8984375
    assert tdropout._scale(0.9, "mul", torch.float32) == float(np.float32(1) / np.float32(0.9))
