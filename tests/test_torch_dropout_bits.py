"""The dropout kernel's keep mask as bits (ops/dropout.py#pack_mask,
#unpack_mask, #dropout_from_bits_plain) on the CPU: the bits of
jax.random.bernoulli's mask (``prng.bernoulli``, bit for bit JAX's) at ragged
sizes, in the layout the kernel writes (word w, bit b = keep[32·w + b],
NumPy's little-endian packbits read as uint32), unpacked back to the mask;
the backward from the bits ≡ flax's VJP of ``nn.Dropout`` and of the
attention-weight dropout, bit for bit, in f32 and bf16.  The CUDA forward's
bits and its backward launch are held to these by chip_smoke.py on the
card."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen.attention import dot_product_attention_weights

from learnablepoolingmethods_torch.ops import dropout as tdropout
from learnablepoolingmethods_torch.utils import prng

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("shape", [(1,), (7,), (31,), (33,), (1023,), ((1 << 20) + 5,), (1, 1, 9, 9)])
@pytest.mark.parametrize("p", [0.9, 0.5])
def test_bits_pack_and_unpack_bernoullis_mask(shape, p):
    keep = prng.bernoulli(prng.key(5), p, shape)
    np.testing.assert_array_equal(keep, np.asarray(jax.random.bernoulli(jax.random.key(5), p, shape)))
    bits = tdropout.pack_mask(torch.from_numpy(keep))
    n = keep.size
    assert bits.dtype == torch.int32 and bits.shape == (-(-n // 32),)
    packed = np.packbits(keep.reshape(-1), bitorder="little")
    want = np.pad(packed, (0, -packed.size % 4)).view("<u4")
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), want)
    if n % 32:  # the bits past the mask are zero
        assert int(want[-1]) >> (n % 32) == 0
    assert torch.equal(tdropout.unpack_mask(bits, shape), torch.from_numpy(keep))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_backward_from_bits_is_flax_dropouts_vjp(dtype, rate):
    """mode div: the cotangent through nn.Dropout's VJP, from the bits."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 10, 37)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    drop = nn.Dropout(rate, deterministic=False)
    _, vjp = jax.vjp(lambda v: drop.apply({}, v, rngs={"dropout": jax.random.key(9)}), jnp.asarray(x, jdt))
    want = np.asarray(jnp.asarray(vjp(jnp.asarray(g, jdt))[0], jnp.float32))
    key = prng.flax_make_rng(prng.key(9), 1)
    bits = tdropout.pack_mask(tdropout.keep_mask(key, 1.0 - rate, x.shape))
    got = tdropout.dropout_from_bits_plain(torch.from_numpy(g).to(tdt), bits, 1.0 - rate, x.shape)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_backward_from_bits_is_the_attention_weight_dropouts_vjp(dtype, rate):
    """mode mul: one [1, 1, Lq, Lk] mask over batch and heads; the
    cotangent through dot_product_attention_weights' dropout, from the
    bits."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(8)
    q = jnp.asarray(rng.normal(size=(2, 9, 3, 4)), jdt)
    k = jnp.asarray(rng.normal(size=(2, 7, 3, 4)), jdt)
    w0 = dot_product_attention_weights(q, k, deterministic=True)

    dropped = dot_product_attention_weights(q, k, dropout_rng=jax.random.key(6), dropout_rate=rate,
                                            deterministic=False)
    # flax's dropout step alone (w ↦ w · keep / keep_prob), the same values
    # as flax's dropped weights; its VJP on the weights
    np.testing.assert_array_equal(np.asarray(jnp.asarray(_attention_dropout(w0, rate), jnp.float32)),
                                  np.asarray(jnp.asarray(dropped, jnp.float32)))
    g = rng.normal(size=w0.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda w: _attention_dropout(w, rate), w0)
    want = np.asarray(jnp.asarray(vjp(jnp.asarray(g, jdt))[0], jnp.float32))
    mask_shape = (1, 1, 9, 7)
    bits = tdropout.pack_mask(tdropout.keep_mask(prng.key(6), 1.0 - rate, mask_shape))
    got = tdropout.dropout_from_bits_plain(torch.from_numpy(g).to(tdt), bits, 1.0 - rate, mask_shape, "mul")
    np.testing.assert_array_equal(got.float().numpy(), want)


def _attention_dropout(w, rate):
    """dot_product_attention_weights' dropout of ``w`` (flax/linen/
    attention.py: keep over [1, 1, Lq, Lk] broadcast, w · keep / keep_prob
    in w's dtype) under the test's key."""
    keep_prob = 1.0 - rate
    keep = jax.random.bernoulli(jax.random.key(6), keep_prob, (1, 1) + w.shape[-2:])
    multiplier = keep.astype(w.dtype) / jnp.asarray(keep_prob, dtype=w.dtype)
    return w * multiplier


def test_the_kernels_take_cuda_tensors_only():
    x = torch.randn(4, 33)
    bits = tdropout.pack_mask(torch.ones(4, 33, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdropout.dropout_kernel(x, prng.key(0), 0.9, x.shape)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdropout.dropout_from_bits(x, bits, 0.9, x.shape)
    # the CPU path keeps the host's mask and launches nothing
    before = tdropout.dropout_kernel.launches
    xr = x.clone().requires_grad_(True)
    y = tdropout.dropout(xr, prng.key(2), 0.25)
    y.backward(torch.ones_like(y))
    keep = tdropout.keep_mask(prng.key(2), 0.75, x.shape)
    assert torch.equal(xr.grad, tdropout.dropout_from_bits_plain(torch.ones_like(x), tdropout.pack_mask(keep), 0.75,
                                                                 x.shape))
    assert tdropout.dropout_kernel.launches == before
