"""One GRU layer over every frame in the port (ops/native_tail.py
#gru_layer_plain, the plain version of the native runner's gru_layer
kernel) ≡ flax's ``nn.RNN(nn.GRUCell, return_carry=True)`` as the JAX
GruModel stacks it (learnablepoolingmethods_tpu/models/frame_level.py:276-290),
on the CPU: the outputs of every frame and the carry at each row's
``min(num_frames, F) − 1``, within 1e-5, at small widths, one and two
layers, with a row of no frames and one of more frames than F.  On the CPU
the ``gru_layer`` wrapper takes its plain version and launches nothing; the
kernel itself is held to the plain version by chip_smoke.py on the card."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_torch.ops import native_tail as nt

# flax's f32 products against PyTorch's: the summation order alone
TOL = 1e-5
IN_WIDTH = 11


def _flax_layers(x: np.ndarray, num_frames: np.ndarray, width: int, layers: int, seed: int):
    """flax's stacked GRU as the JAX GruModel runs it → (each layer's params,
    the top layer's outputs, its carry)."""
    seq_lengths = jnp.minimum(jnp.asarray(num_frames, jnp.int32), x.shape[1])
    h, params, carry = jnp.asarray(x), [], None
    for layer in range(layers):
        rnn = nn.RNN(nn.GRUCell(features=width), return_carry=True)
        variables = rnn.init(jax.random.key(seed + layer), h, seq_lengths=seq_lengths)
        carry, h = rnn.apply(variables, h, seq_lengths=seq_lengths)
        params.append(variables["params"]["cell"])
    return params, np.asarray(h), np.asarray(carry)


def _port_layers(x: np.ndarray, num_frames: np.ndarray, params, layer_fn=nt.gru_layer_plain):
    """The port's layers from flax's params: W_i and b_i the ``i*`` gates'
    kernels and biases, W_h the ``h*`` kernels (r, z, n), b_hn ``hn``'s
    bias; each layer's input product x·W_i over all frames, then the layer."""
    seq, nf, carry = torch.from_numpy(x), torch.from_numpy(num_frames), None
    for cell in params:
        cat = lambda side, leaf: torch.from_numpy(np.concatenate(  # noqa: E731
            [np.asarray(cell[side + g][leaf], np.float32) for g in "rzn"], axis=-1))
        w_i, b_i, w_h = cat("i", "kernel"), cat("i", "bias"), cat("h", "kernel")
        b_hn = torch.from_numpy(np.array(cell["hn"]["bias"], np.float32))
        seq, carry = layer_fn(seq @ w_i, w_h, b_i, b_hn, nf)
    return seq, carry


def _inputs(b: int, frames: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, frames, IN_WIDTH)).astype(np.float32)
    # a row of no frames (its carry after the last frame), one frame, every
    # frame, more frames than F, and the rest in between
    nf = np.array([0, 1, frames, frames + 4] + list(rng.integers(1, frames + 1, b - 4)), np.int32)
    return x, nf


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("frames", [1, 5, 9])
@pytest.mark.parametrize("width", [8, 13, 40])
def test_gru_layer_plain_is_flax_rnn_gru(width, frames, layers):
    x, nf = _inputs(6, frames, seed=width * 10 + frames)
    params, want_seq, want_carry = _flax_layers(x, nf, width, layers, seed=layers)
    seq, carry = _port_layers(x, nf, params)
    assert seq.shape == (6, frames, width) and carry.shape == (6, width)
    np.testing.assert_allclose(seq.numpy(), want_seq, atol=TOL, rtol=0)
    np.testing.assert_allclose(carry.numpy(), want_carry, atol=TOL, rtol=0)
    # the carry is the top layer's output at each row's last frame, bit for bit
    last = nt.last_frame(torch.from_numpy(nf), frames)
    assert torch.equal(carry, seq[torch.arange(6), last])


def test_gru_layer_takes_its_plain_version_on_the_cpu():
    x, nf = _inputs(5, 7, seed=3)
    params, want_seq, want_carry = _flax_layers(x, nf, 12, 2, seed=4)
    before = {w: w.launches for w in nt.WRAPPERS}
    seq, carry = _port_layers(x, nf, params, nt.gru_layer)
    assert torch.equal(seq, _port_layers(x, nf, params)[0]) and torch.equal(carry, _port_layers(x, nf, params)[1])
    np.testing.assert_allclose(seq.numpy(), want_seq, atol=TOL, rtol=0)
    np.testing.assert_allclose(carry.numpy(), want_carry, atol=TOL, rtol=0)
    # without num_frames: the outputs alone, the same
    pre = torch.from_numpy(x) @ torch.randn(IN_WIDTH, 3 * 12, generator=torch.Generator().manual_seed(0))
    w_h = torch.randn(12, 36, generator=torch.Generator().manual_seed(1)) * 0.3
    b_i, b_hn = torch.zeros(36), torch.zeros(12)
    assert torch.equal(nt.gru_layer(pre, w_h, b_i, b_hn), nt.gru_layer_plain(pre, w_h, b_i, b_hn, None))
    assert {w: w.launches for w in nt.WRAPPERS} == before
    assert nt.gru_layer in nt.WRAPPERS
