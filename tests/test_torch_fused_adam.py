"""FusedAdam (``--fused_adam``): the port's plain version
(``ops/fused_adam.py#fused_adam_plain``, which the CUDA kernel repeats
entry by entry on the card) ≡ the JAX package's ``ops/fused_adam.py`` on
the CPU, case by case as tests/unit/test_fused_adam.py holds the JAX one:

- ``stochastic_round_bf16`` bit for bit on the same bits, the non-finite and
  near-max guard included;
- ``stochastic=False`` against JAX's ``FusedAdam(stochastic=False)``;
- f32 leaves against optax's Adam at 1e-6, and against JAX's FusedAdam
  exactly;
- the per-leaf clip;
- with stochastic rounding: every p and ν on a bf16 neighbour of
  ``adam_reference_step``'s f32 value, m equal to JAX's (rounded to
  nearest, so the bits do not touch it);
- SR-ν's 300-step EMA within 1 % where deterministic bf16 drifts;
- the state's leaf names and dtypes against JAX's ``state_to_tree``.

The random bits are the port's own (Philox-4x32-10; JAX draws XLA's
RngBitGenerator, a stream defined by the backend), held to Random123's
known answers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learnablepoolingmethods_tpu.core import checkpoints as jckpt
from learnablepoolingmethods_tpu.core.train_state import TrainState as JTrainState
from learnablepoolingmethods_tpu.ops import fused_adam as jfa
from learnablepoolingmethods_torch.config import ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.core.checkpoints import dtype_name
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.ops import fused_adam as tfa

BIG = (70, 300)


def _t(a, dtype=None):
    """A jax or numpy array as a torch tensor (bf16 through its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy()) if dtype is None else torch.from_numpy(a.copy()).to(dtype)


def _np(t):
    return t.float().numpy()


def _tree(rng):
    return {"big": jnp.asarray(rng.normal(0, 0.05, BIG), jnp.bfloat16),
            "small": jnp.asarray(rng.normal(0, 0.05, (37,)), jnp.float32)}


def _grads(rng, params, scale=0.01):
    return jax.tree.map(lambda p: jnp.asarray(rng.normal(0, scale, p.shape), p.dtype), params)


class _Port:
    """The port's plain FusedAdam state on the same leaves (big, small)."""

    def __init__(self, params):
        self.p = [_t(params["big"]), _t(params["small"])]
        self.m = [torch.zeros_like(p) for p in self.p]
        self.v = [torch.zeros_like(p) for p in self.p]

    def step(self, grads, lr, count, clip, stochastic, seed=0):
        tfa.fused_adam_plain([_t(grads["big"]), _t(grads["small"])], self.p, self.m, self.v,
                             tfa.AdamConsts(lr, count), clip, stochastic, seed, count)


def _bf16_step(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_stochastic_round_matches_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1.0, (4096,)).astype(np.float32) + rng.uniform(1e-5, 1e-4, (4096,)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, (4096,), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jfa.stochastic_round_bf16(jnp.asarray(x), jnp.asarray(bits))).view(np.uint16)
    got = tfa.stochastic_round_bf16(torch.from_numpy(x), torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    # each draw is the bf16 floor or ceil, exact values never move
    u = x.view(np.uint32)
    lo, hi = (u & 0xFFFF0000).view(np.float32), ((u & 0xFFFF0000) + 0x10000).view(np.float32)
    assert np.all((_np(got) == lo) | (_np(got) == hi))
    exact = _np(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(_np(tfa.stochastic_round_bf16(torch.from_numpy(exact),
                                                                torch.from_numpy(bits.astype(np.int64)))), exact)


def test_stochastic_round_guard_matches_jax():
    """inf stays inf, NaN NaN, and nothing at or near bf16 max dithers into
    the inf encoding: the deterministic cast, as JAX's guard takes it."""
    bf16_max = float(jnp.finfo(jnp.bfloat16).max)
    x = np.array([np.inf, -np.inf, np.nan, bf16_max, -bf16_max, 3.4e38,
                  np.nextafter(np.float32(bf16_max), np.float32(0.0)), 1.0], np.float32)
    for fill in (0xFFFF, 0x0, 0x8000):
        bits = np.full(x.shape, fill, np.uint32)
        want = np.asarray(jfa.stochastic_round_bf16(jnp.asarray(x), jnp.asarray(bits))).view(np.uint16)
        got = tfa.stochastic_round_bf16(torch.from_numpy(x), torch.full(x.shape, fill))
        # bit for bit, but for the payload of the NaN
        nan = np.isnan(x)
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16)[~nan], want[~nan])
        assert np.isnan(_np(got)[nan]).all()


def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32_10."""
    z = torch.zeros(1, dtype=torch.int64)
    assert [int(w) for w in tfa.philox4x32(z, z, z, z, 0, 0)] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = z + 0xFFFFFFFF
    assert [int(w) for w in tfa.philox4x32(f, f, f, f, 0xFFFFFFFF, 0xFFFFFFFF)] == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    bits = tfa.random_bits(10, seed=5, count=2, leaf=3)
    assert bits.min() >= 0 and bits.max() < 2 ** 32 and len(set(bits.tolist())) == 10
    assert not torch.equal(bits, tfa.random_bits(10, seed=5, count=3, leaf=3))


def test_deterministic_mode_matches_jax():
    """stochastic=False, clip 1 engaging on the bf16 leaf's N(0, 1)
    gradients: three steps; the f32 leaf equal, bf16 leaves within one bf16 step (plus 1e-6 of the
    leaf's largest entry, where m and p cancel to near 0) and equal on
    ≥ 99.9 % (the norm's f32 sum runs in another order)."""
    rng = np.random.default_rng(0)
    opt = jfa.FusedAdam(lambda step: 0.01, clip_norm=1.0, stochastic=False)
    params = _tree(rng)
    state = opt.init(params)
    port = _Port(params)
    for count in range(3):
        # the f32 leaf's gradient stays under the clip, so its norm's order
        # plays no part and it equals JAX's bit for bit
        grads = {"big": jnp.asarray(rng.normal(0, 1.0, BIG), jnp.bfloat16),
                 "small": jnp.asarray(rng.normal(0, 0.01, (37,)), jnp.float32)}
        params, state = opt.fused_apply(grads, state, params)
        port.step(grads, 0.01, count, 1.0, False)
    for i, name in enumerate(("big", "small")):
        for got, want in ((port.p[i], params[name]), (port.m[i], state.m[name]), (port.v[i], state.nu[name])):
            want = np.asarray(want, np.float32)
            assert got.dtype == (torch.bfloat16 if name == "big" else torch.float32)
            if name == "small":
                np.testing.assert_array_equal(_np(got), want)
            else:
                assert np.all(np.abs(_np(got) - want) <= _bf16_step(want) + 1e-6 * np.abs(want).max()), name
                assert np.mean(_np(got) == want) >= 0.999


def test_fp32_leaves_match_optax_adam():
    rng = np.random.default_rng(1)
    lr = 0.01
    w = torch.from_numpy(rng.normal(0, 0.1, (37,)).astype(np.float32))
    ref_params = {"w": jnp.array(w.numpy(), copy=True)}  # not a view of w, which steps in place
    ref_tx = optax.adam(lr)
    ref_state = ref_tx.init(ref_params)
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    for count in range(5):
        g = rng.normal(0, 0.01, (37,)).astype(np.float32)
        tfa.fused_adam_plain([torch.from_numpy(g)], [w], [m], [v], tfa.AdamConsts(lr, count), None, True, 0, count)
        updates, ref_state = ref_tx.update({"w": jnp.asarray(g)}, ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
        np.testing.assert_allclose(w.numpy(), np.asarray(ref_params["w"]), rtol=1e-6, atol=1e-8)


def test_per_leaf_clip_matches_the_reference():
    """Gradients of N(0, 10) engage a clip of 0.5: the bf16 parameter within
    one bf16 step of adam_reference_step's clipped update, plus the 1e-6
    that JAX's test allows (the reference forms 1 − b2 in f32, FusedAdam
    from the Python float: ν̂ apart by 1.3e-5 of itself)."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(0, 10.0, p.shape), p.dtype), params)
    port = _Port(params)
    port.step(grads, 0.01, 0, 0.5, False)
    zero = jnp.zeros(BIG, jnp.bfloat16)
    p32, _, _ = jfa.adam_reference_step(grads["big"], params["big"], zero, zero, lr=0.01, t=1, clip_norm=0.5)
    p32 = np.asarray(p32)
    assert np.all(np.abs(_np(port.p[0]) - p32) <= _bf16_step(p32) + 1e-6)
    # the clip scale itself, in the kernel's order against the plain f32 sum
    g32 = _t(grads["big"]).float()
    np.testing.assert_allclose(float(tfa.leaf_sumsq(g32)), float(torch.sum(g32.double() ** 2)), rtol=1e-6)


def test_stochastic_rounding_lands_on_a_bf16_neighbour():
    """Three SR steps (clip off, so the per-leaf norm's order plays no part):
    m equal to JAX FusedAdam's bit for bit, p and ν within one bf16 step of
    adam_reference_step's f32 values from the same state (plus 1e-5 of the
    largest, for the reference's f32 1 − b2: test_per_leaf_clip_...), and differing
    from round-to-nearest somewhere (the dither is live)."""
    rng = np.random.default_rng(4)
    opt = jfa.FusedAdam(lambda step: 0.01, clip_norm=None, stochastic=True)
    params = _tree(rng)
    state = opt.init(params)
    port = _Port(params)
    differs = 0
    for count in range(3):
        grads = _grads(rng, params)
        p32, m32, v32 = jfa.adam_reference_step(grads["big"], port_bf16(port.p[0]), port_bf16(port.m[0]),
                                                port_bf16(port.v[0]), lr=0.01, t=count + 1)
        params, state = opt.fused_apply(grads, state, params)
        port.step(grads, 0.01, count, None, True)
        np.testing.assert_array_equal(port.m[0].view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(state.m["big"]).view(np.uint16))
        for got, ref in ((port.p[0], p32), (port.v[0], v32)):
            ref = np.asarray(ref)
            assert np.all(np.abs(_np(got) - ref) <= _bf16_step(ref) * (1 + 2 ** -10) + 1e-5 * np.abs(ref).max())
            differs += int(np.sum(_np(got) != _np(torch.from_numpy(ref.copy()).to(torch.bfloat16))))
    assert differs > 0


def port_bf16(t):
    """A port bf16 tensor as a jax bf16 array (through its bits), a copy:
    the port steps its tensors in place."""
    return jnp.array(t.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16), copy=True)


@pytest.mark.parametrize("stochastic", [True, False])
def test_sr_nu_tracks_the_ema_where_deterministic_bf16_drifts(stochastic):
    """300 constant-gradient steps at lr 0 on a bf16 leaf: the mean SR ν
    within 1 % of the exact EMA (1 − b2^300)·g², deterministic bf16 ν more
    than 5 % off, as in the JAX package's test."""
    steps = 300
    g = torch.full((512, 128), 0.01, dtype=torch.bfloat16)
    p, m, v = (torch.zeros_like(g) for _ in range(3))
    for count in range(steps):
        tfa.fused_adam_plain([g], [p], [m], [v], tfa.AdamConsts(0.0, count), None, stochastic, 0, count)
    g32 = float(g[0, 0])
    expect = (1 - 0.999 ** steps) * g32 * g32
    err = abs(v.double().mean().item() - expect) / expect
    assert (err < 0.01) if stochastic else (err > 0.05), err


def test_state_leaves_carry_jax_names_and_dtypes():
    """A bf16 LogisticModel under --fused_adam: the port's state tree and
    JAX's state_to_tree of a TrainState driving FusedAdam, after one step,
    by name and dtype (m, ν bf16; the count int32)."""
    mcfg = ModelConfig(vocab_size=6, param_dtype="bfloat16")
    model = create_model("LogisticModel", mcfg, 5)
    state = TrainState.create(model, TrainingConfig(fused_adam=True, batch_size=4))
    assert isinstance(state.tx, tfa.FusedAdam)
    state.apply_gradients([torch.full_like(p, 0.1) for p in model.parameters()])
    got = {name: dtype_name(t) for name, t in state.state_tree().items()}
    params = {"fc": {"kernel": jnp.zeros((5, 6), jnp.bfloat16), "bias": jnp.zeros((6,), jnp.bfloat16)}}
    jstate = JTrainState.create(params, {}, jfa.FusedAdam(lambda s: 0.01, clip_norm=1.0))
    jstate = jstate.apply_gradients(jax.tree.map(lambda p: jnp.full_like(p, 0.1), params))
    want = {name: str(np.asarray(v).dtype)
            for name, v in weights.tree_paths(jax.tree.map(np.asarray, jckpt.state_to_tree(jstate))).items()}
    assert got == want
    assert state.tx.count == 1 and int(jstate.opt_state.count) == 1
