"""The port's optimizers (core/optimizers.py) ≡ the JAX package's
``create_optimizer``, which chains the per-tensor clip and optax's
optimizers: three updates of each ``--optimizer`` from the same parameters
and gradients, the updates at 1e-6 relative and the state leaf by leaf,
under the names of the JAX ``opt_state`` tree.  One leaf is 128 × 160 and
one [1, 130, 144], so that Adafactor factors them; ``--adam_bf16_momentum``
keeps μ equal to optax's bf16 μ bit for bit.  optax runs under ``jax.jit``,
as in the JAX package's train step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learnablepoolingmethods_tpu.config import TrainingConfig as JTrainingConfig
from learnablepoolingmethods_tpu.core import optimizers as jopt
from learnablepoolingmethods_torch.config import TrainingConfig
from learnablepoolingmethods_torch.core import optimizers
from learnablepoolingmethods_torch.core.weights import tree_paths

SHAPES = {"hidden1_weights": (128, 160), "NetVLAD_0": {"cluster_weights2": (1, 130, 144),
                                                        "cluster_weights": (20, 8)},
          "hidden1_biases": (160,)}
NAMES = ["NetVLAD_0/cluster_weights", "NetVLAD_0/cluster_weights2", "hidden1_biases", "hidden1_weights"]
OPTIMIZERS = sorted(optimizers.OPTIMIZERS)


def _tree(rng, scale):
    return jax.tree.map(lambda shape: (rng.normal(size=shape) * scale).astype(np.float32), SHAPES,
                        is_leaf=lambda x: isinstance(x, tuple))


def _run(optimizer, bf16_momentum=False, clip=1.0):
    """Three updates in both packages; returns the updates and states."""
    cfg = TrainingConfig(optimizer=optimizer, base_learning_rate=0.01, batch_size=32,
                         learning_rate_decay_examples=64, clip_gradient_norm=clip,
                         adam_bf16_momentum=bf16_momentum)
    rng = np.random.default_rng(0)
    params = _tree(rng, 0.5)
    # the first gradients pass the clip (norms above 1), the rest stay below it
    grads = [_tree(rng, s) for s in (0.3, 0.01, 0.002)]
    tx = jopt.create_optimizer(JTrainingConfig(**dataclasses.asdict(cfg)))
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    update = jax.jit(tx.update)  # as the JAX train step runs it
    flat = tree_paths(params)
    tp = [torch.from_numpy(flat[n].copy()) for n in NAMES]
    opt = optimizers.create_optimizer(list(zip(NAMES, tp)), cfg)
    out = []
    for g in grads:
        ju, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        gflat = tree_paths(g)
        tu = opt.updates([torch.from_numpy(gflat[n]) for n in NAMES])
        for p, u in zip(tp, tu):
            p.add_(u)
        out.append((tree_paths(ju), dict(zip(NAMES, tu)), tree_paths(js),
                    {k: v.clone() for k, v in opt.state_tree().items()}))
    return out, tree_paths(jp), dict(zip(NAMES, tp))


def _close(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_three_updates_match_optax(optimizer):
    runs, jparams, tparams = _run(optimizer)
    for ju, tu, _, _ in runs:
        for name in NAMES:
            _close(tu[name].numpy(), ju[name])
    for name in NAMES:
        _close(tparams[name].numpy(), jparams[name])


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_state_leaves_carry_the_jax_opt_state_names_and_values(optimizer):
    for _, _, js, ts in _run(optimizer)[0]:
        assert set(ts) == set(js), (sorted(ts), sorted(js))
        for name, want in js.items():
            got = ts[name]
            assert tuple(got.shape) == np.shape(want), name
            if name.endswith("count"):
                assert got.dtype == torch.int32 and int(got) == int(want), name
            else:
                _close(got.float().numpy(), np.asarray(want, np.float32))


def test_without_the_clip_the_chain_starts_at_position_zero():
    runs, jparams, tparams = _run("AdamOptimizer", clip=0.0)
    _, _, js, ts = runs[-1]
    assert set(ts) == set(js) and "0/0/count" in ts
    for name in NAMES:
        _close(tparams[name].numpy(), jparams[name])


def test_adafactor_factors_the_leaves_of_two_large_dims():
    _, _, js, ts = _run("AdafactorOptimizer")[0][0]
    assert ts["1/0/v_row/hidden1_weights"].shape == (128,) and ts["1/0/v_col/hidden1_weights"].shape == (160,)
    assert ts["1/0/v/hidden1_weights"].shape == (1,)
    assert ts["1/0/v_row/NetVLAD_0/cluster_weights2"].shape == (1, 130)
    assert ts["1/0/v/NetVLAD_0/cluster_weights"].shape == (20, 8)
    assert optimizers.factored_dims((128, 160)) == (0, 1) and optimizers.factored_dims((127, 400)) is None


def _share_off(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.mean(np.abs(got - want) > rtol * (np.abs(want).max() + np.abs(want)))


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["no_clip", "clip"])
def test_adam_bf16_momentum_matches_optax_mu_dtype_bfloat16(clip):
    """μ stored in bf16 against optax's after each update; ν, the updates
    and the parameters at 1e-6.  Without the clip μ is equal bit for bit and
    everything else within 1e-6.  With it the two packages sum the clip's
    squared norm in different orders, so a clipped gradient can part by an
    f32 ulp and move a rounding of μ, which the later updates carry on
    (one entry of 20480 here, its update 1 % off): there at most 1e-3 of
    the entries of μ, of the updates and of the parameters may differ."""
    prefix = "1/0" if clip else "0/0"
    runs, jparams, tparams = _run("AdamOptimizer", bf16_momentum=True, clip=clip)
    checks = []
    for ju, tu, js, ts in runs:
        for name in NAMES:
            mu = ts[f"{prefix}/mu/{name}"]
            want = np.asarray(js[f"{prefix}/mu/{name}"])
            assert mu.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            got_bits, want_bits = mu.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16)
            _close(ts[f"{prefix}/nu/{name}"].numpy(), js[f"{prefix}/nu/{name}"])
            checks += [float(np.mean(got_bits != want_bits)), _share_off(tu[name].numpy(), ju[name])]
    checks += [_share_off(tparams[name].numpy(), jparams[name]) for name in NAMES]
    assert max(checks) <= (1e-3 if clip else 0.0), checks


def test_unported_options_raise_naming_12b():
    """Item 12b's options are ported: --fused_adam builds the FusedAdam,
    --bf16_params the f32 master around the chain; the JAX package's two
    ValueErrors stay."""
    from learnablepoolingmethods_torch.ops.fused_adam import FusedAdam

    assert isinstance(optimizers.create_optimizer([torch.zeros(2)], TrainingConfig(fused_adam=True)), FusedAdam)
    tx = optimizers.create_optimizer([torch.zeros(2, dtype=torch.bfloat16)], TrainingConfig(fp32_master=True))
    assert isinstance(tx, optimizers.Fp32Master) and isinstance(tx.inner, optimizers.Adam)
    with pytest.raises(ValueError, match="requires --optimizer=AdamOptimizer"):
        optimizers.create_optimizer([torch.zeros(2)], TrainingConfig(optimizer="SgdOptimizer", fused_adam=True))
    with pytest.raises(ValueError, match="Unknown optimizer"):
        optimizers.create_optimizer([torch.zeros(2)], TrainingConfig(optimizer="LambOptimizer"))
