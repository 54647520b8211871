"""Frame sampling of the train step without --presample_frames ≡ the JAX
package's: the flax model draws from ``make_rng("sampling")``, a key that
flax derives from the step's sampling key, and the port derives the same
key (utils/prng.py#flax_make_rng), so both draw the same frames bit for bit
and the first step's loss agrees; iid frames, or one random window a video
under --nosample_random_frames; and a model that samples nothing
(FrameLevelLogisticModel) sees what the JAX step gives it."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu import losses as jlosses
from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.config import TrainingConfig as JTrainingConfig
from learnablepoolingmethods_tpu.core import optimizers as jopt
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.core.train_state import TrainState as JTrainState
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_tpu.models import model_utils as jmodel_utils
from learnablepoolingmethods_torch import losses
from learnablepoolingmethods_torch.config import ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.models import create_model, model_utils
from learnablepoolingmethods_torch.ops.fused_frontend import sample_indices
from learnablepoolingmethods_torch.utils import prng

MODEL_KW = dict(vocab_size=20, iterations=4, netvlad_cluster_size=8, netvlad_hidden_size=32)
B, F, SIZES = 6, 10, (1024, 16)


class _MakeRng(fnn.Module):
    """Hands out flax's make_rng("sampling") keys, ``calls`` of them."""

    calls: int

    @fnn.compact
    def __call__(self):
        return [self.make_rng("sampling") for _ in range(self.calls)]


def _words(key):
    return [int(w) for w in np.asarray(jax.random.key_data(key))]


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_flax_make_rng_is_flax_make_rng(seed):
    want = _MakeRng(calls=3).apply({}, rngs={"sampling": jax.random.key(seed)})
    for counter, key in enumerate(want, start=1):
        assert prng.flax_make_rng(prng.key(seed), counter).tolist() == _words(key)


def test_step_draws_the_frames_of_the_flax_model():
    """The indices the JAX model draws in step ``step`` (from the step's
    fold_in → split → make_rng) equal the port's, bit for bit."""
    rng = np.random.default_rng(3)
    nf = rng.integers(1, F + 1, size=B).astype(np.int32)
    for step in (0, 1, 5):
        sampling_rng, _ = jax.random.split(jax.random.fold_in(jax.random.key(7), step))
        (key,) = _MakeRng(calls=1).apply({}, rngs={"sampling": sampling_rng})
        u = jax.random.uniform(key, (B, MODEL_KW["iterations"]), dtype=jnp.float32)
        want = np.minimum((np.asarray(u) * np.minimum(nf, F)[:, None]).astype(np.int32), F - 1)
        port_key = prng.flax_make_rng(prng.split(prng.fold_in(prng.key(7), step))[0])
        got = sample_indices(port_key, torch.from_numpy(nf), F, MODEL_KW["iterations"])
        np.testing.assert_array_equal(got.numpy(), want)


def test_first_step_loss_matches_jax_without_presample_frames():
    """make_train_step with presample_frames=False (the flax model samples
    the dequantized frames itself) against the port's step, which gathers
    the uint8 rows first from the same key: the step-1 loss in f32."""
    rng = np.random.default_rng(11)
    batch = {
        "features": rng.integers(0, 256, size=(B, F, sum(SIZES)), dtype=np.uint8),
        "num_frames": rng.integers(1, F + 1, size=B).astype(np.int32),
        "labels": (rng.random((B, MODEL_KW["vocab_size"])) < 0.2).astype(np.float32),
        "weights": np.r_[np.ones(B - 1), 0].astype(np.float32),
    }
    train_kw = dict(batch_size=B, presample_frames=False)
    jmodel = jcreate("NetVLADModelLF", JModelConfig(**MODEL_KW))
    params, stats = jstep.init_model_variables(jmodel, batch, True, seed=0)
    init = jax.tree.map(np.asarray, {"params": params, "batch_stats": stats})
    jtcfg = JTrainingConfig(**train_kw)
    state = JTrainState.create(params, stats, jopt.create_optimizer(jtcfg))
    step = jax.jit(jstep.make_train_step(jmodel, jlosses.CrossEntropyLoss(), jtcfg,
                                         JModelConfig(**MODEL_KW), True))
    _, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(7))

    mcfg = ModelConfig(**MODEL_KW, presampled=True)
    model = weights.load_flax_variables(create_model("NetVLADModelLF", mcfg, sum(SIZES)), init)
    tstate = TrainState.create(model, TrainingConfig(**train_kw))
    port_step = tstep.TrainStep(losses.CrossEntropyLoss(), TrainingConfig(**train_kw), mcfg, True)
    loss = port_step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, prng.key(7))["loss"]
    # the same frames; f32 sums in another order
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=1e-5, atol=0)
    # under --presample_frames the port keeps the step's own key: other frames
    presampled_cfg = TrainingConfig(**dict(train_kw, presample_frames=True))
    port_step = tstep.TrainStep(losses.CrossEntropyLoss(), presampled_cfg, mcfg, True)
    model = weights.load_flax_variables(create_model("NetVLADModelLF", mcfg, sum(SIZES)), init)
    other = port_step(TrainState.create(model, TrainingConfig(**train_kw)),
                      {k: torch.from_numpy(v) for k, v in batch.items()}, prng.key(7))["loss"]
    assert abs(float(other) - float(metrics["loss"])) > 1e-4 * abs(float(metrics["loss"]))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_sample_random_sequence_draws_the_jax_window(seed):
    """The window of --nosample_random_frames: the rows JAX's
    sample_random_sequence gathers equal the port's bit for bit, for
    num_frames below, at and above S and past F, on frames whose values are
    their own indices."""
    s, f = 4, 10
    nf = np.array([0, 1, 3, 4, 5, 9, 10, 12], np.int32)
    rows = np.broadcast_to(np.arange(f, dtype=np.float32)[None, :, None], (nf.size, f, 1)).copy()
    want = jmodel_utils.sample_random_sequence(jnp.asarray(rows), jnp.minimum(nf, f), s, jax.random.key(seed))
    got = model_utils.sample_random_sequence(torch.from_numpy(rows), torch.from_numpy(nf), s, prng.key(seed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx = model_utils.sequence_indices(prng.key(seed), torch.from_numpy(nf), f, s).numpy()
    np.testing.assert_array_equal(idx, np.asarray(want)[:, :, 0].astype(np.int32))
    # one window a video: consecutive frames up to the last valid one
    assert (np.diff(idx, axis=1) >= 0).all() and (np.diff(idx, axis=1) <= 1).all()


@pytest.mark.parametrize("model_name", ["NetVLADModelLF", "DbofModel"])
def test_first_step_loss_matches_jax_with_random_windows(model_name):
    """--nosample_random_frames without --presample_frames: the flax model
    draws one window a video from make_rng("sampling"), the port's step
    gathers the same uint8 rows; the step-1 loss agrees in f32."""
    rng = np.random.default_rng(5)
    batch = {
        "features": rng.integers(0, 256, size=(B, F, sum(SIZES)), dtype=np.uint8),
        "num_frames": np.array([1, 3, 4, 7, 10, 10], np.int32),
        "labels": (rng.random((B, MODEL_KW["vocab_size"])) < 0.2).astype(np.float32),
        "weights": np.r_[np.ones(B - 1), 0].astype(np.float32),
    }
    kw = dict(MODEL_KW, sample_random_frames=False, dbof_cluster_size=16, dbof_hidden_size=16)
    train_kw = dict(batch_size=B, presample_frames=False)
    jmodel = jcreate(model_name, JModelConfig(**kw))
    params, stats = jstep.init_model_variables(jmodel, batch, True, seed=0)
    init = jax.tree.map(np.asarray, {"params": params, "batch_stats": stats})
    jtcfg = JTrainingConfig(**train_kw)
    state = JTrainState.create(params, stats, jopt.create_optimizer(jtcfg))
    step = jax.jit(jstep.make_train_step(jmodel, jlosses.CrossEntropyLoss(), jtcfg, JModelConfig(**kw), True))
    _, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(7))

    mcfg = ModelConfig(**kw, presampled=True)
    model = weights.load_flax_variables(create_model(model_name, mcfg, sum(SIZES)), init)
    port_step = tstep.TrainStep(losses.CrossEntropyLoss(), TrainingConfig(**train_kw), mcfg, True)
    loss = port_step(TrainState.create(model, TrainingConfig(**train_kw)),
                     {k: torch.from_numpy(v) for k, v in batch.items()}, prng.key(7))["loss"]
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=1e-5, atol=0)


def test_frame_level_logistic_sees_every_frame_without_presample_frames():
    """FrameLevelLogisticModel samples nothing: without --presample_frames
    the JAX step hands it all F rows, and so does the port's step, whatever
    the model was built as; under --presample_frames both steps hand it S
    iid rows, averaged over the video's original num_frames."""
    rng = np.random.default_rng(9)
    batch = {
        "features": rng.integers(0, 256, size=(B, F, sum(SIZES)), dtype=np.uint8),
        "num_frames": np.array([1, 3, 4, 7, 10, 10], np.int32),
        "labels": (rng.random((B, MODEL_KW["vocab_size"])) < 0.2).astype(np.float32),
    }
    for presample in (False, True):
        jtcfg = JTrainingConfig(batch_size=B, presample_frames=presample)
        jmcfg = JModelConfig(**MODEL_KW, presampled=presample)
        jmodel = jcreate("FrameLevelLogisticModel", jmcfg)
        params, stats = jstep.init_model_variables(jmodel, batch, True, seed=0)
        init = jax.tree.map(np.asarray, {"params": params, "batch_stats": stats})
        state = JTrainState.create(params, stats, jopt.create_optimizer(jtcfg))
        step = jax.jit(jstep.make_train_step(jmodel, jlosses.CrossEntropyLoss(), jtcfg, jmcfg, True))
        _, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(7))
        tcfg = TrainingConfig(batch_size=B, presample_frames=presample)
        mcfg = ModelConfig(**MODEL_KW, presampled=True)
        model = weights.load_flax_variables(create_model("FrameLevelLogisticModel", mcfg, sum(SIZES)), init)
        loss = tstep.TrainStep(losses.CrossEntropyLoss(), tcfg, mcfg, True)(
            TrainState.create(model, tcfg), {k: torch.from_numpy(v) for k, v in batch.items()},
            prng.key(7))["loss"]
        np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=1e-5, atol=0,
                                   err_msg=f"presample_frames={presample}")
