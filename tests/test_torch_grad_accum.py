"""``--grad_accum_steps`` and ``--use_remat`` ≡ the JAX package's train
step on the CPU.

- ``--grad_accum_steps`` 2 and 4 against JAX's accumulating jitted
  ``make_train_step`` (tests/unit/test_step.py:90-225 holds it to the
  single pass): NetVLADModelLF, whose BN statistics chain from one
  microbatch to the next, with and without ``--presample_frames``, and
  MoeModel on video-level input (no BN) with the L2 penalty on, whose
  gradient is taken once outside the loop; ragged weights with a padded
  row; three Adam steps, losses and variables at 1e-5.
- A batch that the microbatches do not divide raises, in both packages.
- ``--use_remat`` (the forward recomputed in the backward) equals the run
  without it bit for bit, BN statistics included: the recompute leaves them
  alone, so they move once a step, as flax returns them once.
- Each item-12b mode resumes from a checkpoint bit for bit.
"""

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
from learnablepoolingmethods_torch import losses
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.utils import prng

B, F, SIZES, V = 8, 10, (1024, 16), 20
KW = dict(vocab_size=V, iterations=4, netvlad_cluster_size=8, netvlad_hidden_size=32)
TRAIN_KW = dict(batch_size=B, base_learning_rate=1e-4, learning_rate_decay_examples=16)
LR = TRAIN_KW["base_learning_rate"]
# case → (model, frame-level, ModelConfig overrides, --presample_frames)
CASES = {
    "NetVLADModelLF": ("NetVLADModelLF", True, {}, False),
    "NetVLADModelLF-presample": ("NetVLADModelLF", True, {}, True),
    "MoeModel-l2": ("MoeModel", False, {"l2_penalty": 1e-3}, False),
}
RUNS = [(case, accum) for case in CASES for accum in (2, 4)]


def _batches(frame, n=3):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        if frame:
            batch = {"features": rng.integers(0, 256, size=(B, F, sum(SIZES)), dtype=np.uint8),
                     "num_frames": rng.integers(1, F + 1, size=B).astype(np.int32)}
        else:
            batch = {"features": rng.normal(size=(B, sum(SIZES))).astype(np.float32)}
        batch["labels"] = (rng.random((B, V)) < 0.2).astype(np.float32)
        batch["weights"] = np.array([1, 1, 0, 1, 1, 0.5, 1, 1], np.float32)  # a padded row, a ragged one
        out.append(batch)
    return out


def _init(model_name, frame, overrides):
    fcfg = FeatureConfig(("rgb", "audio") if frame else ("mean_rgb", "mean_audio"), SIZES, frame, F)
    tree = weights.init_variables_np(ModelConfig(**KW, **overrides), fcfg, seed=0, model_name=model_name)
    return {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}


def _jax_run(model_name, frame, overrides, presample, accum, batches, init):
    mcfg = JModelConfig(**KW, **overrides, presampled=presample)
    tcfg = JTrainingConfig(**TRAIN_KW, presample_frames=presample, grad_accum_steps=accum)
    model = jcreate(model_name, mcfg)
    state = JTrainState.create(jax.tree.map(jnp.asarray, init["params"]),
                               jax.tree.map(jnp.asarray, init["batch_stats"]), jopt.create_optimizer(tcfg))
    step = jax.jit(jstep.make_train_step(model, jlosses.CrossEntropyLoss(), tcfg, mcfg, frame))
    loss, preds = [], None
    for b in batches:
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(7))
        loss.append(float(metrics["loss"]))
        preds = np.asarray(metrics["predictions"])
    return loss, preds, jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})


def _port_run(model_name, frame, overrides, presample, accum, batches, init, remat=False):
    mcfg = ModelConfig(**KW, **overrides, presampled=frame)
    tcfg = TrainingConfig(**TRAIN_KW, presample_frames=presample, grad_accum_steps=accum, use_remat=remat)
    model = weights.load_flax_variables(create_model(model_name, mcfg, sum(SIZES)), init)
    state = TrainState.create(model, tcfg)
    step = tstep.TrainStep(losses.CrossEntropyLoss(), tcfg, mcfg, frame)
    loss, preds = [], None
    for b in batches:
        metrics = step(state, {k: torch.from_numpy(v) for k, v in b.items()}, prng.key(7))
        loss.append(float(metrics["loss"]))
        preds = metrics["predictions"].numpy()
    return loss, preds, weights.state_dict_to_flax(model)


def _leaves(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_leaves(value, path) if isinstance(value, dict) else {path: np.asarray(value)})
    return out


@pytest.mark.parametrize("case, accum", RUNS, ids=[f"{c}-accum{a}" for c, a in RUNS])
def test_accumulated_steps_match_jax(case, accum):
    """Losses, the last step's concatenated predictions, BN statistics and
    parameters after three Adam steps (lr 1e-4) at 1e-5 (max-relative)."""
    model_name, frame, overrides, presample = CASES[case]
    batches = _batches(frame)
    init = _init(model_name, frame, overrides)
    jl, jp, jv = _jax_run(model_name, frame, overrides, presample, accum, batches, init)
    pl, pp, pv = _port_run(model_name, frame, overrides, presample, accum, batches, init)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(pp, jp, atol=1e-5)
    for collection in ("batch_stats", "params"):
        want, got = _leaves(jv[collection]), _leaves(pv[collection])
        assert set(got) == set(want)
        for path, w in want.items():
            tol = 1e-5 * np.abs(w).max() + 1e-5
            assert np.abs(got[path] - w).max() <= tol, f"{collection}/{path}"


def test_a_batch_the_microbatches_do_not_divide_raises():
    model_name, frame, overrides, _ = CASES["MoeModel-l2"]
    batch = _batches(frame, 1)[0]
    init = _init(model_name, frame, overrides)
    with pytest.raises(ValueError, match="not divisible by grad_accum_steps=3"):
        _jax_run(model_name, frame, overrides, False, 3, [batch], init)
    with pytest.raises(ValueError, match="batch_size=8 not divisible by grad_accum_steps=3"):
        _port_run(model_name, frame, overrides, False, 3, [batch], init)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("accum", [1, 2])
def test_remat_equals_the_run_without_it(fused, accum):
    """NetVLADModelLF (through the training kernels' plain versions when
    fused) for three steps with and without --use_remat: losses and every
    variable equal bit for bit; and the BN statistics after one step are
    those of one momentum update per microbatch (a second update in the
    recompute would move them again)."""
    model_name, frame, overrides, _ = CASES["NetVLADModelLF"]
    overrides = {"fused_train_aggregation": fused}
    batches = _batches(frame)
    init = _init(model_name, frame, overrides)
    a = _port_run(model_name, frame, overrides, False, accum, batches, init)
    b = _port_run(model_name, frame, overrides, False, accum, batches, init, remat=True)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    for path, w in _leaves(a[2]).items():
        np.testing.assert_array_equal(_leaves(b[2])[path], w, err_msg=path)
    # one step: every BN statistic moved, and as far as without remat
    one = _leaves(_port_run(model_name, frame, overrides, False, accum, batches[:1], init, remat=True)[2])
    ref = _leaves(_port_run(model_name, frame, overrides, False, accum, batches[:1], init)[2])
    for path in (p for p in ref if p.startswith("batch_stats/")):
        assert not np.array_equal(ref[path], _leaves(init)[path]), path
        np.testing.assert_array_equal(one[path], ref[path], err_msg=path)


def test_remat_with_fused_aggregation_under_bf16_parameters_keeps_the_f32_c2_gradient():
    """The f32 dC₂ tap (JAX's custom VJP keeps it f32) survives the
    checkpoint's recompute: the gradient of C₂ is f32 and equals the run
    without remat."""
    mcfg = ModelConfig(**KW, fused_train_aggregation=True, presampled=True, param_dtype="bfloat16")
    init = _init("NetVLADModelLF", True, {})
    batch = {k: torch.from_numpy(v) for k, v in _batches(True, 1)[0].items()}
    grads = []
    for remat in (False, True):
        tcfg = TrainingConfig(**TRAIN_KW, use_remat=remat)
        model = weights.load_flax_variables(create_model("NetVLADModelLF", mcfg, sum(SIZES)), init)
        state = TrainState.create(model, tcfg)
        step = tstep.TrainStep(losses.CrossEntropyLoss(), tcfg, mcfg, True)
        total = step.loss(state, batch, prng.key(7))[0]
        grads.append(dict(zip([n for n, _ in model.named_parameters()], tstep.gradients(total, model))))
    for name, g in grads[0].items():
        assert g.dtype == (torch.float32 if name.endswith("cluster_weights2") else torch.bfloat16), name
        assert torch.equal(grads[1][name], g), name


# item 12b's modes: TrainingConfig and ModelConfig overrides
RESUME_MODES = {"bf16_params": ({"fp32_master": True}, {"param_dtype": "bfloat16"}),
                "fused_adam": ({"fused_adam": True}, {"param_dtype": "bfloat16"}),
                "bf16_params-accum2": ({"fp32_master": True, "grad_accum_steps": 2}, {"param_dtype": "bfloat16"}),
                "use_remat": ({"use_remat": True}, {})}


@pytest.mark.parametrize("mode", sorted(RESUME_MODES))
def test_each_12b_mode_resumes_bit_for_bit(tmp_path, mode):
    """Two steps in each item-12b mode, a checkpoint, a fresh state restored
    from it: the third step from the restored state equals the third step
    of the live one bit for bit, every leaf (bf16 parameters, the f32 master
    or FusedAdam's bf16 m, ν and count, BN statistics, the step)."""
    from learnablepoolingmethods_torch.core.checkpoints import CheckpointManager, to_numpy

    tkw, mkw = RESUME_MODES[mode]
    mcfg = ModelConfig(**KW, presampled=True, fused_train_aggregation=True, **mkw)
    tcfg = TrainingConfig(**TRAIN_KW, **tkw)
    init = _init("NetVLADModelLF", True, {})
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches(True)]

    def fresh():
        model = weights.load_flax_variables(create_model("NetVLADModelLF", mcfg, sum(SIZES)), init)
        return TrainState.create(model, tcfg), tstep.TrainStep(losses.CrossEntropyLoss(), tcfg, mcfg, True)

    live, step = fresh()
    for b in batches[:2]:
        step(live, b, prng.key(7))
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(live.step, live.state_tree())
    restored, step2 = fresh()
    restored.load_state_tree(mngr.restore(2, like=restored.state_tree()))
    step(live, batches[2], prng.key(7))
    step2(restored, batches[2], prng.key(7))
    got, want = restored.state_tree(), live.state_tree()
    assert set(got) == set(want) and int(want["step"]) == 3
    for name, t in want.items():
        np.testing.assert_array_equal(to_numpy(got[name]), to_numpy(t), err_msg=name)
