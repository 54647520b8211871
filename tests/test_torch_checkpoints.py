"""The port's checkpoints (core/checkpoints.py, TrainState.state_tree) and
resume ≡ the JAX package's, on the CPU.

- Save and restore bit for bit for every optimizer's state, bf16 μ
  included; ``keep`` retention; a half-written step (a planted temporary
  directory, a save that dies after some leaves) is never the latest; a
  restore that does not fit the live state names the leaf.
- From one state bridged across (core/weights.py#train_state_from_jax_tree):
  three steps of JAX's jitted make_train_step against the port's
  TrainStep, for NetVLADModelLF with --fused_train_aggregation (the
  training kernels' plain versions here, JAX's Pallas kernels in interpret
  mode) and DbofModel, each with Adam and Adafactor; the port's
  checkpoint leaves carry the names of JAX's ``state_to_tree`` and its
  values at 1e-5.  Then resume: two steps, a checkpoint, a fresh state
  restored from it, two more steps on the batches again from the first
  (the JAX trainer's iterator restarts), in both packages.
- The train CLI SIGKILLed mid-run in a subprocess and run again: it
  restores the latest step and finishes; the eval CLI writes its summary
  at the checkpoint's step.
"""

import dataclasses
import os
import re
import signal
import subprocess
import sys
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu import losses as jlosses
from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.config import TrainingConfig as JTrainingConfig
from learnablepoolingmethods_tpu.core import checkpoints as jckpt
from learnablepoolingmethods_tpu.core import optimizers as jopt
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.core.train_state import TrainState as JTrainState
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_tpu.ops import netvlad_train as jnetvlad_train
from learnablepoolingmethods_torch import eval as teval
from learnablepoolingmethods_torch import losses, train
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core import checkpoints, optimizers, weights
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core.checkpoints import CheckpointManager
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.data import fixtures
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.utils import prng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F, SIZES, V = 6, 10, (1024, 16), 20
MODEL_KW = dict(vocab_size=V, iterations=4, netvlad_cluster_size=8, netvlad_hidden_size=32,
                dbof_cluster_size=32, dbof_hidden_size=32)
# lr 1e-6: Adam and Adafactor move an entry whose gradient is f32 rounding
# noise by about ±lr in either package (tests/test_torch_train_zoo.py), far
# below the 1e-5 the leaves are held to
TRAIN_KW = dict(batch_size=B, base_learning_rate=1e-6, learning_rate_decay_examples=12)
OPTIMIZER_CASES = sorted(optimizers.OPTIMIZERS) + ["AdamOptimizer-bf16"]


def _tcfg(optimizer: str, **kw) -> TrainingConfig:
    name, _, bf16 = optimizer.partition("-")
    return TrainingConfig(**{**TRAIN_KW, **kw}, optimizer=name, adam_bf16_momentum=bool(bf16))


def _small_state(optimizer: str, seed=0) -> TrainState:
    """A LogisticModel's TrainState after two updates of random gradients."""
    fcfg = FeatureConfig(("mean_rgb", "mean_audio"), (140, 16))
    mcfg = ModelConfig(vocab_size=V)
    model = create_model("LogisticModel", mcfg, fcfg.total_size)
    weights.load_flax_variables(model, weights.init_variables_np(mcfg, fcfg, seed=seed, model_name="LogisticModel"))
    state = TrainState.create(model, _tcfg(optimizer, base_learning_rate=0.01))
    gen = torch.Generator().manual_seed(seed)
    for _ in range(2):
        state.apply_gradients([torch.randn(p.shape, generator=gen) for p in model.parameters()])
    return state


def _bits(t: torch.Tensor) -> np.ndarray:
    return checkpoints.to_numpy(t)


@pytest.mark.parametrize("optimizer", OPTIMIZER_CASES)
def test_save_and_restore_bit_for_bit(tmp_path, optimizer):
    state = _small_state(optimizer)
    mngr = CheckpointManager(str(tmp_path))
    assert mngr.save(state.step, state.state_tree())
    assert not mngr.save(state.step, state.state_tree())  # a step is written once
    fresh = _small_state(optimizer, seed=1)
    fresh.step = 0
    fresh.load_state_tree(mngr.restore(2, like=fresh.state_tree()))
    want, got = state.state_tree(), fresh.state_tree()
    assert set(got) == set(want) and fresh.step == 2 and fresh.tx.count == 2
    for name, t in want.items():
        assert got[name].dtype == t.dtype, name
        np.testing.assert_array_equal(_bits(got[name]), _bits(t), err_msg=name)
    if optimizer == "AdamOptimizer-bf16":
        assert want["opt_state/1/0/mu/fc/kernel"].dtype == torch.bfloat16
        assert mngr.manifest(2)["leaves"][[leaf["name"] for leaf in mngr.manifest(2)["leaves"]]
                                         .index("opt_state/1/0/mu/fc/kernel")]["dtype"] == "bfloat16"
    # readable with numpy alone
    arrays = mngr.load_arrays(2)
    np.testing.assert_array_equal(arrays["params/fc/kernel"][0], _bits(want["params/fc/kernel"]))


def test_keep_retains_the_newest_steps(tmp_path):
    tree = {"step": np.int32(0), "params/w": np.zeros(3, np.float32)}
    keep_all, keep_two = CheckpointManager(str(tmp_path / "a")), CheckpointManager(str(tmp_path / "b"), keep=2)
    for step in (1, 2, 5, 7):
        keep_all.save(step, tree)
        keep_two.save(step, tree)
    assert keep_all.all_steps() == [1, 2, 5, 7] and keep_two.all_steps() == [5, 7]
    assert CheckpointManager(str(tmp_path / "c"), keep=0).keep is None
    assert sorted(os.listdir(keep_two.directory)) == ["5", "7"]


def test_a_step_of_another_format_is_neither_read_nor_overwritten(tmp_path):
    """The JAX package's orbax manager writes the same <step> directories:
    the port reads only steps with its manifest and refuses to save over a
    directory without one."""
    mngr = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(mngr.directory, "7", "default"))
    assert mngr.latest_step() is None and checkpoints.latest_weights_step(str(tmp_path)) is None
    with pytest.raises(ValueError, match="another format"):
        mngr.save(7, {"step": np.int32(7)})
    assert mngr.save(8, {"step": np.int32(8)}) and mngr.all_steps() == [8]


def test_a_half_written_step_is_never_the_latest(tmp_path, monkeypatch):
    """A planted temporary directory, and a save that dies after two
    leaves, leave the previous step the latest; the next save clears both."""
    state = _small_state("AdamOptimizer")
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(2, state.state_tree())
    planted = os.path.join(mngr.directory, "3.tmp-planted")
    os.makedirs(planted)
    with open(os.path.join(planted, "00000.npy"), "wb") as f:
        f.write(b"\x93NUMPY half")
    calls = []
    real_save = np.save

    def dying_save(*args, **kw):
        calls.append(1)
        if len(calls) > 2:
            raise KeyboardInterrupt("killed mid-save")
        return real_save(*args, **kw)

    monkeypatch.setattr(checkpoints.np, "save", dying_save)
    with pytest.raises(KeyboardInterrupt):
        mngr.save(4, state.state_tree())
    monkeypatch.setattr(checkpoints.np, "save", real_save)
    assert mngr.latest_step() == 2 and mngr.all_steps() == [2]
    assert sum(name.startswith("4.tmp-") for name in os.listdir(mngr.directory)) == 1
    resumed = _small_state("AdamOptimizer", seed=1)
    resumed.load_state_tree(mngr.restore(mngr.latest_step(), like=resumed.state_tree()))
    assert resumed.step == 2
    mngr.save(6, resumed.state_tree())
    assert sorted(os.listdir(mngr.directory)) == ["2", "6"]


def test_a_restore_that_does_not_fit_names_the_leaf(tmp_path):
    state = _small_state("AdamOptimizer")
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(2, state.state_tree())
    other = _small_state("AdafactorOptimizer")
    with pytest.raises(ValueError, match="missing .*opt_state/1/0/v"):
        mngr.restore(2, like=other.state_tree())
    tree = state.state_tree()
    tree["params/fc/bias"] = torch.zeros(V + 1)
    with pytest.raises(ValueError, match="params/fc/bias: shape"):
        state.load_state_tree(tree)
    tree = state.state_tree()
    tree["opt_state/1/0/mu/fc/bias"] = tree["opt_state/1/0/mu/fc/bias"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="opt_state/1/0/mu/fc/bias: shape .* bfloat16"):
        state.load_state_tree(tree)


def test_variables_and_weights_inputs(tmp_path):
    """The eval and inference CLIs' inputs: a checkpoint's latest step, or a
    weights-only variables.npz (a file, or a directory without
    checkpoints/) at step 0."""
    state = _small_state("SgdOptimizer")
    tree = weights.state_dict_to_flax(state.model)
    npz_dir, ckpt_dir = str(tmp_path / "npz"), str(tmp_path / "ckpt")
    os.makedirs(npz_dir)
    assert checkpoints.latest_weights_step(npz_dir) is None
    path = weights.save_variables_npz(tree, npz_dir)
    assert checkpoints.latest_weights_step(npz_dir) == 0 == checkpoints.latest_weights_step(path)
    mngr = CheckpointManager(ckpt_dir)
    os.makedirs(mngr.directory)
    weights.save_variables_npz(tree, ckpt_dir)  # beside checkpoints/: not read
    assert checkpoints.latest_weights_step(ckpt_dir) is None
    mngr.save(2, state.state_tree())
    assert checkpoints.latest_weights_step(ckpt_dir) == 2
    for source, step in ((npz_dir, 0), (ckpt_dir, 2)):
        got = weights.tree_paths(checkpoints.load_weights(source, step))
        assert got.keys() == weights.tree_paths(tree).keys()
        for name, value in weights.tree_paths(tree).items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)


# --- against the JAX package ----------------------------------------------

PARITY_MODELS = {"NetVLADModelLF-fused": ("NetVLADModelLF", {"fused_train_aggregation": True}),
                 "DbofModel": ("DbofModel", {})}
PARITY_OPTIMIZERS = ("AdamOptimizer", "AdafactorOptimizer")


def _batches(n=3):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        out.append({"features": rng.integers(0, 256, size=(B, F, sum(SIZES)), dtype=np.uint8),
                    "num_frames": rng.integers(1, F + 1, size=B).astype(np.int32),
                    "labels": (rng.random((B, V)) < 0.2).astype(np.float32),
                    "weights": np.r_[np.ones(B - 1), 0].astype(np.float32)})
    return out


def _interpret_aggregate(orig=jnetvlad_train.netvlad_aggregate):
    return lambda x, logits, c2, interpret=False: orig(x, logits, c2, True)


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(np.abs(want).max(), 1.0), err_msg=name)


def _assert_state_matches(port_tree, jax_tree):
    """The port's checkpoint leaves (name → tensor) against JAX's
    ``state_to_tree`` flattened by path: the same names, values at 1e-5."""
    want = weights.tree_paths(jax_tree)
    assert set(port_tree) == set(want), sorted(set(port_tree) ^ set(want))
    for name, w in want.items():
        g = port_tree[name]
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g, np.float32)
        assert g.shape == np.shape(w), name
        _close(g, np.asarray(w, np.float32), name)


@pytest.fixture(scope="module")
def parity():
    """(model case, optimizer) → the JAX run: its jitted step, the initial
    state and the states after 2 and 3 steps and after the resume."""
    cache = {}

    def get(case, optimizer):
        if (case, optimizer) in cache:
            return cache[case, optimizer]
        model_name, overrides = PARITY_MODELS[case]
        mcfg = JModelConfig(**MODEL_KW, **overrides)
        tcfg = JTrainingConfig(**dataclasses.asdict(_tcfg(optimizer)))
        fcfg = FeatureConfig(("rgb", "audio"), SIZES, True, F)
        init = weights.init_variables_np(ModelConfig(**MODEL_KW, **overrides), fcfg, seed=0, model_name=model_name)
        batches = _batches()
        with mock.patch.object(jnetvlad_train, "netvlad_aggregate", _interpret_aggregate()):
            tx = jopt.create_optimizer(tcfg)
            state = JTrainState.create(jax.tree.map(jnp.asarray, init["params"]),
                                       jax.tree.map(jnp.asarray, init["batch_stats"]), tx)
            step = jax.jit(jstep.make_train_step(jcreate(model_name, mcfg), jlosses.CrossEntropyLoss(),
                                                 tcfg, mcfg, True))
            run = {"init": jax.tree.map(np.asarray, jckpt.state_to_tree(state)), "losses": []}
            for i, b in enumerate(batches):
                state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(7))
                run["losses"].append(float(metrics["loss"]))
                if i == 1:
                    run["at2"] = jax.tree.map(np.asarray, jckpt.state_to_tree(state))
            run["at3"] = jax.tree.map(np.asarray, jckpt.state_to_tree(state))
            # resume from step 2: the iterator starts again at the first batch
            state = jckpt.tree_to_state(jax.tree.map(jnp.asarray, run["at2"]), tx)
            run["resumed_losses"] = []
            for b in batches[:2]:
                state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(7))
                run["resumed_losses"].append(float(metrics["loss"]))
            run["at4"] = jax.tree.map(np.asarray, jckpt.state_to_tree(state))
        cache[case, optimizer] = run, batches
        return cache[case, optimizer]

    return get


def _port_state(case, optimizer, jax_tree):
    model_name, overrides = PARITY_MODELS[case]
    mcfg = ModelConfig(**MODEL_KW, **overrides, presampled=True)
    model = create_model(model_name, mcfg, sum(SIZES))
    state = weights.train_state_from_jax_tree(jax_tree, model, _tcfg(optimizer))
    return state, tstep.TrainStep(losses.CrossEntropyLoss(), _tcfg(optimizer), mcfg, True)


def _port_steps(state, step, batches):
    out = []
    for b in batches:
        out.append(float(step(state, {k: torch.from_numpy(v) for k, v in b.items()}, prng.key(7))["loss"]))
    return out


@pytest.mark.parametrize("optimizer", PARITY_OPTIMIZERS)
@pytest.mark.parametrize("case", sorted(PARITY_MODELS))
def test_three_steps_from_the_bridged_state_match_jax(parity, tmp_path, case, optimizer):
    run, batches = parity(case, optimizer)
    state, step = _port_state(case, optimizer, run["init"])
    _assert_state_matches(state.state_tree(), run["init"])  # the bridge carries every leaf
    got = _port_steps(state, step, batches)
    np.testing.assert_allclose(got, run["losses"], rtol=1e-5)
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(state.step, state.state_tree())
    arrays = {name: checkpoints.to_tensor(arr, dtype) for name, (arr, dtype) in mngr.load_arrays(3).items()}
    _assert_state_matches(arrays, run["at3"])
    # and back: the port's state in the JAX tree's structure and dtypes
    back = weights.train_state_to_jax_tree(state, like=run["at3"])
    assert jax.tree.structure(back) == jax.tree.structure(run["at3"])
    _assert_state_matches(state.state_tree(), back)


@pytest.mark.parametrize("case", sorted(PARITY_MODELS))
def test_resume_matches_jax(parity, tmp_path, case):
    """Two steps, a checkpoint, a fresh state restored from it, two more
    steps on the batches from the first again, as the JAX trainer resumes."""
    run, batches = parity(case, "AdamOptimizer")
    state, step = _port_state(case, "AdamOptimizer", run["init"])
    _port_steps(state, step, batches[:2])
    mngr = CheckpointManager(str(tmp_path), keep=1)
    mngr.save(state.step, state.state_tree())
    fresh, step = _port_state(case, "AdamOptimizer", run["init"])
    assert fresh.step == 0
    fresh.load_state_tree(mngr.restore(mngr.latest_step(), like=fresh.state_tree()))
    assert fresh.step == 2
    np.testing.assert_allclose(_port_steps(fresh, step, batches[:2]), run["resumed_losses"], rtol=1e-5)
    mngr.save(fresh.step, fresh.state_tree())
    assert mngr.all_steps() == [4]
    _assert_state_matches(fresh.state_tree(), run["at4"])


# --- the CLIs --------------------------------------------------------------

CLI_FLAGS = ["--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
             "--feature_sizes=1024,128", "--num_classes=20", "--iterations=4", "--netvlad_cluster_size=8",
             "--netvlad_hidden_size=16", "--max_frames=10", "--device=cpu", "--batch_size=2"]


def test_train_cli_killed_mid_run_resumes(tmp_path):
    """SIGKILL the train CLI after its first checkpoint, run it again
    without --start_new_model: it restores a step at least as late and
    finishes."""
    data = str(tmp_path / "train-0.tfrecord")
    fixtures.write_frame_level_fixture(data, 4, num_classes=20, max_frames=10, seed=1)
    train_dir = str(tmp_path / "m")
    args = CLI_FLAGS + [f"--train_data_pattern={data}", f"--train_dir={train_dir}", "--num_epochs=0",
                        "--save_checkpoint_every_n_steps=1", "--keep_checkpoint_max=2"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-m", "learnablepoolingmethods_torch.train", *args,
                             "--max_steps=100000"], cwd=ROOT, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    mngr = CheckpointManager(train_dir)
    saved = None
    deadline = time.time() + 120
    try:
        while time.time() < deadline and proc.poll() is None:
            saved = mngr.latest_step()
            if saved is not None and saved >= 2:
                break
            time.sleep(0.05)
        assert proc.poll() is None, "the train CLI exited before it could be killed"
        assert saved is not None, "no checkpoint appeared before the deadline"
        proc.send_signal(signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
    latest = mngr.latest_step()
    out = subprocess.run([sys.executable, "-m", "learnablepoolingmethods_torch.train", *args,
                          f"--max_steps={latest + 2}"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    m = re.search(r"restored checkpoint at step (\d+)", out.stderr)
    assert m and int(m.group(1)) == latest >= saved, out.stderr[-2000:]
    assert f"done; final checkpoint at step {latest + 2}" in out.stderr
    assert mngr.all_steps() == [latest + 1, latest + 2]


# every optimizer with --adam_bf16_momentum, each run with one of the losses
CLI_OPTIMIZER_RUNS = [(opt, loss) for opt, loss in zip(
    OPTIMIZER_CASES, ["CrossEntropyLoss", "HingeLoss", "SoftmaxLoss"] * 3)]


@pytest.mark.parametrize("optimizer,loss", CLI_OPTIMIZER_RUNS, ids=[f"{o}-{l}" for o, l in CLI_OPTIMIZER_RUNS])
def test_train_cli_trains_and_resumes_with_every_optimizer(tmp_path, optimizer, loss):
    """Two steps of the train CLI, a checkpoint, one more step resumed from
    it, and the eval CLI on the result, with ``optimizer`` and ``loss``; the
    optimizer's state survives the resume (its counts reach 3)."""
    data = str(tmp_path / "train-0.tfrecord")
    fixtures.write_frame_level_fixture(data, 4, num_classes=20, max_frames=10, seed=1)
    name, _, bf16 = optimizer.partition("-")
    flags = CLI_FLAGS + [f"--optimizer={name}", f"--label_loss={loss}", f"--train_data_pattern={data}",
                         f"--train_dir={tmp_path}/m", "--log_every_n_steps=1"] + (
        ["--adam_bf16_momentum"] if bf16 else [])
    train.main(flags + ["--max_steps=2"])
    resumed = train.main(flags + ["--max_steps=3"])
    assert resumed.restored_step == 2 and [h["step"] for h in resumed.history] == [3]
    assert np.isfinite(resumed.history[0]["loss"])
    counts = {k: int(v) for k, v in resumed.state.state_tree().items() if k.endswith("count")}
    assert counts and set(counts.values()) == {3}, counts
    info = teval.main(CLI_FLAGS + [f"--label_loss={loss}", f"--eval_data_pattern={data}",
                                   f"--train_dir={tmp_path}/m", "--run_once"])
    assert np.isfinite(info["avg_loss"]) and 0.0 <= info["gap"] <= 1.0


def test_eval_cli_writes_its_summary_at_the_checkpoints_step(tmp_path, monkeypatch):
    data = str(tmp_path / "train-0.tfrecord")
    fixtures.write_frame_level_fixture(data, 4, num_classes=20, max_frames=10, seed=1)
    train_dir = str(tmp_path / "m")
    train.main(CLI_FLAGS + [f"--train_data_pattern={data}", f"--train_dir={train_dir}", "--max_steps=3"])
    steps = []

    class Writer(teval.MetricWriter):
        def __init__(self, logdir):  # records the steps; no TensorBoard file
            super().__init__(None)

        def epoch_summary(self, step, info):
            steps.append(step)
            super().epoch_summary(step, info)

    monkeypatch.setattr(teval, "MetricWriter", Writer)
    for extra in ([], ["--fast_forward"]):
        info = teval.main(CLI_FLAGS + extra + [f"--eval_data_pattern={data}", f"--train_dir={train_dir}",
                                               "--run_once"])
        assert 0.0 <= info["gap"] <= 1.0
    assert steps == [3, 3]
