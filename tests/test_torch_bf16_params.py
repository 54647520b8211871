"""bf16 parameters (``--bf16_params``, ``--fused_adam``'s storage) ≡ the JAX
package's ``param_dtype="bfloat16"`` on the CPU:

- every ported model's parameter dtypes equal the leaf dtypes of flax's
  initialised tree, one for one, and its BN statistics stay f32;
- the forward from the same bf16 weights equals ``model.apply``'s (f32
  compute: 1e-5);
- three steps of JAX's jitted ``make_train_step`` with the f32 master
  (``fp32_master``, Adam and its per-leaf clip) against the port's
  TrainStep, for NetVLADModelLF through the training kernels' plain
  versions (against the Pallas kernels in interpret mode) and for
  DbofModel: the master at 1e-5, the bf16 parameters within one bf16 step
  and equal on ≥ 99.9 % of their entries, the state's leaves under JAX's
  ``state_to_tree`` names and dtypes, and each gradient's dtype JAX's (f32
  for C₂ through the fused aggregation, whose custom VJP returns it so);
- the eval and inference CLIs with ``--bf16_params`` on a checkpoint of bf16
  parameters against the JAX CLIs on the same weights (one subprocess).
"""

import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from learnablepoolingmethods_torch import inference, losses
from learnablepoolingmethods_torch.config import ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.core.checkpoints import CheckpointManager, dtype_name
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.data import fixtures
from learnablepoolingmethods_torch.models import create_model, find_class_by_name
from learnablepoolingmethods_torch.utils import prng

B, F, SIZES, V = 6, 10, (1024, 16), 20
DT = sum(SIZES)
KW = dict(vocab_size=V, iterations=4, netvlad_cluster_size=8, netvlad_hidden_size=32, rvlad_cluster_size=8,
          fv_cluster_size=4, fv_hidden_size=32, dbow_cluster_size=16, nextvlad_cluster_size=4,
          nextvlad_hidden_size=32, dbof_cluster_size=32, dbof_hidden_size=32)
VIDEO_LEVEL = ("LogisticModel", "MoeModel")
# case → (model, ModelConfig overrides)
DTYPE_CASES = {
    "NetVLADModelLF": ("NetVLADModelLF", {}),
    "NetVLADModelLF-dimred": ("NetVLADModelLF", {"netvlad_dimred": 64}),
    "NetRVLADModelLF": ("NetRVLADModelLF", {}),
    "NetFVModelLF": ("NetFVModelLF", {}),
    "SoftDbofModelLF": ("SoftDbofModelLF", {}),
    "NeXtVLADModel": ("NeXtVLADModel", {}),
    "DbofModel": ("DbofModel", {}),
    "DbofModel-nobn": ("DbofModel", {"dbof_add_batch_norm": False}),
    "FrameLevelLogisticModel": ("FrameLevelLogisticModel", {}),
    "LogisticModel": ("LogisticModel", {}),
    "MoeModel": ("MoeModel", {}),
}
# Adam's first update is ±lr wherever the gradient exceeds ε, so lr 1e-4
# keeps an entry that rounding noise moves within what the others show
TRAIN_KW = dict(batch_size=B, base_learning_rate=1e-4, learning_rate_decay_examples=12)
LR = TRAIN_KW["base_learning_rate"]
STEP_CASES = {"NetVLADModelLF-fused": ("NetVLADModelLF", {"fused_train_aggregation": True}),
              "DbofModel": ("DbofModel", {})}


def _interpret_aggregate(orig=jnetvlad_train.netvlad_aggregate):
    return lambda x, logits, c2, interpret=False: orig(x, logits, c2, True)


def _inputs(model_name, seed=0):
    rng = np.random.default_rng(seed)
    if model_name in VIDEO_LEVEL:
        return {"features": rng.normal(size=(B, DT)).astype(np.float32)}
    return {"features": rng.integers(0, 256, size=(B, F, DT), dtype=np.uint8),
            "num_frames": rng.integers(1, F + 1, size=B).astype(np.int32)}


def _flax_init(model_name, overrides, batch):
    """flax's initialised ``{params, batch_stats}`` at param_dtype bf16 (f32
    compute), jitted; arrays of numpy (params in ml_dtypes bf16)."""
    model = jcreate(model_name, JModelConfig(**KW, **overrides, param_dtype="bfloat16"))
    key = jax.random.key(0)
    kwargs = {"num_frames": jnp.asarray(batch["num_frames"])} if "num_frames" in batch else {}
    with mock.patch.object(jnetvlad_train, "netvlad_aggregate", _interpret_aggregate()):
        v = jax.jit(lambda x: model.init({"params": key, "sampling": key, "dropout": key}, x, training=True,
                                         **kwargs))(jstep.preprocess_input(jnp.asarray(batch["features"])))
    return model, jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v.get("batch_stats", {})})


def _leaves(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_leaves(value, path) if isinstance(value, dict) else {path: np.asarray(value)})
    return out


def _port_model(model_name, overrides, tree=None, **mcfg_kw):
    presampled = model_name not in VIDEO_LEVEL and find_class_by_name(model_name).samples_frames
    mcfg = ModelConfig(**KW, **overrides, param_dtype="bfloat16", presampled=presampled, **mcfg_kw)
    model = create_model(model_name, mcfg, DT)
    return (weights.load_flax_variables(model, tree) if tree is not None else model), mcfg


@pytest.mark.parametrize("case", sorted(DTYPE_CASES))
def test_parameter_dtypes_are_flax_leaf_dtypes(case):
    model_name, overrides = DTYPE_CASES[case]
    _, tree = _flax_init(model_name, overrides, _inputs(model_name))
    want = {path: str(a.dtype) for path, a in _leaves(tree["params"]).items()}
    model, _ = _port_model(model_name, overrides)
    got = {name.replace(".", "/"): dtype_name(p) for name, p in model.named_parameters()}
    assert got == want
    stats = {path: str(a.dtype) for path, a in _leaves(tree["batch_stats"]).items()}
    assert {name.replace(".", "/"): dtype_name(b) for name, b in model.named_buffers()} == stats
    assert set(stats.values()) <= {"float32"}


@pytest.mark.parametrize("model_name", ["NetVLADModelLF", "NetFVModelLF", "DbofModel", "MoeModel"])
def test_forward_at_bf16_parameters_matches_flax(model_name):
    """Inference mode, the frames drawn from key(3) in both packages."""
    batch = _inputs(model_name, seed=1)
    overrides = {"presampled": False} if model_name not in VIDEO_LEVEL else {}
    jmodel, tree = _flax_init(model_name, {}, batch)
    kwargs = {"num_frames": jnp.asarray(batch["num_frames"])} if "num_frames" in batch else {}
    x = jstep.preprocess_input(jnp.asarray(batch["features"]))
    want = jmodel.apply({"params": tree["params"], "batch_stats": tree["batch_stats"]}, x, training=False,
                        **kwargs)["predictions"]
    mcfg = ModelConfig(**KW, param_dtype="bfloat16", **overrides)
    model = weights.load_flax_variables(create_model(model_name, mcfg, DT), tree)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    nf = torch.from_numpy(batch["num_frames"]) if "num_frames" in batch else None
    with torch.no_grad():
        got = model(tstep.preprocess_input(torch.from_numpy(batch["features"])), nf, training=False)
    np.testing.assert_allclose(got["predictions"].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _keep_gradient():
    """An optax transform that passes the gradient on and keeps it."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


def _batches(n=3):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        batch = {"features": rng.integers(0, 256, size=(B, F, DT), dtype=np.uint8),
                 "num_frames": rng.integers(1, F + 1, size=B).astype(np.int32),
                 "labels": (rng.random((B, V)) < 0.2).astype(np.float32)}
        batch["weights"] = np.r_[np.ones(B - 1), 0].astype(np.float32)
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def steps():
    """case → (JAX run, port run): three steps each from flax's bf16 init."""
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        model_name, overrides = STEP_CASES[case]
        batches = _batches()
        _, init = _flax_init(model_name, overrides, batches[0])
        jmcfg = JModelConfig(**KW, **overrides, param_dtype="bfloat16")
        jtcfg = JTrainingConfig(**TRAIN_KW, fp32_master=True)
        jmodel = jcreate(model_name, jmcfg)
        with mock.patch.object(jnetvlad_train, "netvlad_aggregate", _interpret_aggregate()):
            state = JTrainState.create(jax.tree.map(jnp.asarray, init["params"]),
                                       jax.tree.map(jnp.asarray, init["batch_stats"]),
                                       optax.chain(_keep_gradient(), jopt.create_optimizer(jtcfg)))
            step = jax.jit(jstep.make_train_step(jmodel, jlosses.CrossEntropyLoss(), jtcfg, jmcfg, True))
            jloss, grad0 = [], None
            for b in batches:
                state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(7))
                jloss.append(float(metrics["loss"]))
                grad0 = grad0 if grad0 is not None else jax.tree.map(np.asarray, state.opt_state[0])
        tree = jckpt.state_to_tree(state)
        tree = {**tree, "opt_state": tree["opt_state"][1]}  # without the gradient keeper
        want = {name: np.asarray(v) for name, v in weights.tree_paths(jax.tree.map(np.asarray, tree)).items()}

        model, mcfg = _port_model(model_name, overrides, init)
        tcfg = TrainingConfig(**TRAIN_KW, fp32_master=True)
        pstate = TrainState.create(model, tcfg)
        pstep = tstep.TrainStep(losses.CrossEntropyLoss(), tcfg, mcfg, True)
        ploss, pgrad0 = [], None
        for b in batches:
            total = pstep.loss(pstate, {k: torch.from_numpy(v) for k, v in b.items()}, prng.key(7))[0]
            grads = tstep.gradients(total, model)
            if pgrad0 is None:
                pgrad0 = {name.replace(".", "/"): g for (name, _), g in zip(model.named_parameters(), grads)}
            pstate.apply_gradients(grads)
            ploss.append(float(total.detach()))
        cache[case] = ({"loss": jloss, "grad0": _leaves(grad0), "tree": want},
                       {"loss": ploss, "grad0": pgrad0, "tree": pstate.state_tree()})
        return cache[case]

    return get


def _f32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _bf16_step(x):
    """One bf16 step (ulp) at |x|: 2^(e − 7) for x in [2^e, 2^(e+1))."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_bf16_master_steps_match_jax(steps, case):
    want, got = steps(case)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    # the checkpoint's leaves: JAX's state_to_tree names and dtypes
    assert set(got["tree"]) == set(want["tree"])
    for name, w in want["tree"].items():
        assert dtype_name(got["tree"][name]) == str(w.dtype), name
    # each gradient in JAX's dtype; its step-1 values at 1e-5
    noise = 1e-6 * max(np.abs(_f32(g)).max() for g in want["grad0"].values())
    for name, w in want["grad0"].items():
        assert dtype_name(got["grad0"][name]) == str(w.dtype), name
        g, w = _f32(got["grad0"][name]), _f32(w)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-5 + 2 * _bf16_step(w).max() * (
            str(want["grad0"][name].dtype) == "bfloat16"), name
    equal = total = 0
    for name, w in want["tree"].items():
        g, w32 = _f32(got["tree"][name]), _f32(w)
        leaf = name.split("params/", 1)[-1] if name.startswith("params/") else name.split("master/", 1)[-1]
        grad0 = _f32(want["grad0"][leaf]) if leaf in want["grad0"] else None
        exempt = np.zeros(w32.shape, bool) if grad0 is None else np.abs(grad0) < noise
        if name.startswith("params/"):
            # bf16(f32(p) + (master − f32(p))) from masters 1e-5 apart
            assert np.all((np.abs(g - w32) <= _bf16_step(w32)) | exempt), name
            equal += int(np.sum((g == w32) | exempt))
            total += g.size
        elif name.startswith("opt_state/master/"):
            tol = 1e-5 * np.abs(w32).max() + 1e-5
            assert np.abs(np.where(exempt, w32, g) - w32).max() <= tol, name
            assert np.abs(g - w32)[exempt].max(initial=0) <= 3 * 2 * LR, name
        elif not name.startswith("opt_state/inner/") or "count" in name:
            np.testing.assert_allclose(g, w32, rtol=1e-5, atol=1e-5, err_msg=name)
    assert equal / total >= 0.999, equal / total


# the JAX eval and inference CLIs each own the absl flags of their process
_JAX_EVAL = """
import json, sys
from absl import flags
from learnablepoolingmethods_tpu import eval as eval_cli
flags.FLAGS(["eval"] + json.loads(sys.argv[1]))
info = eval_cli.evaluation_loop()
print("RESULT " + json.dumps({k: float(info[k]) for k in ("gap", "avg_hit_at_one", "avg_perr", "avg_loss")}))
"""
_JAX_INFERENCE = """
import json, sys
from absl import flags
from learnablepoolingmethods_tpu import inference
flags.FLAGS(["inference"] + json.loads(sys.argv[1]))
inference.main(None)
"""


CLI_FLAGS = ["--num_classes=16", "--netvlad_cluster_size=4", "--netvlad_hidden_size=8", "--iterations=4",
             "--batch_size=8", "--frame_features", "--feature_names=rgb,audio", "--feature_sizes=1024,2",
             "--max_frames=8", "--model=NetVLADModelLF", "--bf16_params"]


def _csv_rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    rows = {}
    for line in lines[1:]:
        vid, pairs = line.split(",")
        nums = pairs.split()
        rows[vid] = ([int(i) for i in nums[::2]], np.array([float(v) for v in nums[1::2]]))
    return rows


def test_eval_and_inference_clis_read_a_bf16_checkpoint(tmp_path):
    """NetVLADModelLF's bf16 weights (BN statistics moved off their init) as
    a JAX checkpoint and as the port's (bf16 leaves as their bits): both
    packages' eval CLIs (default accumulator: every metric within 1e-5) and
    inference CLIs (the same top 20, scores within 1e-5) with --bf16_params."""
    data = str(tmp_path / "frames-0.tfrecord")
    fixtures.write_frame_level_fixture(data, 20, num_classes=16, rgb_size=1024, audio_size=2, max_frames=8, seed=3)
    rng = np.random.default_rng(0)
    jmodel = jcreate("NetVLADModelLF", JModelConfig(vocab_size=16, netvlad_cluster_size=4, netvlad_hidden_size=8,
                                                    iterations=4, param_dtype="bfloat16"))
    x = rng.integers(0, 256, size=(2, 8, 1026), dtype=np.uint8)
    params, stats = jstep.init_model_variables(jmodel, {"features": x, "num_frames": np.array([8, 3], np.int32)},
                                               True)
    stats = jax.tree.map(lambda s: s + 0.05 * np.abs(rng.normal(size=s.shape)).astype(np.float32), stats)
    assert {str(a.dtype) for a in jax.tree.leaves(params)} == {"bfloat16"}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    mngr = jckpt.CheckpointManager(jdir)
    mngr.save(7, {"params": params, "batch_stats": stats})
    mngr.close()
    tree = jax.tree.map(np.asarray, {"params": params, "batch_stats": stats})
    leaves = {f"params/{k}": torch.from_numpy(v.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
              for k, v in _leaves(tree["params"]).items()}
    leaves.update({f"batch_stats/{k}": torch.from_numpy(v.copy()) for k, v in _leaves(tree["batch_stats"]).items()})
    CheckpointManager(pdir).save(7, leaves)
    eval_argv = CLI_FLAGS + [f"--eval_data_pattern={data}", "--run_once"]
    jcsv, pcsv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    inf_argv = CLI_FLAGS + [f"--input_data_pattern={data}"]
    procs = [subprocess.Popen([sys.executable, "-c", code, json.dumps(argv)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
             for code, argv in ((_JAX_EVAL, eval_argv + [f"--train_dir={jdir}"]),
                                (_JAX_INFERENCE, inf_argv + [f"--train_dir={jdir}", f"--output_file={jcsv}"]))]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    want = json.loads(next(ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT "))[len("RESULT "):])
    got = teval.main(eval_argv + [f"--train_dir={pdir}", "--device=cpu"])
    assert 0.0 < want["gap"] <= 1.0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5, err_msg=k)
    assert inference.main(inf_argv + [f"--train_dir={pdir}", f"--output_file={pcsv}", "--device=cpu"]) == 20
    got_rows, want_rows = _csv_rows(pcsv), _csv_rows(jcsv)
    assert sorted(got_rows) == sorted(want_rows)
    for vid, (ids, vals) in want_rows.items():
        assert got_rows[vid][0] == ids, vid
        np.testing.assert_allclose(got_rows[vid][1], vals, atol=1e-5)
