"""The port's eval CLI and the model-forward route of its inference CLI ≡
the JAX package's CLIs, on the CPU, on the same synthetic TFRecords and
the same weights (a weights-only ``variables.npz`` for the port, a
``CheckpointManager`` checkpoint for JAX, as tests/integration/test_eval_api.py
writes one, each in a train_dir of its own: the two packages' checkpoints
share the directory name ``checkpoints/``).

The JAX CLIs run in a subprocess each: tests/integration/test_eval_api.py
owns the absl flag namespace of this process under xdist.  Each subprocess
parses a command line per case into the CLI's flags and runs what the
CLI's ``main`` runs (``evaluation_loop``, ``inference``), so that one
import and one set of compiles serves every case.

- Default accumulator: every metric within 1e-5, since both draw the same
  frames bit for bit (NetVLADModelLF, DbofModel, and the video-level
  LogisticModel).
- ``--fast_forward`` (the port's plain version on the CPU, JAX's jnp
  route, both bf16): |ΔGAP| <= 1e-3, the north star's budget.
- The inference CLI without ``--fast_infer``: the same CSV rows, labels
  equal and scores within 1e-5.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import checkpoints as ckpt_lib
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_torch import eval as teval
from learnablepoolingmethods_torch import inference
from learnablepoolingmethods_torch.core.checkpoints import CheckpointManager
from learnablepoolingmethods_torch.core.weights import load_variables_npz, save_variables_npz
from learnablepoolingmethods_torch.data import fixtures

V, D_RGB, D_AUDIO, MAXF, N_RECORDS = 16, 1024, 2, 8, 20
VIDEO_SIZES = (12, 4)
MODEL_FLAGS = ["--num_classes=16", "--netvlad_cluster_size=4", "--netvlad_hidden_size=8", "--iterations=4",
               "--dbof_cluster_size=8", "--dbof_hidden_size=8", "--batch_size=8"]
FRAME_FLAGS = ["--frame_features", "--feature_names=rgb,audio", f"--feature_sizes={D_RGB},{D_AUDIO}",
               f"--max_frames={MAXF}"]
VIDEO_FLAGS = ["--noframe_features", "--feature_names=mean_rgb,mean_audio",
               "--feature_sizes={},{}".format(*VIDEO_SIZES)]
METRICS = ("avg_hit_at_one", "avg_perr", "gap", "avg_loss")
# case → (model, extra flags); every case runs in both packages
EVAL_CASES = {
    "NetVLADModelLF": ("NetVLADModelLF", []),
    "NetVLADModelLF-fast_forward": ("NetVLADModelLF", ["--fast_forward"]),
    "DbofModel": ("DbofModel", []),
    "DbofModel-fast_forward": ("DbofModel", ["--fast_forward"]),
    "DbofModel-fast_eval": ("DbofModel", ["--fast_eval"]),
    "NetVLADModelLF-fast_forward-fast_eval": ("NetVLADModelLF", ["--fast_forward", "--fast_eval"]),
    "LogisticModel": ("LogisticModel", []),
    "LogisticModel-HingeLoss": ("LogisticModel", ["--label_loss=HingeLoss"]),
    "NetVLADModelLF-SoftmaxLoss": ("NetVLADModelLF", ["--label_loss=SoftmaxLoss"]),
}

_JAX_EVAL = """
import json, sys
from absl import flags
from learnablepoolingmethods_tpu import eval as eval_cli
out = {}
for case, argv in json.loads(sys.argv[1]).items():
    flags.FLAGS.unparse_flags()
    flags.FLAGS(["eval"] + argv)
    info = eval_cli.evaluation_loop()
    out[case] = {k: float(info[k]) for k in %r}
print("RESULT " + json.dumps(out))
""" % (METRICS,)

_JAX_INFERENCE = """
import json, sys
from absl import flags
from learnablepoolingmethods_tpu import inference
for argv in json.loads(sys.argv[1]):
    flags.FLAGS.unparse_flags()
    flags.FLAGS(["inference"] + argv)
    inference.main(None)
"""


def _run_jax(code: str, payload) -> str:
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code, json.dumps(payload)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _save(root, model_name, frame, x, nf=None):
    """Weights of ``model_name`` as a JAX checkpoint and as the port's
    variables.npz, in train_dirs ``jax/<model>`` and ``port/<model>``.
    BN statistics move off their initial
    values, and DbofModel's MoE bias off zero: with a zero bias every class
    of a video whose hidden layer relu6 zeroes has the same probability,
    and the reference's PERR is defined only up to the order of ties (its
    host PERR takes them in argpartition's order, the device partials
    lowest index first)."""
    jmodel = jcreate(model_name, JModelConfig(vocab_size=V, netvlad_cluster_size=4, netvlad_hidden_size=8,
                                              iterations=4, dbof_cluster_size=8, dbof_hidden_size=8))
    batch = {"features": x} if nf is None else {"features": x, "num_frames": nf}
    params, stats = jstep.init_model_variables(jmodel, batch, frame)
    rng = np.random.default_rng(4)
    stats = jax.tree.map(lambda s: s + 0.05 * np.abs(rng.normal(size=s.shape)).astype(np.float32), stats)
    if model_name == "DbofModel":
        params = jax.tree.map(lambda p: p, params)
        bias = params["MoeModel_0"]["experts_bias"]
        params["MoeModel_0"]["experts_bias"] = bias + rng.normal(scale=0.5, size=bias.shape).astype(np.float32)
    mngr = ckpt_lib.CheckpointManager(os.path.join(root, "jax", model_name))
    mngr.save(7, {"params": params, "batch_stats": stats})
    mngr.close()
    port_dir = os.path.join(root, "port", model_name)
    os.makedirs(port_dir)
    save_variables_npz(jax.tree.map(np.asarray, {"params": params, "batch_stats": stats}), port_dir)
    return model_name


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("evalcli"))
    frames = os.path.join(root, "frames-0.tfrecord")
    fixtures.write_frame_level_fixture(frames, N_RECORDS, num_classes=V, rgb_size=D_RGB,
                                       audio_size=D_AUDIO, max_frames=MAXF, seed=3)
    videos = os.path.join(root, "videos-0.tfrecord")
    fixtures.write_video_level_fixture(videos, N_RECORDS, num_classes=V, rgb_size=VIDEO_SIZES[0],
                                       audio_size=VIDEO_SIZES[1], seed=4)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(2, MAXF, D_RGB + D_AUDIO), dtype=np.uint8)
    nf = np.array([MAXF, 3], np.int32)
    dirs = {name: _save(root, name, True, x, nf) for name in ("NetVLADModelLF", "DbofModel")}
    dirs["LogisticModel"] = _save(root, "LogisticModel", False,
                                  rng.normal(size=(2, sum(VIDEO_SIZES))).astype(np.float32))
    return {"root": root, "frames": frames, "videos": videos, "dirs": dirs}


def _train_dir(setup, model_name, package="port"):
    return os.path.join(setup["root"], package, model_name)


def _eval_argv(setup, model_name, extra, package="port"):
    data = setup["videos"] if model_name == "LogisticModel" else setup["frames"]
    feats = VIDEO_FLAGS if model_name == "LogisticModel" else FRAME_FLAGS
    return (MODEL_FLAGS + feats + extra + [f"--model={model_name}", f"--eval_data_pattern={data}",
                                            f"--train_dir={_train_dir(setup, model_name, package)}",
                                            "--run_once"])


@pytest.fixture(scope="module")
def jax_eval(setup):
    payload = {case: _eval_argv(setup, *spec, package="jax") for case, spec in EVAL_CASES.items()}
    line = next(ln for ln in _run_jax(_JAX_EVAL, payload).splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _port_eval(setup, model_name, extra):
    return teval.main(_eval_argv(setup, model_name, extra) + ["--device=cpu"])


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_eval_cli_matches_the_jax_eval_cli(setup, jax_eval, case):
    model_name, extra = EVAL_CASES[case]
    got, want = _port_eval(setup, model_name, extra), jax_eval[case]
    assert 0.0 < want["gap"] <= 1.0
    if "--fast_forward" in extra:
        assert abs(got["gap"] - want["gap"]) <= 1e-3
    else:
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
        assert (got["aps"] is None) == ("--fast_eval" in extra)


@pytest.mark.parametrize("model_name", ["NetVLADModelLF", "DbofModel", "LogisticModel"])
@pytest.mark.parametrize("route", ["model_forward", "fast_forward"])
def test_fast_eval_agrees_with_the_default_accumulator(setup, model_name, route):
    """The device partials and the host accumulator on the same forward and
    keys: every metric within 1e-5 (tests/integration/test_eval_api.py)."""
    if route == "fast_forward" and model_name == "LogisticModel":
        with pytest.raises(ValueError, match="--fast_forward supports"):
            _port_eval(setup, model_name, ["--fast_forward"])
        return
    extra = ["--fast_forward"] if route == "fast_forward" else []
    default = _port_eval(setup, model_name, extra)
    fast = _port_eval(setup, model_name, extra + ["--fast_eval"])
    for k in METRICS:
        np.testing.assert_allclose(fast[k], default[k], atol=1e-5, err_msg=k)
    assert fast["aps"] is None and default["aps"] is not None


def test_eval_cli_refuses_what_is_not_ported(setup):
    # --int8_hidden needs --fast_forward (the JAX eval CLI's ValueError);
    # --bf16_params is ported (test_torch_bf16_params.py)
    with pytest.raises(ValueError, match="--int8_hidden requires --fast_forward"):
        _port_eval(setup, "NetVLADModelLF", ["--int8_hidden"])
    with pytest.raises(ValueError, match="--int8_hidden requires --fast_forward"):
        _port_eval(setup, "DbofModel", ["--int8_hidden", "--fast_forward"])
    with pytest.raises(ValueError, match="needs --frame_features"):
        teval.main(MODEL_FLAGS + VIDEO_FLAGS + ["--model=DbofModel", "--fast_forward", "--run_once",
                                                f"--eval_data_pattern={setup['videos']}",
                                                f"--train_dir={_train_dir(setup, 'DbofModel')}",
                                                "--device=cpu"])


def test_eval_polls_and_evaluates_again_when_the_weights_change(setup, tmp_path, monkeypatch):
    """Without --run_once the CLI waits for a checkpoint, evaluates its
    latest step, skips a poll where no new step appeared, evaluates the
    next step once it is saved, and writes each summary to <train_dir>/eval
    at the step it evaluated."""
    weights = load_variables_npz(_train_dir(setup, "LogisticModel"))
    train_dir = str(tmp_path / "td")
    mngr = CheckpointManager(train_dir)
    infos, summaries = [], []
    real_evaluate = teval.evaluate_checkpoint

    def evaluate(*args, **kw):
        infos.append(real_evaluate(*args, **kw))
        return infos[-1]

    class Writer(teval.MetricWriter):
        def epoch_summary(self, step, info):
            summaries.append(step)
            super().epoch_summary(step, info)

    class Stop(Exception):
        pass

    def save(step, scale):
        tree = {"params": {"fc": {k: v * scale if k == "kernel" else v
                                  for k, v in weights["params"]["fc"].items()}}}
        mngr.save(step, {f"params/fc/{k}": v for k, v in tree["params"]["fc"].items()})

    sleeps = iter([lambda: save(5, 1.0), lambda: None, lambda: save(9, 3.0)])

    def sleep(_secs):
        step = next(sleeps, None)
        if step is None:
            raise Stop
        step()

    monkeypatch.setattr(teval, "evaluate_checkpoint", evaluate)
    monkeypatch.setattr(teval, "MetricWriter", Writer)
    monkeypatch.setattr(teval.time, "sleep", sleep)
    argv = _eval_argv(setup, "LogisticModel", [])
    argv = [a for a in argv if a not in ("--run_once",) and not a.startswith("--train_dir")]
    with pytest.raises(Stop):
        teval.main(argv + [f"--train_dir={train_dir}", "--device=cpu", "--poll_interval_secs=1"])
    assert len(infos) == 2 and infos[0]["avg_loss"] != infos[1]["avg_loss"]
    assert summaries == [5, 9]
    assert os.listdir(os.path.join(train_dir, "eval"))


INFERENCE_CASES = {
    "NetVLADModelLF": ("NetVLADModelLF", FRAME_FLAGS, "frames"),
    "LogisticModel": ("LogisticModel", VIDEO_FLAGS, "videos"),
}


@pytest.fixture(scope="module")
def jax_csvs(setup):
    argvs, out = [], {}
    for case, (model_name, feats, data) in INFERENCE_CASES.items():
        out[case] = os.path.join(setup["root"], f"jax-{case}.csv")
        argvs.append(MODEL_FLAGS + feats + [f"--model={model_name}", f"--input_data_pattern={setup[data]}",
                                            f"--train_dir={_train_dir(setup, model_name, 'jax')}",
                                            f"--output_file={out[case]}"])
    _run_jax(_JAX_INFERENCE, argvs)
    return out


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "VideoId,LabelConfidencePairs"
    rows = {}
    for line in lines[1:]:
        vid, pairs = line.split(",")
        nums = pairs.split()
        rows[vid] = ([int(i) for i in nums[::2]], np.array([float(v) for v in nums[1::2]]))
    return rows


@pytest.mark.parametrize("case", sorted(INFERENCE_CASES))
def test_model_forward_inference_cli_writes_the_jax_csv(setup, jax_csvs, tmp_path, case):
    model_name, feats, data = INFERENCE_CASES[case]
    out = str(tmp_path / "port.csv")
    written = inference.main(MODEL_FLAGS + feats + [
        f"--model={model_name}", f"--input_data_pattern={setup[data]}",
        f"--train_dir={_train_dir(setup, model_name)}", f"--output_file={out}", "--device=cpu"])
    got, want = _rows(out), _rows(jax_csvs[case])
    assert written == N_RECORDS and sorted(got) == sorted(want)
    for vid, (ids, vals) in want.items():
        assert got[vid][0] == ids and len(ids) == V, vid
        np.testing.assert_allclose(got[vid][1], vals, atol=1e-5, err_msg=vid)
