"""The port's TF-checkpoint import ≡ TensorFlow's reader and the JAX
package's importer, on the CPU (tensorflow is installed here, not on the
card's machine; the port never imports it).

- utils/tf_bundle.py against ``tf.train.load_checkpoint`` on bundles TF
  wrote: float32 variables under a ``tower/`` prefix with names long
  enough to span several index blocks, an int64 ``global_step``, int32,
  float64 and bf16 tensors, a TF2 object-based checkpoint, and the
  committed fixture of tools/torch_make_tf_bundle_fixture.py; what it does
  not read raises and names it.
- core/checkpoint_import.py against the JAX package's
  core/checkpoint_import.py for the models of
  tests/unit/test_checkpoint_import.py that the port has: the imported
  trees equal at 1e-6, the exported layouts equal.
- The inference and eval CLIs with ``--reference_checkpoint`` on the
  fixture against the JAX CLIs.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import checkpoint_import as jci
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_torch import eval as teval
from learnablepoolingmethods_torch import inference
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import checkpoint_import as tci
from learnablepoolingmethods_torch.core.weights import tree_paths
from learnablepoolingmethods_torch.data import fixtures
from learnablepoolingmethods_torch.utils import tf_bundle

tf = pytest.importorskip("tensorflow")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "tf_bundle_fixture", os.path.join(ROOT, "tools", "torch_make_tf_bundle_fixture.py"))
FIXTURE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(FIXTURE)

CFG_KW = dict(vocab_size=12, iterations=4, moe_num_mixtures=2, netvlad_cluster_size=4, netvlad_hidden_size=16,
              dbof_cluster_size=16, dbof_hidden_size=8, fv_cluster_size=4, fv_hidden_size=16)


def _tf_values(prefix):
    reader = tf.train.load_checkpoint(prefix)
    return {name: np.asarray(reader.get_tensor(name)) for name in reader.get_variable_to_shape_map()}


def _assert_reader_matches_tf(path):
    got = tf_bundle.BundleReader(path)
    want = _tf_values(tf_bundle.resolve_prefix(path))
    assert got.keys() == sorted(want)
    for name, value in want.items():
        if value.dtype.kind in "OSU":  # TF2's object graph, a string tensor
            with pytest.raises(ValueError, match="DT_STRING"):
                got.get_tensor(name)
            continue
        arr = got.get_tensor(name)
        assert arr.shape == value.shape, name
        if value.dtype == tf.bfloat16.as_numpy_dtype:
            value = value.astype(np.float32)
        assert arr.dtype == value.dtype, name
        np.testing.assert_array_equal(arr, value, err_msg=name)
    return got


def test_reader_matches_tf_on_a_saver_bundle_of_many_blocks(tmp_path):
    """SaveV2, what tf.train.Saver runs: 1500 variables with names of 200
    random characters (past one index block: the keys share no prefix), and
    the other dtypes read."""
    rng = np.random.default_rng(0)
    names, values = [], []
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz_"))
    for i in range(1500):
        names.append(f"tower/{i:05d}" + "".join(rng.choice(letters, 200)))
        values.append(rng.normal(size=(i % 7 + 1, 3)).astype(np.float32))
    names += ["global_step", "tower/ints", "tower/doubles", "tower/halves"]
    values += [np.int64(123456789012), np.arange(6, dtype=np.int32).reshape(2, 3),
               rng.normal(size=(4,)), tf.constant(rng.normal(size=(5,)).astype(np.float32), tf.bfloat16)]
    prefix = str(tmp_path / "model.ckpt-5")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names, shape_and_slices=[""] * len(names),
                      tensors=[tf.convert_to_tensor(v) for v in values])
    reader = _assert_reader_matches_tf(prefix)
    assert reader.num_blocks > 1
    assert reader.get_tensor("global_step").dtype == np.int64


def test_reader_matches_tf_on_tf1_and_tf2_checkpoints(tmp_path):
    rng = np.random.default_rng(1)
    graph = tf.Graph()
    with graph.as_default():
        with tf.compat.v1.variable_scope("tower"):
            tf.compat.v1.get_variable("gates/weights", initializer=rng.normal(size=(3, 8)).astype(np.float32))
        tf.compat.v1.train.get_or_create_global_step()
        with tf.compat.v1.Session(graph=graph) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            tf.compat.v1.train.Saver().save(sess, str(tmp_path / "tf1" / "model.ckpt"), global_step=3)
    _assert_reader_matches_tf(str(tmp_path / "tf1"))  # the directory: its state file names the bundle
    ckpt = tf.train.Checkpoint(w=tf.Variable(rng.normal(size=(2, 5)).astype(np.float32)))
    path = ckpt.write(str(tmp_path / "tf2" / "ckpt"))
    reader = _assert_reader_matches_tf(path)
    assert "w/.ATTRIBUTES/VARIABLE_VALUE" in reader.keys()


def test_reader_matches_tf_on_the_committed_fixture():
    reader = _assert_reader_matches_tf(FIXTURE.FIXTURE_DIR)
    assert int(reader.get_tensor("global_step")) == FIXTURE.FIXTURE_STEP


def test_reader_names_what_it_does_not_read(tmp_path):
    prefix = str(tmp_path / "s")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=["words", "x"], shape_and_slices=["", ""],
                      tensors=[tf.constant(["a", "b"]), tf.constant([1.0, 2.0])])
    reader = tf_bundle.BundleReader(prefix)
    with pytest.raises(ValueError, match="DT_STRING"):
        reader.get_tensor("words")
    np.testing.assert_array_equal(reader.get_tensor("x"), [1.0, 2.0])
    v1 = tmp_path / "v1.ckpt"
    v1.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="V1"):
        tf_bundle.BundleReader(str(v1))
    data = tmp_path / "s.data-00000-of-00001"
    raw = bytearray(data.read_bytes())
    raw[-1] ^= 1
    data.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C mismatch"):
        reader.get_tensor("x")


def test_crc32c_known_value_and_chunked_path():
    assert tf_bundle.crc32c(b"123456789") == 0xE3069283
    data = np.random.default_rng(2).integers(0, 256, 4096 * 70 + 11, dtype=np.uint8).tobytes()
    assert tf_bundle.crc32c(data) == tf_bundle._crc_raw(0xFFFFFFFF, data) ^ 0xFFFFFFFF


# --- the mapping, against the JAX importer -----------------------------------

# model → (frame-level, feature sizes, scope prefix), the cases of
# tests/unit/test_checkpoint_import.py
IMPORT_CASES = {
    "LogisticModel": (False, (16, 8), ""),
    "MoeModel": (False, (16, 8), ""),
    "DbofModel": (True, (16, 8), "tower/"),
    "NetVLADModelLF": (True, (1024, 2), ""),
    "NetFVModelLF": (True, (16, 8), ""),
}


def _jax_tree(model_name, frame, sizes):
    """The flax init of the JAX package's test, BN statistics and MoE biases
    drawn off their initial values."""
    rng = np.random.default_rng(3)
    d = sum(sizes)
    if frame:
        batch = {"features": rng.integers(0, 256, size=(2, 6, d), dtype=np.uint8),
                 "num_frames": np.array([6, 3], np.int32)}
    else:
        batch = {"features": rng.normal(size=(2, d)).astype(np.float32)}
    params, stats = jstep.init_model_variables(jcreate(model_name, JModelConfig(**CFG_KW)), batch, frame)
    params, stats = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)
    stats = jax.tree.map(lambda s: (s + 0.1 * np.abs(rng.normal(size=s.shape))).astype(np.float32), stats)
    params = jax.tree.map(lambda p: (p + 0.01 * rng.normal(size=p.shape)).astype(np.float32), params)
    return params, stats, batch


def _write_tf1(ref_vars, path, scope_prefix=""):
    graph = tf.Graph()
    with graph.as_default():
        for name, value in ref_vars.items():
            tf.compat.v1.Variable(initial_value=value, name=scope_prefix + name)
        with tf.compat.v1.Session(graph=graph) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            tf.compat.v1.train.Saver().save(sess, path, write_meta_graph=False)


def _assert_trees_equal(got, want):
    got, want = tree_paths(got), tree_paths(want)
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for name, value in want.items():
        np.testing.assert_allclose(got[name], np.asarray(value), rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("model_name", sorted(IMPORT_CASES))
def test_import_and_export_match_the_jax_importer(tmp_path, model_name):
    frame, sizes, scope = IMPORT_CASES[model_name]
    params, stats, batch = _jax_tree(model_name, frame, sizes)
    want_ref = jci.export_reference_layout(params, stats, CFG_KW["vocab_size"])
    got_ref = tci.export_reference_layout(params, stats, CFG_KW["vocab_size"])
    assert got_ref.keys() == want_ref.keys()
    for name, value in want_ref.items():
        np.testing.assert_array_equal(got_ref[name], value, err_msg=name)
    path = str(tmp_path / "model.ckpt")
    _write_tf1(want_ref, path, scope)
    jparams, jstats = jci.import_reference_checkpoint(path, model_name, JModelConfig(**CFG_KW), batch,
                                                      frame_features=frame)
    names = ("rgb", "audio") if frame else ("mean_rgb", "mean_audio")
    fcfg = FeatureConfig(names, sizes, frame, 6)
    tree = tci.tree_from_reference_checkpoint(path, model_name, ModelConfig(**CFG_KW), fcfg)
    _assert_trees_equal(tree["params"], jparams)
    _assert_trees_equal(tree["batch_stats"], jstats)
    _assert_trees_equal(tree["params"], params)


def test_missing_gamma_defaults_to_ones_and_strict_names_what_is_missing():
    params, stats, batch = _jax_tree("DbofModel", True, (16, 8))
    ref = {k: v for k, v in jci.export_reference_layout(params, stats, 12).items() if not k.endswith("/gamma")}
    fcfg = FeatureConfig(("rgb", "audio"), (16, 8), True, 6)
    got, _ = tci.import_reference_checkpoint(ref, "DbofModel", ModelConfig(**CFG_KW), fcfg)
    want, _ = jci.import_reference_checkpoint(ref, "DbofModel", JModelConfig(**CFG_KW), batch, frame_features=True)
    _assert_trees_equal(got, want)
    for bn in ("input_bn", "cluster_bn", "hidden1_bn"):
        np.testing.assert_array_equal(got[bn]["scale"], np.ones_like(got[bn]["scale"]))
    with pytest.raises(KeyError, match="fully_connected"):
        tci.import_reference_checkpoint({}, "LogisticModel", ModelConfig(**CFG_KW),
                                        FeatureConfig(("mean_rgb", "mean_audio"), (16, 8)))


# --- the CLIs on the committed fixture -------------------------------------

_JAX_CLI = {
    "inference": """
import json, sys
from absl import flags
from learnablepoolingmethods_tpu import inference
flags.FLAGS(["inference"] + json.loads(sys.argv[1]))
inference.main(None)
""",
    "eval": """
import json, sys
from absl import flags
from learnablepoolingmethods_tpu import eval as eval_cli
flags.FLAGS(["eval"] + json.loads(sys.argv[1]))
info = eval_cli.evaluation_loop()
print("RESULT " + json.dumps({k: float(info[k]) for k in ("gap", "avg_hit_at_one", "avg_perr", "avg_loss")}))
""",
}


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "VideoId,LabelConfidencePairs"
    out = {}
    for line in lines[1:]:
        vid, pairs = line.split(",")
        nums = pairs.split()
        out[vid] = ([int(i) for i in nums[::2]], np.array([float(v) for v in nums[1::2]]))
    return out


def test_reference_checkpoint_clis_match_the_jax_clis(tmp_path):
    data = str(tmp_path / "frames-0.tfrecord")
    fixtures.write_frame_level_fixture(data, 10, num_classes=12, rgb_size=16, audio_size=8, max_frames=20,
                                       seed=2)
    common = FIXTURE.FIXTURE_FLAGS + [f"--reference_checkpoint={FIXTURE.FIXTURE_DIR}", "--batch_size=4",
                                      f"--train_dir={tmp_path}/none"]
    jax_csv, port_csv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    payload = {"inference": common + [f"--input_data_pattern={data}", f"--output_file={jax_csv}", "--top_k=5"],
               "eval": common + [f"--eval_data_pattern={data}", "--run_once"]}
    procs = {cli: subprocess.Popen([sys.executable, "-c", code, json.dumps(payload[cli])], stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
             for cli, code in _JAX_CLI.items()}
    outs = {cli: proc.communicate(timeout=600) for cli, proc in procs.items()}
    for cli, proc in procs.items():
        assert proc.returncode == 0, outs[cli][1][-4000:]
    want = json.loads(next(ln for ln in outs["eval"][0].splitlines() if ln.startswith("RESULT "))[len("RESULT "):])
    assert inference.main(payload["inference"][:-2] + [f"--output_file={port_csv}", "--top_k=5",
                                                       "--device=cpu"]) == 10
    got, ref = _rows(port_csv), _rows(jax_csv)
    assert sorted(got) == sorted(ref)
    for vid, (ids, vals) in ref.items():
        assert got[vid][0] == ids, vid
        np.testing.assert_allclose(got[vid][1], vals, atol=1e-5, err_msg=vid)
    info = teval.main(payload["eval"] + ["--device=cpu"])
    for k, v in want.items():
        np.testing.assert_allclose(info[k], v, atol=1e-5, err_msg=k)
