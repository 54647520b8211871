"""The port's input sources in its CLIs ≡ the JAX CLIs': ``cli_flags.
input_iterator`` ≡ JAX ``flags.input_iterator`` for each source, the train
CLI's batches ≡ the JAX trainer's for each source and its ValueError for two
at once, the inference CLI's CSV through ``--packed_cache_dir`` ≡ the JAX
inference CLI's byte for byte, and ``--profile_dir`` writes a trace.

The JAX CLIs run in one subprocess (tests/integration/test_eval_api.py owns
this process's absl flags under xdist).  The CSV's model is a video-level
LogisticModel whose weights and features sit on a 1/8 grid, so that its
logits are exact in both packages and every printed score agrees: the
bytes then test the ids, the order and the formatter, not f32 rounding.
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
from learnablepoolingmethods_tpu.data import grain_pipeline as jgrain
from learnablepoolingmethods_tpu.data import packed_cache as jpacked
from learnablepoolingmethods_tpu.data import pipeline as jpipeline
from learnablepoolingmethods_tpu.data.readers import YT8MFrameFeatureReader as JFrameReader
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_tpu.parallel import mesh as jmesh
from learnablepoolingmethods_torch import cli_flags, inference, train
from learnablepoolingmethods_torch.config import FeatureConfig
from learnablepoolingmethods_torch.core.weights import save_variables_npz
from learnablepoolingmethods_torch.data import fixtures
from learnablepoolingmethods_torch.data.tfrecord_io import write_tfrecord

V, VIDEO_SIZES, FRAME_SIZES, MAXF = 16, (12, 4), (8, 4), 10
VIDEO_FLAGS = ["--noframe_features", "--feature_names=mean_rgb,mean_audio", "--feature_sizes=12,4",
               "--num_classes=16", "--model=LogisticModel"]
FRAME_FLAGS = ["--frame_features", "--feature_names=rgb,audio", "--feature_sizes=8,4", f"--max_frames={MAXF}",
               "--num_classes=16"]
SOURCES = {"python": [], "packed": ["--packed_cache_dir={cache}"], "grain": ["--use_grain"]}
ITER_CALL = dict(batch_size=8, num_epochs=2, shuffle=True, seed=5)

_JAX = """
import json, os, sys
import numpy as np
from absl import flags
from learnablepoolingmethods_tpu import flags as lpm_flags
from learnablepoolingmethods_tpu import inference
FLAGS = flags.FLAGS
payload = json.loads(sys.argv[1])
for argv in payload["inference"]:
    FLAGS.unparse_flags()
    FLAGS(["inference"] + argv)
    inference.main(None)
for name, (argv, call) in payload["iterators"].items():
    FLAGS.unparse_flags()
    FLAGS(["inference"] + argv)
    batches = list(lpm_flags.input_iterator(call["pattern"], call["batch_size"], num_epochs=call["num_epochs"],
                                            shuffle=call["shuffle"], seed=call["seed"]))
    arrays = {f"{i}/{k}": np.array(v, dtype="S32") if k == "video_id" else v
              for i, b in enumerate(batches) for k, v in b.items()}
    np.savez(os.path.join(payload["out"], name + ".npz"), **arrays)
"""


def _grid(rng, shape):
    return (rng.integers(-8, 9, size=shape) / 8).astype(np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ingest"))
    rng = np.random.default_rng(0)
    for i, n in enumerate((12, 8)):
        with open(os.path.join(root, f"videos-{i}.tfrecord"), "wb") as f:
            for j in range(n):
                labels = sorted(rng.choice(V, size=2, replace=False).tolist())
                x = rng.integers(0, 2, size=sum(VIDEO_SIZES)).astype(np.float32)
                write_tfrecord(f, fixtures.encode_video_example(f"v{i}{j:03d}".encode(), labels, x[:12], x[12:]))
    for i, n in enumerate((13, 8)):
        fixtures.write_frame_level_fixture(os.path.join(root, f"frames-{i}.tfrecord"), n, num_classes=V,
                                           rgb_size=8, audio_size=4, max_frames=MAXF, seed=3 + i)
    jmodel = jcreate("LogisticModel", JModelConfig(vocab_size=V))
    params, stats = jstep.init_model_variables(jmodel, {"features": np.zeros((2, 16), np.float32)}, False)
    params = jax.tree.map(lambda p: _grid(rng, p.shape), params)
    mngr = ckpt_lib.CheckpointManager(os.path.join(root, "jax"))
    mngr.save(7, {"params": params, "batch_stats": stats})
    mngr.close()
    os.makedirs(os.path.join(root, "port"))
    save_variables_npz(jax.tree.map(np.asarray, {"params": params, "batch_stats": stats}), os.path.join(root, "port"))
    setup = {"root": root, "videos": os.path.join(root, "videos-*"), "frames": os.path.join(root, "frames-*")}

    def inference_argv(package, source):
        extra = [f.format(cache=os.path.join(root, f"{package}_inference_cache")) for f in SOURCES[source]]
        return VIDEO_FLAGS + extra + [f"--input_data_pattern={setup['videos']}", "--batch_size=8", "--top_k=10",
                                      f"--train_dir={os.path.join(root, package)}",
                                      f"--output_file={os.path.join(root, f'{package}_{source}.csv')}"]

    def iterator_argv(package, source):
        return FRAME_FLAGS + [f.format(cache=os.path.join(root, f"{package}_iter_cache")) for f in SOURCES[source]]

    setup.update(inference_argv=inference_argv, iterator_argv=iterator_argv)
    payload = {"out": root,
               "inference": [inference_argv("jax", s) for s in ("python", "packed")],
               "iterators": {s: (iterator_argv("jax", s), dict(ITER_CALL, pattern=setup["frames"]))
                             for s in SOURCES}}
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _JAX, json.dumps(payload)], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return setup


def _batches_from_npz(path):
    arrays = np.load(path)
    out = {}
    for key in arrays.files:
        i, k = key.split("/")
        out.setdefault(int(i), {})[k] = [bytes(v) for v in arrays[key]] if k == "video_id" else arrays[key]
    return [out[i] for i in sorted(out)]


def _assert_batches_equal(got, want, limit=None):
    got = got if limit is None else got[:limit]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and [bytes(v) for v in g["video_id"]] == [bytes(v) for v in w["video_id"]]
        for k in g:
            if k != "video_id":
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _args(cli, argv):
    return cli.build_parser().parse_args(argv)


def _fcfg(args):
    return FeatureConfig.from_flag_strings(args.feature_names, args.feature_sizes, args.frame_features,
                                           args.max_frames)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_input_iterator_equals_jax_flags_input_iterator(setup, source):
    args = _args(inference, setup["iterator_argv"]("port", source))
    got = list(cli_flags.input_iterator(args, _fcfg(args), setup["frames"], ITER_CALL["batch_size"],
                                        ITER_CALL["num_epochs"], shuffle=True, seed=ITER_CALL["seed"]))
    want = _batches_from_npz(os.path.join(setup["root"], f"{source}.npz"))
    _assert_batches_equal(got, want)
    assert got[-1]["features"].shape[0] == 8 and got[-1]["weights"].min() == 0  # 42 rows, padded to 48


def test_the_packed_and_grain_flags_are_exclusive(setup):
    args = _args(inference, ["--use_grain", "--packed_cache_dir=/x"])
    with pytest.raises(ValueError, match="--packed_cache_dir and --use_grain are exclusive"):
        cli_flags.input_iterator(args, _fcfg(args), setup["frames"], 8, 1)


def test_inference_csv_through_the_packed_cache_equals_the_jax_clis(setup):
    for source in ("python", "packed"):
        assert inference.main(setup["inference_argv"]("port", source) + ["--device=cpu"]) == 20
    csv = {f"{p}_{s}": open(os.path.join(setup["root"], f"{p}_{s}.csv"), "rb").read()
           for p in ("port", "jax") for s in ("python", "packed")}
    assert len(set(csv.values())) == 1, sorted(csv)
    assert csv["port_packed"].count(b"\n") == 21
    for package in ("port", "jax"):
        assert os.path.exists(os.path.join(setup["root"], f"{package}_inference_cache", "meta.json"))


TWO_SOURCES = [("--use_grain", "--use_native_reader"), ("--use_grain", "--packed_cache_dir=/x"),
               ("--use_native_reader", "--packed_cache_dir=/x"),
               ("--use_grain", "--use_native_reader", "--packed_cache_dir=/x")]


@pytest.mark.parametrize("flags", TWO_SOURCES)
def test_train_cli_rejects_two_sources_as_the_jax_trainer(tmp_path, flags):
    with pytest.raises(ValueError, match="--use_grain, --use_native_reader and --packed_cache_dir are "
                                         "mutually exclusive input sources"):
        train.main(list(flags) + VIDEO_FLAGS + [f"--train_data_pattern={tmp_path}/x*",
                                                f"--train_dir={tmp_path}/m", "--device=cpu"])


def _jax_trainer_batches(source, args, setup):
    """The batches of the JAX trainer's source (learnablepoolingmethods_tpu/
    train.py:116-152, one process), from the arguments it passes."""
    kw = dict(feature_sizes=(8, 4), feature_names=("rgb", "audio"), num_classes=V, max_frames=MAXF)
    if source == "native":
        return jpipeline.native_batch_iterator(setup["frames"], 8, True, num_epochs=2, shuffle=True, seed=args.seed,
                                               num_workers=args.num_readers, shard_index=0, num_shards=1, **kw)
    if source == "packed":
        cache = jpacked.build_cache(setup["frames"], args.packed_cache_dir + "_jax", True,
                                    num_workers=args.num_readers, **kw)
        return jpacked.packed_batch_iterator(cache, 8, num_epochs=2, shuffle=True, seed=args.seed)
    if source == "grain":
        return (jmesh.pad_batch_to_multiple(b, 8) for b in jgrain.grain_batch_iterator(
            setup["frames"], 8, True, num_epochs=2, shuffle=True, seed=args.seed,
            worker_count=args.grain_worker_count, shard_by_process=True, **kw))
    reader = JFrameReader(V, (8, 4), ("rgb", "audio"), MAXF)
    return jpipeline.batch_iterator(reader, setup["frames"], 8, num_epochs=2, shuffle=True,
                                    shuffle_buffer=args.shuffle_buffer, seed=args.seed)


@pytest.mark.parametrize("source, flags", [
    ("python", ["--shuffle_buffer=7"]), ("native", ["--use_native_reader", "--num_readers=2"]),
    ("packed", ["--packed_cache_dir={cache}"]), ("grain", ["--use_grain"])])
def test_train_cli_batches_equal_the_jax_trainers(setup, tmp_path, source, flags):
    argv = FRAME_FLAGS + [f.format(cache=tmp_path / "cache") for f in flags] + [
        "--model=NetVLADModelLF", "--batch_size=8", "--num_epochs=2", "--seed=11",
        f"--train_data_pattern={setup['frames']}"]
    args = _args(train, argv)
    got = list(train.Trainer(args)._batches(*train.configs_from_args(args)))
    _assert_batches_equal(got, list(_jax_trainer_batches(source, args, setup)))


def test_profile_dir_writes_a_chrome_trace_of_the_training_loop(setup, tmp_path):
    """--profile_dir on the CPU: one *.pt.trace.json in the directory with
    the loop's ops; the steps (here fed by two grain worker processes) train."""
    trainer = train.main(VIDEO_FLAGS + [
        f"--train_data_pattern={setup['videos']}", f"--train_dir={tmp_path}/m", "--batch_size=8",
        "--max_steps=2", "--log_every_n_steps=1", f"--profile_dir={tmp_path}/trace", "--use_grain",
        "--grain_worker_count=2", "--device=cpu"])
    assert len(trainer.history) == 2 and all(np.isfinite(h["loss"]) for h in trainer.history)
    assert os.listdir(tmp_path / "trace") == [os.path.basename(trainer.trace_path)]
    assert trainer.trace_path.endswith(".pt.trace.json")
    with open(trainer.trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
