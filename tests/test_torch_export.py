"""The port's export artifact and its loader (export_model.py) against the
JAX package's: a JAX export serves in the port and a port export in JAX,
with the same classes and scores; the layout checks, the record parser, the
fast-path selection, the trainer's export cadence.

Tolerances: the model-forward route in f32, scores within 1e-5 and the
same classes; the fast route (JAX's jnp path against the port's plain
versions, both bf16), scores within 3e-2 (tests/integration/
test_serving.py's bf16 tolerance) on the classes both return.
"""

import os

import numpy as np
import pytest

from learnablepoolingmethods_torch import export_model as tem
from learnablepoolingmethods_torch import train
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.core.checkpoints import CheckpointManager
from learnablepoolingmethods_torch.data import fixtures, tfrecord_io
from learnablepoolingmethods_torch.models import create_model, list_models
from learnablepoolingmethods_torch.utils import flax_msgpack

from learnablepoolingmethods_tpu import config as jconfig
from learnablepoolingmethods_tpu import export_model as jem

F32_TOL, BF16_TOL = 1e-5, 3e-2
FCFG = FeatureConfig(("rgb", "audio"), (1024, 128), True, 10)
VIDEO_FCFG = FeatureConfig(("mean_rgb", "mean_audio"), (6, 2))
# every width small; iterations < max_frames, so that the sampling models
# draw frames and the fast route's key(0) decides which
SMALL = dict(vocab_size=12, netvlad_cluster_size=4, netvlad_hidden_size=8, iterations=6, dbof_cluster_size=8,
             dbof_hidden_size=8, fv_cluster_size=4, fv_hidden_size=8, dbow_cluster_size=8, rvlad_cluster_size=4,
             nextvlad_cluster_size=4, nextvlad_hidden_size=8, nextvlad_groups=2, lstm_cells=8, gru_cells=8,
             attention_hidden_size=16, attention_heads=2, transformer_layers=1, transformer_ff_size=24,
             attention_cluster_size=3)


def _jax_configs(mcfg: ModelConfig, fcfg: FeatureConfig):
    import dataclasses

    jf = dataclasses.asdict(fcfg)
    return jconfig.ModelConfig(**dataclasses.asdict(mcfg)), jconfig.FeatureConfig(**jf)


def _frame_records(counts=((10, 10), (3, 3), (14, 14), (1, 1), (7, 4), (5, 0))):
    """Frame-level records: fewer and more frames than max_frames, one
    frame, audio shorter than rgb, and no audio list at all (the last)."""
    rng = np.random.default_rng(1)
    out = []
    for i, (n_rgb, n_aud) in enumerate(counts):
        rgb = rng.integers(0, 256, (n_rgb, 1024), dtype=np.uint8)
        aud = rng.integers(0, 256, (n_aud, 128), dtype=np.uint8)
        names = ("rgb", "audio") if n_aud else ("rgb", "not_audio")
        out.append(fixtures.encode_frame_sequence_example(b"v%d" % i, [1], rgb, aud, feature_names=names))
    return out


def _video_records():
    rng = np.random.default_rng(2)
    return [fixtures.encode_video_example(b"v%d" % i, [1], rng.standard_normal(6).astype(np.float32),
                                          rng.standard_normal(2).astype(np.float32)) for i in range(5)]


CASES = {
    # name: (model, frame-level, prefer_fast)
    "LogisticModel": ("LogisticModel", False, False),
    "NetVLADModelLF": ("NetVLADModelLF", True, False),
    "NetVLADModelLF-fast": ("NetVLADModelLF", True, True),
}


def _shifted(stats):
    """BN statistics moved off their init (mean 0, var 1)."""
    return {k: _shifted(v) if isinstance(v, dict) else v + np.float32(0.1) for k, v in stats.items()}


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Each case's weights (a seeded tree) exported by both packages:
    case → {"jax": dir, "port": dir}."""
    root = tmp_path_factory.mktemp("exports")
    mcfg = ModelConfig(**SMALL)
    by_model = {}
    for model, frame, _ in CASES.values():
        if model in by_model:
            continue
        fcfg = FCFG if frame else VIDEO_FCFG
        tree = weights.init_variables_np(mcfg, fcfg, seed=3, model_name=model)
        stats = _shifted(tree["batch_stats"])
        if model == "NetVLADModelLF":
            # scores spread over (0.78, 1): frames drawn from another key
            # than key(0) move them by 0.16, past the fast route's 3e-2
            params = tree["params"]
            params["hidden1_weights"] = params["hidden1_weights"] * np.float32(3)
            for name in ("gates_kernel", "experts_kernel"):
                params["MoeModel_0"][name] = params["MoeModel_0"][name] * np.float32(3)
        jm, jf = _jax_configs(mcfg, fcfg)
        by_model[model] = {
            "jax": jem.export_model(str(root / f"{model}-jax"), model, jm, jf, tree["params"], stats, top_k=3),
            "port": tem.export_model(str(root / f"{model}-port"), model, mcfg, fcfg, tree["params"], stats,
                                     top_k=3),
        }
    return {case: by_model[model] for case, (model, _, _) in CASES.items()}


def _compare(got, want, tol):
    (gi, gv), (wi, wv) = got, want
    assert gi.shape == wi.shape and np.isfinite(gv).all()
    np.testing.assert_allclose(gv, wv, atol=tol)
    if tol == F32_TOL:
        np.testing.assert_array_equal(gi, wi)
    for grow, gvals, wrow, wvals in zip(gi, gv, wi, wv):
        shared = set(grow.tolist()) & set(wrow.tolist())
        assert len(shared) >= len(grow) - 1
        g, w = dict(zip(grow.tolist(), gvals)), dict(zip(wrow.tolist(), wvals))
        for c in shared:
            assert abs(g[c] - w[c]) <= tol


@pytest.mark.parametrize("direction", ["jax_export_in_port", "port_export_in_jax"])
@pytest.mark.parametrize("case", list(CASES))
def test_served_alike_across_packages(exports, case, direction):
    model, frame, fast = CASES[case]
    records = _frame_records() if frame else _video_records()
    src = exports[case]["jax" if direction == "jax_export_in_port" else "port"]
    for name in (tem.PARAMS_FILE, tem.STATS_FILE):  # the same bytes either way
        with open(os.path.join(exports[case]["jax"], name), "rb") as a, \
                open(os.path.join(exports[case]["port"], name), "rb") as b:
            assert a.read() == b.read(), name
    *_, jax_serve = jem.load_exported_model(src, prefer_fast=fast)
    port_model, params, _, mcfg, fcfg, port_serve = tem.load_exported_model(src, prefer_fast=fast, device="cpu")
    assert (port_model is None) == fast and mcfg.iterations == 6 and fcfg.frame_features == frame
    assert isinstance(params, dict)
    _compare(port_serve(records), jax_serve(records), BF16_TOL if fast else F32_TOL)


def test_fast_route_draws_from_key_zero_for_every_batch(exports):
    """JAX's serve passes jax.random.key(0) to every batch: the same
    records give the same scores in two calls, and a call with another key
    (fold_in(key(0), 1), the inference CLI's second batch) gives others."""
    from learnablepoolingmethods_torch.ops.fast_infer import build_fast_netvlad_inference, prepare_fast_params
    from learnablepoolingmethods_torch.utils import prng
    import torch

    records = _frame_records()
    *_, mcfg, fcfg, serve = tem.load_exported_model(exports["NetVLADModelLF-fast"]["port"], prefer_fast=True,
                                                    device="cpu")
    first, second = serve(records), serve(records)
    np.testing.assert_array_equal(first[1], second[1])
    tree = flax_msgpack.load(os.path.join(exports["NetVLADModelLF-fast"]["port"], tem.PARAMS_FILE))
    stats = flax_msgpack.load(os.path.join(exports["NetVLADModelLF-fast"]["port"], tem.STATS_FILE))
    fp = prepare_fast_params(weights.convert_flax_variables({"params": tree, "batch_stats": stats}, mcfg), mcfg,
                             device="cpu")
    feats, nfs = tem.parse_serialized_records(fcfg, records)
    fn = build_fast_netvlad_inference(mcfg, top_k=3)
    vals, _ = fn(fp, torch.from_numpy(feats), torch.from_numpy(nfs), prng.key(0))
    np.testing.assert_array_equal(vals.float().numpy(), first[1])
    other, _ = fn(fp, torch.from_numpy(feats), torch.from_numpy(nfs), prng.fold_in(prng.key(0), 1))
    assert np.abs(other.float().numpy() - first[1]).max() > 0


def test_bf16_params_tree_round_trips(tmp_path, exports):
    """A --bf16_params model's tree (bf16 parameters kept as bits, f32 BN
    statistics) exports, loads in JAX as bfloat16 leaves of the same bits,
    loads back in the port as BFloat16Bits, and serves alike (f32
    compute)."""
    mcfg = ModelConfig(**SMALL, param_dtype="bfloat16")
    src = exports["NetVLADModelLF"]["port"]
    model = create_model("NetVLADModelLF", mcfg, FCFG.total_size)
    weights.load_flax_variables(model, {"params": flax_msgpack.load(os.path.join(src, tem.PARAMS_FILE)),
                                        "batch_stats": flax_msgpack.load(os.path.join(src, tem.STATS_FILE))})
    tree = weights.state_dict_to_flax(model, keep_bf16=True)
    assert isinstance(tree["params"]["hidden1_weights"], flax_msgpack.BFloat16Bits)
    assert tree["batch_stats"]["input_bn"]["mean"].dtype == np.float32
    export_dir = tem.export_model(str(tmp_path / "bf16"), "NetVLADModelLF", mcfg, FCFG, tree["params"],
                                  tree["batch_stats"], top_k=3)
    _, jparams, _, _, _, jax_serve = jem.load_exported_model(export_dir)
    assert jparams["hidden1_weights"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jparams["hidden1_weights"]).view(np.uint16),
                                  tree["params"]["hidden1_weights"].view(np.uint16))
    _, params, _, _, _, port_serve = tem.load_exported_model(export_dir, device="cpu")
    for path, leaf in weights.tree_paths(tree["params"]).items():
        got = weights.tree_paths(params)[path]
        assert type(got) is type(leaf) and got.dtype == leaf.dtype
        np.testing.assert_array_equal(got, leaf)
    records = _frame_records()
    _compare(port_serve(records), jax_serve(records), F32_TOL)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_export_that_does_not_fit_the_model_raises(tmp_path, exports, fault):
    """The port refuses a missing leaf, as flax's from_bytes against the
    model's template does, and an extra leaf or another shape, which flax
    lets through."""
    src = exports["NetVLADModelLF"]["port"]
    params = flax_msgpack.load(os.path.join(src, tem.PARAMS_FILE))
    stats = flax_msgpack.load(os.path.join(src, tem.STATS_FILE))
    if fault == "missing":
        del params["NetVLAD_1"]["cluster_weights2"]
    elif fault == "extra":
        params["NetVLAD_1"]["stray"] = np.zeros(3, np.float32)
    else:
        params["hidden1_weights"] = params["hidden1_weights"][:-1]
    mcfg = ModelConfig(**SMALL)
    export_dir = tem.export_model(str(tmp_path / fault), "NetVLADModelLF", mcfg, FCFG, params, stats, top_k=3)
    with pytest.raises(ValueError, match="does not fit the model"):
        tem.load_exported_model(export_dir, device="cpu")
    if fault == "missing":  # flax's from_bytes checks the template's keys only
        with pytest.raises(ValueError):
            jem.load_exported_model(export_dir)


@pytest.mark.parametrize("frame", [True, False], ids=["frame_level", "video_level"])
def test_parse_serialized_records_equals_jax(frame):
    fcfg = FCFG if frame else VIDEO_FCFG
    records = _frame_records() if frame else _video_records()
    got = tem.parse_serialized_records(fcfg, records)
    want = jem.parse_serialized_records(_jax_configs(ModelConfig(), fcfg)[1], records)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    if frame:
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == np.int32 and got[1].tolist() == [10, 3, 10, 1, 4, 0]
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("presampled", [False, True], ids=["sampling", "presampled"])
def test_try_fast_predict_selects_the_models_jax_selects(presampled):
    """Over every registered model: a fast forward where JAX builds one,
    None where JAX returns None, and None for a presampled config."""
    mcfg = ModelConfig(**SMALL, presampled=presampled)
    jm, _ = _jax_configs(mcfg, FCFG)
    selected = {}
    for name in list_models():
        fcfg = VIDEO_FCFG if name in ("LogisticModel", "MoeModel") else FCFG
        tree = weights.init_variables_np(mcfg, fcfg, seed=0, model_name=name)
        want = jem._try_fast_predict(name, jm, tree, 3) is not None
        got = tem._try_fast_predict(name, mcfg, tree, 3, device="cpu") is not None
        assert got == want, name
        selected[name] = got
    if presampled:
        assert not any(selected.values())
    else:
        assert selected["NetVLADModelLF"] and selected["TransformerEncoderModel"]
        assert not selected["LstmModel"] and not selected["LogisticModel"]


def test_fast_serve_kernel_error_propagates(monkeypatch, exports):
    """A failing kernel on the fast route reaches the caller: no fallback
    to the model-forward route."""
    from learnablepoolingmethods_torch import serving
    from learnablepoolingmethods_torch.ops import fast_infer

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(fast_infer, "netvlad_frontend", broken)
    server = serving.ModelServer(exports["NetVLADModelLF-fast"]["port"], 2, fast_serve=True, device="cpu")
    assert server.model is None
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        server.warmup()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        server.predict(_frame_records()[:1])


def test_stablehlo_export_raises_naming_item_14b(tmp_path):
    """(Named for the refusal it held before item 14b landed.)  The native
    runner runs the fast route of NetVLADModelLF only: with_stablehlo on
    another model raises NotImplementedError naming ROADMAP item 14c, and
    writes nothing (tests/test_torch_native_export.py holds the route)."""
    with pytest.raises(NotImplementedError, match="ROADMAP item 14c"):
        tem.export_model(str(tmp_path / "e"), "LogisticModel", ModelConfig(), VIDEO_FCFG, {}, {},
                         with_stablehlo=True)
    assert not os.path.exists(tmp_path / "e")


TRAIN_FLAGS = ["--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
               "--feature_sizes=1024,128", "--num_classes=12", "--iterations=6", "--netvlad_cluster_size=4",
               "--netvlad_hidden_size=8", "--max_frames=10", "--device=cpu", "--batch_size=4", "--max_steps=4",
               "--save_checkpoint_every_n_steps=2", "--export_model_steps=2"]


@pytest.mark.parametrize("flags", [[], ["--bf16_params"]], ids=["f32", "bf16_params"])
def test_train_cli_exports_at_its_cadence(tmp_path, flags):
    """--export_model_steps=2 over four steps: export/step_2 and step_4,
    each the checkpoint's weights at its step (bf16 parameters as bf16);
    JAX's loader serves step_4 as the port does."""
    data = str(tmp_path / "train-0.tfrecord")
    fixtures.write_frame_level_fixture(data, 8, num_classes=12, max_frames=10, seed=1)
    train_dir = str(tmp_path / "m")
    train.main(TRAIN_FLAGS + [f"--train_data_pattern={data}", f"--train_dir={train_dir}", *flags])
    assert sorted(os.listdir(os.path.join(train_dir, "export"))) == ["step_2", "step_4"]
    mngr = CheckpointManager(train_dir)
    for step in (2, 4):
        export_dir = os.path.join(train_dir, "export", f"step_{step}")
        params = flax_msgpack.load(os.path.join(export_dir, tem.PARAMS_FILE))
        stats = flax_msgpack.load(os.path.join(export_dir, tem.STATS_FILE))
        want = mngr.variables(step)
        assert isinstance(params["hidden1_weights"], flax_msgpack.BFloat16Bits) == bool(flags)
        for got_tree, want_tree in ((params, want["params"]), (stats, want["batch_stats"])):
            got_flat, want_flat = weights.tree_paths(got_tree), weights.tree_paths(want_tree)
            assert sorted(got_flat) == sorted(want_flat)
            for path, leaf in want_flat.items():
                np.testing.assert_array_equal(weights.as_f32(got_flat[path]), leaf, err_msg=path)
    records = [r for r in tfrecord_io.read_tfrecords(data)]
    *_, jax_mcfg, _, jax_serve = jem.load_exported_model(os.path.join(train_dir, "export", "step_4"))
    *_, port_serve = tem.load_exported_model(os.path.join(train_dir, "export", "step_4"), device="cpu")
    assert not jax_mcfg.presampled and jax_mcfg.param_dtype == ("bfloat16" if flags else "float32")
    _compare(port_serve(records), jax_serve(records), F32_TOL)
