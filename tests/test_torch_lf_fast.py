"""The port's fast LF inference (ops/fast_lf.py) ≡ the JAX package's on the
CPU, for NetFVModelLF, NetRVLADModelLF, SoftDbofModelLF and NeXtVLADModel:
the plain route against JAX's build_fast_lf_inference(use_pallas=False) and
against the port's own nn.Module model, the kernel route (the CPU wrappers
take the plain versions) against the plain one, init_variables_np against
flax's model.init for all five LF models, and the inference CLI against the
JAX fast path on the same sampled frames."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.data.pipeline import batch_iterator as j_batch_iterator
from learnablepoolingmethods_tpu.data.readers import YT8MFrameFeatureReader as JReader
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_tpu.ops import fast_lf as jlf
from learnablepoolingmethods_torch import inference
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.data import fixtures as tfix
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.ops import fast_lf
from learnablepoolingmethods_torch.ops.fast_dispatch import get_fast_path
from learnablepoolingmethods_torch.utils import prng

LF = ["NetFVModelLF", "NetRVLADModelLF", "SoftDbofModelLF", "NeXtVLADModel"]
KW = dict(iterations=12, vocab_size=29, fv_cluster_size=8, rvlad_cluster_size=8, dbow_cluster_size=16,
          nextvlad_cluster_size=8, netvlad_hidden_size=32, fv_hidden_size=32, nextvlad_hidden_size=32)
B, F, DT = 3, 12, 1152


@pytest.fixture(scope="module")
def flax_models():
    """Per model: (flax model, variables with perturbed BN statistics as
    NumPy arrays), made from presampled frames as tests/unit/test_fast_lf.py."""
    out = {}
    for name in LF:
        rng = np.random.default_rng(0)
        model = jcreate(name, JModelConfig(**KW, presampled=True))
        batch = {"features": rng.integers(0, 256, size=(B, F, DT), dtype=np.uint8),
                 "num_frames": rng.integers(4, F + 1, size=(B,)).astype(np.int32)}
        params, stats = jstep.init_model_variables(model, batch, frame_features=True)
        stats = jax.tree.map(lambda s: s + 0.05 * np.abs(rng.normal(size=s.shape)).astype(np.float32), stats)
        out[name] = (model, jax.tree.map(np.asarray, {"params": params, "batch_stats": stats}))
    return out


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 256, size=(B, F, DT), dtype=np.uint8)
    nf = rng.integers(4, F + 1, size=(B,)).astype(np.int32)
    return feats, nf


def _port_fp(name, tree, dtype, cfg=None):
    cfg = cfg or ModelConfig(**KW)
    return fast_lf.prepare_fast_lf_params(weights.convert_flax_variables(tree, cfg, name), cfg, name,
                                          compute_dtype=dtype, device="cpu")


@pytest.mark.parametrize("model_name", LF)
def test_plain_route_f32_matches_jax_and_the_port_model(flax_models, model_name):
    model, tree = flax_models[model_name]
    feats, nf = _frames()
    jcfg = JModelConfig(**KW, compute_dtype="float32", presampled=True)
    jfp = jlf.prepare_fast_lf_params(tree, jcfg, model_name, compute_dtype=jnp.float32)
    want = jlf.build_fast_lf_inference(jcfg, model_name, use_pallas=False, compute_dtype=jnp.float32,
                                       return_probs=True)(jfp, jnp.asarray(feats), jnp.asarray(nf),
                                                          jax.random.key(0), presampled=True)
    fn = fast_lf.build_fast_lf_inference(ModelConfig(**KW), model_name, use_kernels=False,
                                         compute_dtype=torch.float32, return_probs=True)
    got = fn(_port_fp(model_name, tree, torch.float32), torch.from_numpy(feats), torch.from_numpy(nf),
             prng.key(0), presampled=True)
    # f32 throughout, sums in another order (tests/unit/test_fast_lf.py:79)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    port = weights.load_flax_variables(create_model(model_name, ModelConfig(**KW, presampled=True), DT), tree)
    want_model = port(tstep.preprocess_input(torch.from_numpy(feats)), torch.from_numpy(nf), training=False)
    np.testing.assert_allclose(got.numpy(), want_model["predictions"].detach().numpy(), atol=2e-4)


@pytest.mark.parametrize("model_name", LF)
def test_bf16_routes_match_jax_plain_route_with_its_indices(flax_models, model_name):
    """bf16 uint8 input, unsampled: both the port's routes draw JAX's frames
    from the same key; the plain route against JAX's plain route, and the
    kernel route (the CPU wrappers take the plain versions) bit for bit the
    plain route."""
    _, tree = flax_models[model_name]
    feats, nf = _frames(1)
    jcfg = JModelConfig(**KW)
    jfp = jlf.prepare_fast_lf_params(tree, jcfg, model_name, compute_dtype=jnp.bfloat16)
    want = jlf.build_fast_lf_inference(jcfg, model_name, use_pallas=False, return_probs=True)(
        jfp, jnp.asarray(feats), jnp.asarray(nf), jax.random.key(3))
    fp = _port_fp(model_name, tree, torch.bfloat16)
    got = {use: fast_lf.build_fast_lf_inference(ModelConfig(**KW), model_name, use_kernels=use,
                                                return_probs=True)(
        fp, torch.from_numpy(feats), torch.from_numpy(nf), prng.key(3)) for use in (False, True)}
    # bf16 rounding points are the same; f32 sums run in another order and
    # XLA may keep bf16 intermediates in f32 (test_fast_infer.py:141's 3e-2)
    np.testing.assert_allclose(got[False].numpy(), np.asarray(want), atol=3e-2)
    torch.testing.assert_close(got[True], got[False], rtol=0, atol=0)


@pytest.mark.parametrize("model_name", ["NetVLADModelLF"] + LF)
def test_init_variables_np_matches_flax_init(model_name):
    cfg = dict(KW, netvlad_cluster_size=8)
    model = jcreate(model_name, JModelConfig(**cfg, presampled=True))
    want = jax.eval_shape(
        lambda x: model.init({"params": jax.random.key(0), "sampling": jax.random.key(1)}, x,
                             num_frames=jnp.full((2,), 6), training=True),
        jax.ShapeDtypeStruct((2, 6, DT), jnp.float32))
    want = {"params": want["params"], "batch_stats": want["batch_stats"]}
    got = weights.init_variables_np(ModelConfig(**cfg), FeatureConfig(("rgb", "audio"), (1024, 128), True, 6),
                                    seed=0, model_name=model_name)

    def shapes(tree):
        return {jax.tree_util.keystr(p): tuple(np.shape(leaf))
                for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}

    assert shapes(got) == shapes(want)
    # and the tree converts and loads into the port's model
    tv = weights.convert_flax_variables(got, ModelConfig(**cfg), model_name)
    assert jax.tree_util.tree_structure(jax.tree.map(np.asarray, tv)) == jax.tree_util.tree_structure(got)
    weights.load_flax_variables(create_model(model_name, ModelConfig(**cfg), DT), got)


def test_init_variables_np_scales():
    cfg = ModelConfig(**dict(KW, nextvlad_cluster_size=64, fv_cluster_size=16))
    fcfg = FeatureConfig(("rgb", "audio"), (1024, 128), True)
    nx = weights.init_variables_np(cfg, fcfg, seed=1, model_name="NeXtVLADModel")["params"]
    # normal(1/√fan), a few thousand draws each; C₂ [K, D′] at 1/√D
    np.testing.assert_allclose(np.std(nx["hidden1_weights"]), 1 / np.sqrt(64), rtol=0.05)
    np.testing.assert_allclose(np.std(nx["NeXtVLAD_0"]["cluster_weights2"]), 1 / np.sqrt(1024), rtol=0.05)
    np.testing.assert_allclose(np.std(nx["NeXtVLAD_0"]["cluster_weights"]), 1 / np.sqrt(2048), rtol=0.05)
    fv = weights.init_variables_np(cfg, fcfg, seed=1, model_name="NetFVModelLF")["params"]
    np.testing.assert_allclose(np.std(fv["hidden1_weights"]), 1 / np.sqrt(16), rtol=0.05)
    np.testing.assert_allclose(np.std(fv["NetFV_0"]["covar_weights"]), 1 / np.sqrt(1024), rtol=0.05)
    rv = weights.init_variables_np(cfg, fcfg, seed=1, model_name="NetRVLADModelLF")["params"]
    assert "cluster_weights2" not in rv["NetRVLAD_0"]


def test_convert_checks_each_layout(flax_models):
    _, tree = flax_models["NetFVModelLF"]
    cfg = ModelConfig(**KW)
    with pytest.raises(ValueError, match="NetFV_0/cluster_weights"):
        weights.convert_flax_variables(tree, dataclasses.replace(cfg, fv_cluster_size=16), "NetFVModelLF")
    with pytest.raises(ValueError, match="NetVLAD_0"):
        weights.convert_flax_variables(tree, cfg, "NetVLADModelLF")
    _, tree = flax_models["NeXtVLADModel"]
    with pytest.raises(ValueError, match="NeXtVLAD_0/group_attention_weights"):
        weights.convert_flax_variables(tree, dataclasses.replace(cfg, nextvlad_groups=4), "NeXtVLADModel")


def test_dispatch_and_what_is_not_ported(flax_models):
    _, tree = flax_models["SoftDbofModelLF"]
    cfg = ModelConfig(**KW)
    tv = weights.convert_flax_variables(tree, cfg, "SoftDbofModelLF")
    fp = get_fast_path("SoftDbofModelLF").prepare(tv, cfg, device="cpu")
    assert fp["mods"][0]["w1"].dtype == torch.bfloat16 and len(fp["mods"]) == 2
    # --int8_hidden: the JAX dispatch's wording on the LF models without it
    with pytest.raises(ValueError, match="int8_hidden is only supported on the models with the giant"):
        get_fast_path("SoftDbofModelLF").prepare(tv, cfg, int8_hidden=True, device="cpu")
    with pytest.raises(ValueError, match="gating on"):
        fast_lf.prepare_fast_lf_params(tv, dataclasses.replace(cfg, gating=False), "SoftDbofModelLF",
                                       device="cpu")
    with pytest.raises(ValueError, match="unsupported fast-LF model"):
        fast_lf.build_fast_lf_inference(cfg, "LstmModel")


@pytest.mark.parametrize("model_name", LF)
def test_cli_top20_matches_jax_fast_path(flax_models, tmp_path, model_name):
    """The inference CLI on synthetic TFRecords of 1 to 12 frames: one row
    per video, and each row's top 20 the JAX fast path's (its plain route,
    as the JAX CLI runs off the TPU) on the frames drawn from
    fold_in(key(0), batch)."""
    _, tree = flax_models[model_name]
    weights.save_variables_npz(tree, str(tmp_path))
    data = str(tmp_path / "in-0.tfrecord")
    truth = tfix.write_frame_level_fixture(data, 7, num_classes=29, max_frames=F, seed=5)
    out = str(tmp_path / "out.csv")
    flags = [f"--{k}={v}" for k, v in KW.items()]
    n = inference.main([
        "--fast_infer", f"--model={model_name}", "--frame_features", "--feature_names=rgb,audio",
        "--feature_sizes=1024,128", f"--max_frames={F}", f"--input_data_pattern={data}",
        f"--train_dir={tmp_path}", f"--output_file={out}", "--batch_size=4", "--num_classes=29",
        "--device=cpu", *[f for f in flags if not f.startswith(("--vocab_size", "--iterations"))],
        f"--iterations={KW['iterations']}",
    ])
    assert n == len(truth) == 7
    jcfg = JModelConfig(**KW)
    jfp = jlf.prepare_fast_lf_params(tree, jcfg, model_name)
    fast = jlf.build_fast_lf_inference(jcfg, model_name, top_k=20, use_pallas=False)
    want = {}
    for i, batch in enumerate(j_batch_iterator(JReader(29, max_frames=F), data, 4)):
        vals, idx = fast(jfp, jnp.asarray(batch["features"]), jnp.asarray(batch["num_frames"]),
                         jax.random.fold_in(jax.random.key(0), i))
        rows = zip(batch["video_id"], batch["weights"] > 0, np.asarray(vals), np.asarray(idx))
        for vid, keep, v, ix in rows:
            if keep:
                want[vid.decode()] = (list(ix), v)
    with open(out) as f:
        rows = f.read().splitlines()
    assert rows[0] == "VideoId,LabelConfidencePairs" and len(rows) == 8
    for row in rows[1:]:
        vid, pairs = row.split(",")
        nums = pairs.split()
        ids, vals = [int(i) for i in nums[::2]], np.array([float(v) for v in nums[1::2]])
        assert ids == want[vid][0], vid
        # the same bf16 rounding points and f32 sums in another order: an
        # f32 descriptor entry on a bf16 rounding boundary may round the
        # other way (NetRVLAD: 1 of 8192 entries of one video, which moves
        # its probabilities by up to 1.1e-4)
        np.testing.assert_allclose(vals, want[vid][1], atol=1e-3)
