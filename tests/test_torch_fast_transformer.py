"""The port's transformer-family fast inference (ops/fast_transformer.py) ≡
the JAX package's on the CPU, at the small config of
tests/unit/test_fast_transformer.py (D=16, 2 heads, 2 layers, FF 24, V=20,
B=3, F=7): both fast paths in f32 against the JAX fast paths (the jnp
route and the Pallas kernels in interpret mode) and against flax's
model.apply, a bf16 run against the JAX plain route, init_variables_np
against flax's model.init, the weight checks, the inference CLI against
the JAX fast path, and the dispatch."""

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
from learnablepoolingmethods_tpu.ops import fast_transformer as jft
from learnablepoolingmethods_torch import inference
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.data import fixtures as tfix
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.ops import fast_transformer as ft
from learnablepoolingmethods_torch.ops.fast_dispatch import fast_path_models, get_fast_path

KW = dict(vocab_size=20, attention_hidden_size=16, attention_heads=2, transformer_layers=2,
          transformer_ff_size=24, moe_num_mixtures=2, netvlad_cluster_size=4, netvlad_hidden_size=16)
MODELS = ("TransformerEncoderModel", "AttentionNetVLADModel")
B, F, DT = 3, 7, 1152
JAX_FAST = {
    "TransformerEncoderModel": (jft.prepare_fast_transformer_params, jft.build_fast_transformer_inference),
    "AttentionNetVLADModel": (jft.prepare_fast_attn_netvlad_params, jft.build_fast_attn_netvlad_inference),
}
PORT_FAST = {
    "TransformerEncoderModel": (ft.prepare_fast_transformer_params, ft.build_fast_transformer_inference),
    "AttentionNetVLADModel": (ft.prepare_fast_attn_netvlad_params, ft.build_fast_attn_netvlad_inference),
}


def _frames(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(B, F, DT), dtype=np.uint8), np.array([F, 4, 1], np.int32)


@pytest.fixture(scope="module")
def flax_models():
    """Per model: (flax model, variables with every BN statistic moved off
    its initial value, as NumPy arrays), as tests/unit/test_fast_transformer.py
    makes them."""
    out = {}
    for name in MODELS:
        model = jcreate(name, JModelConfig(**KW))
        feats, nf = _frames(0)
        variables = model.init({"params": jax.random.key(0), "sampling": jax.random.key(1)},
                               jstep.preprocess_input(jnp.asarray(feats)), num_frames=jnp.asarray(nf),
                               training=True)
        stats = jax.tree.map(
            lambda a: a + 0.07 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape) / a.size,
            variables["batch_stats"])
        out[name] = (model, jax.tree.map(np.asarray, {"params": variables["params"], "batch_stats": stats}))
    return out


def _port(name, tree, dtype, use_kernels=True):
    cfg = ModelConfig(**KW)
    prepare, build = PORT_FAST[name]
    fp = prepare(weights.convert_flax_variables(tree, cfg, name), cfg, compute_dtype=dtype, device="cpu")
    return fp, build(cfg, use_kernels=use_kernels, compute_dtype=dtype, return_probs=True)


@pytest.mark.parametrize("model_name", MODELS)
def test_f32_matches_jax_fast_paths_and_flax(flax_models, model_name):
    model, tree = flax_models[model_name]
    feats, nf = _frames(1)
    jcfg = JModelConfig(**KW)
    prepare, build = JAX_FAST[model_name]
    jfp = prepare(tree, jcfg, compute_dtype=jnp.float32)
    fp, fn = _port(model_name, tree, torch.float32)
    got = fn(fp, torch.from_numpy(feats), torch.from_numpy(nf), None).numpy()
    for use_pallas in (False, True):
        want = build(jcfg, use_pallas=use_pallas, pallas_interpret=True, compute_dtype=jnp.float32,
                     return_probs=True)(jfp, jnp.asarray(feats), jnp.asarray(nf))
        # f32 throughout, sums in another order
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, err_msg=f"use_pallas={use_pallas}")
    want = model.apply(tree, jstep.preprocess_input(jnp.asarray(feats)), num_frames=jnp.asarray(nf),
                       training=False)["predictions"]
    # flax's softmax and LayerNorm differ in rounding (tests/unit/test_fast_transformer.py:62)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("model_name", MODELS)
def test_bf16_matches_jax_plain_route(flax_models, model_name):
    """bf16, the CLI's dtype: against the JAX plain route within the 3e-2 of
    tests/test_torch_lf_fast.py:106 (the same rounding points, f32 sums in
    another order); the kernel route (the CPU wrappers take the plain
    versions) bit for bit the plain route."""
    _, tree = flax_models[model_name]
    feats, nf = _frames(2)
    jcfg = JModelConfig(**KW)
    prepare, build = JAX_FAST[model_name]
    want = build(jcfg, use_pallas=False, return_probs=True)(prepare(tree, jcfg), jnp.asarray(feats),
                                                            jnp.asarray(nf))
    got = {}
    for use in (False, True):
        fp, fn = _port(model_name, tree, torch.bfloat16, use_kernels=use)
        got[use] = fn(fp, torch.from_numpy(feats), torch.from_numpy(nf), None)
    np.testing.assert_allclose(got[False].numpy(), np.asarray(want), atol=3e-2)
    torch.testing.assert_close(got[True], got[False], rtol=0, atol=0)


@pytest.mark.parametrize("model_name", MODELS)
def test_init_variables_np_matches_flax_init(model_name):
    model = jcreate(model_name, JModelConfig(**KW))
    want = jax.eval_shape(
        lambda x: model.init({"params": jax.random.key(0), "sampling": jax.random.key(1)}, x,
                             num_frames=jnp.full((2,), 6), training=True),
        jax.ShapeDtypeStruct((2, 6, DT), jnp.float32))
    want = {"params": want["params"], "batch_stats": want["batch_stats"]}
    got = weights.init_variables_np(ModelConfig(**KW), FeatureConfig(("rgb", "audio"), (1024, 128), True, 6),
                                    seed=0, model_name=model_name)

    def shapes(tree):
        return {jax.tree_util.keystr(p): tuple(np.shape(leaf))
                for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}

    assert shapes(got) == shapes(want)
    weights.convert_flax_variables(got, ModelConfig(**KW), model_name)
    # lecun-normal kernels at 1/√fan_in, zero Dense biases, LayerNorm scale 1
    p = got["params"]
    np.testing.assert_allclose(np.std(p["input_proj"]["kernel"]), 1 / np.sqrt(DT), rtol=0.05)
    layer = p["encoder"]["layer_1"]
    assert not layer["mha"]["out"]["bias"].any() and (layer["ln2"]["scale"] == 1).all()


def test_convert_checks_the_layout(flax_models):
    _, tree = flax_models["TransformerEncoderModel"]
    cfg = ModelConfig(**KW)
    with pytest.raises(ValueError, match="input_proj/kernel"):
        weights.convert_flax_variables(tree, dataclasses.replace(cfg, attention_hidden_size=32),
                                       "TransformerEncoderModel")
    with pytest.raises(ValueError, match="mha/query/kernel"):
        weights.convert_flax_variables(tree, dataclasses.replace(cfg, attention_heads=4),
                                       "TransformerEncoderModel")
    with pytest.raises(ValueError, match="more than --transformer_layers=1"):
        weights.convert_flax_variables(tree, dataclasses.replace(cfg, transformer_layers=1),
                                       "TransformerEncoderModel")
    with pytest.raises(ValueError, match="ff1/kernel"):
        weights.convert_flax_variables(tree, dataclasses.replace(cfg, transformer_ff_size=32),
                                       "TransformerEncoderModel")
    _, tree = flax_models["AttentionNetVLADModel"]
    with pytest.raises(ValueError, match="vlad/cluster_weights"):
        weights.convert_flax_variables(tree, dataclasses.replace(cfg, netvlad_cluster_size=8),
                                       "AttentionNetVLADModel")
    with pytest.raises(ValueError, match="vlad"):
        weights.convert_flax_variables(flax_models["TransformerEncoderModel"][1], cfg, "AttentionNetVLADModel")


def test_dispatch_and_what_is_not_ported(flax_models):
    assert set(MODELS) <= set(fast_path_models())
    cfg = ModelConfig(**KW)
    _, tree = flax_models["AttentionNetVLADModel"]
    tv = weights.convert_flax_variables(tree, cfg, "AttentionNetVLADModel")
    fp = get_fast_path("AttentionNetVLADModel").prepare(tv, cfg, device="cpu")
    assert fp["hidden_w"].shape == (16 * 4, 16) and fp["hidden_w"].dtype == torch.bfloat16
    assert fp["layers"][0]["wqkv"].shape == (16, 48)
    # --int8_hidden: AttentionNetVLAD's D·K hidden FC in int8 (its tests in
    # test_torch_int8_matmul.py), the transformer refused in JAX's wording
    fp8 = get_fast_path("AttentionNetVLADModel").prepare(tv, cfg, int8_hidden=True, device="cpu")
    # (the [K, N] = [16·4, 16] weight in the kernel's layout: N rows of one 64-deep block)
    assert fp8["hidden_w"]["q"].dtype == torch.int8 and fp8["hidden_w"]["q"].shape == (16, 1, 64)
    with pytest.raises(ValueError, match="int8_hidden is only supported on the models with the giant"):
        get_fast_path("TransformerEncoderModel").prepare(tv, cfg, int8_hidden=True, device="cpu")
    with pytest.raises(ValueError, match="relu off"):
        ft.prepare_fast_attn_netvlad_params(tv, dataclasses.replace(cfg, netvlad_relu=True), device="cpu")
    # the JAX package has no fast path for AttentionPoolingModel either
    with pytest.raises(ValueError, match="--fast_infer supports .*AttentionPoolingModel"):
        get_fast_path("AttentionPoolingModel")
    # the family's nn.Modules (the model-forward route and training) are
    # ported (item 10b; tests/test_torch_attention_rnn.py)
    for name in MODELS + ("AttentionPoolingModel",):
        assert create_model(name, cfg, DT).input_proj.kernel.shape == (DT, cfg.attention_hidden_size)


@pytest.mark.parametrize("model_name", MODELS)
def test_cli_top20_matches_jax_fast_path(flax_models, tmp_path, model_name):
    """The inference CLI on synthetic TFRecords of 1 to 7 frames in batches
    of 4 (the second batch carries a padding row with num_frames 0): one row
    per video, and each row's top 20 the JAX fast path's (its plain route,
    as the JAX CLI runs off the TPU)."""
    _, tree = flax_models[model_name]
    weights.save_variables_npz(tree, str(tmp_path))
    data = str(tmp_path / "in-0.tfrecord")
    truth = tfix.write_frame_level_fixture(data, 7, num_classes=20, max_frames=F, seed=5)
    out = str(tmp_path / "out.csv")
    n = inference.main([
        "--fast_infer", f"--model={model_name}", "--frame_features", "--feature_names=rgb,audio",
        "--feature_sizes=1024,128", f"--max_frames={F}", f"--input_data_pattern={data}",
        f"--train_dir={tmp_path}", f"--output_file={out}", "--batch_size=4", "--num_classes=20",
        "--device=cpu", "--attention_dropout=0.3",
        *[f"--{k}={v}" for k, v in KW.items() if k != "vocab_size"],
    ])
    assert n == len(truth) == 7
    jcfg = JModelConfig(**KW)
    prepare, build = JAX_FAST[model_name]
    jfp = prepare(tree, jcfg)
    fast = build(jcfg, top_k=20, use_pallas=False)
    want = {}
    for batch in j_batch_iterator(JReader(20, max_frames=F), data, 4):
        vals, idx = fast(jfp, jnp.asarray(batch["features"]), jnp.asarray(batch["num_frames"]))
        for vid, keep, v, ix in zip(batch["video_id"], batch["weights"] > 0, np.asarray(vals), np.asarray(idx)):
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
        # the same bf16 rounding points, f32 sums in another order
        np.testing.assert_allclose(vals, want[vid][1], atol=1e-3)
