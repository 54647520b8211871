"""``--int8_hidden``: the port's weight-only int8 hidden FC
(``ops/int8_matmul.py``; the W8A16 CUDA kernel's plain version on the CPU)
≡ the JAX package's ``ops/int8_matmul.py`` and its int8 fast paths.

- ``quantize_weight_int8`` bit for bit (``rint``, the clip to ±127, the
  scale 1 of a zero column);
- ``matmul_wi8`` at 1e-5 relative;
- the int8 fast paths of NetVLADModelLF, NetFVModelLF, NetRVLADModelLF and
  AttentionNetVLADModel against JAX's, prepared from the same weights and
  run on the same presampled frames (f32 compute, so the int8 FC is the one
  bf16 rounding of each: 1e-4 in probability);
- the refusals in JAX's wording: the dispatch on every other model, the
  inference CLI without ``--fast_infer``, the eval CLI without
  ``--fast_forward``; ``int8_capable_models`` pinned to the registry.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.ops import fast_dispatch as jdispatch
from learnablepoolingmethods_tpu.ops import fast_infer as jfi
from learnablepoolingmethods_tpu.ops import fast_lf as jlf
from learnablepoolingmethods_tpu.ops import fast_transformer as jft
from learnablepoolingmethods_tpu.ops import int8_matmul as jq
from learnablepoolingmethods_torch import eval as teval
from learnablepoolingmethods_torch import inference
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.ops import fast_dispatch, fast_infer, fast_lf, fast_transformer
from learnablepoolingmethods_torch.ops import int8_matmul as tq

KW = dict(vocab_size=20, iterations=6, netvlad_cluster_size=8, netvlad_hidden_size=16, rvlad_cluster_size=8,
          fv_cluster_size=4, fv_hidden_size=16, attention_hidden_size=16, attention_heads=2,
          transformer_layers=1, transformer_ff_size=24)
B, S = 3, 6


def test_quantizer_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(96, 24)).astype(np.float32)
    w[:, 3] = 0.0                                    # a zero column: scale 1, all zeros
    w[5, 7] = np.float32(2.5) * np.abs(w[:, 7]).max()  # one dominant entry: the clip at ±127
    w[:, 9] = np.float32(0.5) * np.arange(96) / 95   # half-way values: rint rounds half to even
    for src in (w, jnp.asarray(w, jnp.bfloat16)):
        want_q, want_s = jq.quantize_weight_int8(src)
        got_q, got_s = tq.quantize_weight_int8(np.asarray(src))
        np.testing.assert_array_equal(got_q, want_q)
        np.testing.assert_array_equal(got_s, want_s)
    got_q, got_s = tq.quantize_weight_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(got_q, jq.quantize_weight_int8(w)[0])
    assert got_s[3] == 0.0 and not got_q[:, 3].any() and np.abs(got_q).max() == 127


def test_tensor_quantizer_equals_the_host_quantizer():
    """quantize_int8_tensor (torch, on the weight's device) gives the host
    quantizer's bits, and int8_weight lays them out as device_weight does."""
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(4112, 40)) * 3.0).astype(np.float32)
    w[:, 3] = 0.0
    w[5, 7] = np.float32(2.5) * np.abs(w[:, 7]).max()
    w[:, 9] = np.float32(0.5) * np.arange(4112) / 4111
    for src in (w, torch.from_numpy(w).to(torch.bfloat16)):
        want_q, want_s = tq.quantize_weight_int8(src)
        got_q, got_s = tq.quantize_int8_tensor(src if isinstance(src, torch.Tensor) else torch.from_numpy(src))
        np.testing.assert_array_equal(got_q.numpy(), want_q)
        np.testing.assert_array_equal(got_s.numpy().view(np.int32), want_s.view(np.int32))
        got = fast_infer.int8_weight(src, "cpu")
        want = tq.device_weight(want_q, "cpu")
        assert got["q"].stride() == want.stride() and torch.equal(got["q"], want)
        np.testing.assert_array_equal(got["s"].numpy(), want_s)


def test_matmul_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(4112, 40)).astype(np.float32)
    q, s = jq.quantize_weight_int8(w)
    x = rng.normal(size=(5, 4112)).astype(np.float32)
    want = np.asarray(jq.matmul_wi8(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s)))
    got = tq.matmul_wi8(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the kernel's layout holds the same [K, N] matrix: n-major, K padded
    # with zeros to 65 blocks of 64, byte p of a block holding k K_ORDER[p]
    view = tq.device_weight(q, "cpu")
    assert view.shape == (40, 65, 64) and view.is_contiguous()
    assert sorted(tq.K_ORDER.tolist()) == list(range(64))
    blocks = np.zeros((65 * 64, 40), np.int8)
    blocks[:4112] = q
    np.testing.assert_array_equal(view.numpy(), blocks.T.reshape(40, 65, 64)[:, :, tq.K_ORDER])
    np.testing.assert_array_equal(tq.logical_weight(view, 4112).numpy(), q)
    np.testing.assert_array_equal(tq.matmul_wi8(torch.from_numpy(x), view, torch.from_numpy(s)).numpy(), got)
    bias = rng.normal(size=40).astype(np.float32)
    np.testing.assert_allclose(
        tq.matmul_wi8(torch.from_numpy(x), view, torch.from_numpy(s), torch.from_numpy(bias)).numpy(),
        got + bias, rtol=1e-6, atol=1e-6)


def test_kernel_geometry_covers_k():
    """int8_geometry's splits cover every K step once, with no empty split,
    in one wave of blocks; the batch tile is the least that holds B."""
    for m, n, k in ((1, 1024, 262144), (32, 1024, 262144), (512, 1024, 262144), (512, 1024, 16384),
                    (37, 200, 4112), (256, 1024, 131072), (1, 1024, 64)):
        geo = tq.int8_geometry(m, n, k)
        assert (geo["splits"] - 1) * geo["kb_per_split"] < geo["k_steps"] <= geo["splits"] * geo["kb_per_split"]
        assert geo["k_steps"] == -(-k // tq.TILE_K)
        assert geo["tiles"] == -(-m // geo["batch_tile"]) * -(-n // tq.TILE_N)
        assert geo["tiles"] * geo["splits"] <= tq.H100_SMS
    assert [tq.batch_tile(m) for m in (1, 8, 9, 32, 37, 64, 65, 256, 512)] == [8, 8, 16, 32, 64, 64, 128, 128, 128]


def _variables(model_name, mcfg):
    """init_variables_np's tree at the JAX layout, BN statistics moved off
    their initial values (folding must show)."""
    fcfg = FeatureConfig(("rgb", "audio"), (1024, 128), True, 300)
    tree = weights.init_variables_np(mcfg, fcfg, seed=3, model_name=model_name)
    rng = np.random.default_rng(4)
    stats = jax.tree.map(lambda s: s + 0.05 * np.abs(rng.normal(size=s.shape)).astype(np.float32),
                         tree["batch_stats"])
    return {"params": tree["params"], "batch_stats": stats}


# model → (JAX prepare, JAX build, port prepare, port build); each takes
# (variables, mcfg, f32, int8) / (mcfg, f32)
PATHS = {
    "NetVLADModelLF": (
        lambda v, c: jfi.prepare_fast_params(v, c, compute_dtype=jnp.float32, int8_hidden=True),
        lambda c: jfi.build_fast_netvlad_inference(c, use_pallas=False, compute_dtype=jnp.float32, return_probs=True),
        lambda v, c: fast_infer.prepare_fast_params(v, c, compute_dtype=torch.float32, int8_hidden=True, device="cpu"),
        lambda c: fast_infer.build_fast_netvlad_inference(c, compute_dtype=torch.float32, return_probs=True)),
    "AttentionNetVLADModel": (
        lambda v, c: jft.prepare_fast_attn_netvlad_params(v, c, compute_dtype=jnp.float32, int8_hidden=True),
        lambda c: jft.build_fast_attn_netvlad_inference(c, use_pallas=False, compute_dtype=jnp.float32,
                                                        return_probs=True),
        lambda v, c: fast_transformer.prepare_fast_attn_netvlad_params(v, c, compute_dtype=torch.float32,
                                                                       int8_hidden=True, device="cpu"),
        lambda c: fast_transformer.build_fast_attn_netvlad_inference(c, compute_dtype=torch.float32,
                                                                     return_probs=True)),
    **{name: (
        lambda v, c, n=name: jlf.prepare_fast_lf_params(v, c, n, compute_dtype=jnp.float32, int8_hidden=True),
        lambda c, n=name: jlf.build_fast_lf_inference(c, n, use_pallas=False, compute_dtype=jnp.float32,
                                                      return_probs=True),
        lambda v, c, n=name: fast_lf.prepare_fast_lf_params(v, c, n, compute_dtype=torch.float32, int8_hidden=True,
                                                            device="cpu"),
        lambda c, n=name: fast_lf.build_fast_lf_inference(c, n, compute_dtype=torch.float32, return_probs=True))
       for name in ("NetFVModelLF", "NetRVLADModelLF")},
}


@pytest.mark.parametrize("model_name", sorted(PATHS))
def test_int8_fast_path_matches_jax(model_name):
    jprep, jbuild, tprep, tbuild = PATHS[model_name]
    attention = model_name == "AttentionNetVLADModel"
    mcfg = ModelConfig(**KW, presampled=True)
    tree = _variables(model_name, mcfg)
    rng = np.random.default_rng(5)
    f = 7 if attention else S
    feats = rng.integers(0, 256, size=(B, f, 1152), dtype=np.uint8)
    nf = np.array([f, 4, 1], np.int32)
    want = jbuild(JModelConfig(**KW, presampled=True))(jprep(jax.tree.map(jnp.asarray, tree),
                                                             JModelConfig(**KW, presampled=True)),
                                                       jnp.asarray(feats), jnp.asarray(nf), jax.random.key(0),
                                                       **({} if attention else {"presampled": True}))
    tv = weights.convert_flax_variables(tree, mcfg, model_name)
    fp = tprep(tv, mcfg)
    hidden = fp["hidden_w"] if attention else (fp["w_rgb"] if model_name == "NetVLADModelLF" else fp["mods"][0]["w1"])
    assert hidden["q"].dtype == torch.int8 and hidden["s"].dtype == torch.float32
    got = tbuild(mcfg)(fp, torch.from_numpy(feats), torch.from_numpy(nf), None,
                       **({} if attention else {"presampled": True}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _jax_message(model_name):
    with pytest.raises(ValueError) as err:
        jdispatch._reject_int8(model_name, True)
    return str(err.value)


@pytest.mark.parametrize("model_name", ["DbofModel", "SoftDbofModelLF", "NeXtVLADModel",
                                        "TransformerEncoderModel"])
def test_other_models_refuse_int8_in_jax_wording(model_name):
    with pytest.raises(ValueError) as err:
        fast_dispatch.get_fast_path(model_name).prepare({}, ModelConfig(**KW), int8_hidden=True, device="cpu")
    assert str(err.value) == _jax_message(model_name)


def test_int8_capable_models_pinned_to_the_registry():
    """As the JAX package's test_fast_dispatch pins it: the static list
    equals JAX's and the registry's supports_int8."""
    assert fast_dispatch.int8_capable_models() == jdispatch.int8_capable_models()
    capable = {name for name in fast_dispatch.fast_path_models()
               if fast_dispatch.get_fast_path(name).supports_int8}
    assert capable == set(fast_dispatch.int8_capable_models())
    with pytest.raises(ValueError, match="int8_hidden is not supported on SoftDbofModelLF"):
        fast_lf.prepare_fast_lf_params({}, ModelConfig(**KW), "SoftDbofModelLF", int8_hidden=True, device="cpu")


def test_clis_refuse_int8_without_their_fast_route(tmp_path):
    flags = ["--frame_features", "--feature_names=rgb,audio", "--feature_sizes=1024,128", "--device=cpu",
             f"--train_dir={tmp_path}", "--int8_hidden"]
    capable = fast_dispatch.int8_capable_models()
    with pytest.raises(ValueError, match=re.escape(f"--int8_hidden requires --fast_infer with one of {capable}")):
        inference.main(flags + ["--model=NetVLADModelLF", f"--output_file={tmp_path}/o.csv",
                                f"--input_data_pattern={tmp_path}/*.tfrecord"])
    with pytest.raises(ValueError, match="--int8_hidden requires --fast_infer"):
        inference.main(flags + ["--model=DbofModel", "--fast_infer", f"--output_file={tmp_path}/o.csv",
                                f"--input_data_pattern={tmp_path}/*.tfrecord"])
    with pytest.raises(ValueError, match="--int8_hidden requires --fast_forward"):
        teval.main(flags + ["--model=NetFVModelLF", f"--eval_data_pattern={tmp_path}/*.tfrecord", "--run_once"])
