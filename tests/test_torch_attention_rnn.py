"""The attention family and the RNNs as nn.Modules ≡ the JAX package's flax
models on the CPU: TransformerEncoderModel, AttentionPoolingModel,
AttentionNetVLADModel, LstmModel and GruModel, forward with training off
and on (flax's dropout masks drawn from the same key) in f32 and bf16, at
num_frames 0, 1 and F; their trees (keys, shapes, dtypes under
--bf16_params) against model.init's; the LSTM's TF import against the JAX
importer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.core import checkpoint_import as jimport
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core import checkpoint_import as timport
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.models import create_model, list_models
from learnablepoolingmethods_torch.utils import prng

B, F, SIZES, V = 5, 9, (24, 8), 20
DT = sum(SIZES)
KW = dict(vocab_size=V, attention_hidden_size=16, attention_heads=2, transformer_ff_size=24,
          transformer_layers=2, attention_cluster_size=3, attention_dropout=0.25, netvlad_cluster_size=4,
          netvlad_hidden_size=12, lstm_cells=12, lstm_layers=2, gru_cells=12, gru_layers=2)
MODELS = ("TransformerEncoderModel", "AttentionPoolingModel", "AttentionNetVLADModel", "LstmModel", "GruModel")
FCFG = FeatureConfig(("rgb", "audio"), SIZES, True, F)


def _inputs(seed=3):
    """ℓ2-normalised frames [B, F, DT] and frame counts 0, 1, F and two more."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, F, DT)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return x, np.array([0, 1, F, 4, 7], np.int32)


def _tree(name, **overrides):
    return weights.init_variables_np(ModelConfig(**{**KW, **overrides}), FCFG, seed=1, model_name=name)


def _flax(name, tree, x, nf, training, dtype="float32", dropout_seed=None):
    """The flax model's predictions (and its updated BN statistics)."""
    model = jcreate(name, JModelConfig(**KW, compute_dtype=dtype))
    rngs = {} if dropout_seed is None else {"dropout": jax.random.key(dropout_seed)}
    variables = jax.tree.map(jnp.asarray, tree)
    out, _ = model.apply(variables, jnp.asarray(x), num_frames=jnp.asarray(nf), training=training,
                         rngs=rngs, mutable=["batch_stats"])
    return np.asarray(jnp.asarray(out["predictions"], jnp.float32))


def _port(name, tree, x, nf, training, dtype="float32", dropout_seed=None):
    model = weights.load_flax_variables(create_model(name, ModelConfig(**KW, compute_dtype=dtype), DT), tree)
    kwargs = {}
    if dropout_seed is not None and model.takes_dropout_key:
        kwargs["dropout_key"] = prng.key(dropout_seed)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(nf), training=training, **kwargs)
    return out["predictions"].float().numpy()


def test_registry_equals_the_jax_zoo():
    from learnablepoolingmethods_tpu.models import list_models as jax_models

    assert list_models() == sorted(jax_models())


@pytest.mark.parametrize("name", MODELS)
def test_tree_matches_flax_init(name):
    """init_variables_np has model.init's keys and shapes, every leaf f32;
    under --bf16_params create_model's parameters take flax's dtypes leaf
    for leaf (only the NetVLAD module, the tail and the head are bf16)."""
    x, nf = _inputs()
    for pdtype in ("float32", "bfloat16"):
        jmodel = jcreate(name, JModelConfig(**KW, param_dtype=pdtype))
        init = jmodel.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, jnp.asarray(x),
                           num_frames=jnp.asarray(nf), training=False)
        want = {p: (np.shape(v), np.dtype(v.dtype).name) for p, v in weights.tree_paths(
            {"params": init["params"], "batch_stats": init.get("batch_stats", {})}).items()}
        ours = weights.tree_paths(_tree(name))
        assert {p: s for p, (s, _) in want.items()} == {p: np.shape(v) for p, v in ours.items()}
        model = create_model(name, ModelConfig(**KW, param_dtype=pdtype), DT)
        got = {f"params/{n.replace('.', '/')}": str(p.dtype).removeprefix("torch.")
               for n, p in model.named_parameters()}
        got.update({f"batch_stats/{n.replace('.', '/')}": "float32" for n, _ in model.named_buffers()})
        assert got == {p: d for p, (_, d) in want.items()}


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_forward_matches_flax_f32(name, training):
    """f32 within 1e-5; in training the dropout masks from the key are
    flax's (dropout 0.25), so the predictions agree as closely."""
    x, nf = _inputs()
    tree = _tree(name)
    seed = 11 if training else None
    want = _flax(name, tree, x, nf, training, dropout_seed=seed)
    got = _port(name, tree, x, nf, training, dropout_seed=seed)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if training and name in ("TransformerEncoderModel", "AttentionNetVLADModel"):
        # the masks matter: another key gives other predictions
        assert np.abs(_port(name, tree, x, nf, training, dropout_seed=12) - want).max() > 1e-4


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_flax_bf16(name):
    """bf16 compute within 2e-2 (the two frameworks round at other places),
    in training with dropout."""
    x, nf = _inputs()
    tree = _tree(name)
    want = _flax(name, tree, x, nf, True, "bfloat16", dropout_seed=4)
    got = _port(name, tree, x, nf, True, "bfloat16", dropout_seed=4)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_rnn_reads_the_carry_flax_reads():
    """A video of no frames reads the carry after the last (padded) frame,
    as flax's _select_last_carry does at index −1; each other video the
    carry at its last valid frame, whatever follows."""
    x, nf = _inputs()
    for name in ("LstmModel", "GruModel"):
        tree = _tree(name)
        y = x.copy()
        y[3, 4:] = 0.0   # past video 3's 4 frames
        base = _port(name, tree, x, nf, False)
        moved = _port(name, tree, y, nf, False)
        np.testing.assert_array_equal(moved[3], base[3])
        full = _port(name, tree, x, np.full(B, F, np.int32), False)
        np.testing.assert_array_equal(base[0], full[0])


def test_lstm_import_matches_the_jax_importer():
    """A reference LSTM checkpoint (TF's fused [D+H, 4H] gates in (i, g, f,
    o) order, forget bias 1.0 folded into hf/bias) through both importers:
    the same tree within 1e-6, and back through the port's exporter."""
    mcfg = ModelConfig(**KW)
    tree = _tree("LstmModel")
    ref = jimport.export_reference_layout(tree["params"], tree["batch_stats"], V)
    assert any("basic_lstm_cell/kernel" in n for n in ref)
    want, _ = jimport.import_reference_checkpoint(
        ref, "LstmModel", JModelConfig(**KW), {"features": jnp.zeros((1, F, DT), jnp.uint8),
                                              "num_frames": jnp.ones((1,), jnp.int32)}, True)
    got, _ = timport.import_reference_checkpoint(ref, "LstmModel", mcfg, FCFG)
    want_paths, got_paths = weights.tree_paths(jax.tree.map(np.asarray, want)), weights.tree_paths(got)
    assert set(want_paths) == set(got_paths)
    for path, value in want_paths.items():
        np.testing.assert_allclose(got_paths[path], value, atol=1e-6, rtol=0, err_msg=path)
        np.testing.assert_allclose(got_paths[path], weights.tree_paths(tree["params"])[path], atol=1e-6)
    back = timport.export_reference_layout(got, {}, V)
    for name, value in ref.items():
        np.testing.assert_allclose(back[name], value, atol=1e-6, err_msg=name)


def test_convert_checks_the_layout():
    """convert_flax_variables reads all five and names a wrong shape or an
    extra layer."""
    mcfg = ModelConfig(**KW)
    for name in MODELS:
        weights.convert_flax_variables(_tree(name), mcfg, name)
    with pytest.raises(ValueError, match="more than 2 layers"):
        weights.convert_flax_variables(_tree("GruModel", gru_layers=3), mcfg, "GruModel")
    with pytest.raises(ValueError, match="attn_pool/queries"):
        weights.convert_flax_variables(_tree("AttentionPoolingModel"),
                                       dataclasses.replace(mcfg, attention_cluster_size=5),
                                       "AttentionPoolingModel")
