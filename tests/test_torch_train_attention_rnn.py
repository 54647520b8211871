"""Training of the attention family and the RNNs ≡ the JAX package's on the
CPU: three steps of the jitted make_train_step against the port's TrainStep
from the same variables, batches and seed, for TransformerEncoderModel,
AttentionPoolingModel, AttentionNetVLADModel, LstmModel and GruModel, the
transformers with flax's dropout (rate 0.25, the masks drawn from the
step's dropout key); and on TransformerEncoderModel --grad_accum_steps=2
(microbatch i drops from fold_in(dropout_key, i)), --use_remat (the
recompute draws the same masks) and --bf16_params (f32 encoder, bf16 tail
and head, the f32 master).  Losses, the step-1 gradient and the variables
after three steps at 1e-5."""

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
from learnablepoolingmethods_torch import losses
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.core.checkpoints import dtype_name
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.utils import prng

B, F, SIZES, V = 6, 10, (24, 8), 20
MODEL_KW = dict(vocab_size=V, attention_hidden_size=16, attention_heads=2, transformer_ff_size=24,
                transformer_layers=2, attention_cluster_size=3, attention_dropout=0.25, netvlad_cluster_size=4,
                netvlad_hidden_size=12, lstm_cells=12, lstm_layers=2, gru_cells=12, gru_layers=2)
# lr 1e-4: an entry whose gradient is rounding noise moves by ±lr in
# either package (tests/test_torch_train_zoo.py)
TRAIN_KW = dict(batch_size=B, base_learning_rate=1e-4, learning_rate_decay_examples=12)
LR = TRAIN_KW["base_learning_rate"]
# case → (model, ModelConfig overrides, TrainingConfig overrides)
CASES = {
    "TransformerEncoderModel": ("TransformerEncoderModel", {}, {}),
    "AttentionPoolingModel": ("AttentionPoolingModel", {}, {}),
    "AttentionNetVLADModel": ("AttentionNetVLADModel", {}, {}),
    "LstmModel": ("LstmModel", {}, {}),
    "GruModel": ("GruModel", {}, {}),
    "TransformerEncoderModel-accum2": ("TransformerEncoderModel", {}, {"grad_accum_steps": 2}),
    "TransformerEncoderModel-remat": ("TransformerEncoderModel", {}, {"use_remat": True}),
    "TransformerEncoderModel-bf16_params": ("TransformerEncoderModel", {"param_dtype": "bfloat16"},
                                            {"fp32_master": True}),
}


def _batches(n=3):
    """uint8 frames with 0 to F valid (a video of none included), one
    padding row a batch."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        nf = rng.integers(1, F + 1, size=B).astype(np.int32)
        nf[1] = 0
        out.append({"features": rng.integers(0, 256, size=(B, F, sum(SIZES)), dtype=np.uint8),
                    "num_frames": nf, "labels": (rng.random((B, V)) < 0.2).astype(np.float32),
                    "weights": np.r_[np.ones(B - 1), 0].astype(np.float32)})
    return out


def _keep_gradient():
    """An optax transform that passes the gradient on and keeps it as its
    state, so the jitted step hands back the gradient it computed."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


def _f32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _bf16_step(x):
    """One bf16 step at |x|."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _init(model_name, moverrides):
    """init_variables_np(seed=0) in flax's dtypes (bf16 where flax gives
    param_dtype, under --bf16_params), as both packages start."""
    mcfg = ModelConfig(**MODEL_KW, **moverrides)
    tree = weights.init_variables_np(mcfg, FeatureConfig(("rgb", "audio"), SIZES, True, F), seed=0,
                                     model_name=model_name)
    model = create_model(model_name, mcfg, sum(SIZES))
    dtypes = {n.replace(".", "/"): p.dtype for n, p in model.named_parameters()}
    params = {p: (v.astype(jnp.bfloat16) if dtypes[p] == torch.bfloat16 else v)
              for p, v in weights.tree_paths(tree["params"]).items()}
    return {"params": weights.unflatten_tree(params), "batch_stats": tree["batch_stats"]}


def _run(case):
    model_name, moverrides, toverrides = CASES[case]
    batches = _batches()
    init = _init(model_name, moverrides)

    jmcfg = JModelConfig(**MODEL_KW, **moverrides)
    jtcfg = JTrainingConfig(**TRAIN_KW, **toverrides)
    state = JTrainState.create(jax.tree.map(jnp.asarray, init["params"]),
                               jax.tree.map(jnp.asarray, init["batch_stats"]),
                               optax.chain(_keep_gradient(), jopt.create_optimizer(jtcfg)))
    step = jax.jit(jstep.make_train_step(jcreate(model_name, jmcfg), jlosses.CrossEntropyLoss(), jtcfg, jmcfg,
                                         True))
    jloss, jgrad = [], None
    for b in batches:
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(7))
        jloss.append(float(metrics["loss"]))
        jgrad = jgrad if jgrad is not None else weights.tree_paths(jax.tree.map(np.asarray, state.opt_state[0]))
    tree = jckpt.state_to_tree(state)
    want_tree = weights.tree_paths(jax.tree.map(np.asarray, {**tree, "opt_state": tree["opt_state"][1]}))

    mcfg = ModelConfig(**MODEL_KW, **moverrides)
    tcfg = TrainingConfig(**TRAIN_KW, **toverrides)
    model = weights.load_flax_variables(create_model(model_name, mcfg, sum(SIZES)), init)
    pstate = TrainState.create(model, tcfg)
    pstep = tstep.TrainStep(losses.CrossEntropyLoss(), tcfg, mcfg, True)
    ploss, pgrad = [], None
    for b in batches:
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        if pstep.accum == 1:
            total = pstep.loss(pstate, tb, prng.key(7))[0]
            grads = tstep.gradients(total, model)
        else:
            grads, total = pstep.accumulated(pstate, tb, prng.key(7))[:2]
        if pgrad is None:
            pgrad = {n.replace(".", "/"): g for (n, _), g in zip(model.named_parameters(), grads)}
        pstate.apply_gradients(grads)
        ploss.append(float(total.detach()))
    assert pstate.step == 3
    return ({"loss": jloss, "grad0": jgrad, "tree": want_tree},
            {"loss": ploss, "grad0": pgrad, "tree": pstate.state_tree()})


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run(case)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_jax(runs, case):
    """The same dropout masks (bit for bit) and f32 sums in another order."""
    want, got = runs(case)
    assert np.isfinite(got["loss"]).all()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_step1_gradient_matches_jax(runs, case):
    """Each gradient in JAX's dtype, within 1e-5·max + 1e-5 (and two bf16
    steps for a bf16 gradient)."""
    want, got = runs(case)
    assert set(got["grad0"]) == set(want["grad0"])
    for name, w in want["grad0"].items():
        assert dtype_name(got["grad0"][name]) == str(w.dtype), name
        g, w32 = _f32(got["grad0"][name]), _f32(w)
        slack = 2 * _bf16_step(w32).max() if str(w.dtype) == "bfloat16" else 0.0
        assert np.abs(g - w32).max() <= 1e-5 * np.abs(w32).max() + 1e-5 + slack, name


@pytest.mark.parametrize("case", list(CASES))
def test_state_after_three_steps_matches_jax(runs, case):
    """The state's leaves under JAX's state_to_tree names and dtypes; the
    f32 parameters (the master under --bf16_params), BN statistics and
    Adam moments at 1e-5, an entry whose step-1 gradient is rounding noise
    held to 2·lr a step; a bf16 parameter within one bf16 step."""
    want, got = runs(case)
    assert set(got["tree"]) == set(want["tree"])
    grad0 = {n: _f32(g) for n, g in want["grad0"].items()}
    noise = 1e-6 * max(np.abs(g).max() for g in grad0.values())
    for name, w in want["tree"].items():
        assert dtype_name(got["tree"][name]) == str(w.dtype), name
        g, w32 = _f32(got["tree"][name]), _f32(w)
        leaf = name.split("params/", 1)[-1] if name.startswith("params/") else name.split("master/", 1)[-1]
        if str(w.dtype) == "bfloat16":
            assert np.all(np.abs(g - w32) <= _bf16_step(w32)), name
        elif name.startswith(("params/", "opt_state/master/")):
            exempt = np.abs(grad0[leaf]) < noise
            tol = 1e-5 * np.abs(w32).max() + 1e-5
            assert np.abs(np.where(exempt, w32, g) - w32).max() <= tol, name
            assert np.abs(g - w32)[exempt].max(initial=0) <= 3 * 2 * LR, name
        elif name.startswith("batch_stats/") or name.endswith("count") or name == "step":
            np.testing.assert_allclose(g, w32, rtol=1e-5, atol=1e-5, err_msg=name)
