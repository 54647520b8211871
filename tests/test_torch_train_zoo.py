"""Training of every served model but NetVLADModelLF ≡ the JAX package's on
the CPU: three steps of the jitted make_train_step against the port's
TrainStep from the same variables, batches and seed, with and without
--presample_frames, for NetRVLADModelLF (plain, and fused through the
training kernels' plain versions at zero C₂ against the Pallas kernels in
interpret mode), NetFVModelLF (also --fv_couple_weights), SoftDbofModelLF,
NeXtVLADModel, DbofModel (BN on and off, max and average pooling),
FrameLevelLogisticModel, and LogisticModel and MoeModel on video-level
input; --netvlad_dimred; then the train CLI end to end for each model,
its checkpoint read back by the port's eval CLI."""

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
from learnablepoolingmethods_tpu.core import optimizers as jopt
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.core.train_state import TrainState as JTrainState
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_tpu.ops import netvlad_train as jnetvlad_train
from learnablepoolingmethods_torch import eval as eval_cli
from learnablepoolingmethods_torch import inference, losses, train
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core import weights
from learnablepoolingmethods_torch.core.checkpoints import CheckpointManager
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.data import fixtures
from learnablepoolingmethods_torch.data.pipeline import batch_iterator
from learnablepoolingmethods_torch.data.readers import make_reader
from learnablepoolingmethods_torch.models import create_model, find_class_by_name
from learnablepoolingmethods_torch.utils import prng

B, F, SIZES, V = 6, 10, (1024, 16), 20
MODEL_KW = dict(vocab_size=V, iterations=4, netvlad_cluster_size=8, netvlad_hidden_size=32,
                rvlad_cluster_size=8, fv_cluster_size=4, fv_hidden_size=32, dbow_cluster_size=16,
                nextvlad_cluster_size=4, nextvlad_hidden_size=32, dbof_cluster_size=32,
                dbof_hidden_size=32)
# Adam's first update is ±lr for any entry whose gradient exceeds its ε of
# 1e-8, so an entry whose gradient is f32 rounding noise (input_bn's bias
# ahead of a projection and a BN has a zero gradient analytically) moves by
# ±lr at random in either package, and its neighbours follow; at lr 1e-4
# that stays below what the losses and the other entries show at 1e-5
TRAIN_KW = dict(batch_size=B, base_learning_rate=1e-4, learning_rate_decay_examples=12)
LR = TRAIN_KW["base_learning_rate"]
VIDEO_LEVEL = ("LogisticModel", "MoeModel")


def _floor_magnitude(name):
    """|w| >= 1e-2, sign kept, for NetFV's ``name`` weights: σ² = w² + 1e-6
    then stays >= 1e-4.  At σ² near its 1e-6 floor the reference's f32
    gradient on the CPU loses whole terms (test_netfv_gradient_near_the_
    variance_floor_matches_float64), so parity is held away from it."""

    def floor(params):
        for mod in [m for m in params if m.startswith("NetFV_")]:
            w = np.asarray(params[mod][name])
            params[mod][name] = np.where(w < 0, -1.0, 1.0).astype(np.float32) * np.maximum(np.abs(w), 1e-2)
        return params

    return floor


def _unsaturate_nextvlad(params):
    """The hidden FC's initial weights ÷ 16.  NeXtVLAD's vlad_bn hands the
    hidden FC unit-scale inputs, so at flax's init the MoE's sigmoids round
    to 0 or 1 in f32, where log(1 − p + 1e-5) of the loss is accurate to
    about 1e-2 in either package; scaled down, the predictions leave that
    regime."""
    params["hidden1_weights"] = np.asarray(params["hidden1_weights"]) / np.float32(16)
    return params


# case → (model, ModelConfig overrides, change to the initial parameters)
CASES = {
    "NetRVLADModelLF": ("NetRVLADModelLF", {}, None),
    "NetRVLADModelLF-fused": ("NetRVLADModelLF", {"fused_train_aggregation": True}, None),
    "NetFVModelLF": ("NetFVModelLF", {}, _floor_magnitude("covar_weights")),
    "NetFVModelLF-coupled": ("NetFVModelLF", {"fv_couple_weights": True, "fv_coupling_factor": 1.0},
                             _floor_magnitude("cluster_weights")),
    "SoftDbofModelLF": ("SoftDbofModelLF", {}, None),
    "NeXtVLADModel": ("NeXtVLADModel", {}, _unsaturate_nextvlad),
    "DbofModel-max-bn": ("DbofModel", {}, None),
    "DbofModel-max-nobn": ("DbofModel", {"dbof_add_batch_norm": False}, None),
    "DbofModel-average-bn": ("DbofModel", {"dbof_pooling_method": "average"}, None),
    "DbofModel-average-nobn": ("DbofModel", {"dbof_pooling_method": "average", "dbof_add_batch_norm": False},
                               None),
    "FrameLevelLogisticModel": ("FrameLevelLogisticModel", {}, None),
    "LogisticModel": ("LogisticModel", {}, None),
    "MoeModel": ("MoeModel", {}, None),
    # --netvlad_dimred: one module of r=64 columns, or rgb only at r=200
    "NetVLADModelLF-dimred64": ("NetVLADModelLF", {"netvlad_dimred": 64}, None),
    "NetVLADModelLF-dimred200": ("NetVLADModelLF", {"netvlad_dimred": 200}, None),
    "NetRVLADModelLF-dimred64": ("NetRVLADModelLF", {"netvlad_dimred": 64}, None),
    "NetRVLADModelLF-dimred200": ("NetRVLADModelLF", {"netvlad_dimred": 200}, None),
}
# every model of the zoo's training with and without --presample_frames;
# the dimred cases at the CLI's default (without)
RUNS = [(case, presample) for case in CASES for presample in (False, True)
        if "dimred" not in case or not presample]
RUN_IDS = [f"{case}-{'presample' if p else 'in_model'}" for case, p in RUNS]


def _batches(frame_features: bool, n=3):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        if frame_features:
            batch = {"features": rng.integers(0, 256, size=(B, F, sum(SIZES)), dtype=np.uint8),
                     "num_frames": rng.integers(1, F + 1, size=B).astype(np.int32)}
        else:
            batch = {"features": rng.normal(size=(B, sum(SIZES))).astype(np.float32)}
        batch["labels"] = (rng.random((B, V)) < 0.2).astype(np.float32)
        batch["weights"] = np.r_[np.ones(B - 1), 0].astype(np.float32)  # one padding row
        out.append(batch)
    return out


def _keep_gradient():
    """An optax transform that passes the gradient on unchanged and keeps it
    as its state, so the jitted step hands back the gradient it computed."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


def _interpret_aggregate(orig=jnetvlad_train.netvlad_aggregate):
    """The JAX training kernels in Pallas interpret mode, as the JAX
    package's own tests run them on the CPU."""
    return lambda x, logits, c2, interpret=False: orig(x, logits, c2, True)


def _init_variables(model_name, overrides, tweak, frame_features: bool):
    """The port's core/weights.py#init_variables_np(seed=0) of the model
    (flax's tree, test_dimred_tree_and_forward_match_flax and the weights
    tests hold its keys and shapes), changed by ``tweak``: a tree of NumPy
    arrays that both packages start from.  The parameters do not depend on
    how the model samples, so one tree serves both runs of a case."""
    fcfg = FeatureConfig(("rgb", "audio") if frame_features else ("mean_rgb", "mean_audio"), SIZES,
                         frame_features, F)
    tree = weights.init_variables_np(ModelConfig(**MODEL_KW, **overrides), fcfg, seed=0, model_name=model_name)
    tree = {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}
    if tweak is not None:
        tree["params"] = tweak(tree["params"])
    return tree


def _flax_variables(model_name, overrides, batch):
    """core/step.py#init_model_variables(seed=0) of the frame-level model,
    jitted (one compile instead of an eager dispatch of every op): a tree of
    NumPy arrays."""
    model = jcreate(model_name, JModelConfig(**MODEL_KW, **overrides))
    key = jax.random.key(0)
    init = jax.jit(lambda x, nf: model.init({"params": key, "sampling": key, "dropout": key}, x,
                                            num_frames=nf, training=True))
    with mock.patch.object(jnetvlad_train, "netvlad_aggregate", _interpret_aggregate()):
        variables = init(jstep.preprocess_input(jnp.asarray(batch["features"])), jnp.asarray(batch["num_frames"]))
    return jax.tree.map(np.asarray, {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})})


def _jax_run(model_name, overrides, presample, batches, frame_features, init):
    """Three jitted JAX train steps from ``init``: the losses, the step-1
    gradient and the final variables."""
    mcfg = JModelConfig(**MODEL_KW, **overrides, presampled=presample)
    tcfg = JTrainingConfig(**TRAIN_KW, presample_frames=presample)
    model = jcreate(model_name, mcfg)
    loss, grad0 = [], None
    with mock.patch.object(jnetvlad_train, "netvlad_aggregate", _interpret_aggregate()):
        params, stats = (jax.tree.map(jnp.asarray, init[c]) for c in ("params", "batch_stats"))
        tx = optax.chain(_keep_gradient(), jopt.create_optimizer(tcfg))
        state = JTrainState.create(params, stats, tx)
        step = jax.jit(jstep.make_train_step(model, jlosses.CrossEntropyLoss(), tcfg, mcfg, frame_features))
        for b in batches:
            state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(7))
            loss.append(float(metrics["loss"]))
            if grad0 is None:
                grad0 = jax.tree.map(np.asarray, state.opt_state[0])
    final = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return {"loss": loss, "grad0": grad0, "final": final}


def _port_run(model_name, overrides, presample, batches, frame_features, init):
    """The port's TrainStep on the same batches from the same variables, the
    model built as the train CLI builds it."""
    presampled = frame_features and find_class_by_name(model_name).samples_frames
    mcfg = ModelConfig(**MODEL_KW, **overrides, presampled=presampled)
    tcfg = TrainingConfig(**TRAIN_KW, presample_frames=presample)
    model = weights.load_flax_variables(create_model(model_name, mcfg, sum(SIZES)), init)
    state = TrainState.create(model, tcfg)
    step = tstep.TrainStep(losses.CrossEntropyLoss(), tcfg, mcfg, frame_features)
    loss, grad0 = [], None
    for b in batches:
        total = step.loss(state, {k: torch.from_numpy(v) for k, v in b.items()}, prng.key(7))[0]
        grads = tstep.gradients(total, model)
        if grad0 is None:
            grad0 = {name: g.numpy() for (name, _), g in zip(model.named_parameters(), grads)}
        state.apply_gradients(grads)
        loss.append(float(total.detach()))
    assert state.step == 3
    return {"loss": loss, "grad0": grad0, "final": weights.state_dict_to_flax(model)}


@pytest.fixture(scope="module")
def runs():
    """(case, presample) → (JAX run, port run), each computed once; the
    video-level steps, which sample nothing, once for both settings."""
    cache, inits = {}, {}

    def get(case, presample):
        model_name, overrides, tweak = CASES[case]
        frame_features = model_name not in VIDEO_LEVEL
        presample = presample and frame_features
        if (case, presample) not in cache:
            batches = _batches(frame_features)
            if case not in inits:
                inits[case] = _init_variables(model_name, overrides, tweak, frame_features)
            want = _jax_run(model_name, overrides, presample, batches, frame_features, inits[case])
            got = _port_run(model_name, overrides, presample, batches, frame_features, inits[case])
            cache[case, presample] = want, got
        return cache[case, presample]

    return get


def _leaves(tree, prefix=""):
    """{flax path: array} of a nested tree."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_leaves(value, path) if isinstance(value, dict) else {path: np.asarray(value)})
    return out


def _assert_close(got, want, name):
    """|got − want| <= 1e-5·max|want| + 1e-5, element by element."""
    assert got.shape == want.shape, name
    tol = 1e-5 * np.abs(want).max() + 1e-5
    err = np.abs(got - want).max()
    assert err <= tol, f"{name}: max |Δ| {err} > {tol}"


@pytest.mark.parametrize("case, presample", RUNS, ids=RUN_IDS)
def test_losses_match_jax(runs, case, presample):
    """The same frames (bit-exact sampling) and f32 sums in another order."""
    want, got = runs(case, presample)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=0)


@pytest.mark.parametrize("case, presample", RUNS, ids=RUN_IDS)
def test_step1_gradient_matches_jax(runs, case, presample):
    want, got = runs(case, presample)
    want_grad = _leaves(want["grad0"])
    assert set(got["grad0"]) == {path.replace("/", ".") for path in want_grad}
    for path, w in want_grad.items():
        _assert_close(got["grad0"][path.replace("/", ".")], w, path)


@pytest.mark.parametrize("case, presample", RUNS, ids=RUN_IDS)
def test_variables_after_three_steps_match_jax(runs, case, presample):
    """BN statistics, and parameters after three Adam updates.  An entry
    whose step-1 gradient in JAX's run is below 1e-6 of the model's largest
    is rounding noise that Adam turns into ±lr (TRAIN_KW): it is held to
    three steps of 2·lr instead."""
    want, got = runs(case, presample)
    w, g = _leaves(want["final"]["batch_stats"]), _leaves(got["final"]["batch_stats"])
    assert set(g) == set(w)
    for path in w:
        _assert_close(g[path], w[path], f"batch_stats/{path}")
    w, g = _leaves(want["final"]["params"]), _leaves(got["final"]["params"])
    grad0 = _leaves(want["grad0"])
    noise = 1e-6 * max(np.abs(v).max() for v in grad0.values())
    assert set(g) == set(w)
    for path in w:
        exempt = np.abs(grad0[path]) < noise
        _assert_close(np.where(exempt, w[path], g[path]), w[path], f"params/{path}")
        assert np.abs(g[path] - w[path])[exempt].max(initial=0) <= 3 * 2 * LR, path


def _netfv_float64(params, x, r):
    """sum(NetFV(x)·r) in float64 (training mode, BN on batch statistics),
    a plain composition of ref: models/modules.py#NetFV; returns the
    gradients of the parameters and of x."""
    p = {n: torch.from_numpy(np.asarray(v, np.float64)).requires_grad_()
         for n, v in _leaves(params).items()}
    x = torch.from_numpy(x.astype(np.float64)).requires_grad_()
    d, k = p["cluster_weights"].shape

    def l2(t, dim):
        return t * torch.rsqrt(torch.clamp(torch.sum(t * t, dim=dim, keepdim=True), min=1e-12))

    logits = torch.einsum("bfd,dk->bfk", x, p["cluster_weights"])
    mean = logits.mean((0, 1))
    var = (logits * logits).mean((0, 1)) - mean * mean
    logits = (logits - mean) * torch.rsqrt(var + 1e-3) * p["cluster_bn/scale"] + p["cluster_bn/bias"]
    a = torch.softmax(logits, -1)
    a_sum = a.sum(1, keepdim=True)
    covar, cw2 = p["covar_weights"] ** 2 + 1e-6, p["cluster_weights2"]
    fv1 = torch.einsum("bfk,bfd->bdk", a, x)
    fv2 = torch.einsum("bfk,bfd->bdk", a, x * x)
    fv2 = (a_sum * cw2 ** 2 + fv2 - 2 * fv1 * cw2) / covar ** 2 - a_sum
    out = torch.cat([l2(l2((fv1 - a_sum * cw2) / covar, 1).reshape(-1, d * k), 1),
                     l2(l2(fv2, 1).reshape(-1, d * k), 1)], 1)
    torch.sum(out * torch.from_numpy(r.astype(np.float64))).backward()
    return {n: v.grad.numpy() for n, v in p.items()}, x.grad.numpy()


def test_netfv_gradient_near_the_variance_floor_matches_float64():
    """NetFV at flax's init, D=1024, K=4: some covariance weights lie near
    0, where σ² = w² + 1e-6 sits at its floor and fv2/σ⁴ reaches 1e12.  The
    port's f32 gradient there agrees with a float64 evaluation within
    1e-5·max + 1e-5; the reference's f32 gradient on the CPU does not (its
    backward through the intra-normalisation passes values near the bottom
    of f32's range), which is why the parity cases above keep σ² >= 1e-4."""
    from learnablepoolingmethods_tpu.models.modules import NetFV as JNetFV
    from learnablepoolingmethods_torch.models.modules import NetFV

    d, k = 1024, 4
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 4, d)).astype(np.float32)
    r = rng.normal(size=(6, 2 * d * k)).astype(np.float32)
    jm = JNetFV(feature_size=d, max_frames=4, cluster_size=k)
    v = jax.jit(lambda x: jm.init(jax.random.key(0), x, training=True))(jnp.asarray(x))
    assert float(jnp.abs(v["params"]["covar_weights"]).min()) < 1e-4

    def f(params, xx):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xx, training=True,
                          mutable=["batch_stats"])
        return jnp.sum(out * r)

    jgrad = jax.jit(jax.grad(f))(v["params"], jnp.asarray(x))
    port = NetFV(d, k)
    port.load_state_dict(weights.flax_to_state_dict(jax.tree.map(np.asarray, dict(v))))
    xt = torch.from_numpy(x).requires_grad_()
    torch.sum(port(xt, training=True) * torch.from_numpy(r)).backward()
    want, want_x = _netfv_float64(jax.tree.map(np.asarray, v["params"]), x, r)
    _assert_close(xt.grad.numpy(), want_x, "x")
    jax_gap = 0.0
    jgrad = _leaves(jax.tree.map(np.asarray, jgrad))
    for name, w in want.items():
        _assert_close(port.get_parameter(name.replace("/", ".")).grad.numpy(), w, name)
        jax_gap = max(jax_gap, np.abs(jgrad[name] - w).max() / np.abs(w).max())
    assert jax_gap > 1e-2, jax_gap


def test_relu6_gradient_at_its_bounds_matches_jnp_clip():
    """relu6 at exactly 0 and 6 passes half the gradient on, as jnp.clip
    does (torch.clamp passes all of it)."""
    from learnablepoolingmethods_torch.models.frame_level import relu6

    x = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 6.0) * jnp.arange(1.0, 6.0)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    torch.sum(relu6(t) * torch.arange(1.0, 6.0)).backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


# --- the variable tree and forward of --netvlad_dimred ---------------------


@pytest.mark.parametrize("model_name", ["NetVLADModelLF", "NetRVLADModelLF"])
@pytest.mark.parametrize("dimred", [64, 200])
def test_dimred_tree_and_forward_match_flax(model_name, dimred):
    """init_variables_np's keys and shapes are flax's (``dimred`` [D, r], one
    pooling module of r columns), and the port's forward on flax's
    variables matches flax's in training and inference mode."""
    overrides = {"netvlad_dimred": dimred}
    (batch,) = _batches(True, n=1)
    jmodel = jcreate(model_name, JModelConfig(**MODEL_KW, **overrides, presampled=True))
    tree = _flax_variables(model_name, overrides, batch)
    mcfg = ModelConfig(**MODEL_KW, **overrides, presampled=True)
    fcfg = FeatureConfig(("rgb", "audio"), SIZES, True, F)
    ours = weights.init_variables_np(mcfg, fcfg, seed=0, model_name=model_name)
    shapes = {p: v.shape for p, v in _leaves(ours).items()}
    assert shapes == {p: v.shape for p, v in _leaves(tree).items()}
    assert shapes["params/dimred"] == (sum(SIZES), dimred)
    prefix = "NetVLAD" if model_name == "NetVLADModelLF" else "NetRVLAD"
    assert shapes[f"params/{prefix}_0/cluster_weights"] == (dimred, 8)
    assert f"{prefix}_1" not in tree["params"]
    weights.convert_flax_variables(tree, mcfg, model_name)  # the layout check takes it

    port = weights.load_flax_variables(create_model(model_name, mcfg, sum(SIZES)), tree)
    x_u8, nf = batch["features"][:, :MODEL_KW["iterations"]], batch["num_frames"]
    x = jstep.preprocess_input(jnp.asarray(x_u8))
    for training in (True, False):
        apply = jax.jit(lambda v, x, nf: jmodel.apply(v, x, num_frames=nf, training=training,
                                                       mutable=["batch_stats"] if training else False))
        out = apply(tree, x, jnp.asarray(nf))
        want = (out[0] if training else out)["predictions"]
        got = port(tstep.preprocess_input(torch.from_numpy(x_u8)), torch.from_numpy(nf),
                   training=training)["predictions"]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-4,
                                   err_msg=f"training={training}")


def test_fast_inference_refuses_dimred(tmp_path):
    """The fast paths refuse --netvlad_dimred with ValueError, as the JAX
    fast paths do; such a model serves through the model-forward route."""
    data = str(tmp_path / "f.tfrecord")
    fixtures.write_frame_level_fixture(data, 4, num_classes=V, max_frames=F, seed=1)
    flags = ["--model=NetRVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
             "--feature_sizes=1024,128", f"--num_classes={V}", "--iterations=4",
             "--rvlad_cluster_size=8", "--netvlad_hidden_size=16", "--netvlad_dimred=64",
             f"--max_frames={F}", "--device=cpu", f"--input_data_pattern={data}",
             f"--train_dir={tmp_path}", f"--output_file={tmp_path}/p.csv", "--batch_size=4"]
    mcfg = ModelConfig(vocab_size=V, rvlad_cluster_size=8, netvlad_hidden_size=16, netvlad_dimred=64)
    weights.save_variables_npz(weights.init_variables_np(
        mcfg, FeatureConfig(("rgb", "audio"), (1024, 128), True, F), model_name="NetRVLADModelLF"), str(tmp_path))
    with pytest.raises(ValueError, match="dimred"):
        inference.main(flags + ["--fast_infer"])
    assert inference.main(flags) == 4


# --- the train CLI end to end ---------------------------------------------

CLI_SMALL = [f"--num_classes={V}", "--iterations=4", "--netvlad_cluster_size=8", "--netvlad_hidden_size=16",
             "--rvlad_cluster_size=8", "--fv_cluster_size=4", "--fv_hidden_size=16", "--dbow_cluster_size=16",
             "--nextvlad_cluster_size=4", "--nextvlad_hidden_size=16", "--dbof_cluster_size=16",
             "--dbof_hidden_size=16", "--device=cpu", "--batch_size=4"]
FRAME_FLAGS = ["--frame_features", "--feature_names=rgb,audio", "--feature_sizes=1024,128", f"--max_frames={F}"]
VIDEO_FLAGS = ["--feature_names=mean_rgb,mean_audio", "--feature_sizes=1024,128"]
CLI_RUNS = {
    "NetRVLADModelLF-fused": ("NetRVLADModelLF", ["--fused_train_aggregation"]),
    "NetRVLADModelLF": ("NetRVLADModelLF", []),
    "NetFVModelLF": ("NetFVModelLF", ["--fv_couple_weights"]),
    "SoftDbofModelLF": ("SoftDbofModelLF", ["--presample_frames"]),
    "NeXtVLADModel": ("NeXtVLADModel", []),
    "DbofModel-max": ("DbofModel", []),
    "DbofModel-average-nobn": ("DbofModel", ["--dbof_pooling_method=average", "--nodbof_add_batch_norm"]),
    "DbofModel-windows": ("DbofModel", ["--nosample_random_frames"]),
    "FrameLevelLogisticModel": ("FrameLevelLogisticModel", []),
    "NetVLADModelLF-dimred": ("NetVLADModelLF", ["--netvlad_dimred=64", "--fused_train_aggregation"]),
    "NetFVModelLF-logistic-head": ("NetFVModelLF", ["--video_level_classifier_model=LogisticModel"]),
    "LogisticModel": ("LogisticModel", None),
    "MoeModel": ("MoeModel", None),
}


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo_cli")
    frame, video = str(d / "frame-0.tfrecord"), str(d / "video-0.tfrecord")
    fixtures.write_frame_level_fixture(frame, 10, num_classes=V, max_frames=F, seed=1)
    fixtures.write_video_level_fixture(video, 10, num_classes=V, seed=1)
    return {"frame": frame, "video": video}


@pytest.mark.parametrize("run", sorted(CLI_RUNS))
def test_train_cli_trains_and_the_eval_cli_reads_the_weights(cli_data, tmp_path, run):
    """Two steps of the train CLI on the CPU, then the port's eval CLI
    (--run_once) on the checkpoint it wrote."""
    model_name, extra = CLI_RUNS[run]
    flags = [f"--model={model_name}", *CLI_SMALL, *(VIDEO_FLAGS if extra is None else FRAME_FLAGS + extra)]
    data = cli_data["video" if extra is None else "frame"]
    train_dir = str(tmp_path / "model")
    trainer = train.main(flags + [f"--train_data_pattern={data}", f"--train_dir={train_dir}",
                                  "--max_steps=2", "--log_every_n_steps=1"])
    assert [h["step"] for h in trainer.history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    tree = CheckpointManager(train_dir).variables(2)
    head = "LogisticModel_0" if "logistic-head" in run else "MoeModel_0"
    assert model_name in VIDEO_LEVEL + ("FrameLevelLogisticModel",) or head in tree["params"]
    info = eval_cli.main(flags + [f"--eval_data_pattern={data}", f"--train_dir={train_dir}", "--run_once"])
    assert np.isfinite(float(info["gap"])) and 0.0 <= float(info["gap"]) <= 1.0


def test_train_cli_starts_from_the_models_own_weights(cli_data, tmp_path):
    """The CLI draws the initial weights of --model (init_variables_np with
    its model_name): at a learning rate of 0 the parameters it writes are
    those weights exactly."""
    flags = ["--model=DbofModel", *CLI_SMALL, *FRAME_FLAGS, f"--train_data_pattern={cli_data['frame']}",
             f"--train_dir={tmp_path}/m", "--max_steps=1", "--base_learning_rate=0", "--seed=3"]
    train.main(flags)
    args = train.build_parser().parse_args(flags)
    fcfg, mcfg, _ = train.configs_from_args(args)
    want = weights.init_variables_np(mcfg, fcfg, seed=3, model_name="DbofModel")["params"]
    got = CheckpointManager(f"{tmp_path}/m").variables(1)["params"]
    assert _leaves(got).keys() == _leaves(want).keys()
    for path, w in _leaves(want).items():
        np.testing.assert_array_equal(_leaves(got)[path], w, err_msg=path)


@pytest.mark.parametrize("model_name", ["LogisticModel", "MoeModel"])
def test_train_cli_reads_video_level_records(cli_data, tmp_path, model_name):
    """Without --frame_features the CLI reads tf.Example records
    (data/readers.py#make_reader): its first loss is the port's TrainStep
    loss on the first batch of those records, from the same weights."""
    flags = [f"--model={model_name}", *CLI_SMALL, *VIDEO_FLAGS, f"--train_data_pattern={cli_data['video']}",
             f"--train_dir={tmp_path}/m", "--max_steps=1", "--log_every_n_steps=1", "--shuffle_buffer=1"]
    trainer = train.main(flags)
    args = train.build_parser().parse_args(flags)
    fcfg, mcfg, tcfg = train.configs_from_args(args)
    batch = next(batch_iterator(make_reader(fcfg, V), cli_data["video"], 4, num_epochs=None, shuffle=True,
                                shuffle_buffer=1, seed=0))
    assert batch["features"].shape == (4, 1152) and batch["features"].dtype == np.float32
    model = weights.load_flax_variables(create_model(model_name, mcfg, 1152),
                                        weights.init_variables_np(mcfg, fcfg, seed=0, model_name=model_name))
    step = tstep.TrainStep(losses.CrossEntropyLoss(), tcfg, mcfg, False)
    total = step.loss(TrainState.create(model, tcfg), {k: torch.from_numpy(v) for k, v in batch.items()
                                                       if k != "video_id"}, prng.key(0))[0]
    np.testing.assert_allclose(trainer.history[0]["loss"], float(total.detach()), rtol=1e-6)
