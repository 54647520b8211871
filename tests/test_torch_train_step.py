"""The port's train step, optimizer and train CLI ≡ the JAX package's on the
CPU: three steps of make_train_step (presample_frames) from the same
variables, batches and seed; per-tensor clipping, the learning-rate
schedule and Adam against their optax counterparts; the train CLI writing a
variables.npz that the inference CLI reads."""

import dataclasses

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
from learnablepoolingmethods_torch import inference, losses, train
from learnablepoolingmethods_torch.config import ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core import optimizers, weights
from learnablepoolingmethods_torch.core import step as tstep
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.data import fixtures
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.utils import prng

MODEL_KW = dict(vocab_size=20, iterations=4, netvlad_cluster_size=8, netvlad_hidden_size=32,
                presampled=True)
TRAIN_KW = dict(batch_size=6, presample_frames=True, base_learning_rate=0.05,
                learning_rate_decay_examples=12)
B, F, SIZES, V = 6, 10, (1024, 16), 20


def _batches(rng, n=3):
    return [{
        "features": rng.integers(0, 256, size=(B, F, sum(SIZES)), dtype=np.uint8),
        "num_frames": rng.integers(1, F + 1, size=B).astype(np.int32),
        "labels": (rng.random((B, V)) < 0.2).astype(np.float32),
        "weights": np.r_[np.ones(B - 1), 0].astype(np.float32),  # one padding row
    } for _ in range(n)]


def _keep_gradient():
    """An optax transform that passes the gradient on unchanged and keeps it
    as its state, so the jitted step hands back the gradient it computed."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX train steps (the jitted production step) from model.init,
    and the gradient of the first."""
    batches = _batches(np.random.default_rng(11))
    mcfg, tcfg = JModelConfig(**MODEL_KW), JTrainingConfig(**TRAIN_KW)
    model = jcreate("NetVLADModelLF", mcfg)
    params, stats = jstep.init_model_variables(model, batches[0], True, seed=0)
    init = jax.tree.map(np.asarray, {"params": params, "batch_stats": stats})
    tx = optax.chain(_keep_gradient(), jopt.create_optimizer(tcfg))
    state = JTrainState.create(params, stats, tx)
    step = jax.jit(jstep.make_train_step(model, jlosses.CrossEntropyLoss(), tcfg, mcfg, True))
    loss, grad0 = [], None
    for b in batches:
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(7))
        loss.append(float(metrics["loss"]))
        if grad0 is None:
            grad0 = jax.tree.map(np.asarray, state.opt_state[0])
    final = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats,
                                      "grad0": grad0})
    return batches, init, loss, final


@pytest.mark.parametrize("fused", [False, True])
def test_three_steps_match_jax(jax_run, fused):
    batches, init, want_loss, want = jax_run
    mcfg = ModelConfig(**MODEL_KW, fused_train_aggregation=fused)
    tcfg = TrainingConfig(**TRAIN_KW)
    model = weights.load_flax_variables(create_model("NetVLADModelLF", mcfg, sum(SIZES)), init)
    state = TrainState.create(model, tcfg)
    step = tstep.TrainStep(losses.CrossEntropyLoss(), tcfg, mcfg, True)
    loss = [float(step(state, {k: torch.from_numpy(v) for k, v in b.items()}, prng.key(7))["loss"])
            for b in batches]
    assert state.step == 3
    # the same frames (bit-exact sampling) and f32 sums in another order
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=0)
    got = weights.state_dict_to_flax(model)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want["batch_stats"]),
                            jax.tree_util.tree_leaves(got["batch_stats"])):
        np.testing.assert_allclose(g, w, atol=1e-6, err_msg=jax.tree_util.keystr(path))
    # Adam's first update is lr·g/(|g| + 1e-8): an entry whose first
    # gradient sits within rounding noise of zero may move by up to 2·lr in
    # one package and not the other.  Such an entry is exempt: |g| of JAX's
    # first step below 1e-6 of its tensor's largest |g| (about eight f32
    # ulps of it).  Measured: 17 exempt entries, all in the hidden FC (6e-5
    # of all entries), 7 of them apart by more than 1e-4.  Every other entry
    # within 1e-4, and none further apart than three steps of 2·lr
    exempt, total = 0, 0
    for (path, w), g, g0 in zip(jax.tree_util.tree_leaves_with_path(want["params"]),
                                jax.tree_util.tree_leaves(got["params"]),
                                jax.tree_util.tree_leaves(want["grad0"])):
        diff = np.abs(g - w)
        name = jax.tree_util.keystr(path)
        near_zero = np.abs(g0) < 1e-6 * np.abs(g0).max()
        exempt, total = exempt + near_zero.sum(), total + near_zero.size
        np.testing.assert_array_less(diff[~near_zero], 1e-4, err_msg=name)
        assert diff.max() <= 3 * 2 * TRAIN_KW["base_learning_rate"], name
    assert exempt / total < 1e-4, (exempt, total)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_gradient_norms_matches_jax(rng, max_norm):
    grads = {"a": rng.normal(size=(4, 5)).astype(np.float32), "b": rng.normal(size=7).astype(np.float32) * 0.01}
    tx = jopt.clip_gradient_norms(max_norm)
    want, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(grads))
    got = optimizers.clip_gradient_norms([torch.from_numpy(grads[k]) for k in ("a", "b")], max_norm)
    for g, k in zip(got, ("a", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6)
    # per tensor: the small one is never scaled, whatever the large one's norm
    np.testing.assert_array_equal(got[1].numpy(), grads["b"])


@pytest.mark.parametrize("batch_size, decay_examples", [(256, 4_000_000), (6, 12), (1000, 10)])
def test_learning_rate_schedule_matches_jax(batch_size, decay_examples):
    cfg = dict(batch_size=batch_size, learning_rate_decay_examples=decay_examples,
               base_learning_rate=0.01, learning_rate_decay=0.95)
    want = jopt.learning_rate_schedule(JTrainingConfig(**cfg))
    got = optimizers.learning_rate_schedule(TrainingConfig(**cfg))
    for count in (0, 1, 2, 7, 15624, 15625, 100000):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)


def test_adam_matches_optax(rng):
    """Clip then Adam at optax's defaults, three updates, the first at lr(0)."""
    cfg = TrainingConfig(batch_size=6, base_learning_rate=0.05, learning_rate_decay_examples=12,
                         clip_gradient_norm=1.0)
    shapes = ((3, 4), (5,))
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 0.3 for s in shapes] for _ in range(3)]
    tx = jopt.create_optimizer(JTrainingConfig(**dataclasses.asdict(cfg)))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
    tp = [torch.from_numpy(p.copy()) for p in params]
    adam = optimizers.create_optimizer(tp, cfg)
    for g in grads:
        adam.step([torch.from_numpy(x) for x in g])
    assert adam.count == 3
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)  # f32, a few ulp


def test_regularization_loss_matches_jax(jax_run):
    _, init, _, _ = jax_run
    model = weights.load_flax_variables(
        create_model("NetVLADModelLF", ModelConfig(**MODEL_KW), sum(SIZES)), init)
    for kw in (dict(l2_penalty=1e-3), dict(l2_penalty=1e-3, moe_l2=0.5), dict(l2_penalty=1e-3, all_kernels=True)):
        want = float(jstep.regularization_loss(jax.tree.map(jnp.asarray, init["params"]), **kw))
        got = float(tstep.regularization_loss(model.named_parameters(), **kw).detach())
        np.testing.assert_allclose(got, want, rtol=1e-6)


CLI_FLAGS = [
    "--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
    "--feature_sizes=1024,128", "--num_classes=20", "--iterations=4", "--netvlad_cluster_size=8",
    "--netvlad_hidden_size=16", "--max_frames=10", "--device=cpu",
]


def test_train_cli_writes_variables_the_inference_cli_reads(tmp_path):
    data = str(tmp_path / "train-0.tfrecord")
    fixtures.write_frame_level_fixture(data, 10, num_classes=20, max_frames=10, seed=1)
    train_dir = str(tmp_path / "model")
    trainer = train.main(CLI_FLAGS + [
        f"--train_data_pattern={data}", f"--train_dir={train_dir}", "--batch_size=4",
        "--max_steps=3", "--log_every_n_steps=1", "--fused_train_aggregation",
        "--compute_dtype=bfloat16", "--save_checkpoint_every_n_steps=2",
    ])
    assert [h["step"] for h in trainer.history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    tree = weights.load_variables_npz(train_dir)
    assert set(tree) == {"params", "batch_stats"} and "NetVLAD_1" in tree["params"]
    out = str(tmp_path / "predictions.csv")
    n = inference.main(CLI_FLAGS + [
        "--fast_infer", f"--input_data_pattern={data}", f"--train_dir={train_dir}",
        f"--output_file={out}", "--batch_size=4", "--top_k=5",
    ])
    assert n == 10
    with open(out) as f:
        rows = f.read().splitlines()
    assert rows[0] == "VideoId,LabelConfidencePairs" and len(rows) == 11
    assert all(len(r.split(",")[1].split()) == 10 for r in rows[1:])


@pytest.mark.parametrize("flag, error", [
    ("--grad_accum_steps=2", NotImplementedError),
    ("--bf16_params", NotImplementedError),
    ("--optimizer=MomentumOptimizer", NotImplementedError),
    ("--label_loss=HingeLoss", NotImplementedError),
    ("--noframe_features", NotImplementedError),
    ("--nosample_random_frames", NotImplementedError),
])
def test_train_cli_refuses_what_is_not_ported(tmp_path, flag, error):
    data = str(tmp_path / "train-0.tfrecord")
    fixtures.write_frame_level_fixture(data, 2, num_classes=20, max_frames=10, seed=1)
    with pytest.raises(error):
        train.main(CLI_FLAGS + [f"--train_data_pattern={data}", f"--train_dir={tmp_path}/m",
                                "--batch_size=2", "--max_steps=1", flag])


def test_train_cli_refuses_to_overwrite_a_checkpoint(tmp_path):
    data = str(tmp_path / "train-0.tfrecord")
    fixtures.write_frame_level_fixture(data, 2, num_classes=20, max_frames=10, seed=1)
    args = CLI_FLAGS + [f"--train_data_pattern={data}", f"--train_dir={tmp_path}/m",
                        "--batch_size=2", "--max_steps=1"]
    train.main(args)
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        train.main(args)
    train.main(args + ["--start_new_model"])
