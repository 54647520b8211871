"""The port's model axis on four gloo ranks of the CPU against the JAX
package's steps on the same meshes of its virtual devices (the cases of
tests/distributed/test_model_axis.py): 1×2 and 2×2 (data × model) meshes on
a narrow NetVLADModelLF with BatchNorm and on MoeModel, the multislice
2×1×2 (dcn × data × model) mesh, ``--fused_adam`` in deterministic
rounding, Adafactor's factored moments over split columns, the eval step and
the fast route with split weights, and a checkpoint of one process resumed
on a mesh whose checkpoint one process restores.  The split threshold is
the JAX test's 2⁸ entries, so that the narrow matrices split; the four
ranks run once, in the module's fixture (a 1×2 case on ranks 0 and 1)."""

import os

import numpy as np
import pytest
import torch

from learnablepoolingmethods_torch.config import ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core.checkpoints import CheckpointManager
from learnablepoolingmethods_torch.core.step import TrainStep
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.core.weights import load_flax_variables, load_variables_npz
from learnablepoolingmethods_torch.losses import CrossEntropyLoss
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.ops.fast_dispatch import get_fast_path
from learnablepoolingmethods_torch.utils import prng
from tests import _torch_mesh_oracle as O
from tests import _torch_mp

FAST = dict(model_name="NetVLADModelLF",
            mcfg=dict(vocab_size=20, iterations=6, netvlad_cluster_size=8, netvlad_hidden_size=16,
                      moe_num_mixtures=2),
            frame_features=True, input_size=1152)
# MoE kernels with both dims >= 128, which Adafactor factors
WIDE_MOE = dict(model_name="MoeModel", mcfg=dict(vocab_size=128), frame_features=False, input_size=200)
BF16_VLAD = dict(O.NETVLAD, mcfg=dict(O.NETVLAD["mcfg"], param_dtype="bfloat16"))
FUSED = dict(O.TCFG, fused_adam=True)
ADAFACTOR = dict(O.TCFG, optimizer="AdafactorOptimizer")

# name → (case, tcfg, batch maker, ranks, model, dcn)
CASES = {
    "vlad_1x2": (O.NETVLAD, O.TCFG, lambda r: [O.netvlad_batch(r)], [0, 1], 2, 1),
    "moe_1x2": (O.MOE, O.TCFG, lambda r: [O.moe_batch(r)], [0, 1], 2, 1),
    "vlad_2x2": (O.NETVLAD, O.TCFG, lambda r: [O.netvlad_batch(r, b=7)], None, 2, 1),
    "moe_2x2": (O.MOE, O.TCFG, lambda r: [O.moe_batch(r, real=13)], None, 2, 1),
    "vlad_dcn": (O.NETVLAD, O.TCFG, lambda r: [O.netvlad_batch(r)], None, 2, 2),
    "fused_adam": (BF16_VLAD, FUSED, lambda r: [O.netvlad_batch(r)], [0, 1], 2, 1),
    "adafactor": (WIDE_MOE, ADAFACTOR,
                  lambda r: [dict(O.moe_batch(r), features=r.normal(size=(16, 200)).astype(np.float32),
                                  labels=(r.uniform(size=(16, 128)) < 0.1).astype(np.float32))],
                  [0, 1], 2, 1),
}


def _fast_batch(rng, b=8):
    return {"features": rng.integers(0, 256, size=(b, 6, 1152), dtype=np.uint8),
            "num_frames": np.full((b,), 6, np.int32),
            "labels": (rng.uniform(size=(b, 20)) < 0.2).astype(np.float32),
            "weights": np.ones(b, np.float32)}


def _port_steps(case, tcfg, init, batches):
    """One process of the port over ``batches`` → its TrainState."""
    mcfg = ModelConfig(**O.port_mcfg(case))
    net = load_flax_variables(create_model(case["model_name"], mcfg, case["input_size"]), init)
    state = TrainState.create(net, TrainingConfig(**tcfg))
    step = TrainStep(CrossEntropyLoss(), TrainingConfig(**tcfg), mcfg, case["frame_features"])
    for b in batches:
        step(state, {k: torch.from_numpy(v) for k, v in b.items()}, prng.key(0))
    return state


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = O.out_dir(tmp_path_factory, "model_axis")
    rng = np.random.default_rng(1)
    jobs, cases = [], {}
    for name, (case, tcfg, make, ranks, model, dcn) in CASES.items():
        batches = make(rng)
        init_path = os.path.join(root, f"{name}_init.npz")
        init = O.write_init(case, batches[0], init_path)
        cases[name] = (case, tcfg, init, batches, ranks, model, dcn)
        jobs.append({"fn": "train_steps", "kw": dict(
            out=root, name=name, model_name=case["model_name"], mcfg=O.port_mcfg(case), tcfg=tcfg,
            frame_features=case["frame_features"], input_size=case["input_size"], init=init_path,
            batches=O.write_batches(batches, os.path.join(root, f"{name}_batches.npz")), ranks=ranks,
            model=model, dcn=dcn, min_size=O.MIN_SIZE, deterministic=name == "fused_adam")})
    # a checkpoint of one process after one step, resumed on ranks 0 and 1
    # (1×2) for a second, whose checkpoint one process restores
    batches = [O.netvlad_batch(rng), O.netvlad_batch(rng)]
    init_path = os.path.join(root, "resume_init.npz")
    init = O.write_init(O.NETVLAD, batches[0], init_path)
    one = _port_steps(O.NETVLAD, O.TCFG, init, batches[:1])
    CheckpointManager(os.path.join(root, "ckpt_one")).save(one.step, one.state_tree())
    cases["resume"] = (O.NETVLAD, O.TCFG, init, batches, [0, 1], 2, 1)
    jobs.append({"fn": "train_steps", "kw": dict(
        out=root, name="resume", model_name="NetVLADModelLF", mcfg=O.port_mcfg(O.NETVLAD), tcfg=O.TCFG,
        frame_features=True, input_size=24, init=init_path,
        batches=O.write_batches(batches[1:], os.path.join(root, "resume_batches.npz")), ranks=[0, 1], model=2,
        min_size=O.MIN_SIZE, restore=os.path.join(root, "ckpt_one"), checkpoint=os.path.join(root, "ckpt_mesh"))})
    # the eval step and the fast route with split weights on ranks 0 and 1
    eval_batch = O.netvlad_batch(rng)
    np.savez(os.path.join(root, "eval_batch.npz"), **eval_batch)
    jobs.append({"fn": "eval_forward", "kw": dict(
        out=root, name="eval", model_name="NetVLADModelLF", mcfg=O.port_mcfg(O.NETVLAD), frame_features=True,
        input_size=24, init=os.path.join(root, "vlad_1x2_init.npz"), batch=os.path.join(root, "eval_batch.npz"),
        ranks=[0, 1], model=2, min_size=O.MIN_SIZE)})
    fast_batch = _fast_batch(rng)
    np.savez(os.path.join(root, "fast_batch.npz"), **fast_batch)
    O.write_init(FAST, fast_batch, os.path.join(root, "fast_init.npz"))
    jobs.append({"fn": "eval_forward", "kw": dict(
        out=root, name="fast", model_name="NetVLADModelLF", mcfg=FAST["mcfg"], frame_features=True,
        input_size=1152, init=os.path.join(root, "fast_init.npz"), batch=os.path.join(root, "fast_batch.npz"),
        ranks=[0, 1], model=2, min_size=O.MIN_SIZE, fast=True)})
    _torch_mp.spawn(4, jobs)
    return root, cases, eval_batch, fast_batch


@pytest.mark.parametrize("name", ["vlad_1x2", "moe_1x2", "vlad_2x2", "moe_2x2", "vlad_dcn", "adafactor"])
def test_model_mesh_train_step_equals_jax_on_the_same_mesh(run, name):
    root, cases, _, _ = run
    case, tcfg, init, batches, ranks, model, dcn = cases[name]
    got = np.load(os.path.join(root, f"{name}.npz"))
    devices = 4 if ranks is None else len(ranks)
    losses, want, preds = O.jax_train(case, init, batches, tcfg=tcfg, devices=devices, model=model, dcn=dcn)
    np.testing.assert_allclose(got["losses"], losses, rtol=O.RTOL)
    O.assert_state_close(got, want)
    np.testing.assert_allclose(got["preds0"], preds, rtol=O.RTOL, atol=O.ATOL)


@pytest.mark.parametrize("name, want", [
    ("vlad_1x2", {"hidden1_weights", "gating.gating_weights", "MoeModel_0.gates_kernel",
                  "MoeModel_0.experts_kernel"}),
    ("adafactor", {"gates_kernel", "experts_kernel"}),
])
def test_the_split_is_not_vacuous(run, name, want):
    """The leaves the rule split, as the JAX test guards its own."""
    got = np.load(os.path.join(run[0], f"{name}.npz"))
    assert set(got["split"].tolist()) == want


def test_fused_adam_deterministic_matches_jax(run):
    """The JAX test's comparison (deterministic rounding, bf16 state): the
    loss within 1e-3 and every parameter within 2e-2."""
    from learnablepoolingmethods_tpu.core import optimizers as jopt
    from learnablepoolingmethods_tpu.config import TrainingConfig as JTrainingConfig
    from learnablepoolingmethods_tpu.ops.fused_adam import FusedAdam as JFusedAdam

    root, cases, _, _ = run
    case, tcfg, init, batches, ranks, model, dcn = cases["fused_adam"]
    jt = JTrainingConfig(**tcfg)
    tx = JFusedAdam(jopt.learning_rate_schedule(jt), clip_norm=jt.clip_gradient_norm, stochastic=False)
    losses, want, _ = O.jax_train(case, init, batches, tcfg=tcfg, devices=2, model=2, tx=tx)
    got = np.load(os.path.join(root, "fused_adam.npz"))
    assert abs(got["losses"][0] - losses[0]) < 1e-3
    O.assert_state_close(got, want, rtol=2e-2, atol=2e-2, prefixes=("params/",))
    assert got["state/params/hidden1_weights"].dtype == np.uint16  # bf16 bits: the state stayed bf16


def test_checkpoint_of_one_process_resumes_on_a_mesh_and_back(run):
    root, cases, _, _ = run
    case, tcfg, init, batches, *_ = cases["resume"]
    got = np.load(os.path.join(root, "resume.npz"))
    losses, want, _ = O.jax_train(case, init, batches, tcfg=tcfg, devices=2, model=2)
    np.testing.assert_allclose(got["losses"], losses[1:], rtol=O.RTOL)
    O.assert_state_close(got, want)
    # the mesh's checkpoint, whole, restored by one process
    state = _port_steps(case, tcfg, init, [])
    mngr = CheckpointManager(os.path.join(root, "ckpt_mesh"))
    state.load_checkpoint(mngr, mngr.latest_step())
    assert state.step == 2
    for name, t in state.state_tree().items():
        np.testing.assert_array_equal(t.detach().numpy(), got[f"state/{name}"], err_msg=name)


def test_model_mesh_eval_equals_jax(run):
    root, cases, batch, _ = run
    got = np.load(os.path.join(root, "eval.npz"))
    want = O.jax_eval(O.NETVLAD, cases["vlad_1x2"][2], batch, devices=2, model=2)
    np.testing.assert_allclose(got["predictions"], np.asarray(want["predictions"]), rtol=O.RTOL, atol=O.ATOL)
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=O.RTOL)


def test_fast_route_with_split_weights_equals_one_process_and_jax(run):
    """The hidden FC's slices and the MoE kernels split: each column is
    summed whole by one rank, so the route equals one process bit for bit;
    against JAX's fast route on a 2-device model mesh at the bf16 routes'
    tolerance (tests/test_torch_fast_infer.py)."""
    import jax

    from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
    from learnablepoolingmethods_tpu.ops.fast_dispatch import get_fast_path as jget
    from learnablepoolingmethods_tpu.parallel import mesh as jmesh
    from learnablepoolingmethods_torch.core.weights import convert_flax_variables

    root, _, _, batch = run
    got = np.load(os.path.join(root, "fast.npz"))["predictions"]
    init = load_variables_npz(os.path.join(root, "fast_init.npz"))
    mcfg = ModelConfig(**FAST["mcfg"])
    path = get_fast_path("NetVLADModelLF")
    fp = path.prepare(convert_flax_variables(init, mcfg, "NetVLADModelLF"), mcfg, device="cpu")
    key = prng.fold_in(prng.key(0), 3)
    one = path.build(mcfg, return_probs=True, use_kernels=False)(
        fp, torch.from_numpy(batch["features"]), torch.from_numpy(batch["num_frames"]), key).float()
    np.testing.assert_array_equal(got, one.numpy())

    jcfg = JModelConfig(**FAST["mcfg"])
    jpath = jget("NetVLADModelLF")
    mesh = jmesh.create_mesh(jax.devices()[:2], model_parallelism=2)
    jfp = jmesh.shard_params(jpath.prepare(init, jcfg), mesh, min_size=O.MIN_SIZE)
    want = jax.jit(jpath.build(jcfg, use_pallas=False, return_probs=True))(
        jfp, jax.device_put(batch["features"], jmesh.batch_sharding(mesh)),
        jax.device_put(batch["num_frames"], jmesh.batch_sharding(mesh)), jax.random.fold_in(jax.random.key(0), 3))
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-2)
