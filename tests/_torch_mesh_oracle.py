"""The JAX package's side of the mesh tests: its models' variables, its
jitted train and eval steps on meshes of the 8 virtual CPU devices that
``tests/conftest.py`` provides, and the cases both sides run."""

import os

import jax
import numpy as np

from learnablepoolingmethods_tpu import losses as jlosses
from learnablepoolingmethods_tpu.config import ModelConfig as JModelConfig
from learnablepoolingmethods_tpu.config import TrainingConfig as JTrainingConfig
from learnablepoolingmethods_tpu.core import optimizers as jopt
from learnablepoolingmethods_tpu.core import step as jstep
from learnablepoolingmethods_tpu.core.train_state import TrainState as JTrainState
from learnablepoolingmethods_tpu.models import create_model as jcreate
from learnablepoolingmethods_tpu.parallel import mesh as jmesh
from learnablepoolingmethods_torch.core.weights import bf16_bits_to_f32, save_variables_npz

# the JAX distributed tests' tolerances (tests/distributed/test_dp_equivalence.py)
RTOL, ATOL = 1e-5, 1e-6
MIN_SIZE = 1 << 8  # tests/distributed/test_model_axis.py's "large param" threshold

# a MoE penalty large enough that the regularization's gradient shows: a
# mesh that counted it once per rank would move the MoE kernels off JAX's
MOE = dict(model_name="MoeModel", mcfg=dict(vocab_size=24, moe_l2=0.5), frame_features=False, input_size=20)
NETVLAD = dict(model_name="NetVLADModelLF",
               mcfg=dict(vocab_size=32, iterations=6, netvlad_cluster_size=8, netvlad_hidden_size=32,
                         moe_num_mixtures=2),
               frame_features=True, input_size=24)
TCFG = dict(batch_size=8, base_learning_rate=0.01)


def moe_batch(rng, b=16, real=None):
    real = b if real is None else real
    return {"features": rng.normal(size=(b, 20)).astype(np.float32),
            "labels": (rng.uniform(size=(b, 24)) < 0.2).astype(np.float32),
            "weights": (np.arange(b) < real).astype(np.float32)}


def netvlad_batch(rng, b=8, real=None):
    real = b if real is None else real
    return {"features": rng.integers(0, 256, size=(b, 12, 24), dtype=np.uint8),
            "labels": (rng.uniform(size=(b, 32)) < 0.2).astype(np.float32),
            "num_frames": rng.integers(1, 13, size=(b,)).astype(np.int32),
            "weights": (np.arange(b) < real).astype(np.float32)}


def port_mcfg(case):
    """The port's ModelConfig fields of a case: a sampling model is built
    presampled, as the train CLI builds it (its step gathers the frames)."""
    return dict(case["mcfg"], presampled=case["model_name"] == "NetVLADModelLF")


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def write_init(case, batch, path, seed=0):
    """The flax variables of ``case``'s model from ``init_model_variables``,
    as a variables.npz the workers load; returns the tree."""
    model = jcreate(case["model_name"], JModelConfig(**case["mcfg"]))
    params, stats = jstep.init_model_variables(model, batch, case["frame_features"], seed=seed)
    tree = jax.tree.map(np.asarray, {"params": params, "batch_stats": stats})
    # bf16 leaves widened to f32 (exact) for the .npz
    save_variables_npz(jax.tree.map(lambda x: x.astype(np.float32), tree), path)
    return tree


def write_batches(batches, path):
    np.savez(path, **{f"b{i}_{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    return path


def jax_train(case, init, batches, tcfg=TCFG, devices=1, model=1, dcn=1, min_size=MIN_SIZE, mcfg=None, tx=None):
    """The jitted JAX step over ``batches`` on a mesh of the first
    ``devices`` devices (the batch padded to a multiple of them, the state
    sharded by ``shard_params`` with a model axis) → (losses, flat
    ``params/…`` and ``batch_stats/…``, the last step's predictions)."""
    mcfg = JModelConfig(**(mcfg or case["mcfg"]))
    tcfg = JTrainingConfig(**tcfg)
    net = jcreate(case["model_name"], mcfg)
    tx = jopt.create_optimizer(tcfg) if tx is None else tx
    state = JTrainState.create(init["params"], init["batch_stats"], tx)
    mesh = jmesh.create_mesh(jax.devices()[:devices], model_parallelism=model, dcn_parallelism=dcn)
    repl = jmesh.replicated_sharding(mesh)
    if model > 1:
        state = state.replace(params=jmesh.shard_params(state.params, mesh, min_size=min_size),
                              batch_stats=jax.device_put(state.batch_stats, repl),
                              opt_state=jmesh.shard_params(state.opt_state, mesh, min_size=min_size),
                              step=jax.device_put(state.step, repl))
    else:
        state = jax.device_put(state, repl)
    step = jax.jit(jstep.make_train_step(net, jlosses.CrossEntropyLoss(), tcfg, mcfg, case["frame_features"]))
    key = jax.device_put(jax.random.key(0), repl)
    losses, preds = [], None
    for b in batches:
        b = jmesh.pad_batch_to_multiple(b, devices)
        state, m = step(state, jmesh.shard_batch(b, mesh), key)
        losses.append(float(m["loss"]))
        preds = np.asarray(m["predictions"])
    tree = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return np.asarray(losses), flat(tree), preds


def assert_state_close(got_npz, want_flat, rtol=RTOL, atol=ATOL, prefixes=("params/", "batch_stats/")):
    """Every ``params/…`` and ``batch_stats/…`` leaf of a worker's state
    against the JAX tree's (a bf16 leaf, stored as its bits, widened)."""
    names = [k for k in want_flat if k.startswith(prefixes)]
    assert names
    for name in names:
        got = got_npz[f"state/{name}"]
        got = bf16_bits_to_f32(got) if got.dtype == np.uint16 else got
        np.testing.assert_allclose(got, np.asarray(want_flat[name], np.float32), rtol=rtol, atol=atol,
                                   err_msg=name)


def jax_eval(case, init, batch, devices=1, model=1, min_size=MIN_SIZE, top_k=5):
    """The JAX eval step of the eval CLI (sampling key fold_in(key(0), 3))
    on a mesh → predictions, loss and partials."""
    mcfg = JModelConfig(**case["mcfg"])
    net = jcreate(case["model_name"], mcfg)
    mesh = jmesh.create_mesh(jax.devices()[:devices], model_parallelism=model)
    repl = jmesh.replicated_sharding(mesh)
    params = (jmesh.shard_params(init["params"], mesh, min_size=min_size) if model > 1
              else jax.device_put(init["params"], repl))
    stats = jax.device_put(init["batch_stats"], repl)
    fn = jax.jit(jstep.make_eval_step(net, jlosses.CrossEntropyLoss(), mcfg, case["frame_features"], top_k=top_k))
    b = jmesh.pad_batch_to_multiple(batch, devices)
    return fn(params, stats, jmesh.shard_batch(b, mesh), jax.random.fold_in(jax.random.key(0), 3))


def out_dir(tmp_path_factory, name):
    path = str(tmp_path_factory.mktemp(name))
    os.makedirs(path, exist_ok=True)
    return path
