"""Ranks of the PyTorch port on the CPU over gloo, for the mesh tests.

:func:`spawn` starts ``world`` processes of this script with torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT) and waits for them; each runs ``main`` on the JSON job given,
which names a function of this module and its keyword arguments.  The job
functions write their results (rank 0's, unless they say otherwise) as
``.npz`` files into the job's ``out`` directory.  The workers import the
port only, never JAX: the tests hold their results to the JAX package.

    python tests/_torch_mp.py '{"fn": "train_steps", "kw": {...}}'
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(world: int, argv, local_world=None):
    """Start ``world`` ranks of ``argv`` (a command line after the Python
    executable) with torchrun's environment; returns the Popen objects."""
    local_world = world if local_world is None else local_world
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % local_world),
                   LOCAL_WORLD_SIZE=str(local_world), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="-1")
        procs.append(subprocess.Popen([sys.executable] + list(argv), env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def wait(procs, timeout=300):
    """(returncode, stdout, stderr) of each process; all killed on a timeout."""
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    return outs


def spawn(world: int, jobs, local_world=None, timeout=300):
    """Run the ``jobs`` (a list of {"fn": name, "kw": {...}}) in order on
    ``world`` ranks of one process group; raises with a rank's output when
    one fails."""
    outs = wait(launch(world, [os.path.abspath(__file__), json.dumps(jobs)], local_world), timeout)
    for rank, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"rank {rank} failed (rc={rc})\nstdout:\n{out}\nstderr:\n{err[-6000:]}")
    return outs


# ---------------------------------------------------------------- the jobs

def _torch(batch, device="cpu"):
    import torch

    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _save(out, name, arrays):
    import numpy as np

    np.savez(os.path.join(out, f"{name}.npz"), **arrays)


def _mesh(ranks, model=1, dcn=1):
    from learnablepoolingmethods_torch.parallel import mesh as mesh_lib

    return mesh_lib.create_mesh(ranks, model_parallelism=model, dcn_parallelism=dcn)


def train_steps(out, name, model_name, mcfg, tcfg, frame_features, input_size, init, batches,
                ranks=None, model=1, dcn=1, min_size=1 << 22, checkpoint=None, restore=None,
                deterministic=False):
    """Steps of ``TrainStep`` on a mesh of ``ranks``, each rank on its rows
    of each global batch (``batches``: an .npz of ``b<i>_<key>`` arrays);
    writes the losses and the whole state tree.  ``restore``: a checkpoint
    directory to start from; ``checkpoint``: one to save into;
    ``deterministic``: FusedAdam rounds to nearest."""
    import numpy as np

    from learnablepoolingmethods_torch.config import ModelConfig, TrainingConfig
    from learnablepoolingmethods_torch.core.checkpoints import CheckpointManager, to_numpy
    from learnablepoolingmethods_torch.core.step import TrainStep
    from learnablepoolingmethods_torch.core.train_state import TrainState
    from learnablepoolingmethods_torch.core.weights import load_flax_variables, load_variables_npz
    from learnablepoolingmethods_torch.losses import CrossEntropyLoss
    from learnablepoolingmethods_torch.models import create_model
    from learnablepoolingmethods_torch.parallel import mesh as mesh_lib
    from learnablepoolingmethods_torch.utils import prng

    mesh = _mesh(ranks, model, dcn)
    if mesh is None:
        return
    mcfg, tcfg = ModelConfig(**mcfg), TrainingConfig(**tcfg)
    net = load_flax_variables(create_model(model_name, mcfg, input_size), load_variables_npz(init))
    split = mesh_lib.shard_model(net, mesh, min_size)
    state = TrainState.create(net, tcfg)
    if deterministic:
        state.tx.stochastic = False
    if restore:
        mngr = CheckpointManager(restore)
        state.load_checkpoint(mngr, mngr.latest_step())
    step = TrainStep(CrossEntropyLoss(), tcfg, mcfg, frame_features, mesh=mesh)
    data = np.load(batches)
    n = len({k.split("_")[0] for k in data.files})
    losses, preds = [], []
    for i in range(n):
        batch = {k.split("_", 1)[1]: data[k] for k in data.files if k.startswith(f"b{i}_")}
        local = mesh_lib.local_batch(batch, mesh, step.accum)
        metrics = step(state, _torch(local), prng.key(0))
        losses.append(float(metrics["loss"]))
        preds.append(mesh_lib.assemble_local_rows(metrics["predictions"], mesh, step.accum).numpy())
    tree = state.full_state_tree()
    if checkpoint and mesh.rank == 0:
        CheckpointManager(checkpoint).save(state.step, tree)
    if mesh.rank == 0:
        arrays = {f"state/{k}": to_numpy(v) for k, v in tree.items()}
        arrays.update(losses=np.asarray(losses), split=np.asarray(split, dtype=object).astype(str))
        arrays.update({f"preds{i}": p for i, p in enumerate(preds)})
        _save(out, name, arrays)


def eval_forward(out, name, model_name, mcfg, frame_features, input_size, init, batch, ranks=None,
                 model=1, min_size=1 << 22, fast=False):
    """The eval CLI's forward on a mesh (each rank its row block, the rows
    gathered) and ``eval_outputs`` on the whole batch; with ``fast`` the fast
    path of ``model_name`` (its plain kernels on the CPU)."""
    import numpy as np
    import torch

    from learnablepoolingmethods_torch.config import ModelConfig
    from learnablepoolingmethods_torch.core import step as step_lib
    from learnablepoolingmethods_torch.core.weights import (
        convert_flax_variables,
        load_flax_variables,
        load_variables_npz,
    )
    from learnablepoolingmethods_torch.losses import CrossEntropyLoss
    from learnablepoolingmethods_torch.models import create_model
    from learnablepoolingmethods_torch.ops.fast_dispatch import get_fast_path, shard_fast_params
    from learnablepoolingmethods_torch.parallel import mesh as mesh_lib
    from learnablepoolingmethods_torch.parallel.collectives import gather_rows
    from learnablepoolingmethods_torch.utils import prng

    mesh = _mesh(ranks, model)
    if mesh is None:
        return
    mcfg = ModelConfig(**mcfg)
    tree = load_variables_npz(init)
    data = dict(np.load(batch))
    batch = mesh_lib.pad_batch_to_multiple(data, mesh.ranks_per_input)
    local = _torch(mesh_lib.local_batch(batch, mesh))
    key = prng.fold_in(prng.key(0), 3)
    offset = mesh.row_offset(local["features"].shape[0])
    with torch.no_grad():
        if fast:
            path = get_fast_path(model_name)
            fp = shard_fast_params(path.prepare(convert_flax_variables(tree, mcfg, model_name), mcfg, device="cpu"),
                                   mesh, min_size)
            fn = path.build(mcfg, return_probs=True, use_kernels=False)
            preds = fn(fp, local["features"], local["num_frames"], key, row_offset=offset).float()
        else:
            net = load_flax_variables(create_model(model_name, mcfg, input_size), tree).eval()
            mesh_lib.shard_model(net, mesh, min_size)
            fwd = step_lib.inference_forward(net, mcfg, frame_features)
            preds = fwd(local["features"], local.get("num_frames"), key, offset)
    preds = gather_rows(preds, mesh.data_group)
    outs = step_lib.eval_outputs(preds, _torch({k: batch[k] for k in ("labels", "weights")}), CrossEntropyLoss(), 5)
    if mesh.rank == 0:
        p = outs["partials"]
        _save(out, name, {"predictions": preds.numpy(), "loss": outs["loss"].numpy(),
                          "topk_scores": p.topk_scores.numpy(), "topk_labels": p.topk_labels.numpy(),
                          "num_positives": np.asarray(float(p.num_positives)),
                          "hit_at_one_sum": np.asarray(float(p.hit_at_one_sum)),
                          "perr_sum": np.asarray(float(p.perr_sum))})


def collectives(out, name, seed=0):
    """The collectives' autograd on a 2-rank data mesh and a 1×2 model mesh
    of the same two ranks: each rank's forward values and gradients of a
    column-parallel product, a gathered parameter and a BatchNorm over the
    data group, written per rank."""
    import numpy as np
    import torch

    from learnablepoolingmethods_torch.models.modules import BatchNorm, matmul_param
    from learnablepoolingmethods_torch.parallel import mesh as mesh_lib
    from learnablepoolingmethods_torch.parallel.collectives import ColumnShard, all_reduce_sum, full_param

    rank = int(os.environ["RANK"])
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))       # the same rows on both
    w = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    rows = torch.from_numpy(rng.normal(size=(2, 4, 3)).astype(np.float32))  # rank r's rows: rows[r]
    data, model = _mesh(None), _mesh(None, model=2)
    out_arrays = {}
    # column-parallel product: y = x @ w, loss Σ y·c
    shard = ColumnShard(model.model_group, model.model_index, 2, 8)
    xs = x.clone().requires_grad_(True)
    ws = w[:, shard.columns].clone().requires_grad_(True)
    ws.column_shard = shard
    y = matmul_param(xs, ws, torch.float32)
    c = torch.arange(48, dtype=torch.float32).reshape(6, 8) / 48
    (y * c).sum().backward()
    out_arrays.update(mm_y=y.detach().numpy(), mm_dx=xs.grad.numpy(), mm_dw=ws.grad.numpy())
    # a gathered parameter: loss Σ (x @ full(w))²
    wf = w[:, shard.columns].clone().requires_grad_(True)
    wf.column_shard = shard
    ((x @ full_param(wf)) ** 2).sum().backward()
    out_arrays.update(full_dw=wf.grad.numpy())
    # Σ over the data group, backward summed: loss_r = (r + 1)·Σ s
    v = torch.ones(3, requires_grad=True)
    ((rank + 1) * all_reduce_sum(v * (rank + 1), data.data_group)).sum().backward()
    out_arrays.update(ar_dv=v.grad.numpy())
    # BatchNorm over the data group on rows[rank], loss Σ y·rows index
    bn = BatchNorm(3)
    mesh_lib.shard_model(bn, data)
    xr = rows[rank].clone().requires_grad_(True)
    yb = bn(xr, training=True)
    (yb * torch.arange(12, dtype=torch.float32).reshape(4, 3)).sum().backward()
    out_arrays.update(bn_y=yb.detach().numpy(), bn_dx=xr.grad.numpy(), bn_mean=bn.mean.numpy(),
                      bn_var=bn.var.numpy(), bn_dscale=bn.scale.grad.numpy())
    _save(out, f"{name}_{rank}", out_arrays)


def cli(out, name, module, argv, crash_at=0):
    """``<module>.main(argv)`` of the port (eval, inference or train); each
    rank's return value (an eval info, a row count, or the trainer's
    history and restored step, its whole state in ``<name>_<rank>.npz``) is
    written as JSON to ``<name>_<rank>.json``.  With ``crash_at`` rank 1
    SIGKILLs itself once the checkpoint of that step is in place, as a
    preempted worker dies."""
    import importlib
    import signal

    import numpy as np

    from learnablepoolingmethods_torch.core.checkpoints import to_numpy

    rank = os.environ.get("RANK", "0")
    mod = importlib.import_module(f"learnablepoolingmethods_torch.{module}")
    if crash_at and rank == "1":
        save = mod.Trainer._save

        def save_then_die(self, mngr, state):
            save(self, mngr, state)
            if state.step == crash_at:
                os.kill(os.getpid(), signal.SIGKILL)

        mod.Trainer._save = save_then_die
    result = mod.main(argv)
    if module == "train":
        _save(out, f"{name}_{rank}", {k: to_numpy(v) for k, v in result.state.full_state_tree().items()})
        result = {"history": result.history, "restored_step": result.restored_step}
    elif isinstance(result, dict):
        result = {k: (float(v) if isinstance(v, (float, np.floating)) else None) for k, v in result.items()}
    with open(os.path.join(out, f"{name}_{rank}.json"), "w") as f:
        json.dump(result, f)


def main():
    jobs = json.loads(sys.argv[1])
    import torch

    torch.set_num_threads(1)
    from learnablepoolingmethods_torch.parallel import mesh as mesh_lib

    mesh_lib.distributed_init("cpu")
    for job in jobs:
        globals()[job["fn"]](**job["kw"])
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
