"""The rank mesh: data and model parallelism on ``torch.distributed`` (ref:
learnablepoolingmethods_tpu/parallel/mesh.py).

One mesh device is one process (a rank) driving one card, launched by
``torchrun``.  A JAX process owns every chip of its host, so it is a node
here: :func:`process_index` is ``RANK // LOCAL_WORLD_SIZE`` and
:func:`process_count` is ``WORLD_SIZE // LOCAL_WORLD_SIZE``.

- :func:`create_mesh` lays the ranks out in rank order as (dcn, data,
  model), the model axis innermost, and makes the data and model process
  groups; a layout that does not match the rank count raises the JAX
  package's ValueError.  The dcn axis only shards the batch further, as
  ``P(("dcn", "data"))`` does, so it folds into the data axis: a rank's data
  index is ``RANK // model``.
- Input: the ranks of an input shard read one stream, shard
  ``shard_index`` of ``num_shards`` (:attr:`Mesh.input_shard`).  An input
  shard is a node when the model axis fits in a node, else the nodes that
  one model group spans, so that the ranks of a model group always hold the
  same rows.  The shard's batch is padded to a multiple of its ranks
  (:func:`pad_batch_to_multiple`), and a rank keeps its row block
  (:meth:`Mesh.local_rows`), as ``P("data")`` places a host's batch on its
  chips.  The global batch is the shards' batches one after another, so a
  rank's rows start at global row ``data_index · rows`` (:meth:`Mesh.row_offset`).
- :func:`shard_model` splits the last (flax) axis of every parameter that
  :func:`shard_rule` picks over the model group (JAX ``shard_params``), and
  hands the data group to the model's BatchNorms.  The port keeps flax's
  layouts (a kernel is ``[in, out]``), so the rule reads the parameters'
  own shapes.

Backend: NCCL on CUDA, gloo on the CPU (:func:`distributed_init`).  A
caller that made its process group before (two ranks on one card over gloo,
which NCCL refuses) keeps it.  A single process needs no process group, and
its results are those of the single-device code.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from learnablepoolingmethods_torch.parallel.collectives import ColumnShard, all_gather
from learnablepoolingmethods_torch.utils.misc import resolve_device

DCN_AXIS = "dcn"      # across slices (here: the leading part of the data axis)
DATA_AXIS = "data"
MODEL_AXIS = "model"
MIN_SHARD_SIZE = 1 << 22


def _env(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def launch_env() -> Tuple[int, int, int, int]:
    """(RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE) of this process, as
    ``torchrun`` sets them (0, 1, 0, 1 without it)."""
    world = _env("WORLD_SIZE", 1)
    return _env("RANK", 0), world, _env("LOCAL_RANK", 0), _env("LOCAL_WORLD_SIZE", world)


def process_index() -> int:
    """This rank's node (the JAX ``process_index``)."""
    rank, _, _, local_world = launch_env()
    return rank // local_world


def process_count() -> int:
    """The number of nodes (the JAX ``process_count``)."""
    _, world, _, local_world = launch_env()
    return world // local_world


def distributed_init(device="cuda") -> torch.device:
    """This rank's device, and the process group of a ``torchrun`` launch of
    more than one rank, NCCL on CUDA and gloo on the CPU, unless one exists
    already; raises without a card when ``device`` is CUDA.  ``cuda`` means
    ``cuda:LOCAL_RANK``; an explicit ``cuda:N`` stays as it is."""
    rank, world, local_rank, _ = launch_env()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    if world > 1 and not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return dev


class Mesh:
    """The ranks as a (dcn, data, model) grid with this rank's place in it
    and its groups (module docstring).  ``data_group`` and ``model_group``
    are None when their axis has one rank."""

    def __init__(self, dcn: int, data: int, model: int, rank: int, local_world: int,
                 data_group=None, model_group=None):
        self.shape = (dcn, data, model)
        self.rank, self.world = rank, dcn * data * model
        self.data_size, self.model_size = dcn * data, model
        self.data_index, self.model_index = rank // model, rank % model
        self.data_group, self.model_group = data_group, model_group
        shard_ranks = math.lcm(max(local_world, 1), model)
        self.ranks_per_input = shard_ranks
        self.input_shard = (rank // shard_ranks, self.world // shard_ranks)
        self.blocks_per_input = shard_ranks // model
        self.block = (rank % shard_ranks) // model

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (DCN_AXIS, DATA_AXIS, MODEL_AXIS) if self.shape[0] > 1 else (DATA_AXIS, MODEL_AXIS)

    @property
    def devices(self) -> np.ndarray:
        """The ranks laid out as the mesh's axes."""
        grid = np.arange(self.world).reshape(self.shape)
        return grid if self.shape[0] > 1 else grid[0]

    def local_rows(self, n: int, accum: int = 1) -> np.ndarray:
        """The indices of this rank's rows in its input shard's batch of
        ``n`` rows (a multiple of :attr:`ranks_per_input`).  With ``accum``
        microbatches, microbatch i of the global batch is its i-th block of
        rows, as the JAX step slices it, and a rank keeps its block of each:
        its local microbatch i is then its share of global microbatch i."""
        blocks = self.blocks_per_input
        if n % (blocks * accum):
            raise ValueError(f"a batch of {n} rows does not split into {accum} microbatches "
                             f"over {blocks} row blocks")
        return np.arange(n).reshape(accum, blocks, n // (blocks * accum))[:, self.block].reshape(-1)

    def row_offset(self, rows: int) -> int:
        """The global index of this rank's first row in a (micro)batch of
        ``rows`` rows a rank."""
        return self.data_index * rows

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.devices.shape))}, rank={self.rank})"


def create_mesh(ranks: Optional[Sequence[int]] = None, data_parallelism: Optional[int] = None,
                model_parallelism: int = 1, dcn_parallelism: int = 1) -> Optional[Mesh]:
    """The mesh over ``ranks`` of the process group (all of them by default,
    or the one process without a group), as JAX's ``create_mesh`` over its
    devices; the data axis takes what the other two leave.  Every rank of
    the group must call it (it makes the groups); one outside ``ranks``
    gets None."""
    initialized = dist.is_available() and dist.is_initialized()
    if ranks is None:
        ranks = range(dist.get_world_size() if initialized else 1)
    ranks = list(ranks)
    n = len(ranks)
    if data_parallelism is None:
        data_parallelism = n // (model_parallelism * dcn_parallelism)
    if data_parallelism * model_parallelism * dcn_parallelism != n:
        raise ValueError(
            f"mesh {dcn_parallelism}x{data_parallelism}x{model_parallelism}"
            f" != {n} devices"
        )
    me = dist.get_rank() if initialized else 0
    rank = ranks.index(me) if me in ranks else None
    _, _, _, local_world = launch_env()
    model, data_size = model_parallelism, dcn_parallelism * data_parallelism
    data_group = model_group = None
    if initialized and n > 1:
        # every rank of the process group creates every group, in one order
        if data_size > 1:
            for m in range(model):
                group = dist.new_group([ranks[i] for i in range(m, n, model)])
                if rank is not None and rank % model == m:
                    data_group = group
        if model > 1:
            for d in range(data_size):
                group = dist.new_group(ranks[d * model:(d + 1) * model])
                if rank is not None and rank // model == d:
                    model_group = group
    if rank is None:
        return None
    return Mesh(dcn_parallelism, data_parallelism, model, rank, min(local_world, n), data_group, model_group)


def shard_rule(shape, model_size: int, min_size: int = MIN_SHARD_SIZE) -> bool:
    """JAX ``shard_params``'s rule: a tensor of two or more axes and at least
    ``min_size`` entries whose last axis the model axis divides."""
    shape = tuple(shape)
    return (model_size > 1 and len(shape) >= 2 and int(np.prod(shape)) >= min_size
            and shape[-1] % model_size == 0)


def shard_model(model: torch.nn.Module, mesh: Mesh, min_size: int = MIN_SHARD_SIZE) -> List[str]:
    """Give the model's BatchNorms the data group, and keep of every
    parameter that :func:`shard_rule` picks this rank's columns, marked with
    their :class:`ColumnShard`; returns the names of the split parameters.
    Call it before the optimizer is made, so that its state takes the
    shards' shapes."""
    for module in model.modules():
        if hasattr(module, "data_group"):
            module.data_group = mesh.data_group
    names = []
    for name, p in model.named_parameters():
        if shard_rule(p.shape, mesh.model_size, min_size):
            shard = ColumnShard(mesh.model_group, mesh.model_index, mesh.model_size, p.shape[-1])
            p.data = p.data[..., shard.columns].contiguous()
            p.column_shard = shard
            names.append(name)
    return names


def pad_batch_to_multiple(batch: dict, multiple: int) -> dict:
    """Zero-pad the batch axis to a multiple of ``multiple``, the padded
    rows' ``weights`` 0 and ``video_id`` b"" (ref:
    parallel/mesh.py#pad_batch_to_multiple)."""
    n = batch["features"].shape[0]
    pad = -n % multiple
    if pad == 0:
        return batch
    out = {}
    for k, v in batch.items():
        if k == "video_id":
            out[k] = list(v) + [b""] * pad
        elif hasattr(v, "shape") and v.ndim >= 1 and v.shape[0] == n:
            out[k] = np.concatenate([v, np.zeros((pad,) + v.shape[1:], dtype=v.dtype)])
        else:
            out[k] = v
    return out


def local_batch(batch: dict, mesh: Mesh, accum: int = 1) -> dict:
    """This rank's rows of its input shard's batch, padded first to a
    multiple of the shard's ranks; ``video_id`` is dropped.  A rank that
    holds the whole batch, or one row block, gets views, not copies."""
    batch = pad_batch_to_multiple(batch, mesh.ranks_per_input)
    arrays = {k: v for k, v in batch.items() if k != "video_id"}
    if mesh.blocks_per_input == 1:
        return arrays
    n = batch["features"].shape[0]
    if accum == 1:
        size = n // mesh.blocks_per_input
        rows = slice(mesh.block * size, (mesh.block + 1) * size)
    else:
        rows = mesh.local_rows(n, accum)
    return {k: v[rows] for k, v in arrays.items()}


def assemble_local_rows(t: torch.Tensor, mesh: Mesh, accum: int = 1) -> torch.Tensor:
    """The rows of this rank's input shard's batch, in its order, from each
    rank's rows ``t`` (:func:`local_batch`'s, e.g. the predictions): one
    gather over the data group (JAX ``assemble_local_rows`` reads them from
    the process's shards)."""
    if mesh.blocks_per_input == 1:
        return t
    pieces = all_gather(t, mesh.data_group)
    first = mesh.input_shard[0] * mesh.blocks_per_input
    n = t.shape[0] * mesh.blocks_per_input
    out = t.new_empty((n,) + tuple(t.shape[1:]))
    for block in range(mesh.blocks_per_input):
        rows = np.arange(n).reshape(accum, mesh.blocks_per_input, -1)[:, block].reshape(-1)
        out[torch.from_numpy(rows).to(t.device)] = pieces[first + block].to(t.device)
    return out
