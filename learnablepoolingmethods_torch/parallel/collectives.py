"""The collectives of the sharded steps, as the port's own autograd
functions over ``torch.distributed`` process groups.

A group of ``None`` is a group of one rank: every function then returns its
input unchanged and communicates nothing, so a one-rank mesh runs the
single-device arithmetic.  A CUDA tensor under a gloo group, which a
caller makes itself for two ranks that share one card (NCCL refuses that),
goes through the host for each collective.

- :func:`all_reduce_sum`: Σ over the group, whose backward sums the
  cotangents over the group too.  It is the data axis's reduction: each
  rank's loss depends on the sum, so each rank's input gets the sum of every
  rank's cotangent (the batch statistics of ``models/modules.py#BatchNorm``).
- :func:`full_param`: the whole of a column-sharded matrix, gathered along
  its last axis, whose backward keeps this rank's columns of the cotangent:
  the ranks of a model group hold the same rows, so their cotangents of the
  full matrix agree.
- ``models/modules.py#matmul_param`` is the column-parallel product.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ColumnShard:
    """Columns ``[index·n, (index+1)·n)`` of a matrix's last axis of
    ``full`` = ``size``·n entries, held by the rank at ``index`` of its model
    ``group`` (None: a group of one)."""

    group: Optional[object]
    index: int
    size: int
    full: int

    @property
    def width(self) -> int:
        return self.full // self.size

    @property
    def columns(self) -> slice:
        return slice(self.index * self.width, (self.index + 1) * self.width)


def column_shard(t) -> Optional[ColumnShard]:
    """The :class:`ColumnShard` a tensor carries, or None for a whole one."""
    return getattr(t, "column_shard", None)


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Σ of ``t`` over ``group``, in place; returns ``t``."""
    if group is None:
        return t
    if _through_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape on each), in the group's rank order."""
    if group is None:
        return [t]
    src = t.detach().contiguous()
    host = _through_host(src, group)
    if host:
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if host else out


def gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ``t`` side by side along the last axis."""
    return t if group is None else torch.cat(all_gather(t, group), dim=-1)


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ``t`` one under another along the first axis."""
    return t if group is None else torch.cat(all_gather(t, group), dim=0)


def barrier() -> None:
    """Every rank waits for the others; nothing without a process group."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a process
    group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable Σ over ``group`` whose backward all-reduces (module
    docstring)."""
    return x if group is None else _AllReduceSum.apply(x, group)


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, shard):
        ctx.shard = shard
        return gather_last(w, shard.group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.shard.columns].contiguous(), None


def full_param(w: torch.Tensor) -> torch.Tensor:
    """``w`` itself, or the whole matrix of a column shard (module
    docstring)."""
    shard = column_shard(w)
    return w if shard is None else _GatherColumns.apply(w, shard)


def sum_sharded(values: Sequence[torch.Tensor], sharded: Sequence[bool], group) -> List[torch.Tensor]:
    """``values`` (scalars or equal-shaped tensors, one a leaf), where each
    ``sharded`` one is replaced by its Σ over ``group`` (the ranks' partial
    sums of a column-sharded leaf) in one all-reduce; the others as they
    are."""
    idx = [i for i, s in enumerate(sharded) if s]
    if group is None or not idx:
        return list(values)
    stacked = all_reduce_(torch.stack([values[i].detach().float() for i in idx]), group)
    out = list(values)
    for j, i in enumerate(idx):
        out[i] = stacked[j].to(values[i].dtype)
    return out
