"""Train state (ref: core/train_state.py): step, parameters, batch statistics
and optimizer state.

PyTorch keeps parameters and BN statistics inside the model (its parameters
and buffers), so the state holds the model, the optimizer and the step.
:meth:`TrainState.state_tree` names every leaf by its path in the JAX
package's ``state_to_tree(state)`` (``step``, ``params/…``,
``batch_stats/…``, ``opt_state/…``), which is what a checkpoint stores
(``core/checkpoints.py``); ``core/weights.py#state_dict_to_flax`` gives the
flax ``{params, batch_stats}`` view.

On a mesh some leaves hold this rank's columns (:meth:`TrainState.state_shards`);
a checkpoint holds them whole (:meth:`full_state_tree`), and
:meth:`load_checkpoint` keeps each rank's columns, so a checkpoint of one
process resumes on a mesh and the reverse.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import torch
from torch import nn

from learnablepoolingmethods_torch.config import TrainingConfig
from learnablepoolingmethods_torch.core.checkpoints import CheckpointManager, check_against
from learnablepoolingmethods_torch.core.optimizers import Optimizer, create_optimizer
from learnablepoolingmethods_torch.parallel.collectives import ColumnShard, column_shard, gather_last


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Optimizer

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        """One optimizer update of every parameter (in ``model.parameters()``
        order), then step + 1.  The BN statistics were updated by the
        training forward already."""
        self.tx.step(grads)
        self.step += 1

    def state_tree(self) -> Dict[str, torch.Tensor]:
        """Every leaf of the state by its JAX ``state_to_tree`` path: the
        step (an int32 scalar), the live parameters and BN statistics, and
        the optimizer's state."""
        tree = {"step": torch.tensor(self.step, dtype=torch.int32)}
        tree.update({f"params/{name.replace('.', '/')}": p for name, p in self.model.named_parameters()})
        tree.update({f"batch_stats/{name.replace('.', '/')}": b for name, b in self.model.named_buffers()})
        tree.update({f"opt_state/{name}": t for name, t in self.tx.state_tree().items()})
        return tree

    def state_shards(self) -> Dict[str, ColumnShard]:
        """The leaves of :meth:`state_tree` that hold this rank's columns of a
        split tensor, with their ColumnShard."""
        out = {f"params/{name.replace('.', '/')}": column_shard(p) for name, p in self.model.named_parameters()
               if column_shard(p) is not None}
        out.update({f"opt_state/{name}": shard for name, shard in self.tx.state_shards().items()})
        return out

    def full_state_tree(self) -> Dict[str, torch.Tensor]:
        """:meth:`state_tree` with every split leaf gathered whole over its
        model group (every rank of the group must call it)."""
        tree = self.state_tree()
        for name, shard in self.state_shards().items():
            tree[name] = gather_last(tree[name].detach(), shard.group)
        return tree

    def load_checkpoint(self, mngr: CheckpointManager, step: int) -> None:
        """Step ``step`` of ``mngr``: its leaves checked against the whole
        state's names, shapes and dtypes, loaded on the host, and each split
        leaf cut to this rank's columns."""
        shards = self.state_shards()
        like = {}
        for name, t in self.state_tree().items():
            shape = tuple(t.shape) if name not in shards else tuple(t.shape[:-1]) + (shards[name].full,)
            like[name] = torch.empty(shape, dtype=t.dtype, device="meta")
        check_against({leaf["name"]: (tuple(leaf["shape"]), leaf["dtype"])
                       for leaf in mngr.manifest(step)["leaves"]}, like)
        tree = mngr.restore(step)
        self.load_state_tree({name: t[..., shards[name].columns] if name in shards else t
                              for name, t in tree.items()})

    @torch.no_grad()
    def load_state_tree(self, tree: Mapping[str, torch.Tensor]) -> None:
        """Take every leaf of :meth:`state_tree` from ``tree`` (the same
        names, shapes and dtypes, else ValueError naming the leaf), copying
        into the live tensors."""
        live = self.state_tree()
        check_against(tree, live)
        for name, t in live.items():
            if name.startswith(("params/", "batch_stats/")):
                t.copy_(tree[name])
        self.tx.load_state_tree({name[len("opt_state/"):]: value
                                 for name, value in tree.items() if name.startswith("opt_state/")})
        self.step = int(tree["step"])

    @classmethod
    def create(cls, model: nn.Module, cfg: TrainingConfig) -> "TrainState":
        return cls(step=0, model=model, tx=create_optimizer(model.named_parameters(), cfg))
