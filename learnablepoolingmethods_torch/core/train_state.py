"""Train state (ref: core/train_state.py): step, parameters, batch statistics
and optimizer state.

PyTorch keeps parameters and BN statistics inside the model (its parameters
and buffers), so the state holds the model, the optimizer and the step.
:meth:`TrainState.state_tree` names every leaf by its path in the JAX
package's ``state_to_tree(state)`` (``step``, ``params/…``,
``batch_stats/…``, ``opt_state/…``), which is what a checkpoint stores
(``core/checkpoints.py``); ``core/weights.py#state_dict_to_flax`` gives the
flax ``{params, batch_stats}`` view.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import torch
from torch import nn

from learnablepoolingmethods_torch.config import TrainingConfig
from learnablepoolingmethods_torch.core.checkpoints import check_against
from learnablepoolingmethods_torch.core.optimizers import Optimizer, create_optimizer


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
