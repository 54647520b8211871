"""Train state (ref: core/train_state.py): step, parameters, batch statistics
and optimizer state.

PyTorch keeps parameters and BN statistics inside the model (its parameters
and buffers), so the state holds the model, the optimizer and the step;
``core/weights.py#state_dict_to_flax`` gives the flax ``{params,
batch_stats}`` view.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from learnablepoolingmethods_torch.config import TrainingConfig
from learnablepoolingmethods_torch.core.optimizers import Adam, create_optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Adam

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        """One optimizer update of every parameter (in ``model.parameters()``
        order), then step + 1.  The BN statistics were updated by the
        training forward already."""
        self.tx.step(grads)
        self.step += 1

    @classmethod
    def create(cls, model: nn.Module, cfg: TrainingConfig) -> "TrainState":
        return cls(step=0, model=model, tx=create_optimizer(model.parameters(), cfg))
