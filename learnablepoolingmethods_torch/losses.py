"""Multi-label classification losses (ref: losses.py).

Each loss takes post-activation predictions in [0, 1] and a dense multi-hot
label matrix; ``calculate_per_example_loss`` returns the class-summed loss
per video ``[B]``, and ``calculate_loss`` its batch mean.  Selected by name
through ``--label_loss`` (:func:`get_loss_by_name`).
"""

from __future__ import annotations

import torch


class BaseLoss:
    """Loss contract (ref: losses.py#BaseLoss.calculate_loss)."""

    def calculate_per_example_loss(self, predictions, labels, **params):
        raise NotImplementedError()

    def calculate_loss(self, predictions, labels, **params):
        return torch.mean(self.calculate_per_example_loss(predictions, labels, **params))


class CrossEntropyLoss(BaseLoss):
    """Epsilon-clipped multi-label sigmoid cross entropy (ref:
    losses.py#CrossEntropyLoss — epsilon 10e-6, sum over classes)."""

    def calculate_per_example_loss(self, predictions, labels, **unused_params):
        epsilon = 10e-6
        float_labels = labels.to(predictions.dtype)
        cross_entropy_loss = float_labels * torch.log(predictions + epsilon) + (
            1.0 - float_labels
        ) * torch.log(1.0 - predictions + epsilon)
        return torch.sum(-cross_entropy_loss, dim=1)


_LOSSES = {"CrossEntropyLoss": CrossEntropyLoss}


def get_loss_by_name(name: str) -> BaseLoss:
    """``--label_loss`` lookup.  HingeLoss and SoftmaxLoss of the JAX package
    are not ported yet and raise."""
    if name in _LOSSES:
        return _LOSSES[name]()
    if name in ("HingeLoss", "SoftmaxLoss"):
        raise NotImplementedError(
            f"--label_loss={name} is not ported yet: ROADMAP item 12 (ported: {sorted(_LOSSES)})")
    raise ValueError(f"unknown loss {name!r}; ported: {sorted(_LOSSES)}")
