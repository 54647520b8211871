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


class HingeLoss(BaseLoss):
    """Per-class hinge loss on ±1 labels with margin ``b`` (ref:
    losses.py#HingeLoss — max(0, b − (2·label − 1)·prediction), summed over
    classes)."""

    def calculate_per_example_loss(self, predictions, labels, b=1.0, **unused_params):
        float_labels = labels.to(predictions.dtype)
        sign_labels = 2.0 * float_labels - 1.0
        return torch.sum(torch.clamp(b - sign_labels * predictions, min=0.0), dim=1)


class SoftmaxLoss(BaseLoss):
    """Softmax cross entropy against the row-normalised labels (ref:
    losses.py#SoftmaxLoss — the label row sum floored at 10e-8, a stable
    log-softmax of the predictions)."""

    def calculate_per_example_loss(self, predictions, labels, **unused_params):
        epsilon = 10e-8
        float_labels = labels.to(predictions.dtype)
        label_rowsum = torch.clamp(torch.sum(float_labels, dim=1, keepdim=True), min=epsilon)
        norm_float_labels = float_labels / label_rowsum
        log_softmax = predictions - torch.amax(predictions, dim=1, keepdim=True)
        log_softmax = log_softmax - torch.log(torch.sum(torch.exp(log_softmax), dim=1, keepdim=True))
        return -torch.sum(norm_float_labels * log_softmax, dim=1)


_LOSSES = {"CrossEntropyLoss": CrossEntropyLoss, "HingeLoss": HingeLoss, "SoftmaxLoss": SoftmaxLoss}


def get_loss_by_name(name: str) -> BaseLoss:
    """``--label_loss`` lookup."""
    if name in _LOSSES:
        return _LOSSES[name]()
    raise ValueError(f"unknown loss {name!r}; ported: {sorted(_LOSSES)}")
