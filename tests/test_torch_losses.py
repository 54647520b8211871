"""The port's losses (losses.py) ≡ the JAX package's on the same
predictions and labels at 1e-6, an all-zero label row included, and each
by name through ``--label_loss``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnablepoolingmethods_tpu import losses as jlosses
from learnablepoolingmethods_torch import losses

NAMES = ["CrossEntropyLoss", "HingeLoss", "SoftmaxLoss"]


def _inputs(seed, b=6, v=40):
    rng = np.random.default_rng(seed)
    predictions = rng.uniform(0.0, 1.0, size=(b, v)).astype(np.float32)
    labels = (rng.uniform(size=(b, v)) < 0.1).astype(np.float32)
    labels[0] = 0.0  # a video without labels: SoftmaxLoss's row-sum floor
    labels[1, :3] = 1.0
    return predictions, labels


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_per_example_loss_matches_jax(name, seed):
    predictions, labels = _inputs(seed)
    want = np.asarray(getattr(jlosses, name)().calculate_per_example_loss(
        jnp.asarray(predictions), jnp.asarray(labels)))
    got = losses.get_loss_by_name(name).calculate_per_example_loss(
        torch.from_numpy(predictions), torch.from_numpy(labels))
    assert got.shape == (predictions.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_batch_loss_matches_jax(name):
    predictions, labels = _inputs(2)
    want = float(getattr(jlosses, name)().calculate_loss(jnp.asarray(predictions), jnp.asarray(labels)))
    got = float(losses.get_loss_by_name(name).calculate_loss(torch.from_numpy(predictions),
                                                             torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_all_zero_label_row():
    """No labels: the hinge pushes every prediction to −1 (its loss is
    Σ max(0, 1 + p)); the softmax loss is 0 (the floored row sum keeps the
    label distribution at zero instead of NaN)."""
    predictions, labels = _inputs(3)
    p, y = torch.from_numpy(predictions), torch.from_numpy(labels)
    hinge = losses.HingeLoss().calculate_per_example_loss(p, y)
    np.testing.assert_allclose(hinge[0].item(), float(np.sum(1.0 + predictions[0])), rtol=1e-6)
    assert losses.SoftmaxLoss().calculate_per_example_loss(p, y)[0].item() == 0.0


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="unknown loss"):
        losses.get_loss_by_name("FocalLoss")
