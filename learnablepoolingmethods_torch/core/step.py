"""The train step (ref: core/step.py#make_train_step, single pass).

uint8 frames → presampled frames (gathered in uint8) → dequantize →
ℓ2-normalize → model forward in training mode (BN statistics updated in
place) → weighted label loss + penalty · L2 over the head kernels →
gradients → per-tensor clip → Adam.

Frames are sampled as the JAX step does under ``--presample_frames``:
``fold_in(key, step)`` → ``split`` → the first key draws floor(U·nf) per
video (``models/model_utils.py#sample_frame_features``), so both packages
pick the same frames from the same seed.  The port always samples this way;
without ``--presample_frames`` the JAX step draws from a flax-derived key
instead, which the port does not reproduce.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from learnablepoolingmethods_torch.config import ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.losses import BaseLoss
from learnablepoolingmethods_torch.models.base import compute_dtype
from learnablepoolingmethods_torch.models.model_utils import sample_frame_features
from learnablepoolingmethods_torch.ops.normalize import l2_normalize
from learnablepoolingmethods_torch.utils import prng
from learnablepoolingmethods_torch.utils.quantization import dequantize

_HEAD_KERNEL_NAMES = ("gates_kernel", "experts_kernel")


def preprocess_input(features: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(uint8 → dequantize) → ℓ2-normalize the last axis, in ``dtype``."""
    x = dequantize(features, dtype=dtype) if features.dtype == torch.uint8 else features.to(dtype)
    return l2_normalize(x, dim=-1)


def regularization_loss(
    named_params: Iterable[Tuple[str, torch.Tensor]],
    l2_penalty: float,
    all_kernels: bool = False,
    moe_l2: Optional[float] = None,
) -> torch.Tensor:
    """Slim-style L2, penalty · ½·Σ‖w‖², over the classifier-head kernels
    (the MoE gates and experts kernels at ``moe_l2``, a ``fc`` kernel at
    ``l2_penalty``), or every matrix with ``all_kernels``."""
    moe_l2 = l2_penalty if moe_l2 is None else moe_l2
    sq = 0.0
    if l2_penalty > 0 or moe_l2 > 0:
        for name, p in named_params:
            keys = name.split(".")
            if p.dim() < 2:
                continue
            if keys[-1] in _HEAD_KERNEL_NAMES:
                sq = sq + moe_l2 * torch.sum(torch.square(p.float()))
            elif all_kernels or keys[-2:] == ["fc", "kernel"]:
                sq = sq + l2_penalty * torch.sum(torch.square(p.float()))
    return 0.5 * torch.as_tensor(sq, dtype=torch.float32)


def weighted_mean(per_example: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    w = weights.float()
    return torch.sum(per_example.float() * w) / torch.clamp(torch.sum(w), min=1.0)


class TrainStep:
    """``step(state, batch, key) -> metrics``: one single-pass train step
    (ref: core/step.py#make_train_step with ``grad_accum_steps == 1``).

    ``batch`` holds tensors on the model's device: ``features`` (uint8
    ``[B, F, D]`` frames), ``num_frames``, ``labels`` and optionally
    ``weights``.  ``loss`` (the forward) and ``state.apply_gradients`` (the
    update) are separate methods so that each stage can be timed."""

    def __init__(self, loss_obj: BaseLoss, tcfg: TrainingConfig, mcfg: ModelConfig,
                 frame_features: bool):
        if tcfg.grad_accum_steps != 1:
            raise NotImplementedError("--grad_accum_steps > 1 is not ported yet: ROADMAP item 12")
        if tcfg.use_remat:
            raise NotImplementedError("--use_remat is not ported yet")
        if frame_features and not mcfg.presampled:
            raise ValueError("the train step samples frames itself: build the model with presampled=True")
        self.loss_obj, self.tcfg, self.mcfg = loss_obj, tcfg, mcfg
        self.frame_features = frame_features
        self.dtype = compute_dtype(mcfg)

    def loss(self, state: TrainState, batch: Dict[str, torch.Tensor], key: torch.Tensor):
        """Forward in training mode → (total loss, label loss, reg loss, predictions)."""
        sampling_key, _ = prng.split(prng.fold_in(key, state.step))
        features = batch["features"]
        num_frames = batch.get("num_frames") if self.frame_features else None
        if self.frame_features:
            features = sample_frame_features(features, num_frames, self.mcfg.iterations, sampling_key)
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones(features.shape[0], device=features.device)
        out = state.model(preprocess_input(features, self.dtype), num_frames, training=True)
        predictions = out["predictions"]
        per_ex = self.loss_obj.calculate_per_example_loss(predictions, batch["labels"].float())
        label_loss = weighted_mean(per_ex, weights)
        reg = regularization_loss(
            state.model.named_parameters(), self.mcfg.l2_penalty,
            all_kernels=self.mcfg.l2_reg_all_kernels, moe_l2=self.mcfg.moe_l2,
        ).to(label_loss.device)
        total = label_loss + self.tcfg.regularization_penalty * reg
        return total, label_loss, reg, predictions

    def __call__(self, state: TrainState, batch, key) -> Dict[str, torch.Tensor]:
        total, label_loss, reg, predictions = self.loss(state, batch, key)
        grads = torch.autograd.grad(total, list(state.model.parameters()))
        state.apply_gradients(grads)
        return {"loss": total.detach(), "label_loss": label_loss.detach(),
                "reg_loss": reg.detach(), "predictions": predictions.detach()}
