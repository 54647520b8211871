"""Optimizer and learning-rate schedule (ref: core/optimizers.py).

- :func:`clip_gradient_norms` clips each gradient tensor's norm on its own
  (``tf.clip_by_norm`` per tensor), not the global norm that
  ``torch.nn.utils.clip_grad_norm_`` takes.
- :func:`learning_rate_schedule` is ``optax.exponential_decay`` in steps:
  base · decay^(count / ⌊decay_examples / batch_size⌋), the first update at
  count 0.
- :class:`Adam` is ``optax.chain(clip, optax.adam(schedule))`` at optax's
  defaults (b1 0.9, b2 0.999, ε 1e-8 outside the square root), in f32.

The JAX package's other optimizers, ``--adam_bf16_momentum``,
``--bf16_params`` (fp32 master) and ``--fused_adam`` are not ported yet
(ROADMAP item 12) and raise.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Sequence

import numpy as np
import torch

from learnablepoolingmethods_torch.config import TrainingConfig


def clip_gradient_norms(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """Per-tensor clip: g · min(1, max_norm / max(‖g‖, 1e-20)), ‖g‖ in f32."""
    out = []
    for g in grads:
        norm = torch.sqrt(torch.sum(torch.square(g.float())))
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-20), max=1.0)
        out.append((g * scale).to(g.dtype))
    return out


def learning_rate_schedule(cfg: TrainingConfig) -> Callable[[int], float]:
    """lr(count) = base · decay^(count / transition_steps) in f32, with
    transition_steps = max(⌊decay_examples / batch_size⌋, 1)."""
    transition_steps = max(int(cfg.learning_rate_decay_examples / max(cfg.batch_size, 1)), 1)
    base = np.float32(cfg.base_learning_rate)
    decay = np.float32(cfg.learning_rate_decay)

    def schedule(count: int) -> float:
        if count <= 0:
            return float(base)
        return float(base * np.power(decay, np.float32(count) / np.float32(transition_steps)))

    return schedule


class Adam:
    """optax-default Adam after per-tensor clipping, on a list of parameters.

    State: ``count`` and the f32 moments ``mu``, ``nu`` (one per parameter,
    updated in place).  ``step(params, grads)`` applies one update:
    mu ← (1−b1)·g + b1·mu; nu ← (1−b2)·g² + b2·nu; p ← p − lr(count)·m̂/(√v̂ + ε),
    with m̂ = mu/(1−b1^(count+1)) and v̂ likewise."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Iterable[torch.Tensor], cfg: TrainingConfig):
        self.params = list(params)
        self.clip_norm = cfg.clip_gradient_norm
        self.schedule = learning_rate_schedule(cfg)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        if self.clip_norm > 0:
            grads = clip_gradient_norms(grads, self.clip_norm)
        lr = self.schedule(self.count)
        count = np.float32(self.count + 1)
        c1 = float(np.float32(1) - np.float32(self.b1) ** count)
        c2 = float(np.float32(1) - np.float32(self.b2) ** count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.float()
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(update * -lr)
        self.count += 1


def create_optimizer(params: Iterable[torch.Tensor], cfg: TrainingConfig) -> Adam:
    if cfg.optimizer != "AdamOptimizer":
        raise NotImplementedError(f"--optimizer={cfg.optimizer} is not ported yet: ROADMAP item 12")
    for flag in ("adam_bf16_momentum", "fp32_master", "fused_adam"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"--{flag} is not ported yet: ROADMAP item 12")
    return Adam(params, cfg)
