"""Normalization primitives.

``l2_normalize`` reproduces ``tf.nn.l2_normalize``: ``x·rsqrt(max(Σx², ε))``
with ε = 1e-12 on the sum of squares.  ``F.normalize`` clamps the norm
instead (``x / max(‖x‖, ε)``), which differs for rows with Σx² < 1e-12.
Computed in float32 whatever the input dtype, then cast back.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, epsilon: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    square_sum = torch.sum(x32 * x32, dim=dim, keepdim=True)
    inv_norm = torch.rsqrt(torch.clamp(square_sum, min=epsilon))
    return (x32 * inv_norm).to(x.dtype)
