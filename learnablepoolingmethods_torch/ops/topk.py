"""Exact top-k over wide score rows (ref: inference.py#inference top_k)."""

from __future__ import annotations

from typing import Tuple

import torch

# a float type → the signed integer type of its width
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32, torch.float16: torch.int16,
         torch.bfloat16: torch.int16}


def total_order_key(scores: torch.Tensor) -> torch.Tensor:
    """The float total order as a signed integer of the same width: the
    bits, with every bit but the sign flipped where the sign is set, so
    −NaN < −inf < … < −0 < +0 < … < +inf < +NaN, and NaNs by payload.
    Integer scores are their own key."""
    if not scores.is_floating_point():
        return scores
    bits = scores.view(_BITS[scores.dtype])
    return torch.where(bits < 0, bits ^ torch.iinfo(bits.dtype).max, bits)


def top_k_exact(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, sorted descending: (values, indices),
    in ``jax.lax.top_k``'s order: the float total order (+NaN above +inf,
    +0 above −0, −NaN last), the lowest index first among equal bits (a
    stable descending sort of :func:`total_order_key`).  The values are
    gathered from ``scores``, so they come back bit for bit, NaN payloads
    included."""
    _, indices = torch.sort(total_order_key(scores), dim=-1, descending=True, stable=True)
    indices = indices[..., :k]
    return torch.gather(scores, -1, indices), indices
