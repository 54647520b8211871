"""Exact top-k over wide score rows (ref: inference.py#inference top_k)."""

from __future__ import annotations

from typing import Tuple

import torch


def top_k_exact(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, sorted descending: (values, indices),
    as ``jax.lax.top_k``: among exactly tied scores the lowest index comes
    first (a stable descending sort keeps the index order of ties)."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
