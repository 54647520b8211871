"""Exact top-k over wide score rows (ref: inference.py#inference top_k)."""

from __future__ import annotations

from typing import Tuple

import torch


def top_k_exact(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, sorted descending: (values, indices).

    Values equal those of ``jax.lax.top_k``.  Among exactly tied scores
    ``torch.topk`` does not promise the lowest index first, as
    ``lax.top_k`` does, so the indices of ties may be ordered otherwise.
    """
    values, indices = torch.topk(scores, k, dim=-1, largest=True, sorted=True)
    return values, indices
