"""Evaluation partials on the device (ref: ops/metrics_ops.py).

The reference accumulates every metric in host NumPy per batch
(``metrics/eval_util.py#EvaluationMetrics``).  ``--fast_eval`` computes the
per-batch work on the device instead (top-k selection, Hit@1, PERR) and
hands the host small ``[B, k]`` arrays, pooled once per epoch by
``metrics/eval_util.py#StreamingGAP``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from learnablepoolingmethods_torch.ops.topk import top_k_exact

# PERR is exact while no video carries more labels than this (YT-8M videos
# carry about 20 at most; the reference sorts the whole row)
PERR_MAX_LABELS = 256


class BatchMetricPartials(NamedTuple):
    topk_scores: torch.Tensor    # [B, k] float32, padding rows -inf
    topk_labels: torch.Tensor    # [B, k] float32, the labels at those classes
    num_positives: torch.Tensor  # scalar float32 (weighted)
    hit_at_one_sum: torch.Tensor  # scalar float32 (weighted sum over the batch)
    perr_sum: torch.Tensor       # scalar float32 (weighted sum over the batch)
    weight_sum: torch.Tensor     # scalar float32


def batch_topk_partials(
    predictions: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    top_k: int = 20,
) -> BatchMetricPartials:
    """One batch's partials: ``predictions`` [B, V] probabilities,
    ``labels`` [B, V] multi-hot, ``weights`` [B] 1 for a video and 0 for an
    end-of-data padding row.  Ties go to the lower class index, as
    ``lax.top_k`` breaks them."""
    predictions = predictions.float()
    labels = labels.float()
    b, v = predictions.shape
    weights = torch.ones(b, device=predictions.device) if weights is None else weights.float()

    k = min(top_k, v)
    topk_scores, topk_idx = top_k_exact(predictions, k)
    topk_labels = torch.gather(labels, 1, topk_idx)
    # padding rows: scores to -inf and labels to 0, so that the pooled sort
    # puts them last and they never count as positives
    real = weights[:, None] > 0
    topk_scores = torch.where(real, topk_scores, torch.full_like(topk_scores, -torch.inf))
    topk_labels = topk_labels * weights[:, None]

    num_positives = torch.sum(labels * weights[:, None])

    # Hit@1 (ref: eval_util.py#calculate_hit_at_one)
    top1 = torch.argmax(predictions, dim=1)
    hit = torch.gather(labels, 1, top1[:, None])[:, 0]
    hit_sum = torch.sum(hit * weights)

    # PERR (ref: eval_util.py#calculate_precision_at_equal_recall_rate): the
    # row's top-|labels| predictions, the true labels among them where the
    # score is > 0, over |labels|; a row without labels adds 0
    n_l = torch.sum(labels, dim=1)
    k_perr = min(v, PERR_MAX_LABELS)
    perr_scores, perr_idx = top_k_exact(predictions, k_perr)
    sorted_labels = torch.gather(labels, 1, perr_idx)
    rank = torch.arange(k_perr, device=predictions.device)[None, :]
    in_top = (rank < torch.clamp(n_l, max=float(k_perr))[:, None]).float()
    hits_in_top = torch.sum(sorted_labels * (perr_scores > 0).float() * in_top, dim=1)
    perr_row = torch.where(n_l > 0, hits_in_top / torch.clamp(n_l, min=1.0), torch.zeros_like(n_l))
    perr_sum = torch.sum(perr_row * weights)

    return BatchMetricPartials(
        topk_scores=topk_scores,
        topk_labels=topk_labels,
        num_positives=num_positives,
        hit_at_one_sum=hit_sum,
        perr_sum=perr_sum,
        weight_sum=torch.sum(weights),
    )
