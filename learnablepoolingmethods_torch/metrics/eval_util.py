"""Batch-level evaluation metrics: Hit@1, PERR, GAP, mAP.

A NumPy copy of the JAX package's ``metrics/eval_util.py`` (ref:
eval_util.py — #calculate_hit_at_one, #calculate_precision_at_equal_recall_rate,
#calculate_gap, #top_k_by_class, #top_k_triplets, #flatten,
#EvaluationMetrics), so that the port imports nothing of that package.  The
train CLI logs GAP, Hit@1 and PERR through it, and the eval CLI accumulates
its epoch with :class:`EvaluationMetrics`, or under ``--fast_eval`` with
:class:`StreamingGAP` over the device partials of ``ops/metrics_ops.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from learnablepoolingmethods_torch.metrics import average_precision_calculator as ap_calculator
from learnablepoolingmethods_torch.metrics import mean_average_precision_calculator as map_calculator
from learnablepoolingmethods_torch.metrics.average_precision_calculator import ap_vectorized


def flatten(l):
    """Merge a list of lists into one flat list (ref: eval_util.py#flatten)."""
    return [item for sublist in l for item in sublist]


def calculate_hit_at_one(predictions: np.ndarray, actuals: np.ndarray) -> float:
    """Fraction of videos whose arg-max prediction is a true label."""
    top_prediction = np.argmax(predictions, 1)
    hits = actuals[np.arange(actuals.shape[0]), top_prediction]
    return float(np.average(hits))


def calculate_precision_at_equal_recall_rate(
    predictions: np.ndarray, actuals: np.ndarray
) -> float:
    """PERR: precision within each video's top-|labels| predictions.

    Reference semantics: for each row take the |labels| highest-scoring
    classes and count how many are true labels (only where the score is > 0),
    normalized by |labels|; average over videos.
    """
    aggregated_precision = 0.0
    num_videos = actuals.shape[0]
    for row in np.arange(num_videos):
        num_labels = int(np.sum(actuals[row]))
        if num_labels == 0:
            continue
        top_indices = np.argpartition(predictions[row], -num_labels)[-num_labels:]
        item_precision = 0.0
        for label_index in top_indices:
            if predictions[row][label_index] > 0:
                item_precision += actuals[row][label_index]
        item_precision /= top_indices.size
        aggregated_precision += item_precision
    aggregated_precision /= num_videos
    return float(aggregated_precision)


def top_k_triplets(
    predictions: np.ndarray, labels: np.ndarray, k: int = 20
) -> List[Tuple[int, float, float]]:
    """(class_index, prediction, label) for one video's top-k predictions."""
    m = len(predictions)
    k = min(k, m)
    indices = np.argpartition(predictions, -k)[-k:]
    return [(index, predictions[index], labels[index]) for index in indices]


def top_k_by_class(
    predictions: np.ndarray, labels: np.ndarray, k: int = 20
) -> Tuple[List[List[float]], List[List[float]], np.ndarray]:
    """Scatter every video's top-k triplets into per-class pools.

    Returns (out_predictions, out_labels, num_positives) where index c holds
    the pool for class c and ``num_positives[c]`` is the total positive count
    of class c in this batch (ref: eval_util.py#top_k_by_class).
    """
    if k <= 0:
        raise ValueError("k must be a positive integer.")
    k = min(k, predictions.shape[1])
    num_classes = predictions.shape[1]
    prediction_triplets = []
    for video_index in range(predictions.shape[0]):
        prediction_triplets.extend(
            top_k_triplets(predictions[video_index], labels[video_index], k)
        )
    out_predictions: List[List[float]] = [[] for _ in range(num_classes)]
    out_labels: List[List[float]] = [[] for _ in range(num_classes)]
    for triplet in prediction_triplets:
        out_predictions[triplet[0]].append(triplet[1])
        out_labels[triplet[0]].append(triplet[2])
    num_positives = np.sum(labels, 0)
    return out_predictions, out_labels, num_positives


def calculate_gap(predictions: np.ndarray, actuals: np.ndarray, top_k: int = 20) -> float:
    """Global Average Precision over the pooled per-video top-k predictions."""
    gap_calculator = ap_calculator.AveragePrecisionCalculator()
    sparse_predictions, sparse_labels, num_positives = top_k_by_class(
        predictions, actuals, top_k
    )
    gap_calculator.accumulate(
        flatten(sparse_predictions), flatten(sparse_labels), sum(num_positives)
    )
    return gap_calculator.peek_ap_at_n()


class EvaluationMetrics:
    """Epoch accumulator for Hit@1 / PERR / mAP / GAP / loss.

    Same external contract as the reference class
    (ref: eval_util.py#EvaluationMetrics.accumulate/.get/.clear).
    """

    def __init__(self, num_class: int, top_k: int):
        self.sum_hit_at_one = 0.0
        self.sum_perr = 0.0
        self.sum_loss = 0.0
        self.map_calculator = map_calculator.MeanAveragePrecisionCalculator(num_class)
        self.global_ap_calculator = ap_calculator.AveragePrecisionCalculator()
        self.top_k = top_k
        self.num_examples = 0

    def accumulate(self, predictions, labels, loss):
        predictions = np.asarray(predictions)
        labels = np.asarray(labels)
        batch_size = labels.shape[0]
        mean_hit_at_one = calculate_hit_at_one(predictions, labels)
        mean_perr = calculate_precision_at_equal_recall_rate(predictions, labels)
        mean_loss = float(np.mean(loss))

        sparse_predictions, sparse_labels, num_positives = top_k_by_class(
            predictions, labels, self.top_k
        )
        self.map_calculator.accumulate(sparse_predictions, sparse_labels, num_positives)
        self.global_ap_calculator.accumulate(
            flatten(sparse_predictions), flatten(sparse_labels), sum(num_positives)
        )

        self.num_examples += batch_size
        self.sum_hit_at_one += mean_hit_at_one * batch_size
        self.sum_perr += mean_perr * batch_size
        self.sum_loss += mean_loss * batch_size

        return {"hit_at_one": mean_hit_at_one, "perr": mean_perr, "loss": mean_loss}

    def get(self):
        if self.num_examples <= 0:
            raise ValueError("total_sample must be positive.")
        avg_hit_at_one = self.sum_hit_at_one / self.num_examples
        avg_perr = self.sum_perr / self.num_examples
        avg_loss = self.sum_loss / self.num_examples
        aps = self.map_calculator.peek_map_at_n()
        gap = self.global_ap_calculator.peek_ap_at_n()
        return {
            "avg_hit_at_one": avg_hit_at_one,
            "avg_perr": avg_perr,
            "avg_loss": avg_loss,
            "aps": aps,
            "gap": gap,
        }

    def clear(self):
        self.sum_hit_at_one = 0.0
        self.sum_perr = 0.0
        self.sum_loss = 0.0
        self.map_calculator.clear()
        self.global_ap_calculator.clear()
        self.num_examples = 0


class StreamingGAP:
    """Fast epoch GAP from on-device top-k partials.

    Consumes per-batch ``(topk_scores [B,k], topk_labels [B,k],
    num_positives scalar)`` produced by
    ``ops.metrics_ops.batch_topk_partials`` and finalizes with one global
    vectorized sort.  Equivalent to :func:`calculate_gap` pooled over the
    epoch, up to score-tie ordering.
    """

    def __init__(self):
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        self._num_positives = 0

    def accumulate(self, topk_scores, topk_labels, num_positives):
        self._scores.append(np.asarray(topk_scores).reshape(-1))
        self._labels.append(np.asarray(topk_labels).reshape(-1))
        self._num_positives += int(num_positives)

    def get(self) -> float:
        if not self._scores:
            return 0.0
        scores = np.concatenate(self._scores)
        labels = np.concatenate(self._labels)
        return ap_vectorized(scores, labels, total_num_positives=self._num_positives)

    def clear(self):
        self._scores, self._labels, self._num_positives = [], [], 0
