"""Streaming average precision with a bounded top-n pool.

Behavioral twin of the reference calculator
(ref: average_precision_calculator.py#AveragePrecisionCalculator —
``accumulate`` / ``peek_ap_at_n`` / ``ap`` / ``ap_at_n`` with a heap-bounded
candidate pool).  Tie-breaking matters for GAP parity at the 1e-3 level, so
the deterministic pre-sort shuffle (stdlib ``random`` seeded with 0) is
reproduced exactly; given identical prediction/label streams this class
returns bit-identical AP values to the reference.

A vectorized NumPy path (:func:`ap_vectorized`) computes one global sort
instead of streaming Python heaps.  This module is a copy of the JAX
package's ``metrics/average_precision_calculator.py`` (it imports no JAX).
"""

from __future__ import annotations

import heapq
import random
from typing import Optional, Sequence

import numpy as np


class AveragePrecisionCalculator:
    """Calculates average precision over a (possibly bounded) candidate pool."""

    def __init__(self, top_n: Optional[int] = None):
        if not ((isinstance(top_n, int) and top_n > 0) or top_n is None):
            raise ValueError("top_n must be a positive integer or None.")
        self._top_n = top_n
        self._total_positives = 0
        self._heap = []  # min-heap of (prediction, actual)

    @property
    def heap_size(self) -> int:
        return len(self._heap)

    @property
    def num_accumulated_positives(self) -> int:
        return self._total_positives

    def accumulate(
        self,
        predictions: Sequence[float],
        actuals: Sequence[float],
        num_positives: Optional[int] = None,
    ) -> None:
        """Add a batch of (prediction, groundtruth) pairs to the pool.

        ``num_positives``, when given, overrides positive counting — used by
        GAP where the top-k pool hides below-threshold positives.
        """
        if len(predictions) != len(actuals):
            raise ValueError("the shape of predictions and actuals does not match.")
        if num_positives is not None:
            if not np.isscalar(num_positives) or num_positives < 0:
                raise ValueError("'num_positives' was provided but it was a negative number.")
            self._total_positives += num_positives
        else:
            self._total_positives += np.size(np.nonzero(np.asarray(actuals) > 0))

        topn = self._top_n
        heap = self._heap
        for i in range(len(predictions)):
            if topn is None or len(heap) < topn:
                heapq.heappush(heap, (predictions[i], actuals[i]))
            else:
                heapq.heappushpop(heap, (predictions[i], actuals[i]))

    def clear(self) -> None:
        self._heap = []
        self._total_positives = 0

    def peek_ap_at_n(self) -> float:
        """AP of the current pool without mutating accumulator state."""
        if self.heap_size <= 0:
            return 0.0
        predlists = np.array(list(zip(*self._heap)))
        ap = self.ap_at_n(
            predlists[0],
            predlists[1],
            n=self._top_n,
            total_num_positives=self._total_positives,
        )
        return ap

    @staticmethod
    def ap(predictions, actuals) -> float:
        """Plain average precision (no pool bound)."""
        return AveragePrecisionCalculator.ap_at_n(predictions, actuals, n=None)

    @staticmethod
    def ap_at_n(
        predictions,
        actuals,
        n: Optional[int] = 20,
        total_num_positives: Optional[int] = None,
    ) -> float:
        """AP@n with the reference's exact tie-break and recall-cap semantics."""
        if len(predictions) != len(actuals):
            raise ValueError("the shape of predictions and actuals does not match.")
        if n is not None:
            if not isinstance(n, int) or n <= 0:
                raise ValueError("n must be 'None' or a positive integer. It was '%s'." % n)

        ap = 0.0
        predictions = np.asarray(predictions)
        actuals = np.asarray(actuals)

        # Deterministic shuffle before the (stable) sort so ties break in a
        # fixed pseudo-random order — bit-compat with the reference.
        predictions, actuals = AveragePrecisionCalculator._shuffle(predictions, actuals)
        sortidx = sorted(range(len(predictions)), key=lambda k: predictions[k], reverse=True)

        if total_num_positives is None:
            numpos = np.size(np.nonzero(actuals > 0))
        else:
            numpos = total_num_positives
        if numpos == 0:
            return 0.0
        if n is not None:
            numpos = min(numpos, n)
        delta_recall = 1.0 / numpos

        poscount = 0.0
        r = len(sortidx)
        if n is not None:
            r = min(r, n)
        for i in range(r):
            if actuals[sortidx[i]] > 0:
                poscount += 1
                ap += poscount / (i + 1) * delta_recall
        return ap

    @staticmethod
    def _shuffle(predictions, actuals):
        # A LOCAL Random(0): bit-identical sample sequence to the
        # reference's random.seed(0) + random.sample (same Mersenne
        # Twister), without resetting the process-global random state on
        # every AP computation (review finding).
        suffidx = random.Random(0).sample(range(len(predictions)), len(predictions))
        predictions = predictions[suffidx]
        actuals = actuals[suffidx]
        return predictions, actuals

    @staticmethod
    def _zero_one_normalize(predictions, epsilon: float = 1e-7):
        """Min-max normalize scores to [0, 1] (ref helper; not used by AP)."""
        denominator = np.max(predictions) - np.min(predictions)
        ret = (predictions - np.min(predictions)) / np.maximum(denominator, epsilon)
        return ret


def ap_vectorized(
    predictions: np.ndarray,
    actuals: np.ndarray,
    total_num_positives: Optional[int] = None,
    shuffle: bool = True,
) -> float:
    """One-shot vectorized AP over a flat pool (no heap, no Python loop).

    Matches :meth:`AveragePrecisionCalculator.ap_at_n` with ``n=None``; used
    by the fast epoch finalizer where the pool is already top-k-bounded on
    device.  O(N log N) sort, all NumPy.

    ``shuffle`` applies the reference's deterministic seed-0 tie shuffle
    before the stable sort — without it, a stable sort systematically favors
    pool order among tied scores, which was measured to bias GAP by >1e-3 on
    tie-heavy (quantized) inputs (tests/unit/test_metrics.py tie-break
    bound tests).
    """
    predictions = np.asarray(predictions, dtype=np.float64)
    actuals = np.asarray(actuals)
    if total_num_positives is None:
        numpos = int(np.count_nonzero(actuals > 0))
    else:
        numpos = int(total_num_positives)
    if numpos == 0 or predictions.size == 0:
        return 0.0
    if shuffle:
        predictions, actuals = AveragePrecisionCalculator._shuffle(
            predictions, actuals
        )
    order = np.argsort(-predictions, kind="stable")
    hits = (actuals[order] > 0).astype(np.float64)
    poscount = np.cumsum(hits)
    precision_at_i = poscount / np.arange(1, len(hits) + 1, dtype=np.float64)
    return float(np.sum(precision_at_i * hits) / numpos)
