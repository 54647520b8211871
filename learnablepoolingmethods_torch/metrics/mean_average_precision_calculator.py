"""Per-class mean average precision.

(ref: mean_average_precision_calculator.py#MeanAveragePrecisionCalculator —
one bounded AveragePrecisionCalculator per class, ``peek_map_at_n`` returns
the per-class AP list.)
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from learnablepoolingmethods_torch.metrics.average_precision_calculator import (
    AveragePrecisionCalculator,
)


class MeanAveragePrecisionCalculator:
    """num_class independent AP calculators, accumulated per class."""

    def __init__(self, num_class: int, top_n: Optional[int] = None):
        if not isinstance(num_class, int) or num_class <= 1:
            raise ValueError("num_class must be a positive integer.")
        self._ap_calculators: List[AveragePrecisionCalculator] = []
        self._num_class = num_class
        for _ in range(num_class):
            self._ap_calculators.append(AveragePrecisionCalculator(top_n))

    def accumulate(
        self,
        predictions: Sequence[Sequence[float]],
        actuals: Sequence[Sequence[float]],
        num_positives: Optional[Sequence[int]] = None,
    ) -> None:
        """Accumulate per-class prediction/label lists.

        ``predictions[c]`` / ``actuals[c]`` are this batch's candidate pool
        for class c (typically from the top-k-by-class scatter);
        ``num_positives[c]`` the true positive count for class c.
        """
        if num_positives is None or len(num_positives) == 0:
            num_positives = [None for _ in range(self._num_class)]
        calculators = self._ap_calculators
        for i in range(self._num_class):
            calculators[i].accumulate(predictions[i], actuals[i], num_positives[i])

    def clear(self) -> None:
        for calculator in self._ap_calculators:
            calculator.clear()

    def is_empty(self) -> bool:
        return [calc.heap_size for calc in self._ap_calculators] == [0] * self._num_class

    def peek_map_at_n(self) -> List[float]:
        """Per-class AP list at the configured pool bound."""
        return [self._ap_calculators[i].peek_ap_at_n() for i in range(self._num_class)]
