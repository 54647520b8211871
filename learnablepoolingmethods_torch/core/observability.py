"""Metric writing (ref: core/observability.py#MetricWriter).

TensorBoard scalars under the reference's names (``model/Eval_GAP``, ...)
through ``torch.utils.tensorboard`` when it imports, logging only
otherwise, as the JAX writer degrades when ``clu`` cannot write.  The
import happens when a writer is made, never when this module is imported.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)


class MetricWriter:
    """Scalar summary writer with the reference's naming convention."""

    def __init__(self, logdir: Optional[str]):
        self._writer = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(logdir)
            except Exception as e:  # noqa: BLE001 — degrade to logs, as the JAX writer
                log.warning("TensorBoard writer unavailable (%s); logging only", e)

    def global_step_summary(self, step: int, hit_at_one, perr, gap, loss, examples_per_sec):
        """(ref: utils.py#AddGlobalStepSummary scalar names)."""
        self.write(step, {
            "model/Training_Hit@1": hit_at_one,
            "model/Training_Perr": perr,
            "model/Training_GAP": gap,
            "model/loss": loss,
            "global_step/Examples/Second": examples_per_sec,
        })

    def epoch_summary(self, step: int, info: dict):
        """(ref: utils.py#AddEpochSummary scalar names)."""
        scalars = {
            "model/Eval_Hit@1": info["avg_hit_at_one"],
            "model/Eval_Perr": info["avg_perr"],
            "model/Eval_Loss": info["avg_loss"],
            "model/Eval_GAP": info["gap"],
        }
        if info.get("aps"):
            scalars["model/Eval_MAP"] = float(np.mean(info["aps"]))
        self.write(step, scalars)

    def write(self, step: int, scalars: dict):
        if self._writer is not None:
            for name, value in scalars.items():
                self._writer.add_scalar(name, float(value), step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
