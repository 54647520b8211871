"""Metric writing and trace capture (ref: core/observability.py).

``MetricWriter``: TensorBoard scalars under the reference's names
(``model/Eval_GAP``, ...) through ``torch.utils.tensorboard`` when it
imports, logging only otherwise, as the JAX writer degrades when ``clu``
cannot write.  The import happens when a writer is made, never when this
module is imported.  ``profile_session``: the train CLI's
``--profile_dir``, a ``torch.profiler`` trace of the enclosed work.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
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


@contextlib.contextmanager
def profile_session(profile_dir: Optional[str]):
    """Trace the enclosed work with ``torch.profiler`` (host and, where a
    card is present, CUDA activity: every kernel the process launches,
    those of the ctypes-loaded libraries included) and write it to
    ``<profile_dir>/<host>_<pid>_<ms>.pt.trace.json`` (Chrome trace).  Yields
    the trace's path; a no-op yielding None when ``profile_dir`` is empty."""
    if not profile_dir:
        yield None
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{os.uname().nodename}_{os.getpid()}_{int(time.time() * 1e3)}.pt.trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
