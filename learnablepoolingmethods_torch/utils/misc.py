"""Small host-side helpers (ref: utils.py)."""

from __future__ import annotations

from collections import deque

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Entry points default to
    ``"cuda"``; asking for CUDA on a machine without a card raises instead
    of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device=cpu) "
            "to run the plain PyTorch versions on the CPU"
        )
    return dev


def format_lines(video_ids, top_values, top_indices):
    """Kaggle CSV lines (ref: inference.py#format_lines)."""
    for vid, values, indices in zip(video_ids, top_values, top_indices):
        pairs = " ".join(
            f"{int(idx)} {float(val):.6f}" for idx, val in zip(indices, values)
        )
        yield f"{vid.decode() if isinstance(vid, bytes) else vid},{pairs}\n"


class InFlight:
    """Bounded dispatch-pipelining queue for the inference CLI.

    CUDA work is queued asynchronously; callers enqueue per-batch payloads
    (host metadata + device result tensors) and receive the OLDEST payload
    back once ``depth`` batches are in flight — blocking on device results
    only then, so host-side work overlaps device compute.  FIFO order is
    preserved.

        pipe = InFlight(depth)
        for batch in ...:
            done = pipe.add(payload)
            if done is not None: consume(done)
        for done in pipe.drain(): consume(done)
    """

    def __init__(self, depth: int):
        self._depth = max(int(depth), 1)
        self._q = deque()

    def add(self, item):
        self._q.append(item)
        if len(self._q) >= self._depth:
            return self._q.popleft()
        return None

    def drain(self):
        while self._q:
            yield self._q.popleft()
