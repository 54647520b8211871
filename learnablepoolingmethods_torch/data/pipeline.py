"""Host input pipeline: record streams → fixed-shape NumPy batches.

A deterministic generator replaces the reference's queue runners
(ref: train.py#get_input_data_tensors): file-order shuffle per epoch, a
bounded shuffle buffer and fixed-size batching.  The final partial batch is
zero-padded and carries a per-example ``weights`` mask (1 real, 0 padding).
Frame features stay uint8 through this stage; dequantization happens on the
device.
"""

from __future__ import annotations

import glob as _glob
import random
from typing import Dict, Iterator, Optional

import numpy as np

from learnablepoolingmethods_torch.data.readers import BaseReader


def _shuffled_records(
    reader: BaseReader,
    files,
    shuffle: bool,
    buffer_size: int,
    rng: random.Random,
) -> Iterator[dict]:
    if not shuffle:
        for path in files:
            yield from reader.read_file(path)
        return
    buf = []
    for path in files:
        for rec in reader.read_file(path):
            buf.append(rec)
            if len(buf) >= buffer_size:
                idx = rng.randrange(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def batch_iterator(
    reader: BaseReader,
    data_pattern: str,
    batch_size: int,
    num_epochs: Optional[int] = 1,
    shuffle: bool = False,
    shuffle_buffer: int = 1024,
    seed: int = 0,
    pad_final_batch: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batches: {video_id, features, labels, (num_frames), weights}.

    ``weights`` is 1.0 for real examples, 0.0 for end-of-data padding rows.
    ``num_epochs=None`` streams forever.
    """
    files = sorted(_glob.glob(data_pattern))
    if not files:
        raise IOError(f"Unable to find input files. data_pattern='{data_pattern}'")
    rng = random.Random(seed)

    epoch = 0
    pending = []
    while num_epochs is None or epoch < num_epochs:
        epoch_files = list(files)
        if shuffle:
            rng.shuffle(epoch_files)
        for rec in _shuffled_records(reader, epoch_files, shuffle, shuffle_buffer, rng):
            pending.append(rec)
            if len(pending) == batch_size:
                yield _collate(pending, pad_to=None)
                pending = []
        epoch += 1

    if pending:
        yield _collate(pending, pad_to=batch_size if pad_final_batch else None)


def _collate(records, pad_to: Optional[int]) -> Dict[str, np.ndarray]:
    n = len(records)
    total = pad_to or n
    sample = records[0]

    out: Dict[str, np.ndarray] = {}
    feat = np.stack([r["features"] for r in records])
    labels = np.stack([r["labels"] for r in records])
    weights = np.ones(total, np.float32)
    if total > n:
        feat = np.concatenate(
            [feat, np.zeros((total - n,) + feat.shape[1:], feat.dtype)]
        )
        labels = np.concatenate(
            [labels, np.zeros((total - n,) + labels.shape[1:], labels.dtype)]
        )
        weights[n:] = 0.0
    out["features"] = feat
    out["labels"] = labels
    out["weights"] = weights
    out["video_id"] = [r["video_id"] for r in records] + [b""] * (total - n)
    if "num_frames" in sample:
        nf = np.asarray([r["num_frames"] for r in records], np.int32)
        if total > n:
            nf = np.concatenate([nf, np.zeros(total - n, np.int32)])
        out["num_frames"] = nf
    return out
