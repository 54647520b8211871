"""Host input pipeline: record streams → fixed-shape NumPy batches.

A deterministic generator replaces the reference's queue runners
(ref: train.py#get_input_data_tensors): file-order shuffle per epoch, a
bounded shuffle buffer and fixed-size batching.  The final partial batch is
zero-padded and carries a per-example ``weights`` mask (1 real, 0 padding).
Frame features stay uint8 through this stage; dequantization happens on the
device.  ``native_batch_iterator`` slices the same batches out of the C++
reader's packed arrays (``data/native_loader.py``).
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
    shard_index: int = 0,
    num_shards: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batches: {video_id, features, labels, (num_frames), weights}.

    ``weights`` is 1.0 for real examples, 0.0 for end-of-data padding rows.
    ``num_epochs=None`` streams forever.  ``shard_index``/``num_shards``
    read one file-level shard of ``num_shards`` (one per process).
    """
    files = shard_files(data_pattern, shard_index, num_shards)
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


def shard_files(data_pattern: str, shard_index: int = 0, num_shards: int = 1) -> list:
    """The sorted files of ``data_pattern``, every ``num_shards``-th from
    ``shard_index``; IOError when there are none."""
    files = sorted(_glob.glob(data_pattern))
    if not files:
        raise IOError(f"Unable to find input files. data_pattern='{data_pattern}'")
    if num_shards > 1:
        files = files[shard_index::num_shards]
        if not files:
            raise IOError(f"shard {shard_index}/{num_shards} got no files "
                          "(pattern matched fewer files than shards)")
    return files


def native_batch_iterator(
    data_pattern: str,
    batch_size: int,
    frame_level: bool,
    feature_sizes=(1024, 128),
    feature_names=None,
    num_classes: int = 3862,
    max_frames: int = 300,
    num_epochs: Optional[int] = 1,
    shuffle: bool = False,
    seed: int = 0,
    num_workers: int = 8,
    pad_final_batch: bool = True,
    shard_index: int = 0,
    num_shards: int = 1,
    chunk_records: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Batches sliced out of the C++ reader's packed arrays
    (``data/native_loader.py``; ref: data/pipeline.py#native_batch_iterator).

    Files are parsed on ``num_workers`` threads (``--num_readers``); with
    ``shuffle`` the file order is permuted each epoch and the records of
    each parse are permuted, both from ``np.random.default_rng(seed)`` in
    the reference's order, so a seed gives the reference's batches.
    ``chunk_records > 0`` parses each file in chunks of that many records,
    bounding peak memory whatever a file's size (the packed cache's build);
    a parse's permutation then covers a chunk.  Raises when the library
    does not build: unlike the reference, it never falls back to the
    Python reader.
    """
    from learnablepoolingmethods_torch.data import native_loader

    if feature_names is None:
        feature_names = ("rgb", "audio") if frame_level else ("mean_rgb", "mean_audio")
    files = shard_files(data_pattern, shard_index, num_shards)
    kwargs = dict(feature_sizes=tuple(feature_sizes), feature_names=tuple(feature_names),
                  num_classes=num_classes)
    if frame_level:
        kwargs["max_frames"] = max_frames
    rng = np.random.default_rng(seed)

    epoch = 0
    pending: list = []
    while num_epochs is None or epoch < num_epochs:
        epoch_files = list(files)
        if shuffle:
            rng.shuffle(epoch_files)
        for out in native_loader.parse_files_parallel(
            epoch_files, frame_level=frame_level, num_workers=num_workers,
            chunk_records=chunk_records, **kwargs
        ):
            n = out["features"].shape[0]
            order = rng.permutation(n) if shuffle else np.arange(n)
            for i in order:
                rec = {"video_id": out["video_id"][i], "features": out["features"][i],
                       "labels": out["labels"][i]}
                if frame_level:
                    rec["num_frames"] = out["num_frames"][i]
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
