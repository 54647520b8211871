"""``--use_grain``: a random-access TFRecord source behind a
``torch.utils.data.DataLoader`` that yields grain's batches
(ref: data/grain_pipeline.py).

The reference feeds ``grain.python.DataLoader`` with an ``IndexSampler``
(per-epoch global shuffle, ``ShardByJaxProcess``), a ``Batch`` operation
and ``worker_count`` worker processes.  grain is not a dependency of the
port; this module gives the same batches in the same order from torch's
DataLoader:

- ``TFRecordRandomAccessSource``: a map-style ``Dataset`` that seeks
  straight to a record through an offset index (one framing-only scan per
  file) and returns NumPy records;
- ``grain_record_keys``: the record each position of grain's sampler reads.
  Epoch e of a shuffled sampler is grain's ``index_shuffle`` permutation
  with seed ``(seed + e) % 2**32`` (``dataset/transformations/shuffle.py``),
  a Simon cipher whose round keys come from ``std::seed_seq``, transcribed
  below from grain's C++;
- ``GrainOrderBatchSampler``: grain's batches in grain's order.  With ``w``
  workers grain gives worker ``k`` positions ``k, k + w, ...``, batches
  each worker's records by themselves and returns the workers' batches in
  turn; torch's DataLoader returns its batch sampler's batches in order,
  whichever worker read them.
"""

from __future__ import annotations

import glob as _glob
import itertools
import math
import struct
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils.data

from learnablepoolingmethods_torch.data import tfrecord_io
from learnablepoolingmethods_torch.data.readers import _get_id, _multi_hot, fill_frame_record

_U64 = struct.Struct("<Q")
_MASK32 = 0xFFFFFFFF
# grain's shuffle: 4 rounds, blocks of at least 16 bits
_ROUNDS = 4
_MIN_BLOCK_BITS = 16


def build_offset_index(path: str) -> List[Tuple[int, int]]:
    """One framing-only pass → [(offset, length), ...] per record."""
    index = []
    with open(path, "rb") as f:
        pos = 0
        while True:
            header = f.read(12)
            if len(header) < 12:
                return index
            (length,) = _U64.unpack_from(header, 0)
            index.append((pos + 12, int(length)))
            pos += 12 + length + 4
            f.seek(pos)


class TFRecordRandomAccessSource(torch.utils.data.Dataset):
    """Map-style dataset over a set of TFRecord files: item ``i`` is the
    ``i``-th record of the sorted files as a dict of NumPy values
    (``data/readers.py``' records).  File handles are per thread and are
    not pickled, so worker processes open their own."""

    def __init__(
        self,
        data_pattern: str,
        frame_level: bool,
        feature_sizes: Sequence[int] = (1024, 128),
        feature_names: Optional[Sequence[str]] = None,
        num_classes: int = 3862,
        max_frames: int = 300,
    ):
        files = sorted(_glob.glob(data_pattern))
        if not files:
            raise IOError(f"Unable to find input files. data_pattern='{data_pattern}'")
        self._files = files
        self._frame_level = frame_level
        self._feature_sizes = list(feature_sizes)
        self._feature_names = list(
            feature_names or (("rgb", "audio") if frame_level else ("mean_rgb", "mean_audio")))
        self._num_classes = num_classes
        self._max_frames = max_frames
        self._index: List[Tuple[int, int, int]] = [  # (file index, offset, length)
            (fi, off, ln) for fi, path in enumerate(files) for off, ln in build_offset_index(path)]
        self._local = threading.local()

    def __len__(self) -> int:
        return len(self._index)

    def _read_raw(self, i: int) -> bytes:
        fi, off, ln = self._index[i]
        handles = getattr(self._local, "handles", None)
        if handles is None:
            handles = self._local.handles = {}
        fh = handles.get(fi)
        if fh is None:
            fh = handles[fi] = open(self._files[fi], "rb")
        fh.seek(off)
        return fh.read(ln)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        record = self._read_raw(int(i))
        if self._frame_level:
            frames = np.zeros((self._max_frames, sum(self._feature_sizes)), np.uint8)
            context, nf = fill_frame_record(frames, record, self._feature_names, self._feature_sizes)
            labels = context.get("labels")
            return {"video_id": _get_id(context), "features": frames, "num_frames": np.int32(nf),
                    "labels": _multi_hot(labels.int64_list if labels else (), self._num_classes)}
        fmap = tfrecord_io.parse_example(record)
        parts = [
            np.asarray(fmap[name].float_list, np.float32)
            if name in fmap and fmap[name].float_list is not None else np.zeros(size, np.float32)
            for name, size in zip(self._feature_names, self._feature_sizes)
        ]
        labels = fmap.get("labels")
        return {"video_id": _get_id(fmap), "features": np.concatenate(parts),
                "labels": _multi_hot(labels.int64_list if labels else (), self._num_classes)}

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_local", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local = threading.local()


# Copyright 2023 Google LLC, Apache License 2.0 (grain,
# grain/_src/python/experimental/index_shuffle/index_shuffle.cc): the
# permutation of grain's index_shuffle, transcribed into Python.
def _seed_seq(seeds: Sequence[int], n: int) -> List[int]:
    """``std::seed_seq(seeds).generate`` of ``n`` 32-bit words (C++11
    [rand.util.seedseq])."""
    out = [0x8B8B8B8B] * n
    s = len(seeds)
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)
    for k in range(m):
        x = out[k % n] ^ out[(k + p) % n] ^ out[(k - 1) % n]
        r1 = (1664525 * (x ^ (x >> 27))) & _MASK32
        r2 = (r1 + (s if k == 0 else (k % n + seeds[k - 1]) if k <= s else k % n)) & _MASK32
        out[(k + p) % n] = (out[(k + p) % n] + r1) & _MASK32
        out[(k + q) % n] = (out[(k + q) % n] + r2) & _MASK32
        out[k % n] = r2
    for k in range(m, m + n):
        x = (out[k % n] + out[(k + p) % n] + out[(k - 1) % n]) & _MASK32
        r3 = (1566083941 * (x ^ (x >> 27))) & _MASK32
        r4 = (r3 - k % n) & _MASK32
        out[(k + p) % n] ^= r3
        out[(k + q) % n] ^= r4
        out[k % n] = r4
    return out


def index_shuffle_permutation(n: int, seed: int) -> List[int]:
    """``[index_shuffle(i, max_index=n - 1, seed, rounds=4) for i < n]``:
    a Simon cipher on a block of ``ceil(log2(n - 1))`` bits (even, at
    least 16), walked until it lands in ``[0, n)``."""
    max_index = n - 1
    if max_index <= 0:
        return [0] * n
    bits = math.ceil(math.log2(max_index))
    w = max(bits + bits % 2, _MIN_BLOCK_BITS) // 2
    mask = (1 << w) - 1
    keys = [k & mask for k in _seed_seq([seed & _MASK32], _ROUNDS)]

    def rotl(x: int, r: int) -> int:
        return ((x << r) | (x >> (w - r))) & mask

    def f(x: int) -> int:
        return (rotl(x, 1) & rotl(x, 8)) ^ rotl(x, 2)

    def encrypt(v: int) -> int:
        left, right = v >> w, v & mask
        for i in range(0, _ROUNDS, 2):
            left ^= f(right) ^ keys[i]
            right ^= f(left) ^ keys[i + 1]
        return (left << w) | right

    out = []
    for i in range(n):
        v = encrypt(i)
        while v > max_index:
            v = encrypt(v)
        out.append(v)
    return out


def even_split(num_records: int, shard_index: int, num_shards: int) -> Tuple[int, int]:
    """[start, end) of shard ``shard_index`` (grain's ``even_split``,
    remainder kept: the first shards take one record more)."""
    per = num_records // num_shards
    extra = num_records % num_shards
    return (per * shard_index + min(shard_index, extra), per * (shard_index + 1) + min(shard_index + 1, extra))


def grain_record_keys(num_records: int, num_epochs: Optional[int], shuffle: bool, seed: int,
                      shard_index: int = 0, num_shards: int = 1) -> Iterator[int]:
    """The record each position of grain's ``IndexSampler(num_records,
    ShardOptions(shard_index, num_shards, drop_remainder=False), shuffle,
    num_epochs, seed)`` reads in this shard's ``DataLoader``, in order;
    endless for ``num_epochs`` None."""
    start, end = even_split(num_records, shard_index, num_shards)
    m = end - start
    total = None if num_epochs is None else num_epochs * num_records // num_shards
    positions = itertools.count() if total is None else range(total)
    perm, perm_epoch = None, None
    for pos in positions:
        epoch, i = divmod(pos, m)
        if shuffle and epoch != perm_epoch:
            perm, perm_epoch = index_shuffle_permutation(m, (seed + epoch) % 2 ** 32), epoch
        yield start + (perm[i] if shuffle else i)


class GrainOrderBatchSampler(torch.utils.data.Sampler):
    """The index lists of grain's ``Batch(batch_size, drop_remainder=False)``
    batches over ``keys`` (an iterable of record keys) with ``workers``
    worker processes, in the order grain's DataLoader returns them."""

    def __init__(self, keys_fn, batch_size: int, workers: int):
        self._keys_fn = keys_fn
        self._batch_size = batch_size
        self._workers = max(workers, 1)

    def __iter__(self) -> Iterator[List[int]]:
        w = self._workers
        per_worker = [itertools.islice(self._keys_fn(), k, None, w) for k in range(w)]
        batches = [iter(lambda it=it: list(itertools.islice(it, self._batch_size)), []) for it in per_worker]
        # each worker's batch in turn; the workers that run out are the last
        # ones, in the last turn
        for turn in itertools.zip_longest(*batches):
            for batch in turn:
                if batch is not None:
                    yield batch


def collate_records(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack records into a batch, ``video_id`` a list.  The arrays are
    tensors on the CPU, which a worker process hands over through shared
    memory (a NumPy array would be pickled through a pipe)."""
    out = {k: torch.from_numpy(np.stack([r[k] for r in records])) for k in records[0] if k != "video_id"}
    out["video_id"] = [r["video_id"] for r in records]
    return out


def grain_batch_iterator(
    data_pattern: str,
    batch_size: int,
    frame_level: bool,
    num_epochs: Optional[int] = 1,
    shuffle: bool = False,
    seed: int = 0,
    worker_count: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    **source_kwargs,
) -> Iterator[Dict[str, Any]]:
    """The reference's ``grain_batch_iterator`` batches
    {features, labels, (num_frames), weights, video_id} from a torch
    DataLoader with ``worker_count`` worker processes; the last batch is
    short, not padded.  ``shard_index``/``num_shards``: this process's share
    (``ShardByJaxProcess``)."""
    source = TFRecordRandomAccessSource(data_pattern, frame_level, **source_kwargs)
    n = len(source)

    def keys():
        return grain_record_keys(n, num_epochs, shuffle, seed, shard_index, num_shards)

    # The workers are forked from a process that may already hold a CUDA
    # context (the train CLI initialises the card first); they read and
    # parse records into NumPy and never touch torch.cuda, which is what a
    # forked child may do.
    loader = torch.utils.data.DataLoader(
        source, batch_sampler=GrainOrderBatchSampler(keys, batch_size, worker_count),
        num_workers=worker_count, collate_fn=collate_records)
    for batch in loader:
        out = {k: batch[k].numpy() for k in ("features", "labels") + (("num_frames",) if frame_level else ())}
        out["weights"] = np.ones(out["labels"].shape[0], np.float32)
        out["video_id"] = batch["video_id"]
        yield out
