"""Packed array cache: TFRecords parsed once into memmappable arrays
(ref: data/packed_cache.py).

Parsing a record costs a fraction of a millisecond on a host core; after a
one-time conversion into flat arrays every later epoch is a memcpy out of
the page cache:

    features.npy        uint8  [N, max_frames, D]   (memmapped; float32 [N, D] video-level)
    num_frames.npy      int32  [N]                  (frame-level only)
    video_ids.npy       bytes  [N] (fixed-width S)
    label_indices.npy   int32  [nnz]   ┐ CSR multi-hot (the dense [N, V]
    label_offsets.npy   int64  [N+1]   ┘  matrix is made per batch)
    meta.json           shapes, feature config, the sources' fingerprint

The files and ``meta.json``'s keys are the reference's, so either package
reads a cache that the other built.  Build offline::

    python -m learnablepoolingmethods_torch.data.packed_cache \\
        --input_pattern='/data/train*.tfrecord' --output_dir=/cache --frame_features

or at first use through ``--packed_cache_dir`` in the train, eval and
inference CLIs.  The build parses with the C++ reader
(``data/native_loader.py``) and raises if it does not build.
"""

from __future__ import annotations

import glob as _glob
import json
import mmap
import os
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

_META = "meta.json"
# rows are written back to the page cache and dropped from this process's
# resident set every this many bytes of the features memmap
_RECLAIM_BYTES = 256 << 20
_PARSE_CHUNK = 256


def _fingerprint(files) -> list:
    return [[os.path.basename(f), os.path.getsize(f)] for f in sorted(files)]


def is_fresh(output_dir: str, data_pattern: str) -> bool:
    """True when a complete cache with a matching source fingerprint exists."""
    meta_path = os.path.join(output_dir, _META)
    if not os.path.exists(meta_path):
        return False
    files = sorted(_glob.glob(data_pattern))
    with open(meta_path) as f:
        return json.load(f).get("fingerprint") == _fingerprint(files)


def wait_for_cache(output_dir: str, data_pattern: str, timeout_s: float = 1800.0) -> str:
    """Block until another process finishes building the cache (with
    several processes only the first builds: two builders writing one
    directory corrupt the arrays)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if is_fresh(output_dir, data_pattern):
            return output_dir
        time.sleep(2.0)
    raise TimeoutError(f"packed cache at {output_dir} not built within {timeout_s:.0f}s")


def build_cache(
    data_pattern: str,
    output_dir: str,
    frame_level: bool,
    feature_sizes: Sequence[int] = (1024, 128),
    feature_names: Optional[Sequence[str]] = None,
    num_classes: int = 3862,
    max_frames: int = 300,
    num_workers: int = 8,
) -> str:
    """Parse every record once and write the packed arrays.  Idempotent:
    an existing cache with a matching source fingerprint is reused."""
    from learnablepoolingmethods_torch.data import native_loader, pipeline

    files = sorted(_glob.glob(data_pattern))
    if not files:
        raise IOError(f"Unable to find input files. data_pattern='{data_pattern}'")
    fp = _fingerprint(files)
    if is_fresh(output_dir, data_pattern):
        return output_dir
    if feature_names is None:
        feature_names = ("rgb", "audio") if frame_level else ("mean_rgb", "mean_audio")
    os.makedirs(output_dir, exist_ok=True)

    # two passes: count the records (framing only), then stream chunked
    # parses straight into a disk-backed memmap, so peak memory is a few
    # chunks, not the data set
    n_total = sum(native_loader.count_records(f) for f in files)
    total_dim = int(sum(feature_sizes))
    feat_shape = (n_total, int(max_frames), total_dim) if frame_level else (n_total, total_dim)
    features = np.lib.format.open_memmap(
        os.path.join(output_dir, "features.npy"), mode="w+",
        dtype=np.uint8 if frame_level else np.float32, shape=feat_shape,
    )
    num_frames = np.zeros(n_total, np.int32) if frame_level else None
    ids: list = []
    label_idx, label_off = [], [0]
    row = last_reclaim = 0
    row_bytes = int(np.prod(feat_shape[1:])) * features.dtype.itemsize
    reclaim_every_rows = max(1, _RECLAIM_BYTES // max(row_bytes, 1))
    for batch in pipeline.native_batch_iterator(
        data_pattern, batch_size=_PARSE_CHUNK, frame_level=frame_level,
        feature_sizes=feature_sizes, feature_names=feature_names, num_classes=num_classes,
        max_frames=max_frames, num_epochs=1, shuffle=False, num_workers=num_workers,
        pad_final_batch=False,
        # peak memory (num_workers + 1) × 256 padded rows, whatever the
        # size of a shard or of the data set
        chunk_records=_PARSE_CHUNK,
    ):
        b = batch["features"].shape[0]
        features[row:row + b] = batch["features"]
        if frame_level:
            num_frames[row:row + b] = batch["num_frames"]
        ids.extend(batch["video_id"])
        for lab in batch["labels"]:
            nz = np.nonzero(lab > 0)[0].astype(np.int32)
            label_idx.append(nz)
            label_off.append(label_off[-1] + len(nz))
        row += b
        if row - last_reclaim >= reclaim_every_rows:
            # Dirty pages of a shared file mapping count against this
            # process's resident set until written back.  MADV_DONTNEED
            # drops this process's mappings only: the dirty pages stay in
            # the page cache and the kernel's writeback persists them.
            features._mmap.madvise(mmap.MADV_DONTNEED)
            last_reclaim = row
    if row != n_total:
        raise IOError(f"record count drifted: counted {n_total}, read {row}")
    features.flush()
    del features

    if frame_level:
        np.save(os.path.join(output_dir, "num_frames.npy"), num_frames)
    width = max((len(v) for v in ids), default=1)
    np.save(os.path.join(output_dir, "video_ids.npy"), np.array(ids, dtype=f"S{width}"))
    np.save(os.path.join(output_dir, "label_indices.npy"),
            np.concatenate(label_idx) if label_idx else np.zeros(0, np.int32))
    np.save(os.path.join(output_dir, "label_offsets.npy"), np.asarray(label_off, np.int64))
    meta = {
        "fingerprint": fp,
        "num_examples": int(n_total),
        "frame_level": frame_level,
        "num_classes": int(num_classes),
        "feature_sizes": list(feature_sizes),
        "feature_names": list(feature_names),
        "max_frames": int(max_frames),
    }
    # meta.json last: its presence, with a matching fingerprint, marks the
    # cache complete for readers and for processes waiting on it
    with open(os.path.join(output_dir, _META), "w") as f:
        json.dump(meta, f)
    return output_dir


class PackedCache:
    """Memmapped view over a built cache."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, _META)) as f:
            self.meta = json.load(f)
        self.features = np.load(os.path.join(cache_dir, "features.npy"), mmap_mode="r")
        self.frame_level = bool(self.meta["frame_level"])
        self.num_frames = (np.load(os.path.join(cache_dir, "num_frames.npy"))
                           if self.frame_level else None)
        self.video_ids = np.load(os.path.join(cache_dir, "video_ids.npy"))
        self.label_indices = np.load(os.path.join(cache_dir, "label_indices.npy"))
        self.label_offsets = np.load(os.path.join(cache_dir, "label_offsets.npy"))
        self.num_classes = int(self.meta["num_classes"])

    def __len__(self) -> int:
        return int(self.meta["num_examples"])

    def dense_labels(self, sel: np.ndarray) -> np.ndarray:
        """The multi-hot rows of the examples ``sel``, in one scatter."""
        off = self.label_offsets
        counts = (off[sel + 1] - off[sel]).astype(np.int64)
        out = np.zeros((len(sel), self.num_classes), np.float32)
        if counts.sum() == 0:
            return out
        # each row's run of label indices: its start repeated, plus a ramp
        starts = np.repeat(off[sel], counts)
        ramp = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts)
        rows = np.repeat(np.arange(len(sel), dtype=np.int64), counts)
        out[rows, self.label_indices[starts + ramp]] = 1.0
        return out


def packed_batch_iterator(
    cache_dir: str,
    batch_size: int,
    num_epochs: Optional[int] = 1,
    shuffle: bool = False,
    seed: int = 0,
    pad_final_batch: bool = True,
    shard_index: int = 0,
    num_shards: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Batches straight out of the memmap, in ``data/pipeline.py``'s schema.
    In order unless ``shuffle`` (a permutation per epoch from
    ``np.random.default_rng(seed)``, as the reference draws it); shard
    ``shard_index`` of ``num_shards`` takes every ``num_shards``-th row.
    Each epoch's last batch is padded to ``batch_size`` with weight 0 rows
    under ``pad_final_batch``."""
    cache = PackedCache(cache_dir)
    indices_all = np.arange(len(cache))[shard_index::num_shards]
    rng = np.random.default_rng(seed)

    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = rng.permutation(indices_all) if shuffle else indices_all
        for start in range(0, len(order), batch_size):
            sel = order[start:start + batch_size]
            if len(sel) > 1 and bool(np.all(np.diff(sel) == 1)):
                # an ascending run: one slice of the memmap (matching
                # endpoints alone would not do: [5, 99, 7])
                feats = np.asarray(cache.features[sel[0]:sel[-1] + 1])
            else:
                feats = np.asarray(cache.features[sel])
            ids = [bytes(v) for v in cache.video_ids[sel]]
            labels = cache.dense_labels(sel)
            b = len(sel)
            weights = np.ones(batch_size if pad_final_batch else b, np.float32)
            pad = batch_size - b if pad_final_batch else 0
            if pad > 0:
                feats = np.concatenate([feats, np.zeros((pad,) + feats.shape[1:], feats.dtype)])
                labels = np.concatenate([labels, np.zeros((pad, labels.shape[1]), labels.dtype)])
                ids = ids + [b""] * pad
                weights[b:] = 0.0
            out = {"features": feats, "labels": labels, "weights": weights, "video_id": ids}
            if cache.frame_level:
                nf = cache.num_frames[sel]
                if pad > 0:
                    nf = np.concatenate([nf, np.zeros(pad, np.int32)])
                out["num_frames"] = nf
            yield out
        epoch += 1


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input_pattern", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--frame_features", action="store_true")
    ap.add_argument("--feature_sizes", default="1024,128")
    ap.add_argument("--feature_names", default="")
    ap.add_argument("--num_classes", type=int, default=3862)
    ap.add_argument("--max_frames", type=int, default=300)
    ap.add_argument("--num_workers", type=int, default=8)
    args = ap.parse_args(argv)
    out = build_cache(
        args.input_pattern, args.output_dir, frame_level=args.frame_features,
        feature_sizes=tuple(int(x) for x in args.feature_sizes.split(",")),
        feature_names=tuple(x for x in args.feature_names.split(",") if x) or None,
        num_classes=args.num_classes, max_frames=args.max_frames, num_workers=args.num_workers,
    )
    with open(os.path.join(out, _META)) as f:
        print(json.dumps(json.load(f)))


if __name__ == "__main__":
    main()
