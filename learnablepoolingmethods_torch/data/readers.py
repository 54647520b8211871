"""YT-8M record readers (ref: readers.py).

Host-side decode producing NumPy.  Video-level records carry one float
vector per named feature (``mean_rgb`` 1024 + ``mean_audio`` 128);
frame-level records carry per-frame uint8 features, which are **kept
quantized** on the host and padded/truncated to ``max_frames`` by
:func:`fill_frame_record` (ref: readers.py#resize_axis,
#YT8MFrameFeatureReader.prepare_serialized_examples); dequantization runs
on the device.  Uses the
TF-free wire decoder in ``data/tfrecord_io.py``.
"""

from __future__ import annotations

import glob as _glob
from typing import Dict, Iterator, Sequence

import numpy as np

from learnablepoolingmethods_torch.data import tfrecord_io


def _multi_hot(labels: Sequence[int], num_classes: int) -> np.ndarray:
    out = np.zeros(num_classes, dtype=np.float32)
    idx = [l for l in labels if 0 <= l < num_classes]
    out[idx] = 1.0
    return out


def _get_id(features: Dict[str, tfrecord_io.Feature]) -> bytes:
    for key in ("id", "video_id"):
        if key in features and features[key].bytes_list:
            return features[key].bytes_list[0]
    return b""


class BaseReader:
    """Reader contract (ref: readers.py#BaseReader.prepare_reader)."""

    def read_file(self, path: str) -> Iterator[dict]:
        raise NotImplementedError()

    def read_pattern(self, pattern: str) -> Iterator[dict]:
        files = sorted(_glob.glob(pattern))
        if not files:
            raise IOError(f"Unable to find input files. data_pattern='{pattern}'")
        for path in files:
            yield from self.read_file(path)


class YT8MAggregatedFeatureReader(BaseReader):
    """Video-level reader: one float vector per named feature, concatenated
    (ref: readers.py#YT8MAggregatedFeatureReader); a missing feature reads
    as zeros."""

    def __init__(
        self,
        num_classes: int = 3862,
        feature_sizes: Sequence[int] = (1024, 128),
        feature_names: Sequence[str] = ("mean_rgb", "mean_audio"),
    ):
        if len(feature_names) != len(feature_sizes):
            raise ValueError(
                f"length of feature_names (={len(feature_names)}) != "
                f"length of feature_sizes (={len(feature_sizes)})"
            )
        self.num_classes = num_classes
        self.feature_sizes = list(feature_sizes)
        self.feature_names = list(feature_names)

    def read_file(self, path: str) -> Iterator[dict]:
        for record in tfrecord_io.read_tfrecords(path):
            features = tfrecord_io.parse_example(record)
            parts = []
            for name, size in zip(self.feature_names, self.feature_sizes):
                feat = features.get(name)
                vec = (
                    feat.float_list
                    if feat is not None and feat.float_list is not None
                    else np.zeros(size, np.float32)
                )
                if vec.shape[0] != size:
                    raise ValueError(f"feature {name!r} has size {vec.shape[0]}, expected {size}")
                parts.append(vec.astype(np.float32))
            labels = features.get("labels")
            yield {
                "video_id": _get_id(features),
                "features": np.concatenate(parts),  # [total_size] float32
                "labels": _multi_hot(labels.int64_list if labels else (), self.num_classes),
            }


class YT8MFrameFeatureReader(BaseReader):
    """Frame-level reader: per-frame uint8 features, padded to max_frames."""

    def __init__(
        self,
        num_classes: int = 3862,
        feature_sizes: Sequence[int] = (1024, 128),
        feature_names: Sequence[str] = ("rgb", "audio"),
        max_frames: int = 300,
    ):
        if len(feature_names) != len(feature_sizes):
            raise ValueError(
                f"length of feature_names (={len(feature_names)}) != "
                f"length of feature_sizes (={len(feature_sizes)})"
            )
        self.num_classes = num_classes
        self.feature_sizes = list(feature_sizes)
        self.feature_names = list(feature_names)
        self.max_frames = max_frames

    def read_file(self, path: str) -> Iterator[dict]:
        for record in tfrecord_io.read_tfrecords(path):
            frames = np.zeros((self.max_frames, sum(self.feature_sizes)), np.uint8)
            context, num_frames = fill_frame_record(frames, record, self.feature_names, self.feature_sizes)
            labels = context.get("labels")
            yield {
                "video_id": _get_id(context),
                "features": frames,  # [max_frames, total_size] uint8
                "num_frames": np.int32(num_frames),
                "labels": _multi_hot(
                    labels.int64_list if labels else (), self.num_classes
                ),
            }


def fill_frame_record(frames: np.ndarray, record: bytes, feature_names: Sequence[str],
                      feature_sizes: Sequence[int]):
    """Write one serialized frame-level record's frames into ``frames``
    (uint8 [max_frames, ΣD], zeros on entry), each feature list cut to
    ``max_frames`` (a missing one reads as no frames); returns (context,
    num_frames), ``num_frames`` the least frame count of the features,
    capped at ``max_frames`` (ref: readers.py
    #YT8MFrameFeatureReader.prepare_serialized_examples).  The caller
    allocates ``frames``: a batch's parser writes its records into one
    array."""
    max_frames = frames.shape[0]
    context, feature_lists = tfrecord_io.parse_sequence_example_lists(record)
    num_frames, col = None, 0
    for name, size in zip(feature_names, feature_sizes):
        feats = feature_lists.get(name, b"")
        mat = tfrecord_io.feature_list_frames(feats) if len(feats) else np.zeros((0, size), np.uint8)
        if mat.shape[1] != size:
            raise ValueError(f"feature_list {name!r} frame size {mat.shape[1]}, expected {size}")
        # the reference asserts equal lengths across modalities
        num_frames = mat.shape[0] if num_frames is None else min(num_frames, mat.shape[0])
        rows = min(mat.shape[0], max_frames)
        frames[:rows, col:col + size] = mat[:rows]
        col += size
    return context, int(min(num_frames or 0, max_frames))


def make_reader(fcfg, num_classes: int) -> BaseReader:
    """The reader of a ``config.FeatureConfig``: frame-level or video-level
    (ref: flags.py#make_reader)."""
    if fcfg.frame_features:
        return YT8MFrameFeatureReader(
            num_classes=num_classes,
            feature_sizes=fcfg.feature_sizes,
            feature_names=fcfg.feature_names,
            max_frames=fcfg.max_frames,
        )
    return YT8MAggregatedFeatureReader(
        num_classes=num_classes,
        feature_sizes=fcfg.feature_sizes,
        feature_names=fcfg.feature_names,
    )
