"""Synthetic YT-8M-format frame-level TFRecord fixtures.

Hand-encodes ``tf.train.SequenceExample`` protos (no TF dependency) with
valid TFRecord CRC framing; ``chip_smoke.py`` and the tests write their
input with these.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from learnablepoolingmethods_torch.data.tfrecord_io import write_tfrecord
from learnablepoolingmethods_torch.utils.quantization import quantize_np


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _feature_bytes(values: Sequence[bytes]) -> bytes:
    inner = b"".join(_len_delim(1, v) for v in values)
    return _len_delim(1, inner)  # Feature.bytes_list = 1


def _feature_ints(values: Sequence[int]) -> bytes:
    packed = b"".join(_varint(int(v)) for v in values)
    inner = _len_delim(1, packed)  # Int64List.value packed
    return _len_delim(3, inner)  # Feature.int64_list = 3


def _features_map(entries: Dict[str, bytes]) -> bytes:
    out = b""
    for key, feature in entries.items():
        entry = _len_delim(1, key.encode()) + _len_delim(2, feature)
        out += _len_delim(1, entry)
    return out


def encode_frame_sequence_example(
    video_id: bytes,
    labels: Sequence[int],
    rgb_frames: np.ndarray,  # [F, 1024] uint8
    audio_frames: np.ndarray,  # [F, 128] uint8
    feature_names: Sequence[str] = ("rgb", "audio"),
) -> bytes:
    """Serialized tf.train.SequenceExample in YT-8M frame-level layout."""
    context = _features_map(
        {"id": _feature_bytes([video_id]), "labels": _feature_ints(labels)}
    )
    fl_entries = b""
    for name, mat in ((feature_names[0], rgb_frames), (feature_names[1], audio_frames)):
        feature_list = b"".join(
            _len_delim(1, _feature_bytes([row.tobytes()])) for row in np.asarray(mat, np.uint8)
        )
        entry = _len_delim(1, name.encode()) + _len_delim(2, feature_list)
        fl_entries += _len_delim(1, entry)
    return _len_delim(1, context) + _len_delim(2, fl_entries)


def write_frame_level_fixture(
    path: str,
    num_videos: int,
    num_classes: int = 3862,
    rgb_size: int = 1024,
    audio_size: int = 128,
    max_frames: int = 300,
    seed: int = 0,
    max_labels: int = 5,
) -> List[dict]:
    """Write a frame-level TFRecord file with uint8-quantized features;
    each video has a uniform 1..max_frames frame count.  Returns the
    groundtruth records."""
    rng = np.random.default_rng(seed)
    truth = []
    with open(path, "wb") as f:
        for i in range(num_videos):
            vid = f"vid{seed:02d}{i:04d}".encode()
            n_labels = int(rng.integers(1, max_labels + 1))
            labels = sorted(
                rng.choice(num_classes, size=n_labels, replace=False).tolist()
            )
            n_frames = int(rng.integers(1, max_frames + 1))
            rgb = quantize_np(rng.normal(scale=0.7, size=(n_frames, rgb_size)))
            audio = quantize_np(rng.normal(scale=0.7, size=(n_frames, audio_size)))
            write_tfrecord(
                f, encode_frame_sequence_example(vid, labels, rgb, audio)
            )
            truth.append(
                {
                    "video_id": vid,
                    "labels": labels,
                    "rgb": rgb,
                    "audio": audio,
                    "num_frames": n_frames,
                }
            )
    return truth
