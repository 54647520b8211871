"""Synthetic YT-8M-format TFRecord fixtures (a copy of the JAX package's
``data/fixtures.py`` writers).

Hand-encodes ``tf.train.Example`` (video-level) and
``tf.train.SequenceExample`` (frame-level) protos, with no TF dependency,
with valid TFRecord CRC framing; ``chip_smoke.py`` and the tests write
their input with these.  The learnable writers make sets whose labels are
a linear function of the features, so that a model can fit them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from learnablepoolingmethods_torch.data.tfrecord_io import encode_varint, write_tfrecord
from learnablepoolingmethods_torch.utils.quantization import quantize_np


def _tag(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + encode_varint(len(payload)) + payload


def _feature_bytes(values: Sequence[bytes]) -> bytes:
    inner = b"".join(_len_delim(1, v) for v in values)
    return _len_delim(1, inner)  # Feature.bytes_list = 1


def _feature_floats(values: np.ndarray) -> bytes:
    packed = np.asarray(values, dtype="<f4").tobytes()
    inner = _len_delim(1, packed)  # FloatList.value packed
    return _len_delim(2, inner)  # Feature.float_list = 2


def _feature_ints(values: Sequence[int]) -> bytes:
    packed = b"".join(encode_varint(int(v)) for v in values)
    inner = _len_delim(1, packed)  # Int64List.value packed
    return _len_delim(3, inner)  # Feature.int64_list = 3


def _features_map(entries: Dict[str, bytes]) -> bytes:
    out = b""
    for key, feature in entries.items():
        entry = _len_delim(1, key.encode()) + _len_delim(2, feature)
        out += _len_delim(1, entry)
    return out


def encode_video_example(
    video_id: bytes,
    labels: Sequence[int],
    mean_rgb: np.ndarray,
    mean_audio: np.ndarray,
    feature_names: Sequence[str] = ("mean_rgb", "mean_audio"),
) -> bytes:
    """Serialized tf.train.Example in YT-8M video-level layout."""
    feats = {
        "id": _feature_bytes([video_id]),
        "labels": _feature_ints(labels),
        feature_names[0]: _feature_floats(mean_rgb),
        feature_names[1]: _feature_floats(mean_audio),
    }
    return _len_delim(1, _features_map(feats))  # Example.features = 1


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


def write_video_level_fixture(
    path: str,
    num_videos: int,
    num_classes: int = 3862,
    rgb_size: int = 1024,
    audio_size: int = 128,
    seed: int = 0,
    max_labels: int = 5,
) -> List[dict]:
    """Write a video-level TFRecord file; return the groundtruth records."""
    rng = np.random.default_rng(seed)
    truth = []
    with open(path, "wb") as f:
        for i in range(num_videos):
            vid = f"vid{seed:02d}{i:04d}".encode()
            n_labels = int(rng.integers(1, max_labels + 1))
            labels = sorted(
                rng.choice(num_classes, size=n_labels, replace=False).tolist()
            )
            rgb = rng.normal(scale=0.5, size=rgb_size).astype(np.float32)
            audio = rng.normal(scale=0.5, size=audio_size).astype(np.float32)
            write_tfrecord(f, encode_video_example(vid, labels, rgb, audio))
            truth.append(
                {"video_id": vid, "labels": labels, "mean_rgb": rgb, "mean_audio": audio}
            )
    return truth


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


def make_learnable_synthetic_video_level(
    path: str,
    num_videos: int = 256,
    num_classes: int = 32,
    rgb_size: int = 16,
    audio_size: int = 4,
    seed: int = 0,
) -> List[dict]:
    """A *learnable* tiny dataset: labels are a linear function of features.

    Class c is positive iff ``w_c · x > 0`` for a fixed random ``w`` — a
    LogisticModel can fit it, so integration tests can assert that training
    actually reduces loss / raises GAP (SURVEY.md §4 item 5).
    """
    rng = np.random.default_rng(seed)
    d = rgb_size + audio_size
    w = rng.normal(size=(d, num_classes)).astype(np.float32)
    truth = []
    with open(path, "wb") as f:
        for i in range(num_videos):
            vid = f"syn{i:05d}".encode()
            x = rng.normal(size=d).astype(np.float32)
            labels = np.nonzero(x @ w > 1.0)[0].tolist()
            write_tfrecord(
                f,
                encode_video_example(vid, labels, x[:rgb_size], x[rgb_size:]),
            )
            truth.append({"video_id": vid, "labels": labels, "x": x})
    return truth


def make_learnable_synthetic_frame_level(
    path: str,
    num_videos: int = 128,
    num_classes: int = 16,
    rgb_size: int = 10,
    audio_size: int = 2,
    max_frames: int = 8,
    seed: int = 0,
    label_threshold: float = 1.0,
    min_labels: int = 0,
    active_classes: int = 0,
) -> List[dict]:
    """Learnable frame-level dataset: every frame is a noisy copy of a
    per-video latent, labels are a linear function of the latent — so a
    frame aggregator (DBoF/NetVLAD/attention) can fit it and integration
    tests can assert training actually learns (SURVEY.md §4 item 5).

    ``label_threshold`` tunes label density: class c is positive iff
    ``z · w_c > label_threshold`` where ``z · w_c`` has std ≈ sqrt(d), so
    large vocabularies (V=3862) can get YT-8M-like sparse labels (~a few
    per video) instead of the ~50% density the default gives.
    ``min_labels`` guarantees at least that many labels per video (the
    top-scoring classes), so no video is label-free under a high threshold.
    ``active_classes`` > 0 restricts label mass to the first that-many
    classes: at V=3862 a model cannot learn ~6 scattered positives per
    video in the few dozen steps a full-shape drill can afford (measured:
    GAP stayed at chance), but all tensor shapes — vocab FC, metric
    accumulation — keep the full V while the LEARNING problem shrinks to
    the active subset.
    """
    rng = np.random.default_rng(seed)
    d = rgb_size + audio_size
    n_scored = active_classes if active_classes > 0 else num_classes
    w = rng.normal(size=(d, n_scored)).astype(np.float32)
    truth = []
    with open(path, "wb") as f:
        for i in range(num_videos):
            vid = f"fsyn{i:05d}".encode()
            z = rng.normal(size=d).astype(np.float32)
            scores = z @ w
            labels = np.nonzero(scores > label_threshold)[0].tolist()
            if len(labels) < min_labels:
                labels = sorted(
                    np.argsort(scores)[-min_labels:].tolist()
                )
            n_frames = int(rng.integers(max(2, max_frames // 2), max_frames + 1))
            frames = z[None, :] + 0.3 * rng.normal(size=(n_frames, d)).astype(
                np.float32
            )
            rgb = quantize_np(frames[:, :rgb_size])
            audio = quantize_np(frames[:, rgb_size:])
            write_tfrecord(f, encode_frame_sequence_example(vid, labels, rgb, audio))
            truth.append({"video_id": vid, "labels": labels, "z": z})
    return truth


def write_frame_level_shards(
    out_dir: str,
    num_videos: int,
    num_shards: int = 16,
    num_classes: int = 3862,
    rgb_size: int = 1024,
    audio_size: int = 128,
    max_frames: int = 300,
    min_frames: int = 10,
    seed: int = 0,
) -> List[str]:
    """A frame-level set in ``num_shards`` files of ``out_dir``, written
    fast enough for ingest measurements at hundreds of MB; returns the
    paths.  The wire format is the YT-8M layout's (framing, CRCs, the
    SequenceExample fields the readers read); each video's frames are a
    slice of one shared random pool (parse cost does not depend on the
    values)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    d = rgb_size + audio_size
    # shared entropy pool: enough rows for the largest video + stride wiggle
    pool = rng.integers(0, 256, size=(max_frames + 1024, d), dtype=np.uint8)
    pool_rows = pool.shape[0]
    n_frames_all = rng.integers(min_frames, max_frames + 1, size=num_videos)
    n_labels_all = rng.integers(1, 6, size=num_videos)
    per_shard = (num_videos + num_shards - 1) // num_shards
    paths = []
    vid_idx = 0
    for s in range(num_shards):
        path = os.path.join(
            out_dir, f"train-{s:05d}-of-{num_shards:05d}.tfrecord"
        )
        paths.append(path)
        with open(path, "wb") as f:
            for _ in range(min(per_shard, num_videos - vid_idx)):
                nf = int(n_frames_all[vid_idx])
                start = (vid_idx * 131) % (pool_rows - nf)
                frames = pool[start : start + nf]
                labels = sorted(
                    rng.choice(
                        num_classes, size=int(n_labels_all[vid_idx]),
                        replace=False,
                    ).tolist()
                )
                write_tfrecord(
                    f,
                    encode_frame_sequence_example(
                        f"scale{vid_idx:07d}".encode(),
                        labels,
                        frames[:, :rgb_size],
                        frames[:, rgb_size:],
                    ),
                )
                vid_idx += 1
    assert vid_idx == num_videos
    return paths
