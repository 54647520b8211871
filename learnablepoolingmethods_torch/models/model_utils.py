"""Frame sampling and pooling (ref: models/model_utils.py).

iid frames (``--sample_random_frames``, the default) are floor(U·min(
num_frames, F)) clamped to F−1, one U per sample; a random window
(``--nosample_random_frames``) starts at floor(U·(max(nf − S, 0) + 1)), one
U per video, and runs S frames, clamped to the last valid frame.  U is drawn
by ``utils/prng.py`` exactly as ``jax.random.uniform`` draws it, so the port
picks the frames the JAX package picks from the same key.  Rows are
gathered by index (``ops/fused_frontend.py#gather_frames``), where the JAX
package multiplies by a one-hot matrix on the TPU (``gather_frames_u8`` for
uint8 rows); both are exact.
"""

from __future__ import annotations

import torch

from learnablepoolingmethods_torch.ops.fused_frontend import (
    gather_frames,
    sample_indices,
    sequence_indices,
)


def sample_frame_features(features, num_frames, num_samples: int, key, row_offset: int = 0) -> torch.Tensor:
    """iid frame sampling on a feature tensor ``[B, F, D]`` of any dtype →
    ``[B, num_samples, D]``: the train step's presampling of uint8 frames and
    the model's own sampling of float frames, bit for bit those of
    ``model_utils.py#sample_frame_features`` and ``#sample_random_frames``
    under the same key.  ``row_offset``: the global index of the first row
    (``ops/fused_frontend.py#sample_indices``)."""
    return gather_frames(features, sample_indices(key, num_frames, features.shape[1], num_samples, row_offset))


def sample_random_sequence(features, num_frames, num_samples: int, key, row_offset: int = 0) -> torch.Tensor:
    """A random window of ``num_samples`` frames a video from ``[B, F, D]``
    features of any dtype, bit for bit that of
    ``model_utils.py#sample_random_sequence`` under the same key."""
    return gather_frames(features, sequence_indices(key, num_frames, features.shape[1], num_samples, row_offset))


def sample_model_input(features, num_frames, num_samples: int, key, random_frames: bool = True,
                       row_offset: int = 0):
    """A sampling model's frames: iid (:func:`sample_frame_features`) with
    ``random_frames`` (``--sample_random_frames``), else one random window
    (:func:`sample_random_sequence`); ``row_offset`` is the global index of
    the first row."""
    sample = sample_frame_features if random_frames else sample_random_sequence
    return sample(features, num_frames, num_samples, key, row_offset)


def frame_pooling(frames: torch.Tensor, method: str) -> torch.Tensor:
    """Pool ``[B, F, D]`` over the frame axis (ref: model_utils.py#FramePooling):
    ``"average"`` or ``"max"``."""
    if method == "average":
        return torch.mean(frames, dim=1)
    if method == "max":
        return torch.amax(frames, dim=1)
    raise ValueError(f"Unrecognized pooling method: {method}")


def frame_mask(num_frames: torch.Tensor, max_frames: int, dtype=torch.float32) -> torch.Tensor:
    """``[B, F]`` validity mask from per-video frame counts."""
    positions = torch.arange(max_frames, device=num_frames.device)[None, :]
    return (positions < num_frames.reshape(-1, 1)).to(dtype)
