"""Frame sampling (ref: models/model_utils.py).

Indices are floor(U·min(num_frames, F)) clamped to F−1, with U drawn by
``utils/prng.py`` exactly as ``jax.random.uniform`` draws it, so the port
picks the frames the JAX package picks from the same key.  Rows are
gathered by index (``ops/fused_frontend.py#gather_frames``), where the JAX
package multiplies by a one-hot matrix on the TPU (``gather_frames_u8`` for
uint8 rows); both are exact.
"""

from __future__ import annotations

import torch

from learnablepoolingmethods_torch.ops.fused_frontend import gather_frames, sample_indices


def sample_frame_features(features, num_frames, num_samples: int, key) -> torch.Tensor:
    """iid frame sampling on a feature tensor ``[B, F, D]`` of any dtype →
    ``[B, num_samples, D]``: the train step's presampling of uint8 frames and
    the model's own sampling of float frames, bit for bit those of
    ``model_utils.py#sample_frame_features`` and ``#sample_random_frames``
    under the same key."""
    return gather_frames(features, sample_indices(key, num_frames, features.shape[1], num_samples))
