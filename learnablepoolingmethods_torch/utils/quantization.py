"""uint8 feature (de)quantization.

The YouTube-8M frame features ship as uint8 with the fixed affine transform
(ref: utils.py#Dequantize):

    quantized_range = max_quantized_value - min_quantized_value      (= 4.0)
    scalar          = quantized_range / 255.0
    bias            = quantized_range / 512.0 + min_quantized_value  (≈ -1.992)
    value           = uint8 * scalar + bias

Dequantization runs on the device, so the host→device copy stays at one
byte per element.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_MAX = 2.0
DEFAULT_MIN = -2.0


def _scalar_bias(max_quantized_value: float, min_quantized_value: float):
    quantized_range = max_quantized_value - min_quantized_value
    scalar = quantized_range / 255.0
    bias = (quantized_range / 512.0) + min_quantized_value
    return scalar, bias


def dequantize(
    feat_vector: torch.Tensor,
    max_quantized_value: float = DEFAULT_MAX,
    min_quantized_value: float = DEFAULT_MIN,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Torch dequantize: one multiply and one add in ``dtype``, each rounded
    to ``dtype`` (bit-exact with the JAX ``dequantize`` for float32)."""
    scalar, bias = _scalar_bias(max_quantized_value, min_quantized_value)
    return feat_vector.to(dtype) * torch.tensor(scalar, dtype=dtype) + torch.tensor(
        bias, dtype=dtype
    )


def dequantize_np(
    feat_vector: np.ndarray,
    max_quantized_value: float = DEFAULT_MAX,
    min_quantized_value: float = DEFAULT_MIN,
) -> np.ndarray:
    """NumPy twin of :func:`dequantize` for host-side golden tests."""
    scalar, bias = _scalar_bias(max_quantized_value, min_quantized_value)
    return feat_vector.astype(np.float32) * np.float32(scalar) + np.float32(bias)


def quantize_np(
    values: np.ndarray,
    max_quantized_value: float = DEFAULT_MAX,
    min_quantized_value: float = DEFAULT_MIN,
) -> np.ndarray:
    """Forward quantizer used to fabricate synthetic YT-8M-format records.

    Mirrors the dataset-producer side (clip to range, affine to [0,255],
    round-half-away like the feature extractor) so that
    ``dequantize(quantize(x)) ≈ x`` within one quantization step.
    """
    quantized_range = max_quantized_value - min_quantized_value
    clipped = np.clip(values, min_quantized_value, max_quantized_value)
    q = (clipped - min_quantized_value) * (255.0 / quantized_range)
    return np.clip(np.floor(q + 0.5), 0, 255).astype(np.uint8)
