"""Dropout with flax's keep masks: ``csrc/dropout.cu`` on the card, the
plain version (the mask drawn on the host by ``utils/prng.py``) on the CPU.

The JAX package trains the transformer family with flax's two dropouts,
which XLA fuses from ``jax.random.bernoulli``'s threefry bits (no
``pallas_call``).  The port draws the same bits, so a mask is bit for bit
flax's from the same key:

- ``mode="div"``, ``nn.Dropout`` (flax/linen/stochastic.py:98-107): keep =
  ``bernoulli(key, 1 - rate, x.shape)``, ``select(keep, x / keep_prob, 0)``
  with the division in x's dtype;
- ``mode="mul"``, the attention-weight dropout of
  ``dot_product_attention_weights`` (flax/linen/attention.py:151-161): keep
  = ``bernoulli(key, 1 - rate, [1, 1, F, F])`` broadcast over batch and
  heads, ``w * (keep.astype(dtype) / keep_prob)``, the multiplier in w's
  dtype.

The two round differently in bf16.  Both are linear in x with one mask, so
the backward is the same function of the cotangent.  On the card the
forward launch hashes the mask and also writes it as bits
(:func:`pack_mask`'s layout: word w, bit b = keep[32·w + b]), which the
autograd function keeps for the backward launch, which reads them and
hashes nothing (:func:`dropout_from_bits`); that is ceil(P / 32) words
held from the forward to the backward (9.6 MB for config 5's FFN output,
11 KB for the attention's [1, 1, 300, 300]).  The CPU path keeps the host's
mask.  A host draw costs about 0.2 µs a value, seconds a step at full
width, so a CUDA tensor always takes the kernel; there is no fallback.

    y = dropout(x, key, rate=0.1)                              # nn.Dropout
    w = dropout(w, key, rate=0.1, mask_shape=(1, 1, F, F), mode="mul")
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from learnablepoolingmethods_torch.ops import kernel_build
from learnablepoolingmethods_torch.utils import prng

MODES = {"div": 0, "mul": 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _period(x: torch.Tensor, mask_shape: Sequence[int]) -> int:
    """The mask's size P, checking that the mask broadcasts over ``x`` as a
    run of leading 1s followed by x's trailing dims (so x is rows × P)."""
    mask_shape = tuple(int(s) for s in mask_shape)
    if len(mask_shape) != x.dim():
        raise ValueError(f"mask shape {mask_shape} does not match x's rank {x.dim()}")
    lead = 0
    while lead < len(mask_shape) and mask_shape[lead] == 1:
        lead += 1
    if mask_shape[lead:] != tuple(x.shape[lead:]):
        raise ValueError(f"mask shape {mask_shape} must be 1s then x's trailing dims {tuple(x.shape)}")
    return int(np.prod(mask_shape, dtype=np.int64))


def _scale(keep_prob: float, mode: str, dtype: torch.dtype) -> float:
    """keep_prob in ``dtype`` (mode div), or 1 / that in ``dtype`` (mode
    mul), as the f32 value the kernel takes."""
    kp = torch.tensor(keep_prob, dtype=dtype)
    return float(kp if mode == "div" else torch.tensor(1, dtype=dtype) / kp)


def keep_mask(key: torch.Tensor, keep_prob: float, mask_shape: Sequence[int], device=None,
              offset: int = 0) -> torch.Tensor:
    """``jax.random.bernoulli(key, keep_prob, mask_shape)`` as a bool tensor,
    drawn on the host; with ``offset``, the entries ``offset`` … of a larger
    mask's draw."""
    return torch.from_numpy(prng.bernoulli(key, keep_prob, mask_shape, offset)).to(device)


def pack_mask(keep: torch.Tensor) -> torch.Tensor:
    """A keep mask as the kernel's bits: ceil(n / 32) int32 words (the
    uint32 bit patterns), word w bit b = keep.flatten()[32·w + b], the bits
    past n zero."""
    flat = keep.reshape(-1).to(torch.int64)
    flat = torch.nn.functional.pad(flat, (0, -flat.numel() % 32)).view(-1, 32)
    words = (flat << torch.arange(32, device=flat.device)).sum(dim=1)
    return (words - (words >> 31 << 32)).to(torch.int32)


def unpack_mask(bits: torch.Tensor, mask_shape: Sequence[int]) -> torch.Tensor:
    """:func:`pack_mask`'s inverse: the bool mask of ``mask_shape``."""
    n = int(np.prod(mask_shape, dtype=np.int64))
    words = bits.to(torch.int64) & 0xFFFFFFFF
    keep = (words[:, None] >> torch.arange(32, device=bits.device)) & 1
    return keep.reshape(-1)[:n].bool().reshape(tuple(mask_shape))


def apply_mask(x: torch.Tensor, keep: torch.Tensor, keep_prob: float, mode: str) -> torch.Tensor:
    """The plain version of the kernel's arithmetic for a mask ``keep`` that
    broadcasts over ``x``."""
    kp = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    if mode == "div":
        return torch.where(keep, x / kp, torch.zeros_like(x))
    return x * (keep.to(x.dtype) / kp)


def dropout_plain(x: torch.Tensor, key: torch.Tensor, keep_prob: float, mask_shape: Sequence[int],
                  mode: str = "div", offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`dropout_kernel`: the mask drawn on
    the host, then :func:`apply_mask`."""
    _period(x, mask_shape)
    return apply_mask(x, keep_mask(key, keep_prob, mask_shape, x.device, offset), keep_prob, mode)


def dropout_from_bits_plain(g: torch.Tensor, bits: torch.Tensor, keep_prob: float, mask_shape: Sequence[int],
                            mode: str = "div") -> torch.Tensor:
    """Plain PyTorch version of :func:`dropout_from_bits`: the rule on
    ``g`` under the mask that ``bits`` holds."""
    _period(g, mask_shape)
    return apply_mask(g, unpack_mask(bits, mask_shape).to(g.device), keep_prob, mode)


def _launch(x: torch.Tensor, keep_prob: float, mask_shape: Sequence[int], mode: str, bits: torch.Tensor,
            key=None, offset: int = 0) -> torch.Tensor:
    if x.device.type != "cuda" or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dropout_kernel takes an f32 or bf16 CUDA tensor, got {x.dtype} on {x.device}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    period = _period(x, mask_shape)
    if bits.shape != (-(-period // 32),) or bits.dtype != torch.int32 or bits.device != x.device:
        raise ValueError(f"dropout bits: {bits.dtype} {tuple(bits.shape)} on {bits.device} for a mask of {period}")
    x = x.contiguous()
    y = torch.empty_like(x)
    k0, k1 = (0, 0) if key is None else prng.key_words(key)
    fn = kernel_build.load_function("dropout", "lpm_dropout", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), bits.data_ptr(), x.numel() // period if period else 0, period, k0, k1,
                float(np.float32(keep_prob)), _scale(keep_prob, mode, x.dtype), MODES[mode],
                int(x.dtype == torch.bfloat16), int(offset), int(key is None),
                torch.cuda.current_stream(x.device).cuda_stream)
    kernel_build.check(rc, "dropout")
    dropout_kernel.launches += 1
    return y


def dropout_kernel(x: torch.Tensor, key: torch.Tensor, keep_prob: float, mask_shape: Sequence[int],
                   mode: str = "div", offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csrc/dropout.cu``'s forward on a contiguous f32 or bf16 CUDA tensor:
    one launch, the mask hashed on the card from the key's two words
    (entries ``offset`` … of the mask's draw) → (y, the mask's bits, as
    :func:`pack_mask`)."""
    bits = torch.empty(-(-_period(x, mask_shape) // 32), dtype=torch.int32, device=x.device)
    return _launch(x, keep_prob, mask_shape, mode, bits, key, offset), bits


def dropout_from_bits(g: torch.Tensor, bits: torch.Tensor, keep_prob: float, mask_shape: Sequence[int],
                      mode: str = "div") -> torch.Tensor:
    """``csrc/dropout.cu``'s backward: one launch that applies the rule to
    ``g`` under the mask of a forward's ``bits``, with no hash; counted on
    ``dropout_kernel.launches``."""
    return _launch(g, keep_prob, mask_shape, mode, bits)


dropout_kernel.launches = 0


class _Dropout(torch.autograd.Function):
    """Forward through :func:`dropout_kernel` and backward through
    :func:`dropout_from_bits` on the forward's bits on the card; through
    the host mask on the CPU."""

    @staticmethod
    def forward(ctx, x, key, keep_prob, mask_shape, mode, offset):
        ctx.args = (keep_prob, tuple(mask_shape), mode)
        if x.device.type == "cpu":
            ctx.keep = keep_mask(key, keep_prob, mask_shape, offset=offset)
            return apply_mask(x, ctx.keep, keep_prob, mode)
        y, bits = dropout_kernel(x, key, keep_prob, mask_shape, mode, offset)
        ctx.save_for_backward(bits)
        return y

    @staticmethod
    def backward(ctx, g):
        keep_prob, mask_shape, mode = ctx.args
        if g.device.type == "cpu":
            gx = apply_mask(g, ctx.keep, keep_prob, mode)
        else:
            gx = dropout_from_bits(g, ctx.saved_tensors[0], keep_prob, mask_shape, mode)
        return gx, None, None, None, None, None


def dropout(x: torch.Tensor, key: Optional[torch.Tensor], rate: float,
            mask_shape: Optional[Tuple[int, ...]] = None, mode: str = "div",
            row_offset: int = 0) -> torch.Tensor:
    """flax's dropout of ``x`` at ``rate`` with the keep mask of ``key``
    over ``mask_shape`` (x's shape by default): ``x`` itself at rate 0 or
    without a key (deterministic), zeros at rate 1, as flax.  A mask of x's
    own shape takes rows ``row_offset`` … of the mask of a global batch
    whose row ``row_offset`` is x's first (``parallel/mesh.py``); a mask
    that the rows share needs none."""
    if key is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    mask_shape = tuple(x.shape) if mask_shape is None else tuple(mask_shape)
    offset = row_offset * (x.numel() // x.shape[0]) if mask_shape == tuple(x.shape) and x.dim() else 0
    return _Dropout.apply(x, key, 1.0 - rate, mask_shape, mode, offset)
