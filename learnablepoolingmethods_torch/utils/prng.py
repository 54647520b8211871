"""Threefry-2x32 keys and uniform draws, bit for bit those of ``jax.random``.

JAX's default generator is Threefry-2x32 (20 rounds).  With
``jax_threefry_partitionable=True``, the default since jax 0.5, a draw of
``n`` values hashes the counters ``(0, i)`` for ``i < n`` under the key and
XORs the two output words; ``split`` keeps both words of each counter as the
new keys; ``fold_in(key, d)`` hashes the single counter ``(0, d)``.  This
module reproduces those rules, so the port draws the same frames as the JAX
package from the same seed.

The hash runs on the host in NumPy ``uint32``, which wraps as the hash needs,
and a draw reaches a CUDA device through pinned memory without waiting for
the device.  As PyTorch ops on the card the hash would be about a hundred
small integer kernels (PyTorch has no uint32 arithmetic, so each sum and
shift also needs a mask); launched one by one they cost more host time than
the batch they feed (PERF.md).  The inference front end's CUDA kernel
(``csrc/fused_frontend.cu``) draws its frames itself from the key's two
words, by the same rules.

A key is a ``[2]`` int64 tensor of two 32-bit words.

    key = prng.key(0)
    u = prng.uniform(prng.fold_in(key, step), (batch, samples), device)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of uint32 counter words ``(x0, x1)`` under key
    ``(k0, k1)``: 5 groups of 4 rounds with a key injection after each, as
    ``jax._src.prng._threefry2x32_lowering``."""
    ks = [np.uint32(k) for k in (k0, k1, k0 ^ k1 ^ _PARITY)]
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key_words(key_: torch.Tensor) -> Tuple[int, int]:
    """The key's two 32-bit words as Python ints."""
    if key_.shape != (2,):
        raise ValueError(f"a key is a [2] tensor of 32-bit words, got shape {tuple(key_.shape)}")
    k0, k1 = (int(w) for w in key_.tolist())
    return k0 & _MASK, k1 & _MASK


def _key_of(x0: np.ndarray, x1: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.stack([x0, x1], axis=-1).astype(np.int64))


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)`` for a seed that fits 32 bits: words
    ``(0, seed mod 2³²)``."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def fold_in(key_: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of counter ``(0, data)``."""
    x0, x1 = threefry2x32(*key_words(key_), np.zeros(1, np.uint32),
                         np.array([int(data) & _MASK], np.uint32))
    return _key_of(x0, x1)[0]


def split(key_: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` → ``[num, 2]``: key ``i`` is the hash
    of counter ``(0, i)``, both words kept."""
    x0, x1 = threefry2x32(*key_words(key_), np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return _key_of(x0, x1)


def random_bits(key_: torch.Tensor, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)`` as a NumPy uint32 array."""
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2**32:
        raise ValueError("a draw of 2**32 values or more needs the high counter word")
    x0, x1 = threefry2x32(*key_words(key_), np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return (x0 ^ x1).reshape(tuple(shape))


def uniform(key_: torch.Tensor, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1) on ``device``:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key_, shape)
    u = torch.from_numpy(((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0))
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cuda":
        return u.pin_memory().to(device, non_blocking=True)
    return u.to(device)
