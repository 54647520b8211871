"""Weight-only int8 hidden FC (``--int8_hidden``): the quantizer, the W8A16
CUDA kernel's wrapper and its plain version.

Port of ``learnablepoolingmethods_tpu/ops/int8_matmul.py``.  Per output
column, symmetric:

    s[n]  = max_k |w[k, n]| / 127          (1 where the column is zero)
    q     = clip(rint(w / s), −127, 127)   int8
    y     = (bf16(x) · bf16(q)) ⊙ s        f32 sums

int8 → bf16 is exact, so the only error beside a bf16 weight's is the
quantization of w.  :func:`quantize_weight_int8` is the host-side numpy
quantizer, equal to the JAX package's bit for bit, and
:func:`quantize_int8_tensor` the same arithmetic in torch on the weight's
own device, equal to it bit for bit.  :func:`matmul_wi8` runs
``csrc/int8_matmul.cu`` on a CUDA tensor (the int8 tiles come by TMA and are
converted in registers into wgmma's A operand; no bf16 copy of the weight is
written) and :func:`matmul_wi8_plain` on a CPU tensor.  The kernel reads the
weight n-major with each 64-deep block of a row permuted
(:func:`device_weight`, ``[N, Kp / 64, 64]``); both versions take that
layout, and the plain version also the ``[K, N]`` matrix itself.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from learnablepoolingmethods_torch.ops import kernel_build

# csrc/int8_matmul.cu's tiles (lpm_int8_matmul_tile): the weight rows of a
# block (kBN), the k-step (kBK), and the batch tiles (wgmma's N: the least
# that holds the batch, the last past it)
TILE_N, TILE_K = 256, 64
BATCH_TILES = (8, 16, 32, 64, 128)
# split K until the grid holds at most one block an SM: a block's 197 KB
# ring of six stages and its two consumer warpgroups of 232 registers fill
# an SM, and a second wave of a few blocks would double the time
H100_SMS = 132


def _k_order() -> np.ndarray:
    """K_ORDER[p]: the k (within a TILE_K block) that byte p of a weight
    row's block holds — 16t + 4s + j holds 16s + 2t + (j & 1) + 8(j >> 1), so
    that the thread of lane % 4 = t finds its wgmma A fragments of all four
    k16 steps (k 2t, 2t+1, 2t+8, 2t+9) in 16 contiguous bytes."""
    p = np.arange(TILE_K)
    t, step, j = p // 16, (p % 16) // 4, p % 4
    return 16 * step + 2 * t + (j & 1) + 8 * (j >> 1)


K_ORDER = _k_order()
K_INVERSE = np.argsort(K_ORDER)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def quantize_weight_int8(w):
    """w ``[K, N]`` (numpy or torch, any float dtype) → (q ``[K, N]`` int8,
    scales ``[N]`` f32), as the JAX package's quantizer computes them: in
    numpy f32, ``rint`` (half to even), the clip to ±127, scale 1 for a zero
    column."""
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=0)
    scales = (amax / 127.0).astype(np.float32)
    safe = np.where(scales == 0.0, 1.0, scales)
    q = np.clip(np.rint(w / safe[None, :]), -127, 127).astype(np.int8)
    return q, scales


def quantize_int8_tensor(w: torch.Tensor):
    """:func:`quantize_weight_int8` in torch on ``w``'s device → (q ``[K, N]``
    int8, scales ``[N]`` f32), bit for bit the same: every operation is an
    exact or correctly rounded f32 one (the scale's division by a tensor of
    127, since torch may take a division by a Python scalar as a product with
    its reciprocal; ``round`` is half to even, as ``rint``)."""
    w = w.detach().float()
    amax = w.abs().amax(dim=0)
    scales = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scales == 0.0, torch.ones_like(scales), scales)
    q = torch.round(w / safe[None, :]).clamp_(-127, 127).to(torch.int8)
    return q, scales


def device_weight(q, device) -> torch.Tensor:
    """The int8 ``[K, N]`` weight (numpy or a tensor) on ``device`` as the
    kernel reads it: ``[N, Kp / 64, 64]`` int8, n-major, K zero-padded to a
    multiple of TILE_K and each 64-deep block of a row in K_ORDER."""
    q = q if isinstance(q, torch.Tensor) else torch.from_numpy(np.asarray(q))
    q = q.to(device)
    k, n = q.shape
    kp = -(-k // TILE_K) * TILE_K
    wt = torch.zeros((n, kp), dtype=torch.int8, device=q.device)
    wt[:, :k] = q.t()
    order = torch.from_numpy(K_ORDER).to(q.device)
    return wt.view(n, kp // TILE_K, TILE_K)[:, :, order].contiguous()


def logical_weight(wt: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`device_weight`'s ``[N, Kp / 64, 64]`` layout back to the
    ``[K, N]`` int8 matrix (a view of a copy)."""
    inverse = torch.from_numpy(K_INVERSE).to(wt.device)
    return wt[:, :, inverse].reshape(wt.shape[0], -1)[:, :k].t()


def batch_tile(m: int) -> int:
    """The kernel's batch tile at batch ``m``: the least of BATCH_TILES that
    holds it, the last past it."""
    return next((t for t in BATCH_TILES if m <= t), BATCH_TILES[-1])


def int8_geometry(m: int, n: int, k: int) -> dict:
    """The kernel's grid: the batch tile, output tiles, K steps of
    ``TILE_K``, and the split of K — ``splits`` ranges of ``kb_per_split``
    steps, the last maybe shorter — chosen so that tiles × splits fills the
    H100_SMS once (one wave)."""
    bt = batch_tile(m)
    tiles = -(-m // bt) * -(-n // TILE_N)
    kb = max(1, -(-k // TILE_K))
    want = max(1, min(kb, H100_SMS // tiles))
    per = -(-kb // want)
    return {"batch_tile": bt, "tiles": tiles, "k_steps": kb, "splits": -(-kb // per), "kb_per_split": per}


def matmul_wi8(x: torch.Tensor, w_i8: torch.Tensor, scales: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y ``[M, N]`` f32 = (bf16(x) · bf16(w_i8)) ⊙ scales (+ bias).

    x ``[M, K]``; w_i8 the weight in :func:`device_weight`'s layout (on the
    CPU also the ``[K, N]`` int8 matrix); scales and bias ``[N]``.  A CPU
    tensor takes :func:`matmul_wi8_plain`; a CUDA tensor launches the
    kernel."""
    if x.device.type == "cpu":
        return matmul_wi8_plain(x, w_i8, scales, bias)
    if x.dim() != 2 or w_i8.dim() != 3 or w_i8.shape[1:] != (-(-x.shape[1] // TILE_K), TILE_K):
        raise ValueError(f"matmul_wi8: x {tuple(x.shape)} and w_i8 {tuple(w_i8.shape)} do not chain "
                         "(the weight in device_weight's layout)")
    if w_i8.dtype != torch.int8 or not w_i8.is_contiguous() or w_i8.device != x.device:
        raise ValueError("matmul_wi8: the weight must be contiguous int8 on x's device (device_weight)")
    m, k = x.shape
    n = w_i8.shape[0]
    if k % 8:
        raise ValueError(f"matmul_wi8: K={k} must be a multiple of 8")
    dev = x.device
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:  # TMA reads from 16-byte aligned rows
        xb = xb.clone()
    s = scales.to(device=dev, dtype=torch.float32).reshape(n).contiguous()
    b = None if bias is None else bias.to(device=dev, dtype=torch.float32).reshape(n).contiguous()
    geo = int8_geometry(m, n, k)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = torch.empty((geo["splits"] * m * n if geo["splits"] > 1 else 1,), dtype=torch.float32, device=dev)
    fn = kernel_build.load_function("int8_matmul", "lpm_int8_matmul", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(xb.data_ptr(), w_i8.data_ptr(), s.data_ptr(), 0 if b is None else b.data_ptr(),
                y.data_ptr(), part.data_ptr(), m, n, k, geo["splits"], geo["kb_per_split"],
                torch.cuda.current_stream(dev).cuda_stream)
    kernel_build.check(rc, "matmul_wi8")
    matmul_wi8.launches += 1
    return y


matmul_wi8.launches = 0


def matmul_wi8_plain(x, w_i8, scales, bias=None):
    """Plain PyTorch version of :func:`matmul_wi8` (the JAX package's
    ``matmul_wi8``): x rounded to bf16, the int8 weight (``[K, N]``, or in
    :func:`device_weight`'s layout) widened exactly, the product summed in
    f32, times the scales, plus the bias."""
    if w_i8.dim() == 3:
        w_i8 = logical_weight(w_i8, x.shape[-1])
    y = x.to(torch.bfloat16).float() @ w_i8.float()
    y = y * scales.float()
    return y if bias is None else y + bias.float()
