"""Masked multi-head self-attention over a fused QKV tensor: CUDA kernel
wrapper and its plain version.

    qkv   [B, F, 3·H·hd]   q ‖ k ‖ v on the last axis, head h at columns h·hd…
    mask  [B, F]           1 = valid key
    out   [B, F, H·hd]     per head softmax_s(q·k_s/√hd + (1 − mask_s)·(−1e9))·V

Every query row is computed, pad rows included.  Masked keys are not left
out: they get −1e9 added to their f32 logit, so a row whose keys are all
masked (a padding row of the CLI's last batch, ``num_frames`` 0) gets
uniform weights, the mean of V over all F rows, as flax's
``MultiHeadDotProductAttention`` gives.  The kernel
(``csrc/masked_attention.cu``, compiled into the native runner's library,
which launches it on the transformer family's routes:
``ops/kernel_build.py#LIBRARY_PARTS``) replaces
``learnablepoolingmethods_tpu/ops/fast_transformer.py#masked_attention_fused``;
:func:`attention_reference` transcribes that module's ``attention_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from learnablepoolingmethods_torch.ops import kernel_build

MAX_HEAD_DIM = 128  # csrc/masked_attention.cu kAttnMaxHd

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def check_attention(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int):
    """Validate the kernel's operands; returns (B, F, H, hd).  qkv must be a
    contiguous ``[B, F, 3·H·hd]`` bf16 or f32 tensor with 8 <= hd <= 128, hd
    a multiple of 8 (the kernel moves 8 values at a time), 1 <= B <= 65535
    and 1 <= H <= 65535 (grid limits); mask must be ``[B, F]``."""
    if qkv.dim() != 3 or qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"masked_attention_fused: qkv must be [B, F, 3·H·hd] bf16/f32, "
                         f"got {tuple(qkv.shape)} {qkv.dtype}")
    b, f, dm3 = qkv.shape
    if num_heads < 1 or dm3 % (3 * num_heads):
        raise ValueError(f"masked_attention_fused: last axis {dm3} is not 3·H·hd for H={num_heads}")
    hd = dm3 // (3 * num_heads)
    if hd < 8 or hd > MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"masked_attention_fused: head width {hd} must be a multiple of 8 "
                         f"in [8, {MAX_HEAD_DIM}]")
    if not 1 <= b <= 65535 or f < 1 or num_heads > 65535:
        raise ValueError(f"masked_attention_fused: needs 1 <= B <= 65535, F >= 1, H <= 65535; "
                         f"got B={b}, F={f}, H={num_heads}")
    if tuple(mask.shape) != (b, f):
        raise ValueError(f"masked_attention_fused: mask {tuple(mask.shape)} for qkv {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError(f"masked_attention_fused: qkv must be contiguous, got strides {qkv.stride()}")
    return b, f, num_heads, hd


def masked_attention_fused(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Masked attention of every head → ``[B, F, H·hd]`` in ``qkv.dtype``.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`masked_attention_plain`."""
    if qkv.device.type == "cpu":
        return masked_attention_plain(qkv, mask, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"masked_attention_fused: unsupported device {qkv.device}")
    b, f, h, hd = check_attention(qkv, mask, num_heads)
    if qkv.data_ptr() % 16:
        raise ValueError("masked_attention_fused: qkv must start on a 16-byte boundary")
    dev = qkv.device
    m = mask.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((b, f, h * hd), dtype=qkv.dtype, device=dev)
    fn = kernel_build.load_function("masked_attention", "lpm_masked_attention", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(qkv.data_ptr(), m.data_ptr(), out.data_ptr(), int(qkv.dtype == torch.bfloat16),
                b, f, h, hd, torch.cuda.current_stream(dev).cuda_stream)
    kernel_build.check(rc, "masked_attention_fused")
    masked_attention_fused.launches += 1
    return out


masked_attention_fused.launches = 0


def attention_reference(q, k, v, mask, num_heads: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel on separate q, k, v ``[B, F, H·hd]``,
    at the TPU kernel's rounding points: q scaled by 1/√hd in f32, f32
    logits plus the −1e9 key mask, an f32 softmax, the normalised weights
    rounded to v's dtype, then weights·V summed in f32 and cast to q's
    dtype.  The bf16 kernel rounds at the same points (in f32 nothing is
    rounded)."""
    b, f, dm = q.shape
    hd = dm // num_heads
    qh = q.reshape(b, f, num_heads, hd).float() / (hd ** 0.5)
    kh = k.reshape(b, f, num_heads, hd).float()
    vh = v.reshape(b, f, num_heads, hd)
    logits = torch.einsum("bqhk,bshk->bhqs", qh, kh)
    logits = logits + (1.0 - mask.float())[:, None, None, :] * -1e9
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqs,bshk->bqhk", w.to(v.dtype).float(), vh.float())
    return out.reshape(b, f, dm).to(q.dtype)


def masked_attention_plain(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """:func:`attention_reference` on the column slices of the fused qkv."""
    d = qkv.shape[-1] // 3
    return attention_reference(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], mask, num_heads)
