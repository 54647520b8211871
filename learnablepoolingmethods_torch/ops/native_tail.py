"""The fast route's tail as the native runner runs it: four hand kernels
between its cuBLAS products (``csrc/native_runner.cu``).

- :func:`hidden_sum`: the hidden FC's two slices summed with its bias,
  ``(h_rgb + h_aud) + b`` in f32, and that sum rounded to bf16 for the
  gating product;
- :func:`gating`: ``bf16(h · σ(gates · g_scale + g_bias))``, the folded
  context gating after its product;
- :func:`moe_combine`: ``Σ_m softmax_m(ga) · σ(ea + experts_bias)`` over the
  vocab-major MoE products (class v's mixture m in column m·V + v);
- :func:`topk`: exact top-k, sorted descending, the lowest index first
  among equal scores (``jax.lax.top_k``).

They replace no ``pallas_call``: the JAX package leaves this arithmetic to
XLA's fusions (``learnablepoolingmethods_tpu/ops/fast_infer.py:64-88``,
``ops/topk.py``).  The ``*_plain`` versions are that arithmetic in PyTorch,
and ``ops/fast_infer.py#gated_moe_tail`` computes with them.  A wrapper
takes its plain version for CPU tensors and launches the runner library's
entry point for CUDA tensors (``chip_smoke.py`` holds each against its plain
version); the runner launches the same kernels itself and counts them apart
(``core/native_runtime.py#NativeExecutable.launches``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from learnablepoolingmethods_torch.ops import kernel_build
from learnablepoolingmethods_torch.ops.topk import top_k_exact

LIBRARY = "native_runner"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def hidden_sum_plain(h_rgb: torch.Tensor, h_aud: torch.Tensor, bias: torch.Tensor):
    """(h f32 [B, H], h rounded to bf16) of the two slices' products."""
    h = (h_rgb + h_aud) + bias
    return h, h.to(torch.bfloat16)


def gating_plain(gates: torch.Tensor, h: torch.Tensor, g_scale: torch.Tensor, g_bias: torch.Tensor,
                 ct: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Folded context gating after its product ``gates`` [B, H] (f32)."""
    return (h * torch.sigmoid(gates * g_scale + g_bias)).to(ct)


def moe_combine_plain(ga: torch.Tensor, ea: torch.Tensor, experts_bias: torch.Tensor, m: int) -> torch.Tensor:
    """The MoE's probabilities [B, V] from its gate [B, (M+1)·V] and expert
    [B, M·V] products (f32), vocab-major."""
    b = ga.shape[0]
    v = ga.shape[1] // (m + 1)
    ga = ga.reshape(b, m + 1, v)
    ea = (ea + experts_bias).reshape(b, m, v)
    return torch.sum(torch.softmax(ga, dim=1)[:, :m] * torch.sigmoid(ea), dim=1)


def topk_plain(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    values, indices = top_k_exact(probs, k)
    return values, indices.to(torch.int32)


def _f32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous f32 CUDA tensors, got {t.dtype} on {t.device}")


def _launch(name: str, symbol: str, argtypes, *args, device) -> None:
    fn = kernel_build.load_function(LIBRARY, symbol, argtypes)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    kernel_build.check(rc, name)


def hidden_sum(h_rgb: torch.Tensor, h_aud: torch.Tensor, bias: torch.Tensor):
    """:func:`hidden_sum_plain` on the card (the kernel) or the CPU."""
    if h_rgb.device.type == "cpu":
        return hidden_sum_plain(h_rgb, h_aud, bias)
    _f32("hidden_sum", h_rgb, h_aud, bias)
    rows, width = h_rgb.shape
    if h_aud.shape != h_rgb.shape or bias.shape != (width,):
        raise ValueError(f"hidden_sum: shapes {tuple(h_rgb.shape)}, {tuple(h_aud.shape)}, {tuple(bias.shape)}")
    h = torch.empty_like(h_rgb)
    hb = torch.empty(h_rgb.shape, dtype=torch.bfloat16, device=h_rgb.device)
    _launch("hidden_sum", "lpm_hidden_sum", [_P] * 5 + [_LL, _I, _P],
            h_rgb.data_ptr(), h_aud.data_ptr(), bias.data_ptr(), h.data_ptr(), hb.data_ptr(), rows, width,
            device=h_rgb.device)
    hidden_sum.launches += 1
    return h, hb


def gating(gates: torch.Tensor, h: torch.Tensor, g_scale: torch.Tensor, g_bias: torch.Tensor) -> torch.Tensor:
    """:func:`gating_plain` (bf16 out) on the card (the kernel) or the CPU."""
    if gates.device.type == "cpu":
        return gating_plain(gates, h, g_scale, g_bias)
    _f32("gating", gates, h, g_scale, g_bias)
    rows, width = gates.shape
    if h.shape != gates.shape or g_scale.shape != (width,) or g_bias.shape != (width,):
        raise ValueError(f"gating: shapes {tuple(gates.shape)}, {tuple(h.shape)}, {tuple(g_scale.shape)}")
    out = torch.empty(gates.shape, dtype=torch.bfloat16, device=gates.device)
    _launch("gating", "lpm_gating", [_P] * 5 + [_LL, _I, _P],
            gates.data_ptr(), h.data_ptr(), g_scale.data_ptr(), g_bias.data_ptr(), out.data_ptr(), rows, width,
            device=gates.device)
    gating.launches += 1
    return out


def moe_combine(ga: torch.Tensor, ea: torch.Tensor, experts_bias: torch.Tensor, m: int) -> torch.Tensor:
    """:func:`moe_combine_plain` on the card (the kernel) or the CPU."""
    if ga.device.type == "cpu":
        return moe_combine_plain(ga, ea, experts_bias, m)
    _f32("moe_combine", ga, ea, experts_bias)
    b = ga.shape[0]
    v = ga.shape[1] // (m + 1)
    if ga.shape != (b, (m + 1) * v) or ea.shape != (b, m * v) or experts_bias.shape != (m * v,):
        raise ValueError(f"moe_combine: shapes {tuple(ga.shape)}, {tuple(ea.shape)}, {tuple(experts_bias.shape)}")
    probs = torch.empty((b, v), dtype=torch.float32, device=ga.device)
    _launch("moe_combine", "lpm_moe_combine", [_P] * 4 + [_I] * 3 + [_P],
            ga.data_ptr(), ea.data_ptr(), experts_bias.data_ptr(), probs.data_ptr(), b, m, v, device=ga.device)
    moe_combine.launches += 1
    return probs


def topk(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values f32 [B, k], indices int32 [B, k]): :func:`topk_plain` on the
    card (the kernel) or the CPU."""
    if probs.device.type == "cpu":
        return topk_plain(probs, k)
    _f32("topk", probs)
    b, v = probs.shape
    if not 1 <= k <= v:
        raise ValueError(f"topk: k={k} for rows of {v}")
    values = torch.empty((b, k), dtype=torch.float32, device=probs.device)
    indices = torch.empty((b, k), dtype=torch.int32, device=probs.device)
    _launch("topk", "lpm_topk", [_P] * 3 + [_I] * 3 + [_P],
            probs.data_ptr(), values.data_ptr(), indices.data_ptr(), b, v, k, device=probs.device)
    topk.launches += 1
    return values, indices


for _wrapper in (hidden_sum, gating, moe_combine, topk):
    _wrapper.launches = 0
