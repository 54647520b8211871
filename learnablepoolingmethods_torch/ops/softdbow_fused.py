"""Fused SoftDBoW histogram: CUDA kernel wrapper and its plain version.

    bow[b, k] = Σ_f softmax_k(X[b, f]·C · scale + bias)      [B, K] f32

the raw (unnormalised) soft bag-of-words histogram, with the assignment BN
folded into scale/bias; the caller ℓ2-normalises it.  The kernel
(``csrc/softdbow_fused.cu``) replaces
``learnablepoolingmethods_tpu/ops/softdbow_pallas.py#softdbow_fused``;
:func:`softdbow_reference` transcribes that module's ``softdbow_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from learnablepoolingmethods_torch.ops import kernel_build
from learnablepoolingmethods_torch.ops.netvlad_fused import check_frames

CLUSTER_TILE = 128  # csrc/softdbow_fused.cu kBowClusters

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 4
    + [ctypes.c_void_p]
)


def workspace_shapes(b: int, f: int, k: int, dtype: torch.dtype) -> dict:
    """Shapes of the kernel's f32 scratch tensors, in the order the C entry
    point takes them: ``ws_max`` and ``ws_sum``, one (max, Σ exp) partial per
    frame row and 128-cluster tile, ``[B·F, ⌈K/128⌉]``; and for bf16 frames
    ``ws_logits``, the logits ``[B·F, K]`` that the bf16 kernel writes once
    and reads back (the f32 kernel recomputes them and takes none)."""
    partials = (b * f, -(-k // CLUSTER_TILE))
    logits = (b * f, k) if dtype == torch.bfloat16 else (0,)
    return {"ws_max": partials, "ws_sum": partials, "ws_logits": logits}


def softdbow_fused(
    x: torch.Tensor,             # [B, F, D] bf16 or f32
    cluster: torch.Tensor,       # [D, K]
    assign_scale: torch.Tensor,  # [K] folded BN scale
    assign_bias: torch.Tensor,   # [K] folded BN bias
) -> torch.Tensor:
    """The raw histogram ``[B, K]`` f32.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`softdbow_reference`.  ``x`` may be a column slice of a wider
    ``[B, F, DT]`` tensor, as for ``netvlad_fused``.
    """
    if x.device.type == "cpu":
        return softdbow_reference(x, cluster, assign_scale, assign_bias)
    b, f, d, k = check_frames("softdbow_fused", x, cluster)
    dev = x.device
    c = cluster.to(device=dev, dtype=x.dtype).contiguous()
    scale = assign_scale.to(device=dev, dtype=torch.float32).reshape(k).contiguous()
    bias = assign_bias.to(device=dev, dtype=torch.float32).reshape(k).contiguous()

    bow = torch.empty((b, k), dtype=torch.float32, device=dev)
    ws = [torch.empty(shape, dtype=torch.float32, device=dev)
          for shape in workspace_shapes(b, f, k, x.dtype).values()]
    fn = kernel_build.load_function("softdbow_fused", "lpm_softdbow_fused", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), x.stride(1), int(x.dtype == torch.bfloat16), c.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), bow.data_ptr(), *(w.data_ptr() for w in ws),
            b, f, d, k, torch.cuda.current_stream(dev).cuda_stream,
        )
    kernel_build.check(rc, "softdbow_fused")
    softdbow_fused.launches += 1
    return bow


softdbow_fused.launches = 0


def softdbow_reference(x, cluster, assign_scale, assign_bias):
    """Plain PyTorch twin of :func:`softdbow_fused` (the parity oracle): the
    logits are products in ``x.dtype`` summed in f32, then softmax in f32."""
    logits = (
        torch.einsum("bfd,dk->bfk", x.float(), cluster.to(x.dtype).float())
        * assign_scale.reshape(1, 1, -1)
        + assign_bias.reshape(1, 1, -1)
    )
    return torch.sum(torch.softmax(logits, dim=-1), dim=1)
