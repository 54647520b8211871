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
    + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 4
    + [ctypes.c_void_p]
)


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
    tiles = -(-k // CLUSTER_TILE)
    ws_max = torch.empty((b * f, tiles), dtype=torch.float32, device=dev)
    ws_sum = torch.empty((b * f, tiles), dtype=torch.float32, device=dev)
    fn = kernel_build.load_function("softdbow_fused", "lpm_softdbow_fused", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), x.stride(1), int(x.dtype == torch.bfloat16), c.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), bow.data_ptr(), ws_max.data_ptr(),
            ws_sum.data_ptr(), b, f, d, k, torch.cuda.current_stream(dev).cuda_stream,
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
