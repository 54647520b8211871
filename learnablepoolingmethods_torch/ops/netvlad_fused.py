"""Fused NetVLAD aggregation: CUDA kernel wrapper and its plain version.

    logits = X·C · scale + bias          [F, K]   (BN affine folded)
    A      = softmax(logits)             [F, K]
    a_sum  = Σ_F A                       [1, K]
    vlad   = XᵀA − a_sum ⊙ C₂            [D, K]
    vlad   = intra-ℓ2(vlad, axis=D)
    vlad   = vlad / ‖vlad‖_F             (global ℓ2 of the flattened vector)

Output is ``[B, D, K]``; ``reshape(B, D·K)`` is the reference's d-major
flatten (index d·K + k).  The kernel (``csrc/netvlad_fused.cu``) replaces
``learnablepoolingmethods_tpu/ops/netvlad_pallas.py#netvlad_fused``;
:func:`netvlad_reference` transcribes that module's ``netvlad_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from learnablepoolingmethods_torch.ops import kernel_build

MAX_CLUSTERS = 512  # csrc/netvlad_core.cuh kMaxClusters

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 5
    + [ctypes.c_void_p]
)
GEOMETRY_KEYS = ("ds", "cs", "kc", "ktiles", "dchunks", "one_pass", "threads")


def aggregation_geometry(d: int, k: int) -> dict:
    """How the bf16 kernels' aggregation (``csrc/netvlad_tc.cuh#tc_geometry``,
    which this mirrors) tiles a (D, K) shape: warps of 64 descriptor rows ×
    32 clusters, ``ds`` row slabs × ``cs`` cluster slabs a block (at most 16
    warps), ``kc`` clusters a block, ``ktiles`` blocks a video along K and
    ``dchunks`` along D.  ``one_pass`` when a video's blocks fit one portable
    thread-block cluster (at most 8) and D ≤ 1024; else the two-pass kernel,
    whose scratch holds B·dchunks·K floats."""
    slabs = -(-d // 64)
    dchunks = -(-slabs // 16)
    ds = min(slabs, 16)
    cs = min(16 // ds, -(-k // 32))
    kc = 32 * cs
    ktiles = -(-k // kc)
    return dict(ds=ds, cs=cs, kc=kc, ktiles=ktiles, dchunks=dchunks,
                one_pass=int(dchunks == 1 and ktiles <= 8), threads=32 * ds * cs)


def kernel_geometry(d: int, k: int) -> dict:
    """The geometry that the built kernel itself picks for (D, K); needs
    the library, so ``nvcc`` (chip_smoke.py holds it against
    :func:`aggregation_geometry`)."""
    lib_fn = kernel_build.load_function(
        "netvlad_fused", "lpm_netvlad_geometry", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib_fn.restype = None
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    lib_fn(d, k, ctypes.cast(out, ctypes.c_void_p))
    return dict(zip(GEOMETRY_KEYS, out))


def check_frames(name: str, x: torch.Tensor, cluster_weights: torch.Tensor, max_k: int = None):
    """Validate the frames ``x`` [B, F, D] on a CUDA device and the cluster
    matrix [D, K] of a fused aggregation kernel; returns (B, F, D, K).  The
    rows of ``x`` may be a column slice of a wider tensor: its last axis
    must be contiguous and its rows evenly strided."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be [B, F, D] bf16/f32, got {tuple(x.shape)} {x.dtype}")
    b, f, d = x.shape
    if x.stride(2) != 1 or x.stride(0) != f * x.stride(1):
        raise ValueError(
            f"{name}: x rows must be evenly strided with a contiguous last axis, "
            f"got strides {x.stride()}"
        )
    if cluster_weights.dim() != 2 or cluster_weights.shape[0] != d:
        raise ValueError(f"{name}: cluster_weights {tuple(cluster_weights.shape)} for D={d}")
    k = cluster_weights.shape[1]
    if k < 1 or (max_k is not None and k > max_k) or not 1 <= b <= 65535 or f < 1:
        raise ValueError(f"{name}: needs 1 <= K <= {max_k or 'any'}, 1 <= B <= 65535, F >= 1; "
                         f"got K={k}, B={b}, F={f}")
    return b, f, d, k


def netvlad_fused(
    x: torch.Tensor,                 # [B, F, D] bf16 or f32
    cluster_weights: torch.Tensor,   # [D, K]
    assign_scale: torch.Tensor,      # [K] folded BN γ/σ (or ones)
    assign_bias: torch.Tensor,       # [K] folded BN β−μγ/σ (or cluster biases)
    cluster_weights2: torch.Tensor,  # [D, K] (or [1, D, K])
    *,
    two_pass: bool = False,
) -> torch.Tensor:
    """Fused NetVLAD → ``[B, D, K]`` in ``x.dtype``.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`netvlad_reference`.  ``x`` may be a column slice of a wider
    ``[B, F, DT]`` tensor: its last axis must be contiguous and its rows
    evenly strided.  ``two_pass`` (bf16) runs the two-pass aggregation on a
    shape that the one-pass kernel covers, to time the two designs.
    """
    if x.device.type == "cpu":
        return netvlad_reference(
            x, cluster_weights, assign_scale, assign_bias, cluster_weights2
        )
    b, f, d, k = check_frames("netvlad_fused", x, cluster_weights, MAX_CLUSTERS)
    dev = x.device
    c = cluster_weights.to(device=dev, dtype=x.dtype).contiguous()
    scale = assign_scale.to(device=dev, dtype=torch.float32).reshape(k).contiguous()
    bias = assign_bias.to(device=dev, dtype=torch.float32).reshape(k).contiguous()
    c2 = cluster_weights2.to(device=dev, dtype=torch.float32).reshape(d, k).contiguous()

    out = torch.empty((b, d, k), dtype=x.dtype, device=dev)
    ws_a = torch.empty((b * f, k), dtype=torch.float32, device=dev)
    ws_colsq = torch.empty((b * aggregation_geometry(d, k)["dchunks"], k), dtype=torch.float32,
                           device=dev)
    fn = kernel_build.load_function("netvlad_fused", "lpm_netvlad_fused", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), x.stride(1), int(x.dtype == torch.bfloat16), c.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), c2.data_ptr(), out.data_ptr(),
            ws_a.data_ptr(), ws_colsq.data_ptr(), b, f, d, k, int(two_pass),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernel_build.check(rc, "netvlad_fused")
    netvlad_fused.launches += 1
    return out


netvlad_fused.launches = 0


def netvlad_reference(x, cluster_weights, assign_scale, assign_bias, cluster_weights2,
                      kernel_rounding: bool = False):
    """Plain PyTorch twin of :func:`netvlad_fused` (the parity oracle).

    ``kernel_rounding`` takes the bf16 kernel's rounding points for Xᵀ·A: A
    enters as bf16(A) + bf16(A − bf16(A)), each product summed in f32 (the
    two tensor-core products), while a_sum still sums the unrounded A."""
    b, f, d = x.shape
    k = cluster_weights.shape[-1]
    x32 = x.float()
    logits = (
        torch.einsum("bfd,dk->bfk", x32, cluster_weights.float())
        * assign_scale.reshape(1, 1, k)
        + assign_bias.reshape(1, 1, k)
    )
    a = torch.softmax(logits, dim=-1)
    a_sum = torch.sum(a, dim=1, keepdim=True)  # [B,1,K]
    if kernel_rounding:
        a_hi = a.to(torch.bfloat16).float()
        a_lo = (a - a_hi).to(torch.bfloat16).float()
        vlad = torch.einsum("bfk,bfd->bdk", a_hi, x32) + torch.einsum("bfk,bfd->bdk", a_lo, x32)
    else:
        vlad = torch.einsum("bfk,bfd->bdk", a, x32)
    vlad = vlad - a_sum * cluster_weights2.reshape(1, d, k)
    col = torch.sqrt(torch.clamp(torch.sum(vlad**2, dim=1, keepdim=True), min=1e-12))
    vlad = vlad / col
    tot = torch.sqrt(torch.clamp(torch.sum(vlad**2, dim=(1, 2), keepdim=True), min=1e-12))
    vlad = vlad / tot
    return vlad.to(x.dtype)


def fold_assignment_bn(scale, bias, mean, var, epsilon: float = 1e-3):
    """Inference-mode BN affine (γ = ``scale``, β = ``bias``, the flax
    names): scale' = γ/√(σ²+ε);  bias' = β − μ·scale'."""
    folded = scale / torch.sqrt(var + epsilon)
    return folded, bias - mean * folded
