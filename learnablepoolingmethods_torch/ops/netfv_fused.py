"""Fused NetFV (Net Fisher Vector): CUDA kernel wrapper and its plain version.

    A      = softmax(X·C · scale + bias)                 [F, K]  (BN folded)
    a_sum  = Σ_F A                                       [1, K]
    fv1    = XᵀA,  fv2 = (X²)ᵀA                          [D, K]
    fv2    = (a_sum·C₂² + fv2 − 2·fv1⊙C₂) / σ⁴ − a_sum
    fv1    = (fv1 − a_sum⊙C₂) / σ²
    each:  intra-ℓ2 over D, then global ℓ2 of the flattened vector

σ² arrives squared and floored (``covar = covar_weights² + 1e-6``), as the
flax module forms it.  Both outputs are ``[B, D, K]``; their d-major
flattens, concatenated, are the module's ``[B, 2·D·K]`` descriptor.  The
kernel (``csrc/netfv_fused.cu``) replaces
``learnablepoolingmethods_tpu/ops/netfv_pallas.py#netfv_fused``;
:func:`netfv_reference` transcribes that module's ``netfv_reference``, and
:func:`netfv_geometry` mirrors how the bf16 kernel tiles a shape.
"""

from __future__ import annotations

import ctypes

import torch

from learnablepoolingmethods_torch.ops import kernel_build
from learnablepoolingmethods_torch.ops.netvlad_fused import MAX_CLUSTERS, check_frames

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 4
    + [ctypes.c_void_p]
)
# the built kernel's report (lpm_netfv_geometry): the tiling, which
# netfv_geometry mirrors, then the one-pass kernel's dynamic shared memory
GEOMETRY_KEYS = ("ds", "cs", "kc", "dtiles", "ktiles", "blocks", "one_pass", "threads", "smem")
MAX_WARPS = 8  # a block's warps: 128 f32 accumulators a thread fit 256 threads
MAX_CLUSTER = 8  # the portable thread-block cluster size
ACCUMULATORS = 2 * 64 * 32 // 32  # f32 a thread: a warp's 64 × 32 tile of fv1 and of fv2


def netfv_geometry(d: int, k: int) -> dict:
    """How the bf16 kernel's aggregation (``csrc/netfv_fused.cu#fv_geometry``,
    which this mirrors) tiles a (D, K) shape: warps of 64 descriptor rows ×
    32 clusters, each holding that tile of fv1 and of fv2; ``ds`` row slabs ×
    ``cs`` cluster slabs a block (at most 8 warps), ``kc`` clusters a block,
    ``dtiles`` × ``ktiles`` blocks a video.  ``one_pass`` when a video's
    blocks fit one portable thread-block cluster: the one-pass tensor-core
    kernel; else the first port's two FMA passes (after the tensor-core
    logits).  The keys are GEOMETRY_KEYS but the last."""
    slabs, kslabs = -(-d // 64), -(-k // 32)
    ds = min(slabs, MAX_WARPS)
    cs = min(MAX_WARPS // ds, kslabs)
    dtiles, ktiles = -(-slabs // ds), -(-kslabs // cs)
    return dict(ds=ds, cs=cs, kc=32 * cs, dtiles=dtiles, ktiles=ktiles, blocks=dtiles * ktiles,
                one_pass=int(dtiles * ktiles <= MAX_CLUSTER), threads=32 * ds * cs)


def kernel_geometry(d: int, k: int) -> dict:
    """The geometry that the built kernel itself picks for (D, K), with its
    dynamic shared memory (``smem``, bytes); needs the library, so ``nvcc``
    (chip_smoke.py holds it against :func:`netfv_geometry`)."""
    lib_fn = kernel_build.load_function(
        "netfv_fused", "lpm_netfv_geometry", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib_fn.restype = None
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    lib_fn(d, k, ctypes.cast(out, ctypes.c_void_p))
    return dict(zip(GEOMETRY_KEYS, out))


def resident_clusters(d: int, k: int) -> int:
    """How many thread-block clusters the one-pass bf16 kernel runs at (D,
    K) on the current card, 16-byte-aligned rows (each walks videos y, y +
    that many, ...; a launch takes at most one per video); 0 where the shape
    takes the FMA passes.  Needs the library and a card."""
    lib_fn = kernel_build.load_function(
        "netfv_fused", "lpm_netfv_clusters", [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = ctypes.c_int(0)
    kernel_build.check(lib_fn(d, k, 1, ctypes.byref(out)), "netfv_fused")
    return out.value


def netfv_fused(
    x: torch.Tensor,                 # [B, F, D] bf16 or f32
    cluster_weights: torch.Tensor,   # [D, K]
    assign_scale: torch.Tensor,      # [K] folded BN γ/σ
    assign_bias: torch.Tensor,       # [K] folded BN β−μγ/σ
    cluster_weights2: torch.Tensor,  # [D, K] (or [1, D, K])
    covar: torch.Tensor,             # [D, K] squared and floored σ²
):
    """Fused NetFV → ``(fv1, fv2)``, each ``[B, D, K]`` in ``x.dtype``.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`netfv_reference`.  ``x`` may be a column slice of a wider
    ``[B, F, DT]`` tensor, as for :func:`netvlad_fused`.
    """
    args = (x, cluster_weights, assign_scale, assign_bias, cluster_weights2, covar)
    if x.device.type == "cpu":
        return netfv_reference(*args)
    b, f, d, k = check_frames("netfv_fused", x, cluster_weights, MAX_CLUSTERS)
    dev = x.device
    c = cluster_weights.to(device=dev, dtype=x.dtype).contiguous()
    scale = assign_scale.to(device=dev, dtype=torch.float32).reshape(k).contiguous()
    bias = assign_bias.to(device=dev, dtype=torch.float32).reshape(k).contiguous()
    c2 = cluster_weights2.to(device=dev, dtype=torch.float32).reshape(d, k).contiguous()
    cov = covar.to(device=dev, dtype=torch.float32).reshape(d, k).contiguous()

    fv1 = torch.empty((b, d, k), dtype=x.dtype, device=dev)
    fv2 = torch.empty((b, d, k), dtype=x.dtype, device=dev)
    ws_a = torch.empty((b * f, k), dtype=torch.float32, device=dev)
    ws_colsq = torch.empty((2, b, k), dtype=torch.float32, device=dev)
    fn = kernel_build.load_function("netfv_fused", "lpm_netfv_fused", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), x.stride(1), int(x.dtype == torch.bfloat16), c.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), c2.data_ptr(), cov.data_ptr(),
            fv1.data_ptr(), fv2.data_ptr(), ws_a.data_ptr(), ws_colsq.data_ptr(),
            b, f, d, k, torch.cuda.current_stream(dev).cuda_stream,
        )
    kernel_build.check(rc, "netfv_fused")
    netfv_fused.launches += 1
    return fv1, fv2


netfv_fused.launches = 0


def netfv_reference(x, cluster_weights, assign_scale, assign_bias, cluster_weights2, covar,
                    kernel_rounding: bool = False):
    """Plain PyTorch twin of :func:`netfv_fused` (the parity oracle): f32
    throughout, A unrounded, as the JAX module's ``netfv_reference``.

    ``kernel_rounding`` takes the kernels' rounding points instead (the
    TPU's and the CUDA one's): C in ``x.dtype``, A rounded to ``x.dtype``
    where it enters the two products and X² formed in ``x.dtype``; a_sum
    still sums the unrounded A.  For f32 input the two are the same
    function."""
    b, f, d = x.shape
    k = cluster_weights.shape[-1]
    xf = x.float()
    c2 = cluster_weights2.float().reshape(1, d, k)
    cov = covar.float().reshape(1, d, k)
    c = cluster_weights.to(x.dtype) if kernel_rounding else cluster_weights
    logits = (
        torch.einsum("bfd,dk->bfk", xf, c.float())
        * assign_scale.reshape(1, 1, k)
        + assign_bias.reshape(1, 1, k)
    )
    a = torch.softmax(logits, dim=-1)
    a_sum = torch.sum(a, dim=1, keepdim=True)  # [B, 1, K]
    if kernel_rounding:
        ax, x2 = a.to(x.dtype).float(), (x * x).float()
    else:
        ax, x2 = a, xf * xf
    fv1 = torch.einsum("bfk,bfd->bdk", ax, xf)
    fv2 = torch.einsum("bfk,bfd->bdk", ax, x2)
    fv2 = (a_sum * (c2 * c2) + fv2 - 2.0 * fv1 * c2) / (cov * cov) - a_sum
    fv1 = (fv1 - a_sum * c2) / cov

    def normalize(v):
        col = torch.sqrt(torch.clamp(torch.sum(v * v, dim=1, keepdim=True), min=1e-12))
        v = v / col
        tot = torch.sqrt(torch.clamp(torch.sum(v * v, dim=(1, 2), keepdim=True), min=1e-12))
        return v / tot

    return normalize(fv1).to(x.dtype), normalize(fv2).to(x.dtype)
