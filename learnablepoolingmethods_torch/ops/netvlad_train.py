"""NetVLAD aggregation for training: CUDA forward and backward kernels.

    A   = softmax(L)              [B, F, K]
    S   = Σ_F A                   [B, 1, K]
    V₁  = Xᵀ·A − S⊙C₂             [B, D, K]   (A rounded to X's dtype here)
    V₂  = V₁ / ‖V₁‖_col           (intra-ℓ2 over D, per cluster)
    V₃  = V₂ / ‖V₂‖_F             (global ℓ2), in X's dtype

:func:`netvlad_aggregate` is the ``torch.autograd.Function`` that the
NetVLAD module calls for everything after the assignment BN.  Its forward
saves only (X, L, C₂), and its backward recomputes A and V and returns
dX (X's dtype), dL (f32) and dC₂ (f32), as the JAX custom VJP does.

The two kernels (``csrc/netvlad_train.cu``) replace
``learnablepoolingmethods_tpu/ops/netvlad_train.py#_forward_impl`` and
``#_backward_impl``.  Beside each wrapper is its plain PyTorch version, a
step-by-step transcription of the TPU kernel with the same rounding points;
a CPU tensor takes it, a CUDA tensor launches the kernel.
:func:`netvlad_aggregate_reference` is the autograd composition of the JAX
module's ``netvlad_aggregate_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from learnablepoolingmethods_torch.ops import kernel_build
from learnablepoolingmethods_torch.ops.netvlad_fused import MAX_CLUSTERS

EPS = 1e-12
AGG_ROWS = 64        # csrc/netvlad_core.cuh kAggRows: rows per partial sum
MAX_GROUPS = 16      # video groups whose dC₂ partials the backward sums in order

_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p
]
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p
]


def _check(name: str, x, logits, c2, dv3=None):
    """Validate the kernels' inputs; returns (B, F, D, K)."""
    if x.dim() != 3 or x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous [B, F, D] bf16/f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, f, d = x.shape
    if logits.dim() != 3 or logits.shape[:2] != (b, f) or logits.dtype != torch.float32 \
            or not logits.is_contiguous():
        raise ValueError(f"{name}: logits must be contiguous [B, F, K] f32 for x "
                         f"{tuple(x.shape)}, got {tuple(logits.shape)} {logits.dtype}")
    k = logits.shape[2]
    if c2.shape != (d, k) or c2.dtype != torch.float32 or not c2.is_contiguous():
        raise ValueError(f"{name}: c2 must be contiguous [D, K] = [{d}, {k}] f32, got "
                         f"{tuple(c2.shape)} {c2.dtype}")
    if dv3 is not None and (dv3.shape != (b, d, k) or dv3.dtype != x.dtype
                            or not dv3.is_contiguous()):
        raise ValueError(f"{name}: dv3 must be contiguous [B, D, K] {x.dtype}, got "
                         f"{tuple(dv3.shape)} {dv3.dtype}")
    if not 1 <= k <= MAX_CLUSTERS or not 1 <= b <= 65535:
        raise ValueError(f"{name}: needs K <= {MAX_CLUSTERS}, B <= 65535; got K={k}, B={b}")
    for t in (logits, c2) + (() if dv3 is None else (dv3,)):
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on {t.device} and {x.device}")
    return b, f, d, k


def netvlad_aggregate_forward(x: torch.Tensor, logits: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """V₃ ``[B, D, K]`` in ``x.dtype`` from X ``[B, F, D]``, post-BN logits
    ``[B, F, K]`` f32 and C₂ ``[D, K]`` f32.  A CUDA tensor launches the
    kernel; a CPU tensor takes :func:`netvlad_aggregate_forward_plain`."""
    if x.device.type == "cpu":
        return netvlad_aggregate_forward_plain(x, logits, c2)
    if x.device.type != "cuda":
        raise ValueError(f"netvlad_aggregate_forward: unsupported device {x.device}")
    b, f, d, k = _check("netvlad_aggregate_forward", x, logits, c2)
    dev = x.device
    out = torch.empty((b, d, k), dtype=x.dtype, device=dev)
    ws_a = torch.empty((b * f, k), dtype=torch.float32, device=dev)
    ws_colsq = torch.empty((b, k), dtype=torch.float32, device=dev)
    fn = kernel_build.load_function("netvlad_train", "lpm_netvlad_train_forward", _FWD_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), logits.data_ptr(), c2.data_ptr(),
            out.data_ptr(), ws_a.data_ptr(), ws_colsq.data_ptr(), b, f, d, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernel_build.check(rc, "netvlad_aggregate_forward")
    netvlad_aggregate_forward.launches += 1
    return out


netvlad_aggregate_forward.launches = 0


def netvlad_aggregate_backward(x, logits, c2, dv3):
    """(dX in ``x.dtype``, dL f32, dC₂ f32) for the cotangent ``dv3``
    ``[B, D, K]`` in ``x.dtype``.  A CUDA tensor launches the kernel; a CPU
    tensor takes :func:`netvlad_aggregate_backward_plain`.  dC₂ sums over the
    batch in a fixed order, so the kernel's result does not vary from run to
    run."""
    if x.device.type == "cpu":
        return netvlad_aggregate_backward_plain(x, logits, c2, dv3)
    if x.device.type != "cuda":
        raise ValueError(f"netvlad_aggregate_backward: unsupported device {x.device}")
    b, f, d, k = _check("netvlad_aggregate_backward", x, logits, c2, dv3)
    dev = x.device
    n_rows = -(-d // AGG_ROWS)
    n_groups = min(b, MAX_GROUPS)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dx = torch.empty_like(x)
    dl = f32(b, f, k)
    dc2 = f32(d, k)
    ws_dv1 = torch.empty((b, d, k), dtype=x.dtype, device=dev)
    scratch = [f32(b * f, k), f32(b, n_rows, k), f32(b, n_rows, k), f32(b, k), f32(b, k),
               f32(b, 2), f32(b, n_rows, k), f32(n_groups, d, k)]
    fn = kernel_build.load_function("netvlad_train", "lpm_netvlad_train_backward", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), logits.data_ptr(), c2.data_ptr(),
            dv3.data_ptr(), dx.data_ptr(), dl.data_ptr(), dc2.data_ptr(), ws_dv1.data_ptr(),
            *(t.data_ptr() for t in scratch), b, f, d, k, n_groups,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernel_build.check(rc, "netvlad_aggregate_backward")
    netvlad_aggregate_backward.launches += 1
    return dx, dl, dc2


netvlad_aggregate_backward.launches = 0


def _recompute(x, logits, c2):
    """A, S, V₁, 1/‖V₁‖_col, V₂, 1/‖V₂‖_F as ``_bwd_kernel`` recomputes them."""
    a = torch.softmax(logits.float(), dim=-1)
    s = torch.sum(a, dim=1, keepdim=True)
    v1 = torch.einsum("bfd,bfk->bdk", x.float(), a.to(x.dtype).float()) - s * c2[None]
    inv_c = torch.rsqrt(torch.clamp(torch.sum(v1 * v1, dim=1, keepdim=True), min=EPS))
    v2 = v1 * inv_c
    inv_g = torch.rsqrt(torch.clamp(torch.sum(v2 * v2, dim=(1, 2), keepdim=True), min=EPS))
    return a, s, v1, inv_c, v2, inv_g


def netvlad_aggregate_forward_plain(x, logits, c2):
    """Plain PyTorch version of the forward kernel (``_fwd_kernel``): A is
    rounded to ``x.dtype`` before XᵀA, sums are f32."""
    _, _, _, _, v2, inv_g = _recompute(x, logits, c2)
    return (v2 * inv_g).to(x.dtype)


def netvlad_aggregate_backward_plain(x, logits, c2, dv3):
    """Plain PyTorch version of the backward kernel (``_bwd_kernel``): the
    normalisation VJPs in f32, dV₁ rounded to ``x.dtype`` before X·dV₁ and
    A·dV₁ᵀ, dC₂ summed over the batch."""
    a, s, _, inv_c, v2, inv_g = _recompute(x, logits, c2)
    v3 = v2 * inv_g
    dv3 = dv3.float()
    dv2 = (dv3 - v3 * torch.sum(v3 * dv3, dim=(1, 2), keepdim=True)) * inv_g
    dv1 = (dv2 - v2 * torch.sum(v2 * dv2, dim=1, keepdim=True)) * inv_c
    dc2 = torch.sum(-dv1 * s, dim=0)
    ds = -torch.sum(dv1 * c2[None], dim=1, keepdim=True)
    dv1_c = dv1.to(x.dtype).float()
    da = torch.einsum("bfd,bdk->bfk", x.float(), dv1_c) + ds
    dl = a * (da - torch.sum(a * da, dim=-1, keepdim=True))
    dx = torch.einsum("bfk,bdk->bfd", a.to(x.dtype).float(), dv1_c)
    return dx.to(x.dtype), dl, dc2


class _NetVLADAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, logits, c2):
        ctx.save_for_backward(x, logits, c2)
        return netvlad_aggregate_forward(x, logits, c2)

    @staticmethod
    def backward(ctx, dv3):
        x, logits, c2 = ctx.saved_tensors
        return netvlad_aggregate_backward(x, logits, c2, dv3.to(x.dtype).contiguous())


def netvlad_aggregate(x: torch.Tensor, logits: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Differentiable fused aggregation → ``[B, D, K]`` in ``x.dtype``.

    x ``[B, F, D]`` bf16 or f32; logits ``[B, F, K]`` post-BN assignment
    logits; c2 ``[D, K]`` cluster centres.  The residuals are (x, logits,
    c2) alone; the backward recomputes A and V."""
    return _NetVLADAggregate.apply(
        x.contiguous(), logits.float().contiguous(), c2.float().contiguous()
    )


def netvlad_aggregate_reference(x, logits, c2):
    """Autograd composition (the JAX package's
    ``netvlad_aggregate_reference``): f32 throughout, A never rounded."""
    a = torch.softmax(logits.float(), dim=-1)
    s = torch.sum(a, dim=1, keepdim=True)
    v1 = torch.einsum("bfk,bfd->bdk", a, x.float()) - s * c2.float()[None]
    col = torch.sqrt(torch.clamp(torch.sum(v1 * v1, dim=1, keepdim=True), min=EPS))
    v2 = v1 / col
    tot = torch.sqrt(torch.clamp(torch.sum(v2 * v2, dim=(1, 2), keepdim=True), min=EPS))
    return v2 / tot
