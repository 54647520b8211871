"""The hand kernels of the native runner's routes (``csrc/native_runner.cu``),
each between the runner's cuBLAS products and the TPU-kernel counterparts
(rows 1, 2, 5 and 6) that it also launches.

The tail that every route with a MoE head ends in:

- :func:`hidden_sum`: the hidden FC's per-modality products summed with its
  bias in the route's order, in f32, and that sum rounded to bf16 for the
  gating product;
- :func:`gating`: ``bf16(h · σ(gates · g_scale + g_bias))``, the folded
  context gating after its product;
- :func:`moe_combine`: ``Σ_m softmax_m(ga) · σ(ea + experts_bias)`` over the
  vocab-major MoE products (class v's mixture m in column m·V + v);
- :func:`topk`: exact top-k, sorted descending, the lowest index first
  among equal scores (``jax.lax.top_k``).

The steps of the other routes:

- :func:`frame_stage`: the staged route's frames on the card: each video's
  frames drawn from a key (iid, or one contiguous window), the uint8 rows
  gathered, dequantized in bf16, ℓ2 over the row in f32 and rounded to
  bf16, and with an input BN its folded affine and one more rounding
  (``ops/fast_infer.py#staged_frames``; DBoF takes no affine);
- :func:`bias_sigmoid`: ``σ(y + b)``, LogisticModel's output;
- :func:`bias_relu6`: ``clip(y + b, 0, 6)``, DBoF's two epilogues (f32, or
  rounded to bf16 for the MoE products);
- :func:`frame_pool`: DBoF's pooling over the sampled frames (average or
  max), rounded to bf16;
- :func:`row_l2`: ℓ2 of each row in f32, an optional folded affine, one
  rounding to bf16 (SoftDBoW's ℓ2 over K; NeXtVLAD's intra-ℓ2 with its
  folded ``vlad_bn``), or f32 out (the video-level routes' input,
  ``core/step.py#preprocess_input``);
- :func:`nextvlad_assign`: NeXtVLAD's assignment ``softmax_K(l · s + b) ·
  σ(α)`` in f32 and rounded to bf16;
- :func:`nextvlad_residual`: ``agg − (Σ_rows assign) · c2``.

They replace no ``pallas_call``: the JAX package leaves this arithmetic to
XLA's fusions (``learnablepoolingmethods_tpu/ops/fast_infer.py:64-88``,
``ops/fast_dbof.py``, ``ops/fast_lf.py``, ``ops/topk.py``).  The ``*_plain``
versions are that arithmetic in PyTorch; the fast routes compute with them
(``ops/fast_infer.py#gated_moe_tail``, ``ops/fast_lf.py``,
``ops/fast_dbof.py``), and so does the runner's plain version
(``core/native_runtime.py#plain_run``).  A wrapper takes its plain version
for CPU tensors and launches the runner library's entry point for CUDA
tensors (``chip_smoke.py`` holds each against its plain version); the
runner launches the same kernels itself and counts them apart
(``core/native_runtime.py#NativeExecutable.launches``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from learnablepoolingmethods_torch.ops import kernel_build
from learnablepoolingmethods_torch.ops.fused_frontend import (
    DEQ_BIAS,
    DEQ_SCALE,
    gather_frames,
    sample_indices,
    sequence_indices,
)
from learnablepoolingmethods_torch.ops.normalize import l2_normalize
from learnablepoolingmethods_torch.ops.topk import top_k_exact
from learnablepoolingmethods_torch.utils import prng
from learnablepoolingmethods_torch.utils.quantization import dequantize

LIBRARY = "native_runner"
MAX_PARTS = 4  # hidden_sum's products at most (NetFV: fv1 and fv2 of two modalities)
POOLING = ("average", "max")
_P, _I, _LL, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint, ctypes.c_float
BF16 = torch.bfloat16


# ---- plain versions ----------------------------------------------------------

def hidden_sum_plain(parts: Sequence[torch.Tensor], bias: torch.Tensor, group: int = 1,
                     bias_first: bool = False):
    """(h f32 [B, H], h rounded to bf16) of the hidden FC's products
    ``parts``, taken ``group`` at a time (a modality's products, summed left
    to right): ``bias + G_0 + G_1 …`` with ``bias_first`` (the LF routes'
    order, ``ops/fast_lf.py``), else ``(G_0 + G_1 …) + bias`` (Willow's)."""
    groups = []
    for i in range(0, len(parts), group):
        g = parts[i]
        for p in parts[i + 1:i + group]:
            g = g + p
        groups.append(g)
    if bias_first:
        h = bias
        for g in groups:
            h = h + g
    else:
        h = groups[0]
        for g in groups[1:]:
            h = h + g
        h = h + bias
    return h, h.to(BF16)


def gating_plain(gates: torch.Tensor, h: torch.Tensor, g_scale: torch.Tensor, g_bias: torch.Tensor,
                 ct: torch.dtype = BF16) -> torch.Tensor:
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


def frame_stage_plain(features: torch.Tensor, key, num_frames: torch.Tensor, num_samples: int,
                      in_scale: Optional[torch.Tensor] = None, in_bias: Optional[torch.Tensor] = None,
                      window: bool = False, row_offset: int = 0) -> torch.Tensor:
    """uint8 frames [B, F, DT] → the S frames of each video [B, S, DT] bf16,
    drawn from ``key`` iid (``ops/fused_frontend.py#sample_indices``) or as
    one window (``#sequence_indices``): gathered, dequantized in bf16, ℓ2
    over the row, and with ``in_scale`` the folded input BN in f32 and one
    rounding (``ops/fast_infer.py#staged_frames``)."""
    draw = sequence_indices if window else sample_indices
    idx = draw(key, num_frames, features.shape[1], num_samples, row_offset)
    x = l2_normalize(dequantize(gather_frames(features, idx), dtype=BF16), dim=-1)
    if in_scale is None:
        return x
    return (x.float() * in_scale + in_bias).to(BF16)


def bias_sigmoid_plain(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(y + bias)


def bias_relu6_plain(y: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.clamp(y + bias, 0.0, 6.0).to(dtype)


def frame_pool_plain(act: torch.Tensor, method: str, dtype: torch.dtype = BF16) -> torch.Tensor:
    """``act`` [B, S, C] f32 pooled over S → [B, C] in ``dtype`` (the
    kernel's: bf16), as ``models/model_utils.py#frame_pooling`` pools."""
    if method not in POOLING:
        raise ValueError(f"Unrecognized pooling method: {method}")
    pooled = torch.mean(act, dim=1) if method == "average" else torch.amax(act, dim=1)
    return pooled.to(dtype)


def row_l2_plain(x: torch.Tensor, scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = BF16) -> torch.Tensor:
    """Rows of ``x`` [R, n] f32 ℓ2-normalized, then with ``scale`` the folded
    affine ``y · scale + bias`` (both [A·n]: row r takes entries
    (r mod A)·n …), rounded once to ``dtype`` (the kernel's: bf16)."""
    y = l2_normalize(x, dim=-1)
    if scale is None:
        return y.to(dtype)
    rows, n = x.shape
    span = scale.numel()
    return (y.reshape(rows * n // span, span) * scale + bias).reshape(rows, n).to(dtype)


def nextvlad_assign_plain(prod: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, gprod: torch.Tensor,
                          dtype: torch.dtype = BF16):
    """NeXtVLAD's assignment from its products ``prod`` [R, G·K] and
    ``gprod`` [R, G] (f32): (``softmax_K(prod · scale + bias) · σ(gprod)``
    f32 [R, G, K], the same rounded to ``dtype``, the kernel's bf16)."""
    r, g = gprod.shape
    alpha = torch.sigmoid(gprod)
    logits = (prod * scale + bias).reshape(r, g, -1)
    assign = torch.softmax(logits, dim=-1) * alpha[..., None]
    return assign, assign.to(dtype)


def nextvlad_residual_plain(agg: torch.Tensor, assign: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """``agg`` [B, K, D'] − Σ over ``assign`` [B, S, G, K]'s S and G · ``c2``
    [K, D'] (f32)."""
    return agg - torch.sum(assign, dim=(1, 2))[:, :, None] * c2[None]


# ---- the kernels ---------------------------------------------------------------

def _check(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous {dtype} CUDA tensors, got {t.dtype} on {t.device}")


def _f32(name: str, *tensors: torch.Tensor) -> None:
    _check(name, torch.float32, *tensors)


def _launch(name: str, symbol: str, argtypes, *args, device) -> None:
    fn = kernel_build.load_function(LIBRARY, symbol, argtypes)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    kernel_build.check(rc, name)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def hidden_sum(parts: Sequence[torch.Tensor], bias: torch.Tensor, group: int = 1, bias_first: bool = False):
    """:func:`hidden_sum_plain` on the card (the kernel) or the CPU."""
    parts = list(parts)
    if parts[0].device.type == "cpu":
        return hidden_sum_plain(parts, bias, group, bias_first)
    _f32("hidden_sum", *parts, bias)
    rows, width = parts[0].shape
    if (not 1 <= len(parts) <= MAX_PARTS or group < 1 or len(parts) % group
            or any(p.shape != parts[0].shape for p in parts) or bias.shape != (width,)):
        raise ValueError(f"hidden_sum: {len(parts)} parts of {[tuple(p.shape) for p in parts]} in groups of "
                         f"{group}, bias {tuple(bias.shape)}")
    h = torch.empty_like(parts[0])
    hb = torch.empty(h.shape, dtype=BF16, device=h.device)
    ptrs = [p.data_ptr() for p in parts] + [None] * (MAX_PARTS - len(parts))
    _launch("hidden_sum", "lpm_hidden_sum", [_P] * MAX_PARTS + [_I] * 3 + [_P] * 3 + [_LL, _I, _P],
            *ptrs, len(parts), group, int(bias_first), bias.data_ptr(), h.data_ptr(), hb.data_ptr(), rows,
            width, device=h.device)
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
    out = torch.empty(gates.shape, dtype=BF16, device=gates.device)
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


def frame_stage(features: torch.Tensor, key, num_frames: torch.Tensor, num_samples: int,
                in_scale: Optional[torch.Tensor] = None, in_bias: Optional[torch.Tensor] = None,
                window: bool = False) -> torch.Tensor:
    """:func:`frame_stage_plain` on the card (the kernel, which draws the
    frames from ``key`` itself) or the CPU."""
    if features.device.type == "cpu":
        return frame_stage_plain(features, key, num_frames, num_samples, in_scale, in_bias, window)
    _check("frame_stage", torch.uint8, features)
    _check("frame_stage", torch.int32, num_frames)
    b, f, dt = features.shape
    if in_scale is not None:
        _f32("frame_stage", in_scale, in_bias)
        if in_scale.shape != (dt,) or in_bias.shape != (dt,):
            raise ValueError(f"frame_stage: affine {tuple(in_scale.shape)} for rows of {dt}")
    if num_frames.shape != (b,) or num_samples < 1 or not 1 <= b <= 65535:
        raise ValueError(f"frame_stage: B={b}, num_frames {tuple(num_frames.shape)}, S={num_samples}")
    k0, k1 = prng.key_words(key)
    out = torch.empty((b, num_samples, dt), dtype=BF16, device=features.device)
    _launch("frame_stage", "lpm_frame_stage", [_P, _U, _U] + [_P] * 4 + [_I] * 5 + [_F, _F, _P],
            features.data_ptr(), k0, k1, num_frames.data_ptr(), _ptr(in_scale), _ptr(in_bias), out.data_ptr(),
            b, f, dt, num_samples, int(window), DEQ_SCALE, DEQ_BIAS, device=features.device)
    frame_stage.launches += 1
    return out


def _bias_rows(name: str, y: torch.Tensor, bias: torch.Tensor):
    _f32(name, y, bias)
    rows, width = y.shape
    if bias.shape != (width,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} for rows of {width}")
    return rows, width


def bias_sigmoid(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """:func:`bias_sigmoid_plain` on the card (the kernel) or the CPU."""
    if y.device.type == "cpu":
        return bias_sigmoid_plain(y, bias)
    rows, width = _bias_rows("bias_sigmoid", y, bias)
    out = torch.empty_like(y)
    _launch("bias_sigmoid", "lpm_bias_sigmoid", [_P] * 3 + [_LL, _I, _P],
            y.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, width, device=y.device)
    bias_sigmoid.launches += 1
    return out


def bias_relu6(y: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`bias_relu6_plain` (f32 or bf16 out) on the card (the kernel)
    or the CPU."""
    if y.device.type == "cpu":
        return bias_relu6_plain(y, bias, dtype)
    rows, width = _bias_rows("bias_relu6", y, bias)
    if dtype not in (torch.float32, BF16):
        raise ValueError(f"bias_relu6: out dtype {dtype}")
    out = torch.empty(y.shape, dtype=dtype, device=y.device)
    f32_out, bf16_out = (out, None) if dtype == torch.float32 else (None, out)
    _launch("bias_relu6", "lpm_bias_relu6", [_P] * 4 + [_LL, _I, _P],
            y.data_ptr(), bias.data_ptr(), _ptr(f32_out), _ptr(bf16_out), rows, width, device=y.device)
    bias_relu6.launches += 1
    return out


def frame_pool(act: torch.Tensor, method: str) -> torch.Tensor:
    """:func:`frame_pool_plain` on the card (the kernel) or the CPU."""
    if act.device.type == "cpu":
        return frame_pool_plain(act, method)
    _f32("frame_pool", act)
    if method not in POOLING:
        raise ValueError(f"Unrecognized pooling method: {method}")
    b, s, c = act.shape
    out = torch.empty((b, c), dtype=BF16, device=act.device)
    _launch("frame_pool", "lpm_frame_pool", [_P, _P] + [_I] * 4 + [_P],
            act.data_ptr(), out.data_ptr(), b, s, c, int(method == "max"), device=act.device)
    frame_pool.launches += 1
    return out


def row_l2(x: torch.Tensor, scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
           dtype: torch.dtype = BF16):
    """:func:`row_l2_plain` (bf16 or f32 out) on the card (the kernel) or
    the CPU."""
    if x.device.type == "cpu":
        return row_l2_plain(x, scale, bias, dtype)
    _f32("row_l2", x)
    if dtype not in (torch.float32, BF16):
        raise ValueError(f"row_l2: out dtype {dtype}")
    rows, n = x.shape
    arows = 0
    if scale is not None:
        _f32("row_l2", scale, bias)
        arows = scale.numel() // n
        if scale.numel() != arows * n or bias.shape != scale.shape or arows < 1 or rows % arows:
            raise ValueError(f"row_l2: affine of {scale.numel()} for {rows} rows of {n}")
    out = torch.empty((rows, n), dtype=dtype, device=x.device)
    f32_out, bf16_out = (out, None) if dtype == torch.float32 else (None, out)
    _launch("row_l2", "lpm_row_l2", [_P] * 3 + [_I, _P, _P, _LL, _I, _P],
            x.data_ptr(), _ptr(scale), _ptr(bias), arows, _ptr(f32_out), _ptr(bf16_out), rows, n, device=x.device)
    row_l2.launches += 1
    return out


def nextvlad_assign(prod: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, gprod: torch.Tensor):
    """:func:`nextvlad_assign_plain` on the card (the kernel) or the CPU."""
    if prod.device.type == "cpu":
        return nextvlad_assign_plain(prod, scale, bias, gprod)
    _f32("nextvlad_assign", prod, scale, bias, gprod)
    r, g = gprod.shape
    k = prod.shape[1] // g
    if prod.shape != (r, g * k) or scale.shape != (g * k,) or bias.shape != (g * k,):
        raise ValueError(f"nextvlad_assign: shapes {tuple(prod.shape)}, {tuple(gprod.shape)}, {tuple(scale.shape)}")
    assign = torch.empty((r, g, k), dtype=torch.float32, device=prod.device)
    assign_bf16 = torch.empty((r, g, k), dtype=BF16, device=prod.device)
    _launch("nextvlad_assign", "lpm_nextvlad_assign", [_P] * 6 + [_LL, _I, _I, _P],
            prod.data_ptr(), scale.data_ptr(), bias.data_ptr(), gprod.data_ptr(), assign.data_ptr(),
            assign_bf16.data_ptr(), r, g, k, device=prod.device)
    nextvlad_assign.launches += 1
    return assign, assign_bf16


def nextvlad_residual(agg: torch.Tensor, assign: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """:func:`nextvlad_residual_plain` on the card (the kernel) or the CPU."""
    if agg.device.type == "cpu":
        return nextvlad_residual_plain(agg, assign, c2)
    _f32("nextvlad_residual", agg, assign, c2)
    b, k, dp = agg.shape
    sg = assign.numel() // (b * k)
    if assign.shape[0] != b or assign.shape[-1] != k or assign.numel() != b * sg * k or c2.shape != (k, dp):
        raise ValueError(f"nextvlad_residual: shapes {tuple(agg.shape)}, {tuple(assign.shape)}, {tuple(c2.shape)}")
    out = torch.empty_like(agg)
    _launch("nextvlad_residual", "lpm_nextvlad_residual", [_P] * 4 + [_I] * 4 + [_P],
            agg.data_ptr(), assign.data_ptr(), c2.data_ptr(), out.data_ptr(), b, sg, k, dp, device=agg.device)
    nextvlad_residual.launches += 1
    return out


WRAPPERS = (hidden_sum, gating, moe_combine, topk, frame_stage, bias_sigmoid, bias_relu6, frame_pool, row_l2,
            nextvlad_assign, nextvlad_residual)
for _wrapper in WRAPPERS:
    _wrapper.launches = 0
