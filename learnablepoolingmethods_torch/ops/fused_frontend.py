"""Fused inference front end: uint8 frames → both NetVLAD descriptors.

Per video: frame sampling → dequantize → per-frame ℓ2 over the full 1152-d
vector (the norm couples rgb and audio, so the kernel takes the unsplit
tensor) → folded input BN → NetVLAD on the rgb slice (K) and on the audio
slice (K/2).  The kernel (``csrc/fused_frontend.cu``) replaces
``learnablepoolingmethods_tpu/ops/fused_frontend.py#netvlad_frontend_fused``;
:func:`netvlad_frontend_reference` transcribes that module's
``netvlad_frontend_reference``.  The caller passes a ``utils/prng.py`` key;
the kernel draws each video's frames from it on the card, the plain version
through :func:`sample_indices`, and both draw the indices the JAX package's
``sample_indices`` draws from the same key, so the fused and staged routes
see the same frames.
"""

from __future__ import annotations

import ctypes

import torch

from learnablepoolingmethods_torch.ops import kernel_build
from learnablepoolingmethods_torch.ops.netvlad_fused import (
    MAX_CLUSTERS,
    aggregation_geometry,
    netvlad_reference,
)
from learnablepoolingmethods_torch.ops.normalize import l2_normalize
from learnablepoolingmethods_torch.utils import prng

DEQ_SCALE = 4.0 / 255.0
DEQ_BIAS = 4.0 / 512.0 - 2.0

_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_uint] * 2 + [ctypes.c_void_p] * 18 + [
    ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p]


def sample_indices(
    key: torch.Tensor, num_frames: torch.Tensor, max_frames: int, num_samples: int,
    row_offset: int = 0,
) -> torch.Tensor:
    """floor(U·min(num_frames, F)) clamped to F−1: ``[B, num_samples]``
    int32 on ``num_frames``' device (ref: model_utils.py#SampleRandomFrames).
    ``key`` is a ``utils/prng.py`` key; U is ``jax.random.uniform(key,
    (B, num_samples))`` bit for bit, so the indices are those of the JAX
    package's ``sample_indices`` under the same key.  With ``row_offset``
    the rows are rows ``row_offset`` … of a larger batch's draw (a rank's
    rows of the global batch, ``parallel/mesh.py``)."""
    b = num_frames.shape[0]
    nf = torch.clamp(num_frames.to(torch.int32), max=max_frames)
    u = prng.uniform(key, (b, num_samples), device=num_frames.device, offset=row_offset * num_samples)
    return torch.clamp((u * nf[:, None].float()).to(torch.int32), max=max_frames - 1)


def sequence_indices(key, num_frames: torch.Tensor, max_frames: int, num_samples: int,
                     row_offset: int = 0) -> torch.Tensor:
    """The frames of one random window a video: ``[B, num_samples]`` int32,
    start floor(U·(max(nf − S, 0) + 1)) with U ``[B, 1]`` from ``key``, index
    min(start + s, nf − 1) clipped to [0, F − 1], nf = min(num_frames, F)
    (ref: model_utils.py#sample_random_sequence); U of rows ``row_offset`` …
    of the draw."""
    b = num_frames.shape[0]
    nf = torch.clamp(num_frames.to(torch.int32), max=max_frames).reshape(b, 1)
    u = prng.uniform(key, (b, 1), device=num_frames.device, offset=row_offset)
    max_start = torch.clamp(nf - num_samples, min=0)
    start = (u * (max_start.float() + 1.0)).to(torch.int32)
    offset = torch.arange(num_samples, dtype=torch.int32, device=num_frames.device)[None, :]
    return torch.clamp(torch.minimum(start + offset, nf - 1), 0, max_frames - 1)


def gather_frames(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``x[b, idx[b, s]]`` of ``x`` [B, F, C] → [B, S, C]; an index
    outside [0, F) gives a zero row, as the TPU's one-hot matmul on float
    rows does."""
    valid = (idx >= 0) & (idx < x.shape[1])
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    rows = torch.gather(x, 1, safe[:, :, None].expand(-1, -1, x.shape[2]))
    return torch.where(valid[:, :, None], rows, torch.zeros((), dtype=x.dtype, device=x.device))


def netvlad_frontend(
    x_u8: torch.Tensor,         # [B, F, DT] uint8
    key: torch.Tensor,          # utils/prng.py key of the frame draws
    num_frames: torch.Tensor,   # [B] int32 valid frames per video
    num_samples: int,           # S, frames drawn per video
    in_scale, in_bias,          # [DT] folded input-BN affine
    c_rgb, s_rgb, b_rgb, c2_rgb,   # rgb NetVLAD consts
    c_aud, s_aud, b_aud, c2_aud,   # audio NetVLAD consts
    row_offset: int = 0,        # global index of the first video (a rank's rows)
):
    """Returns (vlad_rgb [B, d_rgb, k_rgb], vlad_aud [B, d_aud, k_aud]) bf16.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`netvlad_frontend_reference`.  The frames are those of rows
    ``row_offset`` … of a batch's draw from ``key`` (:func:`sample_indices`).
    """
    args = (in_scale, in_bias, c_rgb, s_rgb, b_rgb, c2_rgb, c_aud, s_aud, b_aud, c2_aud)
    if x_u8.device.type == "cpu":
        return netvlad_frontend_reference(x_u8, key, num_frames, num_samples, *args, row_offset=row_offset)
    if x_u8.device.type != "cuda":
        raise ValueError(f"netvlad_frontend: unsupported device {x_u8.device}")
    if x_u8.dim() != 3 or x_u8.dtype != torch.uint8 or not x_u8.is_contiguous():
        raise ValueError(
            f"netvlad_frontend: x must be contiguous [B, F, DT] uint8, got "
            f"{tuple(x_u8.shape)} {x_u8.dtype}"
        )
    b, f, dt = x_u8.shape
    if num_frames.shape != (b,) or num_frames.device != x_u8.device:
        raise ValueError(
            f"netvlad_frontend: num_frames must be [B] on {x_u8.device}, got "
            f"{tuple(num_frames.shape)} on {num_frames.device}"
        )
    k0, k1 = prng.key_words(key)
    nf = num_frames.to(torch.int32).contiguous()
    s = int(num_samples)
    d_rgb, k_rgb = c_rgb.shape
    d_aud, k_aud = c_aud.shape
    if d_rgb + d_aud != dt:
        raise ValueError(f"netvlad_frontend: d_rgb {d_rgb} + d_aud {d_aud} != DT {dt}")
    if max(k_rgb, k_aud) > MAX_CLUSTERS or not 1 <= b <= 65535 or s < 1:
        raise ValueError(
            f"netvlad_frontend: needs K <= {MAX_CLUSTERS}, 1 <= B <= 65535, S >= 1; "
            f"got K={k_rgb}/{k_aud}, B={b}, S={s}"
        )
    dev = x_u8.device

    def f32(t, n):
        return t.to(device=dev, dtype=torch.float32).reshape(n).contiguous()

    def mat(t, dtype, d, k):
        return t.to(device=dev, dtype=dtype).reshape(d, k).contiguous()

    consts = [
        f32(in_scale, dt), f32(in_bias, dt),
        mat(c_rgb, torch.bfloat16, d_rgb, k_rgb), f32(s_rgb, k_rgb), f32(b_rgb, k_rgb),
        mat(c2_rgb, torch.float32, d_rgb, k_rgb),
        mat(c_aud, torch.bfloat16, d_aud, k_aud), f32(s_aud, k_aud), f32(b_aud, k_aud),
        mat(c2_aud, torch.float32, d_aud, k_aud),
    ]
    out_rgb = torch.empty((b, d_rgb, k_rgb), dtype=torch.bfloat16, device=dev)
    out_aud = torch.empty((b, d_aud, k_aud), dtype=torch.bfloat16, device=dev)
    ws_x = torch.empty((b * s, dt), dtype=torch.bfloat16, device=dev)
    ws_a_rgb = torch.empty((b * s, k_rgb), dtype=torch.float32, device=dev)
    ws_a_aud = torch.empty((b * s, k_aud), dtype=torch.float32, device=dev)
    ws_cs_rgb, ws_cs_aud = (
        torch.empty((b * aggregation_geometry(d_m, k_m)["dchunks"], k_m), dtype=torch.float32,
                    device=dev)
        for d_m, k_m in ((d_rgb, k_rgb), (d_aud, k_aud)))
    fn = kernel_build.load_function("fused_frontend", "lpm_netvlad_frontend", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            x_u8.data_ptr(), k0, k1, nf.data_ptr(), *(t.data_ptr() for t in consts),
            out_rgb.data_ptr(), out_aud.data_ptr(), ws_x.data_ptr(),
            ws_a_rgb.data_ptr(), ws_a_aud.data_ptr(), ws_cs_rgb.data_ptr(), ws_cs_aud.data_ptr(),
            b, f, dt, s, d_rgb, k_rgb, d_aud, k_aud, DEQ_SCALE, DEQ_BIAS, int(row_offset),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernel_build.check(rc, "netvlad_frontend")
    netvlad_frontend.launches += 1
    return out_rgb, out_aud


netvlad_frontend.launches = 0


def netvlad_frontend_reference(
    x_u8, key, num_frames, num_samples, in_scale, in_bias,
    c_rgb, s_rgb, b_rgb, c2_rgb,
    c_aud, s_aud, b_aud, c2_aud,
    row_offset: int = 0,
):
    """Plain PyTorch twin (gather-based) of the fused front end — the
    parity oracle."""
    d_rgb = c_rgb.shape[0]
    idx = sample_indices(key, num_frames, x_u8.shape[1], num_samples, row_offset)
    xf = x_u8.float() * DEQ_SCALE + DEQ_BIAS
    xf = l2_normalize(xf, dim=-1)
    xf = xf * in_scale.reshape(1, 1, -1) + in_bias.reshape(1, 1, -1)
    xs = gather_frames(xf, idx).to(torch.bfloat16)
    vlad_rgb = netvlad_reference(xs[:, :, :d_rgb], c_rgb, s_rgb, b_rgb, c2_rgb)
    vlad_aud = netvlad_reference(xs[:, :, d_rgb:], c_aud, s_aud, b_aud, c2_aud)
    return vlad_rgb, vlad_aud
