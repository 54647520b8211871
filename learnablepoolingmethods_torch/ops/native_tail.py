"""The hand kernels of the native runner's routes (``csrc/native_runner.cu``),
each between the runner's cuBLAS products and the TPU-kernel counterparts
(rows 1, 2, 5, 6 and 7) that it also launches.

The tail that every route with a MoE head ends in:

- :func:`hidden_sum`: the hidden FC's per-modality products summed with its
  bias in the route's order, in f32, and that sum rounded to bf16 for the
  gating product;
- :func:`gating`: ``bf16(h · σ(gates · g_scale + g_bias))``, the folded
  context gating after its product;
- :func:`moe_combine`: ``Σ_m softmax_m(ga) · σ(ea + experts_bias)`` over the
  vocab-major MoE products (class v's mixture m in column m·V + v);
- :func:`topk`: exact top-k in ``jax.lax.top_k``'s order (the float total
  order, the lowest index first among equal bits: ``ops/topk.py``).

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
- :func:`nextvlad_residual`: ``agg − (Σ_rows assign) · c2`` (the kernel sums
  each cluster's column in a fixed order: ``RESIDUAL_TILE``).

The steps of the routes that read every frame (the transformer family and
FrameLevelLogisticModel):

- :func:`frame_stage_all`: frame_stage's kernel with no draw: every frame
  dequantized, ℓ2 over the row in f32, out in bf16 (dequantized in bf16) or
  f32 (dequantized in f32, ``core/step.py#preprocess_input``), and the f32
  key mask ``f < num_frames``;
- :func:`bias_act`: ``bf16(y + b)``, or ``bf16(relu(y + b))``, a product's
  epilogue;
- :func:`residual_layernorm`: ``bf16(LN(f32(x) + f32(y)))`` with the fast
  path's LayerNorm (var = E[x²] − mean², no clamp; ε 1e-6), then its scale
  and bias; optionally times the key mask (AttentionNetVLAD's pad rows);
- :func:`masked_mean`: ``Σ_f x · mask`` in f32 over ``max(count, 1)``: the
  count of valid frames (the transformer's pooling) or ``num_frames``
  itself (FrameLevelLogisticModel's).

The steps of the f32 routes of the models with no fast route
(AttentionPoolingModel and the RNNs; ``models/attention.py``,
``models/frame_level.py``), each the flax graph's f32 arithmetic:

- :func:`lstm_cell`: one step of flax's ``OptimizedLSTMCell`` for every row
  from the step's products: the gates ``(h·W_h + b_h) + x_t·W_i`` in the
  order i, f, g, o, then c′ = σ(f)·c + σ(i)·tanh(g), h′ = σ(o)·tanh(c′);
- :func:`gru_cell`: one step of flax's ``GRUCell`` (reset after): r, z =
  σ((x·W_i + b_i) + h·W_h), n = tanh((x·W_in + b_in) + r·(h·W_hn + b_hn)),
  h′ = (1 − z)·n + z·h;
  both optionally set the final carry's rows whose last index
  (:func:`last_frame`, flax's ``_select_last_carry``) is this step to h′;
- :func:`gru_layer`: a whole GRU layer over every frame from a zero state,
  each step's h·W_h and :func:`gru_cell`'s arithmetic, the outputs and the
  carry: one persistent launch that keeps W_h in shared memory (the native
  runner's GRU route; :func:`gru_cell` stays as an entry point);
- :func:`pool_attention`: learned-query attention: Q queries (their
  projection, computed once) over every frame's key and value (the product
  plus its bias), q / √hd before the dot, masked logits set to
  ``finfo(f32).min`` (a video of no frames attends uniformly), the softmax
  over the frames, the weighted sum of the values.

They replace no ``pallas_call``: the JAX package leaves this arithmetic to
XLA's fusions (``learnablepoolingmethods_tpu/ops/fast_infer.py:64-88``,
``ops/fast_dbof.py``, ``ops/fast_lf.py``, ``ops/fast_transformer.py``,
``models/frame_level.py``, ``ops/topk.py``).  The ``*_plain`` versions are
that arithmetic in PyTorch; the fast routes compute with them
(``ops/fast_infer.py#gated_moe_tail``, ``ops/fast_lf.py``,
``ops/fast_dbof.py``, ``ops/fast_transformer.py``), and so does the
runner's plain version
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
LN_EPS = 1e-6
# pool_attention's block (csrc/native_runner.cu kPoolMaxHd, kPoolRows,
# kPoolTile, kPoolPitch, kPoolPPitch): a head width of at most 128; 64
# scaled queries, two stages of a key and a value tile of 32 frames (rows of
# 136 floats), the tile's weights (rows of 72) and a float a query in shared
# memory, whatever Q and F
POOL_MAX_HEAD_DIM, POOL_ROWS, POOL_TILE = 128, 64, 32
POOL_SMEM = 4 * (POOL_ROWS * (POOL_MAX_HEAD_DIM + 8) + 4 * POOL_TILE * (POOL_MAX_HEAD_DIM + 8)
                 + POOL_TILE * (POOL_ROWS + 8) + POOL_ROWS)
_P, _I, _LL, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint, ctypes.c_float
BF16 = torch.bfloat16
# topk's block select (csrc/native_runner.cu kTopkThreads, kTopkFastK,
# kTopkPerSmall, kTopkPerLarge): a block of 256 threads a row, k at most
# 64, a thread's entries t + 256·j in registers, 16 of them (V ≤ 4,096) or
# 64 (V ≤ 16,384); a larger k or row takes k rounds of a block-wide argmax
TOPK_THREADS, TOPK_FAST_K, TOPK_PER_THREAD = 256, 64, (16, 64)
# frame_stage's word path (csrc/native_runner.cu kStageThreads, kStageWords,
# kStageDT): blocks of 8 warps, each warp a run of consecutive rows; on a
# row of 1152 bytes (4-byte aligned) lane l holds the 9 words l + 32·j, its
# 36 values summed in that order, then the warp's butterfly; any other row
# (or alignment) the byte path: lane l the columns l + 32·j
STAGE_THREADS, STAGE_WORDS = 256, 9
STAGE_DT = 32 * 4 * STAGE_WORDS
# nextvlad_residual's block (kResidualThreads, kResidualTile): a tile of 32
# clusters of one video, lane l column k0 + l, warp w the rows w, w + 8, …
# in order, the 8 warps' sums added in warp order
RESIDUAL_THREADS, RESIDUAL_TILE = 256, 32
# hidden_sum's and gating's blocks (kHiddenThreads, kHiddenVecs,
# kGatingThreads, kGatingVecs): a tile of 1,024 columns of one row (the row
# from blockIdx.y); of T threads, thread t takes the columns 4q … 4q + 3 of
# q = blockIdx.x · 256 + j · T + t, j < V: a float4 of each input where
# H % 4 = 0 and every pointer is 16-byte aligned (a bf16 output 8), else
# the same columns one at a time.  hidden_sum T = 128, V = 2; gating
# T = 256, V = 1
HIDDEN_THREADS, HIDDEN_VECS = 128, 2
GATING_THREADS, GATING_VECS = 256, 1
HIDDEN_TILE = 4 * HIDDEN_THREADS * HIDDEN_VECS


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


def key_mask(num_frames: torch.Tensor, frames: int) -> torch.Tensor:
    """The f32 mask [B, F] of frames f < num_frames (``models/model_utils.py
    #frame_mask``)."""
    return (torch.arange(frames, device=num_frames.device)[None, :] < num_frames.reshape(-1, 1)).float()


def frame_stage_all_plain(features: torch.Tensor, num_frames: torch.Tensor, dtype: torch.dtype = BF16):
    """uint8 frames [B, F, DT] → (every frame dequantized in ``dtype`` and
    ℓ2 over the row [B, F, DT] in ``dtype``, the f32 key mask [B, F])."""
    return l2_normalize(dequantize(features, dtype=dtype), dim=-1), key_mask(num_frames, features.shape[1])


def bias_act_plain(y: torch.Tensor, bias: torch.Tensor, relu: bool = False, dtype: torch.dtype = BF16):
    """``y + bias`` (f32), with ``relu`` its ReLU, rounded once to ``dtype``."""
    z = y + bias
    return (torch.relu(z) if relu else z).to(dtype)


def layer_norm(x32: torch.Tensor, scale, bias, clamp_var: bool = False) -> torch.Tensor:
    """LayerNorm over the last axis in f32 with var = E[x²] − mean², as
    flax's LayerNorm (``use_fast_variance``) and the JAX fast path compute
    it; ``clamp_var`` takes max(0, var) first, as flax does (the fast path
    does not)."""
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True) - mean * mean
    if clamp_var:
        var = torch.clamp(var, min=0.0)
    return (x32 - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def residual_layernorm_plain(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The encoder's residual and LayerNorm: rows of ``x`` and ``y`` [R, D]
    (bf16) summed in f32, :func:`layer_norm` (no clamp), rounded to x's
    dtype; with ``mask`` (R values) each row times its mask value after the
    rounding, a multiply as ``h * mask`` gives it."""
    out = layer_norm(x.float() + y.float(), scale, bias).to(x.dtype)
    return out if mask is None else out * mask.reshape(-1, 1).to(out.dtype)


def masked_mean_plain(x: torch.Tensor, num_frames: torch.Tensor, dtype: torch.dtype = BF16,
                      count_valid: bool = True) -> torch.Tensor:
    """``x`` [B, F, C] → Σ_f x · mask in f32 over max(n, 1) [B, C] in
    ``dtype``: n the count of valid frames with ``count_valid`` (the
    transformer's ``sum(mask)``), else ``num_frames`` itself
    (FrameLevelLogisticModel's divisor)."""
    mask = key_mask(num_frames, x.shape[1])
    if count_valid:
        denom = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
    else:
        denom = torch.clamp(num_frames.float(), min=1.0).reshape(-1, 1)
    return (torch.sum(x.float() * mask[:, :, None], dim=1) / denom).to(dtype)


def last_frame(num_frames: torch.Tensor, frames: int) -> torch.Tensor:
    """The carry index of each row, min(num_frames, F) − 1 mod F: flax's
    ``x[seq_lengths − 1, arange(B)]`` (``_select_last_carry``), so a row of
    no frames takes the carry after the last frame."""
    return torch.remainder(torch.clamp(num_frames.long(), max=frames) - 1, frames)


def lstm_cell_plain(pre_t: torch.Tensor, hw: torch.Tensor, b_h: torch.Tensor, c: torch.Tensor,
                    carry: Optional[torch.Tensor] = None, num_frames: Optional[torch.Tensor] = None,
                    t: int = 0, frames: int = 1):
    """One LSTM step (f32): ``pre_t`` [B, 4H] the step's x·W_i, ``hw`` [B, 4H]
    the product h·W_h, ``c`` [B, H] → (h′, c′); with ``carry`` [B, H] also the
    carry with the rows whose :func:`last_frame` of ``frames`` is ``t`` set to
    h′ (a new tensor)."""
    i, f, g, o = torch.chunk((hw + b_h) + pre_t, 4, dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    if carry is None:
        return h, c
    return h, c, torch.where((last_frame(num_frames, frames) == t)[:, None], h, carry)


def gru_cell_plain(pre_t: torch.Tensor, hw: torch.Tensor, b_i: torch.Tensor, b_hn: torch.Tensor, h: torch.Tensor,
                   carry: Optional[torch.Tensor] = None, num_frames: Optional[torch.Tensor] = None,
                   t: int = 0, frames: int = 1):
    """One GRU step (f32): ``pre_t`` [B, 3H] the step's x·W_i (no bias),
    ``hw`` [B, 3H] the product h·W_h, ``b_i`` [3H], ``b_hn`` [H], ``h`` [B, H]
    → h′, with ``carry`` as :func:`lstm_cell_plain` → (h′, carry′)."""
    x_r, x_z, x_n = torch.chunk(pre_t + b_i, 3, dim=1)
    h_r, h_z, h_n = torch.chunk(hw, 3, dim=1)
    r = torch.sigmoid(x_r + h_r)
    z = torch.sigmoid(x_z + h_z)
    n = torch.tanh(x_n + r * (h_n + b_hn))
    h = (1.0 - z) * n + z * h
    if carry is None:
        return h
    return h, torch.where((last_frame(num_frames, frames) == t)[:, None], h, carry)


def gru_layer_plain(pre: torch.Tensor, w_h: torch.Tensor, b_i: torch.Tensor, b_hn: torch.Tensor,
                    num_frames: Optional[torch.Tensor] = None):
    """One GRU layer over every frame (f32), flax's ``nn.RNN(nn.GRUCell)``
    from a zero state: ``pre`` [B, F, 3H] the frames' x·W_i (no bias),
    ``w_h`` [H, 3H]; each step's product h·W_h and :func:`gru_cell_plain`
    → the outputs [B, F, H], and with ``num_frames`` the carry at each
    row's :func:`last_frame` [B, H] → (outputs, carry)."""
    b, f, _ = pre.shape
    h = pre.new_zeros(b, w_h.shape[0])
    carry = None if num_frames is None else h
    outs = []
    for t in range(f):
        if carry is None:
            h = gru_cell_plain(pre[:, t], h @ w_h, b_i, b_hn, h)
        else:
            h, carry = gru_cell_plain(pre[:, t], h @ w_h, b_i, b_hn, h, carry, num_frames, t, f)
        outs.append(h)
    seq = torch.stack(outs, dim=1)
    return seq if carry is None else (seq, carry)


def pool_attention_fits(n_q: int, frames: int, hd: int) -> bool:
    """Whether pool_attention's kernel takes Q queries over F frames at head
    width hd: any Q and F, a head width of at most 128."""
    return n_q >= 1 and frames >= 1 and 1 <= hd <= POOL_MAX_HEAD_DIM


def pool_attention_plain(q: torch.Tensor, kv: torch.Tensor, bkv: torch.Tensor, num_frames: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """Learned-query attention in f32: ``q`` [Q, H·hd] the queries'
    projection with its bias, ``kv`` [B, F, 2·H·hd] the frames' key and value
    products (key first), ``bkv`` [2·H·hd] their biases → [B, Q, H·hd], as
    flax's ``MultiHeadDotProductAttention`` computes it before its output
    projection (``models/attention.py#MultiHeadAttention``)."""
    b, f, two_d = kv.shape
    d = two_d // 2
    hd = d // heads
    kv = kv + bkv
    k, v = kv[..., :d].reshape(b, f, heads, hd), kv[..., d:].reshape(b, f, heads, hd)
    qs = (q / torch.sqrt(torch.tensor(float(hd)))).reshape(-1, heads, hd)
    logits = torch.einsum("qhd,bkhd->bhqk", qs, k)
    mask = key_mask(num_frames, f) > 0
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.tensor(torch.finfo(torch.float32).min, device=logits.device))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, -1, d)


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


def gating(gates: torch.Tensor, h: torch.Tensor, g_scale: torch.Tensor, g_bias: torch.Tensor,
           dtype: torch.dtype = BF16) -> torch.Tensor:
    """:func:`gating_plain` (bf16 or f32 out) on the card (the kernel) or
    the CPU."""
    if gates.device.type == "cpu":
        return gating_plain(gates, h, g_scale, g_bias, dtype)
    _f32("gating", gates, h, g_scale, g_bias)
    rows, width = gates.shape
    if (h.shape != gates.shape or g_scale.shape != (width,) or g_bias.shape != (width,)
            or dtype not in (torch.float32, BF16)):
        raise ValueError(f"gating: shapes {tuple(gates.shape)}, {tuple(h.shape)}, {tuple(g_scale.shape)}, "
                         f"out dtype {dtype}")
    out = torch.empty(gates.shape, dtype=dtype, device=gates.device)
    f32_out, bf16_out = (out, None) if dtype == torch.float32 else (None, out)
    _launch("gating", "lpm_gating", [_P] * 6 + [_LL, _I, _P],
            gates.data_ptr(), h.data_ptr(), g_scale.data_ptr(), g_bias.data_ptr(), _ptr(bf16_out), _ptr(f32_out),
            rows, width, device=gates.device)
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


def frame_stage_all(features: torch.Tensor, num_frames: torch.Tensor, dtype: torch.dtype = BF16):
    """:func:`frame_stage_all_plain` on the card (frame_stage's kernel with
    no draw, counted as frame_stage's launch) or the CPU."""
    if features.device.type == "cpu":
        return frame_stage_all_plain(features, num_frames, dtype)
    _check("frame_stage", torch.uint8, features)
    _check("frame_stage", torch.int32, num_frames)
    b, f, dt = features.shape
    if num_frames.shape != (b,) or dtype not in (torch.float32, BF16):
        raise ValueError(f"frame_stage: B={b}, num_frames {tuple(num_frames.shape)}, out dtype {dtype}")
    out = torch.empty((b, f, dt), dtype=dtype, device=features.device)
    mask = torch.empty((b, f), dtype=torch.float32, device=features.device)
    f32_out, bf16_out = (out, None) if dtype == torch.float32 else (None, out)
    _launch("frame_stage", "lpm_frame_stage_all", [_P] * 5 + [_I] * 3 + [_F, _F, _P],
            features.data_ptr(), num_frames.data_ptr(), _ptr(bf16_out), _ptr(f32_out), mask.data_ptr(), b, f, dt,
            DEQ_SCALE, DEQ_BIAS, device=features.device)
    frame_stage.launches += 1
    return out, mask


def bias_act(y: torch.Tensor, bias: torch.Tensor, relu: bool = False, dtype: torch.dtype = BF16) -> torch.Tensor:
    """:func:`bias_act_plain` (bf16 out, or f32: the f32 routes' bias adds)
    on the card (the kernel) or the CPU."""
    if y.device.type == "cpu":
        return bias_act_plain(y, bias, relu, dtype)
    rows, width = _bias_rows("bias_act", y, bias)
    if dtype not in (torch.float32, BF16):
        raise ValueError(f"bias_act: out dtype {dtype}")
    out = torch.empty(y.shape, dtype=dtype, device=y.device)
    f32_out, bf16_out = (out, None) if dtype == torch.float32 else (None, out)
    _launch("bias_act", "lpm_bias_act", [_P] * 4 + [_I, _LL, _I, _P],
            y.data_ptr(), bias.data_ptr(), _ptr(bf16_out), _ptr(f32_out), int(relu), rows, width, device=y.device)
    bias_act.launches += 1
    return out


def residual_layernorm(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`residual_layernorm_plain` (bf16) on the card (the kernel) or
    the CPU."""
    if x.device.type == "cpu":
        return residual_layernorm_plain(x, y, scale, bias, mask)
    _check("residual_layernorm", BF16, x, y)
    _f32("residual_layernorm", scale, bias, *(() if mask is None else (mask,)))
    rows, d = x.shape
    if y.shape != x.shape or scale.shape != (d,) or bias.shape != (d,) or (mask is not None and mask.numel() != rows):
        raise ValueError(f"residual_layernorm: shapes {tuple(x.shape)}, {tuple(y.shape)}, {tuple(scale.shape)}")
    out = torch.empty_like(x)
    _launch("residual_layernorm", "lpm_residual_layernorm", [_P] * 6 + [_LL, _I, _P],
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), _ptr(mask), out.data_ptr(), rows, d,
            device=x.device)
    residual_layernorm.launches += 1
    return out


def masked_mean(x: torch.Tensor, num_frames: torch.Tensor, dtype: torch.dtype = BF16,
                count_valid: bool = True) -> torch.Tensor:
    """:func:`masked_mean_plain` (bf16 or f32 in and out) on the card (the
    kernel) or the CPU."""
    if x.device.type == "cpu":
        return masked_mean_plain(x, num_frames, dtype, count_valid)
    if x.dtype not in (torch.float32, BF16) or dtype not in (torch.float32, BF16):
        raise ValueError(f"masked_mean: {x.dtype} in, {dtype} out")
    _check("masked_mean", x.dtype, x)
    _check("masked_mean", torch.int32, num_frames)
    b, f, c = x.shape
    if num_frames.shape != (b,):
        raise ValueError(f"masked_mean: num_frames {tuple(num_frames.shape)} for B={b}")
    out = torch.empty((b, c), dtype=dtype, device=x.device)
    f32_out, bf16_out = (out, None) if dtype == torch.float32 else (None, out)
    _launch("masked_mean", "lpm_masked_mean", [_P, _I, _P, _P, _P] + [_I] * 4 + [_P],
            x.data_ptr(), int(x.dtype == BF16), num_frames.data_ptr(), _ptr(f32_out), _ptr(bf16_out), b, f, c,
            int(count_valid), device=x.device)
    masked_mean.launches += 1
    return out


def _rows(name: str, t: torch.Tensor, rows: int, width: int) -> int:
    """The row stride of ``t``, a [rows, width] f32 CUDA tensor whose rows
    are contiguous (a step's slice of [B, F, ·] products passes as is)."""
    if (t.device.type != "cuda" or t.dtype != torch.float32 or t.shape != (rows, width)
            or (width > 1 and t.stride(1) != 1)):
        raise ValueError(f"{name}: needs f32 CUDA [{rows}, {width}] with contiguous rows, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.stride(0)


def _cell_carry(name: str, carry, num_frames, b: int, width: int):
    if carry is None:
        return None
    _f32(name, carry)
    _check(name, torch.int32, num_frames)
    if carry.shape != (b, width) or num_frames.shape != (b,):
        raise ValueError(f"{name}: carry {tuple(carry.shape)}, num_frames {tuple(num_frames.shape)} for B={b}")
    return carry.clone()


def lstm_cell(pre_t: torch.Tensor, hw: torch.Tensor, b_h: torch.Tensor, c: torch.Tensor,
              carry: Optional[torch.Tensor] = None, num_frames: Optional[torch.Tensor] = None,
              t: int = 0, frames: int = 1):
    """:func:`lstm_cell_plain` on the card (the kernel; ``pre_t`` may be a
    step's rows of the [B, F, 4H] products) or the CPU."""
    if c.device.type == "cpu":
        return lstm_cell_plain(pre_t, hw, b_h, c, carry, num_frames, t, frames)
    b, width = c.shape
    ld = _rows("lstm_cell", pre_t, b, 4 * width)
    _f32("lstm_cell", hw, b_h, c)
    if hw.shape != (b, 4 * width) or b_h.shape != (4 * width,) or not 0 <= t < frames:
        raise ValueError(f"lstm_cell: hw {tuple(hw.shape)}, b_h {tuple(b_h.shape)}, t={t} of {frames}")
    carry = _cell_carry("lstm_cell", carry, num_frames, b, width)
    h, c_out = torch.empty_like(c), torch.empty_like(c)
    _launch("lstm_cell", "lpm_lstm_cell", [_P, _LL] + [_P] * 6 + [_LL] + [_P] * 2 + [_I] * 4 + [_P],
            pre_t.data_ptr(), ld, hw.data_ptr(), b_h.data_ptr(), c.data_ptr(), c_out.data_ptr(), h.data_ptr(), None,
            0, _ptr(carry), _ptr(num_frames), b, frames, width, t, device=c.device)
    lstm_cell.launches += 1
    return (h, c_out) if carry is None else (h, c_out, carry)


def gru_cell(pre_t: torch.Tensor, hw: torch.Tensor, b_i: torch.Tensor, b_hn: torch.Tensor, h: torch.Tensor,
             carry: Optional[torch.Tensor] = None, num_frames: Optional[torch.Tensor] = None,
             t: int = 0, frames: int = 1):
    """:func:`gru_cell_plain` on the card (the kernel; ``pre_t`` as in
    :func:`lstm_cell`) or the CPU."""
    if h.device.type == "cpu":
        return gru_cell_plain(pre_t, hw, b_i, b_hn, h, carry, num_frames, t, frames)
    b, width = h.shape
    ld = _rows("gru_cell", pre_t, b, 3 * width)
    _f32("gru_cell", hw, b_i, b_hn, h)
    if (hw.shape != (b, 3 * width) or b_i.shape != (3 * width,) or b_hn.shape != (width,)
            or not 0 <= t < frames):
        raise ValueError(f"gru_cell: hw {tuple(hw.shape)}, b_i {tuple(b_i.shape)}, b_hn {tuple(b_hn.shape)}, "
                         f"t={t} of {frames}")
    carry = _cell_carry("gru_cell", carry, num_frames, b, width)
    out = torch.empty_like(h)
    _launch("gru_cell", "lpm_gru_cell", [_P, _LL] + [_P] * 6 + [_LL] + [_P] * 2 + [_I] * 4 + [_P],
            pre_t.data_ptr(), ld, hw.data_ptr(), b_i.data_ptr(), b_hn.data_ptr(), h.data_ptr(), out.data_ptr(), None,
            0, _ptr(carry), _ptr(num_frames), b, frames, width, t, device=h.device)
    gru_cell.launches += 1
    return out if carry is None else (out, carry)


def gru_layer(pre: torch.Tensor, w_h: torch.Tensor, b_i: torch.Tensor, b_hn: torch.Tensor,
              num_frames: Optional[torch.Tensor] = None):
    """:func:`gru_layer_plain` on the card (one cooperative launch over all
    F frames, ``pre`` a contiguous [B, F, 3H]) or the CPU."""
    if pre.device.type == "cpu":
        return gru_layer_plain(pre, w_h, b_i, b_hn, num_frames)
    _f32("gru_layer", pre, w_h, b_i, b_hn)
    b, f, g3 = pre.shape
    width = w_h.shape[0]
    if g3 != 3 * width or w_h.shape != (width, g3) or b_i.shape != (g3,) or b_hn.shape != (width,):
        raise ValueError(f"gru_layer: pre {tuple(pre.shape)}, w_h {tuple(w_h.shape)}, b_i {tuple(b_i.shape)}, "
                         f"b_hn {tuple(b_hn.shape)}")
    carry = None
    if num_frames is not None:
        _check("gru_layer", torch.int32, num_frames)
        if num_frames.shape != (b,):
            raise ValueError(f"gru_layer: num_frames {tuple(num_frames.shape)} for B={b}")
        carry = torch.empty((b, width), dtype=torch.float32, device=pre.device)
    seq = torch.empty((b, f, width), dtype=torch.float32, device=pre.device)
    state = torch.empty(2 * b * (-(-width // 4) * 4), dtype=torch.float32, device=pre.device)
    _launch("gru_layer", "lpm_gru_layer", [_P, _LL, _LL] + [_P] * 5 + [_LL, _LL] + [_P] * 2 + [_I] * 3 + [_P],
            pre.data_ptr(), f * g3, g3, w_h.data_ptr(), b_i.data_ptr(), b_hn.data_ptr(), state.data_ptr(),
            seq.data_ptr(), f * width, width, _ptr(carry), _ptr(num_frames), b, f, width, device=pre.device)
    gru_layer.launches += 1
    return seq if carry is None else (seq, carry)


def pool_attention(q: torch.Tensor, kv: torch.Tensor, bkv: torch.Tensor, num_frames: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """:func:`pool_attention_plain` on the card (the kernel) or the CPU."""
    if kv.device.type == "cpu":
        return pool_attention_plain(q, kv, bkv, num_frames, heads)
    _f32("pool_attention", q, kv, bkv)
    _check("pool_attention", torch.int32, num_frames)
    b, f, two_d = kv.shape
    n_q, d = q.shape
    if (two_d != 2 * d or bkv.shape != (two_d,) or num_frames.shape != (b,) or heads < 1 or d % heads
            or not pool_attention_fits(n_q, f, d // heads)):
        raise ValueError(f"pool_attention: q {tuple(q.shape)}, kv {tuple(kv.shape)}, bkv {tuple(bkv.shape)}, "
                         f"{heads} heads")
    out = torch.empty((b, n_q, d), dtype=torch.float32, device=kv.device)
    _launch("pool_attention", "lpm_pool_attention", [_P] * 5 + [_I] * 5 + [_P],
            q.data_ptr(), kv.data_ptr(), bkv.data_ptr(), num_frames.data_ptr(), out.data_ptr(), b, f, n_q, heads,
            d // heads, device=kv.device)
    pool_attention.launches += 1
    return out


WRAPPERS = (hidden_sum, gating, moe_combine, topk, frame_stage, bias_sigmoid, bias_relu6, frame_pool, row_l2,
            nextvlad_assign, nextvlad_residual, bias_act, residual_layernorm, masked_mean, lstm_cell, gru_cell,
            pool_attention, gru_layer)
for _wrapper in WRAPPERS:
    _wrapper.launches = 0
