"""Fast inference for the transformer family: ``TransformerEncoderModel``
(BASELINE config 5) and ``AttentionNetVLADModel``.

Port of ``learnablepoolingmethods_tpu/ops/fast_transformer.py``.  Every
frame is used (nothing is sampled; ``key`` is accepted for the dispatch
signature and ignored):

    uint8 [B, F, 1152] → dequantize → tf-style ℓ2 → input projection
    → N post-LN encoder layers: fused [D, 3D] QKV product → masked attention
      (``ops/masked_attention.py``, the kernel) → out-projection →
      residual + LayerNorm → FFN (ReLU) → residual + LayerNorm
    → TransformerEncoderModel: masked mean over the valid frames
      AttentionNetVLADModel:   pad rows zeroed, NetVLAD (``netvlad_fused``)
    → hidden FC → folded context gating → MoE → exact top-k

Products are 2-D ``matmul_f32`` on ``[B·F, D]`` views (f32 sums) whose
outputs are cast to the compute dtype in their epilogue, as in JAX; the
residual sums and LayerNorm statistics run in f32.

    fp = prepare_fast_transformer_params(variables, mcfg, device="cuda")
    fn = build_fast_transformer_inference(mcfg, top_k=20)
    values, indices = fn(fp, features_u8, num_frames, key)
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.ops.fast_infer import (
    _require_moe_head,
    gated_moe_tail,
    matmul_f32,
    hidden_fc,
    int8_weight,
)
from learnablepoolingmethods_torch.ops.masked_attention import masked_attention_fused, masked_attention_plain
from learnablepoolingmethods_torch.ops.native_tail import (
    bias_act_plain,
    frame_stage_all_plain,
    key_mask,
    masked_mean_plain,
    residual_layernorm_plain,
)
from learnablepoolingmethods_torch.ops.netvlad_fused import (
    fold_assignment_bn,
    netvlad_fused,
    netvlad_reference,
)
from learnablepoolingmethods_torch.ops.normalize import l2_normalize
from learnablepoolingmethods_torch.utils.misc import resolve_device


def _prepare_encoder_layers(enc, n_layers: int, put, ct) -> list:
    """Encoder-layer weights → one flat dict per layer: the fused ``[D, 3D]``
    QKV kernel from flax's three ``[D, H, hd]`` kernels, the ``[H·hd, D]``
    out-projection from ``[H, hd, D]``, LayerNorm affines and biases in f32,
    product weights in ``ct``."""
    layers = []
    for i in range(n_layers):
        lp = enc[f"layer_{i}"]
        mha = lp["mha"]
        d = mha["query"]["kernel"].shape[0]
        names = ("query", "key", "value")
        layers.append({
            "wqkv": put(torch.cat([mha[n]["kernel"].reshape(d, -1) for n in names], dim=1), ct),
            "bqkv": put(torch.cat([mha[n]["bias"].reshape(-1) for n in names])),
            "wo": put(mha["out"]["kernel"].reshape(-1, d), ct),
            "bo": put(mha["out"]["bias"]),
            "ln1_s": put(lp["ln1"]["scale"]),
            "ln1_b": put(lp["ln1"]["bias"]),
            "ln2_s": put(lp["ln2"]["scale"]),
            "ln2_b": put(lp["ln2"]["bias"]),
            "w1": put(lp["ff1"]["kernel"], ct),
            "b1": put(lp["ff1"]["bias"]),
            "w2": put(lp["ff2"]["kernel"], ct),
            "b2": put(lp["ff2"]["bias"]),
        })
    return layers


def encoder_stack(layers, h: torch.Tensor, mask: torch.Tensor, heads: int, use_kernels: bool, ct,
                  zero_pads: bool = False):
    """The shared encoder stack on ``h`` [B, F, D] in ``ct``; every
    materialised [B, F, ·] tensor stays in ``ct``.  Each product's epilogue
    is ``ops/native_tail.py#bias_act_plain`` and each residual + LayerNorm
    ``#residual_layernorm_plain`` (the native runner's kernels of those
    steps); ``zero_pads`` multiplies the last one's rows by ``mask``."""
    b, f, d = h.shape
    attention = masked_attention_fused if use_kernels else masked_attention_plain
    x = h.reshape(b * f, d)
    for i, lp in enumerate(layers):
        qkv = bias_act_plain(matmul_f32(x, lp["wqkv"]), lp["bqkv"], dtype=ct)
        attn = attention(qkv.reshape(b, f, 3 * d), mask, heads).reshape(b * f, d)
        attn = bias_act_plain(matmul_f32(attn, lp["wo"]), lp["bo"], dtype=ct)
        x = residual_layernorm_plain(x, attn, lp["ln1_s"], lp["ln1_b"])
        ff = bias_act_plain(matmul_f32(x, lp["w1"]), lp["b1"], relu=True, dtype=ct)
        ff = bias_act_plain(matmul_f32(ff, lp["w2"]), lp["b2"], dtype=ct)
        last = zero_pads and i == len(layers) - 1
        x = residual_layernorm_plain(x, ff, lp["ln2_s"], lp["ln2_b"], mask if last else None)
    return x.reshape(b, f, d)


def _prepare_common(variables, mcfg: ModelConfig, device, ct):
    """(params, stats, put, the entries both models share: input projection,
    encoder layers, hidden bias, folded gating and the MoE head)."""
    p = variables["params"]
    s = variables["batch_stats"]
    _require_moe_head(p, mcfg)
    dev = resolve_device(device)

    def put(t, dtype=torch.float32):
        return torch.as_tensor(t).to(device=dev, dtype=dtype).contiguous()

    g_scale, g_bias = fold_assignment_bn(**p["gating"]["gating_bn"], **s["gating"]["gating_bn"])
    moe = p["MoeModel_0"]
    common = {
        "w_proj": put(p["input_proj"]["kernel"], ct),
        "b_proj": put(p["input_proj"]["bias"]),
        "layers": _prepare_encoder_layers(p["encoder"], mcfg.transformer_layers, put, ct),
        "hidden_b": put(p["hidden1_biases"]),
        "gate_w": put(p["gating"]["gating_weights"], ct),
        "g_scale": put(g_scale),
        "g_bias": put(g_bias),
        "gates_kernel": put(moe["gates_kernel"], ct),       # [H, (M+1)·V]
        "experts_kernel": put(moe["experts_kernel"], ct),   # [H, M·V]
        "experts_bias": put(moe["experts_bias"]),
    }
    return p, s, put, common


def prepare_fast_transformer_params(
    variables: Dict[str, Any],
    mcfg: ModelConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    int8_hidden: bool = False,
    device="cuda",
) -> Dict[str, Any]:
    """TransformerEncoderModel: cast and fuse weights once → a flat dict of
    tensors on ``device``.  ``variables`` is the ``{params, batch_stats}``
    tree of float32 tensors that ``core/weights.py#convert_flax_variables``
    returns.  Its hidden FC stays bf16: ``int8_hidden`` raises, as the JAX
    package's dispatch refuses it for this model."""
    if int8_hidden:
        from learnablepoolingmethods_torch.ops.fast_dispatch import reject_int8

        reject_int8("TransformerEncoderModel", int8_hidden)
    if not mcfg.gating:
        raise ValueError("fast transformer path supports the gated tail only")
    if not mcfg.netvlad_add_batch_norm:
        raise ValueError("fast transformer path supports the default tail (BN on)")
    p, _, put, fp = _prepare_common(variables, mcfg, device, compute_dtype)
    fp["hidden_w"] = put(p["hidden1_weights"], compute_dtype)   # [D, H]
    return fp


def prepare_fast_attn_netvlad_params(
    variables: Dict[str, Any],
    mcfg: ModelConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    int8_hidden: bool = False,
    device="cuda",
) -> Dict[str, Any]:
    """AttentionNetVLADModel: the encoder as for the transformer path plus
    the vlad module's folded assignment BN and the ``[D·K, H]`` hidden FC
    (int8 with per-column scales under ``int8_hidden``)."""
    if not mcfg.gating:
        raise ValueError("fast path supports the gated tail only")
    if not mcfg.netvlad_add_batch_norm or mcfg.netvlad_relu:
        raise ValueError("fast attn-NetVLAD path supports the default config (BN on, relu off)")
    p, s, put, fp = _prepare_common(variables, mcfg, device, compute_dtype)
    vp = p["vlad"]
    scale, bias = fold_assignment_bn(**vp["cluster_bn"], **s["vlad"]["cluster_bn"])
    fp.update({
        "cluster": put(vp["cluster_weights"], compute_dtype),   # [D, K]
        "c_scale": put(scale),
        "c_bias": put(bias),
        "c2": put(vp["cluster_weights2"].reshape(vp["cluster_weights"].shape)),
        "hidden_w": (int8_weight(p["hidden1_weights"], fp["hidden_b"].device) if int8_hidden
                     else put(p["hidden1_weights"], compute_dtype)),  # [D·K, H]
    })
    return fp


def _encode(fp, features, num_frames, heads: int, use_kernels: bool, ct, zero_pads: bool = False):
    """dequantize → ℓ2 → input projection → encoder; returns the encoder
    output [B, F, D] in ``ct`` (``zero_pads``: pad rows times the mask) and
    the f32 frame mask [B, F]."""
    b, f, dt = features.shape
    nf = torch.as_tensor(num_frames, device=features.device)
    if features.dtype == torch.uint8:
        x, mask = frame_stage_all_plain(features, nf, ct)
    else:
        x, mask = l2_normalize(features.to(ct), dim=-1), key_mask(nf, f)
    h = bias_act_plain(matmul_f32(x.reshape(b * f, dt), fp["w_proj"]), fp["b_proj"], dtype=ct)
    return encoder_stack(fp["layers"], h.reshape(b, f, -1), mask, heads, use_kernels, ct, zero_pads), mask


def build_fast_transformer_inference(
    mcfg: ModelConfig,
    top_k: int = 20,
    use_kernels: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    return_probs: bool = False,
):
    """Return ``fn(fast_params, features, num_frames, key, presampled=False)``
    → (values [B,k], indices [B,k]), or the probabilities [B, V] when
    ``return_probs``.  ``key``, ``presampled`` and ``row_offset`` are
    accepted for the dispatch signature: the transformer reads every frame.
    ``use_kernels=False`` runs the plain PyTorch attention."""
    m, v, heads, ct = mcfg.moe_num_mixtures, mcfg.vocab_size, mcfg.attention_heads, compute_dtype

    def forward(fp, features, num_frames, key=None, presampled: bool = False, row_offset: int = 0):
        h, _ = _encode(fp, features, num_frames, heads, use_kernels, ct)
        pooled = masked_mean_plain(h, torch.as_tensor(num_frames, device=h.device), ct)
        h2 = matmul_f32(pooled, fp["hidden_w"]) + fp["hidden_b"]
        return gated_moe_tail(fp, h2, m, v, ct, top_k, return_probs)

    return forward


def build_fast_attn_netvlad_inference(
    mcfg: ModelConfig,
    top_k: int = 20,
    use_kernels: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    return_probs: bool = False,
):
    """AttentionNetVLADModel's forward, as :func:`build_fast_transformer_inference`:
    the encoder, pad rows zeroed so they do not pollute the assignments,
    then NetVLAD (``netvlad_fused`` with kernels, ``netvlad_reference``
    without) and the gated-MoE tail."""
    m, v, heads, ct = mcfg.moe_num_mixtures, mcfg.vocab_size, mcfg.attention_heads, compute_dtype

    def forward(fp, features, num_frames, key=None, presampled: bool = False, row_offset: int = 0):
        h, _ = _encode(fp, features, num_frames, heads, use_kernels, ct, zero_pads=True)
        vlad_fn = netvlad_fused if use_kernels else netvlad_reference
        vlad = vlad_fn(h, fp["cluster"], fp["c_scale"], fp["c_bias"], fp["c2"]).reshape(h.shape[0], -1)
        h2 = hidden_fc(vlad.to(ct), fp["hidden_w"], fp["hidden_b"])
        return gated_moe_tail(fp, h2, m, v, ct, top_k, return_probs)

    return forward
