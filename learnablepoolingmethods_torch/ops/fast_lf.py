"""BN-folded fast inference for the rest of the LOUPE "LF" family.

Port of ``learnablepoolingmethods_tpu/ops/fast_lf.py``: the treatment of
``ops/fast_infer.py`` (NetVLADModelLF) for ``NetFVModelLF``,
``NetRVLADModelLF``, ``SoftDbofModelLF`` and ``NeXtVLADModel``.  Sample →
input BN → per-modality pooling → hidden FC → context gating → MoE:

- **NetFVModelLF**: the NetFV kernel (``ops/netfv_fused.py``) once per
  modality; the hidden FC takes (fv1, fv2) through row-split weights, so
  the ``[B, 2·D·K]`` concat never exists;
- **NetRVLADModelLF**: the NetVLAD kernel (``ops/netvlad_fused.py``) with
  zero centres;
- **SoftDbofModelLF**: the SoftDBoW histogram kernel
  (``ops/softdbow_fused.py``), then its ℓ2 over K outside the kernel;
- **NeXtVLADModel**: plain products (``torch.mm`` and an f32 batched
  product), as the JAX package leaves them to XLA; no kernel.

All share the staged route of ``ops/fast_infer.py``: uint8 frame sampling
before dequantize, the folded input and assignment BNs, and the gated-MoE
tail.

    fp = prepare_fast_lf_params(variables, mcfg, "NetFVModelLF", device="cuda")
    fn = build_fast_lf_inference(mcfg, "NetFVModelLF", top_k=20)
    values, indices = fn(fp, features_u8, num_frames, key)
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.models.frame_level import LF_MODULE_PREFIX, lf_hparams
from learnablepoolingmethods_torch.ops.fast_dispatch import FAST_LF_MODELS
from learnablepoolingmethods_torch.ops.fast_infer import (
    _require_moe_head,
    gated_moe_tail,
    matmul_f32,
    hidden_fc,
    int8_weight,
    staged_frames,
)
from learnablepoolingmethods_torch.ops.fused_frontend import gather_frames, sample_indices
from learnablepoolingmethods_torch.ops.netfv_fused import netfv_fused, netfv_reference
from learnablepoolingmethods_torch.ops.netvlad_fused import (
    fold_assignment_bn,
    netvlad_fused,
    netvlad_reference,
)
from learnablepoolingmethods_torch.ops.normalize import l2_normalize
from learnablepoolingmethods_torch.ops.softdbow_fused import softdbow_fused, softdbow_reference
from learnablepoolingmethods_torch.utils.misc import resolve_device


def prepare_fast_lf_params(
    variables: Dict[str, Any],
    mcfg: ModelConfig,
    model_name: str,
    compute_dtype: torch.dtype = torch.bfloat16,
    int8_hidden: bool = False,
    device="cuda",
) -> Dict[str, Any]:
    """Fold BNs and cast weights once → a flat dict of tensors on ``device``
    (``mods`` holds one entry per modality).  ``variables`` is the
    ``{params, batch_stats}`` tree of float32 tensors that
    ``core/weights.py#convert_flax_variables`` returns."""
    if model_name not in FAST_LF_MODELS:
        raise ValueError(f"unsupported fast-LF model {model_name!r}")
    if int8_hidden and model_name not in ("NetFVModelLF", "NetRVLADModelLF"):
        raise ValueError(
            f"int8_hidden is not supported on {model_name} (its hidden FC "
            "is not the HBM-bound giant-weight shape where int8 pays)"
        )
    _, _, relu = lf_hparams(model_name, mcfg)
    if not mcfg.netvlad_add_batch_norm or relu or not mcfg.gating:
        raise ValueError(
            f"fast path for {model_name} supports the default config (BN on, relu off, gating on)"
        )
    if mcfg.netvlad_dimred > 0:
        raise ValueError("fast LF path does not support --netvlad_dimred")
    if not mcfg.sample_random_frames:
        raise ValueError(
            "fast path samples iid frames; --nosample_random_frames "
            "(contiguous windows) needs the flax forward"
        )
    p = variables["params"]
    s = variables["batch_stats"]
    _require_moe_head(p, mcfg)
    dev = resolve_device(device)
    ct = compute_dtype
    prefix = LF_MODULE_PREFIX[model_name]

    def put(t, dtype=torch.float32):
        return torch.as_tensor(t).to(device=dev, dtype=dtype).contiguous()

    def fc(rows):
        """A hidden-FC slice: int8 with per-column scales (NetFV, NetRVLAD
        with ``int8_hidden``), else bf16."""
        return int8_weight(rows, dev) if int8_hidden else put(rows, ct)

    def folded(name, bn):
        scale, bias = fold_assignment_bn(**p[name][bn], **s[name][bn])
        return put(scale), put(bias)

    mods = []
    offset = 0
    hidden_w = p["hidden1_weights"]
    for i in (0, 1):
        name = f"{prefix}_{i}"
        if name not in p:
            break
        mp = p[name]
        scale, bias = folded(name, "cluster_bn")
        if model_name == "NeXtVLADModel":
            # geometry from the parameter shapes (G may have been adjusted)
            k, dp = mp["cluster_weights2"].shape
            vscale, vbias = folded(name, "vlad_bn")
            w = k * dp
            mods.append({
                "cluster": put(mp["expansion_weights"], ct),   # [D, λD]: the split width
                "scale": scale, "bias": bias,
                "wg": put(mp["group_attention_weights"], ct),  # [λD, G]
                "wa": put(mp["cluster_weights"], ct),          # [λD, G·K]
                "c2": put(mp["cluster_weights2"]),              # [K, D′]
                "vscale": vscale, "vbias": vbias,
                "w1": put(hidden_w[offset:offset + w], ct),
            })
            offset += w
            continue
        d, k = mp["cluster_weights"].shape
        entry = {"cluster": put(mp["cluster_weights"], ct), "scale": scale, "bias": bias}
        if model_name == "NetFVModelLF":
            covar = (mcfg.fv_coupling_factor * mp["cluster_weights"] if mcfg.fv_couple_weights
                     else mp["covar_weights"])
            entry["c2"] = put(mp["cluster_weights2"].reshape(d, k))
            entry["covar"] = put(torch.square(covar).float() + 1e-6)
            # fv1 rows, then fv2 rows (the module's concat order)
            entry["w1"] = fc(hidden_w[offset:offset + d * k])
            entry["w2"] = fc(hidden_w[offset + d * k:offset + 2 * d * k])
            w = 2 * d * k
        elif model_name == "NetRVLADModelLF":
            entry["c2"] = torch.zeros((d, k), dtype=torch.float32, device=dev)  # no centres
            w = d * k
            entry["w1"] = fc(hidden_w[offset:offset + w])
        else:  # SoftDbofModelLF
            w = k
            entry["w1"] = put(hidden_w[offset:offset + w], ct)
        offset += w
        mods.append(entry)
    if offset != hidden_w.shape[0]:
        raise ValueError(f"hidden FC row split mismatch: consumed {offset} of {hidden_w.shape[0]} rows")

    in_scale, in_bias = fold_assignment_bn(**p["input_bn"], **s["input_bn"])
    g_scale, g_bias = folded("gating", "gating_bn")
    moe = p["MoeModel_0"]
    return {
        "in_scale": put(in_scale),
        "in_bias": put(in_bias),
        "mods": mods,
        "hidden_b": put(p["hidden1_biases"]),
        "gate_w": put(p["gating"]["gating_weights"], ct),
        "g_scale": g_scale,
        "g_bias": g_bias,
        "gates_kernel": put(moe["gates_kernel"], ct),       # [H, (M+1)·V]
        "experts_kernel": put(moe["experts_kernel"], ct),   # [H, M·V]
        "experts_bias": put(moe["experts_bias"]),
    }


def build_fast_lf_inference(
    mcfg: ModelConfig,
    model_name: str,
    top_k: int = 20,
    use_kernels: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    return_probs: bool = False,
):
    """Return ``fn(fast_params, features, num_frames, key, presampled=False,
    row_offset=0)`` → (values [B,k], indices [B,k]), or the probabilities
    [B, V] when ``return_probs`` (``row_offset`` as in
    ``ops/fast_infer.py``).  ``use_kernels=False`` runs the plain PyTorch
    versions of the kernels."""
    if model_name not in FAST_LF_MODELS:
        raise ValueError(f"unsupported fast-LF model {model_name!r}")
    m = mcfg.moe_num_mixtures
    v = mcfg.vocab_size
    iterations = mcfg.iterations
    ct = compute_dtype

    def nextvlad(x_mod, entry):
        b, s, d = x_mod.shape
        k, dp = entry["c2"].shape
        g = entry["wg"].shape[1]
        xt = matmul_f32(x_mod.reshape(b * s, d), entry["cluster"]).to(ct)     # [B·S, λD]
        alpha = torch.sigmoid(matmul_f32(xt, entry["wg"])).reshape(b, s, g)
        logits = (matmul_f32(xt, entry["wa"]) * entry["scale"] + entry["bias"]).reshape(b, s, g, k)
        assign = torch.softmax(logits, dim=-1) * alpha[..., None]
        # products of compute-dtype values, summed in f32
        agg = torch.einsum("bfgk,bfgd->bkd", assign.to(ct).float(), xt.reshape(b, s, g, dp).float())
        vlad = agg - torch.sum(assign, dim=(1, 2))[:, :, None] * entry["c2"][None]
        vlad = l2_normalize(vlad, dim=-1).reshape(b, k * dp)
        vlad = (vlad * entry["vscale"] + entry["vbias"]).to(ct)
        return matmul_f32(vlad, entry["w1"])

    def pooled_contrib(x_mod, entry):
        """This modality's share of the hidden FC's output, [B, H] f32."""
        b = x_mod.shape[0]
        consts = (x_mod, entry["cluster"], entry["scale"], entry["bias"])
        if model_name == "NeXtVLADModel":
            return nextvlad(x_mod, entry)
        if model_name == "NetFVModelLF":
            fn = netfv_fused if use_kernels else netfv_reference
            fv1, fv2 = fn(*consts, entry["c2"], entry["covar"])
            return hidden_fc(fv1.reshape(b, -1), entry["w1"]) + hidden_fc(fv2.reshape(b, -1), entry["w2"])
        if model_name == "NetRVLADModelLF":
            fn = netvlad_fused if use_kernels else netvlad_reference
            return hidden_fc(fn(*consts, entry["c2"]).reshape(b, -1), entry["w1"])
        fn = softdbow_fused if use_kernels else softdbow_reference
        bow = l2_normalize(fn(*consts), dim=1).to(ct)
        return matmul_f32(bow, entry["w1"])

    def forward(fp, features, num_frames, key, presampled: bool = False, row_offset: int = 0):
        if not presampled:
            idx = sample_indices(key, num_frames, features.shape[1], iterations, row_offset)
            features = gather_frames(features, idx)
        x = staged_frames(features, fp["in_scale"], fp["in_bias"], ct)
        d_rgb = fp["mods"][0]["cluster"].shape[0]
        slices = [x[:, :, :d_rgb]] + ([x[:, :, d_rgb:]] if len(fp["mods"]) > 1 else [])
        h = fp["hidden_b"]
        for x_mod, entry in zip(slices, fp["mods"]):
            h = h + pooled_contrib(x_mod, entry)
        return gated_moe_tail(fp, h, m, v, ct, top_k, return_probs)

    return forward
