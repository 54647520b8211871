"""Fast inference path for the flagship GatedNetVLAD model (NetVLADModelLF).

Port of ``learnablepoolingmethods_tpu/ops/fast_infer.py``.  From the model's
``{params, batch_stats}`` variables it builds one forward with every
inference-time simplification applied:

- frame sampling before dequantize (a uint8 gather; ℓ2-normalize is
  row-wise, so this commutes with the reference's order);
- every BatchNorm folded to a per-channel affine;
- the front end (dequantize, ℓ2, input BN, sampling, both NetVLADs) as one
  CUDA kernel (``ops/fused_frontend.py``), or, on the staged route, the
  NetVLAD kernel (``ops/netvlad_fused.py``) once per modality;
- the 278528×1024 hidden FC split into per-modality products (no concat);
- context gating and the MoE head in the vocab-major layout;
- exact top-k on the device.

    fp = prepare_fast_params(variables, mcfg, device="cuda")
    fn = build_fast_netvlad_inference(mcfg, top_k=20)
    values, indices = fn(fp, features_u8, num_frames, key)

``key`` is a ``utils/prng.py`` key; it draws the sampled frame indices as
``jax.random.uniform`` would.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.ops.fused_frontend import (
    gather_frames,
    netvlad_frontend,
    sample_indices,
)
from learnablepoolingmethods_torch.ops.netvlad_fused import (
    fold_assignment_bn,
    netvlad_fused,
    netvlad_reference,
)
from learnablepoolingmethods_torch.ops.normalize import l2_normalize
from learnablepoolingmethods_torch.ops.topk import top_k_exact
from learnablepoolingmethods_torch.utils.misc import resolve_device
from learnablepoolingmethods_torch.utils.quantization import dequantize


def _require_moe_head(params: Dict[str, Any], mcfg: ModelConfig):
    """The fast path hard-codes the MoE tail; any other
    --video_level_classifier_model gets a clean 'unsupported config' error."""
    if mcfg.video_level_classifier_model != "MoeModel" or "MoeModel_0" not in params:
        raise ValueError(
            "fast path supports only the MoeModel classifier head "
            f"(got --video_level_classifier_model="
            f"{mcfg.video_level_classifier_model!r}); use the flax forward"
        )


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result from inputs of either dtype, as
    ``jnp.matmul(..., preferred_element_type=float32)``: bf16 products are
    summed in f32 and never rounded to bf16.  On the card this is
    ``torch.mm(out_dtype=float32)``; the CPU build has no such kernel, so
    there the bf16 operands are widened first (exact) and summed in f32."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def gated_moe_tail(fp, h, m: int, v: int, ct, top_k: int, return_probs: bool):
    """Folded context gating + vocab-major MoE + exact top-k (fp keys:
    gate_w/g_scale/g_bias/gates_kernel/experts_kernel/experts_bias).  The
    MoE kernels keep column m·V + v, so the activations reshape to
    ``[B, M+1, V]`` and ``[B, M, V]``."""
    b = h.shape[0]
    gates = matmul_f32(h.to(ct), fp["gate_w"]) * fp["g_scale"] + fp["g_bias"]
    h = (h * torch.sigmoid(gates)).to(ct)

    ga = matmul_f32(h, fp["gates_kernel"]).reshape(b, m + 1, v)
    ea = (matmul_f32(h, fp["experts_kernel"]) + fp["experts_bias"]).reshape(b, m, v)
    probs = torch.sum(torch.softmax(ga, dim=1)[:, :m] * torch.sigmoid(ea), dim=1)
    if return_probs:
        return probs
    return top_k_exact(probs, min(top_k, v))


def prepare_fast_params(
    variables: Dict[str, Any],
    mcfg: ModelConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    int8_hidden: bool = False,
    device="cuda",
) -> Dict[str, Any]:
    """Fold BNs and cast weights once → a flat dict of tensors on ``device``.

    ``variables`` is the ``{params, batch_stats}`` tree of float32 tensors
    that ``core/weights.py#convert_flax_variables`` returns.
    """
    if int8_hidden:
        raise NotImplementedError(
            "--int8_hidden (weight-only int8 hidden FC) is not ported yet: "
            "ROADMAP item 12"
        )
    if not mcfg.netvlad_add_batch_norm or mcfg.netvlad_relu or not mcfg.gating:
        raise ValueError(
            "fast path supports the Willow config (BN on, relu off, gating on)"
        )
    if mcfg.netvlad_dimred > 0:
        raise ValueError("fast path does not support --netvlad_dimred")
    if not mcfg.sample_random_frames:
        raise ValueError(
            "fast path samples iid frames; --nosample_random_frames "
            "(contiguous windows) needs the flax forward"
        )
    p = variables["params"]
    s = variables["batch_stats"]
    if "NetVLAD_1" not in p:
        raise ValueError(
            "fast NetVLAD path supports the two-modality (rgb+audio) "
            "layout; this checkpoint has a single pooling module "
            "(feature_size <= 128) — use the flax forward"
        )
    _require_moe_head(p, mcfg)
    dev = resolve_device(device)
    ct = compute_dtype
    k_rgb = mcfg.netvlad_cluster_size

    def put(t, dtype=torch.float32):
        return torch.as_tensor(t).to(device=dev, dtype=dtype).contiguous()

    def vlad_consts(name):
        scale, bias = fold_assignment_bn(**p[name]["cluster_bn"], **s[name]["cluster_bn"])
        cluster = p[name]["cluster_weights"]
        return {
            "cluster": put(cluster, ct),
            "scale": put(scale),
            "bias": put(bias),
            "c2": put(p[name]["cluster_weights2"].reshape(cluster.shape)),
        }

    rgb = vlad_consts("NetVLAD_0")
    aud = vlad_consts("NetVLAD_1")
    d_rgb = rgb["cluster"].shape[0]

    in_scale, in_bias = fold_assignment_bn(**p["input_bn"], **s["input_bn"])
    g_scale, g_bias = fold_assignment_bn(**p["gating"]["gating_bn"], **s["gating"]["gating_bn"])
    hidden_w = p["hidden1_weights"]
    moe = p["MoeModel_0"]
    return {
        "in_scale": put(in_scale),
        "in_bias": put(in_bias),
        "rgb": rgb,
        "aud": aud,
        "w_rgb": put(hidden_w[: d_rgb * k_rgb], ct),
        "w_aud": put(hidden_w[d_rgb * k_rgb :], ct),
        "hidden_b": put(p["hidden1_biases"]),
        "gate_w": put(p["gating"]["gating_weights"], ct),
        "g_scale": put(g_scale),
        "g_bias": put(g_bias),
        "gates_kernel": put(moe["gates_kernel"], ct),       # [H, (M+1)·V]
        "experts_kernel": put(moe["experts_kernel"], ct),   # [H, M·V]
        "experts_bias": put(moe["experts_bias"]),
    }


def staged_frames(features, in_scale, in_bias, ct: torch.dtype) -> torch.Tensor:
    """The staged route's NetVLAD input from sampled frames ``[B, S, DT]``:
    dequantize (uint8) or cast to ``ct``, ℓ2 over the whole row, folded
    input BN in f32, one rounding to ``ct``."""
    x = dequantize(features, dtype=ct) if features.dtype == torch.uint8 else features.to(ct)
    x = l2_normalize(x, dim=-1)
    return (x.float() * in_scale + in_bias).to(ct)


def build_fast_netvlad_inference(
    mcfg: ModelConfig,
    top_k: int = 20,
    use_kernels: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    fuse_frontend: bool = True,
    return_probs: bool = False,
):
    """Return ``fn(fast_params, features, num_frames, key, presampled=False)``
    → (values [B,k], indices [B,k]), or the probabilities [B, V] when
    ``return_probs``.

    ``use_kernels=False`` runs the plain PyTorch versions everywhere (the
    staged route with :func:`netvlad_reference`).  With kernels, uint8
    unsampled input at bf16 takes the fused front end (one kernel per
    batch) unless ``fuse_frontend=False``; every other input takes the
    staged route, which launches :func:`netvlad_fused` once per modality.
    """
    m = mcfg.moe_num_mixtures
    v = mcfg.vocab_size
    iterations = mcfg.iterations
    ct = compute_dtype

    def _netvlad(x, consts, d, k):
        fn = netvlad_fused if use_kernels else netvlad_reference
        out = fn(x, consts["cluster"], consts["scale"], consts["bias"], consts["c2"])
        return out.reshape(-1, d * k)

    def forward(fp, features, num_frames, key, presampled: bool = False):
        b = features.shape[0]
        d_rgb, k_rgb = fp["rgb"]["cluster"].shape
        d_aud, k_aud = fp["aud"]["cluster"].shape

        if (
            fuse_frontend
            and use_kernels
            and not presampled
            and features.dtype == torch.uint8
            and ct == torch.bfloat16  # the fused kernel is bf16-internal
        ):
            out_rgb, out_aud = netvlad_frontend(
                features, key, num_frames, iterations,
                fp["in_scale"], fp["in_bias"],
                fp["rgb"]["cluster"], fp["rgb"]["scale"], fp["rgb"]["bias"], fp["rgb"]["c2"],
                fp["aud"]["cluster"], fp["aud"]["scale"], fp["aud"]["bias"], fp["aud"]["c2"],
            )
            vlad_rgb = out_rgb.reshape(b, d_rgb * k_rgb)
            vlad_aud = out_aud.reshape(b, d_aud * k_aud)
            return _tail(fp, vlad_rgb, vlad_aud)

        if not presampled:
            idx = sample_indices(key, num_frames, features.shape[1], iterations)
            features = gather_frames(features, idx)

        x = staged_frames(features, fp["in_scale"], fp["in_bias"], ct)

        vlad_rgb = _netvlad(x[:, :, :d_rgb], fp["rgb"], d_rgb, k_rgb)
        vlad_aud = _netvlad(x[:, :, d_rgb:], fp["aud"], d_aud, k_aud)
        return _tail(fp, vlad_rgb, vlad_aud)

    def _tail(fp, vlad_rgb, vlad_aud):
        h = (
            matmul_f32(vlad_rgb, fp["w_rgb"])
            + matmul_f32(vlad_aud, fp["w_aud"])
            + fp["hidden_b"]
        )
        return gated_moe_tail(fp, h, m, v, ct, top_k, return_probs)

    return forward
