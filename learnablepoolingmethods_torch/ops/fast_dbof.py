"""Fast inference path for DbofModel (port of
``learnablepoolingmethods_tpu/ops/fast_dbof.py``).

DBoF's two projections are dense products (cluster [1152 → 8192], hidden
[8192 → 1024]); the JAX package computes them outside any Pallas kernel,
and so does the port (cuBLAS through ``torch.mm``).  What the path saves is
algebra:

- frames sampled before dequantize (a uint8 gather; ℓ2 is per row, so the
  order does not matter);
- every BatchNorm folded to an affine; the input BN and the cluster BN fold
  into the cluster product: W′ = diag(in_scale)·W·diag(c_scale) and
  b′ = (in_bias·W)·c_scale + c_bias;
- the MoE head in the vocab-major layout of ``ops/fast_infer.py``.

    fp = prepare_fast_dbof_params(variables, mcfg, device="cuda")
    fn = build_fast_dbof_inference(mcfg, top_k=20)
    values, indices = fn(fp, features_u8, num_frames, key)
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.models.model_utils import frame_pooling
from learnablepoolingmethods_torch.ops.fast_infer import _require_moe_head, matmul_f32
from learnablepoolingmethods_torch.ops.fused_frontend import gather_frames, sample_indices
from learnablepoolingmethods_torch.ops.netvlad_fused import fold_assignment_bn
from learnablepoolingmethods_torch.ops.normalize import l2_normalize
from learnablepoolingmethods_torch.ops.topk import top_k_exact
from learnablepoolingmethods_torch.utils.misc import resolve_device
from learnablepoolingmethods_torch.utils.quantization import dequantize


def prepare_fast_dbof_params(
    variables: Dict[str, Any],
    mcfg: ModelConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> Dict[str, Any]:
    """Fold the BNs (input and cluster BN into the cluster product) and cast
    the weights once → a flat dict of tensors on ``device``.  ``variables``
    is the tree of float32 tensors of ``core/weights.py#convert_flax_variables``."""
    if not mcfg.dbof_add_batch_norm:
        raise ValueError("fast DBoF path requires dbof_add_batch_norm=True")
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

    def put(t, dtype=torch.float32):
        return torch.as_tensor(t).to(device=dev, dtype=dtype).contiguous()

    in_scale, in_bias = fold_assignment_bn(**p["input_bn"], **s["input_bn"])
    c_scale, c_bias = fold_assignment_bn(**p["cluster_bn"], **s["cluster_bn"])
    h_scale, h_bias = fold_assignment_bn(**p["hidden1_bn"], **s["hidden1_bn"])
    w = p["cluster_weights"].float()                          # [D, C]
    moe = p["MoeModel_0"]
    return {
        "cluster_w": put((in_scale[:, None] * w) * c_scale[None, :], ct),
        "cluster_b": put((in_bias @ w) * c_scale + c_bias),
        "hidden_w": put(p["hidden1_weights"].float() * h_scale[None, :], ct),
        "hidden_b": put(h_bias),
        "gates_kernel": put(moe["gates_kernel"], ct),       # [H, (M+1)·V]
        "experts_kernel": put(moe["experts_kernel"], ct),   # [H, M·V]
        "experts_bias": put(moe["experts_bias"]),
    }


def build_fast_dbof_inference(
    mcfg: ModelConfig,
    top_k: int = 20,
    compute_dtype: torch.dtype = torch.bfloat16,
    return_probs: bool = False,
):
    """Return ``fn(fast_params, features, num_frames, key, presampled=False,
    row_offset=0)`` → (values [B,k], indices [B,k]), or the probabilities
    [B, V] when ``return_probs``.  ``key`` is a ``utils/prng.py`` key, which
    draws the frames the JAX fast path draws (``row_offset`` as in
    ``ops/fast_infer.py``)."""
    m, v = mcfg.moe_num_mixtures, mcfg.vocab_size
    ct = compute_dtype

    def forward(fp, features, num_frames, key, presampled: bool = False, row_offset: int = 0):
        b = features.shape[0]
        if not presampled:
            idx = sample_indices(key, num_frames, features.shape[1], mcfg.iterations, row_offset)
            features = gather_frames(features, idx)
        x = dequantize(features, dtype=ct) if features.dtype == torch.uint8 else features.to(ct)
        x = l2_normalize(x, dim=-1)

        act = torch.clamp(matmul_f32(x.reshape(-1, x.shape[-1]), fp["cluster_w"]) + fp["cluster_b"],
                          0.0, 6.0)
        pooled = frame_pooling(act.reshape(b, -1, act.shape[-1]), mcfg.dbof_pooling_method)
        h = matmul_f32(pooled.to(ct), fp["hidden_w"]) + fp["hidden_b"]
        h = torch.clamp(h, 0.0, 6.0).to(ct)

        ga = matmul_f32(h, fp["gates_kernel"]).reshape(b, m + 1, v)
        ea = (matmul_f32(h, fp["experts_kernel"]) + fp["experts_bias"]).reshape(b, m, v)
        probs = torch.sum(torch.softmax(ga, dim=1)[:, :m] * torch.sigmoid(ea), dim=1)
        if return_probs:
            return probs
        return top_k_exact(probs, min(top_k, v))

    return forward
