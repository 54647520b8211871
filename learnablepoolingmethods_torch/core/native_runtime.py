"""The native runner: the fast routes served with no Python in their
execution path (ref: learnablepoolingmethods_tpu/core/native_runtime.py).

The JAX package runs its exported StableHLO module with XLA's PJRT CPU
client (``native/stablehlo_runner.cc``).  The card's machine has neither,
so the port's runner is a CUDA C++ program of each model's route
(``csrc/native_runner.cu``): the TPU-kernel counterparts it needs (rows 1,
2, 5, 6 and 7), cuBLAS for the dense products, and the hand kernels of
``ops/native_tail.py``.  It reads the artifact that ``export_model(...,
with_stablehlo=True)`` writes:

    native_manifest.txt   the JAX package's line format and lines, and the
                          port's: the route, and the lines its route needs
                          (ROUTE_LINES: the sampling key and mode, iterations,
                          moe_num_mixtures, DBoF's pooling, NeXtVLAD's groups
                          and expansion, the encoder's layers and heads, the
                          pooling's queries, the RNNs' layers and cells) and
                          one named line per array
    weights.bin           the route's arrays (ARRAYS: the fast route's
                          prepare with BNs folded, bf16 and f32 as the
                          kernels read them; the f32 leaves of the models
                          with no fast route: the two video-level heads,
                          FrameLevelLogisticModel, AttentionPoolingModel and
                          the RNNs),
                          dense, row-major,
                          little-endian, in the manifest's order

The routes (ROUTES), one per model:

    fast_netvlad_frontend  NetVLADModelLF: row 1, the hidden FC, the tail
    video_logistic         LogisticModel: row_l2, SGEMM, bias_sigmoid   (f32)
    video_moe              MoeModel: row_l2, two SGEMMs, moe_combine   (f32)
    fast_dbof              DbofModel, iid or one window a video: frame_stage,
                           bias_relu6, frame_pool, bias_relu6, the MoE
    fast_lf_netrvlad       NetRVLADModelLF: frame_stage, row 2 a modality
    fast_lf_softdbow       SoftDbofModelLF: frame_stage, row 6, row_l2
    fast_lf_netfv          NetFVModelLF: frame_stage, row 5 (fv1 and fv2)
    fast_lf_nextvlad       NeXtVLADModel: frame_stage, the expansion
                           (rounded to bf16 by cuBLAS), nextvlad_assign,
                           a batched product, nextvlad_residual, row_l2
    fast_transformer       TransformerEncoderModel: frame_stage of every
                           frame and the key mask, the encoder (each product
                           then bias_act; row 7; residual_layernorm),
                           masked_mean
    fast_attn_netvlad      AttentionNetVLADModel: the same encoder (its last
                           residual_layernorm zeroes the pad rows), row 2
    frame_logistic         FrameLevelLogisticModel: frame_stage of every frame
                           in f32, masked_mean, SGEMM, bias_sigmoid      (f32)
    attention_pooling      AttentionPoolingModel: frame_stage in f32, the
                           input projection and bias_act, the key/value
                           SGEMM, pool_attention (the queries' projection
                           made once at load), the output projection, the
                           hidden FC, each with bias_act; gating, the MoE (f32)
    rnn_lstm, rnn_gru      LstmModel, GruModel: frame_stage in f32, then a
                           layer: one SGEMM x·W_i over every frame, then
                           a step: the SGEMM h·W_h and lstm_cell, or one
                           gru_layer over every frame (each keeps the final
                           carry); the MoE                              (f32)

and the LOUPE four and the attention two end in the hidden FC's products,
hidden_sum, gating, moe_combine; every route in topk.

``NativeExecutable`` binds the runner in-process through ``ctypes``;
``build_serving_binary`` links it into ``lpm_serve``
(``native/serving_main.cc``), the HTTP server with no Python at all.  Both
run on the card only: there is no CPU runner and no fallback.
``plain_run`` is the runner's plain PyTorch version, each route's steps in
their plain versions over the artifact's arrays, for the tests and
``chip_smoke.py``.

    exe = NativeExecutable.from_export_dir(export_dir)   # weights uploaded once
    values, indices = exe.run(features_u8, num_frames)   # a batch of the export's size
    values, indices = exe.run(features_f32)              # a video-level artifact
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.data.native_loader import NATIVE_DIR
from learnablepoolingmethods_torch.ops import kernel_build
from learnablepoolingmethods_torch.ops.fast_infer import build_fast_netvlad_inference, matmul_f32_local
from learnablepoolingmethods_torch.ops.fast_lf import lf_hidden_parts
from learnablepoolingmethods_torch.ops.fast_transformer import encoder_stack
from learnablepoolingmethods_torch.ops.native_tail import (
    bias_act_plain,
    bias_relu6_plain,
    bias_sigmoid_plain,
    frame_pool_plain,
    frame_stage_all_plain,
    frame_stage_plain,
    gating_plain,
    gru_layer_plain,
    hidden_sum_plain,
    lstm_cell_plain,
    masked_mean_plain,
    moe_combine_plain,
    pool_attention_plain,
    row_l2_plain,
)
from learnablepoolingmethods_torch.ops.netvlad_fused import netvlad_fused
from learnablepoolingmethods_torch.ops.topk import top_k_exact
from learnablepoolingmethods_torch.utils.misc import resolve_device

MANIFEST_FILE = "native_manifest.txt"
WEIGHTS_FILE = "weights.bin"
# the routes of csrc/native_runner.cu (kRouteNames), by the model each serves
ROUTES = {
    "fast_netvlad_frontend": "NetVLADModelLF",
    "video_logistic": "LogisticModel",
    "video_moe": "MoeModel",
    "fast_dbof": "DbofModel",
    "fast_lf_netrvlad": "NetRVLADModelLF",
    "fast_lf_softdbow": "SoftDbofModelLF",
    "fast_lf_netfv": "NetFVModelLF",
    "fast_lf_nextvlad": "NeXtVLADModel",
    "fast_transformer": "TransformerEncoderModel",
    "fast_attn_netvlad": "AttentionNetVLADModel",
    "frame_logistic": "FrameLevelLogisticModel",
    "attention_pooling": "AttentionPoolingModel",
    "rnn_lstm": "LstmModel",
    "rnn_gru": "GruModel",
}
MODEL_ROUTES = {model: route for route, model in ROUTES.items()}
VIDEO_ROUTES = ("video_logistic", "video_moe")
ATTENTION_ROUTES = ("fast_transformer", "fast_attn_netvlad")
RNN_ROUTES = ("rnn_lstm", "rnn_gru")
# the routes of the models with no fast route that read every frame
FLAX_FRAME_ROUTES = ("frame_logistic", "attention_pooling") + RNN_ROUTES
# the frame-level routes that draw no frames (S = F)
ALL_FRAME_ROUTES = ATTENTION_ROUTES + FLAX_FRAME_ROUTES
# the logistic heads (fc/kernel, fc/bias; no MoE)
LOGISTIC_ROUTES = ("video_logistic", "frame_logistic")
# the routes of the model's f32 forward (the others: a fast route's bf16)
F32_ROUTES = VIDEO_ROUTES + FLAX_FRAME_ROUTES
LF_ROUTES = ("fast_lf_netrvlad", "fast_lf_softdbow", "fast_lf_netfv", "fast_lf_nextvlad")
# NetVLADModelLF's route, the runner's first
ROUTE = "fast_netvlad_frontend"
MOE = ("gates_kernel", "experts_kernel", "experts_bias")
TAIL = ("hidden_b", "gate_w", "g_scale", "g_bias") + MOE
# a LOUPE modality's arrays (prepare_fast_lf_params' keys of its mods entry)
LF_MOD_ARRAYS = {
    "fast_lf_netrvlad": ("cluster", "scale", "bias", "c2", "w1"),
    "fast_lf_softdbow": ("cluster", "scale", "bias", "w1"),
    "fast_lf_netfv": ("cluster", "scale", "bias", "c2", "covar", "w1", "w2"),
    "fast_lf_nextvlad": ("cluster", "scale", "bias", "wg", "wa", "c2", "vscale", "vbias", "w1"),
}
# an encoder layer's arrays (ops/fast_transformer.py#_prepare_encoder_layers)
LAYER_ARRAYS = ("wqkv", "bqkv", "wo", "bo", "ln1_s", "ln1_b", "ln2_s", "ln2_b", "w1", "b1", "w2", "b2")
# an RNN layer's arrays: the gates' kernels side by side (LSTM i, f, g, o;
# GRU r, z, n) and the biases flax gives them
RNN_LAYER_ARRAYS = {"rnn_lstm": ("w_i", "w_h", "b_h"), "rnn_gru": ("w_i", "b_i", "w_h", "b_hn")}
# AttentionPoolingModel's arrays: the input projection, the queries and
# pool_mha's projections ([D, H·hd]; key and value side by side), the hidden
# FC and the folded gating (f32)
POOL_ARRAYS = ("w_proj", "b_proj", "queries", "wq", "bq", "wkv", "bkv", "wo", "bo", "hidden_w", "hidden_b",
               "gate_w", "g_scale", "g_bias")


def route_arrays(route: str, n_mods: int = 2, n_layers: int = 2) -> Tuple[str, ...]:
    """The runner's arrays of ``route`` in weights.bin's order: the keys of
    its prepare, "/" into nested dicts and lists ("rgb/cluster",
    "mods/0/w1", "layers/1/wqkv"); a LOUPE route of ``n_mods`` modalities,
    an attention or RNN route of ``n_layers`` layers."""
    if route in RNN_ROUTES:
        return tuple(f"layers/{i}/{a}" for i in range(n_layers) for a in RNN_LAYER_ARRAYS[route]) + MOE
    if route == "attention_pooling":
        return POOL_ARRAYS + MOE
    if route in ATTENTION_ROUTES:
        pool = ("hidden_w",) if route == "fast_transformer" else ("cluster", "c_scale", "c_bias", "c2", "hidden_w")
        return (("w_proj", "b_proj") + tuple(f"layers/{i}/{a}" for i in range(n_layers) for a in LAYER_ARRAYS)
                + pool + TAIL)
    if route == "fast_netvlad_frontend":
        return (("in_scale", "in_bias") + tuple(f"{m}/{a}" for m in ("rgb", "aud") for a in ("cluster", "scale",
                                                                                          "bias", "c2"))
                + ("w_rgb", "w_aud") + TAIL)
    if route in LOGISTIC_ROUTES:
        return ("fc/kernel", "fc/bias")
    if route == "video_moe":
        return MOE
    if route == "fast_dbof":
        return ("cluster_w", "cluster_b", "hidden_w", "hidden_b") + MOE
    return (("in_scale", "in_bias") + tuple(f"mods/{i}/{a}" for i in range(n_mods) for a in LF_MOD_ARRAYS[route])
            + TAIL)


# each route's arrays in the two-modality layout of the default features and
# the default two encoder layers
ARRAYS = {route: route_arrays(route) for route in ROUTES}
# the port's manifest lines that each route needs beside the JAX package's
# (csrc/native_manifest.h kRoutes)
ROUTE_LINES = {route: ("route",) + (() if route in VIDEO_ROUTES + ALL_FRAME_ROUTES else ("sampling_key", "iterations"))
               + (() if route in LOGISTIC_ROUTES else ("moe_num_mixtures",))
               + {"fast_dbof": ("sampling", "dbof_pooling_method"),
                  "fast_lf_nextvlad": ("nextvlad_groups", "nextvlad_expansion"),
                  **dict.fromkeys(ATTENTION_ROUTES, ("transformer_layers", "attention_heads")),
                  "attention_pooling": ("attention_heads", "attention_cluster_size"),
                  **dict.fromkeys(RNN_ROUTES, ("rnn_layers", "rnn_cells"))}.get(route, ())
               for route in ROUTES}
TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the launches the runner counts (csrc/native_runner.cu kCounterNames)
COUNTERS = ("netvlad_frontend", "netvlad_fused", "softdbow_fused", "netfv_fused", "masked_attention", "frame_stage",
            "bias_sigmoid", "bias_relu6", "frame_pool", "row_l2", "nextvlad_assign", "nextvlad_residual", "bias_act",
            "residual_layernorm", "masked_mean", "hidden_sum", "gating", "moe_combine", "topk", "lstm_cell",
            "gru_cell", "pool_attention", "gru_layer")
# the TPU-kernel counterparts among them (PERF.md's rows 1, 2, 6, 5 and 7)
ROW_KERNELS = ("netvlad_frontend", "netvlad_fused", "softdbow_fused", "netfv_fused", "masked_attention")

LIBRARY = "native_runner"
SERVE_SOURCES = ("serving_main.cc", "tfrecord_reader.cc")
SERVE_CXX_FLAGS = ("-O2", "-std=c++17", "-pthread")
SERVE_BUILD_DIR = kernel_build.BUILD_DIR.parent / "host"
ERR_CAP = 4096
_TEXT_LINES = ("model", "route", "sampling", "dbof_pooling_method")


def array_of(arrays, name: str):
    """The array ``name`` of a route's arrays in its prepare's nested layout
    ("rgb/cluster" is ``arrays["rgb"]["cluster"]``, "mods/1/w1" is
    ``arrays["mods"][1]["w1"]``)."""
    node = arrays
    for part in name.split("/"):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def nest(flat: Dict[str, object]):
    """{"a/b": x} → {"a": {"b": x}}, a level whose keys are 0 … n−1 as a list."""
    root: Dict[str, object] = {}
    for name, value in flat.items():
        *heads, leaf = name.split("/")
        node = root
        for head in heads:
            node = node.setdefault(head, {})
        node[leaf] = value

    def listed(node):
        if not isinstance(node, dict):
            return node
        node = {k: listed(v) for k, v in node.items()}
        if node and sorted(node) == [str(i) for i in range(len(node))]:
            return [node[str(i)] for i in range(len(node))]
        return node

    return listed(root)


def read_manifest(export_dir: str) -> dict:
    """``native_manifest.txt`` → {"model", "route", "batch_size", "top_k", …,
    "sampling_key": (k0, k1), "nextvlad_groups": (g, …), "features":
    [(name, size)], "call_inputs" and "outputs": [(tag, shape)], "weights":
    [(name, tag, shape)]}.  Raises ValueError for a JAX export's manifest,
    which has no route line, for an unknown route and for a manifest that
    lacks a line its route needs (naming the line)."""
    path = os.path.join(export_dir, MANIFEST_FILE)
    if not os.path.exists(path):
        raise ValueError(f"{export_dir} has no {MANIFEST_FILE}: export it with with_stablehlo=True")
    out = {"features": [], "call_inputs": [], "outputs": [], "weights": []}
    with open(path) as f:
        lines = [line.split() for line in f if line.strip()]
    if not lines or lines[0] != ["lpm_native_manifest", "1"]:
        raise ValueError(f"{path}: not a native manifest")
    if not any(words[0] == "route" for words in lines):
        raise ValueError(f"{path} has no route line: it is a JAX with_stablehlo export, which the port's runner "
                         "does not read; re-export it through learnablepoolingmethods_torch's "
                         "export_model(..., with_stablehlo=True)")
    for key, *rest in lines[1:]:
        if key in _TEXT_LINES:
            out[key] = rest[0]
        elif key in ("sampling_key", "nextvlad_groups"):
            out[key] = tuple(int(w) for w in rest)
        elif key == "feature":
            out["features"].append((rest[0], int(rest[1])))
        elif key in ("call_input", "output"):
            out[f"{key}s"].append((rest[0], tuple(int(d) for d in rest[2:])))
        elif key == "weight":
            out["weights"].append((rest[0], rest[1], tuple(int(d) for d in rest[3:])))
        else:
            out[key] = int(rest[0])
    route = out["route"]
    if route not in ROUTES:
        raise ValueError(f"{path}: unknown route {route!r}; the runner's are {sorted(ROUTES)}")
    missing = [line for line in ROUTE_LINES[route] if line not in out]
    if missing:
        raise ValueError(f"{path}: route {route} needs the line {missing[0]!r}")
    return out


def read_artifact(export_dir: str) -> Tuple[dict, Dict[str, object]]:
    """(manifest, arrays): the arrays of ``weights.bin`` as CPU tensors in
    the route's nested layout (:func:`nest`).  Raises ValueError when the
    file's size is not the sum of the manifest's arrays."""
    manifest = read_manifest(export_dir)
    blob = np.fromfile(os.path.join(export_dir, WEIGHTS_FILE), np.uint8)
    flat, off = {}, 0
    for name, tag, shape in manifest["weights"]:
        dtype = np.int16 if tag == "bf16" else np.float32
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        if off + n > blob.size:
            break
        t = torch.from_numpy(blob[off:off + n].view(dtype).reshape(shape).copy())
        flat[name] = t.view(torch.bfloat16) if tag == "bf16" else t
        off += n
    want = sum(int(np.prod(s, dtype=np.int64)) * (2 if t == "bf16" else 4) for _, t, s in manifest["weights"])
    if blob.size != want:
        raise ValueError(f"{WEIGHTS_FILE} has {blob.size} bytes, the manifest accounts for {want} — "
                         "re-export the artifact")
    return manifest, nest(flat)


def _sizes(manifest: dict) -> dict:
    shapes = {name: shape for name, _, shape in manifest["weights"]}
    if manifest["route"] in LOGISTIC_ROUTES:
        vocab = shapes["fc/bias"][0]
    else:
        vocab = shapes["experts_bias"][0] // manifest["moe_num_mixtures"]
    return dict(batch=manifest["batch_size"], frames=manifest["max_frames"],
                width=sum(size for _, size in manifest["features"]), k=manifest["outputs"][0][1][1],
                vocab=vocab, video_level=manifest["route"] in VIDEO_ROUTES)


def _moe_probs(h: torch.Tensor, arrays: dict, m: int) -> torch.Tensor:
    return moe_combine_plain(matmul_f32_local(h, arrays["gates_kernel"]),
                             matmul_f32_local(h, arrays["experts_kernel"]), arrays["experts_bias"], m)


def _frame_route_probs(manifest: dict, arrays: dict, x: torch.Tensor, nf: torch.Tensor) -> torch.Tensor:
    route, s, m = manifest["route"], manifest["iterations"], manifest["moe_num_mixtures"]
    key = torch.tensor(manifest["sampling_key"], dtype=torch.int64)
    b = x.shape[0]
    if route == "fast_dbof":
        xs = frame_stage_plain(x, key, nf, s, window=manifest["sampling"] == "window")
        act = bias_relu6_plain(matmul_f32_local(xs.reshape(b * s, -1), arrays["cluster_w"]), arrays["cluster_b"])
        pooled = frame_pool_plain(act.reshape(b, s, -1), manifest["dbof_pooling_method"])
        h = bias_relu6_plain(matmul_f32_local(pooled, arrays["hidden_w"]), arrays["hidden_b"], torch.bfloat16)
        return _moe_probs(h, arrays, m)
    xs = frame_stage_plain(x, key, nf, s, arrays["in_scale"], arrays["in_bias"])
    parts, off = [], 0
    for entry in arrays["mods"]:
        d = entry["cluster"].shape[0]
        parts += lf_hidden_parts(ROUTES[route], xs[:, :, off:off + d], entry)
        off += d
    return _gated_probs(parts, arrays, m, len(parts) // len(arrays["mods"]), bias_first=True)


def _gated_probs(parts, arrays: dict, m: int, group: int = 1, bias_first: bool = False,
                 trace: Optional[dict] = None) -> torch.Tensor:
    """hidden_sum of the hidden FC's products, the gating product on its
    bf16 rounding, gating, the MoE: the gated tail's probabilities (``trace``
    keeps the products as "part/<i>" and h)."""
    h, hb = hidden_sum_plain(parts, arrays["hidden_b"], group, bias_first)
    if trace is not None:
        trace.update({f"part/{i}": p for i, p in enumerate(parts)}, h=h)
    hg = gating_plain(matmul_f32_local(hb, arrays["gate_w"]), h, arrays["g_scale"], arrays["g_bias"])
    return _moe_probs(hg, arrays, m)


def pool_query(arrays: dict) -> torch.Tensor:
    """AttentionPoolingModel's query projection with its bias [Q, H·hd]
    (f32): it reads no input, so the runner makes it once, at load."""
    return bias_act_plain(matmul_f32_local(arrays["queries"], arrays["wq"]), arrays["bq"], dtype=torch.float32)


def recurrent_final(route: str, layers, x: torch.Tensor, num_frames: torch.Tensor,
                    trace: Optional[dict] = None) -> torch.Tensor:
    """The RNN routes' layers over every frame of ``x`` [B, F, D] (f32): a
    layer's x·W_i over all frames at once, then, from a zero state, each
    step's h·W_h and the cell (``lstm_cell_plain``; the GRU's loop is
    ``gru_layer_plain``), whose outputs are the next layer's input, pad
    frames included, as flax's ``nn.RNN`` runs them → the top layer's carry
    at each row's ``last_frame`` [B, H].  ``trace`` keeps the top layer's
    products x·W_i ("pre/last") and outputs ("seq/last") and the carry
    ("final")."""
    b, f, _ = x.shape
    for i, lp in enumerate(layers):
        pre = matmul_f32_local(x.reshape(b * f, -1), lp["w_i"]).reshape(b, f, -1)
        if route == "rnn_gru":
            x, carry = gru_layer_plain(pre, lp["w_h"], lp["b_i"], lp["b_hn"], num_frames)
            continue
        h = c = carry = x.new_zeros(b, lp["w_h"].shape[0])
        outs = []
        for t in range(f):
            h, c, carry = lstm_cell_plain(pre[:, t], matmul_f32_local(h, lp["w_h"]), lp["b_h"], c, carry,
                                          num_frames, t, f)
            outs.append(h)
        x = torch.stack(outs, dim=1)
    if trace is not None:
        trace.update({"pre/last": pre, "seq/last": x, "final": carry})
    return carry


def _attention_pool_probs(manifest: dict, arrays: dict, xs: torch.Tensor, nf: torch.Tensor,
                          trace: dict) -> torch.Tensor:
    """AttentionPoolingModel in f32 on the staged frames: the input
    projection, the key/value product, pool_attention, the output
    projection, the hidden FC (each + its bias), the gating and the MoE."""
    b, f, dt = xs.shape
    f32 = torch.float32
    xp = bias_act_plain(matmul_f32_local(xs.reshape(b * f, dt), arrays["w_proj"]), arrays["b_proj"], dtype=f32)
    kv = matmul_f32_local(xp, arrays["wkv"]).reshape(b, f, -1)
    att = pool_attention_plain(pool_query(arrays), kv, arrays["bkv"], nf, manifest["attention_heads"])
    pooled = bias_act_plain(matmul_f32_local(att.reshape(-1, att.shape[2]), arrays["wo"]), arrays["bo"],
                            dtype=f32).reshape(b, -1)
    h = bias_act_plain(matmul_f32_local(pooled, arrays["hidden_w"]), arrays["hidden_b"], dtype=f32)
    gated = gating_plain(matmul_f32_local(h, arrays["gate_w"]), h, arrays["g_scale"], arrays["g_bias"], f32)
    trace.update(proj=xp, kv=kv, att=att, pooled=pooled, h=h, gated=gated)
    return _moe_probs(gated, arrays, manifest["moe_num_mixtures"])


def _all_frames_probs(manifest: dict, arrays: dict, x: torch.Tensor, nf: torch.Tensor,
                      trace: Optional[dict] = None) -> torch.Tensor:
    """The routes that read every frame: frame_stage with no draw (and the
    key mask); the attention two's encoder (``ops/fast_transformer.py
    #encoder_stack``: bias_act and residual_layernorm's plain versions, row
    7's wrapper; AttentionNetVLAD's last LayerNorm zeroing the pad rows),
    then masked_mean or row 2's wrapper, the hidden FC and the gated tail;
    the f32 routes on frames staged in f32: FrameLevelLogisticModel's
    masked mean over num_frames, its product and bias_sigmoid;
    AttentionPoolingModel's (:func:`_attention_pool_probs`); the RNNs'
    (:func:`recurrent_final`) and the MoE.  ``trace`` keeps the steps that
    the runner's buffers of the same names hold (``NativeExecutable.read``)."""
    route = manifest["route"]
    b, f, dt = x.shape
    trace = {} if trace is None else trace
    if route in FLAX_FRAME_ROUTES:
        xs, _ = frame_stage_all_plain(x, nf, torch.float32)
        trace.update(frames=xs)
        if route == "attention_pooling":
            return _attention_pool_probs(manifest, arrays, xs, nf, trace)
        if route in RNN_ROUTES:
            return _moe_probs(recurrent_final(route, arrays["layers"], xs, nf, trace), arrays,
                              manifest["moe_num_mixtures"])
        pooled = masked_mean_plain(xs, nf, torch.float32, count_valid=False)
        trace.update(pooled=pooled)
        return bias_sigmoid_plain(pooled @ arrays["fc"]["kernel"], arrays["fc"]["bias"])
    xs, mask = frame_stage_all_plain(x, nf)
    h = bias_act_plain(matmul_f32_local(xs.reshape(b * f, dt), arrays["w_proj"]), arrays["b_proj"])
    h = encoder_stack(arrays["layers"], h.reshape(b, f, -1), mask, manifest["attention_heads"], True,
                      torch.bfloat16, zero_pads=route == "fast_attn_netvlad")
    if route == "fast_transformer":
        pooled = masked_mean_plain(h, nf)
    else:
        pooled = netvlad_fused(h, arrays["cluster"], arrays["c_scale"], arrays["c_bias"], arrays["c2"]).reshape(b, -1)
    trace.update({"frames": xs, "mask": mask, "encoder": h, "pooled" if route == "fast_transformer" else "vlad": pooled})
    return _gated_probs([matmul_f32_local(pooled, arrays["hidden_w"])], arrays, manifest["moe_num_mixtures"],
                        trace=trace)


def tree_to(tree, device):
    """The nested arrays of :func:`read_artifact` on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def plain_run(manifest: dict, arrays: dict, features, num_frames=None, return_probs: bool = False,
              device="cpu", trace: Optional[dict] = None):
    """The runner's plain PyTorch version, route by route over the
    artifact's arrays: every step in its plain version (a kernel's wrapper
    takes it for CPU tensors: row 1's is ``netvlad_frontend_reference``,
    rows 2, 5, 6 and 7 theirs; the tail's are ``ops/native_tail.py``'s), the
    products summed in f32, the frames drawn from the manifest's key.  On
    the CPU each frame-level route equals ``load_exported_model(
    prefer_fast=True, device="cpu")``'s serve bit for bit (the DBoF window
    has no fast route to equal; FrameLevelLogisticModel has none and its
    serve is the model's f32 forward), and the video-level routes compute
    the model's f32 forward; AttentionPoolingModel's and the RNNs' are
    their model's f32 forward within 1e-6 (the gating BN folded, the query
    projection made once).  On a CUDA ``device`` the wrappers launch their
    kernels: the port's torch route.  → (values, indices) [B, k], or the
    probabilities [B, V].  ``trace`` (a dict) receives the steps of a route
    that reads every frame under the names of the runner's buffers."""
    sizes = _sizes(manifest)
    route = manifest["route"]
    x = torch.as_tensor(features).to(device)
    arrays = tree_to(arrays, device)
    nf = None if num_frames is None else torch.as_tensor(num_frames).to(device)
    with torch.no_grad():
        if route == "fast_netvlad_frontend":
            mcfg = ModelConfig(vocab_size=sizes["vocab"], moe_num_mixtures=manifest["moe_num_mixtures"],
                               iterations=manifest["iterations"])
            fn = build_fast_netvlad_inference(mcfg, top_k=sizes["k"], return_probs=return_probs)
            key = torch.tensor(manifest["sampling_key"], dtype=torch.int64)
            return fn(arrays, x, nf, key)
        if route in VIDEO_ROUTES:
            x = row_l2_plain(x, dtype=torch.float32)  # the predict step's preprocess_input
        if route == "video_logistic":
            probs = bias_sigmoid_plain(x @ arrays["fc"]["kernel"], arrays["fc"]["bias"])
        elif route == "video_moe":
            probs = _moe_probs(x, arrays, manifest["moe_num_mixtures"])
        elif route in ALL_FRAME_ROUTES:
            probs = _all_frames_probs(manifest, arrays, x, nf, trace)
        else:
            probs = _frame_route_probs(manifest, arrays, x, nf)
    return probs if return_probs else top_k_exact(probs, sizes["k"])


def _card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the native runner runs on the card (a CUDA device), not on {dev}: it has no CPU "
                         "version; serve on the CPU through load_exported_model")
    return dev


class NativeExecutable:
    """An export's native artifact loaded into the runner on the card:
    ``run(features, num_frames=None)`` → (values, indices) as the route's
    serve returns them, for a batch of exactly the export's size; a
    video-level artifact takes no frame counts."""

    _handle = None

    def __init__(self, manifest: dict, handle=None):
        self.manifest = manifest
        sizes = _sizes(manifest)
        self.route = manifest["route"]
        self.batch_size, self.top_k, self.vocab_size = sizes["batch"], sizes["k"], sizes["vocab"]
        self.video_level = sizes["video_level"]
        if self.video_level:
            self._inputs = (((self.batch_size, sizes["width"]), np.float32),)
        else:
            self._inputs = (((self.batch_size, sizes["frames"], sizes["width"]), np.uint8),
                            ((self.batch_size,), np.int32))
        self._handle = handle

    @classmethod
    def from_export_dir(cls, export_dir: str, device="cuda") -> "NativeExecutable":
        """Load the artifact on ``device`` (a CUDA device; the CPU raises
        ValueError), building the runner at its first use.  Raises
        ValueError for a JAX export and RuntimeError with the runner's
        message when it does not load."""
        dev = _card(device)
        manifest = read_manifest(export_dir)
        resolve_device(dev)
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        err = ctypes.create_string_buffer(ERR_CAP)
        handle = _fn("lpm_runner_load", [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_longlong],
                     ctypes.c_void_p)(os.fsencode(export_dir), index, err, ERR_CAP)
        if not handle:
            raise RuntimeError(f"native runner: {err.value.decode(errors='replace')}")
        return cls(manifest, handle)

    def _check(self, features, num_frames: Optional[np.ndarray]):
        if (num_frames is None) != self.video_level:
            raise ValueError(f"route {self.route}: " + ("a video-level artifact takes no frame counts"
                                                        if self.video_level else "needs the frame counts"))
        args = tuple(np.ascontiguousarray(a) for a in (features, num_frames) if a is not None)
        for a, (shape, dtype) in zip(args, self._inputs):
            if a.shape != shape or a.dtype != dtype:
                raise ValueError(f"input mismatch: got {a.dtype}{list(a.shape)}, export expects "
                                 f"{np.dtype(dtype).name}{list(shape)} — pad the batch to the exported batch "
                                 f"size {self.batch_size}")
        if self._handle is None:
            raise RuntimeError("the native runner is closed")
        return args

    def _call(self, symbol: str, args, outs) -> None:
        err = ctypes.create_string_buffer(ERR_CAP)
        ptrs = [args[0].ctypes.data, args[1].ctypes.data if len(args) > 1 else None] + [o.ctypes.data for o in outs]
        fn = _fn(symbol, [ctypes.c_void_p] * (1 + len(ptrs)) + [ctypes.c_char_p, ctypes.c_longlong])
        if fn(self._handle, *ptrs, err, ERR_CAP) != 0:
            raise RuntimeError(f"native runner: {err.value.decode(errors='replace')}")

    def run(self, features, num_frames=None):
        """→ (values [B, k] f32, indices [B, k] int32) as NumPy arrays; B
        must equal the exported batch size (serving pads to it)."""
        args = self._check(features, num_frames)
        values = np.empty((self.batch_size, self.top_k), np.float32)
        indices = np.empty((self.batch_size, self.top_k), np.int32)
        self._call("lpm_runner_run", args, (values, indices))
        return values, indices

    def probs(self, features, num_frames=None) -> np.ndarray:
        """The class probabilities [B, V] f32 (the route's ``return_probs``)."""
        args = self._check(features, num_frames)
        out = np.empty((self.batch_size, self.vocab_size), np.float32)
        self._call("lpm_runner_probs", args, (out,))
        return out

    def launches(self) -> Dict[str, int]:
        """The runner's own launches of each kernel it counts (COUNTERS)
        since it loaded or :meth:`reset_launches`."""
        fn = _fn("lpm_runner_launches", [ctypes.c_void_p, ctypes.c_char_p], ctypes.c_longlong)
        return {name: fn(self._handle, name.encode()) for name in COUNTERS}

    def read(self, name: str, shape, dtype=torch.float32) -> torch.Tensor:
        """The last batch's buffer ``name`` on the host, for tracing a route
        against its torch version: ``"h"`` and ``"part/<i>"`` (f32 [B, H]),
        a NeXtVLAD modality's ``"mods/<i>/xt"``, ``"assign"``,
        ``"residual"`` and ``"vlad"``, an attention route's ``"frames"``,
        ``"mask"``, ``"ffn1"`` and ``"ffn2"`` (its last layer's FFN),
        ``"encoder"`` and ``"pooled"`` or ``"vlad"``,
        FrameLevelLogisticModel's ``"frames"`` and ``"pooled"``,
        AttentionPoolingModel's ``"frames"``, ``"proj"``, ``"kv"``,
        ``"att"``, ``"pooled"``, ``"h"`` and ``"gated"``, an RNN's
        ``"frames"``, ``"pre/last"``, ``"seq/last"`` and ``"final"`` (``csrc/native_runner.cu#buffers``)."""
        out = torch.empty(shape, dtype=dtype)
        fn = _fn("lpm_runner_read", [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong],
                 ctypes.c_longlong)
        nbytes = out.numel() * out.element_size()
        if fn(self._handle, name.encode(), out.data_ptr(), nbytes) != nbytes:
            raise ValueError(f"route {self.route}: no buffer {name!r} of {nbytes} bytes")
        return out

    def reset_launches(self) -> None:
        _fn("lpm_runner_reset_launches", [ctypes.c_void_p], None)(self._handle)

    def close(self) -> None:
        """Free the runner's memory on the card."""
        if self._handle is not None:
            _fn("lpm_runner_destroy", [ctypes.c_void_p], None)(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def _fn(symbol: str, argtypes, restype=ctypes.c_int):
    return kernel_build.load_function(LIBRARY, symbol, argtypes, restype)


def serving_binary_command(runner, output) -> list:
    """The g++ command that links ``lpm_serve``: the server and the record
    parser (``native/``) with ``runner``, a library or source that defines
    the runner's C API."""
    runner = Path(runner)
    return ["g++", *SERVE_CXX_FLAGS, f"-I{kernel_build.CSRC_DIR}", "-o", str(output),
            *(str(NATIVE_DIR / s) for s in SERVE_SOURCES), str(runner), f"-Wl,-rpath,{runner.parent}"]


def build_serving_binary() -> Path:
    """``lpm_serve`` linked with the runner at first use, into
    ``build/host/`` (named by a hash of its sources, flags and runner; a
    file of this process renamed into place).  Builds the runner first if
    need be; raises RuntimeError with g++'s output on failure."""
    runner = kernel_build.library_path(LIBRARY)
    if not runner.exists():
        kernel_build.build([LIBRARY])
    digest = hashlib.sha256(" ".join(SERVE_CXX_FLAGS + (runner.name,)).encode())
    headers = [kernel_build.CSRC_DIR / h for h in kernel_build.LIBRARY_PARTS[LIBRARY]["headers"]]
    for path in [NATIVE_DIR / s for s in SERVE_SOURCES] + headers:
        digest.update(path.read_bytes())
    target = SERVE_BUILD_DIR / f"lpm_serve-{digest.hexdigest()[:16]}"
    if target.exists():
        return target
    SERVE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run(serving_binary_command(runner, tmp), capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build lpm_serve:\n{out.stdout}{out.stderr}")
    os.replace(tmp, target)
    return target
