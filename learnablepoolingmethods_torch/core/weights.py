"""Weight bridge between the JAX package's flax variables and the port.

The flax ``{params, batch_stats}`` tree of an LF model (``NetVLADModelLF``
and the rest of the LOUPE family), of the attention family
(``TransformerEncoderModel``, ``AttentionPoolingModel``,
``AttentionNetVLADModel``), of ``LstmModel`` or ``GruModel``, of
``DbofModel`` or of a single-layer model (``LogisticModel``, ``MoeModel``,
``FrameLevelLogisticModel``) crosses over as
nested dicts of NumPy arrays, so the port needs neither JAX nor orbax.  On
the JAX side:

    tree = jax.tree.map(np.asarray, CheckpointManager(d).restore(step))
    save_variables_npz({"params": tree["params"],
                        "batch_stats": tree["batch_stats"]}, train_dir)

and the port reads it back with :func:`load_variables_npz` and
:func:`convert_flax_variables` (the fast path) or :func:`load_flax_variables`
(the ``nn.Module`` model).  :func:`state_dict_to_flax` goes the other way
(a weights-only ``variables.npz`` that the eval and inference CLIs read at
step 0).  Keys keep the flax layout: ``[D, K]``
cluster weights, ``[1, D, K]`` C₂, the d-major ``[D·K + D_a·K_a, H]``
hidden FC and the vocab-major MoE kernels (column m·V + v).

The whole train state crosses too: :func:`train_state_from_jax_tree` takes
the JAX package's ``state_to_tree(state)`` (step, params, batch_stats and
the optax ``opt_state``, as numpy arrays) into the port's TrainState, and
:func:`train_state_to_jax_tree` gives it back, both by the leaf paths of
:func:`tree_paths`, which name a checkpoint's leaves (``core/checkpoints.py``).

:func:`init_variables_np` makes a tree of the same keys, shapes and
initial scales as ``model.init`` from a seed, for machines without JAX;
within :func:`init_memo` it draws each distinct tree once.
"""

from __future__ import annotations

import contextlib
import os
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.models.frame_level import (
    LF_MODULE_PREFIX,
    PoolLayout,
    lf_hparams,
    lf_layout,
)
from learnablepoolingmethods_torch.ops.fast_dispatch import FAST_ATTENTION_MODELS
from learnablepoolingmethods_torch.utils.flax_msgpack import BFloat16Bits

NPZ_NAME = "variables.npz"

Tree = Dict[str, Any]


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = value
    return flat


def _unflatten(flat: Dict[str, Any]) -> Tree:
    tree: Tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def bf16_bits_to_f32(arr) -> np.ndarray:
    """A bf16 array (ml_dtypes' bfloat16, or its uint16 bit patterns, which
    is how the port stores and reads bf16 without ml_dtypes) widened to f32,
    exactly."""
    bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def as_f32(value) -> np.ndarray:
    """A leaf of a flax tree as f32 numpy: bf16 (ml_dtypes, named
    ``bfloat16``) and uint16 (bf16 bit patterns) widened exactly, any other
    dtype cast."""
    arr = np.asarray(value)
    if arr.dtype == np.uint16 or arr.dtype.name == "bfloat16":
        return bf16_bits_to_f32(arr)
    return np.ascontiguousarray(arr.astype(np.float32, copy=False))


def unflatten_tree(flat: Dict[str, Any]) -> Tree:
    """``{"a/b/c": x}`` → ``{"a": {"b": {"c": x}}}``."""
    return _unflatten(flat)


def tree_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """The leaves of a nested tree by path: dict keys and NamedTuple fields
    by name, tuple and list positions by index, joined by ``/`` (the names
    of a checkpoint's leaves, ``core/checkpoints.py``).  An empty node (an
    optax ``EmptyState``, a model's empty ``batch_stats``) has no leaves."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(tree_paths(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def tree_like(template, flat: Dict[str, Any], prefix: str = ""):
    """The inverse of :func:`tree_paths` on ``template``'s structure (dicts,
    NamedTuples, tuples, lists): each leaf taken from ``flat`` by its path
    and cast to the template leaf's dtype."""
    def path(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(template, Mapping):
        return {k: tree_like(v, flat, path(k)) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(tree_like(v, flat, path(k)) for k, v in zip(template._fields, template)))
    if isinstance(template, (tuple, list)):
        return type(template)(tree_like(v, flat, path(i)) for i, v in enumerate(template))
    return np.asarray(flat[prefix]).astype(np.asarray(template).dtype)


def train_state_from_jax_tree(tree_np, model: torch.nn.Module, tcfg):
    """The port's TrainState from the JAX package's ``state_to_tree(state)``
    (nested dicts and optax NamedTuples of arrays; bf16 leaves as ml_dtypes
    arrays or as their uint16 bits, read without ml_dtypes): ``model``'s
    parameters and BN statistics, the optimizer of
    ``tcfg`` and the step, each checked against the live state by name,
    shape and dtype."""
    from learnablepoolingmethods_torch.core.checkpoints import dtype_name, to_tensor
    from learnablepoolingmethods_torch.core.train_state import TrainState

    state = TrainState.create(model, tcfg)
    live = state.state_tree()

    def leaf(name, value):
        arr = np.asarray(value)
        if name in live and live[name].dtype == torch.bfloat16 and (
                arr.dtype == np.uint16 or arr.dtype.name == "bfloat16"):
            return to_tensor(arr.view(np.uint16), "bfloat16")
        return to_tensor(arr, dtype_name(arr))

    state.load_state_tree({name: leaf(name, value) for name, value in tree_paths(tree_np).items()})
    return state


def train_state_to_jax_tree(state, like=None):
    """The inverse of :func:`train_state_from_jax_tree`: the state's leaves
    as numpy arrays (bf16 widened to f32, exactly), by their
    ``state_to_tree`` paths; with ``like`` (a JAX state tree) rebuilt in its
    structure and dtypes, else as nested dicts."""
    flat = {name: t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()
            for name, t in state.state_tree().items()}
    return tree_like(like, flat) if like is not None else _unflatten(flat)


def _npz_path(path: str) -> str:
    return os.path.join(path, NPZ_NAME) if os.path.isdir(path) else path


def save_variables_npz(tree: Tree, path: str) -> str:
    """Write a nested tree of arrays as one ``.npz`` with flattened
    ``params/NetVLAD_0/cluster_weights``-style keys.  ``path`` is a file or
    a directory (then ``<path>/variables.npz``).  Returns the file written."""
    target = _npz_path(path)
    flat = {
        key: (value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value))
        for key, value in _flatten(tree).items()
    }
    with open(target, "wb") as f:
        np.savez(f, **flat)
    return target


def load_variables_npz(path: str) -> Tree:
    """Read a tree written by :func:`save_variables_npz` (file or directory)."""
    with np.load(_npz_path(path)) as data:
        return _unflatten({key: data[key] for key in data.files})


def _shape(tree: Tree, path: str):
    node = tree
    for name in path.split("/"):
        if not isinstance(node, Mapping) or name not in node:
            raise ValueError(f"variables have no {path!r}")
        node = node[name]
    return tuple(np.shape(node))


def _expect(tree: Tree, path: str, shape) -> None:
    got = _shape(tree, path)
    if got != tuple(shape):
        raise ValueError(f"{path}: shape {got}, expected {tuple(shape)}")


def _pool_spec(model_name: str, mod: PoolLayout, mcfg: ModelConfig, add_bn: bool):
    """One pooling module's parameters in flax's order of creation:
    ``(name, shape, std)``, ``std`` None for a BatchNorm of that width."""
    d, k = mod.feature_size, mod.cluster_size
    std = 1 / np.sqrt(d)
    if model_name == "NeXtVLADModel":
        lam_d = mcfg.nextvlad_expansion * d
        dp = lam_d // mod.groups
        spec = [("expansion_weights", (d, lam_d), std),
                ("group_attention_weights", (lam_d, mod.groups), 1 / np.sqrt(lam_d)),
                ("cluster_weights", (lam_d, mod.groups * k), 1 / np.sqrt(lam_d))]
        if add_bn:
            spec.append(("cluster_bn", (mod.groups * k,), None))
        spec.append(("cluster_weights2", (k, dp), std))
        if add_bn:
            spec.append(("vlad_bn", (k * dp,), None))
        return spec
    spec = [("cluster_weights", (d, k), std)]
    if model_name == "NetFVModelLF":
        spec.append(("covar_weights", (d, k), std))
    spec.append(("cluster_bn", (k,), None) if add_bn else ("cluster_biases", (k,), std))
    if model_name in ("NetVLADModelLF", "NetFVModelLF"):
        spec.append(("cluster_weights2", (1, d, k), std))
    return spec


# the attention family and the RNNs (models/attention.py, models/frame_level.py)
ATTENTION_MODELS = FAST_ATTENTION_MODELS + ("AttentionPoolingModel",)
RNN_MODELS = {"LstmModel": "OptimizedLSTMCell", "GruModel": "GRUCell"}


def _mha_spec(prefix: str, d: int, heads: int):
    """A flax MultiHeadDotProductAttention of width ``d`` at ``prefix``."""
    hd = d // heads
    spec = []
    for name in ("query", "key", "value"):
        spec += [(f"{prefix}/{name}/kernel", (d, heads, hd), 1 / np.sqrt(d)),
                 (f"{prefix}/{name}/bias", (heads, hd), "zeros")]
    return spec + [(f"{prefix}/out/kernel", (heads, hd, d), 1 / np.sqrt(d)),
                   (f"{prefix}/out/bias", (d,), "zeros")]


def _attention_spec(model_name: str, mcfg: ModelConfig, input_size: int, add_bn: bool):
    """The attention family's parameters before the shared tail (ref:
    models/attention.py): ``(path under params, shape, init)`` with init a
    normal's std (flax's lecun-normal kernels: 1/√fan_in), ``"zeros"``,
    ``"ones"`` or ``"bn"`` (scale and bias in params, mean and var in
    batch_stats); then (descriptor width, hidden size, the cluster count
    that scales the hidden FC, relu6 after it)."""
    d, heads, ff = mcfg.attention_hidden_size, mcfg.attention_heads, mcfg.transformer_ff_size
    if d % heads:
        raise ValueError(f"--attention_hidden_size={d} is not a multiple of --attention_heads={heads}")
    spec = [("input_proj/kernel", (input_size, d), 1 / np.sqrt(input_size)),
            ("input_proj/bias", (d,), "zeros")]
    if model_name == "AttentionPoolingModel":
        q = mcfg.attention_cluster_size
        spec.append(("attn_pool/queries", (q, d), 1 / np.sqrt(d)))
        spec += _mha_spec("attn_pool/pool_mha", d, heads)
        return spec, (q * d, mcfg.attention_hidden_size, q, False)
    for i in range(mcfg.transformer_layers):
        layer = f"encoder/layer_{i}"
        spec += _mha_spec(f"{layer}/mha", d, heads)
        for ln in ("ln1", "ln2"):
            spec += [(f"{layer}/{ln}/scale", (d,), "ones"), (f"{layer}/{ln}/bias", (d,), "zeros")]
        spec += [(f"{layer}/ff1/kernel", (d, ff), 1 / np.sqrt(d)), (f"{layer}/ff1/bias", (ff,), "zeros"),
                 (f"{layer}/ff2/kernel", (ff, d), 1 / np.sqrt(ff)), (f"{layer}/ff2/bias", (d,), "zeros")]
    if model_name == "TransformerEncoderModel":
        return spec, (d, mcfg.attention_hidden_size, d, False)
    k = mcfg.netvlad_cluster_size
    spec.append(("vlad/cluster_weights", (d, k), 1 / np.sqrt(d)))
    spec.append(("vlad/cluster_bn", (k,), "bn") if add_bn else ("vlad/cluster_biases", (k,), 1 / np.sqrt(d)))
    spec.append(("vlad/cluster_weights2", (1, d, k), 1 / np.sqrt(d)))
    return spec, (d * k, mcfg.netvlad_hidden_size, k, mcfg.netvlad_relu)


def _rnn_spec(model_name: str, mcfg: ModelConfig, input_size: int):
    """The RNN cells' parameters (ref: frame_level.py#LstmModel, #GruModel;
    flax's OptimizedLSTMCell and GRUCell): ``(path, shape, init)`` with the
    input kernels lecun-normal (std 1/√fan_in), the recurrent kernels
    ``"orthogonal"``, the biases ``"zeros"``; then the hidden width."""
    if model_name == "LstmModel":
        layers, h = mcfg.lstm_layers, mcfg.lstm_cells
        gates, biased = ("i", "f", "g", "o"), ("hi", "hf", "hg", "ho")
    else:
        layers, h = mcfg.gru_layers, mcfg.gru_cells
        gates, biased = ("r", "z", "n"), ("ir", "iz", "in", "hn")
    spec = []
    for layer in range(layers):
        cell = f"{RNN_MODELS[model_name]}_{layer}"
        d = input_size if layer == 0 else h
        for g in gates:
            for side, (width, init) in (("i", (d, 1 / np.sqrt(d))), ("h", (h, "orthogonal"))):
                spec.append((f"{cell}/{side}{g}/kernel", (width, h), init))
                if side + g in biased:
                    spec.append((f"{cell}/{side}{g}/bias", (h,), "zeros"))
    return spec, h


def _check_spec_paths(tree_np: Tree, spec) -> None:
    for path, shape, init in spec:
        if init != "bn":
            _expect(tree_np, f"params/{path}", shape)
            continue
        for collection, leaves in (("params", ("scale", "bias")), ("batch_stats", ("mean", "var"))):
            for leaf in leaves:
                _expect(tree_np, f"{collection}/{path}/{leaf}", shape)


def _check_attention_layout(tree_np: Tree, mcfg: ModelConfig, model_name: str):
    """Check an attention-family tree against ``mcfg``; returns the hidden
    FC's (descriptor width, hidden size)."""
    input_size = _shape(tree_np, "params/input_proj/kernel")[0]
    spec, (width, h, _, _) = _attention_spec(model_name, mcfg, input_size, mcfg.netvlad_add_batch_norm)
    _check_spec_paths(tree_np, spec)
    extra = f"layer_{mcfg.transformer_layers}"
    if extra in tree_np["params"].get("encoder", {}):
        raise ValueError(f"params/encoder/{extra}: the variables have more than "
                         f"--transformer_layers={mcfg.transformer_layers} layers")
    return width, h


def _check_rnn_layout(tree_np: Tree, mcfg: ModelConfig, model_name: str) -> int:
    """Check an RNN tree against ``mcfg``; returns the hidden width."""
    cell = RNN_MODELS[model_name]
    first = "ii" if model_name == "LstmModel" else "ir"
    spec, h = _rnn_spec(model_name, mcfg, _shape(tree_np, f"params/{cell}_0/{first}/kernel")[0])
    _check_spec_paths(tree_np, spec)
    layers = mcfg.lstm_layers if model_name == "LstmModel" else mcfg.gru_layers
    if f"{cell}_{layers}" in tree_np["params"]:
        raise ValueError(f"params/{cell}_{layers}: the variables have more than {layers} layers")
    return h


# the models of one dense layer over their input
SINGLE_LAYER_MODELS = ("LogisticModel", "FrameLevelLogisticModel", "MoeModel")


def _single_layer_spec(model_name: str, mcfg: ModelConfig, input_size: int):
    """A single-layer model's parameters: ``(path under params, shape)``,
    its input-width kernel first."""
    v, m = mcfg.vocab_size, mcfg.moe_num_mixtures
    if model_name == "MoeModel":
        return [("gates_kernel", (input_size, (m + 1) * v)), ("experts_kernel", (input_size, m * v)),
                ("experts_bias", (m * v,))]
    return [("fc/kernel", (input_size, v)), ("fc/bias", (v,))]


def _dbof_spec(mcfg: ModelConfig, input_size: int):
    """DbofModel's parameters before its head: ``(name, shape, std)``, std
    None for a BatchNorm; then the hidden width."""
    c, h = mcfg.dbof_cluster_size, mcfg.dbof_hidden_size
    add_bn = mcfg.dbof_add_batch_norm
    std = 1 / np.sqrt(input_size)
    spec = [("input_bn", (input_size,), None)] if add_bn else []
    spec.append(("cluster_weights", (input_size, c), std))
    spec.append(("cluster_bn", (c,), None) if add_bn else ("cluster_biases", (c,), std))
    spec.append(("hidden1_weights", (c, h), 1 / np.sqrt(c)))
    spec.append(("hidden1_bn", (h,), None) if add_bn else ("hidden1_biases", (h,), 0.01))
    return spec, h


def _expect_spec(tree_np: Tree, spec, prefix: str = "") -> None:
    for name, shape, std in spec:
        if std is not None:
            _expect(tree_np, f"params/{prefix}{name}", shape)
            continue
        for collection, leaves in (("params", ("scale", "bias")), ("batch_stats", ("mean", "var"))):
            for leaf in leaves:
                _expect(tree_np, f"{collection}/{prefix}{name}/{leaf}", shape)


def convert_flax_variables(tree_np: Tree, mcfg: ModelConfig, model_name: str = "NetVLADModelLF") -> Tree:
    """Flax ``{params, batch_stats}`` tree of NumPy arrays → the same tree
    of float32 CPU tensors, after checking the layout of ``model_name`` (an
    LF model, one of ``ATTENTION_MODELS`` or ``RNN_MODELS``, ``DbofModel``
    or a single-layer model) against ``mcfg``: every pooling module's (or
    the input projection's and every encoder layer's or the attention
    pooling's, every RNN cell's, or DBoF's projections') parameters and BN
    statistics, the hidden FC and the MoE head."""
    params = tree_np["params"]
    width = h = None
    if model_name in SINGLE_LAYER_MODELS:
        first = _single_layer_spec(model_name, mcfg, 0)[0][0]
        for path, shape in _single_layer_spec(model_name, mcfg, _shape(tree_np, f"params/{first}")[0]):
            _expect(tree_np, f"params/{path}", shape)
    elif model_name == "DbofModel":
        spec, h = _dbof_spec(mcfg, _shape(tree_np, "params/cluster_weights")[0])
        _expect_spec(tree_np, spec)
    elif model_name in ATTENTION_MODELS:
        width, h = _check_attention_layout(tree_np, mcfg, model_name)
    elif model_name in RNN_MODELS:
        h = _check_rnn_layout(tree_np, mcfg, model_name)
    elif model_name in LF_MODULE_PREFIX:
        prefix = LF_MODULE_PREFIX[model_name]
        first = "expansion_weights" if model_name == "NeXtVLADModel" else "cluster_weights"
        if mcfg.netvlad_dimred > 0:
            input_size = _shape(tree_np, "params/dimred")[0]
            _expect(tree_np, "params/dimred", (input_size, mcfg.netvlad_dimred))
        else:
            input_size = sum(_shape(tree_np, f"params/{prefix}_{i}/{first}")[0]
                             for i in (0, 1) if i == 0 or f"{prefix}_{i}" in params)
        add_bn = mcfg.netvlad_add_batch_norm
        layout = lf_layout(model_name, mcfg, input_size)
        for mod in layout:
            _expect_spec(tree_np, _pool_spec(model_name, mod, mcfg, add_bn), f"{mod.name}/")
        _, h, _ = lf_hparams(model_name, mcfg)
        width = sum(mod.width for mod in layout)
    else:
        raise ValueError(f"convert_flax_variables reads the LF models {sorted(LF_MODULE_PREFIX)}, "
                         f"{list(ATTENTION_MODELS)}, {list(RNN_MODELS)}, DbofModel and "
                         f"{list(SINGLE_LAYER_MODELS)}, not {model_name!r}")
    if width is not None:
        _expect(tree_np, "params/hidden1_weights", (width, h))
    if h is not None:
        head = mcfg.video_level_classifier_model
        for path, shape in _single_layer_spec(head, mcfg, h):
            _expect(tree_np, f"params/{head}_0/{path}", shape)

    def convert(node):
        if isinstance(node, Mapping):
            return {key: convert(value) for key, value in node.items()}
        # bf16 params arrive as ml_dtypes arrays or their uint16 bits
        arr = as_f32(node)
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy())

    return {"params": convert(tree_np["params"]), "batch_stats": convert(tree_np["batch_stats"])}


def flax_to_state_dict(tree_np: Tree) -> Dict[str, torch.Tensor]:
    """Flax ``{params, batch_stats}`` tree → the port model's ``state_dict``:
    the path ``params/NetVLAD_0/cluster_bn/scale`` becomes the key
    ``NetVLAD_0.cluster_bn.scale`` and ``batch_stats/input_bn/mean`` the
    buffer ``input_bn.mean``; values become float32 tensors (bf16 leaves,
    as ml_dtypes arrays or uint16 bits, widened exactly; loading them into
    a bf16-parameter model rounds nothing)."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(tree_np.get(collection, {})).items():
            arr = as_f32(value)
            out[path.replace("/", ".")] = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return out


def state_dict_to_flax(model: torch.nn.Module, keep_bf16: bool = False, params=None) -> Tree:
    """The inverse of :func:`flax_to_state_dict`: a model's parameters under
    ``params`` and its buffers (BN statistics) under ``batch_stats``, as
    nested dicts of float32 NumPy arrays in the flax layout; with
    ``keep_bf16`` a bf16 tensor stays bf16, as its bits in a
    ``flax_msgpack.BFloat16Bits`` (what an export writes).  ``params``
    ((name, tensor) pairs) stands in for ``model.named_parameters()``, e.g.
    the whole tensors of a model split over a mesh."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if keep_bf16 and t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).view(BFloat16Bits)
        return t.float().numpy()

    def tree(named):
        return _unflatten({name.replace(".", "/"): leaf(t) for name, t in named})

    named = model.named_parameters() if params is None else params
    return {"params": tree(named), "batch_stats": tree(model.named_buffers())}


def load_flax_variables(model: torch.nn.Module, tree_np: Tree) -> torch.nn.Module:
    """Copy a flax-layout tree into ``model`` (every key must match, with its
    shape); returns the model."""
    model.load_state_dict(flax_to_state_dict(tree_np), strict=True)
    return model


def init_variables_np(mcfg: ModelConfig, fcfg: FeatureConfig, seed: int = 0,
                      model_name: str = "NetVLADModelLF") -> Tree:
    """The ``{params, batch_stats}`` tree of ``model_name`` (an LF model,
    one of ``ATTENTION_MODELS`` or ``RNN_MODELS``, ``DbofModel`` or a
    single-layer model) with flax's key set, shapes and initial
    scales, drawn from ``seed`` with NumPy: ``normal(1/√fan)`` for the
    pooling modules' and DBoF's projections and the LF models'
    ``--netvlad_dimred`` ``dimred`` [D, r] (NeXtVLAD's C₂ ``[K, D′]`` at
    ``1/√D``), xavier-uniform ``fc`` kernels with a zero bias, the
    attention family's kernels and the RNN cells' input kernels (flax's
    lecun-normal, untruncated), the attention-pooling queries at
    ``normal(1/√D)``, the RNN cells' recurrent kernels orthogonal (flax's
    ``orthogonal()``: Q of a normal matrix's QR, the signs of R's diagonal
    folded in), the gating weights, zero Dense and RNN biases and LayerNorm
    scale 1, ``normal(1/√K)`` for the hidden FC with K the rgb cluster count
    (the model width for TransformerEncoderModel, the query count for
    AttentionPoolingModel), ``normal(0.01)`` for the hidden bias,
    xavier-uniform MoE kernels with a zero bias (models/modules.py,
    models/frame_level.py, models/video_level.py, and the JAX package's
    models/attention.py), and BN scale 1, bias 0, mean 0, var 1.  The
    classifier head of a pooling model is ``--video_level_classifier_model``'s,
    ``MoeModel_0`` or ``LogisticModel_0``.  Within :func:`init_memo` a tree
    drawn before for the same draw is handed out again as a copy."""
    if _memo is not None:
        return _memo.tree(mcfg, fcfg, seed, model_name)
    return _draw_variables_np(mcfg, fcfg, seed, model_name)


def _draw_variables_np(mcfg, fcfg: FeatureConfig, seed: int, model_name: str) -> Tree:
    head = mcfg.video_level_classifier_model
    if head not in ("MoeModel", "LogisticModel") and model_name not in SINGLE_LAYER_MODELS:
        raise ValueError(f"init_variables_np builds a MoeModel or LogisticModel head, not {head!r}")
    rng = np.random.default_rng(seed)
    params: Tree = {}
    stats: Tree = {}

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def xavier(shape):
        lim = np.sqrt(6.0 / (shape[0] + shape[1]))
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    def bn(width):
        return (
            {"scale": np.ones(width, np.float32), "bias": np.zeros(width, np.float32)},
            {"mean": np.zeros(width, np.float32), "var": np.ones(width, np.float32)},
        )

    def moe(width):
        m, v = mcfg.moe_num_mixtures, mcfg.vocab_size
        return {"gates_kernel": xavier((width, (m + 1) * v)),
                "experts_kernel": xavier((width, m * v)),
                "experts_bias": np.zeros(m * v, np.float32)}

    def logistic(width):
        return {"fc": {"kernel": xavier((width, mcfg.vocab_size)),
                       "bias": np.zeros(mcfg.vocab_size, np.float32)}}

    def classifier(width):
        return {f"{head}_0": moe(width) if head == "MoeModel" else logistic(width)}

    if model_name == "MoeModel":
        return {"params": moe(fcfg.total_size), "batch_stats": {}}
    if model_name in SINGLE_LAYER_MODELS:
        return {"params": logistic(fcfg.total_size), "batch_stats": {}}
    if model_name == "DbofModel":
        spec, h = _dbof_spec(mcfg, fcfg.total_size)
        for name, shape, std in spec:
            if std is None:
                params[name], stats[name] = bn(shape[0])
            else:
                params[name] = normal(shape, std)
        params.update(classifier(h))
        return {"params": params, "batch_stats": stats}

    def orthogonal(shape):
        q, r = np.linalg.qr(rng.standard_normal(shape))
        return (q * np.sign(np.diag(r))).astype(np.float32)

    def fill(spec):
        for path, shape, init in spec:
            *parents, leaf = path.split("/")
            node = params
            for name in parents:
                node = node.setdefault(name, {})
            if init == "bn":
                snode = stats
                for name in parents:
                    snode = snode.setdefault(name, {})
                node[leaf], snode[leaf] = bn(shape[0])
            elif init == "zeros":
                node[leaf] = np.zeros(shape, np.float32)
            elif init == "ones":
                node[leaf] = np.ones(shape, np.float32)
            elif init == "orthogonal":
                node[leaf] = orthogonal(shape)
            else:
                node[leaf] = normal(shape, init)

    if model_name in RNN_MODELS:
        spec, h = _rnn_spec(model_name, mcfg, fcfg.total_size)
        fill(spec)
        params.update(classifier(h))
        return {"params": params, "batch_stats": stats}

    add_bn = mcfg.netvlad_add_batch_norm
    if model_name in ATTENTION_MODELS:
        spec, (width, h, k, relu) = _attention_spec(model_name, mcfg, fcfg.total_size, add_bn)
        fill(spec)
    else:
        if add_bn:
            params["input_bn"], stats["input_bn"] = bn(fcfg.total_size)
        if mcfg.netvlad_dimred > 0:
            params["dimred"] = normal((fcfg.total_size, mcfg.netvlad_dimred), 1 / np.sqrt(fcfg.total_size))
        layout = lf_layout(model_name, mcfg, fcfg.total_size)
        for mod in layout:
            p = {}
            for name, shape, std in _pool_spec(model_name, mod, mcfg, add_bn):
                if std is None:
                    p[name], stats.setdefault(mod.name, {})[name] = bn(shape[0])
                else:
                    p[name] = normal(shape, std)
            params[mod.name] = p
        k, h, relu = lf_hparams(model_name, mcfg)
        width = sum(mod.width for mod in layout)

    params["hidden1_weights"] = normal((width, h), 1 / np.sqrt(k))
    if add_bn and relu:
        params["hidden1_bn"], stats["hidden1_bn"] = bn(h)
    else:
        params["hidden1_biases"] = normal((h,), 0.01)
    if mcfg.gating:
        gating = {"gating_weights": normal((h, h), 1 / np.sqrt(h))}
        if add_bn:
            gating["gating_bn"], gating_stats = bn(h)
            stats["gating"] = {"gating_bn": gating_stats}
        else:
            gating["gating_biases"] = normal((h,), 1 / np.sqrt(h))
        params["gating"] = gating

    params.update(classifier(h))
    return {"params": params, "batch_stats": stats}


class _ReadLog:
    """A ModelConfig whose attribute reads are kept (name → value)."""

    def __init__(self, cfg: ModelConfig):
        self._cfg, self._reads = cfg, {}

    def __getattr__(self, name: str):
        value = getattr(self._cfg, name)
        self._reads[name] = value
        return value


def _copy_tree(tree: Tree) -> Tree:
    return {k: _copy_tree(v) if isinstance(v, Mapping) else np.array(v, copy=True) for k, v in tree.items()}


class _InitMemo:
    """The trees drawn while :func:`init_memo` is open, the most recently
    used last: (model, seed, FeatureConfig), the ModelConfig fields the draw
    read with their values, the tree, its bytes."""

    def __init__(self, max_bytes: int):
        self.max_bytes, self.entries = max_bytes, []

    def tree(self, mcfg: ModelConfig, fcfg: FeatureConfig, seed: int, model_name: str) -> Tree:
        key = (model_name, seed, fcfg)
        for i, (k, reads, tree, _) in enumerate(self.entries):
            if k == key and all(getattr(mcfg, name) == value for name, value in reads.items()):
                self.entries.append(self.entries.pop(i))
                return _copy_tree(tree)
        log = _ReadLog(mcfg)
        tree = _draw_variables_np(log, fcfg, seed, model_name)
        self.entries.append((key, log._reads, tree, sum(a.nbytes for a in _flatten(tree).values())))
        while len(self.entries) > 1 and sum(e[3] for e in self.entries) > self.max_bytes:
            self.entries.pop(0)
        return _copy_tree(tree)


_memo = None


@contextlib.contextmanager
def init_memo(max_bytes: int = 12 << 30):
    """Within the block :func:`init_variables_np` draws each distinct tree
    once and hands out copies of it.  The draw is a function of the model,
    the seed, the FeatureConfig and the ModelConfig fields it reads, so a
    later call whose ModelConfig holds the same values in those fields (say
    another ``compute_dtype``) takes a copy of the earlier tree, bit for
    bit the tree it would draw.  Past ``max_bytes`` of trees the least
    recently used go first.  For a process that builds the same models many
    times over, as ``chip_smoke.py`` does."""
    global _memo
    outer, _memo = _memo, _InitMemo(max_bytes)
    try:
        yield _memo
    finally:
        _memo = outer
