"""Weight bridge between the JAX package's flax variables and the port.

The flax ``{params, batch_stats}`` tree of a ``NetVLADModelLF`` crosses
over as nested dicts of NumPy arrays, so the port needs neither JAX nor
orbax.  On the JAX side:

    tree = jax.tree.map(np.asarray, CheckpointManager(d).restore(step))
    save_variables_npz({"params": tree["params"],
                        "batch_stats": tree["batch_stats"]}, train_dir)

and the port reads it back with :func:`load_variables_npz` and
:func:`convert_flax_variables` (the fast path) or :func:`load_flax_variables`
(the ``nn.Module`` model).  :func:`state_dict_to_flax` goes the other way,
so the train CLI writes a ``variables.npz`` that both CLIs of either package
layout read.  Keys keep the flax layout: ``[D, K]``
cluster weights, ``[1, D, K]`` C₂, the d-major ``[D·K + D_a·K_a, H]``
hidden FC and the vocab-major MoE kernels (column m·V + v).

:func:`init_variables_np` makes a tree of the same keys, shapes and
initial scales as ``model.init`` from a seed, for machines without JAX.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig

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


def convert_flax_variables(tree_np: Tree, mcfg: ModelConfig) -> Tree:
    """Flax ``{params, batch_stats}`` tree of NumPy arrays → the same tree
    of float32 CPU tensors, after checking the NetVLADModelLF layout against
    ``mcfg`` (cluster sizes, hidden width, MoE width)."""
    params = tree_np["params"]
    k, h = mcfg.netvlad_cluster_size, mcfg.netvlad_hidden_size
    d_rgb = _shape(tree_np, "params/NetVLAD_0/cluster_weights")[0]
    _expect(tree_np, "params/NetVLAD_0/cluster_weights", (d_rgb, k))
    dk = d_rgb * k
    if "NetVLAD_1" in params:
        d_aud = _shape(tree_np, "params/NetVLAD_1/cluster_weights")[0]
        _expect(tree_np, "params/NetVLAD_1/cluster_weights", (d_aud, max(k // 2, 1)))
        dk += d_aud * max(k // 2, 1)
    _expect(tree_np, "params/hidden1_weights", (dk, h))
    if "MoeModel_0" in params:
        m, v = mcfg.moe_num_mixtures, mcfg.vocab_size
        _expect(tree_np, "params/MoeModel_0/gates_kernel", (h, (m + 1) * v))
        _expect(tree_np, "params/MoeModel_0/experts_kernel", (h, m * v))

    def convert(node):
        if isinstance(node, Mapping):
            return {key: convert(value) for key, value in node.items()}
        # bf16 params arrive as ml_dtypes arrays, which torch cannot wrap
        arr = np.ascontiguousarray(np.asarray(node).astype(np.float32, copy=False))
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy())

    return {"params": convert(tree_np["params"]), "batch_stats": convert(tree_np["batch_stats"])}


def flax_to_state_dict(tree_np: Tree) -> Dict[str, torch.Tensor]:
    """Flax ``{params, batch_stats}`` tree → the port model's ``state_dict``:
    the path ``params/NetVLAD_0/cluster_bn/scale`` becomes the key
    ``NetVLAD_0.cluster_bn.scale`` and ``batch_stats/input_bn/mean`` the
    buffer ``input_bn.mean``; values become float32 tensors."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(tree_np.get(collection, {})).items():
            arr = np.ascontiguousarray(np.asarray(value).astype(np.float32, copy=False))
            out[path.replace("/", ".")] = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return out


def state_dict_to_flax(model: torch.nn.Module) -> Tree:
    """The inverse of :func:`flax_to_state_dict`: a model's parameters under
    ``params`` and its buffers (BN statistics) under ``batch_stats``, as
    nested dicts of float32 NumPy arrays in the flax layout."""

    def tree(named):
        return _unflatten({
            name.replace(".", "/"): t.detach().float().cpu().numpy() for name, t in named
        })

    return {"params": tree(model.named_parameters()), "batch_stats": tree(model.named_buffers())}


def load_flax_variables(model: torch.nn.Module, tree_np: Tree) -> torch.nn.Module:
    """Copy a flax-layout tree into ``model`` (every key must match, with its
    shape); returns the model."""
    model.load_state_dict(flax_to_state_dict(tree_np), strict=True)
    return model


def init_variables_np(mcfg: ModelConfig, fcfg: FeatureConfig, seed: int = 0) -> Tree:
    """A NetVLADModelLF ``{params, batch_stats}`` tree with flax's key set,
    shapes and initial scales, drawn from ``seed`` with NumPy:
    ``normal(1/√fan)`` for cluster, hidden and gating weights
    (models/modules.py, models/frame_level.py), ``normal(0.01)`` for the
    hidden bias, xavier-uniform MoE kernels with a zero bias
    (models/video_level.py), and BN scale 1, bias 0, mean 0, var 1."""
    if mcfg.video_level_classifier_model != "MoeModel":
        raise ValueError("init_variables_np builds the MoeModel head only")
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

    feature_size = fcfg.total_size
    add_bn = mcfg.netvlad_add_batch_norm
    if add_bn:
        params["input_bn"], stats["input_bn"] = bn(feature_size)
    if mcfg.netvlad_dimred > 0:
        params["dimred"] = normal((feature_size, mcfg.netvlad_dimred), 1 / np.sqrt(feature_size))
        feature_size = mcfg.netvlad_dimred

    k = mcfg.netvlad_cluster_size
    if feature_size > 128:
        rgb_dim = min(1024, feature_size)
        modules = [(rgb_dim, k)]
        if feature_size > rgb_dim:
            modules.append((feature_size - rgb_dim, max(k // 2, 1)))
    else:
        modules = [(feature_size, k)]
    pooled = 0
    for i, (d, kk) in enumerate(modules):
        name = f"NetVLAD_{i}"
        p = {"cluster_weights": normal((d, kk), 1 / np.sqrt(d))}
        if add_bn:
            p["cluster_bn"], bn_stats = bn(kk)
            stats[name] = {"cluster_bn": bn_stats}
        else:
            p["cluster_biases"] = normal((kk,), 1 / np.sqrt(d))
        p["cluster_weights2"] = normal((1, d, kk), 1 / np.sqrt(d))
        params[name] = p
        pooled += d * kk

    h = mcfg.netvlad_hidden_size
    params["hidden1_weights"] = normal((pooled, h), 1 / np.sqrt(k))
    if add_bn and mcfg.netvlad_relu:
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

    m, v = mcfg.moe_num_mixtures, mcfg.vocab_size
    params["MoeModel_0"] = {
        "gates_kernel": xavier((h, (m + 1) * v)),
        "experts_kernel": xavier((h, m * v)),
        "experts_bias": np.zeros(m * v, np.float32),
    }
    return {"params": params, "batch_stats": stats}
