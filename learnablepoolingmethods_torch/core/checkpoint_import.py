"""TF-checkpoint → the port's weights (ref: core/checkpoint_import.py).

Loads a reference-trained TF1 or TF2 checkpoint (``tf.train.Saver`` inside
the reference's Supervisor, or ``tf.train.Checkpoint``) with the port's own
bundle reader (``utils/tf_bundle.py``: no tensorflow), and maps its
variables onto the flax ``{params, batch_stats}`` tree of a model, which the
eval and inference CLIs read (``--reference_checkpoint``).  The mapping is
the JAX package's, generated from the target tree: every leaf knows its
reference-name candidates and its layout transform.

- slim FC: ``<scope>/weights`` → ``kernel``, ``<scope>/biases`` → ``bias``;
- slim batch_norm: ``gamma`` → ``scale`` (ones when absent: slim's default
  is ``scale=False``), ``beta`` → ``bias``, ``moving_mean`` →
  batch_stats ``mean``, ``moving_variance`` → ``var``;
- the MoE head: the reference's mixture-major kernels ([D, V·(M+1)]) become
  the vocab-major [D, (M+1)·V] of models/video_level.py;
- the per-modality pooling modules: ``NetVLAD_0`` ↔ ``video_VLAD``,
  ``NetVLAD_1`` ↔ ``audio_VLAD`` (and their NetRVLAD, NetFV and SoftDBoW
  twins);
- the LSTM: TF's ``BasicLSTMCell`` fuses the four gates into one
  ``[D+H, 4H]`` kernel and ``[4H]`` bias, columns in (i, j=g, f, o) order,
  under ``rnn/multi_rnn_cell/cell_<l>/basic_lstm_cell``; flax's
  ``OptimizedLSTMCell_<l>`` keeps a kernel per gate and side (``ii`` … on
  the D input rows, ``hi`` … on the H hidden rows, the bias on the h side),
  and TF's ``forget_bias`` of 1.0, which TF adds at run time, is folded
  into ``hf/bias``;
- names lose TF's ``tower/``, ``tower_0/`` and ``model/`` prefixes and TF2's
  ``/.ATTRIBUTES/VARIABLE_VALUE`` suffix.

The target tree is ``core/weights.py#init_variables_np``'s, which
has flax's key set and shapes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from learnablepoolingmethods_torch.core.weights import init_variables_np, tree_paths, unflatten_tree
from learnablepoolingmethods_torch.utils.tf_bundle import BundleReader

# Module-scope candidates: the flax submodule name → reference
# variable_scope candidates (Willow/LOUPE lineage), first match wins.
_MODULE_SCOPES: Dict[str, List[str]] = {
    "NetVLAD_0": ["video_VLAD", "video_NetVLAD"],
    "NetVLAD_1": ["audio_VLAD", "audio_NetVLAD"],
    "NetRVLAD_0": ["video_RVLAD", "video_VLAD", "video_NetRVLAD"],
    "NetRVLAD_1": ["audio_RVLAD", "audio_VLAD", "audio_NetRVLAD"],
    "NetFV_0": ["video_FV", "video_NetFV"],
    "NetFV_1": ["audio_FV", "audio_NetFV"],
    "SoftDBoW_0": ["video_DBOW", "video_DBoW"],
    "SoftDBoW_1": ["audio_DBOW", "audio_DBoW"],
    # the video-level head builds in the same scope in the reference
    "MoeModel_0": [""],
    "LogisticModel_0": [""],
    # context gating's weights are tf.get_variable calls in the model scope
    "gating": [""],
}

# leaf name → reference suffix candidates (identity transform)
_LEAF_NAMES: Dict[str, List[str]] = {
    "cluster_weights": ["cluster_weights"],
    "cluster_weights2": ["cluster_weights2"],
    "covar_weights": ["covar_weights"],
    "cluster_biases": ["cluster_biases"],
    "hidden1_weights": ["hidden1_weights"],
    "hidden1_biases": ["hidden1_biases"],
    "gating_weights": ["gating_weights", "gating_weights_2"],
    "gating_biases": ["gating_biases"],
}

_BN_PARAM = {"scale": "gamma", "bias": "beta"}
_BN_STATS = {"mean": "moving_mean", "var": "moving_variance"}
_LSTM_GATE_COL_KEYS = ("ii", "if", "ig", "io", "hi", "hf", "hg", "ho")
# the column block of each flax gate in TF's fused kernel, and the constant
# TF adds to the forget gate's pre-activation
_LSTM_GATE_COL = {"i": 0, "g": 1, "f": 2, "o": 3}
_LSTM_FORGET_BIAS = 1.0


def _lstm_scope_candidates(layer: int) -> List[str]:
    """The reference's variable scopes of stacked-cell layer ``layer``
    (MultiRNNCell under dynamic_rnn's ``rnn`` scope)."""
    cell = f"multi_rnn_cell/cell_{layer}/basic_lstm_cell"
    return [f"RNN/rnn/{cell}", f"rnn/{cell}", f"RNN/{cell}", cell]


def _lstm_transform(gate: str, leaf: str) -> Callable[[np.ndarray], np.ndarray]:
    """TF's fused kernel or bias → flax's ``gate`` (``ii`` … ``ho``) slice."""
    side, g = gate[0], gate[1]
    col = _LSTM_GATE_COL[g]

    def fn(ref: np.ndarray) -> np.ndarray:
        h = ref.shape[-1] // 4
        block = ref[..., col * h:(col + 1) * h]
        if leaf == "bias":
            return np.array(block) + (_LSTM_FORGET_BIAS if g == "f" else 0.0)
        d = ref.shape[0] - h
        return np.array(block[:d] if side == "i" else block[d:])

    return fn


def _moe_from_ref(ref: np.ndarray, vocab: int) -> np.ndarray:
    """[D, V·m] mixture-major → [D, m·V] vocab-major (gates and experts)."""
    d, cols = ref.shape
    m1 = cols // vocab
    return ref.reshape(d, vocab, m1).transpose(0, 2, 1).reshape(d, m1 * vocab)


def _moe_bias_from_ref(ref: np.ndarray, vocab: int) -> np.ndarray:
    """[V·M] mixture-major → [M·V] vocab-major."""
    m = ref.shape[0] // vocab
    return ref.reshape(vocab, m).transpose(1, 0).reshape(m * vocab)


def _scope_prefixes(scope_keys) -> List[str]:
    prefixes: List[str] = [""]
    for sk in scope_keys:
        cands = _MODULE_SCOPES.get(sk, [sk])
        prefixes = [(p + c + "/") if c else p for p in prefixes for c in cands]
    return prefixes


def _candidates_for_leaf(keys: List[str], is_stats: bool, vocab: int
                         ) -> Tuple[List[str], Callable[[np.ndarray], np.ndarray], bool]:
    """→ (reference-name candidates, transform(ref → ours), optional?).
    ``optional`` marks what the reference may lack (BN gamma under slim's
    ``scale=False``)."""
    *scope_keys, leaf = keys
    ident = lambda a: a  # noqa: E731

    if len(scope_keys) >= 2 and scope_keys[-2].startswith("OptimizedLSTMCell_") \
            and scope_keys[-1] in _LSTM_GATE_COL_KEYS and leaf in ("kernel", "bias"):
        layer = int(scope_keys[-2].rsplit("_", 1)[1])
        names = [f"{scope}/{leaf}" for scope in _lstm_scope_candidates(layer)]
        return names, _lstm_transform(scope_keys[-1], leaf), False

    # batch-norm leaves live under a "*_bn" scope; a plain Dense "bias" must not
    is_bn = (leaf in _BN_PARAM or leaf in _BN_STATS) and bool(scope_keys) and scope_keys[-1].endswith("_bn")
    prefixes = _scope_prefixes(scope_keys[:-1] if is_bn else scope_keys)

    if is_bn:
        ref_leaf = (_BN_STATS if is_stats else _BN_PARAM)[leaf]
        names = [p + scope_keys[-1] + "/" + ref_leaf for p in prefixes]
        return names, ident, leaf == "scale"
    if leaf in ("gates_kernel", "experts_kernel"):
        names = [p + ("gates" if leaf == "gates_kernel" else "experts") + "/weights" for p in prefixes]
        return names, (lambda a: _moe_from_ref(a, vocab)), False
    if leaf == "experts_bias":
        return [p + "experts/biases" for p in prefixes], (lambda a: _moe_bias_from_ref(a, vocab)), False
    if scope_keys and scope_keys[-1] == "fc":  # slim fully_connected
        ref_leaf = "weights" if leaf == "kernel" else "biases"
        return [p + "fully_connected/" + ref_leaf for p in _scope_prefixes(scope_keys[:-1])], ident, False
    if leaf in _LEAF_NAMES:
        return [p + cand for p in prefixes for cand in _LEAF_NAMES[leaf]], ident, False
    return ["/".join(keys)], ident, False


# TF2's serialized object graph: a string tensor beside the variables
_OBJECT_GRAPH = "_CHECKPOINTABLE_OBJECT_GRAPH"


def load_tf_checkpoint_vars(ckpt_path: str) -> Dict[str, np.ndarray]:
    """Every variable of a TF checkpoint (a V2 bundle: TF1 Saver or TF2)."""
    reader = BundleReader(ckpt_path)
    return {name: reader.get_tensor(name) for name in reader.keys() if name != _OBJECT_GRAPH}


def _normalize_names(names) -> Dict[str, str]:
    """name → the checkpoint's own name, with TF graph noise stripped: the
    ``tower/`` scopes (the reference builds under variable_scope("tower")),
    ``model/`` and TF2's object suffix; the raw names stay too."""
    out: Dict[str, str] = {}
    for name in names:
        n = name
        if n.endswith("/.ATTRIBUTES/VARIABLE_VALUE"):
            n = n[: -len("/.ATTRIBUTES/VARIABLE_VALUE")]
        for prefix in ("tower/", "tower_0/", "model/"):
            if n.startswith(prefix):
                n = n[len(prefix):]
        out[n] = name
        out.setdefault(name, name)
    return out


def import_reference_checkpoint(checkpoint, model_name: str, mcfg, fcfg, strict: bool = True
                                ) -> Tuple[dict, dict]:
    """Map a reference TF checkpoint (a path, or a {name: array} dict) onto
    ``model_name``'s (params, batch_stats) for ``mcfg`` and ``fcfg``; only
    the variables that map are read.  With ``strict`` a missing non-optional
    variable raises; otherwise the leaf keeps its initial value."""
    if isinstance(checkpoint, str):
        reader = BundleReader(checkpoint)
        names, read = [n for n in reader.keys() if n != _OBJECT_GRAPH], reader.get_tensor
    else:
        names, read = list(checkpoint), checkpoint.__getitem__
    ref_names = _normalize_names(names)
    init = init_variables_np(mcfg, fcfg, seed=0, model_name=model_name)
    used: set = set()
    missing: List[str] = []

    def fill(tree, is_stats: bool):
        out = {}
        for path, leaf in tree_paths(tree).items():
            keys = path.split("/")
            names, transform, optional = _candidates_for_leaf(keys, is_stats, mcfg.vocab_size)
            hit = next((n for n in names if n in ref_names), None)
            if hit is None:
                if not optional:
                    missing.append(f"{'stats' if is_stats else 'params'} {path} (tried {names})")
                out[path] = leaf
                continue
            used.add(hit)
            val = transform(np.asarray(read(ref_names[hit]), np.float32))
            if tuple(val.shape) != tuple(np.shape(leaf)):
                raise ValueError(f"shape mismatch for {path} ← {hit}: checkpoint {val.shape} vs model "
                                 f"{tuple(np.shape(leaf))}")
            out[path] = val.astype(np.asarray(leaf).dtype)
        return unflatten_tree(out)

    params = fill(init["params"], is_stats=False)
    stats = fill(init["batch_stats"], is_stats=True)
    if strict and missing:
        raise KeyError("reference checkpoint is missing variables for:\n  " + "\n  ".join(missing)
                       + "\navailable (unused) checkpoint variables:\n  "
                       + "\n  ".join(sorted(set(ref_names) - used)[:40]))
    return params, stats


def tree_from_reference_checkpoint(checkpoint, model_name: str, mcfg, fcfg, strict: bool = True) -> dict:
    """The CLIs' bridge: the ``{"params", "batch_stats"}`` tree of a
    reference checkpoint."""
    params, stats = import_reference_checkpoint(checkpoint, model_name, mcfg, fcfg, strict=strict)
    return {"params": params, "batch_stats": stats}


def export_reference_layout(params, batch_stats, vocab: int) -> Dict[str, np.ndarray]:
    """The inverse mapping: the flax trees → {reference name: array}, to
    write a TF checkpoint with the reference's names (the first candidate of
    each leaf); an LSTM's per-gate leaves are fused back into TF's kernel
    and bias, the forget bias taken out."""
    out: Dict[str, np.ndarray] = {}
    lstm_cells: Dict[int, Dict[str, np.ndarray]] = {}
    for tree, is_stats in ((params, False), (batch_stats, True)):
        for path, leaf in tree_paths(tree).items():
            keys = path.split("/")
            if len(keys) >= 3 and keys[-3].startswith("OptimizedLSTMCell_") and keys[-2] in _LSTM_GATE_COL_KEYS:
                layer = int(keys[-3].rsplit("_", 1)[1])
                lstm_cells.setdefault(layer, {})[f"{keys[-2]}/{keys[-1]}"] = np.asarray(leaf, np.float32)
                continue
            names, _, _ = _candidates_for_leaf(keys, is_stats, vocab)
            val = np.asarray(leaf, np.float32)
            if keys[-1] in ("gates_kernel", "experts_kernel"):
                d, cols = val.shape
                val = val.reshape(d, cols // vocab, vocab).transpose(0, 2, 1).reshape(d, cols)
            elif keys[-1] == "experts_bias":
                val = val.reshape(val.shape[0] // vocab, vocab).transpose(1, 0).reshape(-1)
            out[names[0]] = val
    for layer, leaves in lstm_cells.items():
        gates = sorted(_LSTM_GATE_COL, key=_LSTM_GATE_COL.get)   # i, g, f, o
        scope = _lstm_scope_candidates(layer)[0]
        out[f"{scope}/kernel"] = np.concatenate(
            [np.concatenate([leaves[f"i{g}/kernel"], leaves[f"h{g}/kernel"]], axis=0) for g in gates], axis=1)
        out[f"{scope}/bias"] = np.concatenate(
            [leaves[f"h{g}/bias"] - (_LSTM_FORGET_BIAS if g == "f" else 0.0) for g in gates])
    return out
