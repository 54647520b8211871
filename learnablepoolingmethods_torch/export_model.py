"""Model export and its loader (ref: learnablepoolingmethods_tpu/export_model.py).

The artifact is the JAX package's, so either package reads what the other
wrote:

    export_dir/
      model_config.json     # model class name, top_k, the full ModelConfig
                            # and FeatureConfig, "framework"
      params.msgpack        # flax-serialized parameters
      batch_stats.msgpack   # BN moving statistics

written and read by ``utils/flax_msgpack.py`` (flax's format, no ``flax`` or
``msgpack`` needed).  A JAX export may also hold StableHLO pieces; the port
ignores them, and ``with_stablehlo=True`` raises (ROADMAP item 14b).

``load_exported_model`` rebuilds the model and a ``serve(serialized_records)``
callable: raw ``tf.SequenceExample`` / ``tf.Example`` bytes in,
``(class_indexes [B, k], predictions [B, k])`` out, through the fast path of
``ops/fast_dispatch.py`` (``prefer_fast``; the CUDA kernels on the card) or
the model-forward route.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core.step import make_predict_step
from learnablepoolingmethods_torch.core.weights import (
    convert_flax_variables,
    load_flax_variables,
    tree_paths,
)
from learnablepoolingmethods_torch.data import tfrecord_io
from learnablepoolingmethods_torch.data.readers import fill_frame_record
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.ops.fast_dispatch import get_fast_path, int8_capable_models
from learnablepoolingmethods_torch.utils import flax_msgpack, prng
from learnablepoolingmethods_torch.utils.misc import resolve_device

log = logging.getLogger(__name__)

CONFIG_FILE = "model_config.json"
PARAMS_FILE = "params.msgpack"
STATS_FILE = "batch_stats.msgpack"
FRAMEWORK = "learnablepoolingmethods_torch"
# the packages whose exports this module reads: the JAX package's and its own
FRAMEWORKS = ("learnablepoolingmethods_tpu", FRAMEWORK)
NATIVE_NOT_PORTED = "the StableHLO export and the native runners are not ported yet: ROADMAP item 14b"


def export_model(
    export_dir: str,
    model_name: str,
    mcfg: ModelConfig,
    fcfg: FeatureConfig,
    params,
    batch_stats,
    top_k: int = 20,
    with_stablehlo: bool = False,
    stablehlo_batch_size: int = 1,
) -> str:
    """Write the artifact of ``params`` and ``batch_stats`` (nested dicts of
    NumPy arrays in the flax layout, e.g. from
    ``core/weights.py#state_dict_to_flax(model, keep_bf16=True)``) into
    ``export_dir``; returns ``export_dir``."""
    if with_stablehlo:
        raise NotImplementedError(f"with_stablehlo: {NATIVE_NOT_PORTED}")
    os.makedirs(export_dir, exist_ok=True)
    meta = {
        "model": model_name,
        "top_k": top_k,
        "model_config": dataclasses.asdict(mcfg),
        "feature_config": dataclasses.asdict(fcfg),
        "framework": FRAMEWORK,
    }
    with open(os.path.join(export_dir, CONFIG_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    for name, tree in ((PARAMS_FILE, params), (STATS_FILE, batch_stats)):
        with open(os.path.join(export_dir, name), "wb") as f:
            flax_msgpack.dump(tree, f)
    return export_dir


def _configs_from_meta(meta: dict) -> Tuple[ModelConfig, FeatureConfig]:
    mc = dict(meta["model_config"])
    fc = dict(meta["feature_config"])
    fc["feature_names"] = tuple(fc["feature_names"])
    fc["feature_sizes"] = tuple(fc["feature_sizes"])
    return ModelConfig(**mc), FeatureConfig(**fc)


def check_variables(model: torch.nn.Module, tree: dict) -> None:
    """Raise ValueError unless ``tree`` ({params, batch_stats}) holds exactly
    ``model``'s parameters and buffers, each of its shape: a missing leaf,
    as flax's ``from_bytes`` against the model's template refuses it, and
    also an extra leaf or another shape, which flax lets through."""
    want = {f"params/{n.replace('.', '/')}": tuple(t.shape) for n, t in model.named_parameters()}
    want.update({f"batch_stats/{n.replace('.', '/')}": tuple(t.shape) for n, t in model.named_buffers()})
    got = {path: tuple(np.shape(leaf)) for path, leaf in tree_paths(tree).items()}
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"the export does not fit the model: missing {missing}, extra {extra}")
    wrong = {path: (got[path], shape) for path, shape in want.items() if got[path] != shape}
    if wrong:
        raise ValueError(f"the export does not fit the model: (shape, expected) {wrong}")


def _try_fast_predict(model_name: str, mcfg: ModelConfig, variables: dict, top_k: int,
                      int8_hidden: bool = False, device="cuda") -> Optional[Callable]:
    """The BN-folded fast forward of ``model_name`` when the model and
    config have one: ``fn(features, num_frames) → (values, indices)`` on
    ``device``, drawing its frames from ``prng.key(0)`` for every batch as
    the JAX package's ``serve`` passes ``jax.random.key(0)``; else None (a
    presampled config, a model without a fast path, or a config or tree
    that its ``prepare`` or ``build`` refuses with ValueError or KeyError).
    Only preparing is guarded: a kernel's build or launch error reaches
    the caller at the first call."""
    if mcfg.presampled:
        # a presampled model consumes its input whole; the fast forwards
        # would subsample it again, so the model-forward route serves
        return None
    try:
        path = get_fast_path(model_name)
        fp = path.prepare(convert_flax_variables(variables, mcfg, model_name), mcfg,
                          int8_hidden=int8_hidden, device=device)
        fn = path.build(mcfg, top_k=top_k)
    except (ValueError, KeyError) as e:
        log.info("no fast path for this export (%s)", e)
        return None
    return lambda features, num_frames: fn(fp, features, num_frames, prng.key(0))


def load_exported_model(export_dir: str, prefer_fast: bool = False, int8_hidden: bool = False,
                        device="cuda"):
    """Rebuild ``(model, params, batch_stats, mcfg, fcfg, serve)`` from an
    export of either package, ``params`` and ``batch_stats`` as nested dicts
    of NumPy arrays (bf16 leaves as ``flax_msgpack.BFloat16Bits``).

    ``prefer_fast``: serve a frame-level export through its fast path
    (``ops/fast_dispatch.py``) when the model and config have one, else
    through the model (``model`` is None on the fast route).
    ``int8_hidden``: the weight-only int8 hidden FC of that fast path; an
    explicit request, so it raises ValueError where it cannot be honoured.
    ``serve(records)`` parses raw record bytes and returns the top-k class
    indexes and scores as NumPy arrays."""
    with open(os.path.join(export_dir, CONFIG_FILE)) as f:
        meta = json.load(f)
    if meta.get("framework") not in FRAMEWORKS:
        raise ValueError(f"{export_dir}: framework {meta.get('framework')!r}, expected one of {FRAMEWORKS}")
    mcfg, fcfg = _configs_from_meta(meta)
    name, top_k = meta["model"], meta["top_k"]
    device = resolve_device(device)
    params = flax_msgpack.load(os.path.join(export_dir, PARAMS_FILE))
    batch_stats = flax_msgpack.load(os.path.join(export_dir, STATS_FILE))
    variables = {"params": params, "batch_stats": batch_stats}
    with torch.device("meta"):
        check_variables(create_model(name, mcfg, fcfg.total_size), variables)

    if int8_hidden and (not prefer_fast or name not in int8_capable_models() or not fcfg.frame_features):
        raise ValueError("int8_hidden requires the fast path (prefer_fast/--fast_serve) on a "
                         f"frame-level export of one of {int8_capable_models()}")
    fast = None
    if prefer_fast and fcfg.frame_features:
        fast = _try_fast_predict(name, mcfg, variables, top_k, int8_hidden=int8_hidden, device=device)
        if int8_hidden and fast is None:
            raise ValueError("int8_hidden requested but this export's config has no fast path "
                             "(non-default pooling config)")
    model = None
    if fast is None:
        model = create_model(name, mcfg, fcfg.total_size)
        load_flax_variables(model, variables)
        model = model.to(device).eval()
        # the model draws its own frames (from prng.key(0) without a key, as
        # the flax model does without a "sampling" RNG) unless its config is
        # presampled, and then pools every frame it is given, as flax's does:
        # the step must not sample for it
        predict = make_predict_step(model, dataclasses.replace(mcfg, presampled=False),
                                    fcfg.frame_features, top_k=top_k)
    log.info("serving %s from %s through the %s on %s", name, export_dir,
             "fast route" + (" with the int8 hidden FC" if int8_hidden else "") if fast else "model-forward route",
             device)

    def serve(serialized_records: List[bytes]):
        """Serving signature: raw record bytes → (class_indexes, predictions)."""
        feats, nfs = parse_serialized_records(fcfg, serialized_records)
        x = torch.from_numpy(feats).to(device)
        nf = torch.from_numpy(nfs).to(device) if nfs is not None else None
        with torch.no_grad():
            values, indices = fast(x, nf) if fast is not None else predict(x, nf)
        return indices.cpu().numpy(), values.float().cpu().numpy()

    return model, params, batch_stats, mcfg, fcfg, serve


def parse_serialized_records(fcfg: FeatureConfig, serialized_records):
    """Raw record bytes → ``(features, num_frames | None)``: frame-level
    ``(uint8 [B, max_frames, ΣD], int32 [B])``, each feature list cut or
    zero-padded to ``max_frames`` and ``num_frames`` the least frame count
    of the features, capped (a missing list reads as no frames:
    ``data/readers.py#fill_frame_record``, the reader's); or video-level
    ``(f32 [B, ΣD], None)`` (ref: export_model.py#parse_serialized_records
    there)."""
    if not fcfg.frame_features:
        feats = []
        for rec in serialized_records:
            fmap = tfrecord_io.parse_example(rec)
            feats.append(np.concatenate([np.asarray(fmap[name].float_list, np.float32)
                                         for name in fcfg.feature_names]))
        return np.stack(feats), None
    out = np.zeros((len(serialized_records), fcfg.max_frames, fcfg.total_size), np.uint8)
    nfs = np.zeros(len(serialized_records), np.int32)
    for i, rec in enumerate(serialized_records):
        _, nfs[i] = fill_frame_record(out[i], rec, fcfg.feature_names, fcfg.feature_sizes)
    return out, nfs
