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
ignores them.

``with_stablehlo=True`` writes the native runner's artifact beside them
(``core/native_runtime.py``): ``native_manifest.txt`` (the JAX package's
lines and the port's) and ``weights.bin`` (the route's arrays: a fast
route's BN-folded prepare, or a video-level model's f32 head), for the
route of each model in ``native_runtime.ROUTES``; other models and configs
raise NotImplementedError (ROADMAP item 14c) and write nothing.
``load_exported_native`` serves such an export through the runner on the
card.

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
from learnablepoolingmethods_torch.core import native_runtime
from learnablepoolingmethods_torch.core.native_runtime import NativeExecutable
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
from learnablepoolingmethods_torch.ops.fast_dbof import prepare_fast_dbof_params
from learnablepoolingmethods_torch.ops.fast_infer import prepare_fast_params
from learnablepoolingmethods_torch.ops.fast_lf import prepare_fast_lf_params
from learnablepoolingmethods_torch.ops.netvlad_fused import MAX_CLUSTERS
from learnablepoolingmethods_torch.utils import flax_msgpack, prng
from learnablepoolingmethods_torch.utils.misc import resolve_device

log = logging.getLogger(__name__)

CONFIG_FILE = "model_config.json"
PARAMS_FILE = "params.msgpack"
STATS_FILE = "batch_stats.msgpack"
FRAMEWORK = "learnablepoolingmethods_torch"
# the packages whose exports this module reads: the JAX package's and its own
FRAMEWORKS = ("learnablepoolingmethods_tpu", FRAMEWORK)


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
    ``export_dir``; returns ``export_dir``.

    ``with_stablehlo``: also the native runner's artifact, for a batch of
    ``stablehlo_batch_size`` (the keyword keeps the JAX package's name; the
    port writes no StableHLO).  Raises NotImplementedError, before writing
    anything, for a model or config outside the runner's routes."""
    arrays = native_arrays(model_name, mcfg, fcfg, params, batch_stats) if with_stablehlo else None
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
    if arrays is not None:
        _write_native_artifact(export_dir, model_name, mcfg, fcfg, top_k, stablehlo_batch_size, arrays)
    return export_dir


def _video_level_arrays(model_name: str, mcfg: ModelConfig, variables) -> dict:
    """The f32 head of a video-level model as the runner reads it (its flax
    layout: the MoE's kernels are vocab-major, column m·V + v, as
    ``moe_combine`` reads them)."""
    p = convert_flax_variables(variables, mcfg, model_name)["params"]

    def f32(t):
        return torch.as_tensor(t).float().contiguous()

    if model_name == "LogisticModel":
        return {"fc": {"kernel": f32(p["fc"]["kernel"]), "bias": f32(p["fc"]["bias"])}}
    return {name: f32(p[name]) for name in native_runtime.MOE}


def _route_arrays(route: str, model_name: str, mcfg: ModelConfig, variables) -> dict:
    """The route's prepare on the CPU, or ValueError / KeyError with the
    reason it does not apply."""
    if route in native_runtime.VIDEO_ROUTES:
        if mcfg.compute_dtype != "float32":
            raise ValueError(f"compute_dtype {mcfg.compute_dtype}: the video-level routes run in f32")
        return _video_level_arrays(model_name, mcfg, variables)
    tree = convert_flax_variables(variables, mcfg, model_name)
    if route == "fast_netvlad_frontend":
        fp = prepare_fast_params(tree, mcfg, device="cpu")
        if max(fp["rgb"]["cluster"].shape[1], fp["aud"]["cluster"].shape[1]) > MAX_CLUSTERS:
            raise ValueError(f"more than {MAX_CLUSTERS} clusters")
        return fp
    if route == "fast_dbof":
        # the runner also draws one window a video, which the torch fast
        # path refuses (as the JAX package's does): the arrays are the same
        return prepare_fast_dbof_params(tree, dataclasses.replace(mcfg, sample_random_frames=True), device="cpu")
    fp = prepare_fast_lf_params(tree, mcfg, model_name, device="cpu")
    if route in ("fast_lf_netrvlad", "fast_lf_netfv") and max(e["cluster"].shape[1] for e in fp["mods"]) > MAX_CLUSTERS:
        raise ValueError(f"more than {MAX_CLUSTERS} clusters")
    return fp


def native_arrays(model_name: str, mcfg: ModelConfig, fcfg: FeatureConfig, params, batch_stats) -> dict:
    """The native runner's arrays of the model's route
    (``native_runtime.ROUTES``): the route's prepare on the CPU
    (``prepare_fast_params``, ``prepare_fast_dbof_params``,
    ``prepare_fast_lf_params``, or the f32 head of a video-level model), by
    ``native_runtime.route_arrays`` name.  Raises NotImplementedError naming
    ROADMAP item 14c where no route applies: another model, features of the
    other level, a presampled config, or a config that the route's prepare
    refuses."""
    route = native_runtime.MODEL_ROUTES.get(model_name)
    video = route in native_runtime.VIDEO_ROUTES
    why = None
    if route is None:
        why = f"model {model_name} has no native route"
    elif video == bool(fcfg.frame_features):
        why = "frame-level features for a video-level model" if video else "video-level features"
    elif mcfg.presampled and not video:
        why = "a presampled config"
    else:
        try:
            arrays = _route_arrays(route, model_name, mcfg, {"params": params, "batch_stats": batch_stats})
        except (ValueError, KeyError) as e:
            why = str(e)
    if why is not None:
        raise NotImplementedError(
            f"with_stablehlo: the native runner has routes for {sorted(native_runtime.MODEL_ROUTES)} at their "
            f"fast routes' configs, not this export ({why}); the other models and configs are ROADMAP item 14c")
    n_mods = len(arrays["mods"]) if route in native_runtime.LF_ROUTES else 2
    return {name: native_runtime.array_of(arrays, name) for name in native_runtime.route_arrays(route, n_mods)}


def _route_lines(route: str, mcfg: ModelConfig, arrays: dict) -> List[str]:
    """The port's manifest lines that ``route`` needs (ROUTE_LINES), after
    its route line."""
    lines = []
    if route not in native_runtime.VIDEO_ROUTES:
        # every batch draws from prng.key(0), as the server draws it
        lines += ["sampling_key {} {}".format(*prng.key_words(prng.key(0))), f"iterations {mcfg.iterations}"]
    if route != "video_logistic":
        lines.append(f"moe_num_mixtures {mcfg.moe_num_mixtures}")
    if route == "fast_dbof":
        lines += [f"sampling {'iid' if mcfg.sample_random_frames else 'window'}",
                  f"dbof_pooling_method {mcfg.dbof_pooling_method}"]
    if route == "fast_lf_nextvlad":
        mods = sorted({name.split("/")[1] for name in arrays if name.startswith("mods/")})
        groups = [arrays[f"mods/{i}/wg"].shape[1] for i in mods]
        d, width = arrays["mods/0/cluster"].shape
        lines += [f"nextvlad_groups {' '.join(map(str, groups))}", f"nextvlad_expansion {width // d}"]
    return lines


def _write_native_artifact(export_dir: str, model_name: str, mcfg: ModelConfig, fcfg: FeatureConfig,
                           top_k: int, batch: int, arrays: dict) -> None:
    """``weights.bin`` (the arrays dense, row-major, little-endian, in the
    route's order) and then ``native_manifest.txt``: the JAX package's
    lines (its ``#_write_native_manifest``: the model, batch, features,
    call inputs and outputs), then the route, the lines it needs
    (:func:`_route_lines`) and one named weight line per array."""
    if not 1 <= batch <= 65535:
        raise ValueError(f"stablehlo_batch_size {batch}: the runner takes 1 to 65535 videos a batch")
    route = native_runtime.MODEL_ROUTES[model_name]
    k = min(top_k, mcfg.vocab_size)
    rows = []
    with open(os.path.join(export_dir, native_runtime.WEIGHTS_FILE), "wb") as f:
        for name, t in arrays.items():
            t = t.contiguous()
            tag = native_runtime.TAGS[t.dtype]
            f.write((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
            rows.append(f"weight {name} {tag} {t.dim()} {' '.join(map(str, t.shape))}".rstrip())
    if fcfg.frame_features:
        call_inputs = [f"call_input u8 3 {batch} {fcfg.max_frames} {fcfg.total_size}", f"call_input s32 1 {batch}"]
    else:
        call_inputs = [f"call_input f32 2 {batch} {fcfg.total_size}"]
    lines = [
        "lpm_native_manifest 1",
        f"model {model_name}",
        f"batch_size {batch}",
        f"top_k {top_k}",
        f"frame_features {int(fcfg.frame_features)}",
        f"max_frames {fcfg.max_frames}",
        f"n_features {len(fcfg.feature_names)}",
        *(f"feature {name} {size}" for name, size in zip(fcfg.feature_names, fcfg.feature_sizes)),
        f"n_call_inputs {len(call_inputs)}",
        *call_inputs,
        "n_outputs 2",
        f"output f32 2 {batch} {k}",
        f"output s32 2 {batch} {k}",
        f"route {route}",
        *_route_lines(route, mcfg, arrays),
        f"n_weights {len(rows)}",
        *rows,
    ]
    with open(os.path.join(export_dir, native_runtime.MANIFEST_FILE), "w") as f:
        f.write("\n".join(lines) + "\n")


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


def load_exported_native(export_dir: str, device="cuda"):
    """Serve an export through the native runner on the card
    (``core/native_runtime.py``): no Python or torch in the execution path.

    → (mcfg, fcfg, batch_size, serve), as the JAX package's: ``serve`` has
    ``load_exported_model``'s record contract at a FIXED batch size, the
    artifact's (callers pad to it); ``serve.executable`` is the runner.
    Raises ValueError on the CPU and for a JAX export."""
    exe = NativeExecutable.from_export_dir(export_dir, device=device)
    with open(os.path.join(export_dir, CONFIG_FILE)) as f:
        mcfg, fcfg = _configs_from_meta(json.load(f))

    def serve(serialized_records: List[bytes]):
        feats, nfs = parse_serialized_records(fcfg, serialized_records)
        values, indices = exe.run(feats, nfs)
        return indices, values

    serve.executable = exe
    return mcfg, fcfg, exe.batch_size, serve
