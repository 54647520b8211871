"""Registry of the per-model fast inference paths (the surface of
``learnablepoolingmethods_tpu/ops/fast_dispatch.py``).

- ``prepare(variables, mcfg, int8_hidden=False, device="cuda")`` folds BNs
  and casts weights once → a flat dict of tensors on ``device``.  Raises
  ``ValueError`` on configs the fast path does not cover.
- ``build(mcfg, top_k=20, use_kernels=True, return_probs=False)`` →
  ``fn(fp, features, num_frames, key, presampled=False, row_offset=0)``.
- :func:`shard_fast_params` splits a ``prepare`` tree's dense product
  weights over a mesh's model group (JAX ``shard_params`` on the fast
  tree); the front-end kernels keep their weights whole.
- ``supports_int8``: whether ``prepare`` takes ``int8_hidden`` (the models
  of :func:`int8_capable_models`); the others raise with the JAX wording
  (:func:`reject_int8`).

Every fast path of the JAX package is ported: ``NetVLADModelLF``
(``ops/fast_infer.py``), ``DbofModel`` (``ops/fast_dbof.py``), the rest of
the LOUPE family (``ops/fast_lf.py``) and the transformer family
(``ops/fast_transformer.py``).  A model without a fast path in the JAX
package (``_NO_FAST_PATH``) raises ``ValueError`` as the JAX CLI does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from learnablepoolingmethods_torch.parallel.collectives import ColumnShard
from learnablepoolingmethods_torch.parallel.mesh import MIN_SHARD_SIZE, shard_rule


class FastPath(NamedTuple):
    prepare: Callable[..., Dict[str, Any]]
    build: Callable[..., Callable]
    supports_int8: bool


# the LF models whose fast path takes --int8_hidden (the JAX package's _LF_INT8)
_LF_INT8 = ("NetFVModelLF", "NetRVLADModelLF")


def int8_capable_models() -> Tuple[str, ...]:
    """The models whose fast path takes ``--int8_hidden``, the ones with the
    giant D·K hidden FC (the JAX package's ``int8_capable_models``).  Static,
    so that the CLIs can check a flag without importing a kernel module;
    tests/test_torch_int8_matmul.py holds it to every FastPath's
    ``supports_int8``."""
    return ("NetVLADModelLF", "AttentionNetVLADModel") + _LF_INT8


def reject_int8(model_name: str, int8_hidden: bool) -> None:
    """ValueError with the JAX package's wording for ``--int8_hidden`` on a
    model without the giant hidden FC."""
    if int8_hidden:
        raise ValueError(
            "int8_hidden is only supported on the models with the giant "
            f"D*K hidden FC ({int8_capable_models()}), not {model_name}"
        )


# models that the JAX package serves with the flax forward only
# (learnablepoolingmethods_tpu/ops/fast_dispatch.py#get_fast_path returns
# None): its CLI refuses --fast_infer for them with a ValueError, and so
# does the port's
_NO_FAST_PATH = ("AttentionPoolingModel", "LogisticModel", "MoeModel", "FrameLevelLogisticModel",
                 "LstmModel", "GruModel")


def _netvlad() -> FastPath:
    from learnablepoolingmethods_torch.ops.fast_infer import (
        build_fast_netvlad_inference,
        prepare_fast_params,
    )

    def prepare(variables, mcfg, int8_hidden=False, device="cuda"):
        return prepare_fast_params(variables, mcfg, int8_hidden=int8_hidden, device=device)

    def build(mcfg, top_k=20, use_kernels=True, return_probs=False):
        return build_fast_netvlad_inference(
            mcfg, top_k=top_k, use_kernels=use_kernels, return_probs=return_probs
        )

    return FastPath(prepare, build, supports_int8=True)


def _dbof() -> FastPath:
    from learnablepoolingmethods_torch.ops.fast_dbof import (
        build_fast_dbof_inference,
        prepare_fast_dbof_params,
    )
    def prepare(variables, mcfg, int8_hidden=False, device="cuda"):
        reject_int8("DbofModel", int8_hidden)
        return prepare_fast_dbof_params(variables, mcfg, device=device)

    def build(mcfg, top_k=20, use_kernels=True, return_probs=False):
        # no kernel to select: the JAX path has no Pallas kernel either
        return build_fast_dbof_inference(mcfg, top_k=top_k, return_probs=return_probs)

    return FastPath(prepare, build, supports_int8=False)


def _lf(model_name: str) -> FastPath:
    from learnablepoolingmethods_torch.ops.fast_lf import (
        build_fast_lf_inference,
        prepare_fast_lf_params,
    )

    def prepare(variables, mcfg, int8_hidden=False, device="cuda"):
        if model_name not in _LF_INT8:
            reject_int8(model_name, int8_hidden)
        return prepare_fast_lf_params(variables, mcfg, model_name, int8_hidden=int8_hidden,
                                      device=device)

    def build(mcfg, top_k=20, use_kernels=True, return_probs=False):
        return build_fast_lf_inference(mcfg, model_name, top_k=top_k, use_kernels=use_kernels,
                                       return_probs=return_probs)

    return FastPath(prepare, build, supports_int8=model_name in _LF_INT8)


def _attention(model_name: str) -> FastPath:
    from learnablepoolingmethods_torch.ops import fast_transformer as ft

    if model_name == "TransformerEncoderModel":
        return FastPath(ft.prepare_fast_transformer_params, ft.build_fast_transformer_inference,
                        supports_int8=False)
    return FastPath(ft.prepare_fast_attn_netvlad_params, ft.build_fast_attn_netvlad_inference,
                    supports_int8=True)


# the LOUPE-family models that ops/fast_lf.py serves (the JAX package's
# fast_dispatch.py#FAST_LF_MODELS)
FAST_LF_MODELS = ("NetFVModelLF", "NetRVLADModelLF", "SoftDbofModelLF", "NeXtVLADModel")
# the transformer family that ops/fast_transformer.py serves
FAST_ATTENTION_MODELS = ("TransformerEncoderModel", "AttentionNetVLADModel")

_FACTORIES: Dict[str, Callable[[], FastPath]] = {
    "NetVLADModelLF": _netvlad,
    "DbofModel": _dbof,
    **{name: (lambda n=name: _lf(n)) for name in FAST_LF_MODELS},
    **{name: (lambda n=name: _attention(n)) for name in FAST_ATTENTION_MODELS},
}


def fast_path_models() -> Tuple[str, ...]:
    """Model names with a ported fast inference path."""
    return tuple(_FACTORIES)


def get_fast_path(model_name: str) -> FastPath:
    """The (prepare, build) pair of ``model_name``.  Raises ``ValueError``
    for a model without a fast path in the JAX package too, or a name the
    package does not know."""
    factory = _FACTORIES.get(model_name)
    if factory is not None:
        return factory()
    if model_name in _NO_FAST_PATH:
        raise ValueError(f"--fast_infer supports {fast_path_models()}, got {model_name!r}")
    raise ValueError(f"unknown model {model_name!r}; ported: {fast_path_models()}")


# the fast trees' weights that only dense products read (``ops/fast_infer.py
# #matmul_f32``): the hidden FC's row slices, DBoF's folded projections and
# the MoE kernels
COLUMN_SPLIT_LEAVES = ("w_rgb", "w_aud", "w1", "w2", "hidden_w", "cluster_w", "gates_kernel",
                       "experts_kernel")


def shard_fast_params(fp, mesh, min_size: int = MIN_SHARD_SIZE):
    """``fp`` with each :data:`COLUMN_SPLIT_LEAVES` tensor that
    ``parallel/mesh.py#shard_rule`` picks cut to this rank's columns and
    marked with its ColumnShard, so that ``matmul_f32`` gathers its product;
    everything else (the kernels' weights, biases, the gating) stays whole.
    An int8 hidden FC is not split: ``--int8_hidden`` with a model axis
    raises in the CLIs, as in the JAX package."""
    if mesh.model_size == 1:
        return fp
    if isinstance(fp, dict):
        out = {}
        for k, v in fp.items():
            if (k in COLUMN_SPLIT_LEAVES and isinstance(v, torch.Tensor)
                    and shard_rule(v.shape, mesh.model_size, min_size)):
                shard = ColumnShard(mesh.model_group, mesh.model_index, mesh.model_size, v.shape[-1])
                v = v[..., shard.columns].contiguous()
                v.column_shard = shard
                out[k] = v
            else:
                out[k] = shard_fast_params(v, mesh, min_size)
        return out
    if isinstance(fp, list):
        return [shard_fast_params(v, mesh, min_size) for v in fp]
    return fp
