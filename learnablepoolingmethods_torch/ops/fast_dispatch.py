"""Registry of the per-model fast inference paths (the surface of
``learnablepoolingmethods_tpu/ops/fast_dispatch.py``).

- ``prepare(variables, mcfg, int8_hidden=False, device="cuda")`` folds BNs
  and casts weights once → a flat dict of tensors on ``device``.  Raises
  ``ValueError`` on configs the fast path does not cover.
- ``build(mcfg, top_k=20, use_kernels=True, return_probs=False)`` →
  ``fn(fp, features, num_frames, key, presampled=False)``.

Only ``NetVLADModelLF`` is ported so far; every other model of the JAX
package raises an error naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple


class FastPath(NamedTuple):
    prepare: Callable[..., Dict[str, Any]]
    build: Callable[..., Callable]


# model name → ROADMAP.md queue-1 item that ports it
_PENDING = {
    "NetFVModelLF": 8,
    "NetRVLADModelLF": 8,
    "SoftDbofModelLF": 8,
    "NeXtVLADModel": 8,
    "DbofModel": 9,
    "LogisticModel": 9,
    "MoeModel": 9,
    "FrameLevelLogisticModel": 9,
    "TransformerEncoderModel": 10,
    "AttentionPoolingModel": 10,
    "AttentionNetVLADModel": 10,
    "LstmModel": 11,
    "GruModel": 11,
}


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

    return FastPath(prepare, build)


_FACTORIES: Dict[str, Callable[[], FastPath]] = {"NetVLADModelLF": _netvlad}


def fast_path_models() -> Tuple[str, ...]:
    """Model names with a ported fast inference path."""
    return tuple(_FACTORIES)


def get_fast_path(model_name: str) -> FastPath:
    """The (prepare, build) pair of ``model_name``.
    Raises ``NotImplementedError`` for a model whose port is still queued
    and ``ValueError`` for a name the package does not know."""
    factory = _FACTORIES.get(model_name)
    if factory is not None:
        return factory()
    if model_name in _PENDING:
        raise NotImplementedError(
            f"{model_name} has no PyTorch fast path yet: ROADMAP item "
            f"{_PENDING[model_name]} ports it (ported: {fast_path_models()})"
        )
    raise ValueError(f"unknown model {model_name!r}; ported: {fast_path_models()}")
