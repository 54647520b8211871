"""Model-zoo contract and string-name registry (ref: models/base.py).

Every zoo model is an ``nn.Module`` registered under its reference class
name and built by :func:`create_model` from the ``--model`` flag string:

    model = create_model("NetVLADModelLF", mcfg, input_size=1152)
    out = model(model_input, num_frames, training=True)   # {"predictions": [B, V]}

``predictions`` are post-activation class probabilities.  Unlike flax,
PyTorch needs the input width when the parameters are made, so
``create_model`` takes it.  ``training`` is passed to every call, as in the
JAX package; in training mode the BatchNorm layers use and update batch
statistics.
"""

from __future__ import annotations

from typing import Dict, Type

import torch
from torch import nn

from learnablepoolingmethods_torch.config import ModelConfig

_MODEL_REGISTRY: Dict[str, Type["BaseModel"]] = {}

# models of the JAX zoo that the port has not built yet → ROADMAP.md queue-1 item
_PENDING = {
    "TransformerEncoderModel": "10b", "AttentionPoolingModel": "10b", "AttentionNetVLADModel": "10b",
    "LstmModel": 11, "GruModel": 11,
}

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def register_model(cls=None, *, name: str = None):
    """Class decorator: register a zoo model under its (reference) class name."""

    def wrap(c):
        _MODEL_REGISTRY[name or c.__name__] = c
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def find_class_by_name(name: str) -> Type["BaseModel"]:
    """Flag-string model lookup (ref: train.py#find_class_by_name)."""
    if name in _MODEL_REGISTRY:
        return _MODEL_REGISTRY[name]
    if name in _PENDING:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP item {_PENDING[name]} "
            f"(ported: {list_models()})"
        )
    raise ValueError(f"Unknown model {name!r}. Registered models: {list_models()}")


def list_models():
    return sorted(_MODEL_REGISTRY)


def create_model(name: str, cfg: ModelConfig, input_size: int) -> "BaseModel":
    """Instantiate a registered model for inputs of width ``input_size``."""
    return find_class_by_name(name)(cfg, input_size)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {cfg.compute_dtype!r}")
    return COMPUTE_DTYPES[cfg.compute_dtype]


class BaseModel(nn.Module):
    """Abstract zoo model (ref: models.py#BaseModel): ``forward(model_input,
    num_frames=None, training=False) -> {"predictions": [B, V], ...}``.

    Parameters are made zero; they are filled from a flax-layout tree
    (``core/weights.py#load_flax_variables``), either converted from the
    JAX package or drawn by ``core/weights.py#init_variables_np``."""

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__()
        if cfg.param_dtype != "float32":
            raise NotImplementedError(
                "--bf16_params / param_dtype other than float32 is not ported yet: ROADMAP item 12b"
            )
        self.cfg = cfg
        self.input_size = input_size
        self.dtype = compute_dtype(cfg)

    # whether the model pools cfg.iterations sampled frames; the predict and
    # eval steps then gather them in uint8 and build the model presampled
    samples_frames = False

    def forward(self, model_input, num_frames=None, training: bool = False):
        raise NotImplementedError()
