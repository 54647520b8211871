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

``cfg.param_dtype`` (``--bf16_params`` or ``--fused_adam`` set it to
bfloat16) is the dtype of every parameter, as the flax modules pass
``param_dtype`` to every ``self.param`` and ``nn.BatchNorm``: the
BatchNorm scales and biases included, the BatchNorm statistics not (flax
keeps ``batch_stats`` in f32).  The arithmetic is unchanged: each
parameter is cast to the compute dtype, or promoted to f32, where it is
used, and its gradient comes back rounded to its own dtype, as a
cotangent takes its primal's dtype in JAX.
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
    """Instantiate a registered model for inputs of width ``input_size``,
    its parameters in ``cfg.param_dtype`` (its buffers stay f32)."""
    model = find_class_by_name(name)(cfg, input_size)
    pdtype = param_dtype(cfg)
    for p in model.parameters():
        p.data = p.data.to(pdtype)
    return model


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    """The parameters' dtype: float32, or bfloat16 under ``--bf16_params``
    or ``--fused_adam`` (flags.py#model_config_from_flags)."""
    if cfg.param_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"param_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {cfg.param_dtype!r}")
    return COMPUTE_DTYPES[cfg.param_dtype]


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
        param_dtype(cfg)  # parameters are made f32 here and cast by create_model
        self.cfg = cfg
        self.input_size = input_size
        self.dtype = compute_dtype(cfg)

    # whether the model pools cfg.iterations sampled frames; the predict and
    # eval steps then gather them in uint8 and build the model presampled
    samples_frames = False

    def forward(self, model_input, num_frames=None, training: bool = False):
        raise NotImplementedError()
