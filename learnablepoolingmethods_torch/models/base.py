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
bfloat16) is the dtype of every parameter that flax makes with
``param_dtype``: every ``self.param`` and ``nn.BatchNorm`` of the pooling
modules, tails and heads, the BatchNorm scales and biases included, the
BatchNorm statistics not (flax keeps ``batch_stats`` in f32).  The modules
that flax builds without it stay f32, leaf for leaf as in the flax tree: a
model names them by ``f32_param_prefixes`` (the attention models' input
projection, encoder and attention pooling, the RNNs' cells).  The
arithmetic is unchanged: each
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
    raise ValueError(f"Unknown model {name!r}. Registered models: {list_models()}")


def list_models():
    return sorted(_MODEL_REGISTRY)


def create_model(name: str, cfg: ModelConfig, input_size: int) -> "BaseModel":
    """Instantiate a registered model for inputs of width ``input_size``,
    its parameters in ``cfg.param_dtype`` but those under the model's
    ``f32_param_prefixes`` (its buffers stay f32)."""
    model = find_class_by_name(name)(cfg, input_size)
    pdtype = param_dtype(cfg)
    for pname, p in model.named_parameters():
        if not pname.startswith(model.f32_param_prefixes):
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
    # the parameter-name prefixes of the modules that flax builds without
    # param_dtype: they stay f32 under --bf16_params (create_model)
    f32_param_prefixes: tuple = ()
    # whether forward takes ``dropout_key``, the train step's
    # rngs={"dropout": key}, and ``row_offset``, the global index of the
    # step's first row, which keys the masks (core/step.py)
    takes_dropout_key = False

    def forward(self, model_input, num_frames=None, training: bool = False):
        raise NotImplementedError()
