"""Video-level classifier heads (ref: models/video_level.py).

They take one vector per video, either the video-level features
``[B, 1152]`` or a frame-level model's pooled activation, and return
``{"predictions": [B, V]}`` probabilities.
"""

from __future__ import annotations

import torch
from torch import nn

from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.models.base import BaseModel, register_model
from learnablepoolingmethods_torch.models.modules import matmul_param


class Dense(nn.Module):
    """``flax.linen.Dense``: ``kernel`` ``[D, N]`` and ``bias`` ``[N]``; the
    product takes operands in ``dtype`` and its result and the bias add are
    in ``dtype``, as flax computes them with ``dtype`` set."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = matmul_param(x.to(self.dtype), self.kernel, self.dtype).to(self.dtype)
        return y + self.bias.to(self.dtype)


@register_model
class LogisticModel(BaseModel):
    """One sigmoid FC over the input (ref: video_level.py#LogisticModel):
    ``fc`` (kernel and bias), the sigmoid in f32."""

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__(cfg, input_size)
        self.fc = Dense(input_size, cfg.vocab_size, self.dtype)

    def forward(self, model_input, num_frames=None, training: bool = False):
        return {"predictions": torch.sigmoid(self.fc(model_input).float())}


@register_model
class MoeModel(BaseModel):
    """Per-class mixture of experts (ref: video_level.py#MoeModel).

    gates ``[B, M+1, V]`` softmax over the M+1 axis (one dummy expert),
    experts ``[B, M, V]`` sigmoid, p = Σ_m gate_m·expert_m.  The kernels are
    vocab-major, ``[D, (M+1)·V]`` with column m·V + v, as in the JAX package.
    """

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__(cfg, input_size)
        m, v = cfg.moe_num_mixtures, cfg.vocab_size
        self.gates_kernel = nn.Parameter(torch.zeros(input_size, (m + 1) * v))
        self.experts_kernel = nn.Parameter(torch.zeros(input_size, m * v))
        self.experts_bias = nn.Parameter(torch.zeros(m * v))

    def forward(self, model_input, num_frames=None, training: bool = False):
        m, v = self.cfg.moe_num_mixtures, self.cfg.vocab_size
        x = model_input.to(self.dtype)
        gate_activations = matmul_param(x, self.gates_kernel, self.dtype).reshape(-1, m + 1, v)
        expert_activations = (
            matmul_param(x, self.experts_kernel, self.dtype) + self.experts_bias.float()
        ).reshape(-1, m, v)
        gating = torch.softmax(gate_activations, dim=1)
        experts = torch.sigmoid(expert_activations)
        return {"predictions": torch.sum(gating[:, :m] * experts, dim=1)}
