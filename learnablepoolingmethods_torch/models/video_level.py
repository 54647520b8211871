"""Video-level classifier heads (ref: models/video_level.py)."""

from __future__ import annotations

import torch
from torch import nn

from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.models.base import BaseModel, register_model
from learnablepoolingmethods_torch.models.modules import matmul_f32


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
        gate_activations = matmul_f32(x, self.gates_kernel.to(self.dtype)).reshape(-1, m + 1, v)
        expert_activations = (
            matmul_f32(x, self.experts_kernel.to(self.dtype)) + self.experts_bias.float()
        ).reshape(-1, m, v)
        gating = torch.softmax(gate_activations, dim=1)
        experts = torch.sigmoid(expert_activations)
        return {"predictions": torch.sum(gating[:, :m] * experts, dim=1)}
