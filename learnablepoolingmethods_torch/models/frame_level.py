"""Frame-level models (ref: models/frame_level.py): ``NetVLADModelLF``.

The model takes ``model_input`` ``[B, F, D]``, the dequantized and
ℓ2-normalized frames in the compute dtype (``core/step.py#preprocess_input``),
and ``num_frames`` ``[B]``.  With ``cfg.presampled`` the frames were sampled
already (the train step gathers them in uint8); otherwise the model draws
``cfg.iterations`` frames itself from ``sampling_key``, or from
``prng.key(0)`` when none is given, as the flax model does without a
"sampling" RNG.
"""

from __future__ import annotations

import torch
from torch import nn

from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.models import model_utils
from learnablepoolingmethods_torch.models.base import BaseModel, create_model, register_model
from learnablepoolingmethods_torch.models.modules import BatchNorm, ContextGating, NetVLAD, matmul_f32
from learnablepoolingmethods_torch.utils import prng


@register_model
class NetVLADModelLF(BaseModel):
    """Gated NetVLAD, late feature fusion (ref: frame_level.py#NetVLADModelLF
    and _LoupeLFBase._lf_forward / _FrameModelBase._lf_tail).

    sample → input BN → NetVLAD on the rgb columns (K clusters) and on the
    audio columns (K/2) → concat → hidden FC (+bias, or BN and relu6 with
    ``netvlad_relu``) → context gating → the video-level classifier.
    Submodule and parameter names are the flax ones (``NetVLAD_0``,
    ``hidden1_weights``, ``MoeModel_0`` ...).
    """

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__(cfg, input_size)
        if cfg.netvlad_dimred > 0:
            raise NotImplementedError("--netvlad_dimred is not ported yet")
        add_bn = cfg.netvlad_add_batch_norm
        if add_bn:
            self.input_bn = BatchNorm(input_size)
        k = cfg.netvlad_cluster_size
        if input_size > 128:
            rgb_dim = min(1024, input_size)
            widths = [(rgb_dim, k)]
            if input_size > rgb_dim:
                widths.append((input_size - rgb_dim, max(k // 2, 1)))
        else:
            widths = [(input_size, k)]
        self.split = widths[0][0] if len(widths) > 1 else None
        for i, (d, kk) in enumerate(widths):
            mod = NetVLAD(d, kk, add_batch_norm=add_bn,
                          fused_aggregation=cfg.fused_train_aggregation, dtype=self.dtype)
            setattr(self, f"NetVLAD_{i}", mod)
        h = cfg.netvlad_hidden_size
        self.hidden1_weights = nn.Parameter(torch.zeros(sum(d * kk for d, kk in widths), h))
        if add_bn and cfg.netvlad_relu:
            self.hidden1_bn = BatchNorm(h)
        else:
            self.hidden1_biases = nn.Parameter(torch.zeros(h))
        if cfg.gating:
            self.gating = ContextGating(h, add_batch_norm=add_bn,
                                        remove_diag=cfg.gating_remove_diag, dtype=self.dtype)
        self.head_name = f"{cfg.video_level_classifier_model}_0"
        setattr(self, self.head_name, create_model(cfg.video_level_classifier_model, cfg, h))

    def forward(self, model_input, num_frames=None, training: bool = False, sampling_key=None):
        cfg, dtype = self.cfg, self.dtype
        frames = model_input
        if not cfg.presampled:
            if not cfg.sample_random_frames:
                raise NotImplementedError(
                    "--nosample_random_frames (random contiguous windows) is not ported yet"
                )
            key = prng.key(0) if sampling_key is None else sampling_key
            frames = model_utils.sample_frame_features(model_input, num_frames, cfg.iterations, key)
        if cfg.netvlad_add_batch_norm:
            frames = self.input_bn(frames, training)
        if self.split is None:
            pooled = self.NetVLAD_0(frames.to(dtype), training)
        else:
            pooled = torch.cat([
                self.NetVLAD_0(frames[:, :, :self.split].to(dtype), training),
                self.NetVLAD_1(frames[:, :, self.split:].to(dtype), training),
            ], dim=1)

        activation = matmul_f32(pooled.to(dtype), self.hidden1_weights.to(dtype))
        if hasattr(self, "hidden1_bn"):
            activation = self.hidden1_bn(activation, training)
        else:
            activation = activation + self.hidden1_biases
        if cfg.netvlad_relu:
            activation = torch.clamp(activation, 0.0, 6.0)
        if cfg.gating:
            activation = self.gating(activation, training)
        return getattr(self, self.head_name)(activation.to(dtype), training=training)
