"""Frame-level models (ref: models/frame_level.py): the LOUPE "LF" family,
``NetVLADModelLF``, ``NetRVLADModelLF``, ``NetFVModelLF``,
``SoftDbofModelLF`` and ``NeXtVLADModel``; ``DbofModel``,
``FrameLevelLogisticModel``, ``LstmModel`` and ``GruModel``.

A model takes ``model_input`` ``[B, F, D]``, the dequantized and
ℓ2-normalized frames in the compute dtype (``core/step.py#preprocess_input``),
and ``num_frames`` ``[B]``.  With ``cfg.presampled`` the frames were sampled
already (the train step gathers them in uint8); otherwise the model draws
``cfg.iterations`` frames itself from ``sampling_key``, or from
``prng.key(0)`` when none is given, as the flax model does without a
"sampling" RNG: iid frames, or one random window with
``--nosample_random_frames``.

relu6 is ``min(max(x, 0), 6)``, as ``jnp.clip`` computes it, so that its
gradient at exactly 0 or 6 is ½ in both packages (``torch.clamp`` gives 1).
"""

from __future__ import annotations

import logging
from typing import List, NamedTuple, Tuple

import torch
from torch import nn

from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.models import model_utils
from learnablepoolingmethods_torch.models.base import BaseModel, create_model, register_model
from learnablepoolingmethods_torch.models.video_level import Dense
from learnablepoolingmethods_torch.models.modules import (
    BatchNorm,
    ContextGating,
    NetFV,
    NetRVLAD,
    NetVLAD,
    NeXtVLAD,
    SoftDBoW,
    matmul_param,
)
from learnablepoolingmethods_torch.ops.native_tail import gru_layer_plain, lstm_cell_plain
from learnablepoolingmethods_torch.parallel.collectives import full_param
from learnablepoolingmethods_torch.utils import prng

log = logging.getLogger(__name__)

# LF model → its pooling module's class, which names the flax submodules
# ``<prefix>_0`` (rgb, or all columns) and ``<prefix>_1`` (audio)
LF_MODULE_PREFIX = {
    "NetVLADModelLF": "NetVLAD",
    "NetRVLADModelLF": "NetRVLAD",
    "NetFVModelLF": "NetFV",
    "SoftDbofModelLF": "SoftDBoW",
    "NeXtVLADModel": "NeXtVLAD",
}


class PoolLayout(NamedTuple):
    """One pooling module of an LF model: its flax name, input width D,
    clusters K, NeXtVLAD groups G (0 for the others) and descriptor width."""

    name: str
    feature_size: int
    cluster_size: int
    groups: int
    width: int


def lf_hparams(model_name: str, cfg: ModelConfig) -> Tuple[int, int, bool]:
    """(rgb cluster size, hidden size, relu6 after the hidden FC) of an LF
    model, from the flags it reads (ref: frame_level.py#_cluster_size etc.)."""
    if model_name == "NetFVModelLF":
        return cfg.fv_cluster_size, cfg.fv_hidden_size, cfg.fv_relu
    if model_name == "NeXtVLADModel":
        return cfg.nextvlad_cluster_size, cfg.nextvlad_hidden_size, cfg.netvlad_relu
    if model_name == "NetRVLADModelLF":
        return cfg.rvlad_cluster_size, cfg.netvlad_hidden_size, cfg.netvlad_relu
    if model_name == "SoftDbofModelLF":
        return cfg.dbow_cluster_size, cfg.netvlad_hidden_size, cfg.netvlad_relu
    if model_name == "NetVLADModelLF":
        return cfg.netvlad_cluster_size, cfg.netvlad_hidden_size, cfg.netvlad_relu
    raise ValueError(f"not an LF model: {model_name!r}")


def nextvlad_groups(cfg: ModelConfig, feature_size: int) -> int:
    """The largest G <= --nextvlad_groups that divides λ·D (the flax model's
    adjustment for narrow inputs)."""
    if cfg.nextvlad_groups < 1:
        raise ValueError(f"--nextvlad_groups must be >= 1, got {cfg.nextvlad_groups}")
    groups = cfg.nextvlad_groups
    while (cfg.nextvlad_expansion * feature_size) % groups:
        groups -= 1
    return groups


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6): ``jnp.clip``'s value and its ½ gradient at either bound."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.full_like(x, 6.0))


def lf_layout(model_name: str, cfg: ModelConfig, input_size: int) -> List[PoolLayout]:
    """The pooling modules of an LF model on ``input_size`` columns, or on
    the ``--netvlad_dimred`` columns of the learned reduction when it is on:
    above 128 columns one module on the first min(1024, D) (rgb, K clusters)
    and one on the rest (audio, K/2), else one module on all (ref:
    frame_level.py#_LoupeLFBase._lf_forward)."""
    prefix = LF_MODULE_PREFIX[model_name]
    k, _, _ = lf_hparams(model_name, cfg)
    if cfg.netvlad_dimred > 0:
        input_size = cfg.netvlad_dimred
    if input_size > 128:
        rgb_dim = min(1024, input_size)
        widths = [(rgb_dim, k)]
        if input_size > rgb_dim:
            widths.append((input_size - rgb_dim, max(k // 2, 1)))
    else:
        widths = [(input_size, k)]
    out = []
    for i, (d, kk) in enumerate(widths):
        groups = 0
        if model_name == "NeXtVLADModel":
            groups = nextvlad_groups(cfg, d)
            width = kk * cfg.nextvlad_expansion * d // groups
        elif model_name == "NetFVModelLF":
            width = 2 * d * kk
        elif model_name == "SoftDbofModelLF":
            width = kk
        else:
            width = d * kk
        out.append(PoolLayout(f"{prefix}_{i}", d, kk, groups, width))
    return out


def sample_model_frames(cfg: ModelConfig, model_input, num_frames, sampling_key=None):
    """The ``cfg.iterations`` frames a sampling model pools: ``model_input``
    itself when ``cfg.presampled``, else iid frames or one random window
    (``--nosample_random_frames``) drawn from ``sampling_key``, or from
    ``prng.key(0)`` without one, as the flax model draws them without a
    "sampling" RNG."""
    if cfg.presampled:
        return model_input
    key = prng.key(0) if sampling_key is None else sampling_key
    return model_utils.sample_model_input(model_input, num_frames, cfg.iterations, key,
                                          cfg.sample_random_frames)


class LFTailModel(BaseModel):
    """A model that ends in the shared LF tail (ref: frame_level.py
    #_FrameModelBase._lf_tail): hidden FC ``hidden1_weights`` [W, H] summed
    in f32 → ``hidden1_bn`` with relu6 on and BN on, else
    ``hidden1_biases`` → relu6 (``relu``) → context gating (``gating``,
    ``--gating``) → the video-level classifier ``<head>_0``.  The LF family
    and the attention models build it with :meth:`_init_tail` after their
    pooling, so its parameters keep flax's names at the model's top level."""

    def _init_tail(self, width: int, hidden: int, relu: bool) -> None:
        cfg = self.cfg
        add_bn = cfg.netvlad_add_batch_norm
        self.relu = relu
        self.hidden1_weights = nn.Parameter(torch.zeros(width, hidden))
        if add_bn and relu:
            self.hidden1_bn = BatchNorm(hidden)
        else:
            self.hidden1_biases = nn.Parameter(torch.zeros(hidden))
        if cfg.gating:
            self.gating = ContextGating(hidden, add_batch_norm=add_bn,
                                        remove_diag=cfg.gating_remove_diag, dtype=self.dtype)
        self.head_name = f"{cfg.video_level_classifier_model}_0"
        setattr(self, self.head_name, create_model(cfg.video_level_classifier_model, cfg, hidden))

    def _lf_tail(self, pooled: torch.Tensor, training: bool):
        dtype = self.dtype
        activation = matmul_param(pooled.to(dtype), self.hidden1_weights, dtype)
        if hasattr(self, "hidden1_bn"):
            activation = self.hidden1_bn(activation, training)
        else:
            activation = activation + self.hidden1_biases
        if self.relu:
            activation = relu6(activation)
        if self.cfg.gating:
            activation = self.gating(activation, training)
        return getattr(self, self.head_name)(activation.to(dtype), training=training)


class _LoupeLFBase(LFTailModel):
    """The template of the LF models (ref: frame_level.py#_LoupeLFBase,
    ``_lf_forward`` and ``_lf_tail``): sample → input BN → a pooling module
    on the rgb columns (K clusters) and one on the audio columns (K/2) →
    concat → hidden FC (+bias, or BN and relu6 with relu on) → context
    gating → the video-level classifier (:class:`LFTailModel`).  Submodule
    and parameter names are the flax ones (``NetVLAD_0``, ``hidden1_weights``, ``MoeModel_0`` ...).

    ``--netvlad_dimred`` r > 0 puts a learned ``dimred`` [D, r] after the
    input BN, summed in f32, and the pooling modules then split r columns
    as :func:`lf_layout` says (ref: frame_level.py:324-340)."""

    samples_frames = True

    def _pool_module(self, layout: PoolLayout) -> nn.Module:
        raise NotImplementedError

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__(cfg, input_size)
        name = type(self).__name__
        add_bn = cfg.netvlad_add_batch_norm
        _, hidden, relu = lf_hparams(name, cfg)
        if add_bn:
            self.input_bn = BatchNorm(input_size)
        if cfg.netvlad_dimred > 0:
            self.dimred = nn.Parameter(torch.zeros(input_size, cfg.netvlad_dimred))
        self.layout = lf_layout(name, cfg, input_size)
        self.split = self.layout[0].feature_size if len(self.layout) > 1 else None
        for mod in self.layout:
            setattr(self, mod.name, self._pool_module(mod))
        self._init_tail(sum(m.width for m in self.layout), hidden, relu)

    def forward(self, model_input, num_frames=None, training: bool = False, sampling_key=None):
        cfg, dtype = self.cfg, self.dtype
        frames = sample_model_frames(cfg, model_input, num_frames, sampling_key)
        if cfg.netvlad_add_batch_norm:
            frames = self.input_bn(frames, training)
        if cfg.netvlad_dimred > 0:
            frames = matmul_param(frames.to(dtype), self.dimred, dtype)
        pools = [getattr(self, mod.name) for mod in self.layout]
        if self.split is None:
            pooled = pools[0](frames.to(dtype), training)
        else:
            pooled = torch.cat([
                pools[0](frames[:, :, :self.split].to(dtype), training),
                pools[1](frames[:, :, self.split:].to(dtype), training),
            ], dim=1)
        return self._lf_tail(pooled, training)


@register_model
class NetVLADModelLF(_LoupeLFBase):
    """Gated NetVLAD, late feature fusion (ref: frame_level.py#NetVLADModelLF):
    the Willow configuration, NetVLAD-256 (audio 128), hidden 1024, gating."""

    def _pool_module(self, layout):
        return NetVLAD(layout.feature_size, layout.cluster_size,
                       add_batch_norm=self.cfg.netvlad_add_batch_norm,
                       fused_aggregation=self.cfg.fused_train_aggregation, dtype=self.dtype)


@register_model
class NetRVLADModelLF(_LoupeLFBase):
    """NetVLAD without the centre subtraction (ref: frame_level.py#NetRVLADModelLF)."""

    def _pool_module(self, layout):
        return NetRVLAD(layout.feature_size, layout.cluster_size,
                        add_batch_norm=self.cfg.netvlad_add_batch_norm,
                        fused_aggregation=self.cfg.fused_train_aggregation, dtype=self.dtype)


@register_model
class NetFVModelLF(_LoupeLFBase):
    """Net Fisher Vector model (ref: frame_level.py#NetFVModelLF)."""

    def _pool_module(self, layout):
        cfg = self.cfg
        return NetFV(layout.feature_size, layout.cluster_size,
                     add_batch_norm=cfg.netvlad_add_batch_norm,
                     couple_weights=cfg.fv_couple_weights,
                     coupling_factor=cfg.fv_coupling_factor, dtype=self.dtype)


@register_model
class SoftDbofModelLF(_LoupeLFBase):
    """Soft bag-of-words model (ref: frame_level.py#SoftDbofModelLF)."""

    def _pool_module(self, layout):
        return SoftDBoW(layout.feature_size, layout.cluster_size,
                        add_batch_norm=self.cfg.netvlad_add_batch_norm, dtype=self.dtype)


@register_model
class NeXtVLADModel(_LoupeLFBase):
    """NeXtVLAD pooling behind the LF tail (ref: frame_level.py#NeXtVLADModel).
    G must divide λ·D: on a narrow input the model takes the largest divisor
    below --nextvlad_groups and says so, as the flax model does."""

    def _pool_module(self, layout):
        cfg = self.cfg
        if layout.groups != cfg.nextvlad_groups:
            log.warning("NeXtVLAD: groups adjusted %d -> %d so it divides expansion*feature_size = %d",
                        cfg.nextvlad_groups, layout.groups,
                        cfg.nextvlad_expansion * layout.feature_size)
        return NeXtVLAD(layout.feature_size, layout.cluster_size, groups=layout.groups,
                        expansion=cfg.nextvlad_expansion,
                        add_batch_norm=cfg.netvlad_add_batch_norm, dtype=self.dtype)


@register_model
class FrameLevelLogisticModel(BaseModel):
    """The mean over a video's valid frames → ``fc`` → sigmoid (ref:
    frame_level.py#FrameLevelLogisticModel).  Padded rows are masked out:
    the pipeline pads in uint8, and a zero row is nonzero after dequantize
    and ℓ2, where the reference padded after dequantize."""

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__(cfg, input_size)
        self.fc = Dense(input_size, cfg.vocab_size, self.dtype)

    def forward(self, model_input, num_frames=None, training: bool = False):
        nf = torch.clamp(num_frames.float(), min=1.0).reshape(-1, 1)
        mask = model_utils.frame_mask(num_frames, model_input.shape[1])
        avg_pooled = torch.sum(model_input.float() * mask[:, :, None], dim=1) / nf
        return {"predictions": torch.sigmoid(self.fc(avg_pooled).float())}


@register_model
class DbofModel(BaseModel):
    """Deep bag of frames (ref: frame_level.py#DbofModel): sample
    ``--iterations`` frames → input BN → cluster projection [D →
    dbof_cluster_size] → BN (or bias) → relu6 → max or average pooling over
    the frames → hidden FC → BN (or bias) → relu6 → the video-level
    classifier.  Without ``--dbof_add_batch_norm`` there is no input BN and
    biases take the other BNs' place, as in flax."""

    samples_frames = True

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__(cfg, input_size)
        c, h = cfg.dbof_cluster_size, cfg.dbof_hidden_size
        add_bn = cfg.dbof_add_batch_norm
        if add_bn:
            self.input_bn = BatchNorm(input_size)
        self.cluster_weights = nn.Parameter(torch.zeros(input_size, c))
        if add_bn:
            self.cluster_bn = BatchNorm(c)
        else:
            self.cluster_biases = nn.Parameter(torch.zeros(c))
        self.hidden1_weights = nn.Parameter(torch.zeros(c, h))
        if add_bn:
            self.hidden1_bn = BatchNorm(h)
        else:
            self.hidden1_biases = nn.Parameter(torch.zeros(h))
        self.head_name = f"{cfg.video_level_classifier_model}_0"
        setattr(self, self.head_name, create_model(cfg.video_level_classifier_model, cfg, h))

    def forward(self, model_input, num_frames=None, training: bool = False, sampling_key=None):
        cfg, dtype = self.cfg, self.dtype
        frames = sample_model_frames(cfg, model_input, num_frames, sampling_key)
        if cfg.dbof_add_batch_norm:
            frames = self.input_bn(frames, training)
        activation = matmul_param(frames.to(dtype), self.cluster_weights, dtype)    # [B, S, C]
        if cfg.dbof_add_batch_norm:
            activation = self.cluster_bn(activation, training)
        else:
            activation = activation + self.cluster_biases
        activation = relu6(activation)
        pooled = model_utils.frame_pooling(activation, cfg.dbof_pooling_method)

        activation = matmul_param(pooled.to(dtype), self.hidden1_weights, dtype)
        if cfg.dbof_add_batch_norm:
            activation = self.hidden1_bn(activation, training)
        else:
            activation = activation + self.hidden1_biases
        activation = relu6(activation)
        return getattr(self, self.head_name)(activation.to(dtype), training=training)


class DenseParams(nn.Module):
    """One of flax's per-gate Dense modules of an RNN cell: ``kernel``
    [in, out] and, with ``use_bias``, ``bias`` [out]."""

    def __init__(self, in_features: int, features: int, use_bias: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))


class _RecurrentCell(nn.Module):
    """A flax RNN cell's gates as named ``DenseParams``: ``i<g>`` on the
    input and ``h<g>`` on the hidden state for each gate g, with a bias
    where flax gives one (``bias_on``: the names that have one).  The
    gates' kernels and biases of one side are used side by side
    (:meth:`_kernels`, :meth:`_biases`)."""

    GATES: Tuple[str, ...] = ()

    def __init__(self, in_features: int, features: int, bias_on: Tuple[str, ...]):
        super().__init__()
        self.features = features
        for g in self.GATES:
            for side, width in (("i", in_features), ("h", features)):
                setattr(self, side + g, DenseParams(width, features, side + g in bias_on))

    def _kernels(self, side: str) -> torch.Tensor:
        return torch.cat([full_param(getattr(self, side + g).kernel) for g in self.GATES], dim=1)

    def _biases(self, side: str) -> torch.Tensor:
        return torch.cat([getattr(self, side + g).bias for g in self.GATES])


class OptimizedLSTMCell(_RecurrentCell):
    """``flax.linen.OptimizedLSTMCell``: ``ii``, ``if``, ``ig``, ``io``
    without bias, ``hi``, ``hf``, ``hg``, ``ho`` with; i, f, o = σ(h·W_h +
    b_h + x·W_i), g = tanh(…), c′ = f·c + i·g, h′ = o·tanh(c′)."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, in_features: int, features: int):
        super().__init__(in_features, features, ("hi", "hf", "hg", "ho"))

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """The cell over every frame of ``x`` [B, F, D] from a zero carry →
        the hidden state after each frame [B, F, H]."""
        w_i, w_h, b_h = self._kernels("i"), self._kernels("h"), self._biases("h")
        pre = torch.matmul(x, w_i)                                    # [B, F, 4H]
        h = c = x.new_zeros(x.shape[0], self.features)
        outs = []
        for t in range(x.shape[1]):
            h, c = lstm_cell_plain(pre[:, t], torch.matmul(h, w_h), b_h, c)
            outs.append(h)
        return torch.stack(outs, dim=1)


class GRUCell(_RecurrentCell):
    """``flax.linen.GRUCell``, the reset-after variant: ``ir``, ``iz``,
    ``in`` with bias, ``hr``, ``hz`` without, ``hn`` with; r, z = σ(x·W_i
    + b_i + h·W_h), n = tanh(x·W_in + b_in + r·(h·W_hn + b_hn)), h′ =
    (1 − z)·n + z·h."""

    GATES = ("r", "z", "n")

    def __init__(self, in_features: int, features: int):
        super().__init__(in_features, features, ("ir", "iz", "in", "hn"))

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """As :meth:`OptimizedLSTMCell.run`."""
        w_i, b_i, w_h, b_hn = self._kernels("i"), self._biases("i"), self._kernels("h"), self.hn.bias
        return gru_layer_plain(torch.matmul(x, w_i), w_h, b_i, b_hn)


class _RecurrentModel(BaseModel):
    """Stacked RNN cells over every frame in f32 (ref: frame_level.py
    #LstmModel, #GruModel: ``nn.RNN(cell, return_carry=True)`` with
    ``seq_lengths``), then the video-level classifier on the top layer's
    hidden state at each video's last valid frame.

    As flax's ``nn.RNN`` does, each layer runs over all F frames, padding
    included (an upper layer reads the lower one's outputs there too), and
    the carry is read at index min(num_frames, F) − 1: for a video of no
    frames that is −1, the carry after the last frame
    (flax/linen/recurrent.py ``_select_last_carry``).  The recurrence is a
    loop over frames of plain products (the JAX package scans it in XLA,
    with no Pallas kernel); the cells' parameters stay f32 under
    ``--bf16_params``, as flax makes them."""

    CELL = None
    PREFIX = ""

    def __init__(self, cfg: ModelConfig, input_size: int, layers: int, cells: int):
        super().__init__(cfg, input_size)
        self.num_layers = layers
        for layer in range(layers):
            setattr(self, f"{self.PREFIX}{layer}", self.CELL(input_size if layer == 0 else cells, cells))
        self.head_name = f"{cfg.video_level_classifier_model}_0"
        setattr(self, self.head_name, create_model(cfg.video_level_classifier_model, cfg, cells))

    def forward(self, model_input, num_frames=None, training: bool = False):
        x = model_input.float()
        b, f = x.shape[:2]
        for layer in range(self.num_layers):
            x = getattr(self, f"{self.PREFIX}{layer}").run(x)
        last = torch.remainder(torch.clamp(num_frames.long(), max=f) - 1, f)
        final = x[torch.arange(b, device=x.device), last]
        return getattr(self, self.head_name)(final, training=training)


@register_model
class LstmModel(_RecurrentModel):
    """Stacked LSTM (ref: frame_level.py#LstmModel): ``--lstm_layers``
    cells ``OptimizedLSTMCell_<l>`` of ``--lstm_cells``; the top layer's h."""

    CELL = OptimizedLSTMCell
    PREFIX = "OptimizedLSTMCell_"
    f32_param_prefixes = (PREFIX,)

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__(cfg, input_size, cfg.lstm_layers, cfg.lstm_cells)


@register_model
class GruModel(_RecurrentModel):
    """Stacked GRU (ref: frame_level.py#GruModel): ``--gru_layers`` cells
    ``GRUCell_<l>`` of ``--gru_cells``; the top layer's carry."""

    CELL = GRUCell
    PREFIX = "GRUCell_"
    f32_param_prefixes = (PREFIX,)

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__(cfg, input_size, cfg.gru_layers, cfg.gru_cells)
