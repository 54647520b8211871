"""The attention family (ref: models/attention.py): ``TransformerEncoderModel``
(BASELINE config 5), ``AttentionPoolingModel`` and ``AttentionNetVLADModel``
as ``nn.Module``s, for the model-forward route and for training.

Submodule and parameter names are flax's: ``input_proj``,
``encoder/layer_<i>/mha/{query,key,value}`` with ``[D, H, hd]`` kernels and
``[H, hd]`` biases, ``mha/out`` with an ``[H, hd, D]`` kernel, ``ln1``,
``ln2``, ``ff1``, ``ff2``, ``attn_pool/queries`` and ``attn_pool/pool_mha``,
``vlad`` (the plain NetVLAD), then the shared tail (``LFTailModel``).

The attention follows flax's ``MultiHeadDotProductAttention``
(flax/linen/attention.py:120-162): q / √hd in the compute dtype, the logits
of masked keys set to ``finfo(dtype).min`` (a video of no frames attends
uniformly), the softmax, cast to the compute dtype.  Products take their
operands in the compute dtype and sum in f32.  The LayerNorms run in f32
and return f32, so each layer's residual sums promote to f32, as in flax.

In training the encoder draws flax's dropout masks (``--attention_dropout``)
from ``dropout_key``, the key the train step passes as
``rngs={"dropout": key}`` (``core/step.py``): layer i's attention dropout
from ``make_rng`` in ``encoder/layer_<i>/mha`` and its FFN dropout from
``encoder/layer_<i>/Dropout_0`` (``utils/prng.py#flax_make_rng``), applied by
``ops/dropout.py`` (the CUDA kernel on the card).  Without a key, or with
``training`` off, nothing is dropped.

Only the NetVLAD module, the tail and the head take ``--bf16_params``' bf16:
flax gives ``param_dtype`` to nothing else here (``f32_param_prefixes``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.models.base import register_model
from learnablepoolingmethods_torch.models.frame_level import LFTailModel
from learnablepoolingmethods_torch.models.model_utils import frame_mask
from learnablepoolingmethods_torch.models.modules import NetVLAD, matmul_f32
from learnablepoolingmethods_torch.parallel.collectives import full_param
from learnablepoolingmethods_torch.ops.dropout import dropout
from learnablepoolingmethods_torch.ops.native_tail import layer_norm
from learnablepoolingmethods_torch.utils import prng


class DenseGeneral(nn.Module):
    """``flax.linen.DenseGeneral`` over the last ``len(in_shape)`` axes:
    ``kernel`` ``[*in_shape, *out_shape]`` and ``bias`` ``out_shape``; the
    inputs, kernel and bias are cast to ``dtype``, the product summed in f32
    and returned in ``dtype``."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int], dtype: torch.dtype):
        super().__init__()
        self.in_shape, self.out_shape, self.dtype = tuple(in_shape), tuple(out_shape), dtype
        self.kernel = nn.Parameter(torch.zeros(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = math.prod(self.in_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        kernel = full_param(self.kernel).to(self.dtype).reshape(n_in, -1)
        y = matmul_f32(x.to(self.dtype).reshape(*lead, n_in), kernel).to(self.dtype)
        return (y + self.bias.to(self.dtype).reshape(-1)).reshape(*lead, *self.out_shape)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=float32)``: ``scale`` and ``bias``, f32
    statistics with the fast variance and ε 1e-6, an f32 result."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.float(), self.scale.float(), self.bias.float(), clamp_var=True)


class MultiHeadAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention`` with ``dropout_rate``
    (flax/linen/attention.py): projections ``query``, ``key``, ``value``
    [D, H, hd] and ``out`` [H, hd, D], the weights dropped (in training,
    with a key) by one ``[1, 1, Lq, Lk]`` mask broadcast over batch and
    heads."""

    def __init__(self, features: int, heads: int, dtype: torch.dtype, dropout_rate: float = 0.0):
        super().__init__()
        if features % heads:
            raise ValueError(f"Memory dimension ({features}) must be divisible by number of heads ({heads}).")
        hd = features // heads
        self.heads, self.head_dim, self.dtype, self.dropout_rate = heads, hd, dtype, dropout_rate
        self.query = DenseGeneral((features,), (heads, hd), dtype)
        self.key = DenseGeneral((features,), (heads, hd), dtype)
        self.value = DenseGeneral((features,), (heads, hd), dtype)
        self.out = DenseGeneral((heads, hd), (features,), dtype)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor, key_mask: torch.Tensor,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``inputs_q`` [B, Lq, D], ``inputs_kv`` [B, Lk, D], ``key_mask``
        [B, Lk] (True: the key is valid) → [B, Lq, D]."""
        dtype = self.dtype
        q, k, v = self.query(inputs_q), self.key(inputs_kv), self.value(inputs_kv)   # [B, L, H, hd]
        q = q / torch.sqrt(torch.tensor(float(self.head_dim))).to(dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = torch.where(key_mask[:, None, None, :], logits,
                             torch.tensor(torch.finfo(dtype).min, dtype=dtype, device=logits.device))
        weights = torch.softmax(logits, dim=-1).to(dtype)
        weights = dropout(weights, dropout_key, self.dropout_rate, (1, 1, *weights.shape[-2:]), mode="mul")
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v))


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder block (ref: attention.py#TransformerEncoderLayer):
    ``mha`` → ``ln1``(x + attn) → ``ff1`` → ReLU → ``ff2`` → dropout →
    ``ln2``(x + ff)."""

    def __init__(self, d_model: int, heads: int, ff_size: int, dropout_rate: float, dtype: torch.dtype):
        super().__init__()
        self.dtype, self.dropout_rate = dtype, dropout_rate
        self.mha = MultiHeadAttention(d_model, heads, dtype, dropout_rate)
        self.ln1 = LayerNorm(d_model)
        self.ff1 = DenseGeneral((d_model,), (ff_size,), dtype)
        self.ff2 = DenseGeneral((ff_size,), (d_model,), dtype)
        self.ln2 = LayerNorm(d_model)

    def forward(self, x, key_mask, dropout_key: Optional[torch.Tensor] = None, scope: tuple = (),
                row_offset: int = 0):
        """``scope``: the layer's flax path, under which its dropout keys are
        made from ``dropout_key``; ``row_offset``: the global index of the
        first row, which keys the FFN dropout mask."""
        mha_key = ff_key = None
        if dropout_key is not None:
            mha_key = prng.flax_make_rng(dropout_key, 1, (*scope, "mha"))
            ff_key = prng.flax_make_rng(dropout_key, 1, (*scope, "Dropout_0"))
        x = self.ln1(x + self.mha(x, x, key_mask, mha_key))
        ff = self.ff2(torch.relu(self.ff1(x)))
        ff = dropout(ff, ff_key, self.dropout_rate, row_offset=row_offset)
        return self.ln2(x + ff)


class TransformerEncoder(nn.Module):
    """``layer_<i>`` for i < ``--transformer_layers`` over the frames, the
    padded frames masked as keys."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.num_layers = cfg.transformer_layers
        for i in range(self.num_layers):
            setattr(self, f"layer_{i}", TransformerEncoderLayer(
                cfg.attention_hidden_size, cfg.attention_heads, cfg.transformer_ff_size,
                cfg.attention_dropout, dtype))

    def forward(self, x, key_mask, dropout_key: Optional[torch.Tensor] = None, row_offset: int = 0):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, key_mask, dropout_key, ("encoder", f"layer_{i}"), row_offset)
        return x


class AttentionPooling(nn.Module):
    """Learned-query attention pooling (ref: attention.py#AttentionPooling):
    ``queries`` [Q, D] attend over the frames through ``pool_mha``
    (deterministic: no dropout) → [B, Q·D]."""

    def __init__(self, num_queries: int, d_model: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.queries = nn.Parameter(torch.zeros(num_queries, d_model))
        self.pool_mha = MultiHeadAttention(d_model, heads, dtype)

    def forward(self, x, key_mask):
        b = x.shape[0]
        q = full_param(self.queries)[None].expand(b, -1, -1).to(x.dtype)
        return self.pool_mha(q, x, key_mask).reshape(b, -1)


class _AttentionModel(LFTailModel):
    """input projection of the dequantized frames to ``--attention_hidden_size``,
    the model's pooling, the shared tail."""

    f32_param_prefixes = ("input_proj.", "encoder.", "attn_pool.")

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__(cfg, input_size)
        self.input_proj = DenseGeneral((input_size,), (cfg.attention_hidden_size,), self.dtype)

    def _frames(self, model_input, num_frames):
        """(projected frames [B, F, D], the f32 frame mask [B, F])."""
        return self.input_proj(model_input.to(self.dtype)), frame_mask(num_frames, model_input.shape[1])


@register_model
class TransformerEncoderModel(_AttentionModel):
    """Transformer-encoder pooling (ref: attention.py#TransformerEncoderModel):
    input projection → ``encoder`` → the mean over the valid frames (f32,
    divided by max(Σ mask, 1)) → the tail (hidden ``--attention_hidden_size``,
    no relu6)."""

    takes_dropout_key = True

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__(cfg, input_size)
        self.encoder = TransformerEncoder(cfg, self.dtype)
        self._init_tail(cfg.attention_hidden_size, cfg.attention_hidden_size, relu=False)

    def forward(self, model_input, num_frames=None, training: bool = False, dropout_key=None,
                row_offset: int = 0):
        x, mask = self._frames(model_input, num_frames)
        x = self.encoder(x, mask > 0, dropout_key if training else None, row_offset)
        denom = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
        pooled = torch.sum(x.float() * mask[:, :, None], dim=1) / denom
        return self._lf_tail(pooled.to(self.dtype), training)


@register_model
class AttentionPoolingModel(_AttentionModel):
    """Multi-head learned-query attention pooling (ref:
    attention.py#AttentionPoolingModel): input projection → ``attn_pool``
    (``--attention_cluster_size`` queries) → the tail (no relu6)."""

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__(cfg, input_size)
        d = cfg.attention_hidden_size
        self.attn_pool = AttentionPooling(cfg.attention_cluster_size, d, cfg.attention_heads, self.dtype)
        self._init_tail(cfg.attention_cluster_size * d, cfg.attention_hidden_size, relu=False)

    def forward(self, model_input, num_frames=None, training: bool = False):
        x, mask = self._frames(model_input, num_frames)
        return self._lf_tail(self.attn_pool(x, mask > 0).to(self.dtype), training)


@register_model
class AttentionNetVLADModel(_AttentionModel):
    """Transformer-contextualised NetVLAD (ref:
    attention.py#AttentionNetVLADModel): input projection → ``encoder`` →
    the padded frames zeroed → ``vlad`` (NetVLAD-``--netvlad_cluster_size``
    over the model width, the plain aggregation as in flax) → the tail
    (hidden ``--netvlad_hidden_size``, relu6 with ``--netvlad_relu``)."""

    takes_dropout_key = True

    def __init__(self, cfg: ModelConfig, input_size: int):
        super().__init__(cfg, input_size)
        d, k = cfg.attention_hidden_size, cfg.netvlad_cluster_size
        self.encoder = TransformerEncoder(cfg, self.dtype)
        self.vlad = NetVLAD(d, k, add_batch_norm=cfg.netvlad_add_batch_norm, dtype=self.dtype)
        self._init_tail(d * k, cfg.netvlad_hidden_size, relu=cfg.netvlad_relu)

    def forward(self, model_input, num_frames=None, training: bool = False, dropout_key=None,
                row_offset: int = 0):
        x, mask = self._frames(model_input, num_frames)
        x = self.encoder(x, mask > 0, dropout_key if training else None, row_offset)
        x = x * mask[:, :, None].to(x.dtype)
        return self._lf_tail(self.vlad(x, training), training)
