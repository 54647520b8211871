"""Learnable pooling modules (ref: models/modules.py): the flax-compatible
BatchNorm, NetVLAD and context gating.

Parameter and statistic names follow the flax tree, so a module's
``state_dict`` key ``NetVLAD_0.cluster_bn.scale`` is the flax path
``params/NetVLAD_0/cluster_bn/scale`` (``core/weights.py`` converts).
Matrix products take operands in the compute dtype and sum in f32, as
``preferred_element_type=float32`` does (:func:`matmul_f32`).
"""

from __future__ import annotations

import torch
from torch import nn

from learnablepoolingmethods_torch.ops.fast_infer import matmul_f32 as _mm_f32
from learnablepoolingmethods_torch.ops.netvlad_train import netvlad_aggregate
from learnablepoolingmethods_torch.ops.normalize import l2_normalize

# TF slim.batch_norm defaults (decay=0.999, epsilon=0.001), as the JAX package
BN_MOMENTUM = 0.999
BN_EPSILON = 1e-3


def _mm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` summed in f32 with operands in ``dtype``.  On the card a
    bf16 product takes bf16 operands, so an f32 cotangent is rounded to bf16
    first, as the TPU's default matmul precision does; on the CPU mixed
    operands are widened to f32, as ``dot_general`` does there."""
    if a.is_cuda:
        a, b = a.to(dtype), b.to(dtype)
    return _mm_f32(a, b)


class _MatmulF32(torch.autograd.Function):
    """2-D ``a @ b`` → f32 from operands of one dtype, with the VJP of
    ``dot_general(..., preferred_element_type=float32)``: each cotangent is
    the f32 product, cast to its operand's dtype.  Both cotangents come out
    contiguous, so the optimizer's element-wise passes over them vectorize."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _mm(g, b.t(), b.dtype).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = _mm(a.t(), g, a.dtype).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable ``a @ b`` over the last axis of ``a`` ([..., K] × [K, N])
    with an f32 result: operands in their own dtype, sums in f32."""
    lead = a.shape[:-1]
    out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*lead, b.shape[-1])


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the last axis, in f32.

    - statistics over every axis but the last (the B·F rows of ``[B, F, K]``);
    - the fast variance ``max(0, E[x²] − E[x]²)``, which is biased;
    - running averages ``m·avg + (1 − m)·batch`` with flax's momentum
      (0.999 here is torch's momentum 0.001), updated in place in training;
    - ``y = (x − μ)·(rsqrt(σ² + ε)·scale) + bias`` with ε = 1e-3.
    """

    def __init__(self, features: int, momentum: float = BN_MOMENTUM, epsilon: float = BN_EPSILON):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        x = x.float()
        if training:
            axes = tuple(range(x.dim() - 1))
            mean = torch.mean(x, dim=axes)
            var = torch.clamp(torch.mean(x * x, dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean) * mul + self.bias


class NetVLAD(nn.Module):
    """NetVLAD aggregation (ref: models/modules.py#NetVLAD) → ``[B, D·K]``.

    A = softmax(BN(X·C)); V = XᵀA − (Σ_F A)⊙C₂; intra-ℓ2 over D; the d-major
    flatten (index d·K + k); global ℓ2.  With ``fused_aggregation`` all that
    follows the assignment BN is :func:`netvlad_aggregate` (the CUDA kernels
    on the card), which rounds A to the compute dtype before XᵀA; otherwise
    A stays f32 and the product is f32, as in the flax module.
    """

    def __init__(self, feature_size: int, cluster_size: int, add_batch_norm: bool = True,
                 fused_aggregation: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, k = feature_size, cluster_size
        self.feature_size, self.cluster_size = d, k
        self.fused_aggregation = fused_aggregation
        self.dtype = dtype
        self.cluster_weights = nn.Parameter(torch.zeros(d, k))
        if add_batch_norm:
            self.cluster_bn = BatchNorm(k)
        else:
            self.cluster_biases = nn.Parameter(torch.zeros(k))
        self.cluster_weights2 = nn.Parameter(torch.zeros(1, d, k))

    def forward(self, frames: torch.Tensor, training: bool = False) -> torch.Tensor:
        d, k = self.feature_size, self.cluster_size
        x = frames.to(self.dtype)
        activation = matmul_f32(x, self.cluster_weights.to(self.dtype))  # [B, F, K]
        if hasattr(self, "cluster_bn"):
            activation = self.cluster_bn(activation, training)
        else:
            activation = activation + self.cluster_biases
        if self.fused_aggregation:
            vlad = netvlad_aggregate(x, activation, self.cluster_weights2.reshape(d, k))
            return vlad.reshape(-1, d * k).to(self.dtype)
        a = torch.softmax(activation, dim=-1)
        a_sum = torch.sum(a, dim=1, keepdim=True)                        # [B, 1, K]
        vlad = torch.einsum("bfk,bfd->bdk", a, x.float()) - a_sum * self.cluster_weights2
        vlad = l2_normalize(vlad, dim=1)
        vlad = l2_normalize(vlad.reshape(-1, d * k), dim=1)
        return vlad.to(self.dtype)


class ContextGating(nn.Module):
    """x ⊙ σ(x·W (+b | BN)) (ref: models/modules.py#ContextGating)."""

    def __init__(self, dim: int, add_batch_norm: bool = True, remove_diag: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remove_diag = remove_diag
        self.dtype = dtype
        self.gating_weights = nn.Parameter(torch.zeros(dim, dim))
        if add_batch_norm:
            self.gating_bn = BatchNorm(dim)
        else:
            self.gating_biases = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        w = self.gating_weights.to(self.dtype)
        if self.remove_diag:
            w = w - torch.diag(torch.diag(w))
        gates = matmul_f32(x.to(self.dtype), w)
        if hasattr(self, "gating_bn"):
            gates = self.gating_bn(gates, training)
        else:
            gates = gates + self.gating_biases
        gates = torch.sigmoid(gates)
        return (x * gates.to(x.dtype)).to(self.dtype)
