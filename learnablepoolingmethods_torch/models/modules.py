"""Learnable pooling modules (ref: models/modules.py): the flax-compatible
BatchNorm, the LOUPE pooling modules (NetVLAD, NetRVLAD, NetFV, SoftDBoW),
NeXtVLAD and context gating.

Parameter and statistic names follow the flax tree, so a module's
``state_dict`` key ``NetVLAD_0.cluster_bn.scale`` is the flax path
``params/NetVLAD_0/cluster_bn/scale`` (``core/weights.py`` converts).
Matrix products take operands in the compute dtype and sum in f32, as
``preferred_element_type=float32`` does (:func:`matmul_f32`).

On a mesh (``parallel/mesh.py#shard_model``) a parameter may hold only this
rank's columns: a product with it is column-parallel
(:func:`matmul_param`), any other use reads the whole matrix
(``parallel/collectives.py#full_param``), and a BatchNorm in training takes
its statistics over the data group's rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from learnablepoolingmethods_torch.ops.fast_infer import matmul_f32_local as _mm_f32
from learnablepoolingmethods_torch.ops.netvlad_train import netvlad_aggregate
from learnablepoolingmethods_torch.ops.normalize import l2_normalize
from learnablepoolingmethods_torch.parallel.collectives import (
    all_reduce_,
    all_reduce_sum,
    column_shard,
    full_param,
    gather_last,
)

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


class _ColumnParallelMatmul(torch.autograd.Function):
    """2-D ``a @ b`` for ``b`` this rank's columns of a matrix split over its
    model group: the f32 product of the shard, all-gathered along the
    columns.  The backward takes this rank's columns of the cotangent g: db
    = aᵀ·g_shard, and da = g_shard·bᵀ summed in f32 over the group before it
    is cast to a's dtype (the ranks' partial sums of g·Bᵀ)."""

    @staticmethod
    def forward(ctx, a, b, shard):
        ctx.save_for_backward(a, b)
        ctx.shard = shard
        return gather_last(_mm_f32(a, b), shard.group)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g[:, ctx.shard.columns].contiguous()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = all_reduce_(_mm(g, b.t(), b.dtype).float(), ctx.shard.group).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _mm(a.t(), g, a.dtype).to(b.dtype)
        return ga, gb, None


def matmul_param(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """:func:`matmul_f32` of ``x`` and the parameter ``w`` cast to ``dtype``;
    column-parallel when ``w`` holds this rank's columns of a split matrix,
    whose output is then the whole product."""
    shard = column_shard(w)
    if shard is None:
        return matmul_f32(x, w.to(dtype))
    lead = x.shape[:-1]
    out = _ColumnParallelMatmul.apply(x.reshape(-1, x.shape[-1]), w.to(dtype), shard)
    return out.reshape(*lead, shard.full)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the last axis, in f32.

    - statistics over every axis but the last (the B·F rows of ``[B, F, K]``);
    - the fast variance ``max(0, E[x²] − E[x]²)``, which is biased;
    - running averages ``m·avg + (1 − m)·batch`` with flax's momentum
      (0.999 here is torch's momentum 0.001), updated in place in training
      unless ``update_stats`` is off (``core/step.py#batch_stats_frozen``,
      the recompute of ``--use_remat``);
    - ``y = (x − μ)·(rsqrt(σ² + ε)·scale) + bias`` with ε = 1e-3.

    With a ``data_group`` (``parallel/mesh.py#shard_model``) the statistics
    are Σx and Σx² over the group's rows, padded rows included, divided by
    their count: the global batch's, as flax takes them under GSPMD.
    """

    def __init__(self, features: int, momentum: float = BN_MOMENTUM, epsilon: float = BN_EPSILON):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.update_stats = True
        self.data_group = None

    def forward(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        x = x.float()
        if training:
            axes = tuple(range(x.dim() - 1))
            if self.data_group is None:
                mean, mean_sq = torch.mean(x, dim=axes), torch.mean(x * x, dim=axes)
            else:
                sums = all_reduce_sum(torch.stack([torch.sum(x, dim=axes), torch.sum(x * x, dim=axes)]),
                                      self.data_group)
                # every rank of the group holds as many rows
                count = float(x.numel() // x.shape[-1] * dist.get_world_size(self.data_group))
                mean, mean_sq = sums[0] / count, sums[1] / count
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                    self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean) * mul + self.bias


class _AssignmentBase(nn.Module):
    """The shared front of the LOUPE pooling modules: ``cluster_weights``
    [D, K] and the assignment logits X·C summed in f32, then ``cluster_bn``
    (or ``cluster_biases`` without BN)."""

    def __init__(self, feature_size: int, cluster_size: int, add_batch_norm: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.feature_size, self.cluster_size = feature_size, cluster_size
        self.dtype = dtype
        self.cluster_weights = nn.Parameter(torch.zeros(feature_size, cluster_size))
        if add_batch_norm:
            self.cluster_bn = BatchNorm(cluster_size)
        else:
            self.cluster_biases = nn.Parameter(torch.zeros(cluster_size))

    def _logits(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        activation = matmul_param(x, self.cluster_weights, self.dtype)
        if hasattr(self, "cluster_bn"):
            return self.cluster_bn(activation, training)
        return activation + self.cluster_biases


class NetVLAD(_AssignmentBase):
    """NetVLAD aggregation (ref: models/modules.py#NetVLAD) → ``[B, D·K]``.

    A = softmax(BN(X·C)); V = XᵀA − (Σ_F A)⊙C₂; intra-ℓ2 over D; the d-major
    flatten (index d·K + k); global ℓ2.  With ``fused_aggregation`` all that
    follows the assignment BN is :func:`netvlad_aggregate` (the CUDA kernels
    on the card), which rounds A to the compute dtype before XᵀA; otherwise
    A stays f32 and the product is f32, as in the flax module.
    """

    def __init__(self, feature_size: int, cluster_size: int, add_batch_norm: bool = True,
                 fused_aggregation: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(feature_size, cluster_size, add_batch_norm, dtype)
        self.fused_aggregation = fused_aggregation
        self.cluster_weights2 = nn.Parameter(torch.zeros(1, feature_size, cluster_size))

    def forward(self, frames: torch.Tensor, training: bool = False) -> torch.Tensor:
        d, k = self.feature_size, self.cluster_size
        x = frames.to(self.dtype)
        activation = self._logits(x, training)                          # [B, F, K]
        if self.fused_aggregation:
            c2 = self.cluster_weights2
            if c2.dtype != torch.float32 and torch.is_grad_enabled():
                # JAX's custom VJP hands back dC₂ in f32 against a bf16 C₂,
                # and jax.grad keeps it f32; the step reads the gradient here
                c2 = c2.float()
                self.f32_gradient_taps = {"cluster_weights2": c2}
                if column_shard(self.cluster_weights2) is not None:
                    c2.column_shard = column_shard(self.cluster_weights2)
            vlad = netvlad_aggregate(x, activation, full_param(c2).reshape(d, k))
            return vlad.reshape(-1, d * k).to(self.dtype)
        a = torch.softmax(activation, dim=-1)
        a_sum = torch.sum(a, dim=1, keepdim=True)                        # [B, 1, K]
        vlad = torch.einsum("bfk,bfd->bdk", a, x.float()) - a_sum * full_param(self.cluster_weights2)
        vlad = l2_normalize(vlad, dim=1)
        vlad = l2_normalize(vlad.reshape(-1, d * k), dim=1)
        return vlad.to(self.dtype)


class NetRVLAD(_AssignmentBase):
    """NetVLAD without the learned centres (ref: models/modules.py#NetRVLAD)
    → ``[B, D·K]``: V = XᵀA, intra-ℓ2 over D, d-major flatten, global ℓ2.
    With ``fused_aggregation`` the aggregation is :func:`netvlad_aggregate`
    with C₂ = 0."""

    def __init__(self, feature_size: int, cluster_size: int, add_batch_norm: bool = True,
                 fused_aggregation: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(feature_size, cluster_size, add_batch_norm, dtype)
        self.fused_aggregation = fused_aggregation

    def forward(self, frames: torch.Tensor, training: bool = False) -> torch.Tensor:
        d, k = self.feature_size, self.cluster_size
        x = frames.to(self.dtype)
        activation = self._logits(x, training)
        if self.fused_aggregation:
            zeros = torch.zeros(d, k, dtype=torch.float32, device=x.device)
            return netvlad_aggregate(x, activation, zeros).reshape(-1, d * k).to(self.dtype)
        a = torch.softmax(activation, dim=-1)
        vlad = l2_normalize(torch.einsum("bfk,bfd->bdk", a, x.float()), dim=1)
        return l2_normalize(vlad.reshape(-1, d * k), dim=1).to(self.dtype)


class NetFV(_AssignmentBase):
    """Net Fisher Vector (ref: models/modules.py#NetFV) → ``[B, 2·D·K]``.

    σ² = (``covar_weights``, or ``coupling_factor``·C with
    ``couple_weights``)² + 1e-6; fv1 = (XᵀA − a_sum⊙C₂)/σ² and
    fv2 = (a_sum⊙C₂² + (X²)ᵀA − 2·(XᵀA)⊙C₂)/σ⁴ − a_sum, each intra-ℓ2 over
    D, flattened d-major and globally ℓ2-normalised, then concatenated.
    ``covar_weights`` exists whether or not it is used, as in flax."""

    def __init__(self, feature_size: int, cluster_size: int, add_batch_norm: bool = True,
                 couple_weights: bool = False, coupling_factor: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__(feature_size, cluster_size, add_batch_norm, dtype)
        self.couple_weights, self.coupling_factor = couple_weights, coupling_factor
        self.covar_weights = nn.Parameter(torch.zeros(feature_size, cluster_size))
        self.cluster_weights2 = nn.Parameter(torch.zeros(1, feature_size, cluster_size))

    def forward(self, frames: torch.Tensor, training: bool = False) -> torch.Tensor:
        d, k = self.feature_size, self.cluster_size
        x = frames.to(self.dtype)
        covar = (self.coupling_factor * full_param(self.cluster_weights) if self.couple_weights
                 else full_param(self.covar_weights))
        covar = torch.square(covar).float() + 1e-6
        a = torch.softmax(self._logits(x, training), dim=-1)            # [B, F, K]
        a_sum = torch.sum(a, dim=1, keepdim=True)                        # [B, 1, K]
        cw2 = full_param(self.cluster_weights2).float()
        fv1 = torch.einsum("bfk,bfd->bdk", a, x.float())
        fv2 = torch.einsum("bfk,bfd->bdk", a, torch.square(x).float())  # X² rounded in x's dtype
        fv2 = (a_sum * torch.square(cw2) + fv2 - 2.0 * (fv1 * cw2)) / torch.square(covar) - a_sum
        fv2 = l2_normalize(l2_normalize(fv2, dim=1).reshape(-1, d * k), dim=1)
        fv1 = (fv1 - a_sum * cw2) / covar
        fv1 = l2_normalize(l2_normalize(fv1, dim=1).reshape(-1, d * k), dim=1)
        return torch.cat([fv1, fv2], dim=1).to(self.dtype)


class SoftDBoW(_AssignmentBase):
    """Soft bag of words (ref: models/modules.py#SoftDBoW) → ``[B, K]``:
    the ℓ2-normalised sum over frames of the soft assignment."""

    def forward(self, frames: torch.Tensor, training: bool = False) -> torch.Tensor:
        a = torch.softmax(self._logits(frames.to(self.dtype), training), dim=-1)
        return l2_normalize(torch.sum(a, dim=1), dim=1).to(self.dtype)


class NeXtVLAD(nn.Module):
    """NeXtVLAD (ref: models/modules.py#NeXtVLAD; Lin et al. 2018) →
    ``[B, K·D′]`` with D′ = λD/G.

    x̃ = X·W_e [B, F, λD]; α = σ(x̃·W_g) [B, F, G]; a = softmax over K of
    BN(x̃·W_a) [B, F, G, K] times α; v[k, d′] = Σ_{f,g} a·x̂[f, g, d′] −
    (Σ_{f,g} a)·C₂[k, d′] with x̂ = x̃ as [B, F, G, D′]; intra-ℓ2 over d′,
    flatten k-major, ``vlad_bn``.  Without BN neither BN exists and no bias
    takes its place, as in flax."""

    def __init__(self, feature_size: int, cluster_size: int, groups: int = 8, expansion: int = 2,
                 add_batch_norm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        lam_d = expansion * feature_size
        if groups < 1:
            raise ValueError(f"NeXtVLAD groups must be >= 1, got {groups}")
        if lam_d % groups:
            raise ValueError(f"NeXtVLAD groups ({groups}) must divide expansion·D ({lam_d})")
        self.groups, self.cluster_size, self.group_dim = groups, cluster_size, lam_d // groups
        self.dtype = dtype
        self.expansion_weights = nn.Parameter(torch.zeros(feature_size, lam_d))
        self.group_attention_weights = nn.Parameter(torch.zeros(lam_d, groups))
        self.cluster_weights = nn.Parameter(torch.zeros(lam_d, groups * cluster_size))
        if add_batch_norm:
            self.cluster_bn = BatchNorm(groups * cluster_size)
        self.cluster_weights2 = nn.Parameter(torch.zeros(cluster_size, self.group_dim))
        if add_batch_norm:
            self.vlad_bn = BatchNorm(cluster_size * self.group_dim)

    def forward(self, frames: torch.Tensor, training: bool = False) -> torch.Tensor:
        b, f, _ = frames.shape
        g, k, dp, dtype = self.groups, self.cluster_size, self.group_dim, self.dtype
        xt = matmul_param(frames.to(dtype), self.expansion_weights, dtype)           # [B, F, λD]
        alpha = torch.sigmoid(matmul_param(xt.to(dtype), self.group_attention_weights, dtype))
        logits = matmul_param(xt.to(dtype), self.cluster_weights, dtype)            # [B, F, G·K]
        if hasattr(self, "cluster_bn"):
            logits = self.cluster_bn(logits, training)
        assign = torch.softmax(logits.reshape(b, f, g, k), dim=-1) * alpha[..., None]
        agg = torch.einsum("bfgk,bfgd->bkd", assign, xt.reshape(b, f, g, dp))
        a_sum = torch.sum(assign, dim=(1, 2))                                        # [B, K]
        vlad = agg - a_sum[:, :, None] * full_param(self.cluster_weights2).float()[None]
        vlad = l2_normalize(vlad, dim=-1).reshape(b, k * dp)
        if hasattr(self, "vlad_bn"):
            vlad = self.vlad_bn(vlad, training)
        return vlad.to(dtype)


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
        if self.remove_diag:
            w = full_param(self.gating_weights).to(self.dtype)
            gates = matmul_f32(x.to(self.dtype), w - torch.diag(torch.diag(w)))
        else:
            gates = matmul_param(x.to(self.dtype), self.gating_weights, self.dtype)
        if hasattr(self, "gating_bn"):
            gates = self.gating_bn(gates, training)
        else:
            gates = gates + self.gating_biases
        gates = torch.sigmoid(gates)
        return (x * gates.to(x.dtype)).to(self.dtype)
