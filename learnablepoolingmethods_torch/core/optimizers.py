"""Optimizers and the learning-rate schedule (ref: core/optimizers.py).

- :func:`clip_gradient_norms` clips each gradient tensor's norm on its own
  (``tf.clip_by_norm`` per tensor), not the global norm that
  ``torch.nn.utils.clip_grad_norm_`` takes.
- :func:`learning_rate_schedule` is ``optax.exponential_decay`` in steps:
  base · decay^(count / ⌊decay_examples / batch_size⌋), the first update at
  count 0.
- Each ``--optimizer`` is ``optax.chain(clip, <optax optimizer>(schedule))``
  as the JAX package builds it, with optax's arithmetic at its defaults, in
  f32 (the card's machine has no optax, so this is a copy):

  ==========================================  =================================================
  ``AdamOptimizer``                            ``optax.adam``: b1 0.9, b2 0.999, ε 1e-8 outside
                                               the root; ``--adam_bf16_momentum``: μ stored in
                                               bf16 (``mu_dtype=bfloat16``)
  ``AdagradOptimizer``                         ``optax.adagrad``: accumulator from 0.1, ε 1e-7
  ``RMSPropOptimizer``                         ``optax.rmsprop``: decay 0.9, ε 1e-8 inside the
                                               root, ν from 0, not centred
  ``GradientDescentOptimizer``, ``SgdOptimizer``  ``optax.sgd``
  ``MomentumOptimizer``                        ``optax.sgd(momentum=0.9)``: a trace, not Nesterov
  ``AdafactorOptimizer``                       ``optax.adafactor(min_dim_size_to_factor=128)``:
                                               decay 0.8, factored second moments where the two
                                               largest dims are ≥ 128, update clipped to RMS 1,
                                               times the parameter's RMS (at least 1e-3)
  ==========================================  =================================================

Every optimizer keeps its state as tensors named by their path in the JAX
package's ``opt_state`` (:meth:`Optimizer.state_tree`), so that a checkpoint
of the port and JAX's ``state_to_tree`` can be compared leaf by leaf: the
clip's ``EmptyState`` at chain position 0 when ``--clip_gradient_norm`` > 0,
then the optimizer's own chain, e.g. Adam's ``1/0/count``, ``1/0/mu/<param>``,
``1/0/nu/<param>`` (``ScaleByAdamState``) and ``1/1/count``
(``ScaleByScheduleState``).  ``<param>`` is the flax path of a parameter
(``NetVLAD_0/cluster_weights``).

``--bf16_params`` wraps the whole chain in :class:`Fp32Master` (the JAX
package's ``with_fp32_master``): the chain runs in f32 on an f32 master
copy, whose leaves are ``master/<param>`` and the chain's ``inner/…``.
``--fused_adam`` is ``ops/fused_adam.py#FusedAdam`` (Adam only): ``count``,
``m/<param>`` and ``nu/<param>``.

A parameter that holds this rank's columns of a matrix split over a model
group (``parallel/mesh.py#shard_model``) keeps state of its shape, and every
reduction over the whole tensor sums over the group: the clip's norm, and
Adafactor's row and column means, its update's RMS and the parameter's RMS.
:meth:`Optimizer.state_shards` says which state a checkpoint gathers.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from learnablepoolingmethods_torch.config import TrainingConfig
from learnablepoolingmethods_torch.parallel.collectives import ColumnShard, all_reduce_, column_shard, sum_sharded


def clip_gradient_norms(grads: Sequence[torch.Tensor], max_norm: float,
                        shards: Optional[Sequence[Optional[ColumnShard]]] = None) -> List[torch.Tensor]:
    """Per-tensor clip: g · min(1, max_norm / max(‖g‖, 1e-20)), ‖g‖ in f32;
    the Σg² of a gradient with a ``shards`` entry summed over its group."""
    sumsq = [torch.sum(torch.square(g.float())) for g in grads]
    if shards is not None and any(s is not None for s in shards):
        group = next(s.group for s in shards if s is not None)
        sumsq = sum_sharded(sumsq, [s is not None for s in shards], group)
    out = []
    for g, sq in zip(grads, sumsq):
        norm = torch.sqrt(sq)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-20), max=1.0)
        out.append((g * scale).to(g.dtype))
    return out


def global_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """The whole tensor's shape of a parameter or of its column shard."""
    shard = column_shard(p)
    return tuple(p.shape) if shard is None else tuple(p.shape[:-1]) + (shard.full,)


def _mean(t: torch.Tensor, dim: int, shard: Optional[ColumnShard], split_dim: Optional[int]) -> torch.Tensor:
    """torch.mean(t, dim), over the whole axis when ``dim`` is the axis
    ``split_dim`` that ``shard``'s group splits."""
    if shard is None or dim != split_dim:
        return torch.mean(t, dim=dim)
    return all_reduce_(torch.sum(t, dim=dim), shard.group) / shard.full


def _mean_all(t: torch.Tensor, shard: Optional[ColumnShard]) -> torch.Tensor:
    """torch.mean over every entry of the whole tensor."""
    if shard is None:
        return torch.mean(t)
    return all_reduce_(torch.sum(t), shard.group) / (t.numel() * shard.size)


def learning_rate_schedule(cfg: TrainingConfig) -> Callable[[int], float]:
    """lr(count) = base · decay^(count / transition_steps) in f32, with
    transition_steps = max(⌊decay_examples / batch_size⌋, 1)."""
    transition_steps = max(int(cfg.learning_rate_decay_examples / max(cfg.batch_size, 1)), 1)
    base = np.float32(cfg.base_learning_rate)
    decay = np.float32(cfg.learning_rate_decay)

    def schedule(count: int) -> float:
        if count <= 0:
            return float(base)
        return float(base * np.power(decay, np.float32(count) / np.float32(transition_steps)))

    return schedule


class Optimizer:
    """The clip and one optax optimizer on a list of named parameters.

    ``step(grads)`` applies one update to every parameter in place;
    ``updates(grads)`` returns the updates that ``tx.update`` would return
    without applying them (the state advances all the same).  Subclasses
    define ``_slots`` (per-parameter state: chain position/field → initial
    tensor of a parameter), ``_counts`` (the chain positions holding the
    update count) and ``_update``."""

    _counts: Tuple[str, ...] = ("1",)

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]], cfg: TrainingConfig):
        # bare tensors are named by their position
        named_params = [item if isinstance(item, tuple) else (str(i), item)
                        for i, item in enumerate(named_params)]
        self.names = [name.replace(".", "/") for name, _ in named_params]
        self.params = [p for _, p in named_params]
        self.shards = [column_shard(p) for p in self.params]
        self.clip_norm = cfg.clip_gradient_norm
        self.schedule = learning_rate_schedule(cfg)
        self.count = 0
        self.slots: Dict[str, List[torch.Tensor]] = {
            slot: [init(p) for p in self.params] for slot, init in self._slots().items()}

    def _slots(self) -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
        return {}

    def _update(self, i: int, p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
        raise NotImplementedError

    def slot_shard(self, slot: str, i: int) -> Optional[ColumnShard]:
        """The ColumnShard along the last axis of parameter i's state
        ``slot``, or None when the rank holds it whole: a slot of the
        parameter's shape is split as the parameter is."""
        return self.shards[i]

    def _each_update(self, grads):
        if self.clip_norm > 0:
            grads = clip_gradient_norms(grads, self.clip_norm, self.shards)
        lr = self.schedule(self.count)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            yield p, self._update(i, p, g.float(), lr)
        self.count += 1

    @torch.no_grad()
    def updates(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [u for _, u in self._each_update(grads)]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for p, u in self._each_update(grads):
            p.add_(u)

    def _prefix(self) -> str:
        return "1/" if self.clip_norm > 0 else "0/"

    def state_shards(self) -> Dict[str, ColumnShard]:
        """The leaves of :meth:`state_tree` that hold this rank's columns,
        with their ColumnShard."""
        prefix = self._prefix()
        return {f"{prefix}{slot}/{name}": self.slot_shard(slot, i)
                for slot in self.slots for i, name in enumerate(self.names)
                if self.slot_shard(slot, i) is not None}

    def state_tree(self) -> Dict[str, torch.Tensor]:
        """Every state leaf under its path in the JAX ``opt_state`` (module
        docstring): the counts as int32 scalars, then the slots."""
        prefix = self._prefix()
        tree = {f"{prefix}{pos}/count": torch.tensor(self.count, dtype=torch.int32)
                for pos in self._counts}
        for slot, tensors in self.slots.items():
            for name, t in zip(self.names, tensors):
                tree[f"{prefix}{slot}/{name}"] = t
        return tree

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, torch.Tensor]) -> None:
        """Take the state of :meth:`state_tree`'s names from ``tree`` (the
        slots copied in place)."""
        prefix = self._prefix()
        counts = {int(tree[f"{prefix}{pos}/count"]) for pos in self._counts}
        if len(counts) != 1:
            raise ValueError(f"the optimizer's counts disagree: {sorted(counts)}")
        self.count = counts.pop()
        for slot, tensors in self.slots.items():
            for name, t in zip(self.names, tensors):
                t.copy_(tree[f"{prefix}{slot}/{name}"])


class Adam(Optimizer):
    """``optax.adam``: μ ← (1−b1)·g + b1·μ; ν ← (1−b2)·g² + b2·ν;
    u = −lr(count) · μ̂ / (√ν̂ + ε), μ̂ = μ / (1 − b1^(count+1)), ν̂ likewise.
    With ``mu_dtype`` bf16 (``--adam_bf16_momentum``) μ is stored in bf16:
    the new μ is formed in f32 as the JAX package's jitted step forms it,
    used in f32, then stored rounded."""

    b1, b2, eps = 0.9, 0.999, 1e-8
    _counts = ("0", "1")

    def __init__(self, named_params, cfg: TrainingConfig, mu_dtype: torch.dtype = torch.float32):
        self.mu_dtype = mu_dtype
        super().__init__(named_params, cfg)

    def _slots(self):
        return {"0/mu": lambda p: torch.zeros_like(p, dtype=self.mu_dtype),
                "0/nu": torch.zeros_like}

    def _each_update(self, grads):
        count = np.float32(self.count + 1)
        self._c1 = float(np.float32(1) - np.float32(self.b1) ** count)
        self._c2 = float(np.float32(1) - np.float32(self.b2) ** count)
        return super()._each_update(grads)

    def _update(self, i, p, g, lr):
        mu, nu = self.slots["0/mu"][i], self.slots["0/nu"][i]
        if mu.dtype == torch.float32:
            mu_f = mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
        else:
            # XLA's jitted update: b1 as a bf16 constant times the widened μ
            # (exact in f32), then one fused multiply-add with (1 − b1)·g,
            # here in f64 and rounded once
            b1 = float(torch.tensor(self.b1, dtype=mu.dtype))
            mu_f = (g.double() * float(np.float32(1 - self.b1)) + (mu.float() * b1).double()).float()
            mu.copy_(mu_f)
        nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
        update = (mu_f / self._c1) / (torch.sqrt(nu / self._c2) + self.eps)
        return update * -lr


class Adagrad(Optimizer):
    """``optax.adagrad``: s ← g² + s (s from 0.1); u = −lr · g / √(s + ε)
    where s > 0, else 0."""

    initial_accumulator_value, eps = 0.1, 1e-7

    def _slots(self):
        return {"0/sum_of_squares": lambda p: torch.full_like(p, self.initial_accumulator_value)}

    def _update(self, i, p, g, lr):
        s = self.slots["0/sum_of_squares"][i]
        s.add_(g * g)
        inv = torch.where(s > 0, torch.rsqrt(s + self.eps), torch.zeros_like(s))
        return inv * g * -lr


class RMSProp(Optimizer):
    """``optax.rmsprop``: ν ← (1−decay)·g² + decay·ν (ν from 0);
    u = −lr · g / √(ν + ε)."""

    decay, eps = 0.9, 1e-8

    def _slots(self):
        return {"0/nu": torch.zeros_like}

    def _update(self, i, p, g, lr):
        nu = self.slots["0/nu"][i]
        nu.mul_(self.decay).add_(g * g, alpha=1 - self.decay)
        return torch.rsqrt(nu + self.eps) * g * -lr


class SGD(Optimizer):
    """``optax.sgd``: u = −lr · g."""

    def _update(self, i, p, g, lr):
        return g * -lr


class Momentum(Optimizer):
    """``optax.sgd(momentum=0.9)``: t ← g + 0.9·t; u = −lr · t."""

    momentum = 0.9

    def _slots(self):
        return {"0/trace": torch.zeros_like}

    def _update(self, i, p, g, lr):
        t = self.slots["0/trace"][i]
        t.mul_(self.momentum).add_(g)
        return t * -lr


def factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax's ``_factored_dims``: (second-largest dim, largest dim) of a
    tensor of two or more dims whose second-largest is at least
    ``min_dim_size_to_factor``, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(Optimizer):
    """``optax.adafactor(lr, min_dim_size_to_factor=128)``, optax's defaults
    otherwise.  With ρ = 1 − (count+1)^−0.8 and G = g² + 1e-30: a factored
    leaf keeps row and column means, v_r ← ρ·v_r + (1−ρ)·mean(G, d0) and
    v_c ← ρ·v_c + (1−ρ)·mean(G, d1), and scales g by (v_r / mean(v_r))^−½
    and v_c^−½; any other keeps v ← ρ·v + (1−ρ)·G and scales g by v^−½.
    Then u ← u / max(1, RMS(u)); u ← lr·u; u ← u · max(RMS(p), 1e-3);
    u ← −u.  Unused slots hold zeros of shape (1,), as optax's do."""

    decay_rate, eps, min_dim_size_to_factor = 0.8, 1e-30, 128
    clipping_threshold, min_scale = 1.0, 1e-3
    _counts = ("0", "2")

    def _slots(self):
        def shape_of(slot):
            def init(p):
                shape = global_shape(p)
                dims = factored_dims(shape, self.min_dim_size_to_factor)
                if dims is None:
                    shape = tuple(p.shape) if slot == "v" else (1,)
                elif slot == "v":
                    shape = (1,)
                else:  # v_row drops the largest dim, v_col the second largest
                    drop = dims[1] if slot == "v_row" else dims[0]
                    shape = tuple(n for d, n in enumerate(p.shape) if d != drop)
                return torch.zeros(shape, dtype=p.dtype, device=p.device)
            return init

        return {f"0/{slot}": shape_of(slot) for slot in ("v_row", "v_col", "v")}

    def slot_shard(self, slot, i):
        """v of an unfactored leaf is split as its parameter; v_row and v_col
        are split while they keep the parameter's split last axis."""
        shard = self.shards[i]
        if shard is None:
            return None
        p = self.params[i]
        dims = factored_dims(global_shape(p), self.min_dim_size_to_factor)
        last = p.dim() - 1
        if dims is None:
            return shard if slot == "0/v" else None
        if slot == "0/v":
            return None
        return shard if (dims[1] if slot == "0/v_row" else dims[0]) != last else None

    def _update(self, i, p, g, lr):
        t = np.float32(self.count + 1)
        rho = np.float32(1.0) - t ** np.float32(-self.decay_rate)
        one_minus = float(np.float32(1.0) - rho)
        rho = float(rho)
        grad_sqr = g * g + self.eps
        shard = self.shards[i]
        last = p.dim() - 1
        dims = factored_dims(global_shape(p), self.min_dim_size_to_factor)
        if dims is not None:
            d1, d0 = dims
            v_row, v_col = self.slots["0/v_row"][i], self.slots["0/v_col"][i]
            v_row.copy_(rho * v_row + one_minus * _mean(grad_sqr, d0, shard, last))
            v_col.copy_(rho * v_col + one_minus * _mean(grad_sqr, d1, shard, last))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            # v_row lost d0: the split axis is its last unless d0 was
            row_split = last - 1 if d0 != last else None
            if shard is None or reduced_d1 != row_split:
                row_mean = v_row.mean(dim=reduced_d1, keepdim=True)
            else:
                row_mean = all_reduce_(torch.sum(v_row, dim=reduced_d1, keepdim=True), shard.group) / shard.full
            row_factor = (v_row / row_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        else:
            v = self.slots["0/v"][i]
            v.copy_(rho * v + one_minus * grad_sqr)
            u = g * v ** -0.5
        u = u / torch.clamp(torch.sqrt(_mean_all(u * u, shard)) / self.clipping_threshold, min=1.0)
        u = lr * u
        rms = torch.sqrt(_mean_all(torch.square(p.float()), shard))
        u = u * torch.where(rms <= self.min_scale, torch.full_like(rms, self.min_scale), rms)
        return -1 * u


class Fp32Master:
    """``with_fp32_master(chain)``: bf16 parameters, an f32 master copy.
    Each step widens the gradients to f32, runs ``inner`` (the clip and the
    optimizer, built on the master tensors) on the master, adds its update
    to the master in f32, and stores bf16(f32(p) + (master − f32(p))) in each
    parameter: what optax's ``apply_updates`` does with the delta that
    ``with_fp32_master`` returns (not bf16(master): the two differ by the f32
    rounding of the subtraction and can land on different bf16 neighbours)."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]], cfg: TrainingConfig,
                 inner: Callable[[Sequence[Tuple[str, torch.Tensor]]], Optimizer]):
        named_params = [item if isinstance(item, tuple) else (str(i), item)
                        for i, item in enumerate(named_params)]
        self.names = [name.replace(".", "/") for name, _ in named_params]
        self.params = [p for _, p in named_params]
        self.master = [p.detach().float().clone() for p in self.params]
        for p, m in zip(self.params, self.master):
            if column_shard(p) is not None:
                m.column_shard = column_shard(p)
        self.inner = inner(list(zip(self.names, self.master)))

    def state_shards(self) -> Dict[str, ColumnShard]:
        """``master/<param>`` is split as its parameter, ``inner/…`` as the
        chain's state."""
        out = {f"master/{name}": column_shard(p) for name, p in zip(self.names, self.params)
               if column_shard(p) is not None}
        out.update({f"inner/{name}": shard for name, shard in self.inner.state_shards().items()})
        return out

    @property
    def count(self) -> int:
        return self.inner.count

    def _apply(self) -> None:
        for p, m in zip(self.params, self.master):
            p32 = p.detach().float()
            p.data.copy_((p32 + (m - p32)).to(p.dtype))

    @torch.no_grad()
    def updates(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The deltas ``with_fp32_master`` returns (master + u − f32(p)), the
        master advanced; the parameters are left as they are."""
        self.inner.step([g.float() for g in grads])
        return [m - p.detach().float() for p, m in zip(self.params, self.master)]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.inner.step([g.float() for g in grads])
        self._apply()

    def state_tree(self) -> Dict[str, torch.Tensor]:
        tree = {f"master/{name}": m for name, m in zip(self.names, self.master)}
        tree.update({f"inner/{name}": t for name, t in self.inner.state_tree().items()})
        return tree

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, torch.Tensor]) -> None:
        for name, m in zip(self.names, self.master):
            m.copy_(tree[f"master/{name}"])
        self.inner.load_state_tree({name[len("inner/"):]: t for name, t in tree.items()
                                    if name.startswith("inner/")})


OPTIMIZERS = {
    "AdamOptimizer": Adam,
    "AdagradOptimizer": Adagrad,
    "RMSPropOptimizer": RMSProp,
    "GradientDescentOptimizer": SGD,
    "SgdOptimizer": SGD,
    "MomentumOptimizer": Momentum,
    "AdafactorOptimizer": Adafactor,
}


def create_optimizer(named_params: Sequence[Tuple[str, torch.Tensor]], cfg: TrainingConfig):
    """The optimizer of ``cfg.optimizer`` on ``named_params``: ``(name,
    parameter)`` pairs, e.g. ``model.named_parameters()``, or bare tensors;
    a FusedAdam under ``cfg.fused_adam`` (which needs Adam), else the chain,
    wrapped in :class:`Fp32Master` under ``cfg.fp32_master``."""
    try:
        cls = OPTIMIZERS[cfg.optimizer]
    except KeyError:
        raise ValueError(f"Unknown optimizer {cfg.optimizer!r}. Known: {sorted(OPTIMIZERS)}") from None
    if cfg.fused_adam:
        if cfg.optimizer != "AdamOptimizer":
            raise ValueError("--fused_adam requires --optimizer=AdamOptimizer")
        from learnablepoolingmethods_torch.ops.fused_adam import FusedAdam

        return FusedAdam(named_params, cfg)

    def chain(named):
        if cls is Adam and cfg.adam_bf16_momentum:
            return Adam(named, cfg, mu_dtype=torch.bfloat16)
        return cls(named, cfg)

    if cfg.fp32_master:
        return Fp32Master(named_params, cfg, chain)
    return chain(named_params)
