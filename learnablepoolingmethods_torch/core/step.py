"""The train, eval and predict steps (ref: core/step.py#make_train_step,
#make_eval_step and #make_predict_step).

uint8 frames → sampled frames (gathered in uint8) → dequantize →
ℓ2-normalize → model forward in training mode (BN statistics updated in
place) → weighted label loss + penalty · L2 over the head kernels →
gradients → per-tensor clip → the optimizer (``core/optimizers.py``).

``--grad_accum_steps`` N > 1 splits the batch into N microbatches, run one
after the other as the JAX step unrolls them: microbatch i samples from
``fold_in(sampling_key, i)`` (under ``--presample_frames`` inside the
loop) and drops from ``fold_in(dropout_key, i)``, its BN statistics follow
the previous microbatch's, its loss is Σ(w·ℓ)/W_total, and its gradient,
taken by ``torch.autograd.grad`` before the next forward starts (so no
graph outlives its backward), is summed in f32; the params-only L2 is
differentiated once, after the loop; the sum is cast back to the dtype a
single pass gives each gradient.
``--use_remat`` recomputes the whole forward, BN included, in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint``); the recompute leaves
the BN statistics alone, so they move once a step, and draws the same
dropout masks from the same key.

Frames are sampled as the JAX step samples them, so both packages pick the
same frames from the same seed: ``fold_in(key, step)`` → ``split`` → the
first key, ``sampling_key``.  The second, ``dropout_key``, is the flax
model's ``rngs={"dropout": ...}``: a model with ``takes_dropout_key`` (the
transformer family) gets it in training and draws flax's masks from it
(``models/attention.py``).

- Under ``--presample_frames`` (frame-level input) the JAX step draws iid
  frames, floor(U·nf) per sample (``models/model_utils.py#sample_frame_features``),
  from ``sampling_key`` for every model: FrameLevelLogisticModel then
  averages those ``--iterations`` rows over its original ``num_frames``,
  and the draw is iid even under ``--nosample_random_frames``.  The port
  does the same.
- Without it only a sampling model (``samples_frames``) draws, inside its
  forward, from ``make_rng("sampling")``, the key flax derives from
  ``sampling_key`` (``utils/prng.py#flax_make_rng``): iid frames, or one
  random window a video with ``--nosample_random_frames``
  (``models/model_utils.py#sample_random_sequence``).  Other models see
  every frame.

The port gathers a sampling model's uint8 rows in the step and builds the
model ``presampled``, which is exact: dequantize and ℓ2 are per frame and
the BN runs after sampling.  Video-level input is never sampled.

On a mesh (``TrainStep(..., mesh=...)``, ``parallel/mesh.py``) the batch
holds this rank's rows of the global batch (``parallel/mesh.py#local_batch``)
and the step computes the single-device step of the global batch:

- the loss divides Σ(w·ℓ) by the global Σw (clamped to at least 1);
- the model's BatchNorms take their statistics over the data group;
- frames are drawn over the global batch's shape, this rank's rows of the
  draw (``row_offset``), and so are the transformers' dropout masks;
- the gradients are summed in f32 over the data group before the
  per-tensor clip, and the regularization term enters the gradient on the
  ranks of data index 0 only, so it counts once;
- the reported loss is the global one.

The eval and predict steps run the model with ``training=False`` (no
dropout).  The JAX CLIs give the flax model ``rngs={"sampling":
fold_in(key(0), batch)}``, so a sampling model draws from
``flax_make_rng(fold_in(key(0), batch))``;
the port's steps gather those frames in uint8 too, from a model built
``presampled``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from learnablepoolingmethods_torch.config import ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.losses import BaseLoss
from learnablepoolingmethods_torch.models.base import compute_dtype
from learnablepoolingmethods_torch.models.model_utils import sample_frame_features, sample_model_input
from learnablepoolingmethods_torch.ops.metrics_ops import batch_topk_partials
from learnablepoolingmethods_torch.ops.normalize import l2_normalize
from learnablepoolingmethods_torch.ops.topk import top_k_exact
from learnablepoolingmethods_torch.parallel.collectives import all_reduce_, column_shard
from learnablepoolingmethods_torch.utils import prng
from learnablepoolingmethods_torch.utils.quantization import dequantize

_HEAD_KERNEL_NAMES = ("gates_kernel", "experts_kernel")


def preprocess_input(features: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(uint8 → dequantize) → ℓ2-normalize the last axis, in ``dtype``."""
    x = dequantize(features, dtype=dtype) if features.dtype == torch.uint8 else features.to(dtype)
    return l2_normalize(x, dim=-1)


def regularization_loss(
    named_params: Iterable[Tuple[str, torch.Tensor]],
    l2_penalty: float,
    all_kernels: bool = False,
    moe_l2: Optional[float] = None,
) -> torch.Tensor:
    """Slim-style L2, penalty · ½·Σ‖w‖², over the classifier-head kernels
    (the MoE gates and experts kernels at ``moe_l2``, a ``fc`` kernel at
    ``l2_penalty``), or every matrix with ``all_kernels``.  The ‖w‖² of a
    column shard is the whole matrix's (its group's sum), and its gradient
    is this rank's columns' own."""
    moe_l2 = l2_penalty if moe_l2 is None else moe_l2
    sq = 0.0
    if l2_penalty > 0 or moe_l2 > 0:
        for name, p in named_params:
            keys = name.split(".")
            if p.dim() < 2:
                continue
            if keys[-1] in _HEAD_KERNEL_NAMES:
                penalty = moe_l2
            elif all_kernels or keys[-2:] == ["fc", "kernel"]:
                penalty = l2_penalty
            else:
                continue
            norm_sq = torch.sum(torch.square(p.float()))
            shard = column_shard(p)
            if shard is not None:
                norm_sq = norm_sq + (all_reduce_(norm_sq.detach().clone(), shard.group) - norm_sq.detach())
            sq = sq + penalty * norm_sq
    return 0.5 * torch.as_tensor(sq, dtype=torch.float32)


def weighted_mean(per_example: torch.Tensor, weights: torch.Tensor,
                  total_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ(w·ℓ) / max(Σw, 1); with ``total_weight``, the global batch's Σw
    in place of these rows' (a rank's share of the global mean)."""
    w = weights.float()
    total = torch.sum(w) if total_weight is None else total_weight
    return torch.sum(per_example.float() * w) / torch.clamp(total, min=1.0)


def all_reduce_gradients(grads: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Σ of each gradient over ``group``, in f32 in one all-reduce, cast back
    to each gradient's dtype."""
    if group is None:
        return grads
    flat = all_reduce_(torch.cat([g.reshape(-1).float() for g in grads]), group)
    out, start = [], 0
    for g in grads:
        out.append(flat[start:start + g.numel()].reshape(g.shape).to(g.dtype))
        start += g.numel()
    return out


def gradient_taps(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The f32 tensors that the last training forward registered in place
    of a bf16 parameter whose gradient JAX keeps in f32 (``cluster_weights2``
    through the fused NetVLAD aggregation), by parameter name; cleared."""
    taps = {}
    for prefix, module in model.named_modules():
        for name, tap in getattr(module, "f32_gradient_taps", {}).items():
            taps[f"{prefix}.{name}" if prefix else name] = tap
        if hasattr(module, "f32_gradient_taps"):
            module.f32_gradient_taps = {}
    return taps


def gradients(total: torch.Tensor, model: torch.nn.Module) -> List[torch.Tensor]:
    """d total / d each parameter, in ``model.parameters()`` order, each in
    its parameter's dtype except where :func:`gradient_taps` gives f32;
    zeros for a parameter the forward does not read (NetFV's
    ``covar_weights`` under ``--fv_couple_weights``), as ``jax.grad``
    gives."""
    named = list(model.named_parameters())
    taps = gradient_taps(model)
    inputs = [taps.get(name, p) for name, p in named]
    grads = torch.autograd.grad(total, inputs, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g.reshape(p.shape) for (_, p), g in zip(named, grads)]


@contextlib.contextmanager
def batch_stats_frozen(model: torch.nn.Module, frozen: bool = True):
    """The model's BatchNorm layers leave their running statistics alone
    inside (the forward is unchanged otherwise)."""
    bns = [m for m in model.modules() if hasattr(m, "update_stats")]
    for m in bns:
        m.update_stats = not frozen
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class TrainStep:
    """``step(state, batch, key) -> metrics``: one train step (ref:
    core/step.py#make_train_step), single pass or over
    ``tcfg.grad_accum_steps`` microbatches (module docstring).

    ``batch`` holds tensors on the model's device: ``features`` (uint8
    ``[B, F, D]`` frames, or ``[B, D]`` video-level features),
    ``num_frames`` (frame-level), ``labels`` and optionally ``weights``.
    For a single pass, ``loss`` (the forward) and ``state.apply_gradients``
    (the update) are separate methods so that each stage can be timed.  A
    sampling model must be built ``presampled``: the step gathers its
    frames."""

    def __init__(self, loss_obj: BaseLoss, tcfg: TrainingConfig, mcfg: ModelConfig,
                 frame_features: bool, mesh=None):
        self.loss_obj, self.tcfg, self.mcfg = loss_obj, tcfg, mcfg
        self.frame_features = frame_features
        self.dtype = compute_dtype(mcfg)
        self.accum = max(1, int(tcfg.grad_accum_steps))
        self.mesh = mesh
        self.data_group = None if mesh is None else mesh.data_group

    def _row_offset(self, rows: int) -> int:
        return 0 if self.mesh is None else self.mesh.row_offset(rows)

    def _total_weight(self, weights: torch.Tensor) -> Optional[torch.Tensor]:
        """The global batch's Σw on a mesh of more than one row block."""
        if self.data_group is None:
            return None
        return all_reduce_(torch.sum(weights.float()), self.data_group)

    def _counts_reg(self) -> bool:
        return self.mesh is None or self.mesh.data_index == 0

    def frames(self, model, features, num_frames, sampling_key, row_offset: int = 0):
        """The rows the model sees this step (module docstring); the draw's
        rows from ``row_offset``, the global index of the first."""
        mcfg = self.mcfg
        if not self.frame_features:
            return features
        if model.samples_frames and not mcfg.presampled:
            raise ValueError("the train step samples frames itself: build the model with presampled=True")
        if self.tcfg.presample_frames:
            return sample_frame_features(features, num_frames, mcfg.iterations, sampling_key, row_offset)
        if model.samples_frames:
            return sample_model_input(features, num_frames, mcfg.iterations,
                                      prng.flax_make_rng(sampling_key), mcfg.sample_random_frames, row_offset)
        return features

    def forward(self, model, features, num_frames, dropout_key=None, row_offset: int = 0
                ) -> Dict[str, torch.Tensor]:
        """The model in training mode on the step's rows, given
        ``dropout_key`` and ``row_offset`` if it takes them; under
        ``--use_remat`` inside a checkpoint whose recompute leaves the BN
        statistics alone.  ``row_offset`` keys the dropout masks (module
        docstring)."""
        x = preprocess_input(features, self.dtype)
        kwargs = {"dropout_key": dropout_key, "row_offset": row_offset} if model.takes_dropout_key else {}
        if not self.tcfg.use_remat:
            return model(x, num_frames, training=True, **kwargs)
        calls = []

        def run(x):
            with batch_stats_frozen(model, frozen=bool(calls)):
                calls.append(None)
                return model(x, num_frames, training=True, **kwargs)

        return checkpoint(run, x, use_reentrant=False)

    def _weights(self, batch, b: int, device) -> torch.Tensor:
        weights = batch.get("weights")
        return torch.ones(b, device=device) if weights is None else weights

    def _reg(self, model) -> torch.Tensor:
        return regularization_loss(model.named_parameters(), self.mcfg.l2_penalty,
                                   all_kernels=self.mcfg.l2_reg_all_kernels, moe_l2=self.mcfg.moe_l2)

    def loss(self, state: TrainState, batch: Dict[str, torch.Tensor], key: torch.Tensor):
        """Single pass: forward in training mode → (total loss, label loss,
        reg loss, predictions)."""
        if self.accum != 1:
            raise ValueError("TrainStep.loss is the single-pass forward; with --grad_accum_steps > 1 "
                             "call the step")
        sampling_key, dropout_key = prng.split(prng.fold_in(key, state.step))
        num_frames = batch.get("num_frames") if self.frame_features else None
        offset = self._row_offset(batch["features"].shape[0])
        features = self.frames(state.model, batch["features"], num_frames, sampling_key, offset)
        weights = self._weights(batch, features.shape[0], features.device)
        predictions = self.forward(state.model, features, num_frames, dropout_key, offset)["predictions"]
        per_ex = self.loss_obj.calculate_per_example_loss(predictions, batch["labels"].float())
        label_loss = weighted_mean(per_ex, weights, self._total_weight(weights))
        reg = self._reg(state.model).to(label_loss.device)
        if not self._counts_reg():
            return label_loss, label_loss, reg, predictions
        total = label_loss + self.tcfg.regularization_penalty * reg
        return total, label_loss, reg, predictions

    def accumulated(self, state: TrainState, batch: Dict[str, torch.Tensor], key: torch.Tensor):
        """(gradients, total, label loss, reg loss, predictions) over
        ``self.accum`` microbatches (module docstring)."""
        model, accum, penalty = state.model, self.accum, self.tcfg.regularization_penalty
        features = batch["features"]
        b = features.shape[0]
        if b % accum:
            raise ValueError(f"batch_size={b} not divisible by grad_accum_steps={accum}")
        mb = b // accum
        sampling_key, dropout_key = prng.split(prng.fold_in(key, state.step))
        num_frames = batch.get("num_frames") if self.frame_features else None
        weights = self._weights(batch, b, features.device).float()
        labels = batch["labels"].float()
        total_weight = self._total_weight(weights)
        w_total = torch.clamp(torch.sum(weights) if total_weight is None else total_weight, min=1.0)
        offset = self._row_offset(mb)
        grads32, dtypes, preds = None, None, []
        label_loss = torch.zeros((), dtype=torch.float32, device=features.device)
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            nfs = None if num_frames is None else num_frames[sl]
            rows = self.frames(model, features[sl], nfs, prng.fold_in(sampling_key, i), offset)
            predictions = self.forward(model, rows, nfs, prng.fold_in(dropout_key, i), offset)["predictions"]
            per_ex = self.loss_obj.calculate_per_example_loss(predictions, labels[sl])
            label_i = torch.sum(per_ex.float() * weights[sl]) / w_total
            g = gradients(label_i, model)
            if grads32 is None:
                dtypes = [t.dtype for t in g]
                grads32 = [t.float() for t in g]
            else:
                for acc, t in zip(grads32, g):
                    acc.add_(t.float())
            label_loss = label_loss + label_i.detach()
            preds.append(predictions.detach())
        reg = self._reg(model).to(label_loss.device)
        if reg.requires_grad and self._counts_reg():
            for acc, t in zip(grads32, gradients(reg, model)):
                acc.add_(penalty * t.float())
        reg = reg.detach()
        grads32 = all_reduce_gradients(grads32, self.data_group)
        grads = [t.to(dt) for t, dt in zip(grads32, dtypes)]
        return grads, label_loss + penalty * reg, label_loss, reg, torch.cat(preds, dim=0)

    def __call__(self, state: TrainState, batch, key) -> Dict[str, torch.Tensor]:
        if self.accum == 1:
            total, label_loss, reg, predictions = self.loss(state, batch, key)
            grads = all_reduce_gradients(gradients(total, state.model), self.data_group)
        else:
            grads, total, label_loss, reg, predictions = self.accumulated(state, batch, key)
        if self.data_group is not None:
            label_loss = all_reduce_(label_loss.detach().clone(), self.data_group)
            total = label_loss + self.tcfg.regularization_penalty * reg.detach()
        state.apply_gradients(grads)
        return {"loss": total.detach(), "label_loss": label_loss.detach(),
                "reg_loss": reg.detach(), "predictions": predictions.detach()}


def inference_forward(model, mcfg: ModelConfig, frame_features: bool):
    """``fn(features, num_frames=None, key=None, row_offset=0) ->
    predictions``: the model's forward with ``training=False`` as
    ``model.apply(..., rngs={"sampling": key})`` runs the flax model
    (without ``key`` flax draws from ``key(0)`` itself); ``row_offset``: the
    global index of the first row, on a mesh."""
    dtype = compute_dtype(mcfg)
    samples = frame_features and mcfg.presampled

    def forward(features, num_frames=None, key=None, row_offset: int = 0):
        if not frame_features:
            num_frames = None
        if samples:
            sampling_key = prng.key(0) if key is None else prng.flax_make_rng(key)
            features = sample_model_input(features, num_frames, mcfg.iterations, sampling_key,
                                          mcfg.sample_random_frames, row_offset)
        with torch.no_grad():
            return model(preprocess_input(features, dtype), num_frames, training=False)["predictions"]

    return forward


def eval_outputs(predictions: torch.Tensor, batch: Dict[str, torch.Tensor], loss_obj: BaseLoss,
                 top_k: int) -> Dict[str, object]:
    """A batch's predictions, weighted loss and ``batch_topk_partials``."""
    labels = batch["labels"].float()
    weights = batch.get("weights")
    if weights is None:
        weights = torch.ones(predictions.shape[0], device=predictions.device)
    per_ex = loss_obj.calculate_per_example_loss(predictions, labels)
    return {"predictions": predictions, "loss": weighted_mean(per_ex, weights),
            "partials": batch_topk_partials(predictions, labels, weights, top_k=top_k)}


def make_eval_step(model, loss_obj: BaseLoss, mcfg: ModelConfig, frame_features: bool,
                   top_k: int = 20):
    """``eval_step(batch, key=None)`` → {predictions, loss, partials}: the
    predictions for the reference-parity host accumulator and the device
    partials of ``--fast_eval`` from one forward (ref:
    core/step.py#make_eval_step).  ``batch`` holds tensors on the model's
    device; ``key`` is the batch's sampling key."""
    forward = inference_forward(model, mcfg, frame_features)

    def eval_step(batch, key=None, row_offset: int = 0):
        predictions = forward(batch["features"], batch.get("num_frames"), key, row_offset)
        return eval_outputs(predictions, batch, loss_obj, top_k)

    return eval_step


def make_predict_step(model, mcfg: ModelConfig, frame_features: bool, top_k: int = 20):
    """``predict_step(features, num_frames=None, key=None)`` → (values
    [B, k], class indices [B, k]): the forward, f32 probabilities and exact
    top-k (ref: core/step.py#make_predict_step)."""
    forward = inference_forward(model, mcfg, frame_features)

    def predict_step(features, num_frames=None, key=None, row_offset: int = 0):
        predictions = forward(features, num_frames, key, row_offset).float()
        return top_k_exact(predictions, min(top_k, predictions.shape[-1]))

    return predict_step
