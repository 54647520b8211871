"""Frozen, hashable configuration objects.

The reference (ref: frame_level_models.py / video_level_models.py /
train.py — flag definitions scattered at module level, see SURVEY.md §5.6)
drives every knob through global ``tf.app.flags``.  The rebuild keeps the same
*flag names* at the CLI (see ``learnablepoolingmethods_tpu/flags.py``) but
backs them with immutable dataclasses so configs are hashable and therefore
jit-static: a model config can close over a compiled XLA program without
retracing hazards.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _parse_csv_ints(s: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in s.split(",") if x.strip())


def _parse_csv_strs(s: str) -> Tuple[str, ...]:
    return tuple(x.strip() for x in s.split(",") if x.strip())


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Input feature layout (ref: readers.py#GetListOfFeatureNamesAndSizes).

    Video-level records carry one float vector per named feature
    (``mean_rgb``[1024] + ``mean_audio``[128]); frame-level records carry
    per-frame uint8-quantized vectors (``rgb``/``audio``) padded/truncated to
    ``max_frames`` (ref: readers.py#resize_axis).
    """

    feature_names: Tuple[str, ...] = ("mean_rgb", "mean_audio")
    feature_sizes: Tuple[int, ...] = (1024, 128)
    frame_features: bool = False
    max_frames: int = 300

    @property
    def total_size(self) -> int:
        return sum(self.feature_sizes)

    @classmethod
    def from_flag_strings(
        cls,
        feature_names: str,
        feature_sizes: str,
        frame_features: bool = False,
        max_frames: int = 300,
    ) -> "FeatureConfig":
        names = _parse_csv_strs(feature_names)
        sizes = _parse_csv_ints(feature_sizes)
        if len(names) != len(sizes):
            raise ValueError(
                f"length of feature_names ({len(names)}) != "
                f"length of feature_sizes ({len(sizes)})"
            )
        return cls(names, sizes, frame_features, max_frames)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Union of every model hyperparameter flag in the reference zoo.

    Flag-name parity (SURVEY.md §5.6): each field mirrors a reference flag
    (``--moe_num_mixtures``, ``--dbof_cluster_size``,
    ``--netvlad_cluster_size`` ...).  Unused fields are ignored by models
    that don't read them, exactly like the reference's global flags.
    """

    vocab_size: int = 3862

    # --- video-level heads (ref: video_level_models.py) ---
    moe_num_mixtures: int = 2           # --moe_num_mixtures
    moe_l2: float = 1e-8                # --moe_l2
    l2_penalty: float = 1e-8            # slim l2_regularizer default in heads
    l2_reg_all_kernels: bool = False    # rebuild-only: L2 every matrix param
                                        # (reference regularizes heads only)

    # --- frame sampling (ref: model_utils.py, frame_level_models.py) ---
    iterations: int = 30                # --iterations (DBoF frame samples)
    sample_random_frames: bool = True   # --sample_random_frames

    # --- DBoF (ref: frame_level_models.py#DbofModel) ---
    dbof_cluster_size: int = 8192       # --dbof_cluster_size
    dbof_hidden_size: int = 1024        # --dbof_hidden_size
    dbof_pooling_method: str = "max"    # --dbof_pooling_method
    dbof_add_batch_norm: bool = True    # --dbof_add_batch_norm

    # --- NetVLAD / NetFV / LOUPE family (ref: frame_level_models.py#NetVLADModelLF) ---
    netvlad_cluster_size: int = 256     # --netvlad_cluster_size (Willow: 256)
    netvlad_hidden_size: int = 1024     # --netvlad_hidden_size
    netvlad_add_batch_norm: bool = True # --netvlad_add_batch_norm
    netvlad_relu: bool = False          # --netvlad_relu (Willow: False)
    netvlad_dimred: int = -1            # optional input dim-reduction (off)
    gating: bool = True                 # --gating (context gating before head)
    gating_remove_diag: bool = False    # --gating_remove_diag
    fv_cluster_size: int = 64           # --fv_cluster_size
    fv_hidden_size: int = 1024          # --fv_hidden_size
    fv_relu: bool = False               # --fv_relu
    fv_couple_weights: bool = False     # --fv_coupling_factor related
    fv_coupling_factor: float = 0.01    # --fv_coupling_factor
    dbow_cluster_size: int = 4096       # SoftDBoW clusters
    rvlad_cluster_size: int = 256       # NetRVLAD clusters

    # --- NeXtVLAD (rebuild bonus; arXiv:1811.05014) ---
    nextvlad_cluster_size: int = 128    # clusters per modality
    nextvlad_groups: int = 8            # attention groups (G)
    nextvlad_expansion: int = 2         # input expansion factor (λ)
    nextvlad_hidden_size: int = 1024    # tail hidden FC

    # --- RNN pooling (ref: frame_level_models.py#LstmModel) ---
    lstm_cells: int = 1024              # --lstm_cells
    lstm_layers: int = 2                # --lstm_layers
    gru_cells: int = 1024               # --gru_cells
    gru_layers: int = 2                 # --gru_layers

    # --- attention / transformer pooling (repo contribution, arXiv:1810.00530)
    attention_heads: int = 8            # multi-head attention head count
    attention_hidden_size: int = 1024   # post-pooling hidden size
    transformer_layers: int = 2         # encoder depth
    transformer_ff_size: int = 2048     # encoder FFN width
    attention_cluster_size: int = 64    # attention-cluster pooling slots
    attention_dropout: float = 0.1

    # --- composition ---
    video_level_classifier_model: str = "MoeModel"  # --video_level_classifier_model

    # --- training kernels (rebuild-only) ---
    # Route NetVLAD's softmax→aggregate→normalize through the custom-VJP
    # Pallas op (ops/netvlad_train.py): fwd+bwd in VMEM with recompute
    # instead of XLA materializing [B,D,K] autodiff intermediates.
    fused_train_aggregation: bool = False

    # --- input-stage control (rebuild-only) ---
    # When True, frame sampling already happened in the input stage (uint8
    # gather before dequantize — mathematically identical to the reference's
    # in-model sampling since ℓ2-normalize is row-wise); frame models skip
    # their internal sampling.
    presampled: bool = False

    # --- numerics (rebuild-only: TPU dtype policy) ---
    compute_dtype: str = "float32"      # "bfloat16" on TPU hot paths
    param_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """Optimization schedule (ref: train.py#build_graph flag defaults)."""

    batch_size: int = 1024                      # --batch_size
    base_learning_rate: float = 0.01            # --base_learning_rate
    learning_rate_decay: float = 0.95           # --learning_rate_decay
    learning_rate_decay_examples: int = 4_000_000  # --learning_rate_decay_examples
    optimizer: str = "AdamOptimizer"            # --optimizer
    clip_gradient_norm: float = 1.0             # --clip_gradient_norm (per-leaf)
    regularization_penalty: float = 1.0         # --regularization_penalty
    label_loss: str = "CrossEntropyLoss"        # --label_loss
    num_epochs: int = 5                         # --num_epochs
    max_steps: int = 0                          # --max_steps (0 = unlimited)
    export_model_steps: int = 1000              # --export_model_steps
    save_checkpoint_every_n_steps: int = 1000   # replaces save_model_secs
    keep_checkpoint_max: int = 0                # 0 = keep all (ref max_to_keep=0)
    use_remat: bool = False                     # jax.checkpoint the forward
                                                # (HBM↔FLOPs trade; rebuild-only)
    adam_bf16_momentum: bool = False            # store Adam's first moment in
                                                # bf16 — the update is HBM-bound
                                                # (~37% of the Willow train step)
    fp32_master: bool = False                   # bf16 params + fp32 master in
                                                # the optimizer (--bf16_params
                                                # sets this with param_dtype)
    presample_frames: bool = False              # sample frames in uint8 BEFORE
                                                # dequantize (sampling models
                                                # only; exact reorder)
    fused_adam: bool = False                    # one-VMEM-pass Adam kernel:
                                                # stochastic-rounded bf16
                                                # params + bf16 ν, no fp32
                                                # master (ops/fused_adam.py)
    grad_accum_steps: int = 1                   # microbatches per optimizer
                                                # step (rebuild-only): peak
                                                # activation memory scales
                                                # with batch_size/accum, so
                                                # effective batches past the
                                                # B=4096 activation OOM fit
