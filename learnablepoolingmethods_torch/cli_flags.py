"""The flag names of the JAX package's CLIs (``learnablepoolingmethods_tpu/
flags.py``), with its defaults and help, for the port's argparse CLIs, and
the input source they select (:func:`input_iterator`).

A JAX command line parses in the port's inference, eval and train CLIs:
each defines every name below plus its JAX CLI's own flags, and every flag
is ported (the mesh's through ``parallel/mesh.py``).  One that the JAX CLI
reads nowhere on that path (the training schedule at inference,
``--num_gpu`` everywhere) is accepted and has no effect there either.  The
defaults are the JAX package's.  This is a copy: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Mapping

from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.data import grain_pipeline, packed_cache, pipeline
from learnablepoolingmethods_torch.data.readers import make_reader
from learnablepoolingmethods_torch.parallel.mesh import pad_batch_to_multiple
from learnablepoolingmethods_torch.utils.misc import add_bool_flag

# name → (default, help), in flags.py's order; a bool default makes an
# absl-style boolean (--name, --name=false, --noname)
FLAGS_PY: Dict[str, tuple] = {
    "int8_hidden": (False, "Weight-only int8 hidden FC on the fast path."),
    # data
    "feature_names": ("mean_rgb,mean_audio", "Name of the feature columns."),
    "feature_sizes": ("1024,128", "Length of the feature vectors."),
    "frame_features": (False, "Input is frame-level tf.SequenceExample; else video-level tf.Example."),
    "max_frames": (300, "Frame pad/truncate length."),
    "num_classes": (3862, "Vocabulary size."),
    "num_readers": (8, "How many threads to use for reading input files."),
    "use_grain": (False, "Read input through the grain DataLoader."),
    "grain_worker_count": (0, "grain worker processes (0 = parse in-process)."),
    "packed_cache_dir": ("", "Pre-parse the TFRecords into memmapped packed arrays here."),
    # model
    "model": ("LogisticModel", "Which model class to use."),
    "video_level_classifier_model": ("MoeModel", "Video-level classifier used by frame-level models."),
    "moe_num_mixtures": (2, "Mixtures per class for MoeModel."),
    "moe_l2": (1e-8, "L2 penalty for MoeModel."),
    "iterations": (30, "Number of frames to sample per video."),
    "sample_random_frames": (True, "Sample random frames (with replacement); else a random window."),
    "dbof_cluster_size": (8192, "DBoF projection size."),
    "dbof_hidden_size": (1024, "DBoF hidden size."),
    "dbof_pooling_method": ("max", "DBoF pooling: max|average."),
    "dbof_add_batch_norm": (True, "BN in DBoF."),
    "netvlad_cluster_size": (256, "NetVLAD clusters (rgb)."),
    "netvlad_hidden_size": (1024, "NetVLAD hidden size."),
    "netvlad_add_batch_norm": (True, "BN in NetVLAD models."),
    "netvlad_relu": (False, "relu6 after the hidden layer."),
    "netvlad_dimred": (-1, "Learned input dim-reduction width (-1 = off)."),
    "gating": (True, "Context gating before the classifier."),
    "gating_remove_diag": (False, "Zero the gating diagonal."),
    "fv_cluster_size": (64, "NetFV clusters."),
    "fv_hidden_size": (1024, "NetFV hidden size."),
    "fv_relu": (False, "relu6 in NetFV tail."),
    "fv_couple_weights": (False, "Couple FV covar to clusters."),
    "fv_coupling_factor": (0.01, "FV coupling factor."),
    "dbow_cluster_size": (4096, "SoftDBoW clusters."),
    "rvlad_cluster_size": (256, "NetRVLAD clusters."),
    "nextvlad_cluster_size": (128, "NeXtVLAD clusters."),
    "nextvlad_groups": (8, "NeXtVLAD attention groups."),
    "nextvlad_expansion": (2, "NeXtVLAD expansion λ."),
    "nextvlad_hidden_size": (1024, "NeXtVLAD hidden FC."),
    "lstm_cells": (1024, "LSTM cells per layer."),
    "lstm_layers": (2, "LSTM layers."),
    "gru_cells": (1024, "GRU cells per layer."),
    "gru_layers": (2, "GRU layers."),
    "attention_heads": (8, "Attention heads."),
    "attention_hidden_size": (1024, "Attention model width."),
    "transformer_layers": (2, "Transformer encoder depth."),
    "transformer_ff_size": (2048, "Transformer FFN width."),
    "attention_cluster_size": (64, "Attention pooling slots."),
    "attention_dropout": (0.1, "Attention dropout rate."),
    "compute_dtype": ("float32", "Model compute dtype: float32|bfloat16."),
    "fused_train_aggregation": (False, "NetVLAD aggregation through the fused forward and backward kernels."),
    "l2_reg_all_kernels": (False, "L2 penalty on every matrix instead of the classifier-head kernels."),
    # training
    "batch_size": (1024, "Videos per batch."),
    "num_gpu": (1, "Accepted for reference CLI compatibility and ignored."),
    "model_parallelism": (1, "Shard large weight matrices' output axis over this many devices."),
    "dcn_parallelism": (1, "Leading multi-slice mesh axis."),
    "label_loss": ("CrossEntropyLoss", "Loss class name."),
    "regularization_penalty": (1.0, "Multiplier on the regularization loss."),
    "base_learning_rate": (0.01, "Initial learning rate."),
    "learning_rate_decay": (0.95, "Decay rate applied every learning_rate_decay_examples."),
    "learning_rate_decay_examples": (4000000.0, "Examples between learning-rate decays."),
    "num_epochs": (5, "Training epochs over the data."),
    "max_steps": (0, "Stop after this many steps (0 = none)."),
    "export_model_steps": (1000, "Export the model every N steps."),
    "optimizer": ("AdamOptimizer", "Optimizer class name."),
    "clip_gradient_norm": (1.0, "Per-gradient norm clip."),
    "save_checkpoint_every_n_steps": (1000, "Checkpoint cadence in steps."),
    "keep_checkpoint_max": (0, "Max checkpoints to keep (0 = all)."),
    "log_every_n_steps": (10, "Steps between log lines."),
    "seed": (0, "PRNG seed."),
    "use_remat": (False, "Rematerialize the forward pass in backward."),
    "adam_bf16_momentum": (False, "Store Adam's first moment in bfloat16."),
    "presample_frames": (False, "Sample frames in uint8 space before dequantize+normalize in the train step."),
    "bf16_params": (False, "Store model params in bfloat16 with an fp32 master copy in the optimizer."),
    "grad_accum_steps": (1, "Microbatches accumulated per optimizer step."),
    "fused_adam": (False, "bf16 params updated with stochastic rounding, no fp32 master."),
}

def add_flag(parser: argparse.ArgumentParser, name: str, default, help: str) -> None:
    """``--name`` of ``default``'s type; a bool an absl-style boolean."""
    if isinstance(default, bool):
        add_bool_flag(parser, name, default, help)
    else:
        parser.add_argument(f"--{name}", type=type(default), default=default, help=help)


def add_flags(parser: argparse.ArgumentParser, own: Mapping[str, tuple]) -> argparse.ArgumentParser:
    """Define a CLI's ``own`` flags (name → (default, help)), then every
    name of :data:`FLAGS_PY`."""
    for name, (default, help) in {**own, **FLAGS_PY}.items():
        add_flag(parser, name, default, help)
    return parser


def model_config_from_args(args: argparse.Namespace, **overrides) -> ModelConfig:
    """ModelConfig from every flag that names one of its fields, the
    vocabulary from ``--num_classes`` and ``param_dtype`` bfloat16 under
    ``--bf16_params`` or ``--fused_adam`` (as flags.py#model_config_from_flags
    builds them), then ``overrides``."""
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(ModelConfig)
          if hasattr(args, f.name)}
    kw["vocab_size"] = args.num_classes
    # the JAX CLIs build the model in bf16 under either flag
    kw["param_dtype"] = "bfloat16" if (args.bf16_params or args.fused_adam) else "float32"
    kw.update(overrides)
    return ModelConfig(**kw)


def input_iterator(args: argparse.Namespace, fcfg: FeatureConfig, data_pattern: str, batch_size: int,
                   num_epochs, shuffle: bool = False, seed: int = 0, shard_index: int = 0,
                   num_shards: int = 1):
    """The batch iterator that the flags select (ref: flags.py#input_iterator):
    ``--packed_cache_dir`` (built there at first use by shard 0; the other
    shards wait for it), else ``--use_grain`` (``--grain_worker_count``
    worker processes; the last batch zero-padded to ``batch_size`` with
    weight 0 rows), else the streaming Python reader.  One process reads
    shard 0 of 1; ``shard_index``/``num_shards`` give a node its share
    (``parallel/mesh.py#Mesh.input_shard``)."""
    if args.packed_cache_dir and args.use_grain:
        raise ValueError("--packed_cache_dir and --use_grain are exclusive")
    if args.packed_cache_dir:
        if shard_index != 0:
            # two builders writing one directory corrupt the arrays
            cache_dir = packed_cache.wait_for_cache(args.packed_cache_dir, data_pattern)
        else:
            cache_dir = packed_cache.build_cache(
                data_pattern, args.packed_cache_dir, frame_level=fcfg.frame_features,
                feature_sizes=fcfg.feature_sizes, feature_names=fcfg.feature_names,
                num_classes=args.num_classes, max_frames=fcfg.max_frames, num_workers=args.num_readers)
        return packed_cache.packed_batch_iterator(cache_dir, batch_size, num_epochs=num_epochs, shuffle=shuffle,
                                                  seed=seed, shard_index=shard_index, num_shards=num_shards)
    if args.use_grain:
        batches = grain_pipeline.grain_batch_iterator(
            data_pattern, batch_size, fcfg.frame_features, num_epochs=num_epochs, shuffle=shuffle, seed=seed,
            worker_count=args.grain_worker_count, shard_index=shard_index, num_shards=num_shards,
            feature_sizes=fcfg.feature_sizes, feature_names=fcfg.feature_names,
            num_classes=args.num_classes, max_frames=fcfg.max_frames)
        return (pad_batch_to_multiple(b, batch_size) for b in batches)
    return pipeline.batch_iterator(make_reader(fcfg, args.num_classes), data_pattern, batch_size,
                                   num_epochs=num_epochs, shuffle=shuffle, seed=seed,
                                   shard_index=shard_index, num_shards=num_shards)
