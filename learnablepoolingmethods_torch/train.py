"""Train entry point (ref: train.py#Trainer.run).

Trains a frame-level model on YouTube-8M TFRecords and writes its weights
as ``<train_dir>/variables.npz`` in the flax ``{params, batch_stats}``
layout, which the inference CLI reads:

    python -m learnablepoolingmethods_torch.train --model=NetVLADModelLF \\
        --frame_features --feature_names=rgb,audio --feature_sizes=1024,128 \\
        --train_data_pattern='/data/train*.tfrecord' --train_dir=/ckpt \\
        --batch_size=256 --max_steps=1000 --compute_dtype=bfloat16 \\
        --fused_train_aggregation --start_new_model

The flags keep the JAX CLI's names; ``--device`` (default ``cuda``) is the
port's own.  With ``--fused_train_aggregation`` each NetVLAD's aggregation
runs the CUDA forward and backward kernels of ``ops/netvlad_train.py``.
Frames are always sampled as the JAX step does under ``--presample_frames``.
The weights start from ``core/weights.py#init_variables_np(seed)``.  Flags
of the JAX CLI that the port does not take yet raise when set: restoring a
checkpoint (an existing ``variables.npz`` without ``--start_new_model``),
export, a device mesh, grain, the native reader, the packed cache, remat,
gradient accumulation, bf16 parameters and the other optimizers.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import time
from typing import Dict, List

import torch

from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core import optimizers
from learnablepoolingmethods_torch.core.step import TrainStep
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.core.weights import (
    NPZ_NAME,
    init_variables_np,
    load_flax_variables,
    save_variables_npz,
    state_dict_to_flax,
)
from learnablepoolingmethods_torch.data.pipeline import batch_iterator
from learnablepoolingmethods_torch.data.readers import YT8MFrameFeatureReader
from learnablepoolingmethods_torch.losses import get_loss_by_name
from learnablepoolingmethods_torch.metrics import eval_util
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.utils import prng
from learnablepoolingmethods_torch.utils.misc import add_bool_flag, resolve_device

log = logging.getLogger(__name__)
TASK = "/job:master/task:0"

# flags of the JAX CLI that are not ported yet, with the value that means "off"
_NOT_PORTED = {
    "use_grain": False, "use_native_reader": False, "packed_cache_dir": "", "profile_dir": "",
    "model_parallelism": 1, "dcn_parallelism": 1, "use_remat": False,
    "adam_bf16_momentum": False, "bf16_params": False, "fused_adam": False,
    "grad_accum_steps": 1, "export_model_steps": 0,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train_data_pattern", default="", help="File glob for the training TFRecords.")
    p.add_argument("--train_dir", default="/tmp/yt8m_model/", help="Directory for variables.npz.")
    add_bool_flag(p, "start_new_model", False, "Wipe train_dir and train from scratch.")
    p.add_argument("--shuffle_buffer", type=int, default=1024, help="Shuffle buffer size.")
    # data
    p.add_argument("--feature_names", default="mean_rgb,mean_audio", help="Name of the feature columns.")
    p.add_argument("--feature_sizes", default="1024,128", help="Length of the feature vectors.")
    add_bool_flag(p, "frame_features", False, "Input is frame-level tf.SequenceExample.")
    p.add_argument("--max_frames", type=int, default=300, help="Frame pad/truncate length.")
    p.add_argument("--num_classes", type=int, default=3862, help="Vocabulary size.")
    # model
    p.add_argument("--model", default="LogisticModel", help="Which model class to use.")
    p.add_argument("--video_level_classifier_model", default="MoeModel",
                   help="Video-level classifier used by frame-level models.")
    p.add_argument("--moe_num_mixtures", type=int, default=2, help="Mixtures per class for MoeModel.")
    p.add_argument("--moe_l2", type=float, default=1e-8, help="L2 penalty for MoeModel.")
    p.add_argument("--iterations", type=int, default=30, help="Number of frames to sample per video.")
    add_bool_flag(p, "sample_random_frames", True, "Sample random frames (with replacement).")
    p.add_argument("--netvlad_cluster_size", type=int, default=256, help="NetVLAD clusters (rgb).")
    p.add_argument("--netvlad_hidden_size", type=int, default=1024, help="NetVLAD hidden size.")
    add_bool_flag(p, "netvlad_add_batch_norm", True, "BN in NetVLAD models.")
    add_bool_flag(p, "netvlad_relu", False, "relu6 after the hidden layer.")
    p.add_argument("--netvlad_dimred", type=int, default=-1, help="Input dim-reduction width (-1 = off).")
    add_bool_flag(p, "gating", True, "Context gating before the classifier.")
    add_bool_flag(p, "gating_remove_diag", False, "Zero the gating diagonal.")
    p.add_argument("--compute_dtype", default="float32", help="Model compute dtype: float32|bfloat16.")
    add_bool_flag(p, "fused_train_aggregation", False,
                  "NetVLAD aggregation through the CUDA forward and backward kernels.")
    add_bool_flag(p, "l2_reg_all_kernels", False, "L2 on every matrix instead of the head kernels.")
    # training
    p.add_argument("--batch_size", type=int, default=1024, help="Videos per training batch.")
    p.add_argument("--label_loss", default="CrossEntropyLoss", help="Loss class name.")
    p.add_argument("--regularization_penalty", type=float, default=1.0,
                   help="Multiplier on the regularization loss.")
    p.add_argument("--base_learning_rate", type=float, default=0.01, help="Initial learning rate.")
    p.add_argument("--learning_rate_decay", type=float, default=0.95,
                   help="Decay rate applied every learning_rate_decay_examples.")
    p.add_argument("--learning_rate_decay_examples", type=float, default=4000000,
                   help="Examples between learning-rate decays.")
    p.add_argument("--num_epochs", type=int, default=5, help="Training epochs over the data.")
    p.add_argument("--max_steps", type=int, default=0, help="Stop after this many steps (0 = none).")
    p.add_argument("--optimizer", default="AdamOptimizer", help="Optimizer class name.")
    p.add_argument("--clip_gradient_norm", type=float, default=1.0, help="Per-gradient norm clip.")
    p.add_argument("--save_checkpoint_every_n_steps", type=int, default=1000,
                   help="Write variables.npz every this many steps.")
    p.add_argument("--log_every_n_steps", type=int, default=10, help="Steps between log lines.")
    p.add_argument("--seed", type=int, default=0, help="Seed of the weights, shuffle and sampling.")
    add_bool_flag(p, "presample_frames", False,
                  "Accepted for the JAX CLI's sake: the port always samples frames in uint8 first.")
    p.add_argument("--device", default="cuda", help="Torch device: cuda (default), cuda:N or cpu.")
    for name, off in _NOT_PORTED.items():
        kind = "not ported yet; raises if set"
        if isinstance(off, bool):
            add_bool_flag(p, name, off, kind)
        else:
            p.add_argument(f"--{name}", type=type(off), default=off, help=kind)
    return p


def configs_from_args(args):
    for name, off in _NOT_PORTED.items():
        if getattr(args, name) != off:
            raise NotImplementedError(f"--{name} is not ported to the PyTorch trainer yet (ROADMAP.md)")
    if not args.sample_random_frames:
        # the step always draws random frames, as the JAX step under
        # --presample_frames; JAX's contiguous windows are not ported
        raise NotImplementedError("--nosample_random_frames is not ported to the PyTorch trainer yet")
    fcfg = FeatureConfig.from_flag_strings(args.feature_names, args.feature_sizes,
                                           args.frame_features, args.max_frames)
    mcfg = ModelConfig(
        vocab_size=args.num_classes, moe_num_mixtures=args.moe_num_mixtures, moe_l2=args.moe_l2,
        iterations=args.iterations, sample_random_frames=args.sample_random_frames,
        netvlad_cluster_size=args.netvlad_cluster_size, netvlad_hidden_size=args.netvlad_hidden_size,
        netvlad_add_batch_norm=args.netvlad_add_batch_norm, netvlad_relu=args.netvlad_relu,
        netvlad_dimred=args.netvlad_dimred, gating=args.gating,
        gating_remove_diag=args.gating_remove_diag,
        video_level_classifier_model=args.video_level_classifier_model,
        compute_dtype=args.compute_dtype, fused_train_aggregation=args.fused_train_aggregation,
        l2_reg_all_kernels=args.l2_reg_all_kernels,
        presampled=True,  # the train step gathers the sampled frames itself
    )
    tcfg = TrainingConfig(
        batch_size=args.batch_size, base_learning_rate=args.base_learning_rate,
        learning_rate_decay=args.learning_rate_decay,
        learning_rate_decay_examples=int(args.learning_rate_decay_examples),
        optimizer=args.optimizer, clip_gradient_norm=args.clip_gradient_norm,
        regularization_penalty=args.regularization_penalty, label_loss=args.label_loss,
        num_epochs=args.num_epochs, max_steps=args.max_steps,
        save_checkpoint_every_n_steps=args.save_checkpoint_every_n_steps,
        presample_frames=True,
    )
    return fcfg, mcfg, tcfg


class Trainer:
    """Single-device trainer (ref: train.py#Trainer).  ``history`` keeps the
    metrics of every logged step."""

    def __init__(self, args):
        self.args = args
        self.train_dir = args.train_dir
        self.history: List[Dict[str, float]] = []

    def run(self) -> TrainState:
        args = self.args
        fcfg, mcfg, tcfg = configs_from_args(args)
        if not fcfg.frame_features:
            raise NotImplementedError("video-level input is not ported yet: pass --frame_features")
        device = resolve_device(args.device)
        loss_obj = get_loss_by_name(tcfg.label_loss)
        lr_schedule = optimizers.learning_rate_schedule(tcfg)

        if args.start_new_model and os.path.exists(self.train_dir):
            log.info("%s: removing existing train dir", TASK)
            shutil.rmtree(self.train_dir)
        if os.path.exists(os.path.join(self.train_dir, NPZ_NAME)):
            raise NotImplementedError(
                f"{self.train_dir} holds {NPZ_NAME}: restoring a checkpoint is not ported yet "
                "(ROADMAP item 13); pass --start_new_model to train from scratch"
            )
        os.makedirs(self.train_dir, exist_ok=True)

        model = create_model(args.model, mcfg, fcfg.total_size)
        load_flax_variables(model, init_variables_np(mcfg, fcfg, seed=args.seed))
        model.to(device)
        state = TrainState.create(model, tcfg)
        train_step = TrainStep(loss_obj, tcfg, mcfg, fcfg.frame_features)
        key = prng.key(args.seed)
        log.info("%s: %s on %s, %d parameters", TASK, args.model, device,
                 sum(p.numel() for p in model.parameters()))

        reader = YT8MFrameFeatureReader(
            num_classes=mcfg.vocab_size, feature_sizes=fcfg.feature_sizes,
            feature_names=fcfg.feature_names, max_frames=fcfg.max_frames,
        )
        batches = batch_iterator(
            reader, args.train_data_pattern, tcfg.batch_size,
            num_epochs=tcfg.num_epochs if tcfg.num_epochs > 0 else None,
            shuffle=True, shuffle_buffer=args.shuffle_buffer, seed=args.seed,
        )
        log_every = max(args.log_every_n_steps, 1)
        last_log_time, last_log_step = time.time(), state.step
        for batch in batches:
            if tcfg.max_steps and state.step >= tcfg.max_steps:
                break
            device_batch = {k: torch.from_numpy(v).to(device)
                            for k, v in batch.items() if k != "video_id"}
            metrics = train_step(state, device_batch, key)
            if state.step % log_every == 0:
                self._log(state.step, metrics, batch["labels"], lr_schedule, last_log_time, last_log_step)
                last_log_time, last_log_step = time.time(), state.step
            if state.step % tcfg.save_checkpoint_every_n_steps == 0:
                self._save(state)
        self._save(state)
        log.info("%s: done; final variables at step %d", TASK, state.step)
        return state

    def _log(self, step, metrics, labels, lr_schedule, since, since_step):
        loss = float(metrics["loss"])  # waits for the device
        preds = metrics["predictions"].float().cpu().numpy()
        gap = eval_util.calculate_gap(preds, labels)
        hit1 = eval_util.calculate_hit_at_one(preds, labels)
        perr = eval_util.calculate_precision_at_equal_recall_rate(preds, labels)
        eps = (step - since_step) * self.args.batch_size / max(time.time() - since, 1e-9)
        log.info(
            "%s: training step %d | Loss: %.4f Hit@1: %.4f PERR: %.4f GAP: %.4f | "
            "%.1f examples/sec | lr %.6f",
            TASK, step, loss, hit1, perr, gap, eps, lr_schedule(step),
        )
        self.history.append({"step": step, "loss": loss, "hit1": hit1, "perr": perr, "gap": gap,
                             "examples_per_sec": eps})

    def _save(self, state):
        path = save_variables_npz(state_dict_to_flax(state.model), self.train_dir)
        log.info("%s: wrote %s at step %d", TASK, path, state.step)


def main(argv=None) -> Trainer:
    args = build_parser().parse_args(argv)
    if not args.train_data_pattern:
        raise ValueError("'train_data_pattern' was not specified")
    trainer = Trainer(args)
    trainer.run()
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
