"""Train entry point (ref: train.py#Trainer.run).

Trains a model on YouTube-8M TFRecords, frame-level or video-level, and
checkpoints the whole train state (step, parameters, BN statistics, the
optimizer's state) into ``<train_dir>/checkpoints/<step>/``
(``core/checkpoints.py``), which the eval and inference CLIs read:

    python -m learnablepoolingmethods_torch.train --model=NetRVLADModelLF \\
        --frame_features --feature_names=rgb,audio --feature_sizes=1024,128 \\
        --train_data_pattern='/data/train*.tfrecord' --train_dir=/ckpt \\
        --batch_size=256 --max_steps=1000 --compute_dtype=bfloat16 \\
        --fused_train_aggregation

As the JAX trainer does, it resumes from the latest checkpoint in
``--train_dir`` when there is one (``--start_new_model`` wipes the directory
first): the batch iterator starts again from the beginning with the same
``--seed`` and its first batch trains the restored step, whose frames come
from ``fold_in(key(seed), step)``.  It saves at every step that is a multiple
of ``--save_checkpoint_every_n_steps`` and at the end, keeping the newest
``--keep_checkpoint_max`` (0: all).  After the save, at every step that is
a multiple of ``--export_model_steps`` (0: never), it exports the model to
``<train_dir>/export/step_<n>`` (``export_model.py``, the JAX package's
artifact; bf16 parameters stay bf16).

It trains every registered model: the LF family (NetVLADModelLF,
NetRVLADModelLF, NetFVModelLF, SoftDbofModelLF, NeXtVLADModel, with
``--netvlad_dimred``), DbofModel, FrameLevelLogisticModel, the attention
family (TransformerEncoderModel, AttentionPoolingModel,
AttentionNetVLADModel; flax's dropout, ``--attention_dropout``, drawn on
the card by ``ops/dropout.py``), LstmModel and GruModel, and LogisticModel
and MoeModel on video-level input (without ``--frame_features``), with every
``--optimizer`` and ``--label_loss`` of the JAX package and
``--adam_bf16_momentum``; ``--bf16_params`` (bf16 parameters, an f32 master
in the optimizer), ``--fused_adam`` (bf16 parameters and state, the FusedAdam
kernel on the card), ``--grad_accum_steps`` and ``--use_remat``
(``core/step.py``).  It takes every flag of the JAX CLI under its name
and default (``cli_flags.py``); ``--device`` (default ``cuda``) is the port's
own.  With ``--fused_train_aggregation`` the NetVLAD and NetRVLAD
aggregations run the CUDA forward and backward kernels of
``ops/netvlad_train.py`` (NetRVLAD at zero C₂).  Frames are the ones the JAX
step draws from the same ``--seed``, with or without ``--presample_frames``
and ``--sample_random_frames`` (``core/step.py``); the port gathers them in
uint8.  The weights start from ``core/weights.py#init_variables_np(seed)``.
Batches come, shuffled from ``--seed``, from the streaming Python reader,
or from one of the JAX trainer's three other sources: ``--use_native_reader``
(the C++ reader on ``--num_readers`` threads, ``data/native_loader.py``),
``--packed_cache_dir`` (``data/packed_cache.py``, built at first use) or
``--use_grain`` (grain's order on a torch DataLoader with
``--grain_worker_count`` workers, ``data/grain_pipeline.py``); two of them
at once raise ValueError, as in the JAX CLI.  ``--profile_dir`` traces the
training loop with ``torch.profiler`` into a Chrome trace there
(``core/observability.py#profile_session``).  What the port does not take
yet raises, naming its ROADMAP item: the flags of
``cli_flags.TRAIN_NOT_PORTED`` set off their defaults (a device mesh).
``--int8_hidden`` raises ValueError: the JAX trainer defines no such flag.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import shutil
import time
from typing import Dict, List

import torch

from learnablepoolingmethods_torch import cli_flags
from learnablepoolingmethods_torch.config import FeatureConfig, TrainingConfig
from learnablepoolingmethods_torch.core import optimizers
from learnablepoolingmethods_torch.core.checkpoints import CheckpointManager
from learnablepoolingmethods_torch.core.step import TrainStep
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.core.weights import init_variables_np, load_flax_variables, state_dict_to_flax
from learnablepoolingmethods_torch.core.observability import profile_session
from learnablepoolingmethods_torch.data.pipeline import batch_iterator, native_batch_iterator
from learnablepoolingmethods_torch.data.readers import make_reader
from learnablepoolingmethods_torch.export_model import export_model
from learnablepoolingmethods_torch.losses import get_loss_by_name
from learnablepoolingmethods_torch.metrics import eval_util
from learnablepoolingmethods_torch.models import create_model, find_class_by_name
from learnablepoolingmethods_torch.utils import prng
from learnablepoolingmethods_torch.utils.misc import resolve_device

log = logging.getLogger(__name__)
TASK = "/job:master/task:0"

# the JAX train CLI's own flags (learnablepoolingmethods_tpu/train.py
# #define_flags) and the port's --device: name → (default, help)
_OWN_FLAGS = {
    "train_data_pattern": ("", "File glob for the training TFRecords."),
    "train_dir": ("/tmp/yt8m_model/", "Directory for checkpoints."),
    "start_new_model": (False, "Wipe train_dir and train from scratch."),
    "shuffle_buffer": (1024, "Shuffle buffer size."),
    "profile_dir": ("", "Capture a profiler trace here."),
    "use_native_reader": (False, "Parse TFRecords with the C++ loader."),
    "device": ("cuda", "Torch device: cuda (default), cuda:N or cpu."),
}


def build_parser() -> argparse.ArgumentParser:
    """Every flag of the JAX train CLI (cli_flags.py), its defaults, and
    --device; the flags of cli_flags.TRAIN_NOT_PORTED raise when set."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    return cli_flags.add_flags(p, _OWN_FLAGS, cli_flags.TRAIN_NOT_PORTED)


def configs_from_args(args):
    if args.int8_hidden:
        raise ValueError("--int8_hidden is a flag of the eval, inference and serving CLIs: "
                         "the JAX trainer defines no such flag")
    cli_flags.refuse_not_ported(args, cli_flags.TRAIN_NOT_PORTED,
                                vars(build_parser().parse_args([])), "trainer")
    if sum(bool(x) for x in (args.use_grain, args.use_native_reader, args.packed_cache_dir)) > 1:
        raise ValueError("--use_grain, --use_native_reader and --packed_cache_dir are "
                         "mutually exclusive input sources")
    fcfg = FeatureConfig.from_flag_strings(args.feature_names, args.feature_sizes,
                                           args.frame_features, args.max_frames)
    # The JAX CLI builds the model presampled under --presample_frames, and
    # its step then gathers the frames; the port's step gathers a sampling
    # model's frames with or without it (core/step.py), so such a model is
    # always built presampled
    presampled = fcfg.frame_features and find_class_by_name(args.model).samples_frames
    mcfg = cli_flags.model_config_from_args(args, presampled=presampled)
    tcfg = TrainingConfig(
        batch_size=args.batch_size, base_learning_rate=args.base_learning_rate,
        learning_rate_decay=args.learning_rate_decay,
        learning_rate_decay_examples=int(args.learning_rate_decay_examples),
        optimizer=args.optimizer, clip_gradient_norm=args.clip_gradient_norm,
        regularization_penalty=args.regularization_penalty, label_loss=args.label_loss,
        num_epochs=args.num_epochs, max_steps=args.max_steps,
        export_model_steps=args.export_model_steps,
        save_checkpoint_every_n_steps=args.save_checkpoint_every_n_steps,
        keep_checkpoint_max=args.keep_checkpoint_max, adam_bf16_momentum=args.adam_bf16_momentum,
        presample_frames=args.presample_frames, use_remat=args.use_remat,
        # --fused_adam keeps no f32 master (stochastic rounding replaces it)
        fp32_master=args.bf16_params and not args.fused_adam, fused_adam=args.fused_adam,
        grad_accum_steps=args.grad_accum_steps,
    )
    return fcfg, mcfg, tcfg


class Trainer:
    """Single-device trainer (ref: train.py#Trainer).  ``history`` keeps the
    metrics of every logged step, ``state`` the live TrainState,
    ``restored_step`` the step it resumed from (None: a fresh start),
    ``restore_seconds`` and ``save_seconds`` (step → seconds) the
    checkpoints' times, ``trace_path`` the ``--profile_dir`` trace's file."""

    def __init__(self, args):
        self.args = args
        self.train_dir = args.train_dir
        self.history: List[Dict[str, float]] = []
        self.state = None
        self.restored_step = None
        self.restore_seconds = None
        self.save_seconds: Dict[int, float] = {}
        self.trace_path = None

    def run(self) -> TrainState:
        args = self.args
        fcfg, mcfg, tcfg = configs_from_args(args)
        device = resolve_device(args.device)
        loss_obj = get_loss_by_name(tcfg.label_loss)
        lr_schedule = optimizers.learning_rate_schedule(tcfg)

        if args.start_new_model and os.path.exists(self.train_dir):
            log.info("%s: removing existing train dir", TASK)
            shutil.rmtree(self.train_dir)
        os.makedirs(self.train_dir, exist_ok=True)

        model = create_model(args.model, mcfg, fcfg.total_size)
        load_flax_variables(model, init_variables_np(mcfg, fcfg, seed=args.seed, model_name=args.model))
        model.to(device)
        state = self.state = TrainState.create(model, tcfg)
        mngr = CheckpointManager(self.train_dir, keep=tcfg.keep_checkpoint_max or None)
        latest = mngr.latest_step()
        if latest is not None:
            t0 = time.perf_counter()
            state.load_state_tree(mngr.restore(latest, like=state.state_tree()))
            self.restored_step, self.restore_seconds = state.step, time.perf_counter() - t0
            log.info("%s: restored checkpoint at step %d", TASK, state.step)
        train_step = TrainStep(loss_obj, tcfg, mcfg, fcfg.frame_features)
        key = prng.key(args.seed)
        log.info("%s: %s on %s, %d parameters", TASK, args.model, device,
                 sum(p.numel() for p in model.parameters()))

        batches = self._batches(fcfg, mcfg, tcfg)
        log_every = max(args.log_every_n_steps, 1)
        last_log_time, last_log_step = time.time(), state.step
        with profile_session(args.profile_dir) as self.trace_path:
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
                    self._save(mngr, state)
                if tcfg.export_model_steps and state.step % tcfg.export_model_steps == 0:
                    # the JAX trainer exports the config it builds, presampled
                    # only under --presample_frames
                    self._export(state, dataclasses.replace(mcfg, presampled=tcfg.presample_frames), fcfg)
        self._save(mngr, state)
        log.info("%s: done; final checkpoint at step %d", TASK, state.step)
        return state

    def _batches(self, fcfg, mcfg, tcfg):
        """The training batches of the source the flags select, shuffled
        from --seed (ref: train.py#Trainer.run)."""
        args = self.args
        num_epochs = tcfg.num_epochs if tcfg.num_epochs > 0 else None
        if args.use_grain or args.packed_cache_dir:
            return cli_flags.input_iterator(args, fcfg, args.train_data_pattern, tcfg.batch_size, num_epochs,
                                            shuffle=True, seed=args.seed)
        if args.use_native_reader:
            return native_batch_iterator(
                args.train_data_pattern, tcfg.batch_size, frame_level=fcfg.frame_features,
                feature_sizes=fcfg.feature_sizes, feature_names=fcfg.feature_names,
                num_classes=mcfg.vocab_size, max_frames=fcfg.max_frames, num_epochs=num_epochs,
                shuffle=True, seed=args.seed, num_workers=args.num_readers)
        return batch_iterator(make_reader(fcfg, mcfg.vocab_size), args.train_data_pattern, tcfg.batch_size,
                              num_epochs=num_epochs, shuffle=True, shuffle_buffer=args.shuffle_buffer,
                              seed=args.seed)

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

    def _export(self, state: TrainState, mcfg, fcfg):
        export_dir = os.path.join(self.train_dir, "export", f"step_{state.step}")
        tree = state_dict_to_flax(state.model, keep_bf16=True)
        export_model(export_dir, self.args.model, mcfg, fcfg, tree["params"], tree["batch_stats"])
        log.info("%s: exported model to %s", TASK, export_dir)

    def _save(self, mngr: CheckpointManager, state: TrainState):
        t0 = time.perf_counter()
        if mngr.save(state.step, state.state_tree()):
            self.save_seconds[state.step] = time.perf_counter() - t0
            log.info("%s: saved checkpoint at step %d", TASK, state.step)


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
