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
(``core/observability.py#profile_session``).  ``--int8_hidden`` raises
ValueError: the JAX trainer defines no such flag.

Under ``torchrun`` it trains data- and model-parallel on a mesh of the
ranks (``parallel/mesh.py``): ``--model_parallelism`` ranks split the large
matrices' columns, ``--dcn_parallelism`` folds into the data axis, and the
data axis takes the rest; a layout that does not match the rank count
raises ValueError, as the JAX CLI does on its devices.  Each rank drives
``cuda:LOCAL_RANK`` (``--device=cuda``; an explicit ``cuda:N`` stays as it
is).  Each node reads its shard of the input (``--seed`` plus the shard's
index for the streaming and C++ readers), ``--batch_size`` videos a batch,
and each rank keeps its row block; the step is the single-device step of
the global batch (``core/step.py``).  A node's first rank logs the GAP of
the node's rows; rank 0 writes checkpoints and exports, whole, and restores
them on any mesh:

    torchrun --nproc_per_node=8 -m learnablepoolingmethods_torch.train \
        --model=NetVLADModelLF ... --model_parallelism=2
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
from learnablepoolingmethods_torch.parallel import mesh as mesh_lib
from learnablepoolingmethods_torch.parallel.collectives import barrier
from learnablepoolingmethods_torch.utils import prng

log = logging.getLogger(__name__)


def task_as_string() -> str:
    return f"/job:master/task:{mesh_lib.process_index()}"

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
    --device."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    return cli_flags.add_flags(p, _OWN_FLAGS)


def configs_from_args(args):
    if args.int8_hidden:
        raise ValueError("--int8_hidden is a flag of the eval, inference and serving CLIs: "
                         "the JAX trainer defines no such flag")
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
    """The trainer (ref: train.py#Trainer), on one device or one rank of a
    mesh (module docstring).  ``history`` keeps the metrics of every logged
    step (on a node's first rank), ``state`` the live TrainState, ``mesh``
    the rank mesh, ``restored_step`` the step it resumed from (None: a fresh
    start), ``restore_seconds`` and ``save_seconds`` (step → seconds) the
    checkpoints' times, ``trace_path`` the ``--profile_dir`` trace's file."""

    def __init__(self, args):
        self.args = args
        self.train_dir = args.train_dir
        self.history: List[Dict[str, float]] = []
        self.state = None
        self.mesh = None
        self.restored_step = None
        self.restore_seconds = None
        self.save_seconds: Dict[int, float] = {}
        self.trace_path = None

    def run(self) -> TrainState:
        args = self.args
        fcfg, mcfg, tcfg = configs_from_args(args)
        device = mesh_lib.distributed_init(args.device)
        mesh = self.mesh = mesh_lib.create_mesh(model_parallelism=args.model_parallelism,
                                                dcn_parallelism=args.dcn_parallelism)
        loss_obj = get_loss_by_name(tcfg.label_loss)
        lr_schedule = optimizers.learning_rate_schedule(tcfg)

        if args.start_new_model and mesh.rank == 0 and os.path.exists(self.train_dir):
            log.info("%s: removing existing train dir", task_as_string())
            shutil.rmtree(self.train_dir)
        barrier()
        os.makedirs(self.train_dir, exist_ok=True)

        model = create_model(args.model, mcfg, fcfg.total_size)
        load_flax_variables(model, init_variables_np(mcfg, fcfg, seed=args.seed, model_name=args.model))
        model.to(device)
        split = mesh_lib.shard_model(model, mesh)
        state = self.state = TrainState.create(model, tcfg)
        mngr = CheckpointManager(self.train_dir, keep=tcfg.keep_checkpoint_max or None)
        latest = mngr.latest_step()
        if latest is not None:
            t0 = time.perf_counter()
            state.load_checkpoint(mngr, latest)
            self.restored_step, self.restore_seconds = state.step, time.perf_counter() - t0
            log.info("%s: restored checkpoint at step %d", task_as_string(), state.step)
        train_step = TrainStep(loss_obj, tcfg, mcfg, fcfg.frame_features, mesh=mesh)
        key = prng.key(args.seed)
        log.info("%s: %s on %s, mesh %s, %d parameters on this rank (%d split: %s)", task_as_string(),
                 args.model, device, mesh, sum(p.numel() for p in model.parameters()), len(split), split)

        batches = self._batches(fcfg, mcfg, tcfg)
        log_every = max(args.log_every_n_steps, 1)
        logs = mesh.rank % mesh.ranks_per_input == 0
        last_log_time, last_log_step = time.time(), state.step
        with profile_session(args.profile_dir) as self.trace_path:
            for batch in batches:
                if tcfg.max_steps and state.step >= tcfg.max_steps:
                    break
                local = mesh_lib.local_batch(batch, mesh, train_step.accum)
                device_batch = {k: torch.from_numpy(v).to(device) for k, v in local.items()}
                metrics = train_step(state, device_batch, key)
                if state.step % log_every == 0:
                    # the node's rows, gathered to every rank of the data group
                    preds = mesh_lib.assemble_local_rows(metrics["predictions"], mesh, train_step.accum)
                    if logs:
                        self._log(state.step, float(metrics["loss"]), preds, batch["labels"], lr_schedule,
                                  last_log_time, last_log_step)
                    last_log_time, last_log_step = time.time(), state.step
                if state.step % tcfg.save_checkpoint_every_n_steps == 0:
                    self._save(mngr, state)
                if tcfg.export_model_steps and state.step % tcfg.export_model_steps == 0:
                    # the JAX trainer exports the config it builds, presampled
                    # only under --presample_frames
                    self._export(state, dataclasses.replace(mcfg, presampled=tcfg.presample_frames), fcfg)
        self._save(mngr, state)
        log.info("%s: done; final checkpoint at step %d", task_as_string(), state.step)
        return state

    def _batches(self, fcfg, mcfg, tcfg):
        """The training batches of this rank's input shard (the only one
        before :meth:`run` makes the mesh) from the source the flags select,
        shuffled from --seed (ref: train.py#Trainer.run)."""
        args = self.args
        num_epochs = tcfg.num_epochs if tcfg.num_epochs > 0 else None
        shard_index, num_shards = (0, 1) if self.mesh is None else self.mesh.input_shard
        if args.use_grain or args.packed_cache_dir:
            return cli_flags.input_iterator(args, fcfg, args.train_data_pattern, tcfg.batch_size, num_epochs,
                                            shuffle=True, seed=args.seed, shard_index=shard_index,
                                            num_shards=num_shards)
        if args.use_native_reader:
            return native_batch_iterator(
                args.train_data_pattern, tcfg.batch_size, frame_level=fcfg.frame_features,
                feature_sizes=fcfg.feature_sizes, feature_names=fcfg.feature_names,
                num_classes=mcfg.vocab_size, max_frames=fcfg.max_frames, num_epochs=num_epochs,
                shuffle=True, seed=args.seed + shard_index, num_workers=args.num_readers,
                shard_index=shard_index, num_shards=num_shards)
        return batch_iterator(make_reader(fcfg, mcfg.vocab_size), args.train_data_pattern, tcfg.batch_size,
                              num_epochs=num_epochs, shuffle=True, shuffle_buffer=args.shuffle_buffer,
                              seed=args.seed + shard_index, shard_index=shard_index, num_shards=num_shards)

    def _log(self, step, loss, preds, labels, lr_schedule, since, since_step):
        """``preds``: the node's padded batch's predictions (waits for the
        device); GAP, Hit@1 and PERR on its real rows."""
        preds = preds.float().cpu().numpy()[: labels.shape[0]]
        gap = eval_util.calculate_gap(preds, labels)
        hit1 = eval_util.calculate_hit_at_one(preds, labels)
        perr = eval_util.calculate_precision_at_equal_recall_rate(preds, labels)
        eps = (step - since_step) * self.args.batch_size / max(time.time() - since, 1e-9)
        log.info(
            "%s: training step %d | Loss: %.4f Hit@1: %.4f PERR: %.4f GAP: %.4f | "
            "%.1f examples/sec | lr %.6f",
            task_as_string(), step, loss, hit1, perr, gap, eps, lr_schedule(step),
        )
        self.history.append({"step": step, "loss": loss, "hit1": hit1, "perr": perr, "gap": gap,
                             "examples_per_sec": eps})

    def _export(self, state: TrainState, mcfg, fcfg):
        full = state.full_state_tree()
        if self.mesh.rank == 0:
            export_dir = os.path.join(self.train_dir, "export", f"step_{state.step}")
            params = [(name[len("params/"):].replace("/", "."), t) for name, t in full.items()
                      if name.startswith("params/")]
            tree = state_dict_to_flax(state.model, keep_bf16=True, params=params)
            export_model(export_dir, self.args.model, mcfg, fcfg, tree["params"], tree["batch_stats"])
            log.info("%s: exported model to %s", task_as_string(), export_dir)
        barrier()

    def _save(self, mngr: CheckpointManager, state: TrainState):
        """Rank 0 writes the whole state (each split leaf gathered over its
        group); every rank waits until the step is in place."""
        t0 = time.perf_counter()
        full = state.full_state_tree()
        saved = mngr.save(state.step, full) if self.mesh.rank == 0 else False
        barrier()
        if saved:
            self.save_seconds[state.step] = time.perf_counter() - t0
            log.info("%s: saved checkpoint at step %d", task_as_string(), state.step)


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
