"""Eval entry point (ref: eval.py#main / #evaluation_loop).

Reads the latest checkpoint in ``<train_dir>/checkpoints``
(``core/checkpoints.py``), streams the eval TFRecords once and reports the
epoch's GAP, Hit@1, PERR and loss (and per-class APs on the default
accumulator):

- default: the reference-parity accumulator (host
  ``metrics/eval_util.py#EvaluationMetrics``: exact heap and tie-break
  semantics, per-class APs);
- ``--fast_eval``: the partials of ``ops/metrics_ops.py`` on the device
  and one host sort per epoch (``StreamingGAP``).

The forward is the registered ``nn.Module`` of ``--model`` (frame-level or
video-level input), or with ``--fast_forward`` its BN-folded fast path
(``ops/fast_dispatch.py``, the CUDA kernels on the card).  Each batch draws
its frames from ``fold_in(key(0), batch)``, as the JAX CLI does.
As the JAX eval does, it polls the latest step every
``--poll_interval_secs``, evaluates each new step once and writes its
``epoch_summary`` to ``<train_dir>/eval`` at that step; ``--run_once``
evaluates the latest step once.  A weights-only ``variables.npz``
(``--train_dir`` names the file, or a directory without ``checkpoints/``)
is step 0, and so is ``--reference_checkpoint``, a reference-trained TF
checkpoint (``core/checkpoint_import.py``), evaluated once without a
summary.  It takes every flag of the JAX eval CLI under its name and
default (``cli_flags.py``); ``--device`` (default ``cuda``) is the port's
own.  Batches come from the source the flags select
(``cli_flags.input_iterator``: ``--packed_cache_dir``, ``--use_grain`` or
the streaming reader).

Under ``torchrun`` on one node it runs over the node's ranks, as the JAX
CLI runs over the host's chips (``parallel/mesh.py``): every rank reads
the stream, pads each batch to a multiple of the ranks and runs the forward
on its row block, with ``--model_parallelism`` ranks splitting the hidden
FC and the MoE kernels (on both routes); the rows are gathered and rank 0
alone accumulates the metrics and writes the summary.  Over more than one
node it raises the JAX CLI's RuntimeError, and a mesh that does not match
the ranks its ValueError.

    python -m learnablepoolingmethods_torch.eval --run_once \\
        --model=NetVLADModelLF --frame_features --feature_names=rgb,audio \\
        --feature_sizes=1024,128 --eval_data_pattern='/data/validate*.tfrecord' \\
        --train_dir=/ckpt
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from learnablepoolingmethods_torch import cli_flags
from learnablepoolingmethods_torch.config import FeatureConfig
from learnablepoolingmethods_torch.core import step as step_lib
from learnablepoolingmethods_torch.core.observability import MetricWriter
from learnablepoolingmethods_torch.core.checkpoints import latest_weights_step, load_weights
from learnablepoolingmethods_torch.core.weights import convert_flax_variables
from learnablepoolingmethods_torch.inference import load_model, load_tree
from learnablepoolingmethods_torch.losses import get_loss_by_name
from learnablepoolingmethods_torch.metrics import eval_util
from learnablepoolingmethods_torch.ops.fast_dispatch import (
    fast_path_models,
    get_fast_path,
    int8_capable_models,
    shard_fast_params,
)
from learnablepoolingmethods_torch.parallel import mesh as mesh_lib
from learnablepoolingmethods_torch.parallel.collectives import broadcast_object, gather_rows
from learnablepoolingmethods_torch.utils import prng
from learnablepoolingmethods_torch.utils.misc import InFlight

log = logging.getLogger(__name__)


# the JAX eval CLI's own flags (learnablepoolingmethods_tpu/eval.py
# #define_flags) and the port's --device: name → (default, help)
_OWN_FLAGS = {
    "eval_data_pattern": ("", "File glob for eval TFRecords."),
    "train_dir": ("/tmp/yt8m_model/", "Directory of checkpoints (or of a variables.npz, or the file)."),
    "run_once": (False, "Evaluate once instead of polling."),
    "top_k": (20, "How many predictions to keep per video."),
    "fast_eval": (False, "Use on-device metric partials (no per-class APs)."),
    "fast_forward": (False, "Run the BN-folded fast forward (CUDA kernels on the card) instead of "
                            "the nn.Module model."),
    "poll_interval_secs": (30, "Seconds between checkpoint polls."),
    "reference_checkpoint": ("", "Evaluate a reference-trained TF checkpoint."),
    "pipeline_depth": (2, "Batches kept in flight before fetching results (1 = synchronous)."),
    "device": ("cuda", "Torch device: cuda (default), cuda:N or cpu."),
}


def build_parser() -> argparse.ArgumentParser:
    """Every flag of the JAX eval CLI (cli_flags.py), its defaults, and
    --device."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    return cli_flags.add_flags(p, _OWN_FLAGS)


def _fast_forward(args, fcfg: FeatureConfig, mcfg, tree, device, mesh):
    """``forward(batch, key, row_offset)`` → probabilities of
    ``--fast_forward``: the fast path, its product weights split over the
    mesh's model group."""
    if args.model not in fast_path_models():
        raise ValueError(f"--fast_forward supports {fast_path_models()}, got {args.model!r}")
    if not fcfg.frame_features:
        raise ValueError(f"--fast_forward with {args.model} needs --frame_features")
    path = get_fast_path(args.model)
    if args.int8_hidden and mesh.model_size > 1:
        raise ValueError("--int8_hidden with --model_parallelism > 1 is not supported (see inference.py)")
    fp = path.prepare(convert_flax_variables(tree, mcfg, args.model), mcfg, int8_hidden=args.int8_hidden,
                      device=device)
    fp = shard_fast_params(fp, mesh)
    fast = path.build(mcfg, return_probs=True)

    def forward(batch, key, row_offset):
        return fast(fp, batch["features"], batch["num_frames"], key, row_offset=row_offset).float()

    return forward


def evaluate_checkpoint(args, step_num: int, tree: dict, fcfg: FeatureConfig, loss_obj, device, mesh) -> dict:
    """One pass over ``--eval_data_pattern`` with the weights of ``tree``
    (flax ``{params, batch_stats}``) over the ranks of ``mesh`` →
    {avg_hit_at_one, avg_perr, avg_loss, gap, aps} on rank 0, None on the
    other ranks."""
    if args.fast_forward:
        mcfg = cli_flags.model_config_from_args(args)
        forward = _fast_forward(args, fcfg, mcfg, tree, device, mesh)
    else:
        model, mcfg = load_model(args, fcfg, device, tree)
        mesh_lib.shard_model(model, mesh)
        model_forward = step_lib.inference_forward(model, mcfg, fcfg.frame_features)

        def forward(batch, key, row_offset):
            return model_forward(batch["features"], batch.get("num_frames"), key, row_offset)

    use_fast = args.fast_eval
    if use_fast:
        sgap = eval_util.StreamingGAP()
        hit_sum = perr_sum = loss_sum = w_sum = 0.0
    else:
        em = eval_util.EvaluationMetrics(mcfg.vocab_size, args.top_k)

    examples = 0
    t0 = time.time()
    pipe = InFlight(args.pipeline_depth)

    def accumulate_one(item):
        nonlocal examples, hit_sum, perr_sum, loss_sum, w_sum
        w, labels_host, out = item
        real = int(w.sum())
        examples += real
        if use_fast:
            p = out["partials"]
            sgap.accumulate(p.topk_scores.cpu().numpy()[w > 0], p.topk_labels.cpu().numpy()[w > 0],
                            float(p.num_positives))
            hit_sum += float(p.hit_at_one_sum)
            perr_sum += float(p.perr_sum)
            loss_sum += float(out["loss"]) * real
            w_sum += real
        else:
            preds = out["predictions"].float().cpu().numpy()[w > 0]
            em.accumulate(preds, labels_host[w > 0], float(out["loss"]))

    for batch_idx, batch in enumerate(cli_flags.input_iterator(args, fcfg, args.eval_data_pattern, args.batch_size,
                                                               num_epochs=1)):
        batch = mesh_lib.pad_batch_to_multiple(batch, mesh.ranks_per_input)
        local = mesh_lib.local_batch(batch, mesh)
        device_batch = {k: torch.from_numpy(v).to(device) for k, v in local.items()}
        # a fresh sampling key per batch; the results are read only once
        # `pipeline_depth` batches are in flight
        predictions = forward(device_batch, prng.fold_in(prng.key(0), batch_idx),
                              mesh.row_offset(local["features"].shape[0]))
        if mesh.data_group is not None:
            predictions = gather_rows(predictions, mesh.data_group)
            device_batch = {k: torch.from_numpy(batch[k]).to(device) for k in ("labels", "weights")}
        if mesh.rank != 0:
            continue
        out = step_lib.eval_outputs(predictions, device_batch, loss_obj, args.top_k)
        done = pipe.add((np.asarray(batch["weights"]), batch["labels"], out))
        if done is not None:
            accumulate_one(done)
    if mesh.rank != 0:
        return None
    for done in pipe.drain():
        accumulate_one(done)

    dt = time.time() - t0
    if use_fast:
        info = {
            "avg_hit_at_one": hit_sum / max(w_sum, 1),
            "avg_perr": perr_sum / max(w_sum, 1),
            "avg_loss": loss_sum / max(w_sum, 1),
            "gap": sgap.get(),
            "aps": None,
        }
    else:
        info = em.get()
    log.info(
        "epoch/eval number %d | Avg_Hit@1: %.5f | Avg_PERR: %.5f | MAP: %s | "
        "GAP: %.5f | Avg_Loss: %.5f | %d examples in %.1fs (%.1f ex/s)",
        step_num, info["avg_hit_at_one"], info["avg_perr"],
        "%.5f" % float(np.mean(info["aps"])) if info["aps"] else "n/a",
        info["gap"], info["avg_loss"], examples, dt, examples / max(dt, 1e-9),
    )
    return info


def evaluation_loop(args):
    """Evaluate the latest step of ``--train_dir`` once (``--run_once``) or
    each new step as it appears; returns the info of a ``--run_once``
    evaluation (None if there was nothing to evaluate, and on every rank but
    0).  Summaries go to ``<train_dir>/eval`` at the step evaluated."""
    if args.int8_hidden and (not args.fast_forward or args.model not in int8_capable_models()):
        raise ValueError(f"--int8_hidden requires --fast_forward with one of {int8_capable_models()}")
    if mesh_lib.process_count() > 1:
        # the reference's eval is a single machine: one node's ranks here
        raise RuntimeError("eval runs on one node; launch it on one node "
                           f"(process_count={mesh_lib.process_count()})")
    device = mesh_lib.distributed_init(args.device)
    mesh = mesh_lib.create_mesh(model_parallelism=args.model_parallelism,
                                dcn_parallelism=args.dcn_parallelism)
    fcfg = FeatureConfig.from_flag_strings(args.feature_names, args.feature_sizes,
                                           args.frame_features, args.max_frames)
    loss_obj = get_loss_by_name(args.label_loss)
    if args.reference_checkpoint:
        return evaluate_checkpoint(args, 0, load_tree(args, fcfg), fcfg, loss_obj, device, mesh)
    root = os.path.dirname(args.train_dir) if os.path.isfile(args.train_dir) else args.train_dir
    writer = MetricWriter(os.path.join(root, "eval")) if mesh.rank == 0 else None
    last = None
    try:
        while True:
            # every rank evaluates the step rank 0 sees
            step = broadcast_object(latest_weights_step(args.train_dir))
            if step is None:
                log.info("No checkpoint yet in %s", args.train_dir)
            elif step != last:
                info = evaluate_checkpoint(args, step, load_weights(args.train_dir, step), fcfg,
                                           loss_obj, device, mesh)
                if writer is not None:
                    writer.epoch_summary(step, info)
                    writer.flush()
                last = step
                if args.run_once:
                    return info
            if args.run_once:
                return None
            time.sleep(args.poll_interval_secs)
    finally:
        if writer is not None:
            writer.close()


def main(argv=None):
    return evaluation_loop(build_parser().parse_args(argv))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
