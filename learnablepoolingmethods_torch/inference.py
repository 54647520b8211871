"""Inference entry point (ref: inference.py#main / #inference / #format_lines).

Streams TFRecords through a model and on-device top-k, and writes the
Kaggle submission CSV ``VideoId,LabelConfidencePairs``.  Two routes:

- default, the model-forward route: the registered ``nn.Module`` of
  ``--model`` (``models/``, every model of the JAX zoo) with
  ``training=False`` and f32 probabilities
  (``core/step.py#make_predict_step``), on frame-level or video-level
  input (``--frame_features``);
- ``--fast_infer``: the BN-folded fast forward of ``--model``
  (``ops/fast_dispatch.py``: ``NetVLADModelLF``, ``DbofModel``, the LF
  models, ``TransformerEncoderModel`` and ``AttentionNetVLADModel``),
  frame-level input only; the models without a fast path in the JAX
  package (``AttentionPoolingModel``, the RNNs, the logistic and MoE
  models) raise ValueError, as the JAX CLI does.

It takes every flag of the JAX CLI under its name and default
(``cli_flags.py``); ``--device`` (default ``cuda``) is the port's own.
Under ``torchrun`` on one node it runs over the node's ranks, as the JAX
CLI runs over the host's chips (``parallel/mesh.py``): each batch padded
to a multiple of the ranks, each rank's row block through the forward,
``--model_parallelism`` ranks splitting the hidden FC and the MoE kernels
on both routes (``--int8_hidden`` with a model axis raises the JAX CLI's
ValueError), the top-k gathered, and rank 0 alone writes the CSV.  Over
more than one node it raises the JAX CLI's RuntimeError.  Batches come from the source the
flags select (``cli_flags.input_iterator``: ``--packed_cache_dir``,
``--use_grain`` or the streaming reader), and the CSV is written by the C++
formatter (``data/native_loader.py#format_csv``, ``format_lines``' bytes),
which raises if it does not build.  Weights come from the latest
checkpoint in ``<train_dir>/checkpoints`` (``core/checkpoints.py``; IOError
when there is none), from a weights-only ``variables.npz``
(``core/weights.py#save_variables_npz``) when ``--train_dir`` names such a
file or a directory without ``checkpoints/``, or with
``--reference_checkpoint`` from a reference-trained TF checkpoint
(``core/checkpoint_import.py``, no tensorflow needed).

    python -m learnablepoolingmethods_torch.inference --fast_infer \\
        --model=NetVLADModelLF --frame_features --feature_names=rgb,audio \\
        --feature_sizes=1024,128 --input_data_pattern='/data/test*.tfrecord' \\
        --train_dir=/ckpt --output_file=/tmp/preds.csv
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from learnablepoolingmethods_torch import cli_flags
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core.checkpoint_import import tree_from_reference_checkpoint
from learnablepoolingmethods_torch.core.checkpoints import latest_weights_step, load_weights
from learnablepoolingmethods_torch.core.step import make_predict_step
from learnablepoolingmethods_torch.core.weights import convert_flax_variables, load_flax_variables
from learnablepoolingmethods_torch.data import native_loader
from learnablepoolingmethods_torch.models import create_model, find_class_by_name
from learnablepoolingmethods_torch.ops.fast_dispatch import get_fast_path, int8_capable_models, shard_fast_params
from learnablepoolingmethods_torch.parallel import mesh as mesh_lib
from learnablepoolingmethods_torch.parallel.collectives import gather_rows
from learnablepoolingmethods_torch.utils import prng
from learnablepoolingmethods_torch.utils.misc import InFlight

log = logging.getLogger(__name__)


# the JAX inference CLI's own flags (learnablepoolingmethods_tpu/inference.py
# #define_flags) and the port's --device: name → (default, help)
_OWN_FLAGS = {
    "input_data_pattern": ("", "File glob for input TFRecords."),
    "train_dir": ("/tmp/yt8m_model/", "Directory of checkpoints (or of a variables.npz, or the file)."),
    "output_file": ("", "Destination CSV path."),
    "top_k": (20, "How many predictions to write per video."),
    "fast_infer": (False, "Use the fused inference path (BN folding, CUDA kernels, bf16)."),
    "reference_checkpoint": ("", "Run inference from a reference-trained TF checkpoint."),
    "pipeline_depth": (2, "Batches kept in flight before fetching results (1 = synchronous)."),
    "device": ("cuda", "Torch device: cuda (default), cuda:N or cpu."),
}


def build_parser() -> argparse.ArgumentParser:
    """Every flag of the JAX inference CLI (cli_flags.py), its defaults, and
    --device; the training schedule's have no effect here, as in the JAX
    CLI."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    return cli_flags.add_flags(p, _OWN_FLAGS)


def model_config_from_args(args) -> ModelConfig:
    """The ModelConfig of every model flag, as the JAX CLI builds it (its
    fast paths compute in bf16 whatever --compute_dtype says, and so do the
    port's)."""
    return cli_flags.model_config_from_args(args)


def load_model(args, fcfg: FeatureConfig, device: torch.device, tree: dict):
    """The registered ``nn.Module`` of ``--model`` with the weights of
    ``tree`` (flax ``{params, batch_stats}``) on ``device``, in eval mode,
    and its ModelConfig.  A model that samples frames is built
    ``presampled``: the predict and eval steps gather its frames in uint8
    (``core/step.py``)."""
    presampled = fcfg.frame_features and find_class_by_name(args.model).samples_frames
    mcfg = cli_flags.model_config_from_args(args, presampled=presampled)
    model = create_model(args.model, mcfg, fcfg.total_size)
    load_flax_variables(model, tree)
    return model.to(device).eval(), mcfg


def load_tree(args, fcfg: FeatureConfig) -> dict:
    """The weights the CLI serves (module docstring), as the JAX CLI finds
    them: the reference checkpoint, else the latest of ``--train_dir``."""
    if args.reference_checkpoint:
        tree = tree_from_reference_checkpoint(args.reference_checkpoint, args.model,
                                              cli_flags.model_config_from_args(args), fcfg)
        log.info("imported reference checkpoint %s", args.reference_checkpoint)
        return tree
    step = latest_weights_step(args.train_dir)
    if step is None:
        raise IOError(f"no checkpoint found in {args.train_dir}")
    log.info("restored checkpoint at step %d", step)
    return load_weights(args.train_dir, step)


def inference(args) -> int:
    """Write the CSV for ``args``; returns the number of videos written (0
    on every rank but 0)."""
    if mesh_lib.process_count() > 1:
        # single-controller by design (mirrors eval): one node's ranks
        raise RuntimeError("inference runs on one node; launch it on one node "
                           f"(process_count={mesh_lib.process_count()})")
    device = mesh_lib.distributed_init(args.device)
    mesh = mesh_lib.create_mesh(model_parallelism=args.model_parallelism,
                                dcn_parallelism=args.dcn_parallelism)
    fcfg = FeatureConfig.from_flag_strings(
        args.feature_names, args.feature_sizes, args.frame_features, args.max_frames
    )
    if args.fast_infer and not fcfg.frame_features:
        raise ValueError(f"--fast_infer with {args.model} needs --frame_features")
    if args.int8_hidden and (not args.fast_infer or args.model not in int8_capable_models()):
        raise ValueError(f"--int8_hidden requires --fast_infer with one of {int8_capable_models()}")
    path = get_fast_path(args.model) if args.fast_infer else None
    if args.fast_infer and args.int8_hidden and mesh.model_size > 1:
        raise ValueError("--int8_hidden with --model_parallelism > 1 is not supported (int8 targets "
                         "single-chip HBM; a sharded model already halves per-chip weight traffic)")
    tree = load_tree(args, fcfg)
    if args.fast_infer:
        mcfg = model_config_from_args(args)
        variables = convert_flax_variables(tree, mcfg, args.model)
        fp = shard_fast_params(path.prepare(variables, mcfg, int8_hidden=args.int8_hidden, device=device), mesh)
        del variables
        fast = path.build(mcfg, top_k=args.top_k)

        def predict(feats, nf, key, row_offset):
            return fast(fp, feats, nf, key, row_offset=row_offset)
    else:
        model, mcfg = load_model(args, fcfg, device, tree)
        mesh_lib.shard_model(model, mesh)
        predict = make_predict_step(model, mcfg, fcfg.frame_features, top_k=args.top_k)
    del tree
    log.info("loaded %s onto %s, mesh %s", args.model, device, mesh)

    native_loader.load()  # the CSV's formatter: build it before the first batch
    pipe = InFlight(args.pipeline_depth)
    num_examples = 0
    start = time.time()

    def flush_one(out_file, item):
        nonlocal num_examples
        vids, real, values, indices = item
        vals_np = values.cpu().numpy()[real]  # waits for the device
        idx_np = indices.cpu().numpy()[real]
        num_examples += int(real.sum())
        out_file.write(native_loader.format_csv(vids, vals_np, idx_np))
        elapsed = time.time() - start
        log.info(
            "num examples processed: %d | elapsed seconds: %.2f (%.1f ex/s)",
            num_examples, elapsed, num_examples / max(elapsed, 1e-9),
        )

    out_file = open(args.output_file, "wb") if mesh.rank == 0 else None
    try:
        if out_file is not None:
            out_file.write(b"VideoId,LabelConfidencePairs\n")
        batches = cli_flags.input_iterator(args, fcfg, args.input_data_pattern, args.batch_size, num_epochs=1)
        for batch_idx, batch in enumerate(batches):
            # a fresh sampling key per batch, as the JAX CLI's
            # fold_in(key(0), batch_idx): the same frames, bit for bit
            key = prng.fold_in(prng.key(0), batch_idx)
            batch = mesh_lib.pad_batch_to_multiple(batch, mesh.ranks_per_input)
            local = mesh_lib.local_batch(batch, mesh)
            feats = torch.from_numpy(local["features"]).to(device)
            nf = torch.from_numpy(local["num_frames"]).to(device) if "num_frames" in local else None
            values, indices = predict(feats, nf, key, mesh.row_offset(feats.shape[0]))
            values, indices = gather_rows(values, mesh.data_group), gather_rows(indices, mesh.data_group)
            if out_file is None:
                continue
            real = np.asarray(batch["weights"]) > 0
            vids = [v for v, keep in zip(batch["video_id"], real) if keep]
            done = pipe.add((vids, real, values, indices))
            if done is not None:
                flush_one(out_file, done)
        if out_file is not None:
            for done in pipe.drain():
                flush_one(out_file, done)
            log.info("done; wrote %s", args.output_file)
    finally:
        if out_file is not None:
            out_file.close()
    return num_examples


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.output_file:
        raise ValueError("'output_file' was not specified. Unable to continue with inference.")
    if not args.input_data_pattern:
        raise ValueError("'input_data_pattern' was not specified. Unable to continue with inference.")
    return inference(args)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
