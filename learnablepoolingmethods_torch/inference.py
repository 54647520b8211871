"""Inference entry point (ref: inference.py#main / #inference / #format_lines).

Streams frame-level TFRecords through the fast NetVLADModelLF forward and
on-device top-k, and writes the Kaggle submission CSV
``VideoId,LabelConfidencePairs``.  The flags keep the JAX CLI's names;
``--device`` (default ``cuda``) is the port's own.  Weights come from
``<train_dir>/variables.npz`` (``core/weights.py#save_variables_npz``).

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

from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core.weights import convert_flax_variables, load_variables_npz
from learnablepoolingmethods_torch.data.pipeline import batch_iterator
from learnablepoolingmethods_torch.data.readers import YT8MFrameFeatureReader
from learnablepoolingmethods_torch.ops.fast_dispatch import get_fast_path
from learnablepoolingmethods_torch.utils import prng
from learnablepoolingmethods_torch.utils.misc import InFlight, add_bool_flag, format_lines, resolve_device

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input_data_pattern", default="", help="File glob for input TFRecords.")
    p.add_argument("--train_dir", default="/tmp/yt8m_model/", help="Directory (or file) of variables.npz.")
    p.add_argument("--output_file", default="", help="Destination CSV path.")
    p.add_argument("--top_k", type=int, default=20, help="How many predictions to write per video.")
    add_bool_flag(p, "fast_infer", False, "Use the fused inference path (BN folding, CUDA kernels, bf16).")
    add_bool_flag(p, "int8_hidden", False, "Weight-only int8 hidden FC (not ported yet).")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="Batches kept in flight before fetching results (1 = synchronous).")
    p.add_argument("--batch_size", type=int, default=1024, help="Videos per batch.")
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
    p.add_argument("--iterations", type=int, default=30, help="Number of frames to sample per video.")
    add_bool_flag(p, "sample_random_frames", True, "Sample random frames (with replacement).")
    p.add_argument("--netvlad_cluster_size", type=int, default=256, help="NetVLAD clusters (rgb).")
    p.add_argument("--netvlad_hidden_size", type=int, default=1024, help="NetVLAD hidden size.")
    add_bool_flag(p, "netvlad_add_batch_norm", True, "BN in NetVLAD models.")
    add_bool_flag(p, "netvlad_relu", False, "relu6 after the hidden layer.")
    p.add_argument("--netvlad_dimred", type=int, default=-1, help="Input dim-reduction width (-1 = off).")
    add_bool_flag(p, "gating", True, "Context gating before the classifier.")
    p.add_argument("--device", default="cuda", help="Torch device: cuda (default), cuda:N or cpu.")
    return p


def model_config_from_args(args) -> ModelConfig:
    return ModelConfig(
        vocab_size=args.num_classes,
        moe_num_mixtures=args.moe_num_mixtures,
        iterations=args.iterations,
        sample_random_frames=args.sample_random_frames,
        netvlad_cluster_size=args.netvlad_cluster_size,
        netvlad_hidden_size=args.netvlad_hidden_size,
        netvlad_add_batch_norm=args.netvlad_add_batch_norm,
        netvlad_relu=args.netvlad_relu,
        netvlad_dimred=args.netvlad_dimred,
        gating=args.gating,
        video_level_classifier_model=args.video_level_classifier_model,
    )


def inference(args) -> int:
    """Write the CSV for ``args``; returns the number of videos written."""
    if not args.fast_infer:
        raise NotImplementedError(
            "the flax-forward route (without --fast_infer) needs the trainable "
            "NetVLADModelLF modules: ROADMAP item 4; pass --fast_infer"
        )
    device = resolve_device(args.device)
    fcfg = FeatureConfig.from_flag_strings(
        args.feature_names, args.feature_sizes, args.frame_features, args.max_frames
    )
    if not fcfg.frame_features:
        raise ValueError("--fast_infer with NetVLADModelLF needs --frame_features")
    mcfg = model_config_from_args(args)
    path = get_fast_path(args.model)

    variables = convert_flax_variables(load_variables_npz(args.train_dir), mcfg)
    fp = path.prepare(variables, mcfg, int8_hidden=args.int8_hidden, device=device)
    del variables
    fast = path.build(mcfg, top_k=args.top_k)
    log.info("loaded %s from %s onto %s", args.model, args.train_dir, device)

    reader = YT8MFrameFeatureReader(
        num_classes=args.num_classes,
        feature_sizes=fcfg.feature_sizes,
        feature_names=fcfg.feature_names,
        max_frames=fcfg.max_frames,
    )
    pipe = InFlight(args.pipeline_depth)
    num_examples = 0
    start = time.time()

    def flush_one(out_file, item):
        nonlocal num_examples
        vids, real, values, indices = item
        vals_np = values.cpu().numpy()[real]  # waits for the device
        idx_np = indices.cpu().numpy()[real]
        num_examples += int(real.sum())
        out_file.writelines(line.encode() for line in format_lines(vids, vals_np, idx_np))
        elapsed = time.time() - start
        log.info(
            "num examples processed: %d | elapsed seconds: %.2f (%.1f ex/s)",
            num_examples, elapsed, num_examples / max(elapsed, 1e-9),
        )

    with open(args.output_file, "wb") as out_file:
        out_file.write(b"VideoId,LabelConfidencePairs\n")
        batches = batch_iterator(reader, args.input_data_pattern, args.batch_size, num_epochs=1)
        for batch_idx, batch in enumerate(batches):
            # a fresh sampling key per batch, as the JAX CLI's
            # fold_in(key(0), batch_idx): the same frames, bit for bit
            key = prng.fold_in(prng.key(0), batch_idx)
            feats = torch.from_numpy(batch["features"]).to(device)
            nf = torch.from_numpy(batch["num_frames"]).to(device)
            values, indices = fast(fp, feats, nf, key)
            real = np.asarray(batch["weights"]) > 0
            vids = [v for v, keep in zip(batch["video_id"], real) if keep]
            done = pipe.add((vids, real, values, indices))
            if done is not None:
                flush_one(out_file, done)
        for done in pipe.drain():
            flush_one(out_file, done)
    log.info("done; wrote %s", args.output_file)
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
