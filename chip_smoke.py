"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

from the root of a checkout.  It imports nothing of JAX, fails on any
error, and prints one JSON line per phase:

1. env        torch and CUDA versions, the card's name and power limit;
2. build      nvcc builds every kernel under learnablepoolingmethods_torch/csrc,
              one process per source, and beside them an -Xptxas -v compile of
              the NetVLAD inference and training kernels' and the NetFV
              kernel's sources: registers, static shared memory and spills
              per kernel; g++ builds the C++ TFRecord reader and CSV
              formatter (learnablepoolingmethods_torch/native) at the same
              time; the native runner's library (row 1's source compiled in,
              linked with cuBLAS) builds among the kernels, then g++ links
              lpm_serve with it;
3. kernels    both inference kernels against their plain PyTorch versions
              (KERNEL_CHECKS): Willow shapes (D 1024/128, K 256/128), B=64,
              S=30, S=300 and S=1 (where each descriptor shows which frame the
              front end drew), S=31 and 33 (a partial stage of the bf16
              aggregation's ring), K 500/512 (the two-pass aggregation at
              D=1024, a two-block cluster at D=128), num_frames including 1
              and 300, and one small shape off every tile width; bf16
              netvlad_fused through both its one- and two-pass aggregation;
              every bf16 result equal bit for bit to a second launch's, and
              the built kernel's tiling equal to ops/netvlad_fused.py's; for a
              bf16 output |Δ| <= 1e-2·max|ref| + 2e-2·|ref| in f32 (one bf16
              rounding of the output plus another f32 summation order; the
              per-element magnitude at full width is about 2e-3, so an
              absolute 2e-2 would test nothing), for an f32 output
              1e-5·max|ref| + 1e-5·|ref| (the summation order alone); then
              netvlad_fused at AttentionNetVLAD's shape (B=256, 300 contiguous
              bf16 rows, D=1024, K=256), checked and timed; times at B=512,
              S=30 and S=300 with CUDA events, the two-pass aggregation's
              beside the one-pass one's;
   fused_adam FusedAdam (csrc/fused_adam.cu) against its plain version on
              the same Philox bits: the whole Willow tree (306.6M bf16
              parameters, clip 1) and edge leaves (1, 7, 1,023 entries, one
              off the vector width and off the 16-byte grid, an f32 leaf,
              non-finite and near-max entries), with and without the clip;
              m bit for bit, p and ν on a bf16 neighbour of the plain f32
              value, a second launch bit for bit, SR-ν within 1 % of the
              f32 EMA over 300 steps; its time beside the bound, the plain
              version, the eager f32 Adam and torch's fused Adam (context);
   int8_matmul
              the W8A16 kernel (csrc/int8_matmul.cu) against its plain
              version at the --int8_hidden FC shapes, B 1, 32, 256, 512, the
              bias fused, K=4,112 with a zero column (INT8_GATE); the
              library's tiles against int8_geometry's; times at the Willow
              rgb FC beside the bound and cuBLAS bf16 (CUDA events and the
              profiler's device clock);
   dropout    the dropout kernel (csrc/dropout.cu, flax's nn.Dropout and
              attention-weight dropout): its keep mask, and the forward's
              bits, equal bit for bit to utils/prng.py's (packed by
              ops/dropout.py#pack_mask) at [1, 1, 300, 300], [76,800, 1024]
              and sizes 1, 7, 1,023 and 2²⁴ + 3; both rules forward and
              backward (the backward launch from the forward's bits) in bf16
              and f32 equal bit for bit to the plain arithmetic on the
              host's mask, a second launch too, and the backward launch on
              the inverted bits equal to the inverted mask's (it reads the
              bits, it hashes nothing); the forward's and the backward's
              times at config 5's FFN output (B=256) beside their bounds
              (the hash at the integer issue rate, PEAK_INT_OPS), the plain
              versions (the forward's host draw included) and F.dropout's and
              native_dropout_backward's (context), the attention call's too,
              and the forward kernel's SASS by integer pipe;
4. e2e        full-width Willow GatedNetVLAD-256 weights from a seed (hidden
              FC 278528×1024, V=3862, M=2, BN stats perturbed) and 96
              synthetic videos driven down two paths, each with the launch
              counters zeroed just before it and read just after: the
              inference CLI (--batch_size=32 --fast_infer --device=cuda),
              which must launch the front-end kernel once per batch, and the
              staged route of build_fast_netvlad_inference, which must launch
              netvlad_fused twice per batch.  The fused and plain routes then
              run on the same batches and sampled indices; the three routes'
              probabilities must agree within 1e-2;
   int8_e2e   the inference CLI with --fast_infer --int8_hidden on the same
              weights and videos (the W8A16 kernel twice a batch), within
              5e-2 of the bf16 route's probabilities; videos/s at B=256 and
              512, int8 beside bf16;
   serve      item 14 on the same weights: phase 4 exports its tree with
              export_model.py (the JAX package's artifact; params.msgpack
              holds the hidden FC in flax's chunked form), the export
              reloaded bit for bit, then ModelServer over it: --fast_serve
              (the front-end kernel once per batch, warmup included) and
              --fast_serve --int8_hidden (also the W8A16 kernel twice a
              batch) on the 96 videos, each within 1e-2 of its plain route
              on the same padded batches drawn from prng.key(0), the
              model-forward route within 1e-5 of make_predict_step;
              predict_pairs' videos/s at serving batch 32 and 256 with the
              host's parse ms and the device ms per batch; HTTP on
              127.0.0.1 with the BatchingQueue on the main thread, 8 clients
              × 16 requests × 4 videos, linger 2 ms: requests/s, videos/s,
              p50/p99 latency, the coalesced share;
   native_serve
              item 14b on the same weights (phase_native_serve): the export
              with with_stablehlo=True at batch 32 and 256 (seconds, the
              bytes of weights.bin, its arrays bit for bit the serve phase's
              folded weights); ModelServer(native=True) through the native
              runner (csrc/native_runner.cu: row 1, cuBLAS, four tail
              kernels) with row 1 and each tail kernel once a batch by the
              runner's own counts, its scores within 1e-2 of the plain
              route, its probabilities within NATIVE_GATE of the fused
              route with kernels at 32 and 256 and its top-k that of its own
              probabilities; each tail kernel against its plain version
              (TAIL_GATES; the top-k bit for bit, also on rows of ±0 and
              ±NaN, at every path of topk and moe_combine: tail_paths)
              and timed beside its bound and torch; the native
              route's videos/s beside predict_pairs'; lpm_serve (linked in
              the build phase): --check, its answers equal to the in-process
              runner's, the HTTP load of the serve phase beside the Python
              server's, /statz coalescing, exit 0 on SIGTERM;
   native_routes
              item 14c (phase_native_routes): LogisticModel and MoeModel
              (video-level, f32), DbofModel-8192 (iid frames and one window
              a video), NetRVLAD-256, SoftDBoW-4096, NetFV-64,
              NeXtVLAD-128, and (item 14c.3) TransformerEncoderModel and
              AttentionNetVLADModel at config 5's widths (row 7 once a layer)
              and FrameLevelLogisticModel (f32), and (item 14c.5)
              AttentionPoolingModel, LstmModel and GruModel at their
              default widths (f32: pool_attention, 600 lstm_cell launches
              or 2 gru_layer launches a batch), each exported with
              with_stablehlo=True at batch 256 and served by
              ModelServer(native=True) on 96 records with the runner's
              launches of its route's kernels once a batch (rows 2, 6 and 5
              twice: a modality each) and no torch-route launch; the
              runner's probabilities on a padded batch of 256 within
              NATIVE_ROUTE_GATES of the port's torch route on the card (the
              f32 model forward; the fast route with its kernels; for the
              DBoF window the plain versions), its top-k that of its
              probabilities, its videos/s; NeXtVLAD and the routes that read
              every frame traced step by step against the torch route
              (nextvlad_trace, all_frames_trace); cuDNN's LSTM and GRU over
              the same frames as a yardstick for the RNN routes (the GRU's
              one layer also alone, gru_layer's library time); lpm_serve
              answering NATIVE_ROUTES_HTTP over HTTP as the in-process
              runner does; then each new kernel against its plain version
              (ROUTE_KERNEL_GATES) at its main-path shape (pool_attention
              also at POOL_EDGE_SHAPES; gru_layer at B=256, F=300, H=1024,
              the carry at the first and last frame and of a row of no
              frames, and at GRU_EDGE_SHAPES), timed beside its bound;
              frame_stage's four modes on its word and byte paths and an
              unaligned base, nextvlad_residual at NeXtVLAD's rgb and audio
              widths and an odd shape (check_stage_paths), and both timed
              alone on input sets in turn that outrun the L2 and on one set
              read again, on the profiler's device clock and by CUDA events
              (stage_timing);
5. throughput the fused inference route at B=512, S=30: videos/s (the median
              of five rounds of timed batches) and per-stage ms; then
   profile    torch.profiler over five fused batches: device ms per kernel
              name and the device's idle share;
6. train_kernels
              both training kernels (the NetVLAD aggregation's forward and
              backward) against their plain versions: the output, dX, dL and
              dC₂, X in bf16 and f32, at both Willow modalities, B=64, S=30
              and S=300, at S 1, 31 and 33 (across the 16-sample stages), at K
              500 and 512 (past a portable cluster at D=1024, a cluster of two
              at D=128), at one small shape off every tile width and at the
              one module of NetVLAD with --netvlad_dimred=256 (D=K=256), with the
              tolerances above chosen by X's dtype; every bf16 output equal bit
              for bit to a second launch's, and the built kernels' tiling equal
              to ops/netvlad_train.py#train_geometry; dC₂ of a batch against
              the kernel's dC₂ of each video alone, summed, and at B=1 against
              the per-video formula; at B=256, S=30 and S=300, X in bf16, all
              four outputs and the per-video dC₂ sum again, and the times
              beside the first port's;
7. train_e2e  the train CLI at full Willow width on 512 synthetic videos:
              five bf16 steps with --fused_train_aggregation (the main path
              of this slice; each training kernel must launch twice a step),
              the same five steps without it, and both again in f32; the
              losses must be finite and fall, and agree between the routes
              (see phase_train_e2e); then the inference CLI reads the trained
              checkpoint and writes a CSV row per video;
   train_resume
              checkpoints and resume at full Willow width (B=256, S=30, bf16,
              fused): the train CLI for two steps saving every two and
              keeping one, a half-written temporary step planted, the CLI
              again to step 4; gates: the restore at step 2, every leaf of
              the step-2 checkpoint equal bit for bit to the first run's
              state and to a restore of it, the resumed step-3 loss within
              RESUME_LOSS_GATE of an in-process step from the checkpoint,
              only step 4 left, the eval CLI (--fast_forward) summarising
              step 4; the checkpoint's bytes, save and restore seconds;
   train_zoo_e2e
              the train CLI for every other trained model at its default
              width, B=256, five bf16 steps (ZOO_RUNS): NetRVLAD-256 on the
              four routes of train_e2e (rows 3 and 4 once per module a step,
              zero C₂; fused against plain: the f32 pair within LOSS_GATES,
              each route's step-1 gradient per tensor within ZOO_GRAD_GATES
              of the plain f32 route's), NetFV-64, SoftDBoW-4096, NeXtVLAD-128,
              DbofModel-8192 (also random windows), FrameLevelLogisticModel,
              LogisticModel and MoeModel on video-level records, NetVLAD
              with --netvlad_dimred=256 (fused); losses finite and falling,
              each model's f32 step-1 loss on the card within 1e-5 of the
              CPU's, no other launch, the eval CLI reading each
              checkpoint back with a finite GAP;
   train_12b  the train CLI at Willow training's settings with
              --bf16_params, --fused_adam, --bf16_params --grad_accum_steps=2
              and --use_remat (TRAIN_12B_RUNS), launch counts per mode; the
              first update against the CPU's (first_update_gap), each mode's
              checkpoint restored bit for bit, remat's losses and BN
              statistics within REMAT_GATE of no remat, eval --fast_forward
              on the bf16 checkpoint; step ms and peak memory per mode;
   train_attn_rnn_e2e
              the train CLI for TransformerEncoderModel, AttentionNetVLADModel,
              AttentionPoolingModel, LstmModel and GruModel at their JAX
              default widths, B=256, five bf16 steps, and the transformer
              under --bf16_params (ATTN_RNN_RUNS): losses finite and falling,
              the dropout kernel 8 times a step for the two encoder models,
              no other launch; each model's f32 step-1 loss on the card
              within 1e-5 of the CPU's on 16 videos of the first batch,
              dropout included, and the transformer's --use_remat and
              --grad_accum_steps=2 steps the same (remat's gradients equal to
              the step's without it within REMAT_GATE); the bf16_params
              checkpoint's leaves in flax's dtypes; the eval CLI reading each
              checkpoint back (model-forward route); eval --fast_forward on
              the two encoder models (rows 7 and 2) within 1e-2 in probability
              of the model-forward route;
8. train_throughput
              the train step at B=256, S=30, bf16, fused: videos/s (the median
              of five rounds), forward, backward and optimizer ms, peak
              memory; then train_profile, torch.profiler over five steps;
   ingest     item 7 on INGEST_FIXTURE (1,024 videos at Willow's widths, 1-300
              frames, 8 shards), ingest_rates: videos/s and MB/s of the Python
              reader, the C++ reader on 1 and 8 threads, the packed cache's
              build (seconds, peak RSS of its process) and two passes of it,
              the grain-order DataLoader on 0 and 4 workers, each over two
              passes and as a share of this run's device rates (phase 5's
              fused inference, phase 8's train step), and the train CLI's
              loop without its logging through each of its three other
              sources; ingest_cli: the train CLI (3 bf16 fused steps, B=256)
              through --use_native_reader --num_readers=8, --packed_cache_dir
              and --use_grain --grain_worker_count=4, finite losses, rows 3-4
              twice a step each, the first under --profile_dir, whose Chrome
              trace must name rows 3-4's kernels (its five largest device ops
              and idle share printed); the inference CLI (--fast_infer, row 1
              once a batch) through the default source and --packed_cache_dir,
              the two CSVs equal byte for byte; the eval CLI (--fast_forward)
              through --use_grain with the GAP of the default source;
   train_zoo_throughput
              the same for every ZOO_RUNS model in bf16 (NetRVLAD fused and
              plain), and a profile of NetRVLAD's fused step;
   train_attn_rnn_throughput
              the same for the five models of train_attn_rnn_e2e (two
              rounds of two steps), a profile of the transformer's step,
              and the model-forward inference route of AttentionPoolingModel,
              LstmModel and GruModel at B=256;
   optimizers every --optimizer of the JAX package and
              --adam_bf16_momentum on Willow fused bf16 at B=256: the first
              update on the card against the same update on the CPU from the
              same parameters and gradients (OPTIMIZER_GATE), five finite
              losses, the step's forward, backward and optimizer ms;
   tf_import  the inference CLI with --reference_checkpoint on the
              committed TF1 bundle (tests/data/tf_bundle_netvlad, read
              without tensorflow) on the card and on the CPU: the same labels,
              scores within 1e-5;
9. lf_kernels the NetFV and SoftDBoW kernels against their plain versions at
              the full widths of NetFVModelLF-64 (D 1024/128, K 64/32) and
              SoftDbofModelLF-4096 (K 4096/2048), B=64, S=30, S=300 and S=1,
              num_frames including 1 and 300, on the staged route's rows in
              bf16 and f32, and at small shapes off every tile width (for
              SoftDBoW also S=150 and S=31, a video over 128 rows and one
              just over the 30-frame group; for NetFV also S=31 and 33 at
              full width, K=512 past one portable cluster, and D=520 across
              the bf16 kernel's row split), with the tolerances of phase 3
              (NetFV's plain version takes the kernels' rounding points
              there, and its bf16 output the tighter NETFV_KERNEL_GATE; its
              gap to the reference's is reported); every bf16 NetFV output
              equal bit for bit to a second launch's, and the built NetFV
              kernel's tiling equal to ops/netfv_fused.py#netfv_geometry at
              every shape; times at B=512, S=30 and S=300 beside each
              kernel's design and the time of its first, FMA-only kernel;
              NetFV's bf16 outputs also checked on those timed inputs and at
              a batch of four videos for each persistent cluster the card
              holds of either modality, S=30 and 300;
10. lf_e2e    for each of NetFVModelLF, SoftDbofModelLF, NetRVLADModelLF and
              NeXtVLADModel at its full default width (weights from a seed,
              BN statistics perturbed): the inference CLI on the 96 videos of
              phase 4 with the launch counters zeroed before and read after
              (its kernel once per modality per batch: netfv_fused,
              softdbow_fused, netvlad_fused; none for NeXtVLAD), then its
              kernel and plain routes on the same batches and sampled
              indices, within 1e-2 in probability;
11. lf_throughput
              each of the four models' kernel route at B=512, S=30 in
              videos/s (the median of five rounds), the plain route beside
              it; then lf_profile, torch.profiler over each kernel route;
12. attn_kernels
              the masked-attention kernel against its plain version, qkv in
              bf16 and f32, at config 5's width (H=8, hd=128, F=300) with
              B=64 and num_frames including 0, 1, 299 and 300, and at small
              shapes off every tile width (F 1, 7, 65, 129, 130, 200; hd 64,
              40 and 16), with the tolerances of phase 3, and in bf16, where
              both round at the TPU kernel's points, also at the tighter
              ATTN_KERNEL_GATE, within ATTN_BF16_STEPS bf16 steps at
              max|ref| of the plain version everywhere and equal on
              ATTN_EQUAL_SHARE of the entries; times at B=256, F=300, bf16,
              num_frames including 0 as in the CLI's last batch, beside
              torch's scaled_dot_product_attention on the same q, k, v and
              additive mask (library_ms: timed here only, the port never
              calls it), the kernel's design and the time of its first,
              FMA-only kernel;
13. attn_e2e  TransformerEncoderModel and AttentionNetVLADModel at full width
              (D=1024, 8 heads, 2 layers, FFN 2048; NetVLAD K=256; weights
              from a seed, BN statistics perturbed): the inference CLI on the
              96 videos of phase 4 with --batch_size=40, so the third batch
              carries 24 padding rows with num_frames 0; the attention kernel
              must launch once per layer per batch and netvlad_fused once per
              batch of AttentionNetVLADModel; then the kernel and plain routes
              on the same batches, within 1e-2 in probability;
14. attn_throughput
              both models' kernel routes at B=256, all 300 frames, num_frames
              random in 1-300: videos/s (the median of five rounds), the plain
              route and peak memory beside it; then attn_profile,
              torch.profiler over five kernel-route batches;
15. eval_e2e  the full-shape GAP drill's learnable set (200 videos, V=3862,
              rgb 1024 + audio 128, up to 300 frames): NetVLADModelLF at full
              width trained in-process (B=64, lr 0.001, bf16, fused, until the
              inference-mode GAP over the set, read every 50 steps, reaches
              0.5, or 1000 steps; each training kernel twice a step); the
              eval CLI on the model-forward route
              (f32) and on --fast_forward (bf16, the front-end kernel once a
              batch), each with the default accumulator and --fast_eval, which
              must agree within 1e-5 on GAP, Hit@1, PERR and loss; the f32
              plain fast route on the frames --fast_forward draws, whose GAP
              must be >= 0.3 and within 1e-3 of --fast_forward's (the north
              star's budget); the inference CLI without --fast_infer, with
              --fused_train_aggregation (the training forward kernel twice a
              batch), its CSV the module's top 20 and the module within the
              f32 gate of its plain aggregation; DbofModel at full width:
              eval --fast_forward and inference --fast_infer against the f32
              plain DBoF route within 1e-2 in probability; then four more
              arms trained the same way (EVAL_ARMS: the drill's NetRVLAD-256
              fused, DbofModel-8192, NetFV-256, and config 5's
              TransformerEncoderModel with its dropout), each through
              eval --fast_forward (rows 2 and 5 twice a batch for the LF
              two, row 7 once per layer a batch for the transformer) against
              the f32 plain route: GAP >= 0.3, |ΔGAP| <= 1e-3,
              --fast_eval within 1e-5; and eval --fast_forward --int8_hidden
              on NetVLADModelLF, NetRVLAD-256 and NetFV-256 within GAP_BUDGET
              of their bf16 route (the W8A16 kernel 2 or 4 times a batch).

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import http.client
import importlib.util
import itertools
import json
import logging
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from learnablepoolingmethods_torch import eval as eval_cli
from learnablepoolingmethods_torch import export_model as export_lib
from learnablepoolingmethods_torch import inference, train
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core import checkpoints, native_runtime, optimizers
from learnablepoolingmethods_torch.core import step as step_lib
from learnablepoolingmethods_torch.core.checkpoints import CheckpointManager, load_weights
from learnablepoolingmethods_torch.core.step import TrainStep
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.core.weights import (
    convert_flax_variables,
    init_memo,
    init_variables_np,
    load_flax_variables,
    load_variables_npz,
    save_variables_npz,
    state_dict_to_flax,
    tree_paths,
)
from learnablepoolingmethods_torch.data import native_loader, packed_cache, tfrecord_io
from learnablepoolingmethods_torch.data.fixtures import (
    make_learnable_synthetic_frame_level,
    write_frame_level_fixture,
    write_frame_level_shards,
    write_video_level_fixture,
)
from learnablepoolingmethods_torch.data.grain_pipeline import grain_batch_iterator
from learnablepoolingmethods_torch.data.pipeline import batch_iterator, native_batch_iterator
from learnablepoolingmethods_torch.data.readers import YT8MFrameFeatureReader, make_reader
from learnablepoolingmethods_torch.losses import CrossEntropyLoss
from learnablepoolingmethods_torch.metrics import eval_util
from learnablepoolingmethods_torch.models import create_model, find_class_by_name
from learnablepoolingmethods_torch.models.frame_level import lf_layout
from learnablepoolingmethods_torch.ops import dropout as dropout_ops
from learnablepoolingmethods_torch.ops import native_tail
from learnablepoolingmethods_torch.ops import fast_dbof, fast_infer, fast_lf, fast_transformer, kernel_build
from learnablepoolingmethods_torch.ops.dropout import apply_mask, dropout_kernel, dropout_plain
from learnablepoolingmethods_torch.ops.fast_dispatch import (
    FAST_ATTENTION_MODELS,
    FAST_LF_MODELS,
    get_fast_path,
)
from learnablepoolingmethods_torch.ops.fast_infer import (
    build_fast_netvlad_inference,
    gated_moe_tail,
    int8_weight,
    matmul_f32,
    prepare_fast_params,
    staged_frames,
)
from learnablepoolingmethods_torch.ops.fused_adam import (
    AdamConsts,
    adam_leaf_f32,
    clip_scale,
    fused_adam_kernel,
    fused_adam_plain,
    leaf_sumsq,
    random_bits,
    stochastic_round_bf16,
)
from learnablepoolingmethods_torch.ops.fused_frontend import (
    gather_frames,
    netvlad_frontend,
    netvlad_frontend_reference,
    sample_indices,
    sequence_indices,
)
from learnablepoolingmethods_torch.ops.int8_matmul import (
    BATCH_TILES,
    H100_SMS,
    TILE_K,
    TILE_N,
    int8_geometry,
    logical_weight,
    matmul_wi8,
    matmul_wi8_plain,
    quantize_int8_tensor,
    quantize_weight_int8,
)
from learnablepoolingmethods_torch.ops.masked_attention import (
    masked_attention_fused,
    masked_attention_plain,
)
from learnablepoolingmethods_torch.ops.netfv_fused import (
    kernel_geometry as netfv_kernel_geometry,
    netfv_fused,
    netfv_geometry,
    netfv_reference,
    resident_clusters as netfv_resident_clusters,
)
from learnablepoolingmethods_torch.ops.netvlad_fused import (
    aggregation_geometry,
    kernel_geometry,
    netvlad_fused,
    netvlad_reference,
)
from learnablepoolingmethods_torch.ops.softdbow_fused import softdbow_fused, softdbow_reference
from learnablepoolingmethods_torch.ops.topk import top_k_exact
from learnablepoolingmethods_torch.serving import (
    BatchingQueue,
    ModelServer,
    ThreadingHTTPServer,
    frame_records,
    make_handler,
)
from learnablepoolingmethods_torch.ops.netvlad_train import (
    netvlad_aggregate_backward,
    netvlad_aggregate_backward_plain,
    netvlad_aggregate_forward,
    netvlad_aggregate_forward_plain,
    netvlad_dv1_plain,
    kernel_train_geometry,
    train_geometry,
)
from learnablepoolingmethods_torch.parallel import mesh as mesh_lib
from learnablepoolingmethods_torch.parallel.collectives import column_shard
from learnablepoolingmethods_torch.utils import prng

# H100 SXM data-sheet peaks (dense, 700 W): HBM bytes/s and bf16 tensor-core
# FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
# float32 outside the tensor cores: the CUDA cores' rate
PEAK_CUDA_CORES = 67e12
# integer instructions: an SM issues at most 128 a clock, 64 on the ALU pipe
# and 64 more as IMAD forms on the FMA pipe (LOP3 and SHF run only on the
# ALU pipe, at 64), on 132 SMs at the 1,980 MHz boost clock the data-sheet
# rates assume; the dropout kernel's hash is counted at this rate
SM_COUNT, SM_CLOCK_HZ = 132, 1.98e9
PEAK_INT_OPS = 128 * SM_COUNT * SM_CLOCK_HZ
DT, D_RGB, D_AUD, K_RGB, K_AUD, F = 1152, 1024, 128, 256, 128, 300
MODS = ((D_RGB, K_RGB), (D_AUD, K_AUD))
# the kernels whose bf16 instantiation was redesigned for Hopper: the
# design, and the time of the first port's FMA-only kernel at the same shape
# (PERF.md's kernel table), beside each kernel_times line
REDESIGNED = {
    "netvlad_frontend": {"design": "bf16 logits+softmax GEMM on mma.sync, one-pass aggregation on mma.sync "
                                   "(A split hi+lo) in persistent 8-block clusters; warp-per-row prep",
                         "earlier_ms": 2.569},
    "netvlad_fused": {"design": "bf16 as netvlad_frontend (two-pass tensor-core aggregation past a portable "
                                "cluster); f32 FMA",
                      "earlier_ms": 2.428},
    "softdbow_fused": {"design": "bf16 mma.sync + cp.async ring, logits kept in f32 scratch; f32 FMA",
                       "earlier_ms": 14.140},
    "masked_attention_fused": {"design": "bf16 mma.sync + cp.async ring, two passes over the key tiles "
                                         "(row max and sum, then the normalised weights · V, the TPU "
                                         "kernel's rounding points); f32 FMA",
                               "earlier_ms": 5.409},
    "netvlad_aggregate_forward": {"design": "bf16 softmax, then the one-pass cluster aggregation on mma.sync "
                                            "with A rounded once (two passes past a portable cluster); f32 FMA",
                                  "earlier_ms": 0.946},
    "netvlad_aggregate_backward": {"design": "bf16 XᵀA once per video on mma.sync in persistent clusters, "
                                             "dV₁ in registers, per-video sums through distributed shared "
                                             "memory, dC₂ in shared memory per group; dA/dL and dX in one "
                                             "mma.sync GEMM launch from a bf16 dV₁ scratch; f32 FMA",
                                   "earlier_ms": 2.830},
    "netfv_fused": {"design": "bf16 logits+softmax GEMM on mma.sync; fv1 and fv2 on mma.sync in one pass per "
                              "video (X² from the X fragments, A rounded once) in persistent clusters of "
                              "≤ 8 blocks splitting D and K, per-cluster and global sums through "
                              "distributed shared memory; FMA passes past a portable cluster; f32 FMA",
                    "earlier_ms": 0.991},
}
# the first port's times of the redesigned kernels at S=300 (B=512 for
# inference, B=256 for training)
EARLIER_S300_MS = {"netvlad_frontend": 18.642, "netvlad_fused": 17.664,
                   "netvlad_aggregate_forward": 7.002, "netvlad_aggregate_backward": 19.006,
                   "netfv_fused": 6.860, "softdbow_fused": 138.623}
KERNELS = {
    "netvlad_frontend": dict(
        fn=netvlad_frontend,
        source="learnablepoolingmethods_torch/csrc/fused_frontend.cu",
        replaces="learnablepoolingmethods_tpu/ops/fused_frontend.py:142",
    ),
    "netvlad_fused": dict(
        fn=netvlad_fused,
        source="learnablepoolingmethods_torch/csrc/netvlad_fused.cu",
        replaces="learnablepoolingmethods_tpu/ops/netvlad_pallas.py:84",
    ),
    "netvlad_aggregate_forward": dict(
        fn=netvlad_aggregate_forward,
        source="learnablepoolingmethods_torch/csrc/netvlad_train.cu",
        replaces="learnablepoolingmethods_tpu/ops/netvlad_train.py:114",
    ),
    "netvlad_aggregate_backward": dict(
        fn=netvlad_aggregate_backward,
        source="learnablepoolingmethods_torch/csrc/netvlad_train.cu",
        replaces="learnablepoolingmethods_tpu/ops/netvlad_train.py:140",
    ),
    "netfv_fused": dict(
        fn=netfv_fused,
        source="learnablepoolingmethods_torch/csrc/netfv_fused.cu",
        replaces="learnablepoolingmethods_tpu/ops/netfv_pallas.py:82",
    ),
    "softdbow_fused": dict(
        fn=softdbow_fused,
        source="learnablepoolingmethods_torch/csrc/softdbow_fused.cu",
        replaces="learnablepoolingmethods_tpu/ops/softdbow_pallas.py:61",
    ),
    "masked_attention_fused": dict(
        fn=masked_attention_fused,
        source="learnablepoolingmethods_torch/csrc/masked_attention.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_transformer.py:108",
    ),
    "fused_adam": dict(
        fn=fused_adam_kernel,
        source="learnablepoolingmethods_torch/csrc/fused_adam.cu",
        replaces="learnablepoolingmethods_tpu/ops/fused_adam.py:111 FusedAdam.fused_apply "
                 "(XLA fusion, no pallas_call)",
    ),
    "int8_matmul": dict(
        fn=matmul_wi8,
        source="learnablepoolingmethods_torch/csrc/int8_matmul.cu",
        replaces="learnablepoolingmethods_tpu/ops/int8_matmul.py:62 matmul_wi8 (XLA fusion, no pallas_call)",
    ),
    "dropout": dict(
        fn=dropout_kernel,
        source="learnablepoolingmethods_torch/csrc/dropout.cu",
        replaces="learnablepoolingmethods_tpu/models/attention.py:49 nn.Dropout and :40 the attention-weight "
                 "dropout (flax; XLA fusion of jax.random.bernoulli, no pallas_call)",
    ),
    # the native runner's tail (csrc/native_runner.cu): its launches on the
    # main path are the runner's own counts (phase_native_serve)
    "native_hidden_sum": dict(
        fn=native_tail.hidden_sum,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_infer.py:272-276 (rgb + aud) + hidden_b and :70 "
                 "h.astype(bf16) (XLA fusion, no pallas_call)",
    ),
    "native_gating": dict(
        fn=native_tail.gating,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_infer.py:74 gating (XLA fusion, no pallas_call)",
    ),
    "native_moe_combine": dict(
        fn=native_tail.moe_combine,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_infer.py:83-85 the MoE combine, with :81 + experts_bias "
                 "(XLA fusion, no pallas_call)",
    ),
    "native_topk": dict(
        fn=native_tail.topk,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/topk.py:29 top_k_exact (jax.lax.top_k, no pallas_call)",
    ),
    # the runner's steps of the other routes (ROADMAP item 14c): launched by
    # the runner on its main path (phase_native_routes counts them)
    "native_frame_stage": dict(
        fn=native_tail.frame_stage,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_lf.py:305-319 sample_frame_features, dequantize, ℓ2 and the "
                 "folded input BN, ops/fast_dbof.py:78-92 without the BN, and with no draw ops/fast_transformer.py:"
                 "280-290 (bf16) and core/step.py:38-44 (f32) (XLA fusion, no pallas_call)",
    ),
    "native_bias_sigmoid": dict(
        fn=native_tail.bias_sigmoid,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/models/video_level.py:26-34 fc's bias and the sigmoid "
                 "(XLA fusion, no pallas_call)",
    ),
    "native_bias_relu6": dict(
        fn=native_tail.bias_relu6,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_dbof.py:94-100 + cluster_b and relu6, and :105-111 the "
                 "hidden FC's (XLA fusion, no pallas_call)",
    ),
    "native_frame_pool": dict(
        fn=native_tail.frame_pool,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_dbof.py:101-104 FramePooling max / average "
                 "(XLA fusion, no pallas_call)",
    ),
    "native_row_l2": dict(
        fn=native_tail.row_l2,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_lf.py:266-267 NeXtVLAD's intra-ℓ2 and folded vlad_bn, "
                 ":302 SoftDBoW's ℓ2, core/step.py:44 preprocess_input (XLA fusion, no pallas_call)",
    ),
    "native_nextvlad_assign": dict(
        fn=native_tail.nextvlad_assign,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_lf.py:244-258 σ(α) · softmax over K of the folded "
                 "logits (XLA fusion, no pallas_call)",
    ),
    "native_nextvlad_residual": dict(
        fn=native_tail.nextvlad_residual,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_lf.py:264-265 agg − Σ assign · c2 (XLA fusion, "
                 "no pallas_call)",
    ),
    "native_bias_act": dict(
        fn=native_tail.bias_act,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_transformer.py:177-180, :197-200, :205-212 and :290-294 "
                 "+ bias (ReLU) .astype(bf16) after each encoder product (XLA fusion, no pallas_call)",
    ),
    "native_residual_layernorm": dict(
        fn=native_tail.residual_layernorm,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_transformer.py:201-204, :213-216 and :256-259 the residual "
                 "and _layernorm, with :418 h * mask (XLA fusion, no pallas_call)",
    ),
    "native_masked_mean": dict(
        fn=native_tail.masked_mean,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/ops/fast_transformer.py:300-301 and models/frame_level.py:146-151 "
                 "the masked mean over the frames (XLA fusion, no pallas_call)",
    ),
    # the f32 routes of the models with no fast route (ROADMAP item 14c.5)
    "native_lstm_cell": dict(
        fn=native_tail.lstm_cell,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/models/frame_level.py:263-269 nn.RNN(nn.OptimizedLSTMCell) a step "
                 "and the carry at seq_lengths − 1 (flax's lax.scan in XLA, no pallas_call)",
    ),
    "native_gru_cell": dict(
        fn=native_tail.gru_cell,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/models/frame_level.py:284-290 nn.RNN(nn.GRUCell) a step and the "
                 "carry at seq_lengths − 1 (flax's lax.scan in XLA, no pallas_call)",
    ),
    # the GRU route's kernel since its redesign: the layer's recurrence in
    # one launch (gru_cell stays an entry point, off the main path)
    "native_gru_layer": dict(
        fn=native_tail.gru_layer,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/models/frame_level.py:276-290 nn.RNN(nn.GRUCell) over every frame, "
                 "h·W_h and the cell each step, the carry at seq_lengths − 1 (flax's lax.scan in XLA, no "
                 "pallas_call)",
    ),
    "native_pool_attention": dict(
        fn=native_tail.pool_attention,
        source="learnablepoolingmethods_torch/csrc/native_runner.cu",
        replaces="learnablepoolingmethods_tpu/models/attention.py:101-109 the learned queries through "
                 "nn.MultiHeadDotProductAttention's masked softmax attention (XLA, no pallas_call)",
    ),
}


def kernel_key(counter: str) -> str:
    """The KERNELS name of a native runner counter (core/native_runtime.py
    COUNTERS): the TPU-kernel rows keep theirs (row 7's wrapper is
    masked_attention_fused), the runner's own kernels are native_<name>."""
    if counter in native_runtime.ROW_KERNELS:
        return {"masked_attention": "masked_attention_fused"}.get(counter, counter)
    return f"native_{counter}"
TRAIN_KERNELS = ("netvlad_aggregate_forward", "netvlad_aggregate_backward")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# (atol as a share of max|ref|, rtol) by output dtype: a bf16 output allows
# one bf16 rounding plus another f32 summation order; an f32 output allows
# the summation order alone, so a kernel that rounds through bf16 fails it
TOLERANCE = {torch.bfloat16: (1e-2, 2e-2), torch.float32: (1e-5, 1e-5)}


def compare(name: str, got, want, dtype=None, tol=None, scale=None) -> float:
    """Max |Δ| in f32; raises unless |Δ| <= a·max|ref| + r·|ref| everywhere,
    with (a, r) = tol or TOLERANCE[dtype or want.dtype]; ``scale`` replaces
    max|ref| where the reference is a cancellation of larger terms."""
    a, r = tol or TOLERANCE[dtype or want.dtype]
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite values")
    diff = (got - want).abs()
    atol = a * (want.abs().max().item() if scale is None else scale)
    if not bool((diff <= atol + r * want.abs()).all()):
        raise AssertionError(f"{name}: max |Δ| {diff.max().item():.3e} over tolerance (atol {atol:.3e})")
    return diff.max().item()


def reset_counters() -> None:
    for spec in KERNELS.values():
        spec["fn"].launches = 0


def counters():
    return {name: spec["fn"].launches for name, spec in KERNELS.items()}


def frontend_consts(rng: np.random.Generator, dev, mods=MODS):
    """Folded input BN and both NetVLADs' (C bf16, scale, bias, C₂) for
    modality widths ``mods``, at the scales of the model's initialisers."""
    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    dt = sum(d for d, _ in mods)
    out = [t(rng.uniform(0.8, 1.2, dt)), t(rng.normal(scale=0.05, size=dt))]
    for d, k in mods:
        out += [
            t(rng.normal(scale=d ** -0.5, size=(d, k)), torch.bfloat16),
            t(rng.uniform(0.5, 1.5, k)),
            t(rng.normal(scale=0.1, size=k)),
            t(rng.normal(scale=d ** -0.5, size=(d, k))),
        ]
    return out


def frames(rng: np.random.Generator, b: int, dev, f: int = F, dt: int = DT):
    """Random uint8 frames [b, f, dt] and frame counts that include 1 and f."""
    x = torch.from_numpy(rng.integers(0, 256, size=(b, f, dt), dtype=np.uint8)).to(dev)
    nf = np.r_[1, f, rng.integers(1, f + 1, size=b - 2)].astype(np.int32)
    return x, torch.from_numpy(nf).to(dev)


def bound(b: int, s: int, idx, frontend: bool, mods=MODS):
    """Least time (ms) for the work of one call (frontend) or of the
    netvlad_fused calls of ``mods`` (the staged pair by default): bytes each
    read or written once over the HBM rate, or the logits and the
    aggregation over the bf16 tensor-core rate, whichever is larger.  The
    aggregation counts at that rate because X is exact in bf16 and A splits
    into bf16 terms without losing f32 accuracy."""
    dk = sum(d * k for d, k in mods)
    consts = sum(d * k * 2 + 2 * k * 4 + d * k * 4 for d, k in mods)
    out = b * dk * 2
    if frontend:
        rows = sum(len(torch.unique(r)) for r in idx.cpu())
        nbytes = rows * DT + b * s * 4 + 2 * DT * 4 + consts + out
    else:
        nbytes = b * s * sum(d for d, _ in mods) * 2 + consts + out
    flops = 2 * b * s * dk
    ops_ms = 2 * flops / PEAK_BF16 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return smi


# the sources whose kernels nvcc's -Xptxas -v reports in the build phase
PTXAS_REPORT = ("netvlad_fused", "fused_frontend", "netvlad_train", "netfv_fused", "fused_adam", "int8_matmul", "dropout",
                "native_runner")


def phase_build():
    """Every library, one nvcc per source, all started together (the native
    runner's compile the sources of rows 1, 2, 5 and 6 and link cuBLAS),
    PTXAS_REPORT's with -Xptxas -v, whose registers, shared memory and
    spills per kernel are printed; beside them g++'s C++ reader; then
    lpm_serve, linked with the runner.  Returns lpm_serve's path and build
    seconds."""
    start = time.perf_counter()
    host = {}
    # the C++ TFRecord reader and CSV formatter (g++) build beside nvcc
    host_build = threading.Thread(target=lambda: host.update(path=str(native_loader.build()),
                                                             seconds=time.perf_counter() - start))
    host_build.start()
    per_source = kernel_build.build(ptxas=PTXAS_REPORT)  # the native runner among them (linked with cuBLAS)
    host_build.join()
    if "path" not in host:
        native_loader.build()  # raises with g++'s output
    # lpm_serve links the runner: g++ once the runner's library is built
    serve_start = time.perf_counter()
    binary = native_runtime.build_serving_binary()
    lpm_serve = {"path": str(binary), "seconds": time.perf_counter() - serve_start}
    emit({"phase": "build", "seconds": time.perf_counter() - start, "per_source": per_source,
          "host_library": host, "lpm_serve": lpm_serve})
    for name in PTXAS_REPORT:
        emit({"phase": "build", "ptxas": name, "kernels": kernel_build.ptxas_report(name)})
    return lpm_serve


def check_kernels(rng, dev, b: int, f: int, s: int, mods, errors) -> list:
    """Both kernels against their plain versions on one random batch: the
    front end on uint8 frames, and netvlad_fused in bf16 and f32 on the
    staged route's rows (strided column slices, as fast_infer passes them);
    bf16 netvlad_fused also through its two-pass aggregation.  Each bf16
    result must equal a second launch's bit for bit, and the aggregation's
    tiling that the built kernel picks must be ops/netvlad_fused.py's."""
    d_rgb = mods[0][0]
    dt = sum(d for d, _ in mods)
    consts = frontend_consts(rng, dev, mods)
    x, nf = frames(rng, b, dev, f, dt)
    key = prng.key(s)
    idx = sample_indices(key, nf, f, s)
    shape = {"B": b, "F": f, "S": s, "D": [d for d, _ in mods], "K": [k for _, k in mods],
             "one_pass": [aggregation_geometry(d, k)["one_pass"] for d, k in mods]}
    for d, k in mods:
        if kernel_geometry(d, k) != aggregation_geometry(d, k):
            raise AssertionError(f"D={d} K={k}: the kernel tiles as {kernel_geometry(d, k)}, "
                                 f"ops/netvlad_fused.py as {aggregation_geometry(d, k)}")
    checks = []

    def record(kernel, label, got, again, want, **extra):
        err = compare(f"{kernel} {label} {extra} {shape}", got, want)
        if again is not None and not torch.equal(got, again):
            raise AssertionError(f"{kernel} {label} {extra} {shape}: two launches differ")
        errors[kernel] = max(errors[kernel], err)
        checks.append({"kernel": kernel, "modality": label, **extra, "max_abs_err": err,
                       "max_ref": want.float().abs().max().item(), "same_bits": again is not None})

    got = netvlad_frontend(x, key, nf, s, *consts)
    again = netvlad_frontend(x, key, nf, s, *consts)
    torch.cuda.synchronize()
    want = netvlad_frontend_reference(x, key, nf, s, *consts)
    for mod, g, g2, w in zip(("rgb", "aud"), got, again, want):
        record("netvlad_frontend", mod, g, g2, w)
    for dtype in (torch.bfloat16, torch.float32):
        rows = staged_frames(gather_frames(x, idx), consts[0], consts[1], dtype)
        for mod, (c, sc, bi, c2), cols in (("rgb", consts[2:6], slice(0, d_rgb)),
                                           ("aud", consts[6:10], slice(d_rgb, dt))):
            xm, cm = rows[:, :, cols], c.to(dtype)
            want = netvlad_reference(xm, cm, sc, bi, c2)
            for two_pass in ((False, True) if dtype == torch.bfloat16 else (False,)):
                g = netvlad_fused(xm, cm, sc, bi, c2, two_pass=two_pass)
                g2 = netvlad_fused(xm, cm, sc, bi, c2, two_pass=two_pass) if dtype == torch.bfloat16 else None
                torch.cuda.synchronize()
                record("netvlad_fused", mod, g, g2, want, dtype=str(dtype), two_pass=two_pass)
    return [{**shape, **c} for c in checks]


# (B, F, S, ((D, K) rgb, (D, K) audio)) of phase_kernels' checks: Willow
# widths at the --iterations default and at every frame; at S=1 a video's
# descriptors come from its one sampled frame, so a frame that the kernel
# drew other than the plain version fails the check; S=31 and 33 end on a
# partial 16-sample stage of the aggregation's ring; K 500 and 512 at D=1024
# take the two-pass aggregation (16 blocks a video, past a portable cluster),
# K 512 at D=128 a cluster of two; then small widths off every tile: D and K
# not multiples of 8 (2-byte loads and stores), and a row of 50 bytes, which
# takes the front end's unvectorised load
KERNEL_CHECKS = ((64, F, 30, MODS), (64, F, 300, MODS), (64, F, 1, MODS), (16, F, 31, MODS),
                 (16, F, 33, MODS), (8, F, 31, ((D_RGB, 500), (D_AUD, 512))),
                 (8, F, 33, ((D_RGB, 512), (D_AUD, 500))), (3, 10, 7, ((42, 20), (8, 10))))
# AttentionNetVLAD's call: contiguous bf16 rows of all 300 frames, B=256
ATTN_NETVLAD_SHAPE = (256, F, D_RGB, K_RGB)


def phase_kernels(dev, smi):
    rng = np.random.default_rng(0)
    errors = {name: 0.0 for name in KERNELS}
    for b, f, s, mods in KERNEL_CHECKS:
        before = counters()
        checks = check_kernels(rng, dev, b, f, s, mods, errors)
        after = counters()
        emit({"phase": "kernels", "checks": checks,
              "launch_deltas": {k: after[k] - before[k] for k in after}})

    # AttentionNetVLAD's shape, twice for the bits, and its time
    b, f, d, k = ATTN_NETVLAD_SHAPE
    xa = torch.from_numpy(rng.normal(scale=0.5, size=(b, f, d)).astype(np.float32)).to(dev, torch.bfloat16)
    consts = frontend_consts(rng, dev, ((d, k),))[2:6]
    got, again = netvlad_fused(xa, *consts), netvlad_fused(xa, *consts)
    torch.cuda.synchronize()
    want = netvlad_reference(xa, *consts)
    err = compare(f"netvlad_fused AttentionNetVLAD shape {ATTN_NETVLAD_SHAPE}", got, want)
    if not torch.equal(got, again):
        raise AssertionError("netvlad_fused at the AttentionNetVLAD shape: two launches differ")
    errors["netvlad_fused"] = max(errors["netvlad_fused"], err)
    bound_ms, by = bound(b, f, None, frontend=False, mods=((d, k),))
    emit({"phase": "kernel_times", "kernel": "netvlad_fused", "B": b, "S": f, "D": d, "K": k,
          "rows": "AttentionNetVLAD (contiguous bf16)", "max_abs_err": err,
          "max_ref": want.float().abs().max().item(),
          "ms": time_ms(lambda: netvlad_fused(xa, *consts)),
          "two_pass_ms": time_ms(lambda: netvlad_fused(xa, *consts, two_pass=True)),
          "plain_ms": time_ms(lambda: netvlad_reference(xa, *consts), reps=5),
          "bound_ms": bound_ms, "bound_by": by, "card": smi})
    del xa, got, again, want

    # times at the throughput shape, B=512, at S=30 (the main path's) and S=300
    consts = frontend_consts(rng, dev)
    rgb, aud = consts[2:6], consts[6:10]
    b = 512
    x, nf = frames(rng, b, dev)
    per_s = {}
    for s in (30, 300):
        key = prng.key(b + s)
        idx = sample_indices(key, nf, F, s)
        rows = staged_frames(gather_frames(x, idx), consts[0], consts[1], torch.bfloat16)
        xr, xa = rows[:, :, :D_RGB], rows[:, :, D_RGB:]
        per_s[s] = {
            "netvlad_frontend": (
                time_ms(lambda: netvlad_frontend(x, key, nf, s, *consts)),
                time_ms(lambda: netvlad_frontend_reference(x, key, nf, s, *consts), reps=5),
                bound(b, s, idx, frontend=True),
            ),
            "netvlad_fused": (
                time_ms(lambda: (netvlad_fused(xr, *rgb), netvlad_fused(xa, *aud))),
                time_ms(lambda: (netvlad_reference(xr, *rgb), netvlad_reference(xa, *aud)), reps=5),
                bound(b, s, idx, frontend=False),
            ),
        }
        # the one-pass design against the two-pass one on the same rows
        two_pass_ms = time_ms(lambda: (netvlad_fused(xr, *rgb, two_pass=True),
                                       netvlad_fused(xa, *aud, two_pass=True)))
        for name, (ms, plain_ms, (bound_ms, by)) in per_s[s].items():
            emit({"phase": "kernel_times", "kernel": name, "B": b, "S": s, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                  **({"two_pass_ms": two_pass_ms} if name == "netvlad_fused" else {}),
                  **(REDESIGNED[name] if s == 30 else {"earlier_ms": EARLIER_S300_MS[name]}),
                  "card": smi})
    return errors, per_s[30]


def train_inputs(rng: np.random.Generator, b: int, f: int, d: int, k: int, dtype, dev):
    """X, post-BN logits, C₂ and a cotangent at the scales of training: X and
    the logits about unit-variance (both follow a BN), C₂ at its
    initialiser's 1/√D, and dV₃ at the scale of V₃ itself."""
    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    return (t(rng.normal(size=(b, f, d)), dtype), t(rng.normal(size=(b, f, k))),
            t(rng.normal(scale=d ** -0.5, size=(d, k))),
            t(rng.normal(scale=(d * k) ** -0.5, size=(b, d, k)), dtype))


def train_bound(b: int, s: int, backward: bool):
    """Least time (ms) for the rgb and audio calls of one training kernel:
    each input read once and each output written once over the HBM rate,
    or the products (XᵀA forward; the recompute of XᵀA, X·dV₁ and A·dV₁ᵀ
    backward) over the bf16 tensor-core rate, whichever is larger."""
    nbytes, flops = 0, 0
    for d, k in MODS:
        x, logits, c2, vlad = b * s * d * 2, b * s * k * 4, d * k * 4, b * d * k * 2
        if backward:
            nbytes += x + logits + c2 + vlad + x + logits + c2  # in: X, L, C₂, dV₃; out: dX, dL, dC₂
            flops += 3 * 2 * b * s * d * k
        else:
            nbytes += x + logits + c2 + vlad
            flops += 2 * b * s * d * k
    ops_ms = flops / PEAK_BF16 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", nbytes, flops


def check_train_kernels(x, logits, c2, dv3, errors, per_video_sum: bool) -> dict:
    """Both training kernels against their plain versions on one batch: the
    forward output, dX, dL and dC₂, each held to the tolerance of X's dtype
    (a bf16 run rounds A and dV₁ to bf16 inside the function, so its f32
    outputs dL and dC₂ inherit that rounding too).  With ``per_video_sum``
    also dC₂ of the batch against the kernel's dC₂ of each video alone,
    summed in f64, and the kernel's dC₂ at B=1 against the plain version's.
    In bf16 every output must equal a second launch's bit for bit, and the
    built kernels' tiling must be ops/netvlad_train.py#train_geometry's."""
    (b, s, d), k, dtype = x.shape, logits.shape[2], x.dtype
    if dtype == torch.bfloat16 and kernel_train_geometry(b, d, k) != train_geometry(b, d, k):
        raise AssertionError(f"B={b} D={d} K={k}: the training kernels tile as "
                             f"{kernel_train_geometry(b, d, k)}, ops/netvlad_train.py as "
                             f"{train_geometry(b, d, k)}")
    got_f = netvlad_aggregate_forward(x, logits, c2)
    got_b = netvlad_aggregate_backward(x, logits, c2, dv3)
    if dtype == torch.bfloat16:
        again = (netvlad_aggregate_forward(x, logits, c2), *netvlad_aggregate_backward(x, logits, c2, dv3))
        for name, g, g2 in zip(("out", "dx", "dl", "dc2"), (got_f, *got_b), again):
            if not torch.equal(g, g2):
                raise AssertionError(f"{name} B={b} S={s} D={d} K={k}: two launches differ")
    torch.cuda.synchronize()
    want_f = netvlad_aggregate_forward_plain(x, logits, c2)
    want_b = netvlad_aggregate_backward_plain(x, logits, c2, dv3)
    label = f"B={b} S={s} D={d} K={k} {dtype}"
    errs = {"out": compare(f"forward {label}", got_f, want_f, dtype)}
    # at S=1 the output does not depend on the logits (one frame: V₂ =
    # (x − C₂)/‖x − C₂‖ whatever A is), so dL is 0 up to rounding, the
    # cancellation of terms A·X·dV₁: its scale is theirs, not max|dL|
    dl_scale = None
    if s == 1:
        a, _, dv1 = netvlad_dv1_plain(x, logits, c2, dv3)
        dl_scale = (a * torch.einsum("bfd,bdk->bfk", x.float().abs(), dv1.abs())).max().item()
    for name, g, w in zip(("dx", "dl", "dc2"), got_b, want_b):
        errs[name] = compare(f"backward {name} {label}", g, w, dtype,
                             scale=dl_scale if name == "dl" else None)
    if per_video_sum:
        one = [netvlad_aggregate_backward(x[i:i + 1], logits[i:i + 1], c2, dv3[i:i + 1])
               for i in range(b)]
        per_video = torch.stack([o[2].double() for o in one]).sum(0)
        errs["dc2_vs_per_video_sum"] = compare(
            f"dc2 batch sum {label}", got_b[2], per_video.float(), dtype)
        want_one = netvlad_aggregate_backward_plain(x[:1], logits[:1], c2, dv3[:1])[2]
        errs["dc2_b1"] = compare(f"dc2 B=1 {label}", one[0][2], want_one, dtype)
    errors["netvlad_aggregate_forward"] = max(errors["netvlad_aggregate_forward"], errs["out"])
    errors["netvlad_aggregate_backward"] = max(
        errors["netvlad_aggregate_backward"], *(v for n, v in errs.items() if n != "out"))
    return {"B": b, "S": s, "D": d, "K": k, "dtype": str(dtype), "max_abs_err": errs,
            "same_bits": dtype == torch.bfloat16, "one_pass": train_geometry(b, d, k)["one_pass"],
            "max_ref": {"out": want_f.float().abs().max().item(),
                        "dx": want_b[0].float().abs().max().item(),
                        "dl": want_b[1].abs().max().item(),
                        "dc2": want_b[2].abs().max().item()}}


# (B, S, ((D, K) rgb, (D, K) audio)) of phase_train_kernels' checks: Willow
# widths at S=30 and 300; S 1, 31 and 33, a partial 16-sample stage of the
# bf16 aggregation's ring and of the dA/dX kernel's 32 frames; K 500 and 512
# at D=1024, past a portable cluster (the two-pass chain, and K 500 the
# 2-byte loads), a cluster of two at D=128; then small widths off every
# tile (D and K not multiples of 8, a 32-thread block); last the one module
# of NetVLADModelLF with --netvlad_dimred=256 (D=256, K=256)
TRAIN_CHECKS = ((64, 30, MODS), (64, 300, MODS), (16, 1, MODS), (16, 31, MODS), (16, 33, MODS),
                (8, 30, ((D_RGB, 500), (D_AUD, 512))), (8, 33, ((D_RGB, 512), (D_AUD, 500))),
                (20, 37, ((70, 20), (8, 10))), (64, 30, ((256, K_RGB),)))


def phase_train_kernels(dev, smi):
    """Both training kernels against their plain versions (check_train_kernels),
    X in bf16 and in f32, at every TRAIN_CHECKS shape, the per-video dC₂ sum
    at B=64, S=30; then at B=256, S=30 and S=300, X in bf16, the shapes of
    the main path: all four outputs, the per-video dC₂ sum, and the times
    beside the first port's."""
    rng = np.random.default_rng(1)
    errors = {name: 0.0 for name in TRAIN_KERNELS}
    for b, s, mods in TRAIN_CHECKS:
        checks = [check_train_kernels(*train_inputs(rng, b, s, d, k, dtype, dev), errors,
                                      per_video_sum=(b, s) == (64, 30))
                  for d, k in mods for dtype in (torch.bfloat16, torch.float32)]
        emit({"phase": "train_kernels", "checks": checks})

    timing = {}
    b = 256
    for s in (30, 300):
        inputs = [train_inputs(rng, b, s, d, k, torch.bfloat16, dev) for d, k in MODS]
        emit({"phase": "train_kernels", "checks": [
            check_train_kernels(*i, errors, per_video_sum=True) for i in inputs]})
        rows = {
            "netvlad_aggregate_forward": (
                time_ms(lambda: [netvlad_aggregate_forward(*i[:3]) for i in inputs]),
                time_ms(lambda: [netvlad_aggregate_forward_plain(*i[:3]) for i in inputs], reps=5),
                train_bound(b, s, backward=False),
            ),
            "netvlad_aggregate_backward": (
                time_ms(lambda: [netvlad_aggregate_backward(*i) for i in inputs]),
                time_ms(lambda: [netvlad_aggregate_backward_plain(*i) for i in inputs], reps=5),
                train_bound(b, s, backward=True),
            ),
        }
        for name, (ms, plain_ms, (bound_ms, by, nbytes, flops)) in rows.items():
            emit({"phase": "kernel_times", "kernel": name, "B": b, "S": s, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                  "bytes": nbytes, "flop": flops,
                  **(REDESIGNED[name] if s == 30 else {"earlier_ms": EARLIER_S300_MS[name]}),
                  "card": smi})
        timing[s] = rows
    return errors, timing


def read_csv(out_csv: str, written: int, truth) -> dict:
    """The inference CLI's CSV → {video id: (top-20 ids, values)}; raises
    unless it has one well-formed row per video of ``truth``: 20 ids in
    range with falling values."""
    with open(out_csv) as f:
        lines = f.read().splitlines()
    if lines[0] != "VideoId,LabelConfidencePairs" or len(lines) != 1 + len(truth) or written != len(truth):
        raise AssertionError(f"CSV has {len(lines) - 1} rows for {len(truth)} videos")
    csv = {}
    for line in lines[1:]:
        vid, pairs = line.split(",")
        nums = pairs.split()
        ids, vals = [int(i) for i in nums[::2]], [float(v) for v in nums[1::2]]
        if len(ids) != 20 or any(a < b for a, b in zip(vals, vals[1:])) or not all(0 <= i < 3862 for i in ids):
            raise AssertionError(f"bad CSV row for {vid}: {line[:120]}")
        csv[vid] = (ids, np.array(vals))
    if sorted(csv) != sorted(t["video_id"].decode() for t in truth):
        raise AssertionError("CSV video ids differ from the fixture's")
    return csv


def load_labeled_batches(data: str, dev, batch_size: int = 32) -> list:
    """The CLI's batches of ``batch_size`` videos of ``data`` on the card:
    (features, num_frames, real-row mask, real video ids, the real rows'
    labels on the host)."""
    reader = YT8MFrameFeatureReader(feature_names=("rgb", "audio"))
    batches = []
    for batch in batch_iterator(reader, data, batch_size):
        real = batch["weights"] > 0
        batches.append((torch.from_numpy(batch["features"]).to(dev),
                        torch.from_numpy(batch["num_frames"]).to(dev),
                        torch.from_numpy(real).to(dev),
                        [v for v, keep in zip(batch["video_id"], real) if keep],
                        batch["labels"][real]))
    return batches


def load_batches(data: str, dev, batch_size: int = 32) -> list:
    """load_labeled_batches without the labels."""
    return [b[:4] for b in load_labeled_batches(data, dev, batch_size)]


def run_batches(batches, fp, fn) -> torch.Tensor:
    """A route's probabilities on every real video of ``batches``, each
    batch drawn from the CLI's per-batch key fold_in(key(0), batch)."""
    out = []
    for batch_idx, (feats, nf, real, _) in enumerate(batches):
        out.append(fn(fp, feats, nf, prng.fold_in(prng.key(0), batch_idx))[real])
    return torch.cat(out)


def check_csv_rows(csv, probs, batches, route: str) -> None:
    """Each CSV row is the top 20 of ``route``'s probabilities, ties lowest
    index first as the CLI's top_k_exact orders them."""
    vals, ids = top_k_exact(probs, 20)
    vids = [vid for *_, batch_vids in batches for vid in batch_vids]
    for vid, v_row, i_row in zip(vids, vals.cpu().numpy(), ids.cpu().numpy()):
        c_ids, c_vals = csv[vid.decode()]
        if list(i_row) != c_ids or np.abs(v_row - c_vals).max() > 1e-5:
            raise AssertionError(f"CSV row of {vid!r} differs from the {route} route's top-20")


def phase_e2e(dev, workdir):
    mcfg = ModelConfig()  # Willow: K=256 (audio 128), H=1024, V=3862, M=2, 30 samples
    fcfg = FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), True, F)
    start = time.perf_counter()
    tree = init_variables_np(mcfg, fcfg, seed=0)
    for stats in (tree["batch_stats"]["input_bn"], tree["batch_stats"]["gating"]["gating_bn"]):
        stats["mean"] += np.float32(0.05) * np.arange(stats["mean"].size, dtype=np.float32) / stats["mean"].size
        stats["var"] += np.float32(0.5) * np.arange(stats["var"].size, dtype=np.float32) / stats["var"].size
    for name in ("NetVLAD_0", "NetVLAD_1"):
        bn = tree["batch_stats"][name]["cluster_bn"]
        bn["mean"] += np.float32(0.1)
        bn["var"] *= np.float32(1.5)
    train_dir = os.path.join(workdir, "train")
    os.makedirs(train_dir)
    save_variables_npz(tree, train_dir)
    data = os.path.join(workdir, "videos-0.tfrecord")
    truth = write_frame_level_fixture(data, 96, seed=0)
    setup_s = time.perf_counter() - start
    export = export_willow(tree, mcfg, fcfg, workdir)

    # path 1: the inference CLI, which takes the fused route
    out_csv = os.path.join(workdir, "predictions.csv")
    reset_counters()
    start = time.perf_counter()
    written = inference.main([
        "--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
        "--feature_sizes=1024,128", f"--input_data_pattern={data}", f"--train_dir={train_dir}",
        f"--output_file={out_csv}", "--batch_size=32", "--fast_infer", "--device=cuda",
    ])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - start
    paths = {"cli": counters()}
    n_batches = -(-len(truth) // 32)
    csv = read_csv(out_csv, written, truth)
    # path 2: the staged route (the NetVLAD kernel once per modality) through
    # build_fast_netvlad_inference on the same batches and sampled indices
    fp = prepare_fast_params(convert_flax_variables(tree, mcfg), mcfg, device=dev)
    del tree
    batches = load_batches(data, dev)

    def run_route(fn):
        return run_batches(batches, fp, fn)

    reset_counters()
    probs = {"staged": run_route(
        build_fast_netvlad_inference(mcfg, return_probs=True, fuse_frontend=False))}
    torch.cuda.synchronize()
    paths["staged"] = counters()
    none = dict.fromkeys(KERNELS, 0)
    expected = {"cli": {**none, "netvlad_frontend": n_batches},
                "staged": {**none, "netvlad_fused": 2 * n_batches}}
    if paths != expected:
        raise AssertionError(f"launch counts per path {paths}, expected {expected}")

    # the fused and plain routes on the same batches, to compare the three
    probs["fused"] = run_route(build_fast_netvlad_inference(mcfg, return_probs=True))
    probs["plain"] = run_route(
        build_fast_netvlad_inference(mcfg, return_probs=True, use_kernels=False))
    for route, p in probs.items():
        if p.shape != (len(truth), 3862) or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{route}: probabilities of shape {tuple(p.shape)} or non-finite")
    gaps = {}
    for a, b in (("fused", "plain"), ("staged", "plain"), ("fused", "staged")):
        gaps[f"{a}_vs_{b}"] = (probs[a] - probs[b]).abs().max().item()
    if max(gaps.values()) > 1e-2:
        raise AssertionError(f"routes disagree: {gaps}")
    check_csv_rows(csv, probs["fused"], batches, "fused")
    emit({"phase": "e2e", "videos": len(truth), "batches": n_batches, "setup_s": setup_s,
          "cli_s": cli_s, "launches_per_path": paths, "max_abs_prob_gap": gaps})
    launches = {name: sum(p[name] for p in paths.values()) for name in ("netvlad_frontend", "netvlad_fused")}
    return fp, launches, export


def phase_throughput(dev, fp, smi):
    mcfg = ModelConfig()
    b, s = 512, mcfg.iterations
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randint(0, 256, (b, F, DT), generator=gen, device=dev, dtype=torch.uint8)
    nf = torch.randint(1, F + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    key = prng.key(1)
    torch.cuda.reset_peak_memory_stats()
    per_route, fused_rounds = {}, []
    for route, kw in (("fused", {}), ("staged", {"fuse_frontend": False}), ("plain", {"use_kernels": False})):
        fn = build_fast_netvlad_inference(mcfg, top_k=20, **kw)
        rounds = [time_ms(lambda: fn(fp, x, nf, key), reps=10) for _ in range(5 if route == "fused" else 1)]
        per_route[route] = statistics.median(rounds)
        if route == "fused":
            fused_rounds = rounds

    def frontend():
        return netvlad_frontend(
            x, key, nf, s, fp["in_scale"], fp["in_bias"],
            *(fp["rgb"][k] for k in ("cluster", "scale", "bias", "c2")),
            *(fp["aud"][k] for k in ("cluster", "scale", "bias", "c2")),
        )

    v_rgb, v_aud = (v.reshape(b, -1) for v in frontend())

    def hidden():
        return matmul_f32(v_rgb, fp["w_rgb"]) + matmul_f32(v_aud, fp["w_aud"]) + fp["hidden_b"]

    h = hidden()
    stages = {
        "frontend_ms": time_ms(frontend, reps=10),
        "hidden_fc_ms": time_ms(hidden, reps=10),
        "tail_ms": time_ms(lambda: gated_moe_tail(fp, h, mcfg.moe_num_mixtures, mcfg.vocab_size,
                                                  torch.bfloat16, 20, False), reps=10),
    }
    videos_per_s = b / (per_route["fused"] / 1e3)
    emit({"phase": "throughput", "B": b, "S": s, "videos_per_s": videos_per_s,
          "videos_per_s_rounds": [b / (ms / 1e3) for ms in fused_rounds],
          "batch_ms": per_route, **stages,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": smi})
    fused = build_fast_netvlad_inference(mcfg, top_k=20)
    emit({"phase": "profile", "route": "fused", "B": b, "S": s,
          **profile_device(lambda: fused(fp, x, nf, key)), "card": smi})
    return videos_per_s


# The profiler keeps no record of the first launches after it starts (on
# one H100: 1–3 of 20 one-kernel calls lost in a process's sessions; about
# half of them late in the whole script, which read frame_stage's all-frames
# mode and pool_attention below their bounds), and a busy time over the
# calls made then reads low.  So profile_device launches ``fn`` for
# PROFILE_LEAD_S of host time first and counts only the records between two
# marker kernels (torch.cuda._sleep's) around the timed calls.
PROFILE_LEAD_S = 0.02
PROFILE_MARKER = "spin_kernel"


def profile_device(fn, reps: int = 5) -> dict:
    """Device time per call of ``fn`` by kernel name, from torch.profiler's
    CUDA activity over ``reps`` calls (between the two markers), the
    records it kept, and the device's idle share between the first
    kernel's start and the last one's end."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        lead = time.perf_counter()
        fn()
        while time.perf_counter() - lead < PROFILE_LEAD_S:
            fn()
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    records = sorted((e.time_range.start, e.time_range.end, e.name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void "))
                     for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    marks = [i for i, r in enumerate(records) if PROFILE_MARKER in r[2]]
    spans = records[marks[0] + 1:marks[1]] if len(marks) == 2 else []
    if not spans:
        return {"device_ms_per_call": f"not measured: {len(marks)} of the 2 markers and {len(spans)} records "
                                      "between them kept"}
    by_name = {}
    busy_us, reach = 0.0, spans[0][0]
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3 / reps
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    window_us = reach - spans[0][0]
    return {"device_busy_ms_per_call": busy_us / 1e3 / reps,
            "device_window_ms_per_call": window_us / 1e3 / reps, "device_records": len(spans),
            "idle_share": 1.0 - busy_us / window_us,
            "kernels_ms_per_call": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])}


TRAIN_FLAGS = [
    "--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
    "--feature_sizes=1024,128", "--batch_size=256", "--max_steps=5", "--compute_dtype=bfloat16",
    "--device=cuda", "--log_every_n_steps=1", "--start_new_model",
]
TRAIN_ROUTES = {
    "fused": ["--fused_train_aggregation"],
    "plain": [],
    "fused_f32": ["--fused_train_aggregation", "--compute_dtype=float32"],
    "plain_f32": ["--compute_dtype=float32"],
}
# (fused run, plain run, the most relative loss gap allowed at any step).
# In f32 the two routes differ in summation order only (1.5e-6 measured);
# in bf16 the fused route rounds A and dV₁ to bf16 and the plain one does
# not (1.018e-3 measured with the first port's kernels, 9.35e-4 with the
# tensor-core ones, the same bits in every run).  PERF.md gives the
# readings of planted gradient faults against both limits
# (tools/torch_loss_gate_faults.py).
LOSS_GATES = (("fused", "plain", 2e-3), ("fused_f32", "plain_f32", 2e-5))


def train_runs(data: str, workdir: str, routes) -> tuple:
    """The train CLI once per route of ``routes`` (names of TRAIN_ROUTES)
    on ``data``, each from the same weights and batches, with the launch
    counters zeroed just before the run and read just after.  Returns
    ({route: {cli_s, losses, gap}}, {route: launches})."""
    runs, paths = {}, {}
    for route in routes:
        reset_counters()
        start = time.perf_counter()
        trainer = train.main(TRAIN_FLAGS + TRAIN_ROUTES[route] + [
            f"--train_data_pattern={data}", f"--train_dir={os.path.join(workdir, route)}"])
        torch.cuda.synchronize()
        paths[route] = counters()
        runs[route] = {"cli_s": time.perf_counter() - start,
                       "losses": [h["loss"] for h in trainer.history],
                       "gap": [float(h["gap"]) for h in trainer.history]}
        if route != "fused":
            shutil.rmtree(os.path.join(workdir, route))
    return runs, paths


def loss_gaps(runs) -> dict:
    """Per LOSS_GATES pair: the relative loss gap of the fused run from the
    plain one at each step."""
    return {fused: [abs(a - b) / abs(b) for a, b in zip(runs[fused]["losses"], runs[plain]["losses"])]
            for fused, plain, _ in LOSS_GATES}


def phase_train_e2e(dev, workdir, smi):
    """The train CLI at full Willow width on 512 synthetic videos of up to
    300 frames: five bf16 steps with --fused_train_aggregation, the main
    path (each training kernel twice a step), then the same five steps from
    the same weights and batches without it, and both again in f32; then
    the inference CLI reads the fused run's checkpoint (the other runs'
    are removed as soon as they end: 3.7 GB each).

    The losses must be finite and fall from step 1 to step 5.  Step 1 sees
    the forward alone: there the routes must agree within 1e-5 relative.
    Every step must agree within the limit of LOSS_GATES.  (In bf16 that is
    twice the 1e-3 budget of the JAX training drill, which the first port's
    1.018e-3 missed: the first Adam update at the default learning rate
    raises the loss by half and amplifies the rounding, see ROADMAP §3.)"""
    data = os.path.join(workdir, "train-0.tfrecord")
    start = time.perf_counter()
    truth = write_frame_level_fixture(data, 512, seed=0)
    setup_s = time.perf_counter() - start
    runs, paths = train_runs(data, workdir, TRAIN_ROUTES)
    none = dict.fromkeys(KERNELS, 0)
    fused_launches = {**none, **{name: 2 * 5 for name in TRAIN_KERNELS}}
    want = {"fused": fused_launches, "plain": none, "fused_f32": fused_launches, "plain_f32": none}
    if paths != want:
        raise AssertionError(f"launches per run {paths}, expected {want}")
    rel = loss_gaps(runs)
    for fused, plain, limit in LOSS_GATES:
        lf, lp = runs[fused]["losses"], runs[plain]["losses"]
        if len(lf) != 5 or len(lp) != 5 or not all(np.isfinite(lf + lp)) or not lf[-1] < lf[0]:
            raise AssertionError(f"{fused} losses {lf}, {plain} {lp}: want five finite values "
                                 "each, the last below the first")
        if max(rel[fused]) > limit or rel[fused][0] > 1e-5:
            raise AssertionError(f"{fused} {lf} and {plain} {lp} losses differ by {rel[fused]} "
                                 f"(limit {limit}, step 1 1e-5)")

    out_csv = os.path.join(workdir, "predictions.csv")
    reset_counters()
    written = inference.main([
        "--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
        "--feature_sizes=1024,128", f"--input_data_pattern={data}",
        f"--train_dir={os.path.join(workdir, 'fused')}", f"--output_file={out_csv}",
        "--batch_size=256", "--fast_infer", "--device=cuda",
    ])
    torch.cuda.synchronize()
    paths["inference_of_trained"] = counters()
    if paths["inference_of_trained"] != {**none, "netvlad_frontend": -(-len(truth) // 256)}:
        raise AssertionError(f"inference launches {paths['inference_of_trained']}")
    with open(out_csv) as f:
        lines = f.read().splitlines()
    vids = sorted(line.split(",")[0] for line in lines[1:])
    if written != len(truth) or vids != sorted(t["video_id"].decode() for t in truth):
        raise AssertionError(f"the CSV of the trained weights has {len(lines) - 1} rows for {len(truth)} videos")
    for line in lines[1:]:
        nums = line.split(",")[1].split()
        vals = [float(v) for v in nums[1::2]]
        if len(nums) != 40 or any(a < b for a, b in zip(vals, vals[1:])) or not all(0 <= v <= 1 for v in vals):
            raise AssertionError(f"bad CSV row: {line[:120]}")
    emit({"phase": "train_e2e", "videos": len(truth), "setup_s": setup_s, "runs": runs,
          "loss_rel_diff_fused_vs_plain": rel, "launches_per_run": paths, "csv_rows": written,
          "card": smi})
    return {name: paths["fused"][name] for name in TRAIN_KERNELS}


def random_train_batch(rng: np.random.Generator, b: int, dev, frame_features: bool = True) -> dict:
    """A train batch of ``b`` videos on the card: uint8 frames [B, 300,
    1152] with 1-300 valid, or video-level features [B, 1152]; 0.2 %
    positive labels."""
    if frame_features:
        batch = {"features": torch.from_numpy(rng.integers(0, 256, (b, F, DT), dtype=np.uint8)).to(dev),
                 "num_frames": torch.from_numpy(rng.integers(1, F + 1, b).astype(np.int32)).to(dev)}
    else:
        batch = {"features": torch.from_numpy(rng.normal(size=(b, DT)).astype(np.float32)).to(dev)}
    batch["labels"] = torch.from_numpy((rng.random((b, 3862)) < 0.002).astype(np.float32)).to(dev)
    batch["weights"] = torch.ones(b, device=dev)
    return batch


def time_train_step(dev, name: str, mcfg: ModelConfig, tcfg: TrainingConfig, batch: dict,
                    frame_features: bool = True, tree=None, rounds: int = 5, state=None) -> tuple:
    """``name``'s train step at ``mcfg`` (weights ``tree``, by default from
    init_variables_np, or a TrainState ``state`` of ``tcfg`` that a caller
    has stepped already) on ``batch``: the median of ``rounds`` rounds of
    ``rounds`` steps by CUDA events, forward, backward and optimizer ms
    (medians over ``rounds`` steps), peak memory.  Returns (line, step)
    where ``step()`` runs one more step."""
    fcfg = FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), frame_features, F)
    b = batch["features"].shape[0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if state is None:
        model = create_model(name, mcfg, DT)
        load_flax_variables(model, tree or init_variables_np(mcfg, fcfg, seed=0, model_name=name)).to(dev)
        state = TrainState.create(model, tcfg)
    model = state.model
    step = TrainStep(CrossEntropyLoss(), tcfg, mcfg, frame_features)
    key = prng.key(0)
    for _ in range(2):
        step(state, batch, key)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(rounds):
            step(state, batch, key)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / rounds)
    stages = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(rounds if step.accum == 1 else 0):  # an accumulated step has no single forward
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        total = step.loss(state, batch, key)[0]
        ev[1].record()
        grads = step_lib.gradients(total, state.model)
        ev[2].record()
        state.apply_gradients(grads)
        ev[3].record()
        ev[3].synchronize()
        for stage, (a, c) in zip(stages, ((0, 1), (1, 2), (2, 3))):
            stages[stage].append(ev[a].elapsed_time(ev[c]))
    step_ms = statistics.median(times)
    line = {"B": b, "S": mcfg.iterations if frame_features and model.samples_frames else None,
            "videos_per_s": b / (step_ms / 1e3), "step_ms": step_ms,
            "videos_per_s_rounds": [b / (ms / 1e3) for ms in times],
            **{stage: statistics.median(v) if v else None for stage, v in stages.items()},
            "parameters": sum(p.numel() for p in model.parameters()),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    return line, lambda: step(state, batch, key)


def phase_train_throughput(dev, smi):
    """The train step at full Willow width, B=256, S=30, bf16, fused route:
    videos/s (the median of five rounds of five steps), forward, backward and
    optimizer ms (medians over five steps, CUDA events), peak memory; then
    torch.profiler over five steps."""
    mcfg = ModelConfig(compute_dtype="bfloat16", fused_train_aggregation=True, presampled=True)
    tcfg = TrainingConfig(batch_size=256, presample_frames=True)
    batch = random_train_batch(np.random.default_rng(2), 256, dev)
    line, step = time_train_step(dev, "NetVLADModelLF", mcfg, tcfg, batch)
    emit({"phase": "train_throughput", **line, "route": "fused bf16", "card": smi})
    emit({"phase": "train_profile", "route": "fused bf16", "B": 256, "S": mcfg.iterations,
          **profile_device(step), "card": smi})
    return line["videos_per_s"]


# the train CLI's runs of phase_train_zoo_e2e: run → (model, flags), flags
# None for video-level input; each at the model's default width, B=256,
# five bf16 steps at the CLI's default learning rate.  NetRVLADModelLF takes
# the four routes of TRAIN_ROUTES
ZOO_RUNS = {
    **{f"NetRVLADModelLF/{route}": ("NetRVLADModelLF", flags) for route, flags in TRAIN_ROUTES.items()},
    "NetFVModelLF": ("NetFVModelLF", []),
    "SoftDbofModelLF": ("SoftDbofModelLF", []),
    "NeXtVLADModel": ("NeXtVLADModel", []),
    "DbofModel": ("DbofModel", []),
    "FrameLevelLogisticModel": ("FrameLevelLogisticModel", []),
    "LogisticModel": ("LogisticModel", None),
    "MoeModel": ("MoeModel", None),
    "NetVLADModelLF/dimred256": ("NetVLADModelLF", ["--netvlad_dimred=256", "--fused_train_aggregation"]),
    "DbofModel/windows": ("DbofModel", ["--nosample_random_frames"]),
}
ZOO_STEP_FLAGS = ["--batch_size=256", "--max_steps=5", "--compute_dtype=bfloat16", "--device=cuda",
                  "--log_every_n_steps=1", "--start_new_model"]
FRAME_FLAGS = ["--frame_features", "--feature_names=rgb,audio", "--feature_sizes=1024,128"]
VIDEO_FLAGS = ["--feature_names=mean_rgb,mean_audio", "--feature_sizes=1024,128"]
# the step-1 loss of a model's f32 train step on the card against the same
# step on the CPU (same first batch and weights): the summation order alone
ZOO_CPU_GATE = 1e-5
# the run of each model whose checkpoint the eval CLI reads back
# (NetRVLADModelLF's four routes write checkpoints of one format)
ZOO_EVAL_RUNS = [run for run in ZOO_RUNS if not run.startswith("NetRVLADModelLF/") or run == "NetRVLADModelLF/fused"]
# NetRVLADModelLF's loss gates: at the CLI's lr of 0.01 the first Adam
# update moves nearly every weight by ±0.01, whatever the size of its
# gradient, and the two bf16 routes then drift from f32 each by its own
# rounding: 7.8e-3 apart at step 5, the plain route 7.1e-3 from f32 and the
# fused one 8.4e-4 (PERF.md).  So the bf16 pair is held at step 1 (the
# forward, 1e-5) and by its step-1 gradients (ZOO_GRAD_GATES); the f32 pair
# on every step as LOSS_GATES holds it
ZOO_LOSS_GATES = tuple(g for g in LOSS_GATES if g[0] == "fused_f32")
# per route of NetRVLADModelLF, the most relative distance ‖g − g₀‖ / ‖g₀‖
# allowed between a parameter tensor's step-1 gradient and the plain f32
# route's g₀, on the CLI's first batch and weights.  Set between the
# readings of tools/torch_loss_gate_faults.py (PERF.md): sound, the fused
# bf16 route reads 2.55e-2 (the rgb cluster_bn.bias, where the column sum of
# dL cancels and the kernel's two bf16 roundings show: ROADMAP §3 item 12),
# the plain bf16 one 1.10e-2, fused f32 5.5e-6; the smallest planted
# backward fault that can show at zero C₂ (cluster 0's dL zeroed) 8.3e-2
ZOO_GRAD_GATES = {"fused": 5e-2, "plain": 5e-2, "fused_f32": 1e-4}


def zoo_model_flags(run: str) -> list:
    """The model and input flags of a ZOO_RUNS run."""
    name, flags = ZOO_RUNS[run]
    return [f"--model={name}", *(VIDEO_FLAGS if flags is None else FRAME_FLAGS + flags)]


def zoo_modules(run: str) -> int:
    """The pooling modules of a fused ZOO_RUNS run, each one launch of a
    training kernel a step; 0 for a run without --fused_train_aggregation."""
    args = train.build_parser().parse_args(zoo_model_flags(run))
    if not args.fused_train_aggregation:
        return 0
    _, mcfg, _ = train.configs_from_args(args)
    return len(lf_layout(args.model, mcfg, DT))


def zoo_args(run: str, *extra: str) -> tuple:
    """(args, (fcfg, mcfg, tcfg)) of ``run``'s train CLI, ``extra`` last."""
    args = train.build_parser().parse_args(ZOO_STEP_FLAGS + zoo_model_flags(run) + list(extra))
    return args, train.configs_from_args(args)


def zoo_first_batch(args, configs, data: str) -> dict:
    """The batch that the train CLI of ``args`` reads first from ``data``
    (its reader, shuffle and seed): the same for every model of one kind of
    input."""
    fcfg, mcfg, tcfg = configs
    batch = next(batch_iterator(make_reader(fcfg, mcfg.vocab_size), data, tcfg.batch_size,
                                num_epochs=tcfg.num_epochs, shuffle=True, shuffle_buffer=args.shuffle_buffer,
                                seed=args.seed))
    return {k: torch.from_numpy(v) for k, v in batch.items() if k != "video_id"}


def zoo_init(args, configs) -> dict:
    """The train CLI's initial variables for ``args``."""
    fcfg, mcfg, _ = configs
    return init_variables_np(mcfg, fcfg, seed=args.seed, model_name=args.model)


def step1_loss(where, args, configs, batch, tree, grad: bool = False):
    """The loss of the first train step on ``where``, and with ``grad`` the
    gradient of each parameter tensor ({name: f32 tensor})."""
    fcfg, mcfg, tcfg = configs
    model = load_flax_variables(create_model(args.model, mcfg, fcfg.total_size), tree).to(where)
    step = TrainStep(CrossEntropyLoss(), tcfg, mcfg, fcfg.frame_features)
    with torch.set_grad_enabled(grad):
        total = step.loss(TrainState.create(model, tcfg), {k: v.to(where) for k, v in batch.items()},
                          prng.key(args.seed))[0]
        if not grad:
            return float(total), None
        grads = step_lib.gradients(total, model)
    return float(total.detach()), {n: g.float() for (n, _), g in zip(model.named_parameters(), grads)}


def cpu_step1_gap(dev, run: str, batch: dict, tree=None) -> dict:
    """``run``'s f32 train step, the loss of the CLI's first ``batch``: on
    the card and on the CPU, from ``tree`` or the CLI's initial weights."""
    args, configs = zoo_args(run, "--compute_dtype=float32")
    tree = tree or zoo_init(args, configs)
    loss = [step1_loss(where, args, configs, batch, tree)[0] for where in (dev, torch.device("cpu"))]
    return {"card": loss[0], "cpu": loss[1], "rel": abs(loss[0] - loss[1]) / abs(loss[1])}


def step1_gradient_gaps(dev, model: str, batch: dict, tree) -> dict:
    """``model``'s four routes of TRAIN_ROUTES on the card, each from the
    CLI's first ``batch`` and initial variables ``tree``: per route other
    than plain_f32, {parameter: ‖g − g₀‖ / ‖g₀‖} of its step-1 gradient g
    against the plain f32 route's g₀."""
    grads = {}
    for route in TRAIN_ROUTES:
        args, configs = zoo_args(f"{model}/{route}")
        grads[route] = step1_loss(dev, args, configs, batch, tree, grad=True)[1]
    ref = grads.pop("plain_f32")
    return {route: {n: float((g[n] - ref[n]).norm() / ref[n].norm().clamp(min=1e-30)) for n in ref}
            for route, g in grads.items()}


def phase_train_zoo_e2e(dev, workdir, smi):
    """The train CLI for every model the port trains, at its full default
    width (config.py), five bf16 steps of B=256 each (ZOO_RUNS): on the
    512-video frame-level fixture of phase_train_e2e in ``workdir``, or on
    512 video-level records for LogisticModel and MoeModel.  Gates:

    - five finite losses a run, the last below the first;
    - NetRVLADModelLF's fused routes against its plain ones: within 1e-5
      relative at step 1, the f32 pair within ZOO_LOSS_GATES at every step;
      the step-1 gradient of each parameter tensor on every route within
      ZOO_GRAD_GATES of the plain f32 route's (the bf16 pair's losses at
      steps 2-5 are printed);
    - each model's f32 train step on the card against the same step on the
      CPU, on the CLI's first batch and weights: within ZOO_CPU_GATE in
      loss; NetRVLAD's f32 CLI runs' step-1 losses within it of the CPU's
      too;
    - launches: each training kernel once per pooling module a step in the
      fused runs (NetRVLAD 2, NetVLAD with --netvlad_dimred=256 1), no
      kernel anywhere else;
    - the eval CLI (--run_once, the model-forward route) reads a trained
      checkpoint of each model back (ZOO_EVAL_RUNS) with a finite GAP, on 64
      videos of the same kind.
    Returns {kernel: launches in the fused runs}."""
    frame = os.path.join(workdir, "train-0.tfrecord")
    video = os.path.join(workdir, "video-0.tfrecord")
    small = {"frame": os.path.join(workdir, "small-frame.tfrecord"),
             "video": os.path.join(workdir, "small-video.tfrecord")}
    start = time.perf_counter()
    write_video_level_fixture(video, 512, seed=0)
    write_frame_level_fixture(small["frame"], 64, seed=1)
    write_video_level_fixture(small["video"], 64, seed=1)
    setup_s = time.perf_counter() - start
    none = dict.fromkeys(KERNELS, 0)
    runs, launches, total = {}, {}, dict(none)
    for run, (name, flags) in ZOO_RUNS.items():
        data = video if flags is None else frame
        train_dir = os.path.join(workdir, "zoo", run)
        reset_counters()
        start = time.perf_counter()
        trainer = train.main(ZOO_STEP_FLAGS + zoo_model_flags(run) + [
            f"--train_data_pattern={data}", f"--train_dir={train_dir}"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - start
        launches[run] = counters()
        want = {**none, **dict.fromkeys(TRAIN_KERNELS, zoo_modules(run) * 5)}
        if launches[run] != want:
            raise AssertionError(f"{run}: launches {launches[run]}, expected {want}")
        for kernel, n in launches[run].items():
            total[kernel] += n
        losses = [h["loss"] for h in trainer.history]
        if len(losses) != 5 or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{run}: losses {losses}, want five finite values, the last below the first")
        runs[run] = {"cli_s": cli_s, "losses": losses, "gap": [float(h["gap"]) for h in trainer.history]}
        if run in ZOO_EVAL_RUNS:
            eval_flags = [f for f in zoo_model_flags(run) if f != "--fused_train_aggregation"]
            start = time.perf_counter()
            reset_counters()
            info = eval_cli.main(eval_flags + ["--compute_dtype=bfloat16", "--device=cuda", "--batch_size=64",
                                               "--run_once", f"--train_dir={train_dir}",
                                               "--eval_data_pattern=" + small['video' if flags is None else 'frame']])
            torch.cuda.synchronize()
            if counters() != none or not np.isfinite(float(info["gap"])):
                raise AssertionError(f"{run}: eval GAP {info['gap']}, launches {counters()}")
            runs[run].update(eval_s=time.perf_counter() - start, eval_gap=float(info["gap"]))
        shutil.rmtree(train_dir)
    rel = {fused: [abs(a - b) / abs(b) for a, b in zip(runs[f"NetRVLADModelLF/{fused}"]["losses"],
                                                        runs[f"NetRVLADModelLF/{plain}"]["losses"])]
           for fused, plain, _ in LOSS_GATES}
    emit({"phase": "train_zoo_e2e", "part": "runs", "videos": 512, "setup_s": setup_s, "runs": runs,
          "netrvlad_loss_rel_diff_fused_vs_plain": rel, "launches_per_run": launches, "card": smi})
    limits = {fused: limit for fused, _, limit in ZOO_LOSS_GATES}
    for fused, plain, _ in LOSS_GATES:
        if rel[fused][0] > 1e-5 or max(rel[fused]) > limits.get(fused, np.inf):
            raise AssertionError(f"NetRVLADModelLF {fused} and {plain} losses differ by {rel[fused]} "
                                 f"(limit {limits.get(fused)}, step 1 1e-5)")
    start = time.perf_counter()
    first = {kind: zoo_first_batch(*zoo_args(run), data)
             for kind, run, data in ((True, "NetRVLADModelLF/plain_f32", frame), (False, "LogisticModel", video))}
    rvlad = zoo_init(*zoo_args("NetRVLADModelLF/plain_f32"))
    grads = step1_gradient_gaps(dev, "NetRVLADModelLF", first[True], rvlad)
    worst = {route: max(g.items(), key=lambda kv: kv[1]) for route, g in grads.items()}
    emit({"phase": "train_zoo_e2e", "part": "step1_gradient_vs_plain_f32", "model": "NetRVLADModelLF",
          "rel_distance": grads, "worst": worst, "limits": ZOO_GRAD_GATES,
          "seconds": time.perf_counter() - start, "card": smi})
    for route, (param, gap) in worst.items():
        if gap > ZOO_GRAD_GATES[route]:
            raise AssertionError(f"NetRVLADModelLF {route}: the step-1 gradient of {param} is {gap} from "
                                 f"the plain f32 route's (limit {ZOO_GRAD_GATES[route]})")
    start = time.perf_counter()
    cpu = {}
    for run, (name, flags) in ZOO_RUNS.items():
        if run.endswith("plain") or run.endswith("_f32") or run in cpu:
            continue
        cpu[run] = cpu_step1_gap(dev, run, first[flags is not None], rvlad if name == "NetRVLADModelLF" else None)
    for route in ("fused_f32", "plain_f32"):
        first = runs[f"NetRVLADModelLF/{route}"]["losses"][0]
        want = cpu["NetRVLADModelLF/fused"]["cpu"]
        cpu[f"NetRVLADModelLF/{route} CLI"] = {"card": first, "cpu": want, "rel": abs(first - want) / abs(want)}
    emit({"phase": "train_zoo_e2e", "part": "f32_step1_card_vs_cpu", "losses": cpu,
          "seconds": time.perf_counter() - start, "card": smi})
    worst = max(v["rel"] for v in cpu.values())
    if worst > ZOO_CPU_GATE:
        raise AssertionError(f"f32 step-1 losses, card against CPU: {cpu} (limit {ZOO_CPU_GATE})")
    return {name: total[name] for name in TRAIN_KERNELS}


# the train CLI's runs of phase_train_resume: Willow fused bf16, saving
# every second step and keeping the newest checkpoint
RESUME_FLAGS = [f for f in TRAIN_FLAGS if not f.startswith(("--max_steps", "--start_new_model"))] + [
    "--fused_train_aggregation", "--save_checkpoint_every_n_steps=2", "--keep_checkpoint_max=1"]
# the resumed CLI's step-3 loss against an in-process step from the step-2
# checkpoint: the same state, batch and key through the same kernels
RESUME_LOSS_GATE = 1e-6


class LogLines(logging.Handler):
    """Keeps the messages of a logger while it is attached."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def leaf_mismatches(tree, arrays) -> list:
    """The leaves of ``tree`` (name → tensor) that differ from ``arrays``
    (a checkpoint's name → (stored array, dtype)) in name, dtype or bits."""
    bad = sorted(set(tree) ^ set(arrays))
    for name, t in tree.items():
        if name in arrays:
            arr, dtype = arrays[name]
            if dtype != checkpoints.dtype_name(t) or not np.array_equal(checkpoints.to_numpy(t), arr):
                bad.append(name)
    return bad


def phase_train_resume(dev, workdir, smi):
    """Checkpoints and resume through the train CLI at full Willow width
    (RESUME_FLAGS: B=256, S=30, bf16, fused; each training kernel twice a
    step) on train_e2e's 512 videos: two steps, a checkpoint at step 2; a
    planted ``3.tmp-…`` directory as a save killed midway leaves it; the CLI
    again to step 4.  Gates, none caught: the second run restores step 2
    and logs it; the step-2 checkpoint equals the first run's live state
    and an in-process restore of it bit for bit, every leaf (parameters, BN
    statistics, μ, ν, counts, step); the resumed step-3 loss is within
    RESUME_LOSS_GATE of that restored state's loss on the CLI's first batch
    at step 2's key; only step 4 is left; the eval CLI (--run_once
    --fast_forward, the front-end kernel once a batch) writes its summary at
    step 4.  Returns {kernel: launches} of the three CLI runs."""
    data = os.path.join(workdir, "train-0.tfrecord")
    train_dir = os.path.join(workdir, "resume")

    def argv(steps):
        return RESUME_FLAGS + [f"--max_steps={steps}", f"--train_data_pattern={data}", f"--train_dir={train_dir}"]

    none = dict.fromkeys(KERNELS, 0)
    launches, seconds = {}, {}
    reset_counters()
    start = time.perf_counter()
    first = train.main(argv(2))
    torch.cuda.synchronize()
    seconds["first_cli"] = time.perf_counter() - start
    launches["first"] = counters()
    mngr = CheckpointManager(train_dir)
    if mngr.all_steps() != [2]:
        raise AssertionError(f"checkpoints after two steps: {mngr.all_steps()}, expected [2]")
    step_dir = os.path.join(mngr.directory, "2")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
    start = time.perf_counter()
    saved = mngr.load_arrays(2)
    seconds["read_npy"] = time.perf_counter() - start
    bad = leaf_mismatches(first.state.state_tree(), saved)
    if bad:
        raise AssertionError(f"the step-2 checkpoint differs from the trained state at {bad[:8]}")
    n_leaves = len(saved)
    save_s = {f"step {k}": v for k, v in first.save_seconds.items()}
    del first, saved
    torch.cuda.empty_cache()

    args = train.build_parser().parse_args(argv(4))
    fcfg, mcfg, tcfg = configs = train.configs_from_args(args)
    restored = TrainState.create(create_model(args.model, mcfg, fcfg.total_size).to(dev), tcfg)
    start = time.perf_counter()
    restored.load_state_tree(mngr.restore(2, like=restored.state_tree()))
    torch.cuda.synchronize()
    seconds["restore_in_process"] = time.perf_counter() - start
    bad = leaf_mismatches(restored.state_tree(), mngr.load_arrays(2))
    if bad or restored.step != 2:
        raise AssertionError(f"the restored state differs from the checkpoint at {bad[:8]} (step {restored.step})")
    batch = {k: v.to(dev) for k, v in zoo_first_batch(args, configs, data).items()}
    with torch.no_grad():
        want = float(TrainStep(CrossEntropyLoss(), tcfg, mcfg, True).loss(restored, batch, prng.key(args.seed))[0])
    del restored, batch
    torch.cuda.empty_cache()

    planted = os.path.join(mngr.directory, "3.tmp-planted")
    os.makedirs(planted)
    with open(os.path.join(planted, "00000.npy"), "wb") as f:
        f.write(b"\x93NUMPY half-written")
    if mngr.latest_step() != 2:
        raise AssertionError(f"the planted directory moved the latest step to {mngr.latest_step()}")
    log_lines = LogLines()
    logging.getLogger(train.__name__).addHandler(log_lines)
    logging.getLogger(train.__name__).setLevel(logging.INFO)
    reset_counters()
    start = time.perf_counter()
    try:
        second = train.main(argv(4))
        torch.cuda.synchronize()
    finally:
        logging.getLogger(train.__name__).removeHandler(log_lines)
    seconds["second_cli"] = time.perf_counter() - start
    launches["second"] = counters()
    restore_line = [m for m in log_lines.lines if "restored checkpoint at step" in m]
    if second.restored_step != 2 or not restore_line or not restore_line[0].endswith("restored checkpoint at step 2"):
        raise AssertionError(f"the second run restored {second.restored_step}, logged {restore_line}")
    steps = [h["step"] for h in second.history]
    got = second.history[0]["loss"]
    rel = abs(got - want) / abs(want)
    if steps != [3, 4] or not all(np.isfinite(h["loss"]) for h in second.history) or rel > RESUME_LOSS_GATE:
        raise AssertionError(f"resumed steps {steps}, step-3 loss {got} against {want} in process "
                             f"(relative {rel}, limit {RESUME_LOSS_GATE})")
    if mngr.all_steps() != [4] or sorted(os.listdir(mngr.directory)) != ["4"]:
        raise AssertionError(f"after the resume: {sorted(os.listdir(mngr.directory))}, expected ['4']")

    summaries = []

    class Writer(eval_cli.MetricWriter):
        def epoch_summary(self, step, info):
            summaries.append(step)
            super().epoch_summary(step, info)

    real_writer, eval_cli.MetricWriter = eval_cli.MetricWriter, Writer
    reset_counters()
    try:
        info = eval_cli.main(["--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
                              "--feature_sizes=1024,128", "--fast_forward", "--run_once", "--batch_size=256",
                              "--device=cuda", f"--train_dir={train_dir}", f"--eval_data_pattern={data}"])
        torch.cuda.synchronize()
    finally:
        eval_cli.MetricWriter = real_writer
    launches["eval"] = counters()
    want_launches = {"first": {**none, **dict.fromkeys(TRAIN_KERNELS, 2 * 2)},
                     "second": {**none, **dict.fromkeys(TRAIN_KERNELS, 2 * 2)},
                     "eval": {**none, "netvlad_frontend": 2}}
    if summaries != [4] or not np.isfinite(info["gap"]) or launches != want_launches:
        raise AssertionError(f"eval summaries at {summaries}, GAP {info['gap']}, launches {launches}")
    no_save = [h for h in second.history if h["step"] == 3][0]
    emit({"phase": "train_resume", "checkpoint_bytes": nbytes, "leaves": n_leaves,
          "save_s": {**save_s, **{f"step {k}": v for k, v in second.save_seconds.items()}},
          "restore_s_cli": second.restore_seconds, "seconds": seconds,
          "step3_loss": {"cli": got, "in_process": want, "rel": rel, "limit": RESUME_LOSS_GATE},
          "step_ms_without_save": 256 / no_save["examples_per_sec"] * 1e3,
          "eval_summary_steps": summaries, "eval_gap": info["gap"], "launches": launches, "card": smi})
    return {name: sum(run[name] for run in launches.values()) for name in KERNELS}


# every --optimizer of the JAX package, and Adam with --adam_bf16_momentum
OPTIMIZER_RUNS = {"AdamOptimizer": {}, "AdamOptimizer-bf16": {"adam_bf16_momentum": True},
                  "AdagradOptimizer": {}, "RMSPropOptimizer": {}, "SgdOptimizer": {},
                  "MomentumOptimizer": {}, "AdafactorOptimizer": {}}
# each parameter's first update on the card against the CPU's from the same
# parameters and gradients, max |Δ| over max |CPU update|: the two differ in
# the f32 order of the clip's norm and of Adafactor's means
OPTIMIZER_GATE = 1e-6
# each optimizer's step timed as train_12b times its modes: three rounds of
# three steps
OPTIMIZER_TIMING_ROUNDS = 3


def phase_optimizers(dev, smi):
    """Every optimizer on Willow fused bf16 at B=256 (S=30): the first
    update on the card within OPTIMIZER_GATE of the CPU's, per parameter;
    five finite losses; the step's forward, backward and optimizer ms
    (time_train_step)."""
    mcfg = ModelConfig(compute_dtype="bfloat16", fused_train_aggregation=True, presampled=True)
    fcfg = FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), True, F)
    tree = init_variables_np(mcfg, fcfg, seed=0, model_name="NetVLADModelLF")
    batch = random_train_batch(np.random.default_rng(3), 256, dev)
    key = prng.key(0)
    worst = {}
    for run, extra in OPTIMIZER_RUNS.items():
        start = time.perf_counter()
        tcfg = TrainingConfig(batch_size=256, presample_frames=True, optimizer=run.split("-")[0], **extra)
        model = load_flax_variables(create_model("NetVLADModelLF", mcfg, DT), tree).to(dev)
        state = TrainState.create(model, tcfg)
        step = TrainStep(CrossEntropyLoss(), tcfg, mcfg, True)
        total = step.loss(state, batch, key)[0]
        grads = step_lib.gradients(total, model)
        cpu_tx = optimizers.create_optimizer(
            [(name, p.detach().cpu()) for name, p in model.named_parameters()], tcfg)
        want = cpu_tx.updates([g.cpu() for g in grads])
        got = state.tx.updates(grads)
        gaps = {}
        for (name, p), u, w in zip(model.named_parameters(), got, want):
            gaps[name] = ((u.cpu() - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
            with torch.no_grad():
                p.add_(u)
        state.step += 1
        del cpu_tx, want, got, grads
        losses = [total.item()] + [float(step(state, batch, key)["loss"]) for _ in range(4)]
        worst[run] = max(gaps.items(), key=lambda kv: kv[1])
        check_s = time.perf_counter() - start
        del model, step, total
        # timed on the checked state, five steps in
        line, _ = time_train_step(dev, "NetVLADModelLF", mcfg, tcfg, batch, rounds=OPTIMIZER_TIMING_ROUNDS,
                                  state=state)
        del state
        emit({"phase": "optimizers", "optimizer": run, "first_update_rel_gap_card_vs_cpu": worst[run],
              "limit": OPTIMIZER_GATE, "losses": losses, "check_s": check_s, **line, "card": smi})
        if worst[run][1] > OPTIMIZER_GATE or not all(np.isfinite(losses)):
            raise AssertionError(f"{run}: first update {worst[run]} from the CPU's (limit {OPTIMIZER_GATE}), "
                                 f"losses {losses}")
        torch.cuda.empty_cache()


def fixture_tool():
    """tools/torch_make_tf_bundle_fixture.py, for its fixture's path and flags
    (it imports tensorflow only when it writes)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "torch_make_tf_bundle_fixture.py")
    spec = importlib.util.spec_from_file_location("torch_make_tf_bundle_fixture", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def csv_scores(path: str) -> dict:
    """{video: {label: score}} of an inference CSV."""
    out = {}
    with open(path) as f:
        for line in f.read().splitlines()[1:]:
            vid, pairs = line.split(",")
            nums = pairs.split()
            out[vid] = {int(i): float(v) for i, v in zip(nums[::2], nums[1::2])}
    return out


def phase_tf_import(dev, workdir, smi):
    """The inference CLI with --reference_checkpoint on the committed TF1
    bundle, read by the port's own bundle reader, on the card and on the
    CPU: the same videos and labels, scores within 1e-5."""
    fixture = fixture_tool()
    data = os.path.join(workdir, "tf-frames-0.tfrecord")
    write_frame_level_fixture(data, 10, num_classes=12, rgb_size=16, audio_size=8, max_frames=20, seed=2)
    scores = {}
    start = time.perf_counter()
    for device in ("cuda", "cpu"):
        out = os.path.join(workdir, f"tf-{device}.csv")
        inference.main(fixture.FIXTURE_FLAGS + [
            f"--reference_checkpoint={fixture.FIXTURE_DIR}", f"--input_data_pattern={data}",
            f"--output_file={out}", "--batch_size=4", "--top_k=12", f"--device={device}",
            f"--train_dir={os.path.join(workdir, 'no-checkpoints')}"])
        scores[device] = csv_scores(out)
    card, cpu = scores["cuda"], scores["cpu"]
    if sorted(card) != sorted(cpu) or len(card) != 10 or any(sorted(card[v]) != sorted(cpu[v]) for v in cpu):
        raise AssertionError(f"the card's CSV holds other videos or labels than the CPU's: {card} {cpu}")
    gap = max(abs(card[v][k] - cpu[v][k]) for v in cpu for k in cpu[v])
    emit({"phase": "tf_import", "videos": len(card), "max_abs_score_gap_card_vs_cpu": gap, "limit": 1e-5,
          "seconds": time.perf_counter() - start, "card": smi})
    if gap > 1e-5:
        raise AssertionError(f"--reference_checkpoint scores differ by {gap} between the card and the CPU")


def phase_train_zoo_throughput(dev, smi):
    """Each trained model's bf16 train step at its full default width, B=256
    (S=30 for the sampling models, all 300 frames for
    FrameLevelLogisticModel, video-level features for LogisticModel and
    MoeModel), as time_train_step reports it; NetRVLADModelLF on its fused
    and plain routes; then torch.profiler over NetRVLAD's fused step.
    Informational: no limit yet."""
    rng = np.random.default_rng(3)
    batches = {True: random_train_batch(rng, 256, dev), False: random_train_batch(rng, 256, dev, False)}
    for run, (name, flags) in ZOO_RUNS.items():
        if run.endswith("_f32"):
            continue
        args = train.build_parser().parse_args(zoo_model_flags(run) + ["--compute_dtype=bfloat16"])
        fcfg, mcfg, _ = train.configs_from_args(args)
        tcfg = TrainingConfig(batch_size=256)
        line, step = time_train_step(dev, name, mcfg, tcfg, batches[fcfg.frame_features], fcfg.frame_features)
        emit({"phase": "train_zoo_throughput", "run": run, "model": name, **line, "card": smi})
        if run == "NetRVLADModelLF/fused":
            emit({"phase": "train_zoo_profile", "run": run, "B": 256, "S": mcfg.iterations,
                  **profile_device(step), "card": smi})
        del step
        torch.cuda.empty_cache()


# (D, K) of the rgb and audio modules at the full default widths of
# NetFVModelLF-64 and SoftDbofModelLF-4096, and a small shape off every tile
# width (NetFV: 32 clusters, 64 rows, 32 samples; SoftDBoW: 128 clusters,
# 64-deep D steps, 128 rows, rows of 50 values that take the 2-byte loads)
LF_KERNEL_MODS = {"netfv_fused": ((D_RGB, 64), (D_AUD, 32)),
                  "softdbow_fused": ((D_RGB, 4096), (D_AUD, 2048))}
LF_SMALL_MODS = {"netfv_fused": ((42, 20), (8, 10)), "softdbow_fused": ((42, 150), (8, 10))}
# (B, F, S, table) of phase_lf_kernels' small checks: every tile width, then
# SoftDBoW with a video of S > 128 rows and one of S = 31
LF_SMALL_CHECKS = ((3, 10, 7, LF_SMALL_MODS),
                   (3, 200, 150, {"softdbow_fused": LF_SMALL_MODS["softdbow_fused"]}),
                   (5, 40, 31, {"softdbow_fused": LF_SMALL_MODS["softdbow_fused"]}))
# NetFV's edge shapes for its bf16 kernel: S=31 and 33 end on a partial
# 16-sample stage of the ring at full width; K=512 at D=1024 needs 32 blocks
# a video (past a portable cluster: the FMA passes), at D=128 four; D=520
# puts 8 rows in the second block of a two-block cluster
NETFV_EDGE_CHECKS = ((16, F, 31, {"netfv_fused": LF_KERNEL_MODS["netfv_fused"]}),
                     (16, F, 33, {"netfv_fused": LF_KERNEL_MODS["netfv_fused"]}),
                     (8, F, 31, {"netfv_fused": ((D_RGB, 512), (D_AUD, 512))}),
                     (5, 40, 33, {"netfv_fused": ((520, 20), (8, 10))}))
LF_PLAIN = {"netfv_fused": netfv_reference, "softdbow_fused": softdbow_reference}
# (atol as a share of max|ref|, rtol) of a bf16 NetFV output against the
# plain version at the kernels' rounding points: both round the same f32
# values once, differing in the f32 summation order, which can move an
# output's rounding by one bf16 step (up to 2⁻⁷·|ref|) and, through a logit
# that rounds A the other way, a small value by a few 1e-4 of max|ref|
# (the widest gap on an H100 was 4.88e-4, one step at values in [1/16, 1/8));
# as ATTN_KERNEL_GATE, against TOLERANCE's 1e-2 and 2e-2
NETFV_KERNEL_GATE = (2e-3, 2 ** -7)
SMEM_PER_BLOCK = 232448  # an H100 block's dynamic shared memory at most (227 KB)
# the inference CLI's flags for the LF models (each at its default width)
LF_CLI_FLAGS = ["--frame_features", "--feature_names=rgb,audio", "--feature_sizes=1024,128",
                "--batch_size=32", "--fast_infer", "--device=cuda"]
# the kernel each LF model's inference launches, once per modality per batch
LF_MODEL_KERNEL = {"NetFVModelLF": "netfv_fused", "SoftDbofModelLF": "softdbow_fused",
                   "NetRVLADModelLF": "netvlad_fused", "NeXtVLADModel": None}


def lf_consts(rng: np.random.Generator, dev, kernel: str, d: int, k: int, dtype) -> list:
    """One modality's (C in ``dtype``, scale, bias) and for NetFV (C₂, σ²),
    at the scales of the modules' initialisers: C, C₂ and covar_weights
    normal(1/√D), σ² = covar_weights² + 1e-6."""
    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    out = [t(rng.normal(scale=d ** -0.5, size=(d, k)), dtype), t(rng.uniform(0.5, 1.5, k)),
           t(rng.normal(scale=0.1, size=k))]
    if kernel == "netfv_fused":
        out += [t(rng.normal(scale=d ** -0.5, size=(d, k))),
                t(np.square(rng.normal(scale=d ** -0.5, size=(d, k))) + 1e-6)]
    return out


def lf_rows(rng: np.random.Generator, dev, b: int, f: int, s: int, mods, dtype) -> list:
    """The rgb and audio column slices (strided views, as ops/fast_lf.py
    passes them) of the staged route's rows [b, s, ΣD] in ``dtype``, drawn
    from random uint8 frames with num_frames including 1 and f."""
    dt = sum(d for d, _ in mods)
    x, nf = frames(rng, b, dev, f, dt)
    in_scale = torch.from_numpy(rng.uniform(0.8, 1.2, dt).astype(np.float32)).to(dev)
    in_bias = torch.from_numpy(rng.normal(scale=0.05, size=dt).astype(np.float32)).to(dev)
    rows = staged_frames(gather_frames(x, sample_indices(prng.key(s), nf, f, s)), in_scale, in_bias, dtype)
    return [rows[:, :, :mods[0][0]], rows[:, :, mods[0][0]:]]


def check_lf_kernel(kernel: str, x, consts, errors) -> dict:
    """One kernel against its plain version on one modality's rows.  NetFV's
    plain version takes the kernels' rounding points here (A and X² rounded
    to X's dtype, as on the TPU); its gap to the reference's rounding (A in
    f32) is reported beside it, a bf16 NetFV output must equal a second
    launch's bit for bit and lie within NETFV_KERNEL_GATE, and the tiling
    that the built kernel picks must be ops/netfv_fused.py#netfv_geometry's,
    in shared memory that a block can have."""
    fn = KERNELS[kernel]["fn"]
    got = fn(x, *consts)
    bf16 = x.dtype == torch.bfloat16
    again = fn(x, *consts) if kernel == "netfv_fused" and bf16 else None
    torch.cuda.synchronize()
    label = f"{kernel} B={x.shape[0]} S={x.shape[1]} D={x.shape[2]} K={consts[0].shape[1]} {x.dtype}"
    if kernel == "netfv_fused":
        d, k = consts[0].shape
        built, mirror = netfv_kernel_geometry(d, k), netfv_geometry(d, k)
        if {n: built[n] for n in mirror} != mirror or (mirror["one_pass"] and built["smem"] > SMEM_PER_BLOCK):
            raise AssertionError(f"D={d} K={k}: the NetFV kernel tiles as {built}, ops/netfv_fused.py as {mirror}")
        if again is not None and not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
            raise AssertionError(f"{label}: two launches differ")
        want = netfv_reference(x, *consts, kernel_rounding=True)
        tol = NETFV_KERNEL_GATE if bf16 else None
        err = max(compare(f"{label} fv{i}", g, w, tol=tol) for i, (g, w) in enumerate(zip(got, want), 1))
        ref = netfv_reference(x, *consts)
        out = {"max_abs_err": err, "max_ref": max(w.float().abs().max().item() for w in want),
               "max_abs_gap_to_f32_a": max((g.float() - r.float()).abs().max().item()
                                           for g, r in zip(got, ref)),
               "same_bits": again is not None, "one_pass": mirror["one_pass"]}
        if bf16:
            out["atol_share_needed_at_rtol"] = max(
                ((g.float() - w.float()).abs() - NETFV_KERNEL_GATE[1] * w.float().abs()).max().item()
                / w.float().abs().max().item() for g, w in zip(got, want))
    else:
        want = softdbow_reference(x, *consts)
        out = {"max_abs_err": compare(label, got, want), "max_ref": want.abs().max().item()}
    errors[kernel] = max(errors[kernel], out["max_abs_err"])
    return out


def lf_bound(kernel: str, b: int, s: int, mods):
    """Least time (ms) for the rgb and audio calls of one LF kernel, bf16 X:
    X, C, the folded BN (and NetFV's C₂ and σ²) read once and the outputs
    written once over the HBM rate, or the products (the logits; NetFV also
    XᵀA and (X²)ᵀA) over the bf16 tensor-core rate, whichever is larger."""
    nbytes, flops = 0, 0
    for d, k in mods:
        nbytes += b * s * d * 2 + d * k * 2 + 2 * k * 4
        if kernel == "netfv_fused":
            nbytes += 2 * d * k * 4 + 2 * b * d * k * 2
            flops += 3 * 2 * b * s * d * k
        else:
            nbytes += b * k * 4
            flops += 2 * b * s * d * k
    ops_ms = flops / PEAK_BF16 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", nbytes, flops


def phase_lf_kernels(dev, smi):
    """The NetFV and SoftDBoW kernels against their plain versions
    (check_lf_kernel), X in bf16 and f32, both modalities at full width,
    B=64, S=30, 300 and 1, at one small shape off every tile width and at
    NETFV_EDGE_CHECKS; then the times of the rgb and audio calls at B=512,
    S=30 and S=300, and NetFV's bf16 outputs checked where its persistent
    clusters each walk several videos (check_netfv_walk)."""
    rng = np.random.default_rng(3)
    errors = dict.fromkeys(LF_KERNEL_MODS, 0.0)
    for b, f, s, table in ((64, F, 30, LF_KERNEL_MODS), (64, F, 300, LF_KERNEL_MODS),
                           (64, F, 1, LF_KERNEL_MODS), *LF_SMALL_CHECKS, *NETFV_EDGE_CHECKS):
        for kernel, mods in table.items():
            before = counters()
            checks = []
            for dtype in (torch.bfloat16, torch.float32):
                for label, x, (d, k) in zip(("rgb", "aud"), lf_rows(rng, dev, b, f, s, mods, dtype), mods):
                    consts = lf_consts(rng, dev, kernel, d, k, dtype)
                    checks.append({"modality": label, "dtype": str(dtype), "D": d, "K": k,
                                   **check_lf_kernel(kernel, x, consts, errors)})
            after = counters()
            emit({"phase": "lf_kernels", "kernel": kernel, "B": b, "F": f, "S": s, "checks": checks,
                  "launch_deltas": {n: after[n] - before[n] for n in after}})

    timing = {}
    b = 512
    for s in (30, 300):
        for kernel, mods in LF_KERNEL_MODS.items():
            xs = lf_rows(rng, dev, b, F, s, mods, torch.bfloat16)
            consts = [lf_consts(rng, dev, kernel, d, k, torch.bfloat16) for d, k in mods]
            fn, plain = KERNELS[kernel]["fn"], LF_PLAIN[kernel]
            ms = time_ms(lambda: [fn(x, *c) for x, c in zip(xs, consts)], reps=10 if s == 300 else 20)
            plain_ms = time_ms(lambda: [plain(x, *c) for x, c in zip(xs, consts)], reps=5)
            bound_ms, by, nbytes, flops = lf_bound(kernel, b, s, mods)
            emit({"phase": "kernel_times", "kernel": kernel, "B": b, "S": s, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
                  "flop": flops, **(REDESIGNED.get(kernel, {}) if s == 30 else
                                    {"earlier_ms": EARLIER_S300_MS.get(kernel)}), "card": smi})
            timing.setdefault(s, {})[kernel] = (ms, plain_ms, (bound_ms, by))
            if kernel == "netfv_fused":
                check_netfv_walk(xs, consts, mods, errors)

    # a batch that gives every modality's clusters four videos each (at
    # B=512 the audio module's one-block clusters may get one)
    mods = LF_KERNEL_MODS["netfv_fused"]
    b = 4 * max(netfv_resident_clusters(d, k) for d, k in mods)
    for s in (30, 300):
        xs = lf_rows(rng, dev, b, F, s, mods, torch.bfloat16)
        check_netfv_walk(xs, [lf_consts(rng, dev, "netfv_fused", d, k, torch.bfloat16) for d, k in mods],
                         mods, errors)
        del xs
    return errors, timing[30]


def check_netfv_walk(xs, consts, mods, errors) -> None:
    """NetFV's bf16 rgb and audio outputs (check_lf_kernel) at a batch where
    the kernel's persistent clusters walk videos y, y + n, y + 2n, ... (n
    the clusters the card holds): the ring runs from one video into the
    next and the published partials' two slots are reused from the third
    video on.  Emits the videos a cluster beside each check."""
    b, s = xs[0].shape[:2]
    checks = []
    for label, x, c, (d, k) in zip(("rgb", "aud"), xs, consts, mods):
        n = netfv_resident_clusters(d, k)
        checks.append({"modality": label, "dtype": str(x.dtype), "D": d, "K": k, "clusters": n,
                       "videos_a_cluster": -(-b // min(n, b)), **check_lf_kernel("netfv_fused", x, c, errors)})
    emit({"phase": "lf_kernels", "kernel": "netfv_fused", "B": b, "F": F, "S": s, "walk": True,
          "checks": checks})


def lf_config() -> ModelConfig:
    """The model configuration that the inference CLI builds from LF_CLI_FLAGS."""
    return inference.model_config_from_args(inference.build_parser().parse_args(LF_CLI_FLAGS))


def seeded_tree(name: str, mcfg: ModelConfig, fcfg: FeatureConfig) -> dict:
    """``name``'s weights from init_variables_np(seed=0) with every BN's
    statistics moved off their initial values, so that folding is exercised."""
    tree = init_variables_np(mcfg, fcfg, seed=0, model_name=name)

    def perturb(node):
        if "mean" in node:
            ramp = np.arange(node["mean"].size, dtype=np.float32) / node["mean"].size
            node["mean"] += np.float32(0.05) * ramp
            node["var"] += np.float32(0.5) * ramp
            return
        for child in node.values():
            perturb(child)

    perturb(tree["batch_stats"])
    return tree


def drive_model(dev, name: str, mcfg: ModelConfig, cli_flags, workdir: str, data: str, truth,
                batches, want: dict):
    """One model at its full default width: weights from seeded_tree, the
    inference CLI (``cli_flags``) on ``data`` with the launch counters zeroed
    just before and read just after (they must equal ``want``, the non-zero
    counts), a CSV row per video, then the kernel and plain routes on
    ``batches``, within 1e-2 in probability, the CSV the kernel route's top
    20.  Returns (fast params, launches, timings and the routes' gap)."""
    fcfg = FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), True, F)
    start = time.perf_counter()
    tree = seeded_tree(name, mcfg, fcfg)
    train_dir = os.path.join(workdir, name)
    os.makedirs(train_dir)
    save_variables_npz(tree, train_dir)
    setup_s = time.perf_counter() - start
    out_csv = os.path.join(workdir, f"{name}.csv")
    reset_counters()
    start = time.perf_counter()
    written = inference.main(cli_flags + [
        f"--model={name}", f"--input_data_pattern={data}", f"--train_dir={train_dir}",
        f"--output_file={out_csv}",
    ])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - start
    got = counters()
    want = {**dict.fromkeys(KERNELS, 0), **want}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")
    csv = read_csv(out_csv, written, truth)
    shutil.rmtree(train_dir)

    path = get_fast_path(name)
    fp = path.prepare(convert_flax_variables(tree, mcfg, name), mcfg, device=dev)
    del tree
    probs = {route: run_batches(batches, fp, path.build(mcfg, use_kernels=route == "kernel",
                                                        return_probs=True))
             for route in ("kernel", "plain")}
    for route, p in probs.items():
        if p.shape != (len(truth), mcfg.vocab_size) or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{name} {route}: probabilities of shape {tuple(p.shape)} or non-finite")
    gap = (probs["kernel"] - probs["plain"]).abs().max().item()
    if gap > 1e-2:
        raise AssertionError(f"{name}: kernel and plain routes differ by {gap}")
    check_csv_rows(csv, probs["kernel"], batches, f"{name} kernel")
    return fp, got, {"setup_s": setup_s, "cli_s": cli_s, "max_abs_prob_gap_kernel_vs_plain": gap}


def phase_lf_e2e(dev, workdir, smi):
    """Each fast-LF model through drive_model: the inference CLI on the 96
    videos of phase_e2e (--batch_size=32 --fast_infer --device=cuda), its
    kernel once per modality per batch, then its kernel and plain routes on
    the same batches and sampled indices.  Returns ({model: fast params},
    {kernel: launches in the CLI runs})."""
    mcfg = lf_config()
    data = os.path.join(workdir, "videos-0.tfrecord")
    truth = write_frame_level_fixture(data, 96, seed=0)
    n_batches = -(-len(truth) // 32)
    batches = load_batches(data, dev)
    fps, launches = {}, dict.fromkeys(KERNELS, 0)
    for name in FAST_LF_MODELS:
        kernel = LF_MODEL_KERNEL[name]
        fps[name], got, info = drive_model(dev, name, mcfg, LF_CLI_FLAGS, workdir, data, truth,
                                           batches, {kernel: 2 * n_batches} if kernel else {})
        for n, c in got.items():
            launches[n] += c
        emit({"phase": "lf_e2e", "model": name, "videos": len(truth), "batches": n_batches,
              **info, "launches": got, "card": smi})
    return fps, launches


def phase_lf_throughput(dev, fps, smi):
    """Each fast-LF model's kernel route at B=512, S=30, uint8 in and top-20
    out: videos/s (the median of five rounds) with the plain route beside
    it, then torch.profiler over the kernel route (lf_profile)."""
    mcfg = lf_config()
    b, s = 512, mcfg.iterations
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    x = torch.randint(0, 256, (b, F, DT), generator=gen, device=dev, dtype=torch.uint8)
    nf = torch.randint(1, F + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    key = prng.key(4)
    for name, fp in fps.items():
        path = get_fast_path(name)
        fn, plain = path.build(mcfg, top_k=20), path.build(mcfg, top_k=20, use_kernels=False)
        rounds = [time_ms(lambda: fn(fp, x, nf, key), reps=10) for _ in range(5)]
        plain_ms = time_ms(lambda: plain(fp, x, nf, key), reps=5)
        ms = statistics.median(rounds)
        emit({"phase": "lf_throughput", "model": name, "B": b, "S": s, "videos_per_s": b / (ms / 1e3),
              "videos_per_s_rounds": [b / (r / 1e3) for r in rounds], "batch_ms": ms,
              "plain_batch_ms": plain_ms, "plain_videos_per_s": b / (plain_ms / 1e3), "card": smi})
        emit({"phase": "lf_profile", "model": name, "route": "kernel", "B": b, "S": s,
              **profile_device(lambda: fn(fp, x, nf, key)), "card": smi})


# (B, F, H, hd) of the attention checks: config 5's width, then small shapes
# off every tile width of csrc/masked_attention.cu (64 query rows; 32-key
# tiles in a two-stage ring, so F = 129 and 200 end on a partial tile after
# the ring has turned over; heads padded to 16, 32, 64 or 128 columns in
# bf16, 64 keys and 128 columns in f32)
ATTN_SHAPES = ((64, F, 8, 128), (4, 1, 2, 64), (4, 7, 2, 64), (4, 65, 3, 64), (5, 130, 2, 40),
               (4, 129, 2, 128), (4, 200, 2, 128), (4, 50, 2, 16))
# (atol as a share of max|ref|, rtol) of the bf16 kernel against its plain
# version, both at the TPU kernel's rounding points (the normalised weights
# rounded to bf16 before ·V, the output once): the two differ in the f32
# summation order, in the online sum l, in the exp's last bits and in
# w = e·(1/l) against e / l, which can move a rounding of a weight or of the
# output by one bf16 step; beside it
# the kernel must be within ATTN_BF16_STEPS bf16 steps at max|ref| (the
# scale of ROADMAP §3 item 4's gap of the earlier rounding: 0.0625 at
# max|ref| 9.5) everywhere and equal on ATTN_EQUAL_SHARE of the entries.
# At an entry's own magnitude a cancellation (an output near 0 of terms
# near max|ref|) reads many steps where one weight's rounding moved; that
# count and its share are reported
ATTN_KERNEL_GATE = (2e-3, 2 ** -7)
ATTN_BF16_STEPS = 1.0
ATTN_EQUAL_SHARE = 0.99
ATTN_TIMING = (256, F, 8, 128)  # config 5's batch (BASELINE.md:45), bf16
# the inference CLI's flags for the transformer family (each at its default
# width); 96 videos in batches of 40 leave 24 padding rows in the third
ATTN_CLI_FLAGS = ["--frame_features", "--feature_names=rgb,audio", "--feature_sizes=1024,128",
                  "--batch_size=40", "--fast_infer", "--device=cuda"]


def attn_inputs(rng: np.random.Generator, dev, b: int, f: int, h: int, hd: int, dtype, nf=None):
    """Fused qkv [b, f, 3·h·hd] in ``dtype``, normal(0, 2) so the logits
    spread over a few units and the running max moves, and the [b, f] f32
    frame mask of ``nf`` (default: 0, 1, f − 1, f, then random in 0–f)."""
    qkv = torch.from_numpy(rng.normal(scale=2.0, size=(b, f, 3 * h * hd)).astype(np.float32)).to(dev, dtype)
    if nf is None:
        nf = np.r_[0, 1, f - 1, f, rng.integers(0, f + 1, size=b)][:b]
    mask = torch.from_numpy((np.arange(f)[None, :] < np.asarray(nf)[:, None]).astype(np.float32)).to(dev)
    return qkv, mask


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (f32): 2^(⌊log₂|x|⌋ − 7)."""
    x = x.abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def attn_bound(b: int, f: int, h: int, hd: int):
    """Least time (ms) for one bf16 attention call: qkv and the f32 mask read
    once and the output written once over the HBM rate, or QKᵀ and P·V
    (2·2·B·H·F²·hd) over the bf16 tensor-core rate, whichever is larger."""
    nbytes = b * f * 3 * h * hd * 2 + b * f * 4 + b * f * h * hd * 2
    flops = 2 * 2 * b * h * f * f * hd
    ops_ms = flops / PEAK_BF16 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", nbytes, flops


def sdpa(qkv, mask, h: int):
    """The same attention by torch's scaled_dot_product_attention on q, k, v
    viewed as [B, H, F, hd] and the additive (1 − mask)·(−1e9) mask: the
    library yardstick of library_ms, never called by the port."""
    b, f, dm3 = qkv.shape
    q, k, v = qkv.view(b, f, 3, h, dm3 // (3 * h)).permute(2, 0, 3, 1, 4).unbind(0)
    bias = ((1.0 - mask) * -1e9).to(qkv.dtype)[:, None, None, :]
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    return out.transpose(1, 2).reshape(b, f, dm3 // 3)


def phase_attn_kernels(dev, smi):
    """The attention kernel against its plain version at every ATTN_SHAPES
    shape, qkv in bf16 and f32; then its times at ATTN_TIMING beside the
    plain version's, the bound and SDPA's."""
    rng = np.random.default_rng(5)
    errors = {"masked_attention_fused": 0.0}
    for b, f, h, hd in ATTN_SHAPES:
        before = counters()
        checks = []
        for dtype in (torch.bfloat16, torch.float32):
            qkv, mask = attn_inputs(rng, dev, b, f, h, hd, dtype)
            got = masked_attention_fused(qkv, mask, h)
            torch.cuda.synchronize()
            label = f"masked_attention_fused B={b} F={f} H={h} hd={hd} {dtype}"
            want = masked_attention_plain(qkv, mask, h)
            err = compare(label, got, want)
            check = {"dtype": str(dtype), "max_abs_err": err, "max_ref": want.float().abs().max().item(),
                     "num_frames_zero_rows": int((mask.sum(1) == 0).sum().item())}
            if dtype == torch.bfloat16:  # the same rounding points: the tighter gates
                compare(f"{label} rounding points", got, want, tol=ATTN_KERNEL_GATE)
                d, ref = (got.float() - want.float()).abs(), want.float().abs()
                steps = (d / bf16_step(ref.max())).max().item()
                own = d / bf16_step(torch.maximum(got.float().abs(), ref))
                equal = (d == 0).float().mean().item()
                check = {**check, "max_bf16_steps_at_max_ref": steps, "equal_share": equal,
                         "max_bf16_steps_at_own_magnitude": own.max().item(),
                         "share_over_one_step_at_own_magnitude": (own > 1).float().mean().item(),
                         "atol_share_needed_at_rtol": ((d - ATTN_KERNEL_GATE[1] * ref) / ref.max()).max().item()}
                if steps > ATTN_BF16_STEPS or equal < ATTN_EQUAL_SHARE:
                    raise AssertionError(f"{label}: {steps} bf16 steps at max|ref|, {equal} of the entries equal "
                                         f"(limits {ATTN_BF16_STEPS}, {ATTN_EQUAL_SHARE})")
            errors["masked_attention_fused"] = max(errors["masked_attention_fused"], err)
            checks.append(check)
        after = counters()
        emit({"phase": "attn_kernels", "B": b, "F": f, "H": h, "hd": hd, "checks": checks,
              "launch_deltas": {n: after[n] - before[n] for n in after}})

    b, f, h, hd = ATTN_TIMING
    # as in the CLI's last batch: 24 padding rows with num_frames 0
    qkv, mask = attn_inputs(rng, dev, b, f, h, hd, torch.bfloat16,
                            nf=np.r_[np.zeros(24, int), rng.integers(1, f + 1, size=b - 24)])
    ms = time_ms(lambda: masked_attention_fused(qkv, mask, h))
    plain_ms = time_ms(lambda: masked_attention_plain(qkv, mask, h), reps=5)
    library_ms = time_ms(lambda: sdpa(qkv, mask, h))
    plain = masked_attention_plain(qkv, mask, h).float()
    bound_ms, by, nbytes, flops = attn_bound(b, f, h, hd)
    emit({"phase": "kernel_times", "kernel": "masked_attention_fused", "B": b, "F": f, "H": h, "hd": hd,
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": by,
          "bytes": nbytes, "flop": flops,
          "max_abs_err_kernel_vs_plain": (masked_attention_fused(qkv, mask, h).float() - plain).abs().max().item(),
          "max_abs_err_library_vs_plain": (sdpa(qkv, mask, h).float() - plain).abs().max().item(),
          "num_frames_zero_rows": 24, **REDESIGNED["masked_attention_fused"], "card": smi})
    return errors, {"masked_attention_fused": (ms, plain_ms, (bound_ms, by))}, library_ms


def attn_config() -> ModelConfig:
    """The model configuration that the inference CLI builds from ATTN_CLI_FLAGS."""
    return inference.model_config_from_args(inference.build_parser().parse_args(ATTN_CLI_FLAGS))


def phase_attn_e2e(dev, workdir, smi):
    """TransformerEncoderModel and AttentionNetVLADModel through drive_model:
    the inference CLI on the 96 videos of phase_e2e in batches of 40 (24
    padding rows with num_frames 0 in the third), the attention kernel once
    per layer per batch and netvlad_fused once per batch of
    AttentionNetVLADModel, then the kernel and plain routes on the same
    batches.  Returns ({model: fast params}, {kernel: launches in the CLI
    runs})."""
    mcfg = attn_config()
    batch_size = int(next(a for a in ATTN_CLI_FLAGS if a.startswith("--batch_size=")).split("=")[1])
    data = os.path.join(workdir, "videos-0.tfrecord")
    truth = write_frame_level_fixture(data, 96, seed=0)
    n_batches = -(-len(truth) // batch_size)
    batches = load_batches(data, dev, batch_size)
    padding = int(sum((~real).sum().item() for _, _, real, _ in batches))
    fps, launches = {}, dict.fromkeys(KERNELS, 0)
    for name in FAST_ATTENTION_MODELS:
        want = {"masked_attention_fused": mcfg.transformer_layers * n_batches}
        if name == "AttentionNetVLADModel":
            want["netvlad_fused"] = n_batches
        fps[name], got, info = drive_model(dev, name, mcfg, ATTN_CLI_FLAGS, workdir, data, truth, batches,
                                           want)
        for n, c in got.items():
            launches[n] += c
        emit({"phase": "attn_e2e", "model": name, "videos": len(truth), "batches": n_batches,
              "padding_rows": padding, **info, "launches": got, "card": smi})
    return fps, launches


def phase_attn_throughput(dev, fps, smi):
    """Each transformer-family model's kernel route at B=256, all 300 frames,
    num_frames random in 1–300, uint8 in and top-20 out: videos/s (the
    median of five rounds), the plain route and both routes' peak memory
    beside it; then torch.profiler over five kernel-route batches
    (attn_profile)."""
    mcfg = attn_config()
    b = ATTN_TIMING[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    x = torch.randint(0, 256, (b, F, DT), generator=gen, device=dev, dtype=torch.uint8)
    nf = torch.randint(1, F + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    for name, fp in fps.items():
        path = get_fast_path(name)
        fn, plain = path.build(mcfg, top_k=20), path.build(mcfg, top_k=20, use_kernels=False)
        peak = {}
        torch.cuda.reset_peak_memory_stats()
        rounds = [time_ms(lambda: fn(fp, x, nf, None), reps=5) for _ in range(5)]
        peak["kernel"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        plain_ms = time_ms(lambda: plain(fp, x, nf, None), reps=5)
        peak["plain"] = torch.cuda.max_memory_allocated() / 2**30
        ms = statistics.median(rounds)
        emit({"phase": "attn_throughput", "model": name, "B": b, "F": F, "videos_per_s": b / (ms / 1e3),
              "videos_per_s_rounds": [b / (r / 1e3) for r in rounds], "batch_ms": ms,
              "plain_batch_ms": plain_ms, "plain_videos_per_s": b / (plain_ms / 1e3),
              "peak_mem_gib": peak, "card": smi})
        emit({"phase": "attn_profile", "model": name, "route": "kernel", "B": b, "F": F,
              **profile_device(lambda: fn(fp, x, nf, None)), "card": smi})


# the learnable set of the JAX package's full-shape GAP drill
# (tests/integration/gap_drill_common.py:141-150): 200 videos of up to 300
# frames, rgb 1024 + audio 128, V=3862, a few labels a video
EVAL_FIXTURE = dict(num_videos=200, num_classes=3862, rgb_size=D_RGB, audio_size=D_AUD, max_frames=F,
                    seed=7, label_threshold=100.0, min_labels=3)
# training for the eval drill: B=64, lr 0.001 (the drill's), until the
# train GAP, read every EVAL_GAP_EVERY steps, reaches the drill's gap_target
# or EVAL_MAX_STEPS
EVAL_BATCH, EVAL_LR, EVAL_MAX_STEPS, EVAL_GAP_TARGET, EVAL_GAP_EVERY = 64, 0.001, 1000, 0.5, 50
# the north star's end-to-end budget, |ΔGAP@20| between the bf16 kernel
# route and the f32 plain route; below EVAL_GAP_FLOOR the gate would
# compare noise
GAP_BUDGET, EVAL_GAP_FLOOR = 1e-3, 0.3
# the JAX drill's bf16 |ΔGAP| on the TPU (BASELINE.md:201-204), printed as
# context beside the port's: not a target
EVAL_TPU_DELTA = {"NetVLADModelLF": 6.5e-4, "NetRVLADModelLF": 1.1e-6, "DbofModel": 1.7e-4,
                  "NetFVModelLF": 8.9e-4}
# the JAX package's own bound between --fast_eval and the default
# accumulator (tests/integration/test_eval_api.py:91-106)
FAST_EVAL_BOUND = 1e-5
EVAL_CLI_FLAGS = ["--frame_features", "--feature_names=rgb,audio", "--feature_sizes=1024,128",
                  f"--batch_size={EVAL_BATCH}", "--device=cuda"]
EVAL_METRICS = ("gap", "avg_hit_at_one", "avg_perr", "avg_loss")


def eval_config(**overrides) -> ModelConfig:
    """The model configuration that the CLIs build from EVAL_CLI_FLAGS
    (every model width at its default), with ``overrides``."""
    args = inference.build_parser().parse_args(EVAL_CLI_FLAGS)
    return dataclasses.replace(inference.model_config_from_args(args), **overrides)


def route_metrics(batches, probs_fn) -> dict:
    """The default accumulator's metrics of a route over ``batches``:
    ``probs_fn(features, num_frames, key)`` → probabilities, each batch drawn
    from the CLIs' per-batch key fold_in(key(0), batch)."""
    em = eval_util.EvaluationMetrics(3862, 20)
    loss_obj = CrossEntropyLoss()
    for batch_idx, (feats, nf, real, _, labels) in enumerate(batches):
        probs = probs_fn(feats, nf, prng.fold_in(prng.key(0), batch_idx))[real].float()
        loss = loss_obj.calculate_per_example_loss(probs, torch.from_numpy(labels).to(probs.device)).mean()
        em.accumulate(probs.cpu().numpy(), labels, float(loss))
    info = em.get()
    return {k: float(info[k]) for k in EVAL_METRICS}


def train_eval_model(dev, data: str, workdir: str, smi, name: str = "NetVLADModelLF", overrides=None) -> tuple:
    """``name`` at full width (eval_config with ``overrides``; NetVLADModelLF
    bf16 with --fused_train_aggregation), trained in-process by the port's
    TrainStep in bf16 on device-resident batches of EVAL_BATCH videos of the
    set in ``data`` drawn with replacement, as the JAX drill's trainer
    (tools/drill_train_fullshape_tpu.py) draws them; every EVAL_GAP_EVERY
    steps the train GAP, that of the inference-mode forward (running BN
    statistics) over the whole set, until it reaches EVAL_GAP_TARGET or
    EVAL_MAX_STEPS; then its variables.npz.  With --fused_train_aggregation
    each training kernel launches once per pooling module a step, the
    forward also once per module in each batch of the GAP reads.  Returns
    (train_dir, info, launches, the tree that variables.npz holds)."""
    overrides = {"fused_train_aggregation": True} if overrides is None else overrides
    mcfg = eval_config(compute_dtype="bfloat16", presampled=True, **overrides)
    fcfg = FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), True, F)
    tcfg = TrainingConfig(batch_size=EVAL_BATCH, base_learning_rate=EVAL_LR)
    model = create_model(name, mcfg, DT)
    load_flax_variables(model, init_variables_np(mcfg, fcfg, seed=0, model_name=name)).to(dev)
    state = TrainState.create(model, tcfg)
    step = TrainStep(CrossEntropyLoss(), tcfg, mcfg, True)
    forward = step_lib.inference_forward(model, mcfg, True)
    records = list(YT8MFrameFeatureReader(feature_names=("rgb", "audio")).read_file(data))
    feats = torch.from_numpy(np.stack([r["features"] for r in records])).to(dev)
    nf = torch.from_numpy(np.array([r["num_frames"] for r in records], np.int32)).to(dev)
    labels_np = np.stack([r["labels"] for r in records])
    labels = torch.from_numpy(labels_np).to(dev)
    rng, key = np.random.default_rng(0), prng.key(0)
    gap_batches = [torch.arange(i, min(i + EVAL_BATCH, len(records)), device=dev)
                   for i in range(0, len(records), EVAL_BATCH)]

    def train_gap() -> float:
        probs = torch.cat([forward(feats[idx], nf[idx], prng.fold_in(prng.key(0), i)).float()
                           for i, idx in enumerate(gap_batches)])
        return float(eval_util.calculate_gap(probs.cpu().numpy(), labels_np))

    gaps = []
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    start = time.perf_counter()
    while state.step < EVAL_MAX_STEPS:
        for _ in range(EVAL_GAP_EVERY):
            idx = torch.from_numpy(rng.integers(0, len(records), EVAL_BATCH)).to(dev)
            step(state, {"features": feats[idx], "num_frames": nf[idx], "labels": labels[idx]}, key)
        gaps.append((state.step, train_gap()))
        if gaps[-1][1] >= EVAL_GAP_TARGET:
            break
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = counters()
    mods = len(lf_layout(name, mcfg, DT)) if mcfg.fused_train_aggregation else 0
    want = {**dict.fromkeys(KERNELS, 0), "netvlad_aggregate_backward": mods * state.step,
            "netvlad_aggregate_forward": mods * (state.step + len(gap_batches) * len(gaps)),
            "dropout": dropout_launches_per_step(name, mcfg) * state.step}
    if launches != want:
        raise AssertionError(f"eval_e2e training of {name}: launches {launches}, expected {want}")
    train_dir = os.path.join(workdir, name)
    os.makedirs(train_dir)
    tree = state_dict_to_flax(state.model)
    save_variables_npz(tree, train_dir)
    info = {"model": name, "steps": state.step, "train_gap": gaps[-1][1], "train_gap_at_step": gaps,
            "seconds": seconds, "ms_per_step": seconds / state.step * 1e3,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "route": "bf16 fused" if mcfg.fused_train_aggregation else "bf16", "B": EVAL_BATCH,
            "lr": EVAL_LR, "card": smi}
    del state, model, feats
    torch.cuda.empty_cache()
    return train_dir, info, launches, tree


def eval_cli_routes(name: str, data: str, train_dir: str, routes) -> tuple:
    """The eval CLI (--run_once) on each of ``routes`` (name → flags), each
    with the default accumulator and with --fast_eval, the launch counters
    zeroed before each run and read after; raises unless --fast_eval agrees
    with the default accumulator within FAST_EVAL_BOUND on every metric.
    Returns ({run: metrics}, {run: launches})."""
    infos, paths = {}, {}
    for route, flags in routes.items():
        for acc in ("default", "fast_eval"):
            run = f"{route}/{acc}"
            reset_counters()
            info = eval_cli.main(EVAL_CLI_FLAGS + flags + (["--fast_eval"] if acc == "fast_eval" else []) + [
                f"--model={name}", f"--eval_data_pattern={data}", f"--train_dir={train_dir}", "--run_once"])
            torch.cuda.synchronize()
            paths[run] = counters()
            infos[run] = {k: float(info[k]) for k in EVAL_METRICS}
        gaps = {k: abs(infos[f"{route}/fast_eval"][k] - infos[f"{route}/default"][k]) for k in EVAL_METRICS}
        if max(gaps.values()) > FAST_EVAL_BOUND:
            raise AssertionError(f"{name} {route}: --fast_eval and the default accumulator differ by {gaps}")
    return infos, paths


def phase_eval_e2e(dev, workdir, smi):
    """The eval CLI and the model-forward inference route end to end at full
    Willow width, on the full-shape GAP drill's learnable set (EVAL_FIXTURE):

    1. NetVLADModelLF trained by train_eval_model;
    2. the eval CLI on the model-forward route (f32) and on --fast_forward
       (bf16, the front-end kernel), each with the default accumulator and
       --fast_eval (within FAST_EVAL_BOUND); the f32 plain fast route's
       metrics in-process on the frames --fast_forward draws.  Gates:
       |ΔGAP| of --fast_forward against the f32 plain route <= GAP_BUDGET on
       a model whose f32 GAP is >= EVAL_GAP_FLOOR.  The model-forward
       route's GAP is printed, not gated: it draws other frames;
    3. the inference CLI without --fast_infer, --fused_train_aggregation
       (the training forward kernel, twice a batch): its CSV is the
       module's top 20, and the module's probabilities equal the plain
       aggregation's within TOLERANCE's f32 gate;
    4. DbofModel at full width (weights from a seed): eval --fast_forward
       and inference --fast_infer, no custom kernel, against the f32 plain
       DBoF fast route within 1e-2 in probability.
    Returns {kernel: launches in the phase's runs}."""
    data = os.path.join(workdir, "learnable-0.tfrecord")
    start = time.perf_counter()
    make_learnable_synthetic_frame_level(data, **EVAL_FIXTURE)
    setup_s = time.perf_counter() - start
    batches = load_labeled_batches(data, dev, EVAL_BATCH)
    n_batches = len(batches)
    none = dict.fromkeys(KERNELS, 0)
    launches = dict(none)

    train_dir, train_info, got, tree = train_eval_model(dev, data, workdir, smi)
    for n, c in got.items():
        launches[n] += c
    emit({"phase": "eval_e2e", "part": "train", "videos": EVAL_FIXTURE["num_videos"], "setup_s": setup_s,
          **train_info})

    infos, paths = eval_cli_routes("NetVLADModelLF", data, train_dir,
                                   {"model_forward_f32": [], "fast_forward_bf16": ["--fast_forward"]})
    want = {run: {**none, "netvlad_frontend": n_batches} if run.startswith("fast_forward") else none
            for run in paths}
    if paths != want:
        raise AssertionError(f"eval launches {paths}, expected {want}")
    mcfg = eval_config()
    fp32 = prepare_fast_params(convert_flax_variables(tree, mcfg), mcfg, compute_dtype=torch.float32,
                               device=dev)
    plain32 = build_fast_netvlad_inference(mcfg, use_kernels=False, compute_dtype=torch.float32,
                                           return_probs=True)
    infos["fast_plain_f32"] = route_metrics(batches, lambda x, n, k: plain32(fp32, x, n, k))
    del fp32
    gap_f32 = infos["fast_plain_f32"]["gap"]
    delta = abs(infos["fast_forward_bf16/default"]["gap"] - gap_f32)
    if gap_f32 < EVAL_GAP_FLOOR:
        raise AssertionError(f"the trained model's f32 GAP {gap_f32} is below {EVAL_GAP_FLOOR}: "
                             "the |ΔGAP| gate would compare noise")
    if delta > GAP_BUDGET:
        raise AssertionError(f"|ΔGAP| of --fast_forward bf16 against the f32 plain route {delta} > {GAP_BUDGET}")
    for n in launches:
        launches[n] += sum(p[n] for p in paths.values())
    emit({"phase": "eval_e2e", "part": "eval", "model": "NetVLADModelLF", "batches": n_batches,
          "metrics": infos, "abs_gap_delta_bf16_vs_f32": delta, "budget": GAP_BUDGET,
          "tpu_bf16_delta_for_context": EVAL_TPU_DELTA["NetVLADModelLF"], "launches_per_run": paths,
          "card": smi})
    for n, c in int8_eval("NetVLADModelLF", data, train_dir, [], infos["fast_forward_bf16/default"]["gap"],
                          n_batches, "netvlad_frontend", 2, smi).items():
        launches[n] += c

    # the model-forward inference CLI with the training forward kernel
    out_csv = os.path.join(workdir, "model_forward.csv")
    reset_counters()
    start = time.perf_counter()
    written = inference.main(EVAL_CLI_FLAGS + [
        "--model=NetVLADModelLF", "--fused_train_aggregation", f"--input_data_pattern={data}",
        f"--train_dir={train_dir}", f"--output_file={out_csv}"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - start
    got = counters()
    if got != {**none, "netvlad_aggregate_forward": 2 * n_batches}:
        raise AssertionError(f"model-forward inference launches {got}")
    for n, c in got.items():
        launches[n] += c
    probs = {}
    for route, fused in (("kernel", True), ("plain", False)):
        cfg = eval_config(fused_train_aggregation=fused, presampled=True)
        model = load_flax_variables(create_model("NetVLADModelLF", cfg, DT), tree).to(dev).eval()
        fwd = step_lib.inference_forward(model, cfg, True)
        probs[route] = torch.cat([fwd(x, n, prng.fold_in(prng.key(0), i))[real].float()
                                  for i, (x, n, real, *_) in enumerate(batches)])
        del model
    err = compare("model-forward NetVLADModelLF, fused vs plain aggregation", probs["kernel"], probs["plain"],
                  torch.float32)
    csv = read_csv(out_csv, written, [{"video_id": v} for *_, vids, _ in batches for v in vids])
    check_csv_rows(csv, probs["kernel"], [b[:4] for b in batches], "model-forward kernel")
    emit({"phase": "eval_e2e", "part": "inference_model_forward", "model": "NetVLADModelLF",
          "route": "f32 --fused_train_aggregation", "csv_rows": written, "cli_s": cli_s,
          "max_abs_prob_err_kernel_vs_plain": err, "launches": got, "card": smi})
    del tree

    # DbofModel: eval --fast_forward and inference --fast_infer
    fcfg = FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), True, F)
    dbof_dir = os.path.join(workdir, "DbofModel")
    os.makedirs(dbof_dir)
    tree = seeded_tree("DbofModel", mcfg, fcfg)
    save_variables_npz(tree, dbof_dir)
    reset_counters()
    info = eval_cli.main(EVAL_CLI_FLAGS + ["--model=DbofModel", "--fast_forward", "--run_once",
                                           f"--eval_data_pattern={data}", f"--train_dir={dbof_dir}"])
    dbof_csv = os.path.join(workdir, "dbof.csv")
    written = inference.main(EVAL_CLI_FLAGS + ["--model=DbofModel", "--fast_infer",
                                               f"--input_data_pattern={data}", f"--train_dir={dbof_dir}",
                                               f"--output_file={dbof_csv}"])
    torch.cuda.synchronize()
    if counters() != none:
        raise AssertionError(f"DbofModel launches {counters()}, expected none")
    path = get_fast_path("DbofModel")
    variables = convert_flax_variables(tree, mcfg, "DbofModel")
    fp = {"bf16": path.prepare(variables, mcfg, device=dev),
          "f32": fast_dbof.prepare_fast_dbof_params(variables, mcfg, compute_dtype=torch.float32, device=dev)}
    fns = {"bf16": path.build(mcfg, return_probs=True),
           "f32": fast_dbof.build_fast_dbof_inference(mcfg, compute_dtype=torch.float32, return_probs=True)}
    dbof_probs = {r: run_batches([b[:4] for b in batches], fp[r], fns[r]) for r in fp}
    gap = (dbof_probs["bf16"] - dbof_probs["f32"]).abs().max().item()
    csv = read_csv(dbof_csv, written, [{"video_id": v} for *_, vids, _ in batches for v in vids])
    vids = [v.decode() for *_, vs, _ in batches for v in vs]
    csv_err = max(float(np.abs(csv[v][1] - dbof_probs["f32"][i, csv[v][0]].cpu().numpy()).max())
                  for i, v in enumerate(vids))
    if gap > 1e-2 or csv_err > 1e-2:
        raise AssertionError(f"DbofModel: bf16 route {gap}, CSV {csv_err} from the f32 plain route")
    f32_metrics = route_metrics(batches, lambda x, n, k: fns["f32"](fp["f32"], x, n, k))
    emit({"phase": "eval_e2e", "part": "dbof", "model": "DbofModel",
          "eval_fast_forward": {k: float(info[k]) for k in EVAL_METRICS}, "fast_plain_f32": f32_metrics,
          "max_abs_prob_gap_bf16_vs_f32": gap, "csv_max_abs_err_vs_f32": csv_err, "csv_rows": written,
          "card": smi})
    del tree, variables, fp
    shutil.rmtree(dbof_dir)

    for name, (overrides, flags, kernel, per_batch) in EVAL_ARMS.items():
        for n, c in eval_arm(dev, data, workdir, smi, batches, name, overrides, flags, kernel, per_batch).items():
            launches[n] += c
    return launches


# the JAX drill's other trained arms (tests/integration/gap_drill_common.py:77-104)
# at their widths, and config 5's transformer (the drill has no transformer
# arm): model → (ModelConfig overrides, CLI flags, the kernel of its
# --fast_forward route, its launches a batch: one per modality, or one per
# encoder layer)
EVAL_ARMS = {
    "NetRVLADModelLF": ({"fused_train_aggregation": True}, [], "netvlad_fused", 2),
    "DbofModel": ({}, [], None, 0),
    "NetFVModelLF": ({"fv_cluster_size": 256}, ["--fv_cluster_size=256"], "netfv_fused", 2),
    "TransformerEncoderModel": ({}, [], "masked_attention_fused", 2),
}


# the arms whose eval also runs --int8_hidden: model → W8A16 launches a batch
# (NetRVLAD one slice per modality, NetFV two: fv1 and fv2)
INT8_ARMS = {"NetRVLADModelLF": 2, "NetFVModelLF": 4}


def f32_plain_route(name: str, tree, mcfg: ModelConfig, dev):
    """(fast params, fn) of ``name``'s f32 fast route without kernels."""
    variables = convert_flax_variables(tree, mcfg, name)
    f32 = torch.float32
    if name == "TransformerEncoderModel":
        return (fast_transformer.prepare_fast_transformer_params(variables, mcfg, compute_dtype=f32, device=dev),
                fast_transformer.build_fast_transformer_inference(mcfg, use_kernels=False, compute_dtype=f32,
                                                                  return_probs=True))
    if name == "DbofModel":
        return (fast_dbof.prepare_fast_dbof_params(variables, mcfg, compute_dtype=f32, device=dev),
                fast_dbof.build_fast_dbof_inference(mcfg, compute_dtype=f32, return_probs=True))
    return (fast_lf.prepare_fast_lf_params(variables, mcfg, name, compute_dtype=f32, device=dev),
            fast_lf.build_fast_lf_inference(mcfg, name, use_kernels=False, compute_dtype=f32, return_probs=True))


def eval_arm(dev, data: str, workdir: str, smi, batches, name: str, overrides, flags, kernel,
             per_batch: int) -> dict:
    """One more trained arm of phase_eval_e2e: ``name`` trained by
    train_eval_model, then the eval CLI with --fast_forward (bf16;
    ``kernel`` ``per_batch`` times a batch), with the default
    accumulator and --fast_eval, against the f32 plain fast route in-process
    on the same frames: GAP >= EVAL_GAP_FLOOR and |ΔGAP| <= GAP_BUDGET.
    Returns {kernel: launches}."""
    train_dir, info, launches, tree = train_eval_model(dev, data, workdir, smi, name, overrides)
    emit({"phase": "eval_e2e", "part": "train", **info})
    mcfg = eval_config(**{k: v for k, v in overrides.items() if k != "fused_train_aggregation"})
    infos, paths = eval_cli_routes(name, data, train_dir, {"fast_forward_bf16": ["--fast_forward", *flags]})
    none = dict.fromkeys(KERNELS, 0)
    want = {run: {**none, **({kernel: per_batch * len(batches)} if kernel else {})} for run in paths}
    if paths != want:
        raise AssertionError(f"{name} eval launches {paths}, expected {want}")
    if name in INT8_ARMS:
        for n, c in int8_eval(name, data, train_dir, flags, infos["fast_forward_bf16/default"]["gap"],
                              len(batches), kernel, INT8_ARMS[name], smi).items():
            launches[n] += c
    fp, fn = f32_plain_route(name, tree, mcfg, dev)
    infos["fast_plain_f32"] = route_metrics(batches, lambda x, n, k: fn(fp, x, n, k))
    del fp, tree
    shutil.rmtree(train_dir)
    torch.cuda.empty_cache()
    gap_f32 = infos["fast_plain_f32"]["gap"]
    delta = abs(infos["fast_forward_bf16/default"]["gap"] - gap_f32)
    if gap_f32 < EVAL_GAP_FLOOR:
        raise AssertionError(f"{name}: the trained model's f32 GAP {gap_f32} is below {EVAL_GAP_FLOOR}")
    if delta > GAP_BUDGET:
        raise AssertionError(f"{name}: |ΔGAP| of --fast_forward bf16 against the f32 plain route {delta} "
                             f"> {GAP_BUDGET}")
    for run in paths.values():
        for n, c in run.items():
            launches[n] += c
    emit({"phase": "eval_e2e", "part": "eval", "model": name, "batches": len(batches), "metrics": infos,
          "abs_gap_delta_bf16_vs_f32": delta, "budget": GAP_BUDGET,
          "tpu_bf16_delta_for_context": EVAL_TPU_DELTA.get(name), "launches_per_run": paths, "card": smi})
    return launches



# ---- item 12b: FusedAdam and the W8A16 hidden FC ---------------------------

# SR-ν over FUSED_ADAM_EMA_STEPS constant-gradient steps within this share
# of the exact f32 EMA (the JAX package's test_sr_nu_tracks_ema_where_
# deterministic_bf16_stalls)
FUSED_ADAM_EMA_STEPS, FUSED_ADAM_EMA_GATE = 300, 0.01


def willow_leaves(dev, dtype=torch.bfloat16, seed: int = 5):
    """Every parameter of full-width Willow NetVLADModelLF (306.6M) as a
    random (g, p, m, ν) leaf on the card at the scales of training: p at
    its initialiser's scale, g ~ 1e-3·N(0, 1) (so the per-leaf clip engages
    on the large leaves), m ~ 1e-4·N(0, 1), ν ~ (1e-4·N(0, 1))²;
    ``cluster_weights2``'s gradient in f32, as the fused aggregation
    returns it."""
    with torch.device("meta"):
        shapes = [(n, tuple(p.shape)) for n, p in
                  create_model("NetVLADModelLF", ModelConfig(), DT).named_parameters()]
    gen = torch.Generator(device=dev).manual_seed(seed)
    leaves = []
    for name, shape in shapes:
        fan = shape[0] if len(shape) > 1 else 1

        def rnd(scale, dt=dtype):
            return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

        g_dt = torch.float32 if name.endswith("cluster_weights2") else dtype
        leaves.append((name, [rnd(1e-3, g_dt), rnd(fan ** -0.5), rnd(1e-4), rnd(1e-4).square()]))
    return leaves


def adam_edge_leaves(dev):
    """Small leaves at the kernel's edges: 1, 7, 1,023 elements, one off the
    vector width (8,193 elements at an odd offset, so the scalar path runs),
    an f32 leaf, and a bf16 leaf whose p and ν hold ±inf, NaN, bf16 max and
    the f32 values just below and above it."""
    gen = torch.Generator(device=dev).manual_seed(6)
    out = []
    for n in (1, 7, 1023, 8193):
        base = torch.randn(n + 1, generator=gen, device=dev)
        leaf = [(base[1:] if n == 8193 else base[:n]) * s for s in (1e-2, 0.05, 1e-3, 1e-3)]
        leaf[3] = leaf[3].square()
        out.append((f"n{n}", [t.to(torch.bfloat16) for t in leaf]))
        if n == 8193:  # a view one element in: its pointer is off the 16-byte grid
            storage = [torch.empty(n + 1, dtype=torch.bfloat16, device=dev) for _ in range(4)]
            for s, t in zip(storage, out[-1][1]):
                s[1:] = t
            out[-1] = (f"n{n}-unaligned", [s[1:] for s in storage])
    out.append(("f32", [torch.randn(4099, generator=gen, device=dev) * s for s in (1e-2, 0.05, 1e-3, 1e-6)]))
    special = torch.tensor([float("inf"), float("-inf"), float("nan"), 3.3895313892515355e38,
                            -3.3895313892515355e38, 3.4e38, 3.3895e38, 1.0], device=dev)
    edge = [torch.full((8,), 1e-3, device=dev), special, torch.full((8,), 1e-3, device=dev), special.abs()]
    out.append(("nonfinite", [t.to(torch.bfloat16) for t in edge]))
    return out


def bf16_neighbour(got: torch.Tensor, f32: torch.Tensor) -> torch.Tensor:
    """Whether each bf16 entry of ``got`` is one of the two bf16 values
    around ``f32`` (or equals its cast, where the guard takes over)."""
    u = f32.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lo = (u & 0xFFFF0000) >> 16
    g = got.view(torch.int16).to(torch.int64) & 0xFFFF
    return (g == lo) | (g == ((lo + 1) & 0xFFFF)) | (got.float() == f32.float().to(torch.bfloat16).float()) \
        | (torch.isnan(got.float()) & torch.isnan(f32.float()))


def run_fused_adam(route, leaves, consts, clip, count=3):
    """A copy of ``leaves`` ((name, [g, p, m, ν]) pairs) after one step of
    ``route`` (fused_adam_kernel or fused_adam_plain)."""
    copies = [[t.clone() for t in leaf] for _, leaf in leaves]
    route([c[0] for c in copies], [c[1] for c in copies], [c[2] for c in copies], [c[3] for c in copies],
          consts, clip, True, 0, count)
    return copies


def check_fused_adam(name: str, leaves, clip, errors) -> dict:
    """The kernel against its plain version on ``leaves`` from the same
    bits: m equal bit for bit; p and ν on a bf16 neighbour of the plain
    version's f32 value (p32, v32 formed op by op), with the share that
    differs from the plain version's pick; a second launch equal bit for bit
    to the first."""
    consts = AdamConsts(1e-3, 3)
    got = run_fused_adam(fused_adam_kernel, leaves, consts, clip)
    again = run_fused_adam(fused_adam_kernel, leaves, consts, clip)
    want = run_fused_adam(fused_adam_plain, leaves, consts, clip)
    torch.cuda.synchronize()
    differ = total = 0
    for (leaf_name, (g, p, m, v)), gk, gk2, wp in zip(leaves, got, again, want):
        for a, b in zip(gk, gk2):
            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                raise AssertionError(f"fused_adam {name}/{leaf_name}: a second launch differs")
        if not torch.equal(gk[2].view(torch.uint8), wp[2].view(torch.uint8)):
            raise AssertionError(f"fused_adam {name}/{leaf_name}: m differs from the plain version")
        g32 = g.float()
        if clip is not None:
            g32 = g32 * clip_scale(leaf_sumsq(g32), clip)
        p32, _, v32 = adam_leaf_f32(g32, p, m, v, consts.tensors(p.device))
        for slot, ref in ((1, p32), (3, v32)):
            if p.dtype == torch.float32:
                same = (gk[slot] == ref) | (torch.isnan(gk[slot]) & torch.isnan(ref))
                if not bool(same.all()):
                    raise AssertionError(f"fused_adam {name}/{leaf_name}: f32 slot {slot} differs")
                continue
            if not bool(bf16_neighbour(gk[slot], ref).all()):
                raise AssertionError(f"fused_adam {name}/{leaf_name}: slot {slot} off the bf16 neighbours")
            differ += int((gk[slot].view(torch.int16) != wp[slot].view(torch.int16)).sum())
            total += gk[slot].numel()
        errors["fused_adam"] = max(errors.get("fused_adam", 0.0),
                                   (gk[1].float() - wp[1].float()).abs().nan_to_num(0.0).max().item())
    return {"share_p_nu_differ_from_plain": differ / max(total, 1), "entries": total}


def sr_nu_ema(dev) -> dict:
    """FUSED_ADAM_EMA_STEPS kernel steps at a constant gradient of 0.01 on a
    [1024, 128] bf16 leaf at lr 0: the mean SR ν against the exact EMA
    (1 − b2^n)·g², and deterministic ν (stochastic=False) beside it."""
    g32 = float(torch.tensor(0.01, dtype=torch.bfloat16))
    expect = (1 - 0.999 ** FUSED_ADAM_EMA_STEPS) * g32 * g32
    out = {}
    for stochastic in (True, False):
        g = torch.full((1024, 128), 0.01, dtype=torch.bfloat16, device=dev)
        p, m, v = (torch.zeros_like(g) for _ in range(3))
        for count in range(FUSED_ADAM_EMA_STEPS):
            fused_adam_kernel([g], [p], [m], [v], AdamConsts(0.0, count), None, stochastic, 0, count)
        out["sr" if stochastic else "deterministic"] = abs(v.double().mean().item() - expect) / expect
    return out


def phase_fused_adam(dev, smi) -> tuple:
    """FusedAdam (``csrc/fused_adam.cu``) against its plain version: on the
    whole Willow tree (bf16, clip 1), on the edge leaves with and without the
    clip, SR-ν's 300-step EMA; its time beside the bound (16 B a bf16
    parameter), the plain version, the port's eager Adam on the f32 tree
    (the default optimizer, with its clip) and torch.optim.Adam(fused=True)
    on the same bf16 tensors (a different function: no per-leaf clip, no
    stochastic rounding; context only)."""
    errors = {}
    leaves = willow_leaves(dev)
    n_params = sum(leaf[1].numel() for _, leaf in leaves)
    willow = check_fused_adam("willow", leaves, 1.0, errors)
    edges = {clip: check_fused_adam(f"edges clip={clip}", adam_edge_leaves(dev), clip, errors)
             for clip in (1.0, None)}
    ema = sr_nu_ema(dev)
    emit({"phase": "fused_adam", "parameters": n_params, "willow": willow,
          "edges": {str(k): v for k, v in edges.items()}, "sr_nu_ema_rel_err": ema,
          "ema_gate": FUSED_ADAM_EMA_GATE, "max_abs_err_p": errors["fused_adam"], "card": smi})
    if ema["sr"] > FUSED_ADAM_EMA_GATE:
        raise AssertionError(f"fused_adam: SR ν {ema['sr']:.4f} off the EMA (gate {FUSED_ADAM_EMA_GATE})")
    names = [name for name, _ in leaves]
    g, p, m, v = ([leaf[i] for _, leaf in leaves] for i in range(4))
    del leaves
    consts = AdamConsts(1e-3, 3)
    ms = time_ms(lambda: fused_adam_kernel(g, p, m, v, consts, 1.0, True, 0, 3), reps=10)
    plain_ms = time_ms(lambda: fused_adam_plain(g, p, m, v, consts, 1.0, True, 0, 3), reps=2, warmup=1)
    bound = (fused_adam_hbm_bytes(p, g) / PEAK_BYTES * 1e3, "bytes")
    lib = torch.optim.Adam(p, lr=1e-3, fused=True)
    for t, gt in zip(p, g):
        t.grad = gt.to(t.dtype)
    library_ms = time_ms(lib.step, reps=10)
    for t in p:
        t.grad = None
    del lib, g, m, v
    torch.cuda.empty_cache()
    f32 = [(name, t.float()) for name, t in zip(names, p)]
    del p
    eager = optimizers.create_optimizer(f32, TrainingConfig())
    grads = [torch.randn_like(t) * 1e-3 for _, t in f32]
    eager_ms = time_ms(lambda: eager.step(grads), reps=5, warmup=1)
    del eager, grads, f32
    torch.cuda.empty_cache()
    emit({"phase": "fused_adam_time", "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
          "eager_f32_adam_ms": eager_ms, "torch_fused_adam_bf16_ms_different_function": library_ms,
          "parameters": n_params, "card": smi})
    # no PyTorch call computes this function (the per-leaf clip, stochastic
    # rounding): library_ms is null; torch's fused Adam above is context only
    return errors, {"fused_adam": (ms, plain_ms, bound)}, {"fused_adam": None}


def fused_adam_hbm_bytes(params, grads) -> int:
    """Bytes of one step: g read twice (norm, update), p, m, ν read and
    written once each."""
    return sum(2 * g.numel() * g.element_size() + 6 * p.numel() * p.element_size()
               for p, g in zip(params, grads))


# the hidden FC products of the --int8_hidden routes: name → (K, N)
INT8_SHAPES = {"willow_rgb": (D_RGB * K_RGB, 1024), "willow_audio": (D_AUD * K_AUD, 1024),
               "netfv64_rgb": (2 * D_RGB * 64, 1024), "netfv64_audio": (2 * D_AUD * 32, 1024)}
INT8_BATCHES = (1, 32, 256, 512)
# |Δ| <= INT8_GATE · (|x|·|q|)·s per entry: the two f32 sums over K differ in
# order only (the kernel: K/splits-long runs of 16-wide tensor-core steps,
# then the splits in order; cuBLAS: its own blocking), and f32 summation of
# K terms in any blocked order errs by at most about (log₂K + K/run)·2⁻²⁴ of
# Σ|x·q| — 4.6e-6 at K = 262,144 over 9 splits; a dropped split moves an
# entry by that split's whole share
INT8_GATE = 1e-5


# the card's quantizer (int8_weight's) against the host's on this many
# first rows of each weight, bit for bit
INT8_HOST_ROWS = 8192


def int8_inputs(gen, m: int, k: int, n: int, dev, zero_column: bool = False):
    """x [m, k] bf16 at a pooled descriptor's scale (unit rows), a weight
    quantized on the card (fast_infer.int8_weight) from N(0, 1/√(k/16))
    with column 0 zero when asked, its scales and a bias.  Raises unless the
    card's quantizer gives the host's bits on the first INT8_HOST_ROWS
    rows."""
    x = (torch.randn(m, k, generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device=dev) * (k / 16) ** -0.5
    if zero_column:
        w[:, 0] = 0
    rows = w[:INT8_HOST_ROWS]
    card_q, card_s = quantize_int8_tensor(rows)
    host_q, host_s = quantize_weight_int8(rows.cpu())
    if not (np.array_equal(card_q.cpu().numpy(), host_q)
            and np.array_equal(card_s.cpu().numpy().view(np.int32), host_s.view(np.int32))):
        raise AssertionError(f"int8 quantizer: the card's bits differ from the host's on [{rows.shape[0]}, {n}]")
    fc = int8_weight(w, dev)
    return x, fc["q"], fc["s"], torch.randn(n, generator=gen, device=dev)


def check_int8(name, x, q, s, b, errors) -> float:
    """The kernel against its plain version (INT8_GATE), with a second
    launch equal bit for bit; returns the largest |Δ| over its allowance."""
    want = matmul_wi8_plain(x, q, s, b)
    got = matmul_wi8(x, q, s, b)
    again = matmul_wi8(x, q, s, b)
    # plus two f32 roundings of the result (the scale, the bias)
    allow = (INT8_GATE * (x.float().abs() @ logical_weight(q, x.shape[1]).float().abs()) * s.abs()
             + 2.0 ** -22 * want.abs())
    diff = (got - want).abs()
    if not torch.equal(got, again):
        raise AssertionError(f"int8_matmul {name}: a second launch differs")
    if not bool(torch.isfinite(got).all()) or not bool((diff <= allow + 1e-30).all()):
        raise AssertionError(f"int8_matmul {name}: max |Δ|/allowance {(diff / (allow + 1e-30)).max().item():.3g}")
    errors["int8_matmul"] = max(errors.get("int8_matmul", 0.0), diff.max().item())
    return (diff / (allow + 1e-30)).max().item()


def phase_int8_matmul(dev, smi) -> tuple:
    """The W8A16 kernel (``csrc/int8_matmul.cu``) against its plain version
    at the --int8_hidden shapes (INT8_SHAPES; AttentionNetVLAD's is Willow
    rgb's, checked with the bias fused) for B in INT8_BATCHES, and at
    K = 4,112 (not a multiple of the 64-deep tile), N = 200, with a zero
    column; times at the Willow rgb FC for each B beside the bound and
    cuBLAS bf16 on the weight dequantized once (library_ms)."""
    errors, worst, times = {}, {}, {}
    # the library's tiles, which int8_geometry mirrors
    tile = (ctypes.c_int * 4)()
    kernel_build.load_function("int8_matmul", "lpm_int8_matmul_tile", [ctypes.c_void_p], restype=None)(tile)
    if list(tile) != [TILE_N, TILE_K, BATCH_TILES[-1], H100_SMS]:
        raise AssertionError(f"int8_matmul: the library's tiles {list(tile)} differ from int8_geometry's")
    gen = torch.Generator(device=dev).manual_seed(7)
    for name, (k, n) in {**INT8_SHAPES, "edge_k4112_n200": (4112, 200)}.items():
        edge = name.startswith("edge")
        x, q, s, b = int8_inputs(gen, 512, k, n, dev, zero_column=edge)
        for m in (1, 37) if edge else INT8_BATCHES:
            xm = x[:m].contiguous()
            worst[f"{name} B={m}"] = check_int8(f"{name} B={m}", xm, q, s, None, errors)
            if name == "willow_rgb":
                worst[f"{name}+bias B={m}"] = check_int8(f"{name}+bias B={m}", xm, q, s, b, errors)
        if name == "willow_rgb":
            # the library's operand: dequantized once, unscaled, [K, N]
            w_bf16 = logical_weight(q, k).float().to(torch.bfloat16)
            for m in INT8_BATCHES:
                xm = x[:m].contiguous()
                ms = time_ms(lambda: matmul_wi8(xm, q, s))
                plain_ms = time_ms(lambda: matmul_wi8_plain(xm, q, s), reps=5)
                library_ms = time_ms(lambda: torch.matmul(xm, w_bf16))
                flops, nbytes = 2 * m * k * n, k * n + m * k * 2 + m * n * 4 + n * 4
                bound = max((flops / PEAK_BF16 * 1e3, "operations"), (nbytes / PEAK_BYTES * 1e3, "bytes"))
                # the same two on the profiler's device clock, without the
                # host's launch gap inside the events (the wrapper's Python)
                device = (device_ms(lambda: matmul_wi8(xm, q, s)), device_ms(lambda: torch.matmul(xm, w_bf16)))
                times[m] = (ms, plain_ms, bound, library_ms, device)
            del w_bf16
        del x, q
        torch.cuda.empty_cache()
    k, n = INT8_SHAPES["willow_rgb"]
    emit({"phase": "int8_matmul", "gate": INT8_GATE, "worst_diff_over_allowance": worst,
          "times_willow_rgb": {f"B={m}": {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2][0],
                                          "bound_by": t[2][1], "cublas_bf16_ms": t[3], "device_ms": t[4][0],
                                          "cublas_bf16_device_ms": t[4][1]}
                               for m, t in times.items()},
          "geometry": {f"B={m}": int8_geometry(m, n, k) for m in INT8_BATCHES}, "card": smi})
    t = times[512]
    return errors, {"int8_matmul": (t[0], t[1], t[2])}, {"int8_matmul": t[3]}



# the train CLI's item-12b modes at Willow training's settings (B=256,
# S=30, bf16 compute, --fused_train_aggregation), TRAIN_12B_STEPS steps each
# (two: every check reads the first update or the steps after it, and a
# second step is one after it), each mode's step timed over
# TRAIN_12B_TIMING_ROUNDS rounds of as many steps (time_train_step)
TRAIN_12B_RUNS = {"bf16_params": ["--bf16_params"], "fused_adam": ["--fused_adam"],
                  "bf16_params_accum2": ["--bf16_params", "--grad_accum_steps=2"], "use_remat": ["--use_remat"]}
TRAIN_12B_STEPS = 2
TRAIN_12B_TIMING_ROUNDS = 3
TRAIN_12B_FLAGS = [f for f in TRAIN_FLAGS if not f.startswith("--max_steps")] + [
    "--fused_train_aggregation", f"--max_steps={TRAIN_12B_STEPS}"]
# --use_remat against the same steps without it: losses and BN statistics
REMAT_GATE = 1e-6
# FusedAdam's first update against the CPU on this many entries of each leaf
FUSED_ADAM_CPU_SLICE = 1 << 22


def first_update_gap(dev, args, configs, batch, tree) -> dict:
    """The first update of ``args``' optimizer on the card against the same
    update on the CPU from the same parameters and gradients (the card's, of
    the CLI's first batch): for the f32 master each entry's |Δ| within
    OPTIMIZER_GATE of the parameter's max |CPU delta| plus one f32 ulp of
    its master (the clip norm's order moves u by ~1e-7 of itself, and
    master + u may then round to the next f32); for FusedAdam the kernel against
    the plain version — m bit for bit, p and ν on a bf16 neighbour of the
    CPU's f32 value, and the share of p and ν entries whose pick differs
    from the CPU's (on FUSED_ADAM_CPU_SLICE entries of each leaf)."""
    fcfg, mcfg, tcfg = configs
    model = load_flax_variables(create_model(args.model, mcfg, fcfg.total_size), tree).to(dev)
    state = TrainState.create(model, tcfg)
    step = TrainStep(CrossEntropyLoss(), tcfg, mcfg, True)
    dbatch = {k: v.to(dev) for k, v in batch.items()}
    if step.accum == 1:
        grads = step_lib.gradients(step.loss(state, dbatch, prng.key(args.seed))[0], model)
    else:
        grads = step.accumulated(state, dbatch, prng.key(args.seed))[0]
    names = [n for n, _ in model.named_parameters()]
    p0 = [p.detach().cpu().clone() for p in model.parameters()]
    cpu_grads = [g.cpu() for g in grads]
    if tcfg.fused_adam:
        tx = state.tx
        m0 = [t.cpu().clone() for t in tx.m]
        v0 = [t.cpu().clone() for t in tx.nu]
        tx.step(grads)
        k = AdamConsts(tx.schedule(0), 0).tensors("cpu")
        differ = total = 0
        for i, (p, name) in enumerate(zip(model.parameters(), names)):
            # the first FUSED_ADAM_CPU_SLICE entries of each leaf (the clip
            # from the whole leaf's norm): the CPU's plain arithmetic on 306M
            # entries would take a minute
            n = min(p.numel(), FUSED_ADAM_CPU_SLICE)
            g32 = cpu_grads[i].float().reshape(-1)
            if tx.clip_norm is not None:
                g32 = g32 * clip_scale(leaf_sumsq(g32), tx.clip_norm)
            p32, m32, v32 = adam_leaf_f32(g32[:n], p0[i].reshape(-1)[:n], m0[i].reshape(-1)[:n],
                                          v0[i].reshape(-1)[:n], k)
            got = [t.detach().reshape(-1)[:n].cpu() for t in (p, tx.m[i], tx.nu[i])]
            if p.dtype != torch.bfloat16:
                if not all(torch.equal(a, b) for a, b in zip(got, (p32, m32, v32))):
                    raise AssertionError(f"fused_adam first update: the f32 leaf {name} differs from the CPU's")
                continue
            bits = random_bits(n, tx.seed, 0, i)
            if not torch.equal(got[1].view(torch.int16), m32.to(torch.bfloat16).view(torch.int16)):
                raise AssertionError(f"fused_adam first update: m of {name} differs from the CPU's")
            for value, ref, pick in ((got[0], p32, stochastic_round_bf16(p32, bits)),
                                     (got[2], v32, stochastic_round_bf16(v32, bits >> 16))):
                if not bool(bf16_neighbour(value, ref).all()):
                    raise AssertionError(f"fused_adam first update: {name} off the bf16 neighbours of the CPU's")
                differ += int((value.view(torch.int16) != pick.view(torch.int16)).sum())
                total += n
        return {"share_p_nu_differ_from_cpu": differ / total, "entries": total}
    got = state.tx.updates(grads)
    cpu_tx = optimizers.create_optimizer(list(zip(names, p0)), tcfg)
    want = cpu_tx.updates(cpu_grads)
    # the delta is master + u − f32(p): the master's f32 add rounds at the
    # master's own magnitude, so one ulp of it is allowed beside the gate
    masters = cpu_tx.master if tcfg.fp32_master else [None] * len(want)
    gaps, over = {}, {}
    for n, u, w, m in zip(names, got, want, masters):
        diff = (u.cpu() - w).abs()
        gaps[n] = (diff.max() / w.abs().max().clamp(min=1e-30)).item()
        ulp = 0.0 if m is None else torch.nextafter(m.abs(), torch.tensor(float("inf"))) - m.abs()
        over[n] = (diff / (OPTIMIZER_GATE * w.abs().max().clamp(min=1e-30) + ulp)).max().item()
    worst = max(gaps.items(), key=lambda kv: kv[1])
    worst_over = max(over.items(), key=lambda kv: kv[1])
    if worst_over[1] > 1.0:
        raise AssertionError(f"{args.train_dir}: first update {worst_over} over its allowance "
                             f"({OPTIMIZER_GATE} of max |Δ| plus one ulp of the master)")
    return {"worst_rel_gap_card_vs_cpu": worst, "worst_over_allowance": worst_over, "limit": OPTIMIZER_GATE}


def remat_gaps(dev, tree) -> dict:
    """TRAIN_12B_STEPS in-process steps of Willow bf16 fused at B=256 from
    ``tree`` with and without --use_remat on the same batches: the largest
    |Δ| of the losses and of the BN statistics (REMAT_GATE: a second BN
    update in the recompute moves every statistic by (1 − 0.999)·(batch −
    running) again)."""
    mcfg = ModelConfig(compute_dtype="bfloat16", fused_train_aggregation=True, presampled=True)
    batches = [random_train_batch(np.random.default_rng(20 + i), 256, dev) for i in range(TRAIN_12B_STEPS)]
    out = {}
    for remat in (False, True):
        tcfg = TrainingConfig(batch_size=256, use_remat=remat)
        model = load_flax_variables(create_model("NetVLADModelLF", mcfg, DT), tree).to(dev)
        state = TrainState.create(model, tcfg)
        step = TrainStep(CrossEntropyLoss(), tcfg, mcfg, True)
        losses = [float(step(state, b, prng.key(0))["loss"]) for b in batches]
        out[remat] = (losses, {n: b.clone() for n, b in model.named_buffers()})
        del model, state
        torch.cuda.empty_cache()
    loss_gap = max(abs(a - b) for a, b in zip(out[False][0], out[True][0]))
    stats_gap = max((out[False][1][n] - out[True][1][n]).abs().max().item() for n in out[False][1])
    return {"loss_gap": loss_gap, "batch_stats_gap": stats_gap, "remat_losses": out[True][0]}


def phase_train_12b(dev, workdir, smi) -> dict:
    """Item 12b through the train CLI at Willow training's settings on
    train_e2e's 512 videos, TRAIN_12B_STEPS steps of each TRAIN_12B_RUNS mode,
    launch counters zeroed before each run and read after: the training
    kernels twice a step per microbatch (the forward again in the
    recompute under --use_remat), FusedAdam once a step.  Gates: finite
    losses; the first update on the card against the CPU's
    (first_update_gap); the final checkpoint restored into a fresh state
    equal bit for bit to the run's live state; --use_remat's losses and BN
    statistics within REMAT_GATE of the run without it (remat_gaps); the
    eval CLI --fast_forward --bf16_params on the bf16 checkpoint, a finite
    GAP.  Each mode's step ms (forward / backward / optimizer) and peak GiB
    (train_throughput has the f32-Adam step's).  Returns {kernel: launches}."""
    data = os.path.join(workdir, "train-0.tfrecord")
    none = dict.fromkeys(KERNELS, 0)
    launches = dict(none)
    tree = None  # the CLI's initial weights: one seed and model for every run
    first = None  # the CLI's first batch: one reader, shuffle and seed for every run
    for run, flags in TRAIN_12B_RUNS.items():
        train_dir = os.path.join(workdir, f"12b-{run}")
        argv = TRAIN_12B_FLAGS + flags + [f"--train_data_pattern={data}", f"--train_dir={train_dir}"]
        reset_counters()
        start = time.perf_counter()
        trainer = train.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - start
        got = counters()
        args = train.build_parser().parse_args(argv)
        fcfg, mcfg, tcfg = configs = train.configs_from_args(args)
        micro = TRAIN_12B_STEPS * 2 * tcfg.grad_accum_steps
        want = {**none, "netvlad_aggregate_forward": micro * (2 if tcfg.use_remat else 1),
                "netvlad_aggregate_backward": micro, "fused_adam": TRAIN_12B_STEPS if tcfg.fused_adam else 0}
        if got != want:
            raise AssertionError(f"train_12b {run}: launches {got}, expected {want}")
        for n, c in got.items():
            launches[n] += c
        losses = [h["loss"] for h in trainer.history]
        if len(losses) != TRAIN_12B_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"train_12b {run}: losses {losses}")
        mngr = CheckpointManager(train_dir)
        arrays = mngr.load_arrays(TRAIN_12B_STEPS)
        bad = leaf_mismatches(trainer.state.state_tree(), arrays)
        fresh = TrainState.create(create_model(args.model, mcfg, fcfg.total_size).to(dev), tcfg)
        fresh.load_state_tree(mngr.restore(TRAIN_12B_STEPS, like=fresh.state_tree()))
        bad += leaf_mismatches(fresh.state_tree(), arrays)
        dtypes = sorted({d for _, d in arrays.values()})
        if bad or fresh.step != TRAIN_12B_STEPS:
            raise AssertionError(f"train_12b {run}: the checkpoint and its restore differ at {bad[:8]}")
        del trainer, fresh, arrays
        torch.cuda.empty_cache()
        tree = zoo_init(args, configs) if tree is None else tree
        first = zoo_first_batch(args, configs, data) if first is None else first
        start = time.perf_counter()
        gate = first_update_gap(dev, args, configs, first, tree)
        gate_s = time.perf_counter() - start
        torch.cuda.empty_cache()
        start = time.perf_counter()
        line, _ = time_train_step(dev, "NetVLADModelLF", dataclasses.replace(mcfg, presampled=True),
                                  dataclasses.replace(tcfg, presample_frames=True),
                                  random_train_batch(np.random.default_rng(2), 256, dev), tree=tree,
                                  rounds=TRAIN_12B_TIMING_ROUNDS)
        timing_s = time.perf_counter() - start
        extra = {}
        if run == "use_remat":
            extra = remat_gaps(dev, tree)
            if not (extra["loss_gap"] <= REMAT_GATE and extra["batch_stats_gap"] <= REMAT_GATE):
                raise AssertionError(f"train_12b use_remat against no remat: {extra} (gate {REMAT_GATE})")
        if run == "bf16_params":
            reset_counters()
            info = eval_cli.main(["--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
                                  "--feature_sizes=1024,128", "--batch_size=64", "--device=cuda", "--bf16_params",
                                  "--fast_forward", "--run_once", f"--eval_data_pattern={data}",
                                  f"--train_dir={train_dir}"])
            torch.cuda.synchronize()
            ev = counters()
            if not np.isfinite(info["gap"]) or ev != {**none, "netvlad_frontend": 8}:
                raise AssertionError(f"train_12b: eval --fast_forward on the bf16 checkpoint: {info['gap']}, {ev}")
            launches["netvlad_frontend"] += ev["netvlad_frontend"]
            extra["eval_fast_forward_bf16_checkpoint"] = {k: float(info[k]) for k in EVAL_METRICS}
        shutil.rmtree(train_dir)
        emit({"phase": "train_12b", "run": run, "flags": flags, "cli_s": cli_s, "gate_s": gate_s, "timing_s": timing_s,
              "losses": losses,
              "launches": got, "checkpoint_dtypes": dtypes, "first_update": gate, **extra, **line,
              "card": smi})
        torch.cuda.empty_cache()
    return launches


def phase_int8_e2e(dev, workdir, fp, smi) -> dict:
    """--int8_hidden on Willow: the inference CLI with --fast_infer on
    phase_e2e's weights and 96 videos (the front-end kernel once a batch,
    the W8A16 kernel twice: rgb and audio), its probabilities against the
    bf16 fused route's on the same frames (report, and within 5e-2); then
    the fused route's videos/s at B=256 and 512 with the int8 hidden FC
    beside the bf16 one (``fp``).  Returns {kernel: launches}."""
    mcfg = ModelConfig()
    data = os.path.join(workdir, "videos-0.tfrecord")
    train_dir = os.path.join(workdir, "train")
    out_csv = os.path.join(workdir, "predictions-int8.csv")
    reset_counters()
    start = time.perf_counter()
    written = inference.main([
        "--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
        "--feature_sizes=1024,128", f"--input_data_pattern={data}", f"--train_dir={train_dir}",
        f"--output_file={out_csv}", "--batch_size=32", "--fast_infer", "--int8_hidden", "--device=cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - start
    got = counters()
    n_batches = -(-written // 32)
    want = {**dict.fromkeys(KERNELS, 0), "netvlad_frontend": n_batches, "int8_matmul": 2 * n_batches}
    if got != want:
        raise AssertionError(f"int8_e2e: inference CLI launches {got}, expected {want}")
    fp8 = prepare_fast_params(convert_flax_variables(load_variables_npz(train_dir), mcfg), mcfg,
                              int8_hidden=True, device=dev)
    batches = load_batches(data, dev)
    fn = build_fast_netvlad_inference(mcfg, return_probs=True)
    gap = (run_batches(batches, fp8, fn) - run_batches(batches, fp, fn)).abs().max().item()
    if gap > 5e-2:
        raise AssertionError(f"int8_e2e: int8 against bf16 probabilities {gap}")
    csv = read_csv(out_csv, written, [{"video_id": v} for *_, vids in batches for v in vids])
    check_csv_rows(csv, run_batches(batches, fp8, fn), batches, "fused int8")
    gen = torch.Generator(device=dev).manual_seed(1)
    rates = {}
    for b in (256, 512):
        x = torch.randint(0, 256, (b, F, DT), generator=gen, device=dev, dtype=torch.uint8)
        nf = torch.randint(1, F + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
        top = build_fast_netvlad_inference(mcfg, top_k=20)
        for name, params in (("bf16", fp), ("int8", fp8)):
            rounds = [time_ms(lambda: top(params, x, nf, prng.key(1)), reps=10) for _ in range(3)]
            rates[f"B={b} {name}"] = b / (statistics.median(rounds) / 1e3)
        del x
    del fp8
    torch.cuda.empty_cache()
    emit({"phase": "int8_e2e", "part": "willow_inference", "videos": written, "cli_s": cli_s, "launches": got,
          "max_abs_prob_gap_int8_vs_bf16": gap, "videos_per_s": rates, "card": smi})
    return {"int8_matmul": got["int8_matmul"], "netvlad_frontend": got["netvlad_frontend"]}


def int8_eval(name: str, data: str, train_dir: str, flags, bf16_gap: float, n_batches: int,
              kernel, per_batch: int, smi) -> dict:
    """The eval CLI --fast_forward --int8_hidden on a trained arm of
    phase_eval_e2e: ``kernel`` (the route's pooling kernel) twice a batch and
    the W8A16 kernel ``per_batch`` times; |ΔGAP| against the arm's bf16
    --fast_forward GAP <= GAP_BUDGET.  Returns {kernel: launches}."""
    reset_counters()
    info = eval_cli.main(EVAL_CLI_FLAGS + flags + ["--fast_forward", "--int8_hidden", f"--model={name}",
                                                   f"--eval_data_pattern={data}", f"--train_dir={train_dir}",
                                                   "--run_once"])
    torch.cuda.synchronize()
    got = counters()
    want = {**dict.fromkeys(KERNELS, 0), kernel: (n_batches if kernel == "netvlad_frontend" else 2 * n_batches),
            "int8_matmul": per_batch * n_batches}
    if got != want:
        raise AssertionError(f"{name} eval --int8_hidden launches {got}, expected {want}")
    delta = abs(float(info["gap"]) - bf16_gap)
    emit({"phase": "int8_e2e", "part": "eval", "model": name, "gap_int8": float(info["gap"]),
          "gap_bf16": bf16_gap, "abs_gap_delta_int8_vs_bf16": delta, "budget": GAP_BUDGET,
          "metrics": {k: float(info[k]) for k in EVAL_METRICS}, "launches": got, "card": smi})
    if delta > GAP_BUDGET:
        raise AssertionError(f"{name}: |ΔGAP| of --int8_hidden against bf16 {delta} > {GAP_BUDGET}")
    return got


# ---- item 14: export and serving

# served top-20 scores against the plain route's on the same padded batches
# (PERF.md §2's kernel-against-plain gate); the model-forward route against
# make_predict_step on the same batch
SERVE_GATE, SERVE_F32_GATE = 1e-2, 1e-5
SERVE_BATCHES = (32, 256)
SERVE_ROUNDS = 3
# the HTTP load: clients × requests each × full-width records a request
HTTP_CLIENTS, HTTP_REQUESTS, HTTP_RECORDS, HTTP_LINGER_MS = 8, 16, 4, 2.0


def export_willow(tree, mcfg: ModelConfig, fcfg: FeatureConfig, workdir: str) -> dict:
    """phase_e2e's Willow tree through export_model.py: the directory, the
    seconds and the bytes of params.msgpack."""
    export_dir = os.path.join(workdir, "export")
    start = time.perf_counter()
    export_lib.export_model(export_dir, "NetVLADModelLF", mcfg, fcfg, tree["params"], tree["batch_stats"])
    return {"dir": export_dir, "export_s": time.perf_counter() - start,
            "params_bytes": os.path.getsize(os.path.join(export_dir, export_lib.PARAMS_FILE))}


def plain_served_values(fp, records, fcfg: FeatureConfig, mcfg: ModelConfig, batch: int, dev) -> np.ndarray:
    """The top-20 scores of the plain fast route (no kernel) on the batches
    the server serves: chunks of ``batch`` padded with their last record,
    each drawn from prng.key(0) as the server draws them."""
    fn = build_fast_netvlad_inference(mcfg, top_k=20, use_kernels=False)
    out = []
    for start in range(0, len(records), batch):
        chunk = records[start:start + batch]
        feats, nfs = export_lib.parse_serialized_records(fcfg, chunk + [chunk[-1]] * (batch - len(chunk)))
        values, _ = fn(fp, torch.from_numpy(feats).to(dev), torch.from_numpy(nfs).to(dev), prng.key(0))
        out.append(values[:len(chunk)].float().cpu().numpy())
    return np.concatenate(out)


def served_gap(route: str, pairs, want: np.ndarray, gate: float) -> float:
    got = np.asarray([scores for _, scores in pairs], np.float32)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"serve {route}: scores of shape {got.shape} or non-finite")
    gap = float(np.abs(got - want).max())
    if gap > gate:
        raise AssertionError(f"serve {route}: served scores {gap} from the reference's, over {gate}")
    return gap


def serve_launches(route: str, server: ModelServer, records, want: dict):
    """Warm ``server`` up and serve ``records`` with the counters zeroed
    just before and read just after; they must equal ``want``."""
    reset_counters()
    server.warmup()
    pairs = server.predict_pairs(records)
    torch.cuda.synchronize()
    got = counters()
    want = {**dict.fromkeys(KERNELS, 0), **want}
    if got != want:
        raise AssertionError(f"serve {route}: launches {got}, expected {want}")
    return pairs


def serve_throughput(server: ModelServer, records) -> dict:
    """predict_pairs over ``records`` at each SERVE_BATCHES size: videos/s
    (the median of SERVE_ROUNDS rounds), and per batch the host's parse ms
    and the device ms (CUDA events from the parse's end to the results'
    arrival)."""
    parse_ms, device_ms, start = [], [], {}
    parse, serve = export_lib.parse_serialized_records, server._serve

    def timed_parse(fcfg, recs):
        t0 = time.perf_counter()
        out = parse(fcfg, recs)
        parse_ms.append((time.perf_counter() - t0) * 1e3)
        start["event"] = torch.cuda.Event(enable_timing=True)
        start["event"].record()
        return out

    def timed_serve(recs):
        out = serve(recs)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        device_ms.append(start["event"].elapsed_time(end))
        return out

    export_lib.parse_serialized_records, server._serve = timed_parse, timed_serve
    out = {}
    try:
        for b in SERVE_BATCHES:
            server.batch_size = b
            server.predict_pairs(records[:b])
            rounds = []
            parse_ms.clear()
            device_ms.clear()
            for _ in range(SERVE_ROUNDS):
                t0 = time.perf_counter()
                server.predict_pairs(records)
                rounds.append(time.perf_counter() - t0)
            wall = statistics.median(rounds)
            out[f"B={b}"] = {"videos_per_s": len(records) / wall, "videos_per_s_rounds": [len(records) / r for r in rounds],
                             "batch_ms": wall * 1e3 * b / len(records),
                             "parse_ms_per_batch": statistics.median(parse_ms),
                             "device_ms_per_batch": statistics.median(device_ms),
                             "host_parse_share": sum(parse_ms) / (sum(rounds) * 1e3)}
    finally:
        export_lib.parse_serialized_records = parse
        server._serve = serve
        server.batch_size = 32
    return out


def serve_http(server: ModelServer, records) -> dict:
    """HTTP on 127.0.0.1: HTTP_CLIENTS threads each post HTTP_REQUESTS
    requests of HTTP_RECORDS records while BatchingQueue dispatches on this
    (the main) thread; requests/s, videos/s, latency, /statz's coalesced
    share, and the launches (the front end once per executed batch)."""
    batcher = BatchingQueue(server, max_delay_ms=HTTP_LINGER_MS)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server, batcher))
    accept = threading.Thread(target=httpd.serve_forever, daemon=True)
    accept.start()
    port = httpd.server_address[1]
    latencies, failures = [], []

    def client(c: int):
        for r in range(HTTP_REQUESTS):
            first = (c * HTTP_REQUESTS + r) * HTTP_RECORDS
            body = frame_records([records[(first + j) % len(records)] for j in range(HTTP_RECORDS)])
            t0 = time.perf_counter()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            try:
                conn.request("POST", "/predict", body=body)
                resp = conn.getresponse()
                payload = resp.read()
            finally:
                conn.close()
            latencies.append(time.perf_counter() - t0)
            if resp.status != 200 or len(json.loads(payload)["predictions"]) != HTTP_RECORDS:
                failures.append((resp.status, payload[:200]))

    def drive():
        threads = [threading.Thread(target=client, args=(c,)) for c in range(HTTP_CLIENTS)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        finally:
            batcher.shutdown()

    reset_counters()
    load = threading.Thread(target=drive)
    t0 = time.perf_counter()
    load.start()
    try:
        batcher.run_forever()
        wall = time.perf_counter() - t0
    finally:
        load.join(timeout=600)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/statz")
        stats = json.loads(conn.getresponse().read())
        conn.close()
        httpd.shutdown()
        httpd.server_close()
    torch.cuda.synchronize()
    got = counters()
    n = HTTP_CLIENTS * HTTP_REQUESTS
    want = {**dict.fromkeys(KERNELS, 0), "netvlad_frontend": stats["executes"]}
    if failures or load.is_alive() or len(latencies) != n or stats["requests"] != n or got != want:
        raise AssertionError(f"serve http: failures {failures[:3]}, {len(latencies)} of {n} answered, "
                             f"statz {stats}, launches {got}, expected {want}")
    lat = sorted(ms * 1e3 for ms in latencies)
    return {"clients": HTTP_CLIENTS, "requests": n, "videos": stats["rows"], "linger_ms": HTTP_LINGER_MS,
            "wall_s": wall, "requests_per_s": n / wall, "videos_per_s": stats["rows"] / wall,
            "latency_ms_p50": lat[len(lat) // 2], "latency_ms_p99": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "statz": stats, "coalesced_share": stats["coalesced"] / stats["requests"], "launches": got}


def phase_serve(dev, workdir, fp, export: dict, smi) -> dict:
    """Item 14 on Willow: phase_e2e's export reloaded bit for bit (the
    hidden FC chunked), then ModelServer over it: the fused route
    (--fast_serve; the front end once per batch, warmup included), the same
    with --int8_hidden (and the W8A16 kernel twice a batch), each within
    SERVE_GATE of its plain route on the same padded batches; the
    model-forward route within SERVE_F32_GATE of make_predict_step; then
    predict_pairs' videos/s at SERVE_BATCHES and the HTTP load.  Returns
    ({kernel: launches}, {"throughput", "http"}: the fused server's rates,
    which phase_native_serve prints beside the native route's)."""
    mcfg = ModelConfig()
    fcfg = FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), True, F)
    records = list(tfrecord_io.read_tfrecords(os.path.join(workdir, "videos-0.tfrecord")))
    n_batches = -(-len(records) // 32)
    with open(os.path.join(export["dir"], export_lib.PARAMS_FILE), "rb") as f:
        chunked = f.read().count(b"__msgpack_chunked_array__")
    if chunked != 1:  # the hidden FC, 278528 × 1024 f32, is over flax's 2**30-byte chunk
        raise AssertionError(f"serve: {chunked} chunked arrays in params.msgpack, expected the hidden FC")
    tree = load_variables_npz(os.path.join(workdir, "train"))

    start = time.perf_counter()
    server = ModelServer(export["dir"], 32, fast_serve=True, device=dev)
    reload_s = time.perf_counter() - start
    got, want = tree_paths({"params": server.params, "batch_stats": server.batch_stats}), tree_paths(tree)
    bad = sorted(set(got) ^ set(want)) + [p for p in want if p in got and (
        got[p].dtype != want[p].dtype or got[p].shape != want[p].shape
        or not np.array_equal(got[p].view(np.uint32), want[p].view(np.uint32)))]
    if bad:
        raise AssertionError(f"serve: reloaded leaves differ from the exported tree: {bad[:5]}")
    emit({"phase": "serve", "part": "export", "export_s": export["export_s"], "reload_s": reload_s,
          "params_bytes": export["params_bytes"], "chunked_arrays": chunked, "leaves_bit_equal": len(want),
          "card": smi})

    gaps, launches = {}, {}
    pairs = serve_launches("fused", server, records, {"netvlad_frontend": n_batches + 1})
    gaps["fused_vs_plain"] = served_gap("fused", pairs, plain_served_values(fp, records, fcfg, mcfg, 32, dev),
                                        SERVE_GATE)
    launches["netvlad_frontend"] = n_batches + 1

    server8 = ModelServer(export["dir"], 32, fast_serve=True, int8_hidden=True, device=dev)
    pairs = serve_launches("int8_hidden", server8, records,
                           {"netvlad_frontend": n_batches + 1, "int8_matmul": 2 * (n_batches + 1)})
    del server8
    fp8 = prepare_fast_params(convert_flax_variables(tree, mcfg), mcfg, int8_hidden=True, device=dev)
    fast_infer.matmul_wi8 = matmul_wi8_plain  # the plain int8 route: no kernel at all
    try:
        want8 = plain_served_values(fp8, records, fcfg, mcfg, 32, dev)
    finally:
        fast_infer.matmul_wi8 = matmul_wi8
    gaps["int8_vs_plain_int8"] = served_gap("int8_hidden", pairs, want8, SERVE_GATE)
    launches["netvlad_frontend"] += n_batches + 1
    launches["int8_matmul"] = 2 * (n_batches + 1)
    del fp8
    torch.cuda.empty_cache()

    server_mf = ModelServer(export["dir"], 32, fast_serve=False, device=dev)
    reset_counters()
    pairs = server_mf.predict_pairs(records[:32])
    torch.cuda.synchronize()
    if any(counters().values()):
        raise AssertionError(f"serve model-forward: launches {counters()}, expected none")
    del server_mf
    model = create_model("NetVLADModelLF", mcfg, DT)
    load_flax_variables(model, tree)
    predict = step_lib.make_predict_step(model.to(dev).eval(), mcfg, True, top_k=20)
    feats, nfs = export_lib.parse_serialized_records(fcfg, records[:32])
    values, indices = predict(torch.from_numpy(feats).to(dev), torch.from_numpy(nfs).to(dev))
    if [c for c, _ in pairs] != indices.cpu().tolist():
        raise AssertionError("serve model-forward: classes differ from make_predict_step's")
    gaps["model_forward_vs_predict_step"] = served_gap("model-forward", pairs, values.float().cpu().numpy(),
                                                       SERVE_F32_GATE)
    del model, predict, tree
    torch.cuda.empty_cache()
    emit({"phase": "serve", "part": "routes", "videos": len(records), "batch": 32, "max_abs_score_gap": gaps,
          "gates": {"fast": SERVE_GATE, "model_forward": SERVE_F32_GATE}, "launches": launches, "card": smi})

    rates = serve_throughput(server, [records[i % len(records)] for i in range(max(SERVE_BATCHES))])
    emit({"phase": "serve", "part": "throughput", "route": "fused", **rates, "card": smi})
    web = serve_http(server, records)
    launches["netvlad_frontend"] += web["launches"]["netvlad_frontend"]
    emit({"phase": "serve", "part": "http", **web, "card": smi})
    del server
    torch.cuda.empty_cache()
    return launches, {"throughput": rates, "http": web}


# ---- item 14b: the native runner (csrc/native_runner.cu) and lpm_serve

# the runner's launches on the Willow route, each once a batch
WILLOW_COUNTERS = ("netvlad_frontend", "hidden_sum", "gating", "moe_combine", "topk")
# the runner's probabilities against the fused route with kernels on the
# same padded batches: both run row 1 and the same rounding points, and the
# products are cuBLAS's in both.  They read equal bit for bit at B=32 and
# 256 (measured on one H100 at 700 W); the gate leaves room for cuBLAS to pick
# another split of the 262,144-long hidden-FC sums, no more
NATIVE_GATE = 1e-5
# each tail kernel against its plain version on the same inputs (atol as a
# share of max|ref|, rtol): the sum, the gating (the same operations as
# PyTorch's, in its order: bit for bit on one H100 at 700 W) and the top-k
# exactly, the MoE combine within the f32 tolerance
TAIL_GATES = {"native_hidden_sum": (0.0, 0.0), "native_gating": (0.0, 0.0),
              "native_moe_combine": TOLERANCE[torch.float32], "native_topk": (0.0, 0.0)}
TAIL_WIDTHS = dict(h=1024, v=3862, m=2, k=20)  # Willow's hidden width, vocabulary, mixtures, top-k
# moe_combine and topk are timed on this many input sets in turn (at B=256,
# 23.7 MB of MoE products, 3.95 MB of probabilities a set: either way more
# than the 50 MB L2), so that their bytes come from HBM as the bound counts
# them; their time on one set read again is printed beside
TAIL_COLD_SETS = 16
COLD_TAIL = ("native_moe_combine", "native_topk")
# lpm_serve's scores are printed with %.6f
LPM_SERVE_ROUNDING = 1e-6
LPM_SERVE_SIGTERM_S = 15


def kernel_clock(fn, reps: int = 20) -> dict:
    """One call of ``fn`` on the profiler's device clock (device_ms), the
    device records the profiler kept against the calls profiled (a call of
    one kernel makes one), and by CUDA events around a run of ``reps``
    calls (event_ms: the host's pace where a call's launch takes longer
    than its kernel)."""
    prof = profile_device(fn, reps)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return {"device_ms": prof.get("device_busy_ms_per_call"), "event_ms": start.elapsed_time(end) / reps,
            "profiler_records": prof.get("device_records"), "calls_profiled": reps}


def device_ms(fn, reps: int = 20) -> float:
    """Device busy ms per call of ``fn`` from the profiler, which leaves out
    the host's launch gaps between a short chain's kernels; CUDA events
    around one call where the profiler records no device activity."""
    busy = profile_device(fn, reps).get("device_busy_ms_per_call")
    return busy if busy is not None else time_ms(fn)


def tail_inputs(b: int, dev, v: int = TAIL_WIDTHS["v"], m: int = TAIL_WIDTHS["m"], seed=None) -> dict:
    """Random f32 inputs of the tail kernels at batch ``b``, Willow's widths
    (or ``v`` classes, ``m`` mixtures), drawn from ``seed`` (else from
    ``b``); the top-k's scores are the MoE's
    probabilities with exact ties (ten copies of each row's largest, ten of
    an entry near the 20th) and, in rows 0–3, the floats that only the total
    order ranks (topk_special_rows)."""
    gen = torch.Generator(device=dev).manual_seed(b if seed is None else seed)
    h = TAIL_WIDTHS["h"]

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = dict(h_rgb=randn(b, h, scale=0.5), h_aud=randn(b, h, scale=0.2), bias=randn(h, scale=0.1),
             gates=randn(b, h, scale=2.0), h=randn(b, h), g_scale=randn(h, scale=0.2) + 1.0,
             g_bias=randn(h, scale=0.1), ga=randn(b, (m + 1) * v, scale=3.0), ea=randn(b, m * v, scale=3.0),
             eb=randn(m * v, scale=0.5))
    probs = native_tail.moe_combine_plain(x["ga"], x["ea"], x["eb"], m)
    top = torch.sort(probs, dim=1, descending=True).values
    probs[:, 3000:3010] = top[:, :1]
    probs[:, 100:110] = top[:, 18:19]
    x["probs"] = topk_special_rows(probs.contiguous())
    return x


# float bits that only jax.lax.top_k's total order ranks: +NaN of three
# payloads (one signalling) above +inf, −NaN below −inf
TOPK_NAN_BITS = (0x7FC00000, 0x7FC00001, 0x7F800001, 0x7F800000, 0xFFC00000, 0xFF800000, 0xFFFFFFFF)


def topk_special_rows(probs: torch.Tensor) -> torch.Tensor:
    """``probs`` [B ≥ 4, V ≥ 64] with rows 0–3 rewritten so that ties only
    the bits break sit at the top-20's boundary: row 0, 15 positives, the
    rest negative but 6 +0 and 6 −0 interleaved (the top 20 takes five +0,
    the lowest indices first); row 1, TOPK_NAN_BITS twice each (equal bits
    at two indices) among the probabilities; row 2, 25 copies of one +NaN
    and 5 of −NaN; row 3, only ±0 in turn."""
    v = probs.shape[1]
    bits = probs.view(torch.int32)

    def put(row: int, at, words) -> None:
        at = torch.as_tensor(at, device=probs.device)
        words = torch.as_tensor(np.asarray(words, dtype=np.uint32).view(np.int32), device=probs.device)
        bits[row, at] = words.expand(at.shape)

    probs[0] = -probs[0].abs()
    probs[0, 7:v:v // 15][:15] = torch.arange(1, 16, device=probs.device, dtype=torch.float32)
    zeros = torch.arange(3, v, v // 12, device=probs.device)[:12]
    put(0, zeros[0::2], [0x00000000])
    put(0, zeros[1::2], [0x80000000])
    nan_at = torch.arange(11, v, v // (2 * len(TOPK_NAN_BITS)), device=probs.device)[:2 * len(TOPK_NAN_BITS)]
    put(1, nan_at, list(TOPK_NAN_BITS) * 2)
    put(2, torch.arange(5, v, v // 30, device=probs.device)[:25], [0x7FC00000])
    put(2, torch.arange(9, v, v // 5, device=probs.device)[:5], [0xFFC00000])
    put(3, torch.arange(v, device=probs.device), [0x00000000, 0x80000000] * (v // 2) + [0x00000000] * (v % 2))
    return probs


def tail_calls(x: dict) -> dict:
    """name → (kernel call, plain call, library call or None, bytes moved)."""
    b, h = x["h"].shape
    m, k = TAIL_WIDTHS["m"], TAIL_WIDTHS["k"]
    v = x["probs"].shape[1]
    return {
        "native_hidden_sum": (lambda: native_tail.hidden_sum([x["h_rgb"], x["h_aud"]], x["bias"]),
                              lambda: native_tail.hidden_sum_plain([x["h_rgb"], x["h_aud"]], x["bias"]),
                              None, 2 * b * h * 4 + h * 4 + b * h * 6),
        "native_gating": (lambda: native_tail.gating(x["gates"], x["h"], x["g_scale"], x["g_bias"]),
                          lambda: native_tail.gating_plain(x["gates"], x["h"], x["g_scale"], x["g_bias"]),
                          None, 2 * b * h * 4 + 2 * h * 4 + b * h * 2),
        "native_moe_combine": (lambda: native_tail.moe_combine(x["ga"], x["ea"], x["eb"], m),
                               lambda: native_tail.moe_combine_plain(x["ga"], x["ea"], x["eb"], m),
                               None, b * (m + 1) * v * 4 + b * m * v * 4 + m * v * 4 + b * v * 4),
        "native_topk": (lambda: native_tail.topk(x["probs"], k), lambda: native_tail.topk_plain(x["probs"], k),
                        lambda: torch.topk(x["probs"], k), b * v * 4 + b * k * 8),
    }


def compare_topk(name: str, got: tuple, want: tuple) -> float:
    """0.0 where the top-k's values equal ``want``'s bit for bit (as int32:
    NaNs and ±0 included, which ``compare`` cannot take) and its indices
    exactly; raises else."""
    if got[0].shape != want[0].shape or got[1].shape != want[1].shape:
        raise AssertionError(f"{name}: shapes {tuple(got[0].shape)}, {tuple(got[1].shape)}")
    if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) and torch.equal(got[1], want[1])):
        bad = (got[0].view(torch.int32) != want[0].view(torch.int32)) | (got[1] != want[1])
        raise AssertionError(f"{name}: {int(bad.sum())} of {bad.numel()} entries differ from topk_plain's, "
                             f"first in row {int(bad.nonzero()[0, 0])}")
    return 0.0


def tail_paths(dev, errors: dict) -> dict:
    """Every path inside topk and moe_combine against its plain version:
    topk at k = 1, 20, 64, TOPK_FAST_K + 1 and V on tail_inputs' rows (the
    block select's 16 entries a thread, then the rounds) at each of
    SERVE_BATCHES; at B=32 a row of 10,007 (the select's 64 entries a
    thread) at k = 20 and 64, and of 20,011 (the rounds) at k = 20;
    moe_combine at M = 1 … 5 (the four in registers, then the loop) on an
    even and an odd V.  → {check: max |Δ|}."""
    line = {}
    v = TAIL_WIDTHS["v"]
    for b in SERVE_BATCHES:
        x = tail_inputs(b, dev)
        for k in sorted({1, 20, 64, native_tail.TOPK_FAST_K + 1, v}):
            line[f"topk B={b} V={v} k={k}"] = compare_topk(f"native_topk B={b} k={k}", native_tail.topk(x["probs"], k),
                                                           native_tail.topk_plain(x["probs"], k))
        del x
        for m in (1, 2, 3, 4, 5):
            for vm in (v, v + 1):
                x = tail_inputs(b, dev, vm, m)
                line[f"moe_combine B={b} M={m} V={vm}"] = compare(
                    f"native_moe_combine B={b} M={m} V={vm}", native_tail.moe_combine(x["ga"], x["ea"], x["eb"], m),
                    native_tail.moe_combine_plain(x["ga"], x["ea"], x["eb"], m), tol=TAIL_GATES["native_moe_combine"])
                del x
    for vk, ks in ((10007, (20, 64)), (20011, (20,))):
        probs = topk_special_rows(torch.rand((32, vk), generator=torch.Generator(device=dev).manual_seed(vk),
                                             device=dev))
        for k in ks:
            line[f"topk B=32 V={vk} k={k}"] = compare_topk(f"native_topk V={vk} k={k}", native_tail.topk(probs, k),
                                                           native_tail.topk_plain(probs, k))
    torch.cuda.synchronize()
    for name in ("native_topk", "native_moe_combine"):
        key = name.removeprefix("native_")
        errors[name] = max([errors.get(name, 0.0)] + [e for c, e in line.items() if c.startswith(key)])
    return line


# hidden_sum's (products, group, bias_first) on each route that ends in the
# gated tail
HIDDEN_ROUTE_SUMS = {"willow": (2, 1, False), "lf_one_modality": (1, 1, True), "lf_two_modalities": (2, 1, True),
                     "netfv": (4, 2, True), "transformer_and_attention_netvlad": (1, 1, False)}
# hidden_sum's and gating's paths (label → rows, H, the inputs' offset in
# floats): float4s at Willow's width, at B=1, past one tile of 1,024
# columns, at four tiles; the scalar path at an odd width and on views one
# float in
HIDDEN_PATH_SHAPES = {"vector": (256, 1024, 0), "vector_b1": (1, 1024, 0), "vector_ragged_tile": (5, 1100, 0),
                      "vector_four_tiles": (3, 4096, 0), "scalar_odd_width": (256, 1003, 0),
                      "scalar_offset_view": (256, 1024, 1)}


def equal_bits(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """0.0 where ``got`` equals ``want`` bit for bit; raises else."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got.view(ints[got.dtype]),
                                                                             want.view(ints[want.dtype])):
        raise AssertionError(f"{name}: differs from the plain version's bits (max |Δ| "
                             f"{(got.float() - want.float()).abs().max().item():.3e})")
    return 0.0


def hidden_paths(dev, errors: dict) -> dict:
    """hidden_sum at every route's (products, group, bias_first) and gating
    in bf16 and f32 out, each at HIDDEN_PATH_SHAPES (the vector and the
    scalar path), against their plain versions bit for bit (h, its bf16
    rounding, the gated output).  → {check: 0.0}."""
    gen = torch.Generator(device=dev).manual_seed(31)
    line = {}
    for label, (rows, h, offset) in HIDDEN_PATH_SHAPES.items():
        def view(scale: float) -> torch.Tensor:
            buf = torch.randn((offset + rows * h,), generator=gen, device=dev) * scale
            return buf[offset:].view(rows, h)

        parts = [view(0.5) for _ in range(4)]
        bias = torch.randn((h,), generator=gen, device=dev) * 0.1
        for route, (n, group, bias_first) in HIDDEN_ROUTE_SUMS.items():
            got = native_tail.hidden_sum(parts[:n], bias, group, bias_first)
            want = native_tail.hidden_sum_plain(parts[:n], bias, group, bias_first)
            name = f"hidden_sum {label} {route}"
            line[name] = max(equal_bits(f"{name} {out}", g, w) for out, g, w in zip(("h", "hb"), got, want))
        gates, hid = view(2.0), view(1.0)
        g_scale, g_bias = torch.randn((h,), generator=gen, device=dev) * 0.2 + 1.0, bias
        for dtype in (torch.bfloat16, torch.float32):
            name = f"gating {label} {str(dtype).removeprefix('torch.')}"
            line[name] = equal_bits(name, native_tail.gating(gates, hid, g_scale, g_bias, dtype),
                                    native_tail.gating_plain(gates, hid, g_scale, g_bias, dtype))
    torch.cuda.synchronize()
    for name in ("native_hidden_sum", "native_gating"):
        key = name.removeprefix("native_")
        errors[name] = max([errors.get(name, 0.0)] + [e for c, e in line.items() if c.startswith(key)])
    return line


def check_tail_kernels(dev, errors: dict) -> tuple:
    """Each tail kernel against its plain version at SERVE_BATCHES within
    TAIL_GATES (the gating's share of outputs equal bit for bit printed; the
    top-k bit for bit, NaNs and ±0 included, compare_topk), then every path
    of topk and moe_combine (tail_paths) and of hidden_sum and gating, bit
    for bit (hidden_paths); at the largest batch each one's
    device ms, the plain chain's, the library call's (torch.topk) and the
    bound (bytes over the HBM rate), moe_combine and topk on
    TAIL_COLD_SETS input sets in turn.  → (timing, library) for the
    kernels line."""
    timing, library = {}, {}
    for b in SERVE_BATCHES:
        x = tail_inputs(b, dev)
        calls = tail_calls(x)
        line = {}
        for name, (kernel, plain, lib, nbytes) in calls.items():
            got, want = kernel(), plain()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            if name == "native_topk":
                err = compare_topk(f"{name} B={b}", got, want)
                equal = got[0].view(torch.int32) == want[0].view(torch.int32)
            else:
                err = max(compare(f"{name} B={b}", g, w, tol=TAIL_GATES[name]) for g, w in zip(got, want))
                equal = got[0] == want[0]
            errors[name] = max(errors.get(name, 0.0), err)
            line[name] = {"max_abs_err": err, "bit_equal_share": float(equal.float().mean())}
        torch.cuda.synchronize()
        emit({"phase": "native_serve", "part": "tail_kernels", "B": b, "checks": line, "gates": TAIL_GATES})
    emit({"phase": "native_serve", "part": "tail_paths", "checks": tail_paths(dev, errors),
          "gates": TAIL_GATES})
    emit({"phase": "native_serve", "part": "hidden_paths", "checks": hidden_paths(dev, errors),
          "gates": "bit for bit"})
    sets = [calls] + [tail_calls(tail_inputs(max(SERVE_BATCHES), dev, seed=s)) for s in range(1, TAIL_COLD_SETS)]
    warm = {}
    for name, (kernel, plain, lib, nbytes) in calls.items():
        bound_ms = nbytes / PEAK_BYTES * 1e3
        if name in COLD_TAIL:
            warm[name] = device_ms(kernel)
            kernel, plain = rotating(sets, name, 0), rotating(sets, name, 1)
            lib = rotating(sets, name, 2) if lib is not None else None
        timing[name] = (device_ms(kernel), device_ms(plain), (bound_ms, "bytes"))
        library[name] = device_ms(lib) if lib is not None else None
    emit({"phase": "native_serve", "part": "tail_times", "B": max(SERVE_BATCHES), "device_ms": timing,
          "library_device_ms": library, "same_inputs_device_ms": warm, "input_sets": TAIL_COLD_SETS})
    del sets
    return timing, library


def rotating(sets: list, name: str, which: int):
    """A call that runs entry ``which`` of ``name`` (0 the kernel, 1 the
    plain version, 2 the library call) on each of ``sets`` in turn."""
    turn = itertools.cycle(sets)
    return lambda: next(turn)[name][which]()


def read_ready(proc: subprocess.Popen, timeout: float) -> int:
    """lpm_serve's port from its readiness line; raises if it exits or says
    nothing within ``timeout`` seconds."""
    line = {}
    reader = threading.Thread(target=lambda: line.update(text=proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout)
    found = re.search(r"serving .* on :(\d+)", line.get("text", ""))
    if not found:
        raise AssertionError(f"lpm_serve: no readiness line in {timeout} s: {line.get('text')!r}, "
                             f"exit {proc.poll()}")
    return int(found.group(1))


def http_call(port: int, method: str, path: str, body=None) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def cublas_libraries(pid) -> list:
    """The libcublas files mapped into process ``pid``."""
    with open(f"/proc/{pid}/maps") as f:
        return sorted({line.split()[-1] for line in f if "libcublas" in line})


def lpm_serve_answers(port: int, exe, fcfg: FeatureConfig, records: list) -> dict:
    """Requests of HTTP_RECORDS records one after another, and one of 40
    (two batches on lpm_serve's solo path), against the in-process runner
    on the same padded batches: the same classes, scores within the
    rounding."""
    b = exe.batch_size
    requests = [records[i:i + HTTP_RECORDS] for i in range(0, 8 * HTTP_RECORDS, HTTP_RECORDS)] + [records[:40]]
    worst = 0.0
    for recs in requests:
        status, body = http_call(port, "POST", "/predict", frame_records(recs))
        if status != 200:
            raise AssertionError(f"lpm_serve: status {status}: {body[:200]!r}")
        preds = json.loads(body)["predictions"]
        want = []
        for start in range(0, len(recs), b):
            chunk = recs[start:start + b]
            feats, nfs = export_lib.parse_serialized_records(fcfg, chunk + [chunk[-1]] * (b - len(chunk)))
            values, indices = exe.run(feats, nfs)
            want += list(zip(indices[:len(chunk)].tolist(), values[:len(chunk)]))
        if len(preds) != len(recs):
            raise AssertionError(f"lpm_serve: {len(preds)} predictions for {len(recs)} records")
        for i, (p, (classes, scores)) in enumerate(zip(preds, want)):
            gap = float(np.abs(np.asarray(p["scores"], np.float64) - scores).max())
            if p["video_index"] != i or p["classes"] != classes or gap > LPM_SERVE_ROUNDING:
                raise AssertionError(f"lpm_serve: record {i} answered {p['classes'][:5]} (gap {gap}), "
                                     f"the runner {classes[:5]}")
            worst = max(worst, gap)
    return {"requests": len(requests), "records": sum(len(r) for r in requests), "max_abs_score_gap": worst}


def lpm_serve_load(port: int, records: list) -> dict:
    """HTTP_CLIENTS threads each post HTTP_REQUESTS requests of HTTP_RECORDS
    records: requests/s, videos/s, p50/p99 latency (serve_http's load)."""
    latencies, failures = [], []

    def client(c: int):
        for r in range(HTTP_REQUESTS):
            first = (c * HTTP_REQUESTS + r) * HTTP_RECORDS
            body = frame_records([records[(first + j) % len(records)] for j in range(HTTP_RECORDS)])
            t0 = time.perf_counter()
            status, payload = http_call(port, "POST", "/predict", body)
            latencies.append(time.perf_counter() - t0)
            if status != 200 or len(json.loads(payload)["predictions"]) != HTTP_RECORDS:
                failures.append((status, payload[:200]))

    before = json.loads(http_call(port, "GET", "/statz")[1])
    threads = [threading.Thread(target=client, args=(c,)) for c in range(HTTP_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    after = json.loads(http_call(port, "GET", "/statz")[1])
    stats = {key: after[key] - before[key] for key in after}
    n = HTTP_CLIENTS * HTTP_REQUESTS
    if failures or len(latencies) != n or stats["requests"] != n or stats["coalesced"] <= 0:
        raise AssertionError(f"lpm_serve load: failures {failures[:3]}, {len(latencies)} of {n} answered, "
                             f"statz {stats} (coalesced must be > 0)")
    lat = sorted(ms * 1e3 for ms in latencies)
    return {"clients": HTTP_CLIENTS, "requests": n, "videos": stats["rows"], "linger_ms": HTTP_LINGER_MS,
            "wall_s": wall, "requests_per_s": n / wall, "videos_per_s": stats["rows"] / wall,
            "latency_ms_p50": lat[len(lat) // 2], "latency_ms_p99": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "statz": stats, "coalesced_share": stats["coalesced"] / stats["requests"]}


def phase_native_serve(dev, workdir, fp, smi, served: dict, lpm_serve: dict) -> tuple:
    """Item 14b on phase_e2e's Willow tree at full width (the serve phase's
    workdir, fp and measurements):

    (a) export_model(with_stablehlo=True) at batch 32 and 256: seconds and
        weights.bin's bytes; read_artifact's arrays equal bit for bit to fp;
    (b) the runner in-process: ModelServer(native=True) at 32 (warmup, then
        the 96 records) with row 1 and each tail kernel once a batch by the
        runner's counts and no torch-route launch, its scores within
        SERVE_GATE of plain_served_values; the runner's probabilities at 32
        and 256 within NATIVE_GATE of the fused route with kernels on the
        same padded batches, its top-k equal to top_k_exact of its own
        probabilities; a profile of one runner batch;
    (c) the tail kernels (check_tail_kernels);
    (d) the native route's videos/s at 32 and 256 (the median of
        SERVE_ROUNDS over 256 records), the runner's ms a batch, beside the
        fused server's from phase_serve;
    (e) lpm_serve: --check, the answers of the in-process runner on the same
        records, the HTTP load beside serve_http's, /statz coalescing, exit 0
        within LPM_SERVE_SIGTERM_S of SIGTERM.
    Returns (errors, timing, library, launches) for the kernels line."""
    mcfg = ModelConfig()
    fcfg = FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), True, F)
    records = list(tfrecord_io.read_tfrecords(os.path.join(workdir, "videos-0.tfrecord")))
    records256 = [records[i % len(records)] for i in range(max(SERVE_BATCHES))]
    n_batches = -(-len(records) // 32)

    # (a) the artifact
    tree = load_variables_npz(os.path.join(workdir, "train"))
    exports, export_s = {}, {}
    for b in SERVE_BATCHES:
        exports[b] = os.path.join(workdir, f"runner_export_b{b}")
        start = time.perf_counter()
        export_lib.export_model(exports[b], "NetVLADModelLF", mcfg, fcfg, tree["params"], tree["batch_stats"],
                                with_stablehlo=True, stablehlo_batch_size=b)
        export_s[b] = time.perf_counter() - start
    del tree
    manifest, arrays = native_runtime.read_artifact(exports[SERVE_BATCHES[0]])
    bad = []
    for name in native_runtime.ARRAYS[native_runtime.ROUTE]:
        got, want = native_runtime.array_of(arrays, name), native_runtime.array_of(fp, name).cpu()
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(
                got.view(torch.int16 if got.dtype == torch.bfloat16 else torch.int32),
                want.view(torch.int16 if want.dtype == torch.bfloat16 else torch.int32)):
            bad.append(name)
    if bad:
        raise AssertionError(f"native_serve: the artifact's arrays differ from the serve phase's: {bad}")
    del arrays
    emit({"phase": "native_serve", "part": "export", "export_s": export_s,
          "weights_bytes": os.path.getsize(os.path.join(exports[32], native_runtime.WEIGHTS_FILE)),
          "arrays_bit_equal": len(native_runtime.ARRAYS[native_runtime.ROUTE]), "route": manifest["route"],
          "sampling_key": manifest["sampling_key"], "card": smi})

    # (b) in process: the main path through ModelServer(native=True)
    start = time.perf_counter()
    servers = {32: ModelServer(exports[32], 32, native=True, device=dev)}
    load_s = {32: time.perf_counter() - start}
    exe = servers[32]._serve.executable
    reset_counters()
    exe.reset_launches()
    servers[32].warmup()
    pairs = servers[32].predict_pairs(records)
    torch.cuda.synchronize()
    runner_counts, torch_counts = exe.launches(), counters()
    want = {name: n_batches + 1 if name in WILLOW_COUNTERS else 0 for name in native_runtime.COUNTERS}
    if runner_counts != want or any(torch_counts.values()):
        raise AssertionError(f"native_serve: the runner's launches {runner_counts} (expected {want}), the torch "
                             f"route's {torch_counts} (expected none)")
    gaps = {"served_vs_plain": served_gap("native", pairs, plain_served_values(fp, records, fcfg, mcfg, 32, dev),
                                          SERVE_GATE)}
    start = time.perf_counter()
    servers[256] = ModelServer(exports[256], 32, native=True, device=dev)
    load_s[256] = time.perf_counter() - start
    if servers[256].batch_size != 256:
        raise AssertionError(f"native_serve: the export's batch 256 did not override 32: {servers[256].batch_size}")
    fused = build_fast_netvlad_inference(mcfg, return_probs=True)
    prob_gap = {}
    for b, server in servers.items():
        runner = server._serve.executable
        worst = 0.0
        for start in range(0, len(records), b):
            chunk = records[start:start + b]
            feats, nfs = export_lib.parse_serialized_records(fcfg, chunk + [chunk[-1]] * (b - len(chunk)))
            got = runner.probs(feats, nfs)
            with torch.no_grad():
                want_p = fused(fp, torch.from_numpy(feats).to(dev), torch.from_numpy(nfs).to(dev), prng.key(0))
            got_t = torch.from_numpy(got)
            if got.shape != (b, mcfg.vocab_size) or not np.isfinite(got).all():
                raise AssertionError(f"native_serve B={b}: probabilities of shape {got.shape} or non-finite")
            worst = max(worst, (got_t - want_p.float().cpu()).abs().max().item())
            values, indices = runner.run(feats, nfs)
            tv, ti = top_k_exact(got_t, 20)
            if not (np.array_equal(indices, ti.numpy()) and np.array_equal(values.view(np.int32),
                                                                           tv.numpy().view(np.int32))):
                raise AssertionError(f"native_serve B={b}: the runner's top-k is not top_k_exact of its probs")
        prob_gap[f"B={b}"] = worst
    if max(prob_gap.values()) > NATIVE_GATE:
        raise AssertionError(f"native_serve: runner probabilities {prob_gap} from the fused route's, over "
                             f"{NATIVE_GATE}")
    gaps["probs_vs_fused_kernels"] = prob_gap
    launches = {kernel_key(name): runner_counts[name] for name in WILLOW_COUNTERS}
    feats, nfs = export_lib.parse_serialized_records(fcfg, records256)
    emit({"phase": "native_serve", "part": "in_process", "videos": len(records), "batch": 32,
          "load_s": load_s, "max_abs_gap": gaps, "gates": {"probs": NATIVE_GATE, "served": SERVE_GATE},
          "runner_launches": runner_counts, "torch_launches": "none",
          "cublas_in_process": cublas_libraries("self"),
          "profile_B256": profile_device(lambda: servers[256]._serve.executable.run(feats, nfs), reps=5),
          "card": smi})

    # (c) the tail kernels alone
    errors = {}
    timing, library = check_tail_kernels(dev, errors)

    # (d) throughput of the native route in process
    rates = {}
    for b, server in servers.items():
        runner = server._serve.executable
        server.predict_pairs(records256[:b])
        rounds = []
        for _ in range(SERVE_ROUNDS):
            t0 = time.perf_counter()
            server.predict_pairs(records256)
            rounds.append(time.perf_counter() - t0)
        run_s = []
        for start in range(0, len(records256), b):
            t0 = time.perf_counter()
            runner.run(feats[start:start + b], nfs[start:start + b])
            run_s.append(time.perf_counter() - t0)
        wall = statistics.median(rounds)
        rates[f"B={b}"] = {"videos_per_s": len(records256) / wall,
                           "videos_per_s_rounds": [len(records256) / r for r in rounds],
                           "batch_ms": wall * 1e3 * b / len(records256),
                           "runner_ms_per_batch": statistics.median(run_s) * 1e3,
                           "fused_server_videos_per_s": served["throughput"][f"B={b}"]["videos_per_s"]}
    emit({"phase": "native_serve", "part": "throughput", "route": "native", **rates, "card": smi})
    servers[256]._serve.executable.close()
    del servers[256]

    # (e) lpm_serve
    binary = lpm_serve["path"]
    start = time.perf_counter()
    check = subprocess.run([binary, f"--export_dir={exports[32]}", "--check"], capture_output=True, text=True,
                           timeout=300)
    check_s = time.perf_counter() - start
    if check.returncode != 0:
        raise AssertionError(f"lpm_serve --check: exit {check.returncode}: {check.stderr[-2000:]}")
    (pred,) = json.loads(check.stdout)["predictions"]
    if len(pred["classes"]) != 20 or len(pred["scores"]) != 20:
        raise AssertionError(f"lpm_serve --check: {pred}")
    proc = subprocess.Popen([binary, f"--export_dir={exports[32]}", "--port=0",
                             f"--linger_ms={HTTP_LINGER_MS:g}"], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        start = time.perf_counter()
        port = read_ready(proc, 300)
        ready_s = time.perf_counter() - start
        if http_call(port, "GET", "/healthz") != (200, b"ok"):
            raise AssertionError("lpm_serve: /healthz")
        cublas_binary = cublas_libraries(proc.pid)
        answers = lpm_serve_answers(port, exe, fcfg, records)
        web = lpm_serve_load(port, records)
        statz = json.loads(http_call(port, "GET", "/statz")[1])
        start = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=LPM_SERVE_SIGTERM_S)
        stop_s = time.perf_counter() - start
        if code != 0:
            raise AssertionError(f"lpm_serve: exit {code} after SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    emit({"phase": "native_serve", "part": "lpm_serve", "build_s": lpm_serve["seconds"], "check_s": check_s,
          "ready_s": ready_s, "cublas_in_binary": cublas_binary, "answers": answers, **web,
          "python_server_http": {key: served["http"][key] for key in
                                 ("requests_per_s", "videos_per_s", "latency_ms_p50", "latency_ms_p99",
                                  "coalesced_share")},
          "statz_total": statz, "sigterm_exit_s": stop_s, "card": smi})
    exe.close()
    del servers, exe
    torch.cuda.empty_cache()
    return errors, timing, library, launches


# ---- item 14c: the runner's other routes (LogisticModel, MoeModel,
# DbofModel, NetRVLADModelLF, SoftDbofModelLF, NetFVModelLF, NeXtVLADModel,
# TransformerEncoderModel, AttentionNetVLADModel, FrameLevelLogisticModel)

NATIVE_ROUTES_BATCH = 256
# run → (model, config overrides); each at its full default width
NATIVE_ROUTE_RUNS = {
    "LogisticModel": ("LogisticModel", {}),
    "MoeModel": ("MoeModel", {}),
    "DbofModel": ("DbofModel", {}),
    "DbofModel_window": ("DbofModel", dict(sample_random_frames=False)),
    "NetRVLADModelLF": ("NetRVLADModelLF", {}),
    "SoftDbofModelLF": ("SoftDbofModelLF", {}),
    "NetFVModelLF": ("NetFVModelLF", {}),
    "NeXtVLADModel": ("NeXtVLADModel", {}),
    "TransformerEncoderModel": ("TransformerEncoderModel", {}),
    "AttentionNetVLADModel": ("AttentionNetVLADModel", {}),
    "FrameLevelLogisticModel": ("FrameLevelLogisticModel", {}),
    "AttentionPoolingModel": ("AttentionPoolingModel", {}),
    "LstmModel": ("LstmModel", {}),
    "GruModel": ("GruModel", {}),
}
# the runs that lpm_serve answers over HTTP: a video-level route (its
# tf.Example parse), a LOUPE route, the transformer, and of item 14c.5 the
# pooling route and one RNN route (rnn_lstm and rnn_gru share all but the
# cell kernel, which the in-process run holds)
NATIVE_ROUTES_HTTP = ("LogisticModel", "NetRVLADModelLF", "TransformerEncoderModel", "AttentionPoolingModel",
                      "LstmModel")
# the runner's probabilities against the port's torch route on the same
# padded batch of 256 (max |Δ|): the f32 model forward for the video-level
# two, the fast route with its kernels for the bf16 routes (the DBoF window:
# the plain versions on the card, as the torch fast path refuses windows).
# Taken from the first two runs on one H100 at 700 W, which read alike:
# DBoF (both draws), NetRVLAD and NetFV (second run only) equal bit for
# bit, so NATIVE_GATE's 1e-5 (room for cuBLAS to split a sum another way);
# LogisticModel 1.2e-7 and MoeModel 6.0e-8 (the f32 products' and the input
# ℓ2's summation order), 1e-6; SoftDBoW 1.9e-6 (a row-ℓ2 rounding of the
# histogram), 1e-5; NeXtVLAD 2.657e-4 in four runs, 5e-4: its trace
# (NEXTVLAD_TRACE_GATES) puts the whole gap in h's bf16 rounding.  The
# routes that read every frame, from the first two runs on one H100 at 700 W
# (equal readings): TransformerEncoderModel 2.574e-4, 1e-3;
# AttentionNetVLADModel 2.879e-5, 2e-4: their traces (ALL_FRAMES_TRACE_GATES)
# put the whole gap in the residual LayerNorms' sums, whose order moves a
# bf16 rounding of 6.5e-6 of the entries (the kernel check), compounded
# over four of them; FrameLevelLogisticModel 6.0e-8 (the f32 ℓ2's and
# mean's summation order), 1e-6 as the video-level two.  The f32 routes of
# item 14c.5, from the first run on one H100 at 700 W: AttentionPoolingModel
# 1.19e-7, LstmModel 5.96e-8, GruModel 8.94e-8 (the products' summation
# order in cuBLAS against torch's; their traces, ALL_FRAMES_TRACE_GATES,
# read every step within 8.2e-7 of max |torch route|), so 1e-6 each; the
# GRU route on gru_layer (h·W_h summed by FMA in its own fixed order) read
# 5.96e-8, its steps within 9.8e-7, on one H100 at 700 W
NATIVE_ROUTE_GATES = {**dict.fromkeys(NATIVE_ROUTE_RUNS, NATIVE_GATE), "LogisticModel": 1e-6, "MoeModel": 1e-6,
                      "NeXtVLADModel": 5e-4, "TransformerEncoderModel": 1e-3, "AttentionNetVLADModel": 2e-4,
                      "FrameLevelLogisticModel": 1e-6, "AttentionPoolingModel": 1e-6, "LstmModel": 1e-6,
                      "GruModel": 1e-6}
# NeXtVLAD's trace (nextvlad_trace) against the torch route, each step's max
# |Δ| over max |torch route| (rel) and, for the VLAD, its share of entries
# equal; from the first run, on one H100 at 700 W: the expansion and the
# assignment equal bit for bit; the residual within 2.1e-7 (its Σ assign
# summed in another order than torch.sum); the VLAD 99.995 % equal, the
# rest one bf16 step apart (the residual's last bits and the intra-ℓ2's sum
# order move its rounding); the hidden FC of the runner's VLAD through the
# torch product equal to the runner's; so h within 1.1e-4, 1,251 of its
# 262,144 bf16 roundings apart, and the torch tail from the runner's h
# equal to the runner's probabilities.  A wrong group offset, stride or
# affine moves a step by O(1).
NEXTVLAD_TRACE_GATES = {"xt": 0.0, "assign": 0.0, "residual": 1e-6, "vlad": 2 ** -7, "vlad_equal_share": 0.9999,
                        "product": 1e-6, "h": 1e-3, "tail": NATIVE_GATE}
# the routes that read every frame, traced step by step (all_frames_trace)
# against the torch route: each step's max |Δ| over max |torch route|.
# From the first two runs on one H100 at 700 W (equal readings): the staged
# frames and the mask equal bit for bit (bf16), the f32 frames and pool of
# FrameLevelLogisticModel within 2.4e-7 and 1.5e-7 (the ℓ2's and the mean's
# sum order); the encoder's output one bf16 step apart at most (rel 5.5e-3;
# 87 % of the transformer's entries equal, 93 % of AttentionNetVLAD's), the
# pool and the VLAD one step (2.9e-3, 5.6e-3), h 1.2e-3 and 1.8e-3; and each
# step from the runner's own inputs equal bit for bit to the runner's (the
# last FFN2 product and epilogue, the masked mean or row 2, the hidden
# product): the gap enters in the LayerNorms alone (the kernel check reads
# their one-step roundings).  A wrong stride, head or layer moves a step by
# O(1).
ALL_FRAMES_TRACE_GATES = {
    **dict.fromkeys(native_runtime.ATTENTION_ROUTES, {
        "frames": 0.0, "mask": 0.0, "encoder": 2 ** -7, "pooled": 2 ** -7, "vlad": 2 ** -7, "default": 5e-3,
        "ffn2_of_runner_ffn1": 0.0, "pooled_of_runner_encoder": 0.0, "vlad_of_runner_encoder": 0.0,
        "product_of_runner_pool": 0.0}),
    "frame_logistic": {"default": 1e-6},
    # the f32 routes of item 14c.5 (first run, one H100 at 700 W): every step
    # within 8.2e-7 of max |torch route| (the f32 summation orders;
    # plain_run on the card 0 from the RNNs' torch route, 2.2e-7 from the
    # pooling's, whose gating BN it folds); pool_attention on the runner's
    # keys and values 6.4e-8 from its plain version; the runner's carry equal
    # to its own outputs at each row's last frame bit for bit
    "attention_pooling": {"default": 1e-5, "att_of_runner_kv": 1e-6},
    **dict.fromkeys(native_runtime.RNN_ROUTES, {"default": 1e-5, "final_of_runner_seq": 0.0}),
}
# the runner's launches a batch of each route (every route ends in topk)
NATIVE_ROUTE_LAUNCHES = {
    "LogisticModel": dict(row_l2=1, bias_sigmoid=1),
    "MoeModel": dict(row_l2=1, moe_combine=1),
    "DbofModel": dict(frame_stage=1, bias_relu6=2, frame_pool=1, moe_combine=1),
    "NetRVLADModelLF": dict(frame_stage=1, netvlad_fused=2, hidden_sum=1, gating=1, moe_combine=1),
    "SoftDbofModelLF": dict(frame_stage=1, softdbow_fused=2, row_l2=2, hidden_sum=1, gating=1, moe_combine=1),
    "NetFVModelLF": dict(frame_stage=1, netfv_fused=2, hidden_sum=1, gating=1, moe_combine=1),
    "NeXtVLADModel": dict(frame_stage=1, nextvlad_assign=2, nextvlad_residual=2, row_l2=2, hidden_sum=1,
                          gating=1, moe_combine=1),
}
# the encoder of config 5 (two layers): the input projection and four
# products a layer end in bias_act; two residual_layernorms a layer; row 7
# once a layer
ENCODER_LAUNCHES = dict(frame_stage=1, bias_act=1 + 4 * 2, masked_attention=2, residual_layernorm=2 * 2)
NATIVE_ROUTE_LAUNCHES.update({
    "DbofModel_window": NATIVE_ROUTE_LAUNCHES["DbofModel"],
    "TransformerEncoderModel": dict(ENCODER_LAUNCHES, masked_mean=1, hidden_sum=1, gating=1, moe_combine=1),
    "AttentionNetVLADModel": dict(ENCODER_LAUNCHES, netvlad_fused=1, hidden_sum=1, gating=1, moe_combine=1),
    "FrameLevelLogisticModel": dict(frame_stage=1, masked_mean=1, bias_sigmoid=1),
    # the input projection's, the output projection's and the hidden FC's
    # bias; the queries' projection is made at load
    "AttentionPoolingModel": dict(frame_stage=1, bias_act=3, pool_attention=1, gating=1, moe_combine=1),
    # two layers of F steps
    "LstmModel": dict(frame_stage=1, lstm_cell=2 * F, moe_combine=1),
    "GruModel": dict(frame_stage=1, gru_layer=2, moe_combine=1),
})
# each kernel of these routes against its plain version on the card (atol as
# a share of max|ref|, rtol): exact where both do the same f32 operations in
# the same order; one bf16 step (at most 2⁻⁷ of the value) where the plain
# version's reduction order (PyTorch's sums) can move a bf16 rounding, with
# a small share of max|ref| beside it where an output near zero takes a large
# relative error from that order; the f32 tolerance for the softmax's and
# the residual's sum order
ROUTE_KERNEL_GATES = {
    "native_frame_stage": (2 ** -8, 2 ** -7),
    "native_bias_sigmoid": TOLERANCE[torch.float32],
    "native_bias_relu6": (0.0, 0.0),
    "native_frame_pool": (2 ** -8, 2 ** -7),
    "native_row_l2": (2 ** -9, 2 ** -7),
    "native_nextvlad_assign": (1e-5, 2 ** -8),
    "native_nextvlad_residual": TOLERANCE[torch.float32],
    "native_hidden_sum": (0.0, 0.0),
    "native_bias_act": (0.0, 0.0),
    # one bf16 step: the LayerNorm's two sums in another order than
    # torch.mean's (6.5e-6 of the entries a step apart in the first runs)
    "native_residual_layernorm": (2 ** -8, 2 ** -7),
    "native_masked_mean": (2 ** -8, 2 ** -7),
    # the f32 outputs: the f32 tolerance (summation order only)
    "native_frame_stage/all_f32": TOLERANCE[torch.float32],
    "native_masked_mean/logistic_f32": TOLERANCE[torch.float32],
    "native_bias_act/f32": (0.0, 0.0),
    "native_gating": (0.0, 0.0),
    # the cells: PyTorch's element-wise operations in the same order
    "native_lstm_cell": TOLERANCE[torch.float32],
    "native_gru_cell": TOLERANCE[torch.float32],
    # h·W_h's summation order (k in order by FMA against cuBLAS's), over
    # every step of the layer
    "native_gru_layer": TOLERANCE[torch.float32],
    # the dots', the softmax's and the weighted sum's order
    "native_pool_attention": TOLERANCE[torch.float32],
}
# frame_stage's paths off the main path's shape (label → B, F, DT, S, the
# base's byte offset, num_frames): the word path (DT=1152, 4-byte rows), the
# byte path (DT=1151; DT=1152 on a base one byte off the 4-byte grid, a view
# into a larger buffer), each with videos of no frame and of more than F
STAGE_PATH_SHAPES = {
    "words_dt1152": (6, 37, 1152, 5, 0, (0, 1, 37, 42, 20, 3)),
    "bytes_dt1151": (6, 37, 1151, 5, 0, (0, 1, 37, 42, 20, 3)),
    "bytes_dt1152_offset1": (6, 37, 1152, 5, 1, (0, 1, 37, 42, 20, 3)),
}
# nextvlad_residual's shapes (label → B, S·G, K, D′): NeXtVLAD-128's rgb and
# audio modules at B=256 (D′ = λD/G = 256 and 32: float4 streams) and an odd
# one (a tile of 5 clusters after one of 32, D′ = 33: scalar streams)
RESIDUAL_PATH_SHAPES = {"rgb": (256, 240, 128, 256), "audio": (256, 240, 128, 32),
                        "odd_k37_dp33_sg7": (5, 7, 37, 33)}
# frame_stage and nextvlad_residual are timed on this many input sets in
# turn, so that their bytes come from HBM as the bound counts them: frames
# of 88.5 MB a set (the sampled modes draw 8.8 MB of each, eight sets 71 MB
# past the 50 MB L2; the all-frames modes read all of each), the residual's
# 65 MB of agg and assign a set; their time on one set read again beside
STAGE_COLD_SETS, RESIDUAL_COLD_SETS = 8, 4
# kernels timed by CUDA events, not the profiler: a gru_layer launch (about
# 15 ms) holds no host time worth the name, and in the whole script the
# profiler's device clock read it at half of that (7.4 ms, at its bound) on
# one H100 at 700 W, as it reads pool_attention at a third of its time alone
ROUTE_EVENT_TIMED = ("native_gru_layer",)
# the one PyTorch call that computes a timed kernel's function on its
# inputs, where there is one (the other kernels' functions take two calls or
# more): frame_pool's max over S (f32 out; the kernel rounds to bf16 as it
# writes)
ROUTE_LIBRARY_CALLS = {
    "native_frame_pool": lambda x, t: torch.amax(x["pooled_in"], dim=1),
    # the same cells from the same products (gate orders i, f, g, o and r,
    # z, n, as flax's), on step t's inputs (contiguous copies): CUDA kernels
    # only
    "native_lstm_cell": lambda x, t: torch.ops.aten._thnn_fused_lstm_cell(
        x["pre_steps"][t], x["hw_steps"][t], x["c_steps"][t], x["b_h"], x["zero_b4"]),
    "native_gru_cell": lambda x, t: torch.ops.aten._thnn_fused_gru_cell(
        x["gru_pre_steps"][t], x["gru_hw_steps"][t], x["h_steps"][t], x["b_i"], x["b_h3"]),
    # SDPA on the biased heads [B, H, ·, hd] with the boolean key mask
    "native_pool_attention": lambda x, t: torch.nn.functional.scaled_dot_product_attention(
        x["sdpa_q"], x["sdpa_k"], x["sdpa_v"], attn_mask=x["sdpa_mask"]),
}


def stepping(call):
    """A call without arguments that runs ``call(t)`` for t = 0, 1, …, F − 1,
    0, … on successive calls: timed so, a cell reads each call inputs that
    the calls before did not (a step of the pre-activations [B, F, G·H] and
    of F products h·W_h and states, each set larger than the L2), so that
    every byte of the bytes bound comes from HBM."""
    steps = itertools.count()
    return lambda: call(next(steps) % F)


def route_config(name: str, overrides: dict) -> tuple:
    """(ModelConfig, FeatureConfig) of a run at its model's default width:
    the LOUPE four as the inference CLI builds them (lf_config), DBoF and
    the video-level two at ModelConfig's defaults."""
    mcfg = lf_config() if name in FAST_LF_MODELS else ModelConfig()
    mcfg = dataclasses.replace(mcfg, **overrides)
    if native_runtime.MODEL_ROUTES[name] in native_runtime.VIDEO_ROUTES:
        return mcfg, FeatureConfig(("mean_rgb", "mean_audio"), (D_RGB, D_AUD), False)
    return mcfg, FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), True, F)


def torch_route(name: str, tree: dict, mcfg: ModelConfig, fcfg: FeatureConfig, export_dir: str, dev):
    """The port's torch route on the card for the runner's batches:
    ``fn(feats, nfs) → probabilities`` (the weights prepared once): the
    model's f32 forward for native_runtime.F32_ROUTES, else the fast
    route."""
    if native_runtime.MODEL_ROUTES[name] in native_runtime.F32_ROUTES:
        model = create_model(name, mcfg, fcfg.total_size)
        load_flax_variables(model, tree)
        forward = step_lib.inference_forward(model.to(dev).eval(), mcfg, fcfg.frame_features)
        return lambda feats, nfs: forward(torch.from_numpy(feats).to(dev),
                                          None if nfs is None else torch.from_numpy(nfs).to(dev)).float()
    if not mcfg.sample_random_frames:
        manifest, arrays = native_runtime.read_artifact(export_dir)
        arrays = native_runtime.tree_to(arrays, dev)
        return lambda feats, nfs: native_runtime.plain_run(manifest, arrays, feats, nfs, return_probs=True,
                                                           device=dev)
    path = get_fast_path(name)
    fp = path.prepare(convert_flax_variables(tree, mcfg, name), mcfg, device=dev)
    fn = path.build(mcfg, return_probs=True)

    def probs(feats, nfs):
        with torch.no_grad():
            return fn(fp, torch.from_numpy(feats).to(dev), torch.from_numpy(nfs).to(dev), prng.key(0))

    return probs


def lpm_serve_route(binary: str, export_dir: str, exe, fcfg: FeatureConfig, records: list) -> dict:
    """lpm_serve on one artifact: --port=0, its answers against the
    in-process runner's (lpm_serve_answers), exit 0 on SIGTERM."""
    proc = subprocess.Popen([binary, f"--export_dir={export_dir}", "--port=0", f"--linger_ms={HTTP_LINGER_MS:g}"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        start = time.perf_counter()
        port = read_ready(proc, 300)
        ready_s = time.perf_counter() - start
        answers = lpm_serve_answers(port, exe, fcfg, records)
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=LPM_SERVE_SIGTERM_S)
        if code != 0:
            raise AssertionError(f"lpm_serve: exit {code} after SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"ready_s": ready_s, "answers": answers}


# pool_attention's edge shapes beside the default width: (B, F, Q, heads,
# head width, num_frames) — ragged (a head width that is not a multiple of
# 4 takes the 4-byte copies; more than 64 queries two query blocks) with
# videos of 0, 1, F and more frames, and F = 900 past the first design's
# shared memory (Q × F logits), with videos of 0, 1 and F frames
POOL_EDGE_SHAPES = {
    "ragged_f37_q5_hd40": (6, 37, 5, 3, 40, (0, 1, 37, 20, 50, 36)),
    "ragged_f37_q70_hd42": (4, 37, 70, 2, 42, (0, 1, 37, 5)),
    "f900_q64_hd128": (16, 900, 64, 8, 128, (0, 1, 900, 899, 450, 33, 32, 64, 700, 5, 900, 0, 2, 31, 97, 800)),
}


def pool_edge_inputs(dev) -> dict:
    """pool_attention's inputs at POOL_EDGE_SHAPES: label → (q, kv, bkv,
    num_frames, heads)."""
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for label, (b, f, n_q, heads, hd, nf) in POOL_EDGE_SHAPES.items():
        d = heads * hd
        out[label] = (torch.randn((n_q, d), generator=gen, device=dev),
                      torch.randn((b, f, 2 * d), generator=gen, device=dev),
                      torch.randn((2 * d,), generator=gen, device=dev) * 0.1,
                      torch.tensor(nf, dtype=torch.int32, device=dev), heads)
    return {"pool_edges": out}


# gru_layer's checks off the default width: label → (B, F, H, num_frames or
# None for random ones): a width off the 16-unit and 4-float grids and rows
# of no frames and past F; H=2048, whose W_h slice does not fit in shared
# memory and whose 256 tiles outnumber the resident blocks (W_h streamed,
# blocks walking several tiles); B=300, past two 128-row tiles
GRU_EDGE_SHAPES = {
    "ragged_b5_f9_h37": (5, 9, 37, (0, 1, 9, 14, 4)),
    "streamed_b256_f8_h2048": (256, 8, 2048, None),
    "rows_b300_f7_h64": (300, 7, 64, None),
}


def gru_recurrent_kernel(h: int, gen) -> torch.Tensor:
    """W_h [H, 3H]: three orthogonal blocks, as flax's GRUCell initialises
    its recurrent kernel."""
    return torch.cat([torch.linalg.qr(torch.randn((h, h), generator=gen, device=gen.device))[0]
                      for _ in range(3)], dim=1).contiguous()


def gru_edge_inputs(dev) -> dict:
    """gru_layer's inputs at GRU_EDGE_SHAPES: label → (pre, w_h, b_i, b_hn,
    num_frames)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    out = {}
    for label, (b, f, h, nf) in GRU_EDGE_SHAPES.items():
        frames_ = (torch.tensor(nf, dtype=torch.int32, device=dev) if nf is not None else
                   torch.randint(0, f + 3, (b,), generator=gen, device=dev, dtype=torch.int32))
        out[label] = (torch.randn((b, f, 3 * h), generator=gen, device=dev) * 2.0, gru_recurrent_kernel(h, gen),
                      torch.randn((3 * h,), generator=gen, device=dev) * 0.5,
                      torch.randn((h,), generator=gen, device=dev) * 0.5, frames_)
    return out


def gru_layer_work(b: int, f: int, h: int) -> tuple:
    """(bytes, operations) of one GRU layer over F frames: W_h, the biases,
    x·W_i and num_frames read once, the outputs and the carry written once;
    2·B·H·3H operations a step of h·W_h for the F − 1 steps after the first
    (h is 0 before it)."""
    return 4 * (3 * h * h + 4 * h + b * f * 3 * h + b * f * h + b * h + b), 2 * b * h * 3 * h * (f - 1)


def route_kernel_inputs(dev) -> dict:
    """Random inputs of the routes' kernels at the shapes their main path
    gives them at B=256 (Willow's widths, S=30, V=3862; DBoF-8192,
    NeXtVLAD-128's rgb module: λD=2048, G=8, D′=256; SoftDBoW-4096), and
    in their ranges: the pooling takes relu6's outputs, whose means do not
    cancel."""
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, v, c, h = NATIVE_ROUTES_BATCH, 30, 3862, 8192, 1024
    g, k, dp = 8, 128, 256

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = torch.randint(0, 256, (b, F, DT), generator=gen, device=dev, dtype=torch.uint8)
    nf = torch.randint(1, F + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    nf[0], nf[1] = 1, F
    assign = torch.softmax(randn(b * s, g, k, scale=3.0), dim=-1) * torch.sigmoid(randn(b * s, g, 1))
    nf0 = nf.clone()
    nf0[2] = 0  # a padding row of a served batch
    d, ff = 1024, 2048  # config 5's encoder width and FFN
    qkv_y = randn(b * F * 3 * d, scale=2.0)
    enc_x = randn(b * F, d).to(torch.bfloat16)
    hc, n_q, heads = 1024, 64, 8  # the RNNs' cells; AttentionPoolingModel's queries and heads (hd 128)
    pre, hw, c_h = randn(b, F, 4 * hc, scale=2.0), randn(b, 4 * hc, scale=2.0), randn(b, hc)
    b_hn = randn(hc, scale=0.5)
    pool_q, kv, bkv = randn(n_q, d), randn(b, F, 2 * d), randn(2 * d, scale=0.1)
    # gru_layer's: a contiguous [B, F, 3H] x·W_i and flax's kind of W_h
    gru = dict(gru_pre=pre[:, :, :3 * hc].contiguous(), gru_w_h=gru_recurrent_kernel(hc, gen),
               gru_edges=gru_edge_inputs(dev))
    kvb = (kv + bkv).view(b, F, 2, heads, d // heads).permute(2, 0, 3, 1, 4)  # [2, B, H, F, hd]
    # the cells' timed calls: a product h·W_h and a state for each step
    steps_gen = torch.Generator(device=dev).manual_seed(8)
    hw_steps = torch.randn((F, b, 4 * hc), generator=steps_gen, device=dev) * 2.0
    c_steps = torch.randn((F, b, hc), generator=steps_gen, device=dev)
    rnn = dict(pre=pre, pre_steps=pre.transpose(0, 1).contiguous(), hw=hw, b_h=randn(4 * hc, scale=0.5), c=c_h,
               h=torch.tanh(c_h), b_i=randn(3 * hc, scale=0.5), b_hn=b_hn,
               b_h3=torch.cat([torch.zeros(2 * hc, device=dev), b_hn]), zero_b4=torch.zeros(4 * hc, device=dev),
               carry=randn(b, hc),
               gru_pre_steps=pre[:, :, :3 * hc].transpose(0, 1).contiguous(), gru_hw=hw[:, :3 * hc].contiguous(),
               hw_steps=hw_steps, c_steps=c_steps, gru_hw_steps=hw_steps[:, :, :3 * hc].contiguous(),
               h_steps=torch.tanh(c_steps),
               pool_q=pool_q, kv=kv, bkv=bkv, heads=heads,
               sdpa_q=pool_q.view(n_q, heads, -1).permute(1, 0, 2)[None].expand(b, -1, -1, -1).contiguous(),
               sdpa_k=kvb[0].contiguous(), sdpa_v=kvb[1].contiguous(),
               sdpa_mask=native_tail.key_mask(nf0, F).bool()[:, None, None, :],
               g_scale=randn(h, scale=0.2) + 1.0, g_bias=randn(h, scale=0.1))
    return dict(**rnn, **gru, **pool_edge_inputs(dev), x=x, nf=nf, s=s, in_scale=randn(DT, scale=0.1) + 1.0,
                in_bias=randn(DT, scale=0.05),
                nf0=nf0, qkv_y=qkv_y.view(b * F, 3 * d), qkv_b=randn(3 * d, scale=0.1),
                ff_y=qkv_y[:b * F * ff].view(b * F, ff), ff_b=randn(ff, scale=0.1), enc_x=enc_x,
                enc_y=randn(b * F, d).to(torch.bfloat16), ln_s=randn(d, scale=0.2) + 1.0, ln_b=randn(d, scale=0.1),
                enc_mask=native_tail.key_mask(nf0, F).reshape(-1), enc=enc_x.view(b, F, d),
                frames32=native_tail.frame_stage_all_plain(x, nf0, torch.float32)[0],
                logits=randn(b, v, scale=3.0), fc_b=randn(v, scale=0.5), act=randn(b * s, c, scale=3.0),
                c_b=randn(c), pooled_in=torch.clamp(randn(b, s, c, scale=3.0), 0.0, 6.0), hid=randn(b, h, scale=3.0),
                h_b=randn(h),
                vlad=randn(b * k, dp), vscale=randn(k * dp, scale=0.2) + 1.0, vbias=randn(k * dp, scale=0.1),
                bow=randn(b, 4096).abs() * 30.0, video=randn(b, DT),
                lp=randn(b * s, g * k, scale=2.0), gp=randn(b * s, g), a_scale=randn(g * k, scale=0.2) + 1.0,
                a_bias=randn(g * k, scale=0.1), agg=randn(b, k, dp), assign=assign.reshape(b, s, g, k).contiguous(),
                c2=randn(k, dp, scale=0.1), parts=[randn(b, h) for _ in range(4)], bias=randn(h, scale=0.1))


def pool_attention_work(nf: torch.Tensor, frames: int, n_q: int, d: int) -> tuple:
    """(bytes, operations) that pool_attention's function needs on this
    data: the queries, each valid frame's key and value (every frame's
    value for a video of no valid frame, which attends uniformly), the
    output; two operations a multiply-add of the logits over the valid
    frames and of the weighted sum over the frames with weight."""
    valid = torch.clamp(nf, 0, frames).long()
    weighted = int(torch.where(valid > 0, valid, frames).sum())
    return (4 * (n_q * d + (int(valid.sum()) + weighted) * d + nf.shape[0] * n_q * d),
            2 * n_q * d * (int(valid.sum()) + weighted))


def route_kernel_calls(x: dict) -> dict:
    """name → [(check label, kernel call, plain call)], the timed call first,
    with the bytes moved by the timed call beside (each call's inputs read
    once and its outputs written once), or (bytes, operations); the cells'
    then a (kernel, plain) pair that is timed in the first check's place,
    each call on the next step (stepping)."""
    nt = native_tail
    b, s = x["nf"].shape[0], x["s"]
    hc = x["c"].shape[1]
    last = F - 1
    key = prng.key(0)
    rows, gk = x["lp"].shape
    g = x["gp"].shape[1]
    k, dp = x["c2"].shape
    return {
        "native_frame_stage": ([
            ("affine", lambda: nt.frame_stage(x["x"], key, x["nf"], s, x["in_scale"], x["in_bias"]),
             lambda: nt.frame_stage_plain(x["x"], key, x["nf"], s, x["in_scale"], x["in_bias"])),
            ("window", lambda: nt.frame_stage(x["x"], key, x["nf"], s, window=True),
             lambda: nt.frame_stage_plain(x["x"], key, x["nf"], s, window=True)),
            ("all_bf16", lambda: nt.frame_stage_all(x["x"], x["nf0"]),
             lambda: nt.frame_stage_all_plain(x["x"], x["nf0"])),
            ("all_f32", lambda: nt.frame_stage_all(x["x"], x["nf0"], torch.float32),
             lambda: nt.frame_stage_all_plain(x["x"], x["nf0"], torch.float32))],
            None),  # timed by stage_timing
        "native_bias_sigmoid": ([
            ("logistic", lambda: nt.bias_sigmoid(x["logits"], x["fc_b"]),
             lambda: nt.bias_sigmoid_plain(x["logits"], x["fc_b"]))],
            2 * x["logits"].numel() * 4 + x["fc_b"].numel() * 4),
        "native_bias_relu6": ([
            ("cluster_f32", lambda: nt.bias_relu6(x["act"], x["c_b"]), lambda: nt.bias_relu6_plain(x["act"], x["c_b"])),
            ("hidden_bf16", lambda: nt.bias_relu6(x["hid"], x["h_b"], torch.bfloat16),
             lambda: nt.bias_relu6_plain(x["hid"], x["h_b"], torch.bfloat16))],
            2 * x["act"].numel() * 4 + x["c_b"].numel() * 4),
        "native_frame_pool": ([
            ("max", lambda: nt.frame_pool(x["pooled_in"], "max"), lambda: nt.frame_pool_plain(x["pooled_in"], "max")),
            ("average", lambda: nt.frame_pool(x["pooled_in"], "average"),
             lambda: nt.frame_pool_plain(x["pooled_in"], "average"))],
            x["pooled_in"].numel() * 4 + b * x["pooled_in"].shape[2] * 2),
        "native_row_l2": ([
            ("nextvlad_affine", lambda: nt.row_l2(x["vlad"], x["vscale"], x["vbias"]),
             lambda: nt.row_l2_plain(x["vlad"], x["vscale"], x["vbias"])),
            ("softdbow", lambda: nt.row_l2(x["bow"]), lambda: nt.row_l2_plain(x["bow"])),
            ("video_f32", lambda: nt.row_l2(x["video"], dtype=torch.float32),
             lambda: nt.row_l2_plain(x["video"], dtype=torch.float32))],
            x["vlad"].numel() * 6 + 2 * x["vscale"].numel() * 4),
        "native_nextvlad_assign": ([
            ("rgb", lambda: nt.nextvlad_assign(x["lp"], x["a_scale"], x["a_bias"], x["gp"]),
             lambda: nt.nextvlad_assign_plain(x["lp"], x["a_scale"], x["a_bias"], x["gp"]))],
            rows * gk * 4 + rows * g * 4 + 2 * gk * 4 + rows * gk * 6),
        "native_nextvlad_residual": ([
            ("rgb", lambda: nt.nextvlad_residual(x["agg"], x["assign"], x["c2"]),
             lambda: nt.nextvlad_residual_plain(x["agg"], x["assign"], x["c2"]))],
            None),  # timed by stage_timing
        "native_hidden_sum": ([
            ("netfv_four_parts", lambda: nt.hidden_sum(x["parts"], x["bias"], 2, True),
             lambda: nt.hidden_sum_plain(x["parts"], x["bias"], 2, True))],
            None),
        "native_bias_act": ([
            ("qkv", lambda: nt.bias_act(x["qkv_y"], x["qkv_b"]), lambda: nt.bias_act_plain(x["qkv_y"], x["qkv_b"])),
            ("ffn1_relu", lambda: nt.bias_act(x["ff_y"], x["ff_b"], True),
             lambda: nt.bias_act_plain(x["ff_y"], x["ff_b"], True)),
            ("f32", lambda: nt.bias_act(x["ff_y"], x["ff_b"], dtype=torch.float32),
             lambda: nt.bias_act_plain(x["ff_y"], x["ff_b"], dtype=torch.float32))],
            x["qkv_y"].numel() * (4 + 2) + x["qkv_b"].numel() * 4),
        "native_residual_layernorm": ([
            ("ln", lambda: nt.residual_layernorm(x["enc_x"], x["enc_y"], x["ln_s"], x["ln_b"]),
             lambda: nt.residual_layernorm_plain(x["enc_x"], x["enc_y"], x["ln_s"], x["ln_b"])),
            ("ln_zero_pads", lambda: nt.residual_layernorm(x["enc_x"], x["enc_y"], x["ln_s"], x["ln_b"], x["enc_mask"]),
             lambda: nt.residual_layernorm_plain(x["enc_x"], x["enc_y"], x["ln_s"], x["ln_b"], x["enc_mask"]))],
            x["enc_x"].numel() * (2 + 2 + 2) + 2 * x["ln_s"].numel() * 4),
        "native_masked_mean": ([
            ("encoder_bf16", lambda: nt.masked_mean(x["enc"], x["nf0"]), lambda: nt.masked_mean_plain(x["enc"], x["nf0"])),
            ("logistic_f32", lambda: nt.masked_mean(x["frames32"], x["nf0"], torch.float32, False),
             lambda: nt.masked_mean_plain(x["frames32"], x["nf0"], torch.float32, False))],
            # the valid frames' rows only: the kernel reads no pad row
            int(torch.clamp(x["nf0"], 0, F).sum()) * x["enc"].shape[2] * 2 + b * 4 + b * x["enc"].shape[2] * 2),
        "native_gating": ([
            ("f32", lambda: nt.gating(x["parts"][0], x["hid"], x["g_scale"], x["g_bias"], torch.float32),
             lambda: nt.gating_plain(x["parts"][0], x["hid"], x["g_scale"], x["g_bias"], torch.float32))],
            None),
        "native_lstm_cell": ([
            ("step", lambda: nt.lstm_cell(x["pre"][:, last], x["hw"], x["b_h"], x["c"]),
             lambda: nt.lstm_cell_plain(x["pre"][:, last], x["hw"], x["b_h"], x["c"])),
            ("carry_last_step", lambda: nt.lstm_cell(x["pre"][:, last], x["hw"], x["b_h"], x["c"], x["carry"], x["nf0"],
                                                     last, F),
             lambda: nt.lstm_cell_plain(x["pre"][:, last], x["hw"], x["b_h"], x["c"], x["carry"], x["nf0"], last, F)),
            ("carry_first_step", lambda: nt.lstm_cell(x["pre"][:, 0], x["hw"], x["b_h"], x["c"], x["carry"], x["nf0"],
                                                      0, F),
             lambda: nt.lstm_cell_plain(x["pre"][:, 0], x["hw"], x["b_h"], x["c"], x["carry"], x["nf0"], 0, F))],
            4 * (2 * b * 4 * hc + 4 * hc + 3 * b * hc),
            (stepping(lambda t: nt.lstm_cell(x["pre"][:, t], x["hw_steps"][t], x["b_h"], x["c_steps"][t])),
             stepping(lambda t: nt.lstm_cell_plain(x["pre"][:, t], x["hw_steps"][t], x["b_h"], x["c_steps"][t])))),
        "native_gru_cell": ([
            ("step", lambda: nt.gru_cell(x["pre"][:, last, :3 * hc], x["gru_hw"], x["b_i"], x["b_hn"], x["h"]),
             lambda: nt.gru_cell_plain(x["pre"][:, last, :3 * hc], x["gru_hw"], x["b_i"], x["b_hn"], x["h"])),
            ("carry_last_step", lambda: nt.gru_cell(x["pre"][:, last, :3 * hc], x["gru_hw"], x["b_i"], x["b_hn"],
                                                    x["h"], x["carry"], x["nf0"], last, F),
             lambda: nt.gru_cell_plain(x["pre"][:, last, :3 * hc], x["gru_hw"], x["b_i"], x["b_hn"], x["h"],
                                       x["carry"], x["nf0"], last, F)),
            ("carry_first_step", lambda: nt.gru_cell(x["pre"][:, 0, :3 * hc], x["gru_hw"], x["b_i"], x["b_hn"],
                                                     x["h"], x["carry"], x["nf0"], 0, F),
             lambda: nt.gru_cell_plain(x["pre"][:, 0, :3 * hc], x["gru_hw"], x["b_i"], x["b_hn"], x["h"],
                                       x["carry"], x["nf0"], 0, F))],
            4 * (2 * b * 3 * hc + 4 * hc + 2 * b * hc),
            (stepping(lambda t: nt.gru_cell(x["pre"][:, t, :3 * hc], x["gru_hw_steps"][t], x["b_i"], x["b_hn"],
                                            x["h_steps"][t])),
             stepping(lambda t: nt.gru_cell_plain(x["pre"][:, t, :3 * hc], x["gru_hw_steps"][t], x["b_i"], x["b_hn"],
                                                  x["h_steps"][t])))),
        "native_gru_layer": ([
            ("default_width", lambda: nt.gru_layer(x["gru_pre"], x["gru_w_h"], x["b_i"], x["b_hn"], x["nf0"]),
             lambda: nt.gru_layer_plain(x["gru_pre"], x["gru_w_h"], x["b_i"], x["b_hn"], x["nf0"]))] + [
            (label, functools.partial(nt.gru_layer, *args), functools.partial(nt.gru_layer_plain, *args))
            for label, args in x["gru_edges"].items()],
            gru_layer_work(b, F, hc)),
        "native_pool_attention": ([
            ("default_width", lambda: nt.pool_attention(x["pool_q"], x["kv"], x["bkv"], x["nf0"], x["heads"]),
             lambda: nt.pool_attention_plain(x["pool_q"], x["kv"], x["bkv"], x["nf0"], x["heads"]))] + [
            (label, functools.partial(nt.pool_attention, *args), functools.partial(nt.pool_attention_plain, *args))
            for label, args in x["pool_edges"].items()],
            pool_attention_work(x["nf0"], F, *x["pool_q"].shape)),
    }


def stage_calls(x: torch.Tensor, nf: torch.Tensor, s: int, in_scale: torch.Tensor, in_bias: torch.Tensor,
                key=None) -> dict:
    """frame_stage's four modes on frames ``x``: mode → (kernel call, plain
    call): the sampled modes (S=``s``; iid with the folded input BN, one
    window without) and every frame in bf16 and in f32 with the key mask."""
    nt = native_tail
    key = prng.key(0) if key is None else key
    return {
        "affine": (lambda: nt.frame_stage(x, key, nf, s, in_scale, in_bias),
                   lambda: nt.frame_stage_plain(x, key, nf, s, in_scale, in_bias)),
        "window": (lambda: nt.frame_stage(x, key, nf, s, window=True),
                   lambda: nt.frame_stage_plain(x, key, nf, s, window=True)),
        "all_bf16": (lambda: nt.frame_stage_all(x, nf), lambda: nt.frame_stage_all_plain(x, nf)),
        "all_f32": (lambda: nt.frame_stage_all(x, nf, torch.float32),
                    lambda: nt.frame_stage_all_plain(x, nf, torch.float32)),
    }


def stage_bytes(x: torch.Tensor, nf: torch.Tensor, s: int, mode: str, key=None) -> int:
    """The bytes that frame_stage's ``mode`` must move on these inputs: the
    distinct rows drawn (the sampled modes) or every row, read once; the
    frame counts and the affine; the output and the key mask written once."""
    b, f, dt = x.shape
    if mode in ("affine", "window"):
        draw = sequence_indices if mode == "window" else sample_indices
        idx = draw(prng.key(0) if key is None else key, nf, f, s)
        rows = sum(len(torch.unique(r)) for r in idx.cpu())
        return rows * dt + b * 4 + b * s * dt * 2 + (2 * dt * 4 if mode == "affine" else 0)
    return b * f * dt + b * 4 + b * f * dt * (2 if mode == "all_bf16" else 4) + b * f * 4


def residual_inputs(gen, b: int, sg: int, k: int, dp: int) -> tuple:
    """nextvlad_residual's (agg [B, K, D′], assign [B, S·G, 1, K] a softmax
    over K, c2 [K, D′]) from ``gen``."""
    dev = gen.device
    return (torch.randn((b, k, dp), generator=gen, device=dev),
            torch.softmax(torch.randn((b, sg, 1, k), generator=gen, device=dev) * 3.0, dim=-1),
            torch.randn((k, dp), generator=gen, device=dev) * 0.1)


def check_stage_paths(dev, errors: dict) -> dict:
    """frame_stage's four modes at STAGE_PATH_SHAPES and nextvlad_residual
    at RESIDUAL_PATH_SHAPES against their plain versions within
    ROUTE_KERNEL_GATES, the key mask equal bit for bit.  → {check: max
    |Δ|}."""
    gen = torch.Generator(device=dev).manual_seed(12)
    line = {}
    name = "native_frame_stage"
    for label, (b, f, dt, s, offset, nfs) in STAGE_PATH_SHAPES.items():
        buf = torch.randint(0, 256, (offset + b * f * dt,), generator=gen, device=dev, dtype=torch.uint8)
        x = buf[offset:].view(b, f, dt)
        nf = torch.tensor(nfs, dtype=torch.int32, device=dev)
        scale = torch.randn((dt,), generator=gen, device=dev) * 0.1 + 1.0
        bias = torch.randn((dt,), generator=gen, device=dev) * 0.05
        for mode, (kernel, plain) in stage_calls(x, nf, s, scale, bias, prng.key(3)).items():
            got, want = kernel(), plain()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            err = compare(f"{name} {label} {mode}", got[0], want[0],
                          tol=ROUTE_KERNEL_GATES.get(f"{name}/{mode}", ROUTE_KERNEL_GATES[name]))
            if len(got) > 1 and not torch.equal(got[1], want[1]):
                raise AssertionError(f"{name} {label} {mode}: the key mask differs from the plain version's")
            errors[name] = max(errors.get(name, 0.0), err)
            line[f"frame_stage {label} {mode}"] = err
    name = "native_nextvlad_residual"
    for label, shape in RESIDUAL_PATH_SHAPES.items():
        agg, assign, c2 = residual_inputs(gen, *shape)
        err = compare(f"{name} {label}", native_tail.nextvlad_residual(agg, assign, c2),
                      native_tail.nextvlad_residual_plain(agg, assign, c2), tol=ROUTE_KERNEL_GATES[name])
        errors[name] = max(errors.get(name, 0.0), err)
        line[f"nextvlad_residual {label}"] = err
    torch.cuda.synchronize()
    return line


def stage_timing(dev, x: dict) -> dict:
    """frame_stage's four modes at B=256, F=300, S=30 (route_kernel_inputs'
    frames and STAGE_COLD_SETS − 1 more sets) and nextvlad_residual at
    NeXtVLAD-128's rgb and audio widths (RESIDUAL_COLD_SETS sets): the
    kernel and its plain version on the sets in turn, the kernel on one set
    read again, each by kernel_clock; the bound (bytes over the HBM rate).
    → "kernel/mode" → times."""
    gen = torch.Generator(device=dev).manual_seed(13)
    b = x["nf"].shape[0]
    frame_sets = [(x["x"], x["nf0"])] + [
        (torch.randint(0, 256, x["x"].shape, generator=gen, device=dev, dtype=torch.uint8),
         torch.randint(0, F + 1, (b,), generator=gen, device=dev, dtype=torch.int32))
        for _ in range(STAGE_COLD_SETS - 1)]
    sets = [stage_calls(fx, nf, x["s"], x["in_scale"], x["in_bias"]) for fx, nf in frame_sets]
    out = {}
    for mode in sets[0]:
        nbytes = statistics.mean(stage_bytes(fx, nf, x["s"], mode) for fx, nf in frame_sets)
        out[f"native_frame_stage/{mode}"] = {
            "in_turn": kernel_clock(rotating(sets, mode, 0)), "plain_in_turn": kernel_clock(rotating(sets, mode, 1)),
            "one_set": kernel_clock(sets[0][mode][0]), "bound_ms": nbytes / PEAK_BYTES * 1e3}
    del sets, frame_sets
    for label in ("rgb", "audio"):
        res = [residual_inputs(gen, *RESIDUAL_PATH_SHAPES[label]) for _ in range(RESIDUAL_COLD_SETS)]
        sets = [{"k": (functools.partial(native_tail.nextvlad_residual, *r),
                       functools.partial(native_tail.nextvlad_residual_plain, *r))} for r in res]
        agg, assign, c2 = res[0]
        out[f"native_nextvlad_residual/{label}"] = {
            "in_turn": kernel_clock(rotating(sets, "k", 0)), "plain_in_turn": kernel_clock(rotating(sets, "k", 1)),
            "one_set": kernel_clock(sets[0]["k"][0]),
            "bound_ms": (2 * agg.numel() + assign.numel() + c2.numel()) * 4 / PEAK_BYTES * 1e3}
        del res, sets, agg, assign, c2
    torch.cuda.empty_cache()
    return out


def check_route_kernels(dev, errors: dict) -> tuple:
    """Each new kernel of the routes against its plain version on the card
    within ROUTE_KERNEL_GATES at the main path's shapes (the share of
    outputs equal bit for bit printed), and hidden_sum at NetFV's four
    products; the first check's device ms, the plain version's and the bound
    (bytes over the HBM rate; by CUDA events for ROUTE_EVENT_TIMED), and
    ROUTE_LIBRARY_CALLS' device ms.  →
    (timing, shapes, library) for the kernels line."""
    x = route_kernel_inputs(dev)
    timing, line = {}, {}
    library = {name: device_ms(stepping(functools.partial(call, x))) for name, call in ROUTE_LIBRARY_CALLS.items()}
    for name, (checks, nbytes, *stepped) in route_kernel_calls(x).items():
        for label, kernel, plain in checks:
            got, want = kernel(), plain()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            tol = ROUTE_KERNEL_GATES.get(f"{name}/{label}", ROUTE_KERNEL_GATES[name])
            err = max(compare(f"{name} {label}", g_, w_, tol=tol) for g_, w_ in zip(got, want))
            errors[name] = max(errors.get(name, 0.0), err)
            line[f"{name}/{label}"] = {"max_abs_err": err,
                                       "bit_equal_share": float((got[0] == want[0]).float().mean())}
            del got, want
        if nbytes is not None:
            nbytes, ops = nbytes if isinstance(nbytes, tuple) else (nbytes, 0)
            kernel, plain = stepped[0] if stepped else checks[0][1:]
            clock = time_ms if name in ROUTE_EVENT_TIMED else device_ms
            timing[name] = (clock(kernel), clock(plain),
                            max((nbytes / PEAK_BYTES * 1e3, "bytes"), (ops / PEAK_CUDA_CORES * 1e3, "operations")))
    torch.cuda.synchronize()
    emit({"phase": "native_routes", "part": "kernels", "B": NATIVE_ROUTES_BATCH, "checks": line,
          "gates": ROUTE_KERNEL_GATES})
    emit({"phase": "native_routes", "part": "stage_paths", "checks": check_stage_paths(dev, errors),
          "gates": {n: ROUTE_KERNEL_GATES[n] for n in ROUTE_KERNEL_GATES if "frame_stage" in n or "residual" in n}})
    times = stage_timing(dev, x)
    emit({"phase": "native_routes", "part": "stage_times", "B": NATIVE_ROUTES_BATCH, "times": times,
          "input_sets": {"frame_stage": STAGE_COLD_SETS, "nextvlad_residual": RESIDUAL_COLD_SETS}})
    # the kernels line: the main path's first mode, on the sets in turn
    for name, mode in (("native_frame_stage", "affine"), ("native_nextvlad_residual", "rgb")):
        t = times[f"{name}/{mode}"]
        timing[name] = tuple(c["device_ms"] if c["device_ms"] is not None else c["event_ms"]
                             for c in (t["in_turn"], t["plain_in_turn"])) + ((t["bound_ms"], "bytes"),)
    shapes = {
        "native_frame_stage": "B=256, F=300, S=30, DT=1152, uint8 in, folded input BN (LOUPE); window without (DBoF)",
        "native_bias_sigmoid": "[256, 3862] f32 (LogisticModel's logits)",
        "native_bias_relu6": "[7680, 8192] f32 in place (DbofModel-8192's cluster epilogue at B=256, S=30)",
        "native_frame_pool": "[256, 30, 8192] f32 → bf16, max (average also checked)",
        "native_row_l2": "[32768, 256] f32 → bf16 with the folded vlad_bn (NeXtVLAD-128 rgb at B=256)",
        "native_nextvlad_assign": "R=7680, G=8, K=128 (NeXtVLAD-128 rgb at B=256, S=30)",
        "native_nextvlad_residual": "B=256, S·G=240, K=128, D′=256 (NeXtVLAD-128 rgb)",
        "native_bias_act": "[76800, 3072] f32 → bf16 (config 5's QKV epilogue at B=256, F=300; ReLU at FFN1's "
                           "[76800, 2048] also checked)",
        "native_residual_layernorm": "[76800, 1024] bf16 × 2 → bf16 (config 5 at B=256, F=300; × the key mask "
                                     "also checked)",
        "native_masked_mean": "[256, 300, 1024] bf16 → bf16 over the valid frames (config 5's pool); f32 [256, 300, "
                              "1152] over num_frames also checked",
        "native_lstm_cell": "B=256, H=1024: a step's rows of the [256, 300, 4096] f32 x·W_i, h·W_h [256, 4096] → h, "
                            "c (LstmModel's default); the carry at t = 0 and F − 1 also checked; timed on another step, h·W_h and c "
                            "each call",
        "native_gru_cell": "B=256, H=1024: a step's rows of x·W_i (row stride 300·4096), h·W_h [256, 3072] → h "
                           "(GruModel's default); the carry at t = 0 and F − 1 also checked; timed as lstm_cell",
        "native_gru_layer": "B=256, F=300, H=1024, f32: x·W_i [256, 300, 3072] → the outputs [256, 300, 1024] and "
                            "the carry (a GruModel layer), num_frames 1, 300 and 0 included; also checked at "
                            "GRU_EDGE_SHAPES; library: cuDNN's one GRU layer over the route's staged frames "
                            "[256, 300, 1152] (its input product included), TF32 off",
        "native_pool_attention": "B=256, F=300, 64 queries, 8 heads of 128, f32 [256, 300, 2048] keys and values "
                                 "(AttentionPoolingModel's default), num_frames 0 included; also checked at "
                                 "POOL_EDGE_SHAPES (F=37 ragged, F=900)",
    }
    return timing, shapes, library


def trace_diff(runner: torch.Tensor, torch_route: torch.Tensor) -> dict:
    """max |Δ|, that over max |torch route|, and the share of entries equal
    bit for bit, of one step's runner and torch-route values (on the torch
    route's device)."""
    b = torch_route.float()
    a = runner.to(b.device).float()
    d = (a - b).abs().max().item()
    return {"max_abs": d, "rel": d / max(b.abs().max().item(), 1e-30), "equal_share": (a == b).float().mean().item()}


def nextvlad_trace(exe, tree: dict, mcfg: ModelConfig, feats, nfs, dev, got: np.ndarray, want_p) -> dict:
    """NeXtVLAD's gap to the torch route, step by step, on the batch the
    runner ran last: the torch route again with its steps kept
    (fast_lf.nextvlad_pool's trace; its probabilities must equal want_p's
    bit for bit), beside the runner's buffers of that batch (exe.read):
    each modality's expansion xt, assignment, residual, VLAD and hidden-FC
    product, then h (trace_diff each, and the entries of h whose bf16
    rounding differs); the hidden-FC product of the runner's VLAD through
    the torch route's product against the runner's product, and the torch
    intra-ℓ2 of the runner's residual against the runner's VLAD; and the
    torch route's tail from the runner's h against the runner's
    probabilities ``got``; all within NEXTVLAD_TRACE_GATES."""
    name = "NeXtVLADModel"
    fp = fast_lf.prepare_fast_lf_params(convert_flax_variables(tree, mcfg, name), mcfg, name, device=dev)
    m, v = mcfg.moe_num_mixtures, mcfg.vocab_size
    x, nf = torch.from_numpy(feats).to(dev), torch.from_numpy(nfs).to(dev)
    steps, out = [], {}
    with torch.no_grad():
        xs = staged_frames(gather_frames(x, sample_indices(prng.key(0), nf, x.shape[1], mcfg.iterations)),
                           fp["in_scale"], fp["in_bias"], torch.bfloat16)
        parts, start = [], 0
        for entry in fp["mods"]:
            d = entry["cluster"].shape[0]
            steps.append({})
            parts.append(fast_lf.nextvlad_pool(xs[:, :, start:start + d], entry, torch.bfloat16, steps[-1]))
            start += d
        h, _ = native_tail.hidden_sum_plain(parts, fp["hidden_b"], 1, bias_first=True)
        if not torch.equal(gated_moe_tail(fp, h, m, v, torch.bfloat16, 20, True), want_p):
            raise AssertionError("native_routes NeXtVLADModel: the trace's torch route is not the torch route")
        for i, (entry, trace) in enumerate(zip(fp["mods"], steps)):
            mod = {}
            for step, value in trace.items():
                mod[step] = trace_diff(exe.read(f"mods/{i}/{step}", value.shape, value.dtype), value)
            part = exe.read(f"part/{i}", parts[i].shape)
            mod["part"] = trace_diff(part, parts[i])
            vlad = exe.read(f"mods/{i}/vlad", trace["vlad"].shape, trace["vlad"].dtype)
            mod["product_of_runner_vlad_vs_runner_part"] = trace_diff(matmul_f32(vlad.to(dev), entry["w1"]), part)
            residual = exe.read(f"mods/{i}/residual", trace["residual"].shape).to(dev)
            k, dp = entry["c2"].shape
            mod["l2_of_runner_residual_vs_runner_vlad"] = trace_diff(
                native_tail.row_l2_plain(residual.reshape(-1, dp), entry["vscale"], entry["vbias"]).reshape(vlad.shape),
                vlad)
            out[f"mods/{i}"] = mod
        h_runner = exe.read("h", h.shape)
        out["h"] = {**trace_diff(h_runner, h),
                    "bf16_roundings_differ": int((h_runner.to(torch.bfloat16) != h.cpu().to(torch.bfloat16)).sum())}
        tail = gated_moe_tail(fp, h_runner.to(dev), m, v, torch.bfloat16, 20, True)
        out["tail_of_runner_h_vs_runner_probs"] = (tail.cpu() - torch.from_numpy(got)).abs().max().item()
    g = NEXTVLAD_TRACE_GATES
    over = [f"{mod} {step}" for mod, steps in out.items() if mod.startswith("mods/")
            for step, key in (("xt", "xt"), ("assign", "assign"), ("residual", "residual"), ("vlad", "vlad"),
                              ("product_of_runner_vlad_vs_runner_part", "product"))
            if steps[step]["rel"] > g[key]]
    over += [f"{mod} vlad equal share" for mod, steps in out.items()
             if mod.startswith("mods/") and steps["vlad"]["equal_share"] < g["vlad_equal_share"]]
    if out["h"]["rel"] > g["h"] or out["tail_of_runner_h_vs_runner_probs"] > g["tail"]:
        over.append("h or the tail")
    if over:
        raise AssertionError(f"native_routes NeXtVLADModel: the trace is over NEXTVLAD_TRACE_GATES at {over}: {out}")
    return out


def all_frames_trace(exe, export_dir: str, feats, nfs, dev, want_p) -> dict:
    """A route that reads every frame, step by step, on the batch the runner
    ran last: plain_run on the card with its steps kept (its probabilities
    must equal the torch route's want_p bit for bit), each beside the
    runner's buffer of that name (exe.read): the staged frames, the mask,
    the encoder's output, the pool (or the VLAD), the hidden product and h
    (trace_diff each; for h also the entries whose bf16 rounding differs).
    Then each step of the runner's own inputs through the torch step,
    against the runner's output of that step: the last layer's FFN2 product
    and epilogue (the product's summation order alone), the pool (the
    masked mean's, or row 2 on the same inputs) and the hidden product.
    The f32 routes of item 14c.5 (plain_run there within the gate of the
    torch route): the pooling's frames, projections, keys and values,
    attention (and pool_attention's plain version on the runner's keys and
    values), h and gating; an RNN's frames, the top layer's x·W_i and
    outputs (the carry after step 1 and step F) and the final carry, also
    against the runner's own outputs at each row's last frame.
    Every step's rel within ALL_FRAMES_TRACE_GATES."""
    manifest, arrays = native_runtime.read_artifact(export_dir)
    route = manifest["route"]
    steps = {}
    probs = native_runtime.plain_run(manifest, arrays, feats, nfs, return_probs=True, device=dev, trace=steps)
    out, runner = {}, {}
    if route in ("attention_pooling",) + native_runtime.RNN_ROUTES:
        # the model's f32 forward is the torch route here: plain_run folds the
        # gating BN and projects the queries once, so it is held within the gate
        out["plain_run_vs_torch_route"] = trace_diff(probs, want_p)
    elif not torch.equal(probs, want_p):
        raise AssertionError(f"native_routes {route}: the trace's route is not the torch route")
    for name, value in steps.items():
        runner[name] = exe.read(name, value.shape, value.dtype)
        out[name] = trace_diff(runner[name], value)
        if name == "h":
            out[name]["bf16_roundings_differ"] = int((runner[name].to(torch.bfloat16)
                                                      != value.cpu().to(torch.bfloat16)).sum())
    if manifest["route"] in native_runtime.ATTENTION_ROUTES:
        nt = native_tail
        with torch.no_grad():
            last = native_runtime.tree_to(arrays["layers"][-1], dev)
            b, f = feats.shape[:2]
            d = last["w2"].shape[1]
            ffn1 = exe.read("ffn1", (b * f, last["w1"].shape[1]), torch.bfloat16).to(dev)
            out["ffn2_of_runner_ffn1"] = trace_diff(
                nt.bias_act_plain(matmul_f32(ffn1, last["w2"]), last["b2"]),
                exe.read("ffn2", (b * f, d), torch.bfloat16))
            enc = runner["encoder"].to(dev)
            if manifest["route"] == "fast_transformer":
                pool, pool_name = nt.masked_mean_plain(enc, torch.from_numpy(nfs).to(dev)), "pooled"
            else:
                pool = netvlad_fused(enc, *(arrays[k].to(dev) for k in ("cluster", "c_scale", "c_bias", "c2")))
                pool, pool_name = pool.reshape(b, -1), "vlad"
            out[f"{pool_name}_of_runner_encoder"] = trace_diff(pool, runner[pool_name])
            out["product_of_runner_pool"] = trace_diff(
                matmul_f32(runner[pool_name].to(dev), arrays["hidden_w"].to(dev)), runner["part/0"])
    nf = torch.from_numpy(nfs).to(dev)
    if route == "attention_pooling":
        # the kernel alone: pool_attention's plain version on the runner's keys
        # and values against the runner's attention
        with torch.no_grad():
            on_dev = native_runtime.tree_to(arrays, dev)
            att = native_tail.pool_attention_plain(native_runtime.pool_query(on_dev), runner["kv"].to(dev),
                                                   on_dev["bkv"], nf, manifest["attention_heads"])
        out["att_of_runner_kv"] = trace_diff(runner["att"], att)
    if route in native_runtime.RNN_ROUTES:
        seq = runner["seq/last"].to(dev)
        f = seq.shape[1]
        # the carry after the first and the last step, and the runner's carry
        # against its own outputs at each row's last frame (the carry's copy)
        out["seq/last step 1"] = trace_diff(seq[:, 0], steps["seq/last"][:, 0])
        out["seq/last step F"] = trace_diff(seq[:, f - 1], steps["seq/last"][:, f - 1])
        out["final_of_runner_seq"] = trace_diff(
            runner["final"], seq[torch.arange(seq.shape[0], device=dev), native_tail.last_frame(nf, f)])
    gates = ALL_FRAMES_TRACE_GATES[route]
    over = [name for name, d in out.items() if d["rel"] > gates.get(name, gates["default"])]
    if over:
        raise AssertionError(f"native_routes {route}: the trace is over ALL_FRAMES_TRACE_GATES at {over}: {out}")
    return out


def cudnn_rnn_ms(name: str, mcfg: ModelConfig, feats: np.ndarray, nfs: np.ndarray, dev) -> tuple:
    """cuDNN's ``torch.nn.LSTM`` / ``GRU`` (random weights, TF32 off) over
    the batch's frames staged in f32, at the model's layers and cells: the
    device ms of the layers alone, a yardstick for the RNN routes', and for
    the GRU also of its first layer alone (gru_layer's library time; None
    for the LSTM)."""
    lstm = name == "LstmModel"
    cells, layers = (mcfg.lstm_cells, mcfg.lstm_layers) if lstm else (mcfg.gru_cells, mcfg.gru_layers)
    x, _ = native_tail.frame_stage_all_plain(torch.from_numpy(feats).to(dev), torch.from_numpy(nfs).to(dev),
                                             torch.float32)
    out = []
    for n in (layers,) if lstm else (layers, 1):
        rnn = (torch.nn.LSTM if lstm else torch.nn.GRU)(DT, cells, num_layers=n, batch_first=True).to(dev)
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            out.append(time_ms(lambda: rnn(x), reps=3, warmup=1))
        del rnn
    del x
    return out[0], out[1] if len(out) > 1 else None


def phase_native_routes(dev, workdir, smi, lpm_serve: dict) -> tuple:
    """Item 14c on the card: for each NATIVE_ROUTE_RUNS model at its full
    default width (weights from seeded_tree, BN statistics perturbed):

    (a) export_model(with_stablehlo=True) at batch 256 (seconds, bytes of
        weights.bin);
    (b) ModelServer(native=True) on 96 records, one batch (the main path:
        the counters zeroed just before, read just after): the runner's
        launches equal NATIVE_ROUTE_LAUNCHES once a batch and no torch-route
        launch;
    (c) the runner's probabilities on a padded batch of 256 within
        NATIVE_ROUTE_GATES of the port's torch route (torch_route),
        its top-k equal to top_k_exact of its own probabilities;
    (d) videos/s of the runner in process at 256 (the median of five
        batches), beside the torch route's device ms a batch;
    (e) lpm_serve (built in the build phase) answering NATIVE_ROUTES_HTTP
        over HTTP, each answer the in-process runner's;
    then the routes' kernels against their plain versions
    (check_route_kernels).  Returns (errors, timing, shapes, library,
    launches) for the kernels line."""
    b = NATIVE_ROUTES_BATCH
    frame_data = os.path.join(workdir, "routes_frames-0.tfrecord")
    video_data = os.path.join(workdir, "routes_videos-0.tfrecord")
    write_frame_level_fixture(frame_data, 96, seed=5)
    write_video_level_fixture(video_data, 96, seed=6)
    data = {True: list(tfrecord_io.read_tfrecords(frame_data)), False: list(tfrecord_io.read_tfrecords(video_data))}
    launches = dict.fromkeys(KERNELS, 0)
    gru_library_ms = None
    for run, (name, overrides) in NATIVE_ROUTE_RUNS.items():
        t_run = time.perf_counter()
        mcfg, fcfg = route_config(name, overrides)
        records = data[fcfg.frame_features]
        batch = [records[i % len(records)] for i in range(b)]
        tree = seeded_tree(name, mcfg, fcfg)
        export_dir = os.path.join(workdir, f"route_{run}")
        start = time.perf_counter()
        export_lib.export_model(export_dir, name, mcfg, fcfg, tree["params"], tree["batch_stats"],
                                with_stablehlo=True, stablehlo_batch_size=b)
        export_s = time.perf_counter() - start
        manifest = native_runtime.read_manifest(export_dir)

        torch.cuda.synchronize()
        free = torch.cuda.mem_get_info(dev)[0]
        server = ModelServer(export_dir, 32, native=True, device=dev)
        exe = server._serve.executable
        server.warmup()
        runner_bytes = free - torch.cuda.mem_get_info(dev)[0]  # its weights, workspaces and cuBLAS's
        reset_counters()
        exe.reset_launches()
        pairs = server.predict_pairs(records)
        torch.cuda.synchronize()
        runner_counts, torch_counts = exe.launches(), counters()
        n_batches = -(-len(records) // b)
        want = {n: n_batches * ({**NATIVE_ROUTE_LAUNCHES[run], "topk": 1}.get(n, 0)) for n in native_runtime.COUNTERS}
        if runner_counts != want or any(torch_counts.values()):
            raise AssertionError(f"native_routes {run}: the runner's launches {runner_counts} (expected {want}), "
                                 f"the torch route's {torch_counts} (expected none)")
        for n, c in runner_counts.items():
            launches[kernel_key(n)] += c

        feats, nfs = export_lib.parse_serialized_records(fcfg, batch)
        got = exe.probs(feats, nfs)
        if got.shape != (b, mcfg.vocab_size) or not np.isfinite(got).all():
            raise AssertionError(f"native_routes {run}: probabilities of shape {got.shape} or non-finite")
        route_fn = torch_route(name, tree, mcfg, fcfg, export_dir, dev)
        want_p = route_fn(feats, nfs)
        gap = (torch.from_numpy(got) - want_p.float().cpu()).abs().max().item()
        values, indices = exe.run(feats, nfs)
        if name == "NeXtVLADModel":
            trace = nextvlad_trace(exe, tree, mcfg, feats, nfs, dev, got, want_p)
        elif manifest["route"] in native_runtime.ALL_FRAME_ROUTES:
            trace = all_frames_trace(exe, export_dir, feats, nfs, dev, want_p)
        else:
            trace = None
        tv, ti = top_k_exact(torch.from_numpy(got), 20)
        if not (np.array_equal(indices, ti.numpy()) and np.array_equal(values.view(np.int32),
                                                                       tv.numpy().view(np.int32))):
            raise AssertionError(f"native_routes {run}: the runner's top-k is not top_k_exact of its probs")
        first = min(b, len(records))  # the server's first batch holds the same rows in the same places
        if [c for c, _ in pairs[:first]] != indices[:first].tolist():
            raise AssertionError(f"native_routes {run}: the server's classes differ from the runner's on the "
                                 "same records")
        if gap > NATIVE_ROUTE_GATES[run]:
            raise AssertionError(f"native_routes {run}: runner probabilities {gap} from the torch route's, over "
                                 f"{NATIVE_ROUTE_GATES[run]}")

        run_s = []
        for _ in range(6):
            t0 = time.perf_counter()
            exe.run(feats, nfs)
            run_s.append(time.perf_counter() - t0)
        runner_ms = statistics.median(run_s[1:]) * 1e3
        torch_ms = time_ms(lambda: route_fn(feats, nfs), reps=3, warmup=1)
        web = (lpm_serve_route(lpm_serve["path"], export_dir, exe, fcfg, records)
               if run in NATIVE_ROUTES_HTTP else None)
        cudnn_ms, cudnn_layer_ms = (cudnn_rnn_ms(name, mcfg, feats, nfs, dev) if name in ("LstmModel", "GruModel")
                                    else (None, None))
        if name == "GruModel":
            gru_library_ms = cudnn_layer_ms
        emit({"phase": "native_routes", "run": run, "route": manifest["route"], "B": b, "export_s": export_s,
              "weights_bytes": os.path.getsize(os.path.join(export_dir, native_runtime.WEIGHTS_FILE)),
              "runner_device_bytes": runner_bytes, "max_abs_prob_gap_vs_torch_route": gap, "gate": NATIVE_ROUTE_GATES[run],
              "runner_launches": {n: c for n, c in runner_counts.items() if c},
              "torch_launches": "none", "videos_per_s": b / (runner_ms / 1e3), "runner_ms_per_batch": runner_ms,
              "torch_route_ms_per_batch": torch_ms, "cudnn_layers_ms": cudnn_ms, "cudnn_one_layer_ms": cudnn_layer_ms,
              "lpm_serve": web, "trace": trace,
              "seconds": time.perf_counter() - t_run, "card": smi})
        exe.close()
        del server, exe, tree, want_p, route_fn
        shutil.rmtree(export_dir)
        torch.cuda.empty_cache()
    errors = {}
    timing, shapes, library = check_route_kernels(dev, errors)
    library["native_gru_layer"] = gru_library_ms
    return errors, timing, shapes, library, launches


# ---- items 10b and 11: the dropout kernel, the attention family and the RNNs

# flax's rate of the transformer family (--attention_dropout)
DROPOUT_RATE = 0.1
# the shapes at which the kernel's keep mask is held to utils/prng.py's
# bits: the attention weights' [1, 1, F, F], config 5's FFN output at B=256
# ([B·F, D]), and sizes 1, 7, 1,023 and one above 2²⁴
DROPOUT_MASK_SHAPES = ((1, 1, F, F), (256 * F, 1024), (1,), (7,), (1023,), ((1 << 24) + 3,))
# the main path's two calls: nn.Dropout on the FFN output [B·F, D] (the
# timed row) and the attention-weight dropout on [B, H, F, F] under one
# [1, 1, F, F] mask
DROPOUT_FFN_SHAPE, DROPOUT_ATTN_SHAPE = (256 * F, 1024), (256, 8, F, F)
# the attention rule's bit-for-bit checks, in bf16 and f32
DROPOUT_ATTN_CHECK_SHAPE = (64, 8, F, F)
# integer instructions counted for the forward's bound: per mask element the
# hash (20 rounds of add, rotate and xor, five key injections of three adds,
# the two first adds) and the draw (xor, shift, or, subtract, compare): 82,
# at PEAK_INT_OPS; per element the select or product: 1 (f32, at
# PEAK_CUDA_CORES)
DROPOUT_HASH_OPS, DROPOUT_APPLY_OPS = 82, 1


def dropout_bound(n: int, period: int, elt: int, backward: bool = False):
    """Least time (ms) of one dropout launch over ``n`` elements of ``elt``
    bytes under a mask of ``period`` elements: x read and y written once and
    the mask's bits written (the forward) or read (the backward) once over
    the HBM rate; and for the forward the mask's hashes over the integer
    issue rate with the per-element select over the CUDA cores' rate;
    whichever is larger."""
    bytes_ms = (2 * n * elt + 4 * -(-period // 32)) / PEAK_BYTES * 1e3
    ops_ms = 0.0 if backward else (period * DROPOUT_HASH_OPS / PEAK_INT_OPS
                                   + n * DROPOUT_APPLY_OPS / PEAK_CUDA_CORES) * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bit patterns (so −0 differs from +0)."""
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def phase_dropout(dev, smi) -> tuple:
    """The dropout kernel (``csrc/dropout.cu``) against utils/prng.py and its
    plain version, on a key that flax's make_rng hands the first encoder
    layer's FFN dropout:

    - its keep mask (from a forward launch on ones) and the forward's bits
      equal bit for bit to ``prng.bernoulli``'s, which is built from
      ``prng.random_bits`` (the bits as ``pack_mask`` packs it), at every
      DROPOUT_MASK_SHAPES shape;
    - both rules (nn.Dropout's select and the attention's product under a
      [1, 1, F, F] mask over [B, H, F, F]), forward and backward through the
      autograd function (the backward launch reading the forward's bits), x
      in bf16 and f32: equal bit for bit to the plain arithmetic on the
      host's mask, a second forward launch to the first, the backward launch
      on the host mask's bits to the plain arithmetic and to
      ``dropout_from_bits_plain``, and on the inverted bits to the inverted
      mask's arithmetic (the backward reads the bits; it hashes nothing);
    - times at the FFN output of config 5 at B=256 in bf16: the forward and
      the backward launch, each beside its bound, its plain version (the
      forward's host draw included) and one torch call (F.dropout, Philox
      bits, another function; ``native_dropout_backward`` on a bool mask, the
      product by 1/keep_prob, another rounding: context only); the
      attention call's forward and backward beside their bounds; the
      forward kernel's SASS by integer pipe (``kernel_build.sass_opcodes``).
    Returns (errors, timing, library, extra)."""
    key = prng.flax_make_rng(prng.key(17), 1, ("encoder", "layer_0", "Dropout_0"))
    kp = 1.0 - DROPOUT_RATE
    masks = []
    for shape in DROPOUT_MASK_SHAPES:
        start = time.perf_counter()
        want = torch.from_numpy(prng.bernoulli(key, kp, shape))
        host_s = time.perf_counter() - start
        y, bits = dropout_kernel(torch.ones(shape, device=dev), key, kp, shape)
        got = (y != 0).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"dropout mask {shape}: {(got != want).sum().item()} entries differ from prng's")
        if not torch.equal(bits, dropout_ops.pack_mask(want.to(dev))):
            raise AssertionError(f"dropout bits {shape}: the forward's bits are not prng's mask packed")
        masks.append({"shape": list(shape), "kept_share": want.float().mean().item(), "host_draw_s": host_s,
                      "bits_equal": True})
        del y, bits
    gen = torch.Generator(device=dev).manual_seed(11)
    errors, checks = {"dropout": 0.0}, []
    for mode, shape, mask_shape in (("div", DROPOUT_FFN_SHAPE, DROPOUT_FFN_SHAPE),
                                    ("mul", DROPOUT_ATTN_CHECK_SHAPE, (1, 1, *DROPOUT_ATTN_CHECK_SHAPE[2:]))):
        keep = torch.from_numpy(prng.bernoulli(key, kp, mask_shape)).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            g = torch.randn(shape, generator=gen, device=dev).to(dtype)
            xr = x.clone().requires_grad_(True)
            y = dropout_ops.dropout(xr, key, DROPOUT_RATE, mask_shape, mode)
            y.backward(g)
            again, bits = dropout_kernel(x, key, kp, mask_shape, mode)
            host_bits = dropout_ops.pack_mask(keep)
            from_bits = dropout_ops.dropout_from_bits(g, host_bits, kp, mask_shape, mode)
            inverted = dropout_ops.dropout_from_bits(g, dropout_ops.pack_mask(~keep), kp, mask_shape, mode)
            torch.cuda.synchronize()
            want_y, want_g = apply_mask(x, keep, kp, mode), apply_mask(g, keep, kp, mode)
            ok = {"forward": bits_equal(y.detach(), want_y), "backward": bits_equal(xr.grad, want_g),
                  "second_launch": bits_equal(again, y.detach()), "bits": torch.equal(bits, host_bits),
                  "backward_from_host_bits": bits_equal(from_bits, want_g) and bits_equal(
                      from_bits, dropout_ops.dropout_from_bits_plain(g, host_bits, kp, mask_shape, mode)),
                  "backward_from_inverted_bits": bits_equal(inverted, apply_mask(g, ~keep, kp, mode))}
            if not all(ok.values()):
                raise AssertionError(f"dropout {mode} {shape} {dtype}: bit for bit {ok}")
            checks.append({"mode": mode, "shape": list(shape), "dtype": str(dtype), **ok})
            del x, g, xr, y, again, bits, host_bits, from_bits, inverted, want_y, want_g
        torch.cuda.empty_cache()
    x = torch.randn(DROPOUT_FFN_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    _, bits = dropout_kernel(x, key, kp, DROPOUT_FFN_SHAPE)
    ms = time_ms(lambda: dropout_kernel(x, key, kp, DROPOUT_FFN_SHAPE))
    back_ms = time_ms(lambda: dropout_ops.dropout_from_bits(x, bits, kp, DROPOUT_FFN_SHAPE))
    plain_ms = time_ms(lambda: dropout_plain(x, key, kp, DROPOUT_FFN_SHAPE), reps=1, warmup=0)
    back_plain_ms = time_ms(lambda: dropout_ops.dropout_from_bits_plain(x, bits, kp, DROPOUT_FFN_SHAPE))
    library_ms = time_ms(lambda: torch.nn.functional.dropout(x, DROPOUT_RATE, training=True))
    keep = dropout_ops.unpack_mask(bits, DROPOUT_FFN_SHAPE)
    back_library_ms = time_ms(lambda: torch.ops.aten.native_dropout_backward(x, keep, 1.0 / kp))
    bound = dropout_bound(x.numel(), x.numel(), 2)
    back_bound = dropout_bound(x.numel(), x.numel(), 2, backward=True)
    w = torch.rand(DROPOUT_ATTN_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    attn_mask = (1, 1, *DROPOUT_ATTN_SHAPE[2:])
    _, attn_bits = dropout_kernel(w, key, kp, attn_mask, "mul")
    attn_ms = time_ms(lambda: dropout_kernel(w, key, kp, attn_mask, "mul"))
    attn_back_ms = time_ms(lambda: dropout_ops.dropout_from_bits(w, attn_bits, kp, attn_mask, "mul"))
    attn_bound = dropout_bound(w.numel(), int(np.prod(attn_mask)), 2)
    attn_back_bound = dropout_bound(w.numel(), int(np.prod(attn_mask)), 2, backward=True)
    sass = {fn: {k: c[k] for k in ("fma_pipe", "alu_pipe")} for fn, c in
            kernel_build.sass_opcodes("dropout", "dropout_kernel").items()}
    emit({"phase": "dropout", "masks": masks, "checks": checks, "sass_integer_pipes": sass, "card": smi})
    # the launches alone on the profiler's device clock (CUDA events around
    # a call also hold the wrapper's host time before its launch)
    extra = {"backward_ms": back_ms, "backward_plain_ms": back_plain_ms, "backward_bound_ms": back_bound[0],
             "backward_bound_by": back_bound[1], "backward_library_ms": back_library_ms,
             "device_ms": device_ms(lambda: dropout_kernel(x, key, kp, DROPOUT_FFN_SHAPE)),
             "backward_device_ms": device_ms(lambda: dropout_ops.dropout_from_bits(x, bits, kp, DROPOUT_FFN_SHAPE))}
    emit({"phase": "kernel_times", "kernel": "dropout", "shape": list(DROPOUT_FFN_SHAPE), "dtype": "bfloat16",
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound[0], "bound_by": bound[1],
          **extra,
          "attention_call": {"shape": list(DROPOUT_ATTN_SHAPE), "ms": attn_ms, "bound_ms": attn_bound[0],
                             "bound_by": attn_bound[1], "backward_ms": attn_back_ms,
                             "backward_bound_ms": attn_back_bound[0]},
          "library": "torch.nn.functional.dropout (Philox bits: another function); backward: "
                     "aten.native_dropout_backward on a bool mask (g · mask · 1/keep_prob: another rounding)",
          "card": smi})
    del x, w, bits, attn_bits, keep
    torch.cuda.empty_cache()
    return errors, {"dropout": (ms, plain_ms, bound)}, {"dropout": library_ms}, {"dropout": extra}


def dropout_launches_per_step(name: str, mcfg: ModelConfig) -> int:
    """The dropout kernel's launches in one training step of ``name``: per
    encoder layer the attention's and the FFN's, each forward and backward."""
    if name not in FAST_ATTENTION_MODELS or mcfg.attention_dropout == 0.0:
        return 0
    return 2 * 2 * mcfg.transformer_layers


# the train CLI's runs of phase_train_attn_rnn_e2e: run → (model, extra
# flags), each at the JAX package's default width (config 5: D 1024, 8
# heads, two layers, FFN 2048, dropout 0.1; AttentionNetVLAD K=256, hidden
# 1024; attention pooling Q=64; LSTM and GRU two layers of 1024), B=256,
# five bf16 steps (ZOO_STEP_FLAGS)
ATTN_RNN_RUNS = {
    "TransformerEncoderModel": ("TransformerEncoderModel", []),
    "AttentionNetVLADModel": ("AttentionNetVLADModel", []),
    "AttentionPoolingModel": ("AttentionPoolingModel", []),
    "LstmModel": ("LstmModel", []),
    "GruModel": ("GruModel", []),
    "TransformerEncoderModel/bf16_params": ("TransformerEncoderModel", ["--bf16_params"]),
}
# the f32 step-1 check against the CPU runs on the first videos of the CLI's
# first batch: the masks depend on the shape, and a full-width f32 step of
# B=256 on the host's CPU would take minutes a model
ATTN_RNN_CPU_VIDEOS = 16
# the one-step checks on TransformerEncoderModel against the CPU
ATTN_RNN_STEP_MODES = {"use_remat": ["--use_remat"], "grad_accum_steps=2": ["--grad_accum_steps=2"]}
# the fast routes (rows 7 and 2) against the model-forward route, in
# probability
ATTN_FAST_GATE = 1e-2


def attn_rnn_args(name: str, *extra: str) -> tuple:
    """(args, (fcfg, mcfg, tcfg)) of the train CLI for ``name``."""
    args = train.build_parser().parse_args(ZOO_STEP_FLAGS + FRAME_FLAGS + [f"--model={name}", *extra])
    return args, train.configs_from_args(args)


def step1_with_grads(where, args, configs, batch, tree, grad: bool) -> tuple:
    """The first train step's loss on ``where`` and with ``grad`` its
    gradients ({name: f32 tensor}, through the recompute under
    ``--use_remat``); the accumulated step where ``--grad_accum_steps`` > 1,
    which takes its gradients microbatch by microbatch whatever ``grad``."""
    fcfg, mcfg, tcfg = configs
    model = load_flax_variables(create_model(args.model, mcfg, fcfg.total_size), tree).to(where)
    step = TrainStep(CrossEntropyLoss(), tcfg, mcfg, True)
    state = TrainState.create(model, tcfg)
    batch = {k: v.to(where) for k, v in batch.items()}
    if step.accum != 1:
        return float(step.accumulated(state, batch, prng.key(args.seed))[1]), None
    with torch.set_grad_enabled(grad):
        total = step.loss(state, batch, prng.key(args.seed))[0]
        if not grad:
            return float(total), None
        grads = step_lib.gradients(total, model)
    return float(total.detach()), {n: g.float() for (n, _), g in zip(model.named_parameters(), grads)}


def flax_param_dtype(name: str, leaf: str) -> str:
    """The dtype of a parameter leaf of ``name`` in flax's tree under
    --bf16_params: f32 where flax builds the module without param_dtype (the
    input projection, the encoder, the attention pooling, the RNN cells),
    bf16 elsewhere (tests/test_torch_attention_rnn.py holds the port to flax
    leaf for leaf)."""
    f32 = find_class_by_name(name).f32_param_prefixes
    return "float32" if leaf.replace("/", ".").startswith(f32) else "bfloat16"


def phase_train_attn_rnn_e2e(dev, workdir, smi) -> dict:
    """The train CLI for the attention family and the RNNs (ATTN_RNN_RUNS)
    on train_e2e's 512 videos, launch counters zeroed before each run and
    read after.  Gates:

    - five finite losses a run, the last below the first;
    - the dropout kernel launches dropout_launches_per_step a step (8 for
      the two encoder models, none for the others), no other kernel;
    - each model's f32 step-1 loss on the card within ZOO_CPU_GATE of the
      CPU's, on the first ATTN_RNN_CPU_VIDEOS videos of the CLI's first
      batch, same weights and key, dropout included; on
      TransformerEncoderModel also --use_remat and --grad_accum_steps=2
      (ATTN_RNN_STEP_MODES), and remat's step-1 gradients on the card
      within REMAT_GATE of max|g| of the step without it (the recompute
      draws the same masks);
    - under --bf16_params the checkpoint's leaves take flax's dtypes;
    - the eval CLI (--run_once, the model-forward route) reads each
      checkpoint back with a finite GAP, no kernel launched;
    - TransformerEncoderModel and AttentionNetVLADModel: eval --fast_forward
      on the trained checkpoint launches rows 7 (once per layer a batch) and
      2 (once a batch), and the fast route's probabilities lie within
      ATTN_FAST_GATE of the model-forward route's on the same batches
      (attn_fast_vs_model_forward).
    Returns {kernel: launches in the CLI runs}."""
    data = os.path.join(workdir, "train-0.tfrecord")
    small = os.path.join(workdir, "attn-small-0.tfrecord")
    write_frame_level_fixture(small, 64, seed=1)
    batches = load_batches(small, dev, 64)
    none = dict.fromkeys(KERNELS, 0)
    total = dict(none)
    first = None
    for run, (name, extra) in ATTN_RNN_RUNS.items():
        args, configs = attn_rnn_args(name, *extra)
        fcfg, mcfg, tcfg = configs
        train_dir = os.path.join(workdir, "attn_rnn", run.replace("/", "-"))
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        trainer = train.main(ZOO_STEP_FLAGS + FRAME_FLAGS + [f"--model={name}", *extra,
                                                             f"--train_data_pattern={data}",
                                                             f"--train_dir={train_dir}"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = counters()
        want = {**none, "dropout": dropout_launches_per_step(name, mcfg) * tcfg.max_steps}
        if got != want:
            raise AssertionError(f"{run}: launches {got}, expected {want}")
        total["dropout"] += got["dropout"]
        losses = [h["loss"] for h in trainer.history]
        if len(losses) != 5 or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{run}: losses {losses}, want five finite values, the last below the first")
        step = trainer.state.step
        del trainer
        torch.cuda.empty_cache()
        extra_info = {}
        if "--bf16_params" in extra:
            dtypes = {leaf["name"]: leaf["dtype"] for leaf in CheckpointManager(train_dir).manifest(step)["leaves"]}
            bad = [n for n, d in dtypes.items() if n.startswith("params/")
                   and d != flax_param_dtype(name, n[len("params/"):])]
            bad += [n for n, d in dtypes.items() if n.startswith(("batch_stats/", "opt_state/master/"))
                    and d != "float32"]
            if bad:
                raise AssertionError(f"{run}: checkpoint leaves in other dtypes than flax's: {bad[:8]}")
            extra_info["checkpoint_dtypes"] = sorted(set(dtypes.values()))
        eval_flags = FRAME_FLAGS + [f"--model={name}", *extra, "--compute_dtype=bfloat16", "--device=cuda",
                                    "--batch_size=64", "--run_once", f"--train_dir={train_dir}",
                                    f"--eval_data_pattern={small}"]
        reset_counters()
        start = time.perf_counter()
        info = eval_cli.main(eval_flags)
        torch.cuda.synchronize()
        if counters() != none or not np.isfinite(float(info["gap"])):
            raise AssertionError(f"{run}: eval GAP {info['gap']}, launches {counters()}")
        extra_info["eval_s"], extra_info["eval_gap"] = time.perf_counter() - start, float(info["gap"])
        if name in FAST_ATTENTION_MODELS and not extra:
            extra_info["fast_forward"] = attn_fast_vs_model_forward(dev, name, mcfg, train_dir, step, eval_flags,
                                                                    batches)
            for n, c in extra_info["fast_forward"]["launches"].items():
                total[n] += c
        shutil.rmtree(train_dir)
        emit({"phase": "train_attn_rnn_e2e", "run": run, "cli_s": cli_s, "losses": losses, "launches": got, "peak_mem_gib": peak, **extra_info, "card": smi})
        if first is None:
            first = zoo_first_batch(args, configs, data)

    # f32 step 1 on the card against the CPU, dropout included
    start = time.perf_counter()
    batch = {k: v[:ATTN_RNN_CPU_VIDEOS] for k, v in first.items()}
    cpu = {}
    for run, (name, extra) in [(n, ATTN_RNN_RUNS[n]) for n in ATTN_RNN_RUNS if "/" not in n] + [
            (f"TransformerEncoderModel/{m}", ("TransformerEncoderModel", f)) for m, f in ATTN_RNN_STEP_MODES.items()]:
        args, configs = attn_rnn_args(name, *extra, "--compute_dtype=float32")
        tree = zoo_init(args, configs)
        reset_counters()
        grad = run in ("TransformerEncoderModel", "TransformerEncoderModel/use_remat")
        card, card_grads = step1_with_grads(dev, args, configs, batch, tree, grad)
        torch.cuda.synchronize()
        launched = counters()["dropout"]
        host, _ = step1_with_grads(torch.device("cpu"), args, configs, batch, tree, False)
        cpu[run] = {"card": card, "cpu": host, "rel": abs(card - host) / abs(host), "dropout_launches": launched}
        if run == "TransformerEncoderModel":
            plain_grads = card_grads
        if run.endswith("use_remat"):
            gap = max(float((card_grads[n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                      for n, g in plain_grads.items())
            cpu[run]["remat_grad_gap_vs_no_remat"] = gap
            if gap > REMAT_GATE:
                raise AssertionError(f"--use_remat's step-1 gradients {gap} of max|g| from the step without it "
                                     f"(limit {REMAT_GATE}): the recompute drew other masks")
        del card_grads, tree
        torch.cuda.empty_cache()
    emit({"phase": "train_attn_rnn_e2e", "part": "f32_step1_card_vs_cpu", "videos": ATTN_RNN_CPU_VIDEOS,
          "losses": cpu, "seconds": time.perf_counter() - start, "card": smi})
    worst = max(v["rel"] for v in cpu.values())
    if worst > ZOO_CPU_GATE:
        raise AssertionError(f"f32 step-1 losses, card against CPU: {cpu} (limit {ZOO_CPU_GATE})")
    return total


def attn_fast_vs_model_forward(dev, name: str, mcfg: ModelConfig, train_dir: str, step: int, eval_flags,
                               batches) -> dict:
    """eval --fast_forward on the trained ``train_dir`` (launch counts: the
    attention kernel once per layer and, for AttentionNetVLADModel,
    netvlad_fused once a batch), then the fast route's and the model-forward
    route's probabilities on ``batches`` in-process (both bf16): the largest
    gap, gated by ATTN_FAST_GATE.  The comparison takes seeded_tree's
    weights, not the checkpoint's: five steps at the CLI's lr 0.01 drive
    every probability to about 0 (the five models' later losses agree to
    1e-7), where any two routes agree; the spread of the reference's
    probabilities is printed and must exceed 1e-2."""
    none = dict.fromkeys(KERNELS, 0)
    reset_counters()
    info = eval_cli.main(eval_flags + ["--fast_forward"])
    torch.cuda.synchronize()
    got = counters()
    n = len(batches)
    want = {**none, "masked_attention_fused": mcfg.transformer_layers * n,
            **({"netvlad_fused": n} if name == "AttentionNetVLADModel" else {})}
    if got != want or not np.isfinite(float(info["gap"])):
        raise AssertionError(f"{name} eval --fast_forward: launches {got}, expected {want}; GAP {info['gap']}")
    tree = seeded_tree(name, mcfg, FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), True, F))
    path = get_fast_path(name)
    fp = path.prepare(convert_flax_variables(tree, mcfg, name), mcfg, device=dev)
    fast = path.build(mcfg, return_probs=True)
    model = load_flax_variables(create_model(name, mcfg, DT), tree).to(dev).eval()
    forward = step_lib.inference_forward(model, mcfg, True)
    gap, spread = 0.0, 0.0
    for i, (feats, nf, real, _) in enumerate(batches):
        key = prng.fold_in(prng.key(0), i)
        a, b = fast(fp, feats, nf, key).float()[real], forward(feats, nf, key).float()[real]
        gap, spread = max(gap, (a - b).abs().max().item()), max(spread, (b.max() - b.min()).item())
    if gap > ATTN_FAST_GATE or spread <= 1e-2:
        raise AssertionError(f"{name}: --fast_forward {gap} from the model-forward route (limit {ATTN_FAST_GATE}), "
                             f"the reference's probabilities spread over {spread}")
    del fp, model, tree
    torch.cuda.empty_cache()
    return {"launches": got, "eval_gap_trained": float(info["gap"]), "weights": "seeded_tree",
            "max_abs_prob_gap_vs_model_forward": gap, "model_forward_prob_spread": spread}


def phase_train_attn_rnn_throughput(dev, smi):
    """The five models' train step at their default widths, B=256, F=300,
    bf16 compute (ATTN_RNN_RUNS without --bf16_params): videos/s (the median
    of two rounds of two steps; for the RNNs, whose step takes about a
    second, one round of one step), forward, backward and optimizer ms,
    peak memory; torch.profiler over the transformer's step (the top
    kernels, the idle share); then the model-forward inference route
    (make_predict_step, training off) of AttentionPoolingModel, LstmModel
    and GruModel at B=256: videos/s, the median of two rounds."""
    batch = random_train_batch(np.random.default_rng(4), 256, dev)
    tcfg = TrainingConfig(batch_size=256)
    for run, (name, extra) in ATTN_RNN_RUNS.items():
        if extra:
            continue
        mcfg = ModelConfig(compute_dtype="bfloat16")
        line, step = time_train_step(dev, name, mcfg, tcfg, batch, rounds=1 if name in ("LstmModel", "GruModel") else 2)
        emit({"phase": "train_attn_rnn_throughput", "model": name, **line,
              "dropout_launches_per_step": dropout_launches_per_step(name, mcfg), "card": smi})
        if name == "TransformerEncoderModel":
            emit({"phase": "train_attn_rnn_profile", "model": name, "B": 256, "F": F, **profile_device(step, reps=3),
                  "card": smi})
        del step
        torch.cuda.empty_cache()
    fcfg = FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), True, F)
    for name in ("AttentionPoolingModel", "LstmModel", "GruModel"):
        mcfg = ModelConfig(compute_dtype="bfloat16")
        model = load_flax_variables(create_model(name, mcfg, DT), init_variables_np(mcfg, fcfg, model_name=name))
        predict = step_lib.make_predict_step(model.to(dev).eval(), mcfg, True)
        rounds = [time_ms(lambda: predict(batch["features"], batch["num_frames"]), reps=3, warmup=1) for _ in range(2)]
        ms = statistics.median(rounds)
        emit({"phase": "attn_rnn_inference_throughput", "model": name, "route": "model-forward bf16", "B": 256,
              "F": F, "videos_per_s": 256 / (ms / 1e3), "batch_ms": ms,
              "videos_per_s_rounds": [256 / (r / 1e3) for r in rounds], "card": smi})
        del model, predict
        torch.cuda.empty_cache()


# the ingest phase's set: Willow's widths in 8 shards (the readers' unit of
# parallelism), 1-300 frames a video
INGEST_FIXTURE = dict(num_videos=1024, num_shards=8, num_classes=3862, rgb_size=D_RGB, audio_size=D_AUD,
                      max_frames=F, min_frames=1, seed=0)
INGEST_BATCH = 256
INGEST_EPOCHS = 2  # each source's rate over two passes of the set (startup amortised)
INGEST_TRAIN_FLAGS = ["--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
                      "--feature_sizes=1024,128", f"--batch_size={INGEST_BATCH}", "--max_steps=3",
                      "--compute_dtype=bfloat16", "--fused_train_aggregation", "--device=cuda",
                      "--log_every_n_steps=1", "--start_new_model"]
# the train CLI's three other sources; {cache} is the packed cache's directory
INGEST_TRAIN_SOURCES = {"native": ["--use_native_reader", "--num_readers=8"],
                        "packed": ["--packed_cache_dir={cache}"],
                        "grain": ["--use_grain", "--grain_worker_count=4"]}
INGEST_PROFILED = "native"
# the names of rows 3 and 4's CUDA kernels in a trace (csrc/netvlad_train.cu;
# the bf16 forward aggregates with csrc/netvlad_tc.cuh's kernels)
TRAIN_KERNEL_NAMES = {"netvlad_aggregate_forward": ("tc_aggregate",),
                      "netvlad_aggregate_backward": ("tc_bwd_kernel", "tc_bwd_gemm_kernel")}


def drain(batches) -> tuple:
    """Iterate ``batches`` to the end: (seconds, real videos, bytes of the
    batches' arrays)."""
    start = time.perf_counter()
    videos = nbytes = 0
    for batch in batches:
        videos += int((batch["weights"] > 0).sum())
        nbytes += sum(v.nbytes for k, v in batch.items() if k != "video_id")
    return time.perf_counter() - start, videos, nbytes


# the packed cache's builder CLI, and its peak resident memory two ways: the
# most of /proc/self/statm's resident pages sampled every 10 ms, and
# ru_maxrss, clean because the child is a shell's child and not this big
# process's (a fork or exec carries the parent's high-water mark over)
_PACKED_BUILD = """
import os, resource, sys, threading
peak = [0]
def sample():
    while True:
        with open("/proc/self/statm") as f:
            peak[0] = max(peak[0], int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE"))
        threading.Event().wait(0.01)
threading.Thread(target=sample, daemon=True).start()
from learnablepoolingmethods_torch.data import packed_cache
packed_cache.main(sys.argv[1:])
print(peak[0] / 2**20, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024)
"""


def build_packed_cache_child(pattern: str, cache_dir: str) -> dict:
    """The packed cache's builder CLI in a grandchild process (under a
    shell): its seconds and peak resident memory."""
    start = time.perf_counter()
    out = subprocess.run(["sh", "-c", 'exe=$1; code=$2; shift 2; "$exe" -c "$code" "$@"; exit $?', "sh",
                          sys.executable, _PACKED_BUILD, f"--input_pattern={pattern}", f"--output_dir={cache_dir}", "--frame_features",
                          "--num_workers=8"],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"the packed cache's builder failed:\n{out.stderr[-4000:]}")
    sampled, maxrss = (float(x) for x in out.stdout.strip().splitlines()[-1].split())
    return {"seconds": time.perf_counter() - start, "peak_rss_mb_sampled": sampled, "ru_maxrss_mb": maxrss}


def source_train_loops(dev, pattern: str, cache_dir: str, steps: int) -> dict:
    """The train CLI's loop without its per-step logging (each batch to the
    card, TrainStep) for ``steps`` steps through each INGEST_TRAIN_SOURCES
    source, the batches from the CLI's own Trainer._batches, the first
    read included: videos/s per source, one model for all."""
    def cli_args(flags):
        return train.build_parser().parse_args(INGEST_TRAIN_FLAGS + [f.format(cache=cache_dir) for f in flags] + [
            f"--train_data_pattern={pattern}", "--train_dir=unused"])

    args = cli_args([])
    fcfg, mcfg, tcfg = train.configs_from_args(args)
    model = create_model(args.model, mcfg, fcfg.total_size)
    load_flax_variables(model, init_variables_np(mcfg, fcfg, seed=0, model_name=args.model)).to(dev)
    state = TrainState.create(model, tcfg)
    step = TrainStep(CrossEntropyLoss(), tcfg, mcfg, fcfg.frame_features)
    key = prng.key(0)

    def to_card(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items() if k != "video_id"}

    step(state, to_card(next(train.Trainer(args)._batches(fcfg, mcfg, tcfg))), key)  # warm up
    torch.cuda.synchronize()
    loops = {}
    for source, flags in INGEST_TRAIN_SOURCES.items():
        start = time.perf_counter()
        for i, batch in enumerate(train.Trainer(cli_args(flags))._batches(fcfg, mcfg, tcfg)):
            if i == steps:
                break
            step(state, to_card(batch), key)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        loops[source] = {"steps": steps, "seconds": seconds, "videos_per_s": steps * INGEST_BATCH / seconds}
    del model, state
    torch.cuda.empty_cache()
    return loops


def trace_device_ops(path: str) -> dict:
    """A Chrome trace's kernels: {name: total ms}, and the device's idle share
    between the first kernel's start and the last one's end."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel" and "dur" in e]
    if not events:
        raise AssertionError(f"the trace {path} holds no kernel")
    by_name = {}
    busy, spans = 0.0, sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    reach = spans[0][0]
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    for start, end in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return {"kernels_ms": by_name, "idle_share": 1.0 - busy / (reach - spans[0][0]),
            "window_ms": (reach - spans[0][0]) / 1e3}


def phase_ingest(dev, workdir, smi, device_rates: dict) -> dict:
    """Item 7 on the card's host: each ingest source's videos/s and MB/s on
    INGEST_FIXTURE beside the device's rates of this run, the train CLI's
    loop without its logging through each of its sources, then the train CLI
    (3 bf16 fused steps, rows 3-4) through each of its three other sources
    (one of them under --profile_dir, whose trace must name rows 3-4's
    kernels), the inference CLI (--fast_infer, row 1) through the default
    source and --packed_cache_dir (the CSVs equal byte for byte), and the
    eval CLI through --use_grain (GAP equal to the default source's).
    Returns the launches of its CLI runs."""
    shards = os.path.join(workdir, "shards")
    start = time.perf_counter()
    paths = write_frame_level_shards(shards, **INGEST_FIXTURE)
    fixture = {"seconds": time.perf_counter() - start, "videos": INGEST_FIXTURE["num_videos"],
               "files": len(paths), "record_mb": sum(os.path.getsize(p) for p in paths) / 1e6}
    pattern = os.path.join(shards, "*.tfrecord")
    n = INGEST_FIXTURE["num_videos"]
    cache_dir = os.path.join(workdir, "packed")
    reader = YT8MFrameFeatureReader(feature_names=("rgb", "audio"))
    e = INGEST_EPOCHS
    runs = {
        "python_reader": lambda: batch_iterator(reader, pattern, INGEST_BATCH, num_epochs=e),
        "native_num_readers_1": lambda: native_batch_iterator(pattern, INGEST_BATCH, True, num_epochs=e,
                                                              num_workers=1),
        "native_num_readers_8": lambda: native_batch_iterator(pattern, INGEST_BATCH, True, num_epochs=e,
                                                              num_workers=8),
        "packed_build": None,
        "packed_epochs": lambda: packed_cache.packed_batch_iterator(cache_dir, INGEST_BATCH, num_epochs=e),
        "grain_workers_0": lambda: grain_batch_iterator(pattern, INGEST_BATCH, True, num_epochs=e,
                                                        worker_count=0),
        "grain_workers_4": lambda: grain_batch_iterator(pattern, INGEST_BATCH, True, num_epochs=e,
                                                        worker_count=4),
    }
    sources = {}
    for name, make in runs.items():
        if make is None:
            line = build_packed_cache_child(pattern, cache_dir)
            seconds, videos, epochs = line["seconds"], len(packed_cache.PackedCache(cache_dir)), 1
        else:
            seconds, videos, nbytes = drain(make())
            line = {"seconds": seconds, "batch_mb_per_s": nbytes / 1e6 / seconds}
            epochs = e
        if videos != epochs * n:
            raise AssertionError(f"{name} delivered {videos} videos of {epochs * n}")
        rate = videos / seconds
        line.update(videos_per_s=rate, record_mb_per_s=epochs * fixture["record_mb"] / seconds,
                    **{f"share_of_{k}": rate / v for k, v in device_rates.items()})
        sources[name] = line
    loops = source_train_loops(dev, pattern, cache_dir, steps=e * n // INGEST_BATCH)
    for line in loops.values():
        line["share_of_train_step_b256"] = line["videos_per_s"] / device_rates["train_step_b256"]
    emit({"phase": "ingest_rates", "host_cpus": os.cpu_count(), "fixture": fixture, "batch": INGEST_BATCH,
          "epochs": e, "device_videos_per_s": device_rates, "sources": sources, "train_loops": loops,
          "card": smi})

    none = dict.fromkeys(KERNELS, 0)
    launches = dict(none)
    trains = {}
    for source, flags in INGEST_TRAIN_SOURCES.items():
        train_dir = os.path.join(workdir, f"train_{source}")
        argv = INGEST_TRAIN_FLAGS + [f.format(cache=cache_dir) for f in flags] + [
            f"--train_data_pattern={pattern}", f"--train_dir={train_dir}"]
        if source == INGEST_PROFILED:
            argv.append(f"--profile_dir={os.path.join(workdir, 'trace')}")
        reset_counters()
        start = time.perf_counter()
        trainer = train.main(argv)
        torch.cuda.synchronize()
        got = counters()
        losses = [h["loss"] for h in trainer.history]
        want = {**none, **{name: 2 * 3 for name in TRAIN_KERNELS}}
        if got != want or len(losses) != 3 or not all(np.isfinite(losses)):
            raise AssertionError(f"train CLI via {source}: launches {got} (want {want}), losses {losses}")
        trains[source] = {"cli_s": time.perf_counter() - start, "losses": losses,
                          "videos_per_s_steps_2_3": [h["examples_per_sec"] for h in trainer.history[1:]]}
        for name in TRAIN_KERNELS:
            launches[name] += got[name]
        if source == INGEST_PROFILED:
            ops = trace_device_ops(trainer.trace_path)
            missing = {row: names for row, names in TRAIN_KERNEL_NAMES.items()
                       if not all(any(name in op for op in ops["kernels_ms"]) for name in names)}
            if missing:
                raise AssertionError(f"the --profile_dir trace names no kernel of {missing}")
            top = dict(sorted(ops["kernels_ms"].items(), key=lambda kv: -kv[1])[:5])
            trains[source]["trace"] = {"file": os.path.basename(trainer.trace_path),
                                       "top5_device_ms": top, "idle_share": ops["idle_share"],
                                       "window_ms": ops["window_ms"]}
        if source != "native":
            shutil.rmtree(train_dir)

    # the native run's checkpoint through the inference and eval CLIs
    train_dir = os.path.join(workdir, "train_native")
    csvs, infers = {}, {}
    for source, flags in (("default", []), ("packed", [f"--packed_cache_dir={cache_dir}"])):
        out_csv = os.path.join(workdir, f"predictions_{source}.csv")
        reset_counters()
        start = time.perf_counter()
        written = inference.main(["--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
                                  "--feature_sizes=1024,128", f"--input_data_pattern={pattern}",
                                  f"--train_dir={train_dir}", f"--output_file={out_csv}",
                                  f"--batch_size={INGEST_BATCH}", "--fast_infer", "--device=cuda", *flags])
        torch.cuda.synchronize()
        got = counters()
        want = {**none, "netvlad_frontend": -(-n // INGEST_BATCH)}
        if got != want or written != n:
            raise AssertionError(f"inference via {source}: {written} rows, launches {got} (want {want})")
        launches["netvlad_frontend"] += got["netvlad_frontend"]
        with open(out_csv, "rb") as f:
            csvs[source] = f.read()
        infers[source] = {"cli_s": time.perf_counter() - start, "csv_bytes": len(csvs[source])}
    if csvs["default"] != csvs["packed"] or csvs["default"].count(b"\n") != n + 1:
        raise AssertionError("the inference CLI's CSVs through the default source and the packed cache differ")
    evals = {}
    for source, flags in (("default", []), ("grain", ["--use_grain"])):
        reset_counters()
        start = time.perf_counter()
        info = eval_cli.main(["--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
                              "--feature_sizes=1024,128", f"--eval_data_pattern={pattern}",
                              f"--train_dir={train_dir}", f"--batch_size={INGEST_BATCH}", "--fast_forward",
                              "--run_once", "--device=cuda", *flags])
        torch.cuda.synchronize()
        got = counters()
        if got != {**none, "netvlad_frontend": -(-n // INGEST_BATCH)} or not np.isfinite(info["gap"]):
            raise AssertionError(f"eval via {source}: launches {got}, GAP {info['gap']}")
        launches["netvlad_frontend"] += got["netvlad_frontend"]
        evals[source] = {"cli_s": time.perf_counter() - start, "gap": info["gap"], "avg_loss": info["avg_loss"]}
    if evals["default"]["gap"] != evals["grain"]["gap"]:
        raise AssertionError(f"eval GAP through --use_grain {evals['grain']['gap']!r} differs from the "
                             f"default source's {evals['default']['gap']!r}")
    emit({"phase": "ingest_cli", "train": trains, "inference": infers, "csv_equal": True, "eval": evals,
          "launches": launches, "card": smi})
    return launches


# data_parallel: Willow NetVLADModelLF at full width in f32 with
# --fused_train_aggregation (rows 3-4), B=256, lr 1e-4.  (a) three steps of
# the mesh step on one rank under NCCL against the plain TrainStep, bit for
# bit; (b) two steps on a 2×1 data mesh and on a 1×2 model mesh of two ranks
# on the one card over gloo (NCCL refuses two ranks on one device) against
# the plain run's first two; the eval CLI with --model_parallelism=2 over the
# two ranks against one process; the train CLI under torchrun.  The gloo
# runs check correctness only: their times are not a speed of the card.
DP_BATCH, DP_STEPS, DP_LR = 256, 3, 1e-4
# each step's loss within LOSS_GATES' f32 limit of the plain run's
DP_LOSS_GATE = LOSS_GATES[1][2]
# the parameters after two steps: Adam moves an entry by about lr·sign(g) a
# step, so an entry whose gradient is rounding noise may move the other way
# on the mesh.  Set from the H100 readings of both meshes (max |Δ| 1.35e-5
# and 1.36e-5; 2 and 3 of 306.6M entries past lr/10): no entry farther than
# 5e-5 from the plain run's, and at most `max_over` entries past lr/10
DP_PARAM_GATE = dict(max_abs=5e-5, over=DP_LR / 10, max_over=100)
# the eval CLI's scores over two ranks against one process
DP_EVAL_GATE = 1e-5
DP_EVAL_VIDEOS = 128
DP_TRAIN_CLI_FLAGS = ["--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
                      "--feature_sizes=1024,128", "--batch_size=32", "--max_steps=2", "--device=cuda",
                      "--fused_train_aggregation", "--netvlad_cluster_size=64", "--netvlad_hidden_size=256",
                      "--log_every_n_steps=1", "--start_new_model"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_config() -> tuple:
    """Willow NetVLADModelLF in f32 with the training kernels, as the train
    CLI builds it (presampled: the step gathers the frames)."""
    mcfg = ModelConfig(fused_train_aggregation=True, presampled=True)
    fcfg = FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), True, F)
    return mcfg, fcfg, TrainingConfig(batch_size=DP_BATCH, base_learning_rate=DP_LR)


def dp_batches(n: int, b: int = DP_BATCH) -> list:
    """``n`` global batches of ``b`` synthetic videos as host arrays."""
    rng = np.random.default_rng(16)
    return [{"features": rng.integers(0, 256, (b, F, DT), dtype=np.uint8),
             "num_frames": rng.integers(1, F + 1, b).astype(np.int32),
             "labels": (rng.random((b, 3862)) < 0.002).astype(np.float32),
             "weights": np.ones(b, np.float32)} for _ in range(n)]


def dp_train(dev, tree, batches, mesh=None, after_step=None) -> tuple:
    """The train step over ``batches`` (each rank its rows of the global
    batch on a mesh) from ``tree`` → (losses, per-step ms by CUDA events,
    the TrainState, the names of the split parameters)."""
    mcfg, _, tcfg = dp_config()
    model = load_flax_variables(create_model("NetVLADModelLF", mcfg, DT), tree).to(dev)
    split = mesh_lib.shard_model(model, mesh) if mesh is not None else []
    state = TrainState.create(model, tcfg)
    step = TrainStep(CrossEntropyLoss(), tcfg, mcfg, True, mesh=mesh)
    losses, ms = [], []
    for i, batch in enumerate(batches):
        rows = mesh_lib.local_batch(batch, mesh) if mesh is not None else batch
        device_batch = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(state, device_batch, prng.key(0))
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        if after_step is not None:
            after_step(i + 1, state)
    return losses, ms, state, split


def dp_kernel_checks(dev) -> dict:
    """The kernels' offsets for a rank's rows, against their plain
    versions: the front end's frames drawn from row 128 on (within the
    bf16 tolerance of phase 3, and equal bit for bit to the same rows of a
    launch over the whole batch), the dropout mask from row 64 on (bit for
    bit), and FusedAdam's two-entry route with an identity reduction equal
    bit for bit to its single entry and within phase fused_adam's bounds of
    its plain version.  These launches are checks, not the main path."""
    rng = np.random.default_rng(21)
    out = {}
    consts = frontend_consts(rng, dev)
    x, nf = frames(rng, 192, dev)
    key = prng.key(4)
    whole = netvlad_frontend(x, key, nf, 30, *consts)
    part = netvlad_frontend(x[128:].contiguous(), key, nf[128:], 30, *consts, row_offset=128)
    want = netvlad_frontend_reference(x[128:], key, nf[128:], 30, *consts, row_offset=128)
    out["netvlad_frontend_row_offset"] = max(compare(f"frontend row_offset {i}", g, w) for i, (g, w) in
                                             enumerate(zip(part, want)))
    if not all(bits_equal(a[128:], b) for a, b in zip(whole, part)):
        raise AssertionError("data_parallel: the front end's rows from 128 differ from a whole batch's")
    xd = torch.from_numpy(rng.normal(size=(32, F, 1024)).astype(np.float32)).to(dev, torch.bfloat16)
    kp = 1.0 - DROPOUT_RATE
    offset = 64 * F * 1024
    got, bits = dropout_kernel(xd, key, kp, tuple(xd.shape), "div", offset)
    if not (bits_equal(got, dropout_plain(xd, key, kp, tuple(xd.shape), "div", offset)) and torch.equal(
            bits, dropout_ops.pack_mask(dropout_ops.keep_mask(key, kp, tuple(xd.shape), dev, offset)))):
        raise AssertionError("data_parallel: the dropout kernel's mask at an offset differs from the plain one")
    out["dropout_offset"] = 0.0
    leaves = [(f"leaf{i}", [torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev, dt)
                            for dt in (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.bfloat16)])
              for i, n in enumerate((1 << 20, 8193, 7))]
    for _, leaf in leaves:
        leaf[3].abs_()
    consts_adam = AdamConsts(1e-3, 2)
    single = run_fused_adam(fused_adam_kernel, leaves, consts_adam, 1.0)
    split = run_fused_adam(functools.partial(fused_adam_kernel, reduce_sumsq=lambda sq: sq), leaves, consts_adam, 1.0)
    if not all(bits_equal(a, b) for sa, sb in zip(single, split) for a, b in zip(sa[1:], sb[1:])):
        raise AssertionError("data_parallel: FusedAdam's two entry points differ from its single one")
    plain = run_fused_adam(functools.partial(fused_adam_plain, reduce_sumsq=lambda sq: sq), leaves, consts_adam, 1.0)
    if not all(bits_equal(a[2], b[2]) for a, b in zip(split, plain)):
        raise AssertionError("data_parallel: FusedAdam's two-entry m differs from its plain version's")
    out["fused_adam_split_p"] = max((a[1].float() - b[1].float()).abs().max().item() for a, b in zip(split, plain))
    return out


def dp_param_gap(model, ref, mesh) -> dict:
    """max |Δ| and the count of entries past DP_PARAM_GATE["over"] between
    the model's parameters (this rank's columns of a split one) and the
    reference's (``ref``: name → (array or tensor,), as a checkpoint's
    ``load_arrays``); a whole parameter counted on rank 0 only, a split one
    on the ranks of data index 0."""
    worst, over, entries = 0.0, 0, 0
    for name, p in model.named_parameters():
        shard = column_shard(p)
        if (shard is None and mesh.rank != 0) or (shard is not None and mesh.data_index != 0):
            continue
        want = torch.as_tensor(ref["params/" + name.replace(".", "/")][0]).to(p.device)
        if shard is not None:
            want = want[..., shard.columns]
        diff = (p.detach().float() - want.float()).abs()
        worst = max(worst, diff.max().item())
        over += int((diff > DP_PARAM_GATE["over"]).sum())
        entries += diff.numel()
    return {"max_abs": worst, "over": over, "entries": entries}


def data_parallel_worker(spec_path: str) -> int:
    """One rank of phase_data_parallel's gloo runs, launched by torchrun
    with two ranks on cuda:0: the 2×1 data mesh and the 1×2 model mesh for
    two steps each, their losses and parameter gaps against the one-process
    checkpoint, then the eval CLI of ``spec["eval_argv"]``; rank 0 writes
    every rank's numbers to ``spec["out"]``."""
    import torch.distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    # NCCL refuses two ranks on one device: a gloo group, which
    # distributed_init and the eval CLI then keep
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    dev = mesh_lib.distributed_init("cuda:0")
    mcfg, fcfg, _ = dp_config()
    tree = init_variables_np(mcfg, fcfg, seed=0, model_name="NetVLADModelLF")
    data = np.load(spec["batches"])
    batches = [{k: data[f"b{i}_{k}"] for k in ("features", "num_frames", "labels", "weights")} for i in range(2)]
    ref = CheckpointManager(spec["train_dir"]).load_arrays(2, ("params/",))
    out = {"rank": dist.get_rank()}
    for name, model_axis in (("data_2x1", 1), ("model_1x2", 2)):
        mesh = mesh_lib.create_mesh(model_parallelism=model_axis)
        reset_counters()
        t0 = time.perf_counter()
        losses, _, state, split = dp_train(dev, tree, batches, mesh)
        torch.cuda.synchronize()
        out[name] = {"losses": losses, "seconds": time.perf_counter() - t0, "split": split,
                     "launches": {k: KERNELS[k]["fn"].launches for k in TRAIN_KERNELS},
                     **dp_param_gap(state.model, ref, mesh)}
        del state
        torch.cuda.empty_cache()
    reset_counters()
    t0 = time.perf_counter()
    info = eval_cli.main(spec["eval_argv"])
    out["eval"] = {"seconds": time.perf_counter() - t0,
                   "scores": {k: float(info[k]) for k in EVAL_METRICS} if info is not None else None}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, out)
    if dist.get_rank() == 0:
        with open(spec["out"], "w") as f:
            json.dump(ranks, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_data_parallel(dev, workdir, smi) -> dict:
    """Item 15 on the card (module docstring, DP_*): returns the training
    kernels' launches of the mesh runs."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    kernel_checks = dp_kernel_checks(dev)
    mcfg, fcfg, _ = dp_config()
    batches = dp_batches(DP_STEPS)
    tree = init_variables_np(mcfg, fcfg, seed=0, model_name="NetVLADModelLF")
    batches_path = os.path.join(workdir, "dp_batches.npz")
    np.savez(batches_path, **{f"b{i}_{k}": v for i, b in enumerate(batches[:2]) for k, v in b.items()})
    train_dir = os.path.join(workdir, "dp_one")
    mngr = CheckpointManager(train_dir)

    def save_step_2(step, state):
        if step == 2:
            mngr.save(step, state.state_tree())

    # (a) the mesh step on one rank under NCCL against the plain step
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        probe = torch.ones(4, device=dev)
        dist.all_reduce(probe)  # the NCCL communicator of a world of one
        mesh = mesh_lib.create_mesh()
        plain = dp_train(dev, tree, batches, after_step=save_step_2)
        reset_counters()
        meshed = dp_train(dev, tree, batches, mesh)
        launches = counters()
    finally:
        dist.destroy_process_group()
    if plain[0] != meshed[0]:
        raise AssertionError(f"data_parallel: the one-rank mesh's losses {meshed[0]} != the plain step's {plain[0]}")
    plain_tree, mesh_tree = plain[2].state_tree(), meshed[2].state_tree()
    unequal = [k for k in plain_tree if not torch.equal(plain_tree[k], mesh_tree[k])]
    if unequal:
        raise AssertionError(f"data_parallel: one-rank mesh state differs from the plain step's: {unequal[:5]}")
    for name in TRAIN_KERNELS:
        if launches[name] != 2 * DP_STEPS:
            raise AssertionError(f"data_parallel: {name} launched {launches[name]} times in {DP_STEPS} steps")
    rates = {run: DP_BATCH / (statistics.median(ms[1:]) / 1e3) for run, ms in (("plain", plain[1]),
                                                                                 ("mesh", meshed[1]))}
    plain_losses = plain[0]
    del plain, meshed, plain_tree, mesh_tree
    torch.cuda.empty_cache()
    seconds_a = time.perf_counter() - t_phase

    # (b) two gloo ranks on the card, and the train CLI under torchrun
    data = os.path.join(workdir, "dp_eval-0.tfrecord")
    # up to 1,000 labels a video, so that an untrained model's top 20 hit
    # some and GAP and Hit@1 compare more than zeros
    write_frame_level_fixture(data, DP_EVAL_VIDEOS, num_classes=3862, rgb_size=D_RGB, audio_size=D_AUD,
                              max_frames=F, seed=9, max_labels=1000)
    eval_argv = ["--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
                 "--feature_sizes=1024,128", f"--eval_data_pattern={data}", f"--train_dir={train_dir}",
                 "--batch_size=64", "--run_once"]
    spec = {"batches": batches_path, "train_dir": train_dir, "out": os.path.join(workdir, "dp_ranks.json"),
            "eval_argv": eval_argv + ["--device=cuda:0", "--model_parallelism=2"]}
    spec_path = os.path.join(workdir, "dp_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    torchrun = [sys.executable, "-m", "torch.distributed.run"]
    log_paths = {name: os.path.join(workdir, f"dp_{name}.log") for name in ("ranks", "train_cli")}
    logs = {name: open(path, "w") for name, path in log_paths.items()}
    t_b = time.perf_counter()
    procs = {
        "ranks": subprocess.Popen(torchrun + ["--nproc_per_node=2", f"--master_port={free_port()}",
                                              os.path.abspath(__file__), "--data-parallel-worker", spec_path],
                                  stdout=logs["ranks"], stderr=subprocess.STDOUT),
        "train_cli": subprocess.Popen(torchrun + ["--nproc_per_node=1", f"--master_port={free_port()}", "-m",
                                                  "learnablepoolingmethods_torch.train", *DP_TRAIN_CLI_FLAGS,
                                                  f"--train_data_pattern={data}",
                                                  f"--train_dir={os.path.join(workdir, 'dp_cli')}"],
                                      stdout=logs["train_cli"], stderr=subprocess.STDOUT),
    }
    try:
        t0 = time.perf_counter()
        one_eval = eval_cli.main(eval_argv + ["--device=cuda"])
        one_eval_s = time.perf_counter() - t0
        rcs = {name: p.wait(timeout=300) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    seconds_b = time.perf_counter() - t_b
    tails = {}
    for name, path in log_paths.items():
        with open(path) as f:
            tails[name] = f.read()
        if rcs[name] != 0:
            raise AssertionError(f"data_parallel: {name} exited {rcs[name]}\n{tails[name][-6000:]}")
    if "done; final checkpoint at step 2" not in tails["train_cli"]:
        raise AssertionError(f"data_parallel: the train CLI under torchrun did not finish\n{tails['train_cli'][-4000:]}")
    with open(spec["out"]) as f:
        ranks = json.load(f)

    runs = {}
    for name in ("data_2x1", "model_1x2"):
        losses = ranks[0][name]["losses"]
        if any(r[name]["losses"] != losses for r in ranks):
            raise AssertionError(f"data_parallel: {name}: the ranks' losses differ")
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
        worst = max(r[name]["max_abs"] for r in ranks)
        over = sum(r[name]["over"] for r in ranks)
        entries = sum(r[name]["entries"] for r in ranks)
        runs[name] = {"losses": losses, "loss_gap": loss_gap, "param_max_abs": worst, "param_over": over,
                      "param_entries": entries, "split": ranks[0][name]["split"],
                      "seconds_rank0_check_only": ranks[0][name]["seconds"],
                      "launches": [r[name]["launches"] for r in ranks]}
        if loss_gap > DP_LOSS_GATE:
            raise AssertionError(f"data_parallel: {name}: loss gap {loss_gap:.3e} > {DP_LOSS_GATE}")
        if worst > DP_PARAM_GATE["max_abs"] or over > DP_PARAM_GATE["max_over"]:
            raise AssertionError(f"data_parallel: {name}: parameters max |Δ| {worst:.3e}, {over} of {entries} "
                                 f"entries past {DP_PARAM_GATE['over']:.1e}")
        for r in ranks:
            for kernel, n in r[name]["launches"].items():
                if n != 4:  # two steps, forward and backward each twice (rgb and audio)
                    raise AssertionError(f"data_parallel: {name} rank {r['rank']}: {kernel} launched {n} times")
                launches[kernel] += n
    if len(runs["data_2x1"]["split"]) != 0 or set(runs["model_1x2"]["split"]) != {
            "hidden1_weights", "MoeModel_0.gates_kernel", "MoeModel_0.experts_kernel"}:
        raise AssertionError(f"data_parallel: split parameters {runs['model_1x2']['split']}")
    mesh_eval = ranks[0]["eval"]["scores"]
    eval_gaps = {k: abs(mesh_eval[k] - float(one_eval[k])) for k in EVAL_METRICS}
    if ranks[1]["eval"]["scores"] is not None or max(eval_gaps.values()) > DP_EVAL_GATE:
        raise AssertionError(f"data_parallel: eval over two ranks {mesh_eval} against one process {one_eval}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "data_parallel", "nvidia_smi": smi, "kernel_offset_checks": kernel_checks,
          "nccl_one_rank": {"B": DP_BATCH, "steps": DP_STEPS, "bit_identical": True, "losses": plain_losses,
                            "videos_per_s_plain": rates["plain"], "videos_per_s_mesh": rates["mesh"],
                            "seconds": seconds_a},
          "gloo_two_ranks_check_only": {**runs, "loss_gate": DP_LOSS_GATE, "param_gate": DP_PARAM_GATE},
          "eval_model_parallel_2": {"scores": mesh_eval, "one_process": {k: float(one_eval[k]) for k in EVAL_METRICS},
                                    "max_gap": max(eval_gaps.values()), "gate": DP_EVAL_GATE,
                                    "seconds_check_only": ranks[0]["eval"]["seconds"],
                                    "one_process_seconds": one_eval_s},
          "train_cli_torchrun_1": {"flags": DP_TRAIN_CLI_FLAGS, "ok": True},
          "subprocess_seconds": seconds_b, "seconds": seconds})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = [time.perf_counter()]
    seconds = {}

    def done(phase: str):
        clock.append(time.perf_counter())
        seconds[phase] = clock[-1] - clock[-2]

    smi = phase_env()
    lpm_serve = phase_build()
    done("build")
    errors, timing = phase_kernels(dev, smi)
    shapes = dict.fromkeys(timing, "B=512 S=30")
    e, t, library = phase_fused_adam(dev, smi)
    errors.update(e)
    timing.update(t)
    shapes["fused_adam"] = "Willow NetVLADModelLF, 306.6M bf16 parameters, clip 1"
    e, t, lib = phase_int8_matmul(dev, smi)
    errors.update(e)
    timing.update(t)
    library.update(lib)
    shapes["int8_matmul"] = "B=512, [512, 262144] x [262144, 1024] (Willow rgb hidden FC)"
    e, t, lib, extra = phase_dropout(dev, smi)
    errors.update(e)
    timing.update(t)
    library.update(lib)
    shapes["dropout"] = "[76800, 1024] bf16, nn.Dropout 0.1 (config 5's FFN output at B=256, F=300)"
    done("fused_adam, int8_matmul, dropout")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        fp, launches, export = phase_e2e(dev, workdir)
        launches.update(dict.fromkeys(("fused_adam", "int8_matmul", "dropout"), 0))
        for name, n in phase_int8_e2e(dev, workdir, fp, smi).items():
            launches[name] = launches.get(name, 0) + n
        done("kernels, e2e, int8_e2e")
        serve_counts, served = phase_serve(dev, workdir, fp, export, smi)
        for name, n in serve_counts.items():
            launches[name] += n
        done("serve")
        e, t, lib, native_launches = phase_native_serve(dev, workdir, fp, smi, served, lpm_serve)
        errors.update(e)
        timing.update(t)
        library.update(lib)
        shapes.update(dict.fromkeys(t, "B=256 (the larger serving batch), H=1024, V=3862, M=2, k=20; f32 in"))
        for name, n in native_launches.items():
            launches[name] = launches.get(name, 0) + n
        done("native_serve")
        e, t, route_shapes, lib, route_launches = phase_native_routes(dev, workdir, smi, lpm_serve)
        for name, err in e.items():
            errors[name] = max(errors.get(name, 0.0), err)
        timing.update(t)
        shapes.update(route_shapes)
        library.update(lib)
        for name, n in route_launches.items():
            launches[name] = launches.get(name, 0) + n
        done("native_routes")
    device_rates = {"fused_inference_b512": phase_throughput(dev, fp, smi)}
    del fp
    done("throughput")
    e, t = phase_train_kernels(dev, smi)
    errors.update(e)
    timing.update(t[30])
    shapes.update(dict.fromkeys(t[30], "B=256 S=30, rgb and audio calls"))
    done("train_kernels")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        launches.update(phase_train_e2e(dev, workdir, smi))
        done("train_e2e")
        for name, n in phase_train_resume(dev, workdir, smi).items():
            launches[name] = launches.get(name, 0) + n
        done("train_resume")
        for name, n in phase_train_zoo_e2e(dev, workdir, smi).items():
            launches[name] += n
        done("train_zoo_e2e")
        for name, n in phase_train_12b(dev, workdir, smi).items():
            launches[name] += n
        done("train_12b")
        for name, n in phase_train_attn_rnn_e2e(dev, workdir, smi).items():
            launches[name] = launches.get(name, 0) + n
        done("train_attn_rnn_e2e")
    device_rates["train_step_b256"] = phase_train_throughput(dev, smi)
    done("train_throughput")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ingest_") as workdir:
        for name, n in phase_ingest(dev, workdir, smi, device_rates).items():
            launches[name] = launches.get(name, 0) + n
    done("ingest")
    phase_train_zoo_throughput(dev, smi)
    done("train_zoo_throughput")
    phase_train_attn_rnn_throughput(dev, smi)
    done("train_attn_rnn_throughput")
    phase_optimizers(dev, smi)
    done("optimizers")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tf_") as workdir:
        phase_tf_import(dev, workdir, smi)
    done("tf_import")
    e, t = phase_lf_kernels(dev, smi)
    errors.update(e)
    timing.update(t)
    shapes.update(dict.fromkeys(t, "B=512 S=30, rgb and audio calls"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lf_") as workdir:
        fps, lf_launches = phase_lf_e2e(dev, workdir, smi)
    for name, n in lf_launches.items():
        launches[name] = launches.get(name, 0) + n
    phase_lf_throughput(dev, fps, smi)
    del fps
    done("lf")
    e, t, library_ms = phase_attn_kernels(dev, smi)
    errors.update(e)
    timing.update(t)
    shapes.update(dict.fromkeys(t, "B={} F={} H={} hd={} bf16".format(*ATTN_TIMING)))
    library["masked_attention_fused"] = library_ms
    with tempfile.TemporaryDirectory(prefix="chip_smoke_attn_") as workdir:
        fps, attn_launches = phase_attn_e2e(dev, workdir, smi)
    for name, n in attn_launches.items():
        launches[name] = launches.get(name, 0) + n
    phase_attn_throughput(dev, fps, smi)
    del fps
    done("attn")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as workdir:
        for name, n in phase_eval_e2e(dev, workdir, smi).items():
            launches[name] = launches.get(name, 0) + n
    done("eval_e2e")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as workdir:
        for name, n in phase_data_parallel(dev, workdir, smi).items():
            launches[name] = launches.get(name, 0) + n
    done("data_parallel")
    emit({"phase": "seconds", **seconds, "total": clock[-1] - clock[0]})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
         "launches": launches[name], "max_abs_err": errors[name], "ms": timing[name][0],
         "plain_ms": timing[name][1], "bound_ms": timing[name][2][0],
         "bound_by": timing[name][2][1], "library_ms": library.get(name), "shape": shapes[name],
         **extra.get(name, {})}
        for name, spec in KERNELS.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--data-parallel-worker":
        sys.exit(data_parallel_worker(sys.argv[2]))
    # the phases build the same models over and over (the CLIs' initial
    # weights among them): each distinct initial tree is drawn once
    with init_memo():
        sys.exit(main())
