"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

from the root of a checkout.  It imports nothing of JAX, fails on any
error, and prints one JSON line per phase:

1. env        torch and CUDA versions, the card's name and power limit;
2. build      nvcc builds every kernel under learnablepoolingmethods_torch/csrc;
3. kernels    both inference kernels against their plain PyTorch versions at
              Willow shapes (D 1024/128, K 256/128), B=64, S=30, S=300 and
              S=1 (where each descriptor shows which frame the front end
              drew), num_frames including 1 and 300, and at one small shape off
              every tile width; for a bf16 output |Δ| <= 1e-2·max|ref| +
              2e-2·|ref| in f32 (one bf16 rounding of the output plus another
              f32 summation order; the per-element magnitude at full width is
              about 2e-3, so an absolute 2e-2 would test nothing), for an f32
              output 1e-5·max|ref| + 1e-5·|ref| (the summation order alone);
              times at B=512, S=30 and S=300 with CUDA events;
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
5. throughput the fused inference route at B=512, S=30: videos/s (the median
              of five rounds of timed batches) and per-stage ms; then
   profile    torch.profiler over five fused batches: device ms per kernel
              name and the device's idle share;
6. train_kernels
              both training kernels (the NetVLAD aggregation's forward and
              backward) against their plain versions: the output, dX, dL and
              dC₂, X in bf16 and f32, at both Willow modalities, B=64, S=30
              and S=300, and at one small shape off every tile width, with the
              tolerances above chosen by X's dtype; dC₂ of a batch against the
              kernel's dC₂ of each video alone, summed, and at B=1 against the
              per-video formula; at B=256, S=30 and S=300, X in bf16, all four
              outputs and the per-video dC₂ sum again, and the times;
7. train_e2e  the train CLI at full Willow width on 512 synthetic videos:
              five bf16 steps with --fused_train_aggregation (the main path
              of this slice; each training kernel must launch twice a step),
              the same five steps without it, and both again in f32; the
              losses must be finite and fall, and agree between the routes
              (see phase_train_e2e); then the inference CLI reads the trained
              variables.npz and writes a CSV row per video;
8. train_throughput
              the train step at B=256, S=30, bf16, fused: videos/s (the median
              of five rounds), forward, backward and optimizer ms, peak
              memory; then train_profile, torch.profiler over five steps.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from learnablepoolingmethods_torch import inference, train
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig, TrainingConfig
from learnablepoolingmethods_torch.core.step import TrainStep
from learnablepoolingmethods_torch.core.train_state import TrainState
from learnablepoolingmethods_torch.core.weights import (
    convert_flax_variables,
    init_variables_np,
    load_flax_variables,
    save_variables_npz,
)
from learnablepoolingmethods_torch.data.fixtures import write_frame_level_fixture
from learnablepoolingmethods_torch.data.pipeline import batch_iterator
from learnablepoolingmethods_torch.data.readers import YT8MFrameFeatureReader
from learnablepoolingmethods_torch.losses import CrossEntropyLoss
from learnablepoolingmethods_torch.models import create_model
from learnablepoolingmethods_torch.ops import kernel_build
from learnablepoolingmethods_torch.ops.fast_infer import (
    build_fast_netvlad_inference,
    gated_moe_tail,
    matmul_f32,
    prepare_fast_params,
    staged_frames,
)
from learnablepoolingmethods_torch.ops.fused_frontend import (
    gather_frames,
    netvlad_frontend,
    netvlad_frontend_reference,
    sample_indices,
)
from learnablepoolingmethods_torch.ops.netvlad_fused import netvlad_fused, netvlad_reference
from learnablepoolingmethods_torch.ops.netvlad_train import (
    netvlad_aggregate_backward,
    netvlad_aggregate_backward_plain,
    netvlad_aggregate_forward,
    netvlad_aggregate_forward_plain,
)
from learnablepoolingmethods_torch.utils import prng

# H100 SXM data-sheet peaks (dense, 700 W): HBM bytes/s and bf16 tensor-core
# FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
DT, D_RGB, D_AUD, K_RGB, K_AUD, F = 1152, 1024, 128, 256, 128, 300
MODS = ((D_RGB, K_RGB), (D_AUD, K_AUD))
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
}
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


def compare(name: str, got, want, dtype=None) -> float:
    """Max |Δ| in f32; raises unless |Δ| <= a·max|ref| + r·|ref| everywhere,
    with (a, r) = TOLERANCE[dtype or want.dtype]."""
    a, r = TOLERANCE[dtype or want.dtype]
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite values")
    diff = (got - want).abs()
    atol = a * want.abs().max().item()
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


def bound(b: int, s: int, idx, frontend: bool):
    """Least time (ms) for the work of one call (frontend) or of the two
    staged netvlad_fused calls: bytes each read or written once over the HBM
    rate, or the logits and the aggregation over the bf16 tensor-core rate,
    whichever is larger.  The aggregation counts at that rate because X is
    exact in bf16 and A splits into bf16 terms without losing f32 accuracy."""
    dk = sum(d * k for d, k in MODS)
    consts = sum(d * k * 2 + 2 * k * 4 + d * k * 4 for d, k in MODS)
    out = b * dk * 2
    if frontend:
        rows = sum(len(torch.unique(r)) for r in idx.cpu())
        nbytes = rows * DT + b * s * 4 + 2 * DT * 4 + consts + out
    else:
        nbytes = b * s * DT * 2 + consts + out
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


def phase_build():
    start = time.perf_counter()
    per_source = kernel_build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - start, "per_source": per_source})


def check_kernels(rng, dev, b: int, f: int, s: int, mods, errors) -> list:
    """Both kernels against their plain versions on one random batch: the
    front end on uint8 frames, and netvlad_fused in bf16 and f32 on the
    staged route's rows (strided column slices, as fast_infer passes them)."""
    d_rgb = mods[0][0]
    dt = sum(d for d, _ in mods)
    consts = frontend_consts(rng, dev, mods)
    x, nf = frames(rng, b, dev, f, dt)
    key = prng.key(s)
    idx = sample_indices(key, nf, f, s)
    shape = {"B": b, "F": f, "S": s, "D": [d for d, _ in mods], "K": [k for _, k in mods]}
    checks = []

    def record(kernel, label, got, want, **extra):
        err = compare(f"{kernel} {label} {shape}", got, want)
        errors[kernel] = max(errors[kernel], err)
        checks.append({"kernel": kernel, "modality": label, **extra, "max_abs_err": err,
                       "max_ref": want.float().abs().max().item()})

    got = netvlad_frontend(x, key, nf, s, *consts)
    torch.cuda.synchronize()
    want = netvlad_frontend_reference(x, key, nf, s, *consts)
    for mod, g, w in zip(("rgb", "aud"), got, want):
        record("netvlad_frontend", mod, g, w)
    for dtype in (torch.bfloat16, torch.float32):
        rows = staged_frames(gather_frames(x, idx), consts[0], consts[1], dtype)
        for mod, (c, sc, bi, c2), cols in (("rgb", consts[2:6], slice(0, d_rgb)),
                                           ("aud", consts[6:10], slice(d_rgb, dt))):
            xm, cm = rows[:, :, cols], c.to(dtype)
            g = netvlad_fused(xm, cm, sc, bi, c2)
            torch.cuda.synchronize()
            record("netvlad_fused", mod, g, netvlad_reference(xm, cm, sc, bi, c2),
                   dtype=str(dtype))
    return [{**shape, **c} for c in checks]


def phase_kernels(dev, smi):
    rng = np.random.default_rng(0)
    errors = {name: 0.0 for name in KERNELS}
    # Willow widths at the --iterations default and at every frame; then
    # small widths off every tile: D and K not multiples of 32, S not a
    # multiple of the 32-sample chunk, and a row of 50 bytes, which takes
    # the front end's unvectorised load
    # at S=1 a video's descriptors come from its one sampled frame, so a frame
    # that the kernel drew other than the plain version fails the check
    for b, f, s, mods in ((64, F, 30, MODS), (64, F, 300, MODS), (64, F, 1, MODS),
                          (3, 10, 7, ((42, 20), (8, 10)))):
        before = counters()
        checks = check_kernels(rng, dev, b, f, s, mods, errors)
        after = counters()
        emit({"phase": "kernels", "checks": checks,
              "launch_deltas": {k: after[k] - before[k] for k in after}})

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
        for name, (ms, plain_ms, (bound_ms, by)) in per_s[s].items():
            emit({"phase": "kernel_times", "kernel": name, "B": b, "S": s, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by, "card": smi})
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
    summed in f64, and the kernel's dC₂ at B=1 against the plain version's."""
    (b, s, d), k, dtype = x.shape, logits.shape[2], x.dtype
    got_f = netvlad_aggregate_forward(x, logits, c2)
    got_b = netvlad_aggregate_backward(x, logits, c2, dv3)
    torch.cuda.synchronize()
    want_f = netvlad_aggregate_forward_plain(x, logits, c2)
    want_b = netvlad_aggregate_backward_plain(x, logits, c2, dv3)
    label = f"B={b} S={s} D={d} K={k} {dtype}"
    errs = {"out": compare(f"forward {label}", got_f, want_f, dtype)}
    for name, g, w in zip(("dx", "dl", "dc2"), got_b, want_b):
        errs[name] = compare(f"backward {name} {label}", g, w, dtype)
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
            "max_ref": {"out": want_f.float().abs().max().item(),
                        "dx": want_b[0].float().abs().max().item(),
                        "dl": want_b[1].abs().max().item(),
                        "dc2": want_b[2].abs().max().item()}}


def phase_train_kernels(dev, smi):
    """Both training kernels against their plain versions (check_train_kernels),
    X in bf16 and in f32, at both Willow modalities (B=64, S=30 and S=300)
    and at one small shape off every tile width, the per-video dC₂ sum at
    B=64, S=30; then at B=256, S=30 and S=300, X in bf16, the shapes of the
    main path, where the backward's video groups are four times longer: all
    four outputs, the per-video dC₂ sum, and the times."""
    rng = np.random.default_rng(1)
    errors = {name: 0.0 for name in TRAIN_KERNELS}
    for b, s, mods in ((64, 30, MODS), (64, 300, MODS), (20, 37, ((70, 20), (8, 10)))):
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
                  "bytes": nbytes, "flop": flops, "card": smi})
        timing[s] = rows
    return errors, timing


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
    # path 2: the staged route (the NetVLAD kernel once per modality) through
    # build_fast_netvlad_inference on the same batches and sampled indices
    fp = prepare_fast_params(convert_flax_variables(tree, mcfg), mcfg, device=dev)
    del tree
    reader = YT8MFrameFeatureReader(feature_names=("rgb", "audio"))
    batches = []
    for batch in batch_iterator(reader, data, 32):
        real = batch["weights"] > 0
        batches.append((torch.from_numpy(batch["features"]).to(dev),
                        torch.from_numpy(batch["num_frames"]).to(dev),
                        torch.from_numpy(real).to(dev),
                        [v for v, keep in zip(batch["video_id"], real) if keep]))

    def run_route(fn):
        out = []
        for batch_idx, (feats, nf, real, _) in enumerate(batches):
            key = prng.fold_in(prng.key(0), batch_idx)  # the CLI's per-batch key
            out.append(fn(fp, feats, nf, key)[real])
        return torch.cat(out)

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
    vals, ids = torch.topk(probs["fused"], 20)
    vids = [vid for *_, batch_vids in batches for vid in batch_vids]
    for vid, v_row, i_row in zip(vids, vals.cpu().numpy(), ids.cpu().numpy()):
        c_ids, c_vals = csv[vid.decode()]
        if list(i_row) != c_ids or np.abs(v_row - c_vals).max() > 1e-5:
            raise AssertionError(f"CSV row of {vid!r} differs from the fused route's top-20")
    emit({"phase": "e2e", "videos": len(truth), "batches": n_batches, "setup_s": setup_s,
          "cli_s": cli_s, "launches_per_path": paths, "max_abs_prob_gap": gaps})
    return fp, {name: sum(p[name] for p in paths.values()) for name in ("netvlad_frontend", "netvlad_fused")}


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
    emit({"phase": "throughput", "B": b, "S": s, "videos_per_s": b / (per_route["fused"] / 1e3),
          "videos_per_s_rounds": [b / (ms / 1e3) for ms in fused_rounds],
          "batch_ms": per_route, **stages,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": smi})
    fused = build_fast_netvlad_inference(mcfg, top_k=20)
    emit({"phase": "profile", "route": "fused", "B": b, "S": s,
          **profile_device(lambda: fused(fp, x, nf, key)), "card": smi})


def profile_device(fn, reps: int = 5) -> dict:
    """Device time per call of ``fn`` by kernel name, from torch.profiler's
    CUDA activity over ``reps`` calls, and the device's idle share between
    the first kernel's start and the last one's end."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void "))
                   for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"device_ms_per_call": "not measured: the profiler recorded no device activity"}
    by_name = {}
    busy_us, reach = 0.0, spans[0][0]
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3 / reps
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    window_us = reach - spans[0][0]
    return {"device_busy_ms_per_call": busy_us / 1e3 / reps,
            "device_window_ms_per_call": window_us / 1e3 / reps,
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
# not (1.018e-3 measured, the same bits in every run).  PERF.md gives the
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
    the inference CLI reads the fused run's variables.npz.

    The losses must be finite and fall from step 1 to step 5.  Step 1 sees
    the forward alone: there the routes must agree within 1e-5 relative.
    Every step must agree within the limit of LOSS_GATES.  (In bf16 that is
    twice the 1e-3 budget of the JAX training drill, which the measured
    1.018e-3 misses: the first Adam update at the default learning rate
    raises the loss by half and amplifies the rounding, see PERF.md.)"""
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


def phase_train_throughput(dev, smi):
    """The train step at full Willow width, B=256, S=30, bf16, fused route:
    videos/s (the median of five rounds of five steps), forward, backward and
    optimizer ms (medians over five steps, CUDA events), peak memory; then
    torch.profiler over five steps."""
    b = 256
    mcfg = ModelConfig(compute_dtype="bfloat16", fused_train_aggregation=True, presampled=True)
    fcfg = FeatureConfig(("rgb", "audio"), (D_RGB, D_AUD), True, F)
    tcfg = TrainingConfig(batch_size=b, presample_frames=True)
    model = create_model("NetVLADModelLF", mcfg, DT)
    load_flax_variables(model, init_variables_np(mcfg, fcfg, seed=0)).to(dev)
    state = TrainState.create(model, tcfg)
    step = TrainStep(CrossEntropyLoss(), tcfg, mcfg, True)
    rng = np.random.default_rng(2)
    batch = {
        "features": torch.from_numpy(rng.integers(0, 256, (b, F, DT), dtype=np.uint8)).to(dev),
        "num_frames": torch.from_numpy(rng.integers(1, F + 1, b).astype(np.int32)).to(dev),
        "labels": torch.from_numpy((rng.random((b, mcfg.vocab_size)) < 0.002).astype(np.float32)).to(dev),
        "weights": torch.ones(b, device=dev),
    }
    key = prng.key(0)
    params = list(model.parameters())
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, batch, key)
    torch.cuda.synchronize()

    rounds = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            step(state, batch, key)
        end.record()
        end.synchronize()
        rounds.append(start.elapsed_time(end) / 5)
    stages = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        total = step.loss(state, batch, key)[0]
        ev[1].record()
        grads = torch.autograd.grad(total, params)
        ev[2].record()
        state.apply_gradients(grads)
        ev[3].record()
        ev[3].synchronize()
        for name, (a, c) in zip(stages, ((0, 1), (1, 2), (2, 3))):
            stages[name].append(ev[a].elapsed_time(ev[c]))
    step_ms = statistics.median(rounds)
    emit({"phase": "train_throughput", "B": b, "S": mcfg.iterations, "route": "fused bf16",
          "videos_per_s": b / (step_ms / 1e3), "step_ms": step_ms,
          "videos_per_s_rounds": [b / (ms / 1e3) for ms in rounds],
          **{name: statistics.median(v) for name, v in stages.items()},
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": smi})
    emit({"phase": "train_profile", "route": "fused bf16", "B": b, "S": mcfg.iterations,
          **profile_device(lambda: step(state, batch, key)), "card": smi})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_env()
    phase_build()
    errors, timing = phase_kernels(dev, smi)
    shapes = dict.fromkeys(timing, "B=512 S=30")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        fp, launches = phase_e2e(dev, workdir)
    phase_throughput(dev, fp, smi)
    del fp
    e, t = phase_train_kernels(dev, smi)
    errors.update(e)
    timing.update(t[30])
    shapes.update(dict.fromkeys(t[30], "B=256 S=30, rgb and audio calls"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        launches.update(phase_train_e2e(dev, workdir, smi))
    phase_train_throughput(dev, smi)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
         "launches": launches[name], "max_abs_err": errors[name], "ms": timing[name][0],
         "plain_ms": timing[name][1], "bound_ms": timing[name][2][0],
         "bound_by": timing[name][2][1], "library_ms": None, "shape": shapes[name]}
        for name, spec in KERNELS.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
