"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

from the root of a checkout.  It imports nothing of JAX, fails on any
error, and prints one JSON line per phase:

1. env        torch and CUDA versions, the card's name and power limit;
2. build      nvcc builds every kernel under learnablepoolingmethods_torch/csrc;
3. kernels    each kernel against its plain PyTorch version at Willow shapes
              (D 1024/128, K 256/128), B=64, S=30 and S=300, num_frames
              including 1 and 300, and at one small shape off every tile
              width; for a bf16 output |Δ| <= 1e-2·max|ref| + 2e-2·|ref| in
              f32 (one bf16 rounding of the output plus another f32
              summation order; the per-element magnitude at full width is
              about 2e-3, so an absolute 2e-2 would test nothing), for an
              f32 output 1e-5·max|ref| + 1e-5·|ref| (the summation order
              alone); times at B=512, S=30 and S=300 with CUDA events;
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
5. throughput the fused route at B=512, S=30: videos/s (the median of
              five rounds of timed batches) and per-stage ms;
6. profile    torch.profiler over five fused batches: device ms per kernel
              name and the device's idle share.

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

from learnablepoolingmethods_torch import inference
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig
from learnablepoolingmethods_torch.core.weights import (
    convert_flax_variables,
    init_variables_np,
    save_variables_npz,
)
from learnablepoolingmethods_torch.data.fixtures import write_frame_level_fixture
from learnablepoolingmethods_torch.data.pipeline import batch_iterator
from learnablepoolingmethods_torch.data.readers import YT8MFrameFeatureReader
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
}


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


def compare(name: str, got, want) -> float:
    """Max |Δ| in f32; raises unless |Δ| <= a·max|ref| + r·|ref| everywhere,
    with (a, r) = TOLERANCE[want.dtype]."""
    a, r = TOLERANCE[want.dtype]
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
    gen = torch.Generator(device=dev)
    gen.manual_seed(s)
    idx = sample_indices(gen, nf, f, s)
    shape = {"B": b, "F": f, "S": s, "D": [d for d, _ in mods], "K": [k for _, k in mods]}
    checks = []

    def record(kernel, label, got, want, **extra):
        err = compare(f"{kernel} {label} {shape}", got, want)
        errors[kernel] = max(errors[kernel], err)
        checks.append({"kernel": kernel, "modality": label, **extra, "max_abs_err": err,
                       "max_ref": want.float().abs().max().item()})

    got = netvlad_frontend(x, idx, *consts)
    torch.cuda.synchronize()
    want = netvlad_frontend_reference(x, idx, *consts)
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
    for b, f, s, mods in ((64, F, 30, MODS), (64, F, 300, MODS), (3, 10, 7, ((42, 20), (8, 10)))):
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
        gen = torch.Generator(device=dev)
        gen.manual_seed(b + s)
        idx = sample_indices(gen, nf, F, s)
        rows = staged_frames(gather_frames(x, idx), consts[0], consts[1], torch.bfloat16)
        xr, xa = rows[:, :, :D_RGB], rows[:, :, D_RGB:]
        per_s[s] = {
            "netvlad_frontend": (
                time_ms(lambda: netvlad_frontend(x, idx, *consts)),
                time_ms(lambda: netvlad_frontend_reference(x, idx, *consts), reps=5),
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
            gen = torch.Generator(device=dev)
            gen.manual_seed(batch_idx)  # the CLI's per-batch seed
            out.append(fn(fp, feats, nf, gen)[real])
        return torch.cat(out)

    reset_counters()
    probs = {"staged": run_route(
        build_fast_netvlad_inference(mcfg, return_probs=True, fuse_frontend=False))}
    torch.cuda.synchronize()
    paths["staged"] = counters()
    expected = {"cli": {"netvlad_frontend": n_batches, "netvlad_fused": 0},
                "staged": {"netvlad_frontend": 0, "netvlad_fused": 2 * n_batches}}
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
    return fp, {name: sum(p[name] for p in paths.values()) for name in KERNELS}


def phase_throughput(dev, fp, smi):
    mcfg = ModelConfig()
    b, s = 512, mcfg.iterations
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randint(0, 256, (b, F, DT), generator=gen, device=dev, dtype=torch.uint8)
    nf = torch.randint(1, F + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    per_route, fused_rounds = {}, []
    for route, kw in (("fused", {}), ("staged", {"fuse_frontend": False}), ("plain", {"use_kernels": False})):
        fn = build_fast_netvlad_inference(mcfg, top_k=20, **kw)
        rounds = [time_ms(lambda: fn(fp, x, nf, gen), reps=10) for _ in range(5 if route == "fused" else 1)]
        per_route[route] = statistics.median(rounds)
        if route == "fused":
            fused_rounds = rounds

    def frontend():
        idx = sample_indices(gen, nf, F, s)
        return netvlad_frontend(
            x, idx, fp["in_scale"], fp["in_bias"],
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
          **profile_device(lambda: fused(fp, x, nf, gen)), "card": smi})


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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        fp, launches = phase_e2e(dev, workdir)
    phase_throughput(dev, fp, smi)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
         "launches": launches[name], "max_abs_err": errors[name], "ms": timing[name][0],
         "plain_ms": timing[name][1], "bound_ms": timing[name][2][0],
         "bound_by": timing[name][2][1], "library_ms": None, "shape": "B=512 S=30"}
        for name, spec in KERNELS.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
