"""Time the W8A16 hidden FC, ``pool_attention``, the GRU layer, the
dropout kernel's two launches and the runner's tail, stage and gated-tail
kernels of the checkout in the working directory, so that two checkouts
can be compared in one run on one card.

The W8A16 kernel is timed by ``chip_smoke.phase_int8_matmul`` (the Willow
rgb FC at every batch of ``INT8_BATCHES``, beside cuBLAS bf16 on the
weight dequantized once), ``pool_attention`` at AttentionPoolingModel's
default width (B=256, F=300, 64 queries, 8 heads of 128, f32, frame
counts from ``chip_smoke``'s generator, one video of none) on the
profiler's device clock and by CUDA events, beside SDPA on the biased
heads.  The GRU layer (B=256, F=300, H=1024, f32: GruModel's) by CUDA
events: ``native_tail.gru_layer`` where the checkout has it, else the
per-frame cuBLAS product and ``gru_cell`` that the runner launched
before; and the native runner's whole GruModel batch of 256 (random
weights and frames, host clock, the frames' copy included), beside
cuDNN's GRU over the same frames (one layer and two, TF32 off).  The
dropout kernel at config 5's FFN output [76,800, 1024] bf16 and the
attention weights [256, 8, 300, 300] under a [1, 1, 300, 300] mask: its
forward and its backward launch (from the forward's bits where the
checkout keeps them, else the hashing launch again).  The runner's tail
kernels, ``topk`` (k = 20) and ``moe_combine`` (M = 2), at Willow's widths
and B=256 on inputs drawn here (the same in every checkout), on the
profiler's device clock and by CUDA events, beside ``torch.topk``; and
inside the runner's batch (random weights and frames): Willow's route at
B=32 and 256 and NetRVLAD's at 256, each batch's host ms and the device ms
of its ``topk`` and ``moe_combine`` kernels.  The runner's stage kernels,
``frame_stage`` in its four modes (iid with the folded input BN, one window,
every frame in bf16 and in f32 with the key mask; B=256, F=300, S=30,
DT=1152) and ``nextvlad_residual`` at NeXtVLAD-128's rgb and audio widths
(B=256, S·G=240, K=128, D′=256 and 32), each on input sets in turn that
outrun the 50 MB L2 and on one set read again, on the profiler's device
clock (with the count of kernel records it kept) and by CUDA events, beside
the bytes bound; and inside the runner's batch of 256 (random weights and
frames): NeXtVLAD, NetRVLAD, TransformerEncoderModel and
FrameLevelLogisticModel, each batch's host ms and the device ms of its
``frame_stage`` and ``nextvlad_residual`` kernels.  The gated tail's
``hidden_sum`` (Willow's two products; NetFV's four in pairs) and
``gating`` (bf16 and f32 out) alone at B=256, H=1024, on one input set read
again and on 16 sets in turn, on the profiler's device clock (with its
record count) and by CUDA events, beside a device copy and PyTorch's
element-wise kernel over as many bytes and the bytes bound, with nvcc's
registers, stack frame and spills of each of their kernels; and inside the
runner's batch (random weights and frames): Willow's route at B=32 and 256
and NetFV's at 256, each batch's host ms and the device ms of its
``hidden_sum`` and ``gating`` kernels.  It prints one JSON line with the
card's name and power limit.

Compare a change with its parent (``git archive`` of each unpacked into
git-ignored directories), in turns: parent, change, change, parent::

    for d in parent change change parent; do (cd $d && python3 ../tools/torch_kernel_ab.py --label $d); done

``--parts tail`` times only those parts (of int8, pool, gru, dropout,
tail, stage, gated).
"""

import argparse
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402  (the checkout's own)
from learnablepoolingmethods_torch import export_model as export_lib  # noqa: E402
from learnablepoolingmethods_torch.core import native_runtime  # noqa: E402
from learnablepoolingmethods_torch.ops import dropout as dropout_ops  # noqa: E402
from learnablepoolingmethods_torch.ops import kernel_build  # noqa: E402
from learnablepoolingmethods_torch.ops import native_tail  # noqa: E402
from learnablepoolingmethods_torch.utils import prng  # noqa: E402


def sm_clocks(fn, seconds: float = 1.0) -> list:
    """The card's SM clock (MHz), sampled every 100 ms by nvidia-smi while
    ``fn`` runs back to back for about ``seconds``."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        while True:
            for _ in range(20):
                fn()
            end.record()
            end.synchronize()
            if start.elapsed_time(end) > seconds * 1e3:
                break
    finally:
        smi.terminate()
        out = smi.communicate()[0]
    return [int(v) for v in out.split() if v.isdigit()]


def pool_times(dev) -> dict:
    """pool_attention's device ms, its event ms and SDPA's at the default
    width, with the bound from ``chip_smoke.pool_attention_work``."""
    gen = torch.Generator(device=dev).manual_seed(7)
    b, f, n_q, heads, d = 256, chip_smoke.F, 64, 8, 1024
    q = torch.randn((n_q, d), generator=gen, device=dev)
    kv = torch.randn((b, f, 2 * d), generator=gen, device=dev)
    bkv = torch.randn((2 * d,), generator=gen, device=dev) * 0.1
    nf = torch.randint(1, f + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    nf[2] = 0
    kvb = (kv + bkv).view(b, f, 2, heads, d // heads).permute(2, 0, 3, 1, 4)
    sq = q.view(n_q, heads, -1).permute(1, 0, 2)[None].expand(b, -1, -1, -1).contiguous()
    sk, sv = kvb[0].contiguous(), kvb[1].contiguous()
    mask = native_tail.key_mask(nf, f).bool()[:, None, None, :]

    def kernel():
        return native_tail.pool_attention(q, kv, bkv, nf, heads)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)

    err = (kernel() - native_tail.pool_attention_plain(q, kv, bkv, nf, heads)).abs().max().item()
    nbytes, ops = chip_smoke.pool_attention_work(nf, f, n_q, d)
    out = {"device_ms": chip_smoke.device_ms(kernel), "event_ms": chip_smoke.time_ms(kernel),
           "sm_clock_mhz_under_load": sm_clocks(kernel),
           "sdpa_device_ms": chip_smoke.device_ms(sdpa), "sdpa_event_ms": chip_smoke.time_ms(sdpa),
           "max_abs_err": err,
           "bound_ms": max(nbytes / chip_smoke.PEAK_BYTES, ops / chip_smoke.PEAK_CUDA_CORES) * 1e3}
    del q, kv, sk, sv
    # the inputs of chip_smoke.py's route check (its native_pool_attention
    # timing), in this process
    x = chip_smoke.route_kernel_inputs(dev)

    def smoke():
        return native_tail.pool_attention(x["pool_q"], x["kv"], x["bkv"], x["nf0"], x["heads"])

    out.update(smoke_inputs_device_ms=chip_smoke.device_ms(smoke), smoke_inputs_event_ms=chip_smoke.time_ms(smoke))
    return out


def gru_times(dev) -> dict:
    """A GRU layer at GruModel's width by CUDA events (the checkout's
    gru_layer, or its per-frame product and gru_cell), the runner's
    GruModel batch by the host clock, and cuDNN's GRU."""
    gen = torch.Generator(device=dev).manual_seed(7)
    b, f, h = 256, chip_smoke.F, 1024
    pre = torch.randn((b, f, 3 * h), generator=gen, device=dev) * 2.0
    w_h = torch.cat([torch.linalg.qr(torch.randn((h, h), generator=gen, device=dev))[0] for _ in range(3)], dim=1)
    b_i = torch.randn((3 * h,), generator=gen, device=dev) * 0.5
    b_hn = torch.randn((h,), generator=gen, device=dev) * 0.5
    nf = torch.randint(1, f + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    if hasattr(native_tail, "gru_layer"):
        def layer():
            return native_tail.gru_layer(pre, w_h, b_i, b_hn, nf)
        kind = "gru_layer"
    else:
        def layer():
            state = torch.zeros((b, h), device=dev)
            carry = torch.zeros((b, h), device=dev)
            for t in range(f):
                state, carry = native_tail.gru_cell(pre[:, t], state @ w_h, b_i, b_hn, state, carry, nf, t, f)
            return state, carry
        kind = "sgemm_and_gru_cell_per_frame"
    out = {"layer": kind, "layer_ms": chip_smoke.time_ms(layer, reps=5, warmup=1)}
    del pre
    mcfg, fcfg = chip_smoke.route_config("GruModel", {})
    tree = chip_smoke.seeded_tree("GruModel", mcfg, fcfg)
    rng = np.random.default_rng(5)
    feats = rng.integers(0, 256, (b, f, chip_smoke.DT), dtype=np.uint8)
    nfs = rng.integers(1, f + 1, b).astype(np.int32)
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as export_dir:
        export_lib.export_model(export_dir, "GruModel", mcfg, fcfg, tree["params"], tree["batch_stats"],
                                with_stablehlo=True, stablehlo_batch_size=b)
        exe = native_runtime.NativeExecutable.from_export_dir(export_dir, dev)
        exe.run(feats, nfs)
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            exe.run(feats, nfs)
            runs.append((time.perf_counter() - t0) * 1e3)
        out["route_ms_per_batch"] = statistics.median(runs)
        out["route_launches_a_batch"] = {k: v for k, v in exe.launches().items() if v}
        exe.close()
    x, _ = native_tail.frame_stage_all_plain(torch.from_numpy(feats).to(dev), torch.from_numpy(nfs).to(dev),
                                             torch.float32)
    for layers in (1, 2):
        rnn = torch.nn.GRU(chip_smoke.DT, h, num_layers=layers, batch_first=True).to(dev)
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            out[f"cudnn_{layers}_layer_ms"] = chip_smoke.time_ms(lambda: rnn(x), reps=3, warmup=1)
    return out


def dropout_times(dev) -> dict:
    """The dropout kernel's forward and backward launch at config 5's FFN
    output and attention weights, bf16, by CUDA events."""
    gen = torch.Generator(device=dev).manual_seed(11)
    key = prng.key(17)
    kp = 0.9
    out = {}
    for name, shape, mask, mode in (("ffn", (256 * chip_smoke.F, 1024), None, "div"),
                                    ("attention", (256, 8, chip_smoke.F, chip_smoke.F), (1, 1, chip_smoke.F, chip_smoke.F),
                                     "mul")):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        mask = mask or shape

        def forward():
            return dropout_ops.dropout_kernel(x, key, kp, mask, mode)

        got = forward()
        if isinstance(got, tuple):  # the forward keeps the mask's bits
            bits = got[1]

            def backward():
                return dropout_ops.dropout_from_bits(x, bits, kp, mask, mode)
        else:
            backward = forward
        out[name] = {"forward_ms": chip_smoke.time_ms(forward), "backward_ms": chip_smoke.time_ms(backward)}
        del x, got
    return out



# the runner's routes timed with their tail kernels, and their batches
TAIL_ROUTES = (("NetVLADModelLF", (32, 256)), ("NetRVLADModelLF", (256,)))


def device_records(fn, reps: int) -> list:
    """(name, µs) of each device record the profiler kept for ``reps``
    calls of ``fn``: between two marker kernels (torch.cuda._sleep's),
    after lead calls for 20 ms of host time, as ``chip_smoke.profile_device``
    counts them (the profiler drops the records of the first launches after
    it starts); raises if a marker was dropped."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        lead = time.perf_counter()
        fn()
        while time.perf_counter() - lead < 0.02:
            fn()
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    records = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    marks = [i for i, r in enumerate(records) if "spin_kernel" in r[2]]
    if len(marks) != 2:
        raise RuntimeError(f"the profiler kept {len(marks)} of its 2 marker kernels")
    return [(name, end - start) for start, end, name in records[marks[0] + 1:marks[1]]]


def kernel_device_ms(fn, needles: tuple, reps: int = 5) -> dict:
    """The profiler's device ms a call of ``fn`` of each kernel whose name
    holds one of ``needles`` (summed by needle)."""
    out = {needle: 0.0 for needle in needles}
    for name, us in device_records(fn, reps):
        for needle in needles:
            if needle in name:
                out[needle] += us / 1e3 / reps
    return out


def tail_times(dev) -> dict:
    """topk and moe_combine alone at B=256, on one input set read again and
    on 16 sets in turn (more bytes than the L2 holds), and in the runner's
    batches."""
    gen = torch.Generator(device=dev).manual_seed(23)
    b, v, m, k = 256, 3862, 2, 20
    sets = []
    for _ in range(16):
        ga = torch.randn((b, (m + 1) * v), generator=gen, device=dev) * 3.0
        ea = torch.randn((b, m * v), generator=gen, device=dev) * 3.0
        eb = torch.randn((m * v,), generator=gen, device=dev) * 0.5
        sets.append((ga, ea, eb, native_tail.moe_combine_plain(ga, ea, eb, m)))
    ga, ea, eb, probs = sets[0]
    got, want = native_tail.topk(probs, k), native_tail.topk_plain(probs, k)
    out = {"topk_equal_to_plain": bool(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                                       and torch.equal(got[1], want[1])),
           "moe_combine_max_abs_err": (native_tail.moe_combine(ga, ea, eb, m)
                                       - native_tail.moe_combine_plain(ga, ea, eb, m)).abs().max().item()}
    calls = {"topk": lambda x: native_tail.topk(x[3], k), "moe_combine": lambda x: native_tail.moe_combine(*x[:3], m),
             "torch_topk": lambda x: torch.topk(x[3], k)}
    for name, fn in calls.items():
        turn = itertools.cycle(sets)
        out[name] = {"device_ms": chip_smoke.device_ms(lambda: fn(sets[0])),
                     "event_ms": chip_smoke.time_ms(lambda: fn(sets[0]), reps=50),
                     "sets_in_turn_device_ms": chip_smoke.device_ms(lambda: fn(next(turn))),
                     "sets_in_turn_event_ms": chip_smoke.time_ms(lambda: fn(next(turn)), reps=50)}
    out["topk"]["bound_ms"] = (b * v * 4 + b * k * 8) / chip_smoke.PEAK_BYTES * 1e3
    out["moe_combine"]["bound_ms"] = (b * (m + 1) * v + b * m * v + m * v + b * v) * 4 / chip_smoke.PEAK_BYTES * 1e3
    del sets, ga, ea, eb, probs
    out.update(runner_batches(dev, TAIL_ROUTES, ("topk", "moe_combine")))
    return out


def runner_batches(dev, routes, needles: tuple) -> dict:
    """The runner's batches of ``routes`` ((model, batches) pairs; random
    weights and frames from one seed): each batch's host ms (the median of
    five, the frames' copy included) and the device ms of its kernels whose
    names hold one of ``needles``."""
    out = {}
    rng = np.random.default_rng(5)
    for name, batches in routes:
        mcfg, fcfg = chip_smoke.route_config(name, {})
        tree = chip_smoke.seeded_tree(name, mcfg, fcfg)
        for batch in batches:
            feats = rng.integers(0, 256, (batch, chip_smoke.F, chip_smoke.DT), dtype=np.uint8)
            nfs = rng.integers(1, chip_smoke.F + 1, batch).astype(np.int32)
            with tempfile.TemporaryDirectory(prefix="kernel_ab_") as export_dir:
                export_lib.export_model(export_dir, name, mcfg, fcfg, tree["params"], tree["batch_stats"],
                                        with_stablehlo=True, stablehlo_batch_size=batch)
                exe = native_runtime.NativeExecutable.from_export_dir(export_dir, dev)
                exe.run(feats, nfs)
                runs = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    exe.run(feats, nfs)
                    runs.append((time.perf_counter() - t0) * 1e3)
                out[f"{name}_B{batch}"] = {"route_ms_per_batch": statistics.median(runs),
                                           "kernel_device_ms": kernel_device_ms(lambda: exe.run(feats, nfs), needles)}
                exe.close()
        del tree
    torch.cuda.empty_cache()
    return out


# the runner's routes timed with their stage kernels, at batch 256
STAGE_ROUTES = ("NeXtVLADModel", "NetRVLADModelLF", "TransformerEncoderModel", "FrameLevelLogisticModel")
# input sets in turn: frames of 88.5 MB a set (the sampled modes draw 8.8 MB
# of each), the residual's 65 MB of agg and assign (rgb) a set
STAGE_SETS, RESIDUAL_SETS = 8, 4


def clock(fn, needle: str, reps: int = 20) -> dict:
    """``fn`` on the profiler's device clock (the kernels named by
    ``needle``, ms a call; device_records) with the count of those kernels'
    records it kept for ``reps`` calls, and by CUDA events around a run of ``reps`` calls
    (the host's pace where a call's launch takes longer than its kernel)."""
    spans = [us for name, us in device_records(fn, reps) if needle in name]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return {"device_ms": sum(spans) / 1e3 / reps, "records": len(spans), "calls": reps,
            "event_ms": start.elapsed_time(end) / reps}


def stage_times(dev) -> dict:
    """stage_alone and stage_routes."""
    return {**stage_alone(dev), **stage_routes(dev)}


def stage_alone(dev) -> dict:
    """frame_stage's four modes and nextvlad_residual (rgb, audio) alone at
    B=256 on sets in turn and on one set, beside an HBM copy of as many
    bytes as every frame in bf16 moves and a fill of as many as every frame
    in f32 writes."""
    gen = torch.Generator(device=dev).manual_seed(29)
    b, f, s, dt = 256, chip_smoke.F, 30, chip_smoke.DT
    key = prng.key(0)
    in_scale = torch.randn((dt,), generator=gen, device=dev) * 0.1 + 1.0
    in_bias = torch.randn((dt,), generator=gen, device=dev) * 0.05
    frame_sets = [(torch.randint(0, 256, (b, f, dt), generator=gen, device=dev, dtype=torch.uint8),
                   torch.randint(0, f + 1, (b,), generator=gen, device=dev, dtype=torch.int32))
                  for _ in range(STAGE_SETS)]
    modes = {
        "affine": (lambda x, nf: native_tail.frame_stage(x, key, nf, s, in_scale, in_bias),
                   lambda x, nf: native_tail.frame_stage_plain(x, key, nf, s, in_scale, in_bias)),
        "window": (lambda x, nf: native_tail.frame_stage(x, key, nf, s, window=True),
                   lambda x, nf: native_tail.frame_stage_plain(x, key, nf, s, window=True)),
        "all_bf16": (lambda x, nf: native_tail.frame_stage_all(x, nf), native_tail.frame_stage_all_plain),
        "all_f32": (lambda x, nf: native_tail.frame_stage_all(x, nf, torch.float32),
                    lambda x, nf: native_tail.frame_stage_all_plain(x, nf, torch.float32)),
    }
    # a device-to-device copy that moves as many bytes as every frame in bf16
    # (88.5 MB read, 177 MB written: 132.7 MB each way), the rate a stream
    # of reads and writes reaches on this card
    src = torch.empty((b * f * dt * 3 // 2,), dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy = clock(lambda: dst.copy_(src), "")
    out = {"hbm_copy_265MB": dict(copy, tb_per_s=2 * src.numel() / (copy["device_ms"] * 1e-3) / 1e12)}
    del src, dst
    # a fill of as many bytes as every frame in f32 writes (354 MB): the rate
    # of writes alone
    dst = torch.empty((b * f * dt,), dtype=torch.float32, device=dev)
    fill = clock(lambda: dst.fill_(1.0), "")
    out["hbm_fill_354MB"] = dict(fill, tb_per_s=4 * dst.numel() / (fill["device_ms"] * 1e-3) / 1e12)
    del dst
    for mode, (kernel, plain) in modes.items():
        got, want = kernel(*frame_sets[0]), plain(*frame_sets[0])
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        turn = itertools.cycle(frame_sets)
        out[f"frame_stage/{mode}"] = {
            "max_abs_err": (got[0].float() - want[0].float()).abs().max().item(),
            "in_turn": clock(lambda: kernel(*next(turn)), "frame_stage"),
            "one_set": clock(lambda: kernel(*frame_sets[0]), "frame_stage"),
            "bound_ms": statistics.mean(stage_bytes(x, nf, s, mode, key) for x, nf in frame_sets)
            / chip_smoke.PEAK_BYTES * 1e3}
        del got, want
    del frame_sets
    for label, dp in (("rgb", 256), ("audio", 32)):
        k, sg = 128, 240
        sets = [(torch.randn((b, k, dp), generator=gen, device=dev),
                 torch.softmax(torch.randn((b, sg, 1, k), generator=gen, device=dev) * 3.0, dim=-1),
                 torch.randn((k, dp), generator=gen, device=dev) * 0.1) for _ in range(RESIDUAL_SETS)]
        turn = itertools.cycle(sets)
        out[f"nextvlad_residual/{label}"] = {
            "max_abs_err": (native_tail.nextvlad_residual(*sets[0])
                            - native_tail.nextvlad_residual_plain(*sets[0])).abs().max().item(),
            "in_turn": clock(lambda: native_tail.nextvlad_residual(*next(turn)), "nextvlad_residual"),
            "one_set": clock(lambda: native_tail.nextvlad_residual(*sets[0]), "nextvlad_residual"),
            "bound_ms": (2 * b * k * dp + b * sg * k + k * dp) * 4 / chip_smoke.PEAK_BYTES * 1e3}
        del sets
    torch.cuda.empty_cache()
    return out


def stage_routes(dev) -> dict:
    """The runner's batches of STAGE_ROUTES at 256: host ms a batch, its
    frame_stage and nextvlad_residual kernels' device ms."""
    return runner_batches(dev, [(name, (256,)) for name in STAGE_ROUTES], ("frame_stage", "nextvlad_residual"))


def stage_bytes(x, nf, s: int, mode: str, key) -> int:
    """The bytes frame_stage's ``mode`` must move (the distinct rows drawn,
    or every row; the output and the key mask once), as
    ``chip_smoke.stage_bytes`` counts them (a parent's chip_smoke may lack
    it)."""
    b, f, dt = x.shape
    if mode in ("affine", "window"):
        from learnablepoolingmethods_torch.ops import fused_frontend
        draw = fused_frontend.sequence_indices if mode == "window" else fused_frontend.sample_indices
        rows = sum(len(torch.unique(r)) for r in draw(key, nf, f, s).cpu())
        return rows * dt + b * 4 + b * s * dt * 2 + (2 * dt * 4 if mode == "affine" else 0)
    return b * f * dt + b * 4 + b * f * dt * (2 if mode == "all_bf16" else 4) + b * f * 4


# the runner's routes timed with hidden_sum and gating, and their batches
GATED_ROUTES = (("NetVLADModelLF", (32, 256)), ("NetFVModelLF", (256,)))
# hidden_sum's and gating's input sets in turn at B=256, H=1024: 8 MB of
# inputs a set, 128 MB in all, past the 50 MB L2
GATED_SETS = 16
GATED_KERNELS = ("hidden_sum_kernel", "gating_kernel")


def gated_calls(b: int, h: int) -> dict:
    """name → (the kernel's call on an input set, its plain version's, the
    bytes it must move: each input read once, each output written once)."""
    nt = native_tail
    sum_out, bias = b * h * (4 + 2), h * 4
    return {
        "hidden_sum/two_parts": (lambda x: nt.hidden_sum(x["parts"][:2], x["bias"]),
                                 lambda x: nt.hidden_sum_plain(x["parts"][:2], x["bias"]), 2 * b * h * 4 + bias + sum_out),
        "hidden_sum/four_parts_in_pairs": (lambda x: nt.hidden_sum(x["parts"], x["bias"], 2, True),
                                           lambda x: nt.hidden_sum_plain(x["parts"], x["bias"], 2, True),
                                           4 * b * h * 4 + bias + sum_out),
        "gating/bf16": (lambda x: nt.gating(x["gates"], x["h"], x["g_scale"], x["g_bias"]),
                        lambda x: nt.gating_plain(x["gates"], x["h"], x["g_scale"], x["g_bias"]),
                        2 * b * h * 4 + 2 * h * 4 + b * h * 2),
        "gating/f32": (lambda x: nt.gating(x["gates"], x["h"], x["g_scale"], x["g_bias"], torch.float32),
                       lambda x: nt.gating_plain(x["gates"], x["h"], x["g_scale"], x["g_bias"], torch.float32),
                       2 * b * h * 4 + 2 * h * 4 + b * h * 4),
    }


def gated_times(dev) -> dict:
    """hidden_sum and gating alone at B=256, H=1024 (equal to their plain
    versions bit for bit or not), each on the profiler's device clock with
    its record count, on one input set read again (as the route finds its
    products, in the L2) and on GATED_SETS sets in turn, beside a device
    copy_ of as many bytes (half read, half written; a DMA copy) and
    PyTorch's element-wise kernel over them (torch.neg, half read, half
    written), each on one buffer pair and on GATED_SETS pairs in turn, and
    the bytes bound; then the runner's batches of GATED_ROUTES."""
    gen = torch.Generator(device=dev).manual_seed(37)
    b, h = 256, 1024

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    sets = [dict(parts=[randn(b, h, scale=0.5) for _ in range(4)], bias=randn(h, scale=0.1),
                 gates=randn(b, h, scale=2.0), h=randn(b, h), g_scale=randn(h, scale=0.2) + 1.0,
                 g_bias=randn(h, scale=0.1)) for _ in range(GATED_SETS)]
    out = {}
    for name, (kernel, plain, nbytes) in gated_calls(b, h).items():
        got, want = kernel(sets[0]), plain(sets[0])
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        equal = all(torch.equal(g.view(ints[g.dtype]), w.view(ints[w.dtype])) for g, w in zip(got, want))
        pairs = [(torch.ones((nbytes // 8,), device=dev), torch.empty((nbytes // 8,), device=dev))
                 for _ in range(GATED_SETS)]
        needle = next(k for k in GATED_KERNELS if name.startswith(k.removesuffix("_kernel")))
        turn, copy_turn = itertools.cycle(sets), itertools.cycle(pairs)
        out[name] = {"equal_to_plain": equal, "bytes": nbytes,
                     "one_set": clock(lambda: kernel(sets[0]), needle),
                     "in_turn": clock(lambda: kernel(next(turn)), needle),
                     "copy_one_set": clock(lambda: pairs[0][1].copy_(pairs[0][0]), ""),
                     "copy_in_turn": clock(lambda: (lambda p: p[1].copy_(p[0]))(next(copy_turn)), ""),
                     "elementwise_one_set": clock(lambda: torch.neg(pairs[0][0], out=pairs[0][1]), ""),
                     "elementwise_in_turn": clock(lambda: (lambda p: torch.neg(p[0], out=p[1]))(next(copy_turn)), ""),
                     "bound_ms": nbytes / chip_smoke.PEAK_BYTES * 1e3}
        del got, want, pairs
    del sets
    out.update(runner_batches(dev, GATED_ROUTES, ("hidden_sum", "gating")))
    return out


def ptxas_resources(text: str, needles: tuple) -> dict:
    """Registers, stack frame and spill bytes of each kernel whose mangled
    name holds one of ``needles``, from nvcc's -Xptxas -v output ``text``."""
    out, current = {}, None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            current = entry.group(1) if any(n in entry.group(1) for n in needles) else None
            if current:
                out[current] = {}
        elif current and "stack frame" in line:
            out[current].update(zip(("stack_frame", "spill_stores", "spill_loads"),
                                    (int(n) for n in re.findall(r"(\d+) bytes", line))))
        elif current and "Used" in line:
            out[current]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    parser.add_argument("--parts", default="int8,pool,gru,dropout,tail,stage,gated")
    args = parser.parse_args()
    parts = set(args.parts.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run on the card only")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = {"label": args.label, "card": smi}
    if "gated" in parts:  # built first, so that nvcc's report of the runner's kernels is kept
        kernel_build.build(["native_runner"], ptxas=["native_runner"])
        line["gated_ptxas"] = ptxas_resources(kernel_build._ptxas_output.get("native_runner", ""), GATED_KERNELS)
    if "int8" in parts:
        _, timing, library = chip_smoke.phase_int8_matmul(dev, smi)
        line.update(int8_matmul_b512=timing["int8_matmul"][0], cublas_b512=library["int8_matmul"])
    if "pool" in parts:
        line["pool_attention"] = pool_times(dev)
    if "gru" in parts:
        line["gru"] = gru_times(dev)
    if "dropout" in parts:
        line["dropout"] = dropout_times(dev)
    if "tail" in parts:
        line["tail"] = tail_times(dev)
    if "stage" in parts:
        line["stage"] = stage_times(dev)
    if "gated" in parts:
        line["gated"] = gated_times(dev)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
