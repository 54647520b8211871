"""Time the W8A16 hidden FC, ``pool_attention``, the GRU layer and the
dropout kernel's two launches of the checkout in the working directory,
so that two checkouts can be compared in one run on one card.

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
checkout keeps them, else the hashing launch again).  It prints one JSON
line with the card's name and power limit.

Compare a change with its parent (``git archive`` of each unpacked into
git-ignored directories), in turns: parent, change, change, parent::

    for d in parent change change parent; do (cd $d && python3 ../tools/torch_kernel_ab.py --label $d); done

``--parts gru,dropout`` times only those parts (of int8, pool, gru,
dropout).
"""

import argparse
import json
import os
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    parser.add_argument("--parts", default="int8,pool,gru,dropout")
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
    if "int8" in parts:
        _, timing, library = chip_smoke.phase_int8_matmul(dev, smi)
        line.update(int8_matmul_b512=timing["int8_matmul"][0], cublas_b512=library["int8_matmul"])
    if "pool" in parts:
        line["pool_attention"] = pool_times(dev)
    if "gru" in parts:
        line["gru"] = gru_times(dev)
    if "dropout" in parts:
        line["dropout"] = dropout_times(dev)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
