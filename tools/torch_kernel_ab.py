"""Time the W8A16 hidden FC and ``pool_attention`` of the checkout in the
working directory, so that two checkouts can be compared in one run on
one card.

The W8A16 kernel is timed by ``chip_smoke.phase_int8_matmul`` (the Willow
rgb FC at every batch of ``INT8_BATCHES``, beside cuBLAS bf16 on the
weight dequantized once), ``pool_attention`` at AttentionPoolingModel's
default width (B=256, F=300, 64 queries, 8 heads of 128, f32, frame
counts from ``chip_smoke``'s generator, one video of none) on the
profiler's device clock and by CUDA events, beside SDPA on the biased
heads.  It prints one JSON line with the card's name and power limit.

Compare a change with its parent (``git archive`` of each unpacked into
git-ignored directories), in turns: parent, change, change, parent::

    for d in parent change change parent; do (cd $d && python3 ../tools/torch_kernel_ab.py --label $d); done
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402  (the checkout's own)
from learnablepoolingmethods_torch.ops import native_tail  # noqa: E402


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run on the card only")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    _, timing, library = chip_smoke.phase_int8_matmul(dev, smi)
    print(json.dumps({"label": args.label, "card": smi, "int8_matmul_b512": timing["int8_matmul"][0],
                      "cublas_b512": library["int8_matmul"], "pool_attention": pool_times(dev)}), flush=True)


if __name__ == "__main__":
    main()
