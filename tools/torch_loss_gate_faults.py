"""Planted gradient faults against chip_smoke.py's training gates.

    python3 tools/torch_loss_gate_faults.py [NetVLADModelLF,NetRVLADModelLF]

from the root of a checkout, on one NVIDIA GPU (Hopper, sm_90a), for the
models named (both by default).  It imports nothing of JAX.

- NetVLADModelLF (train_e2e; C₂ learned): five steps of the train CLI at
  full Willow width (B=256, S=30) on 512 synthetic videos, the fused route
  against the plain one from the same weights and batches, in bf16 and in
  f32, read by ``chip_smoke.LOSS_GATES``.
- NetRVLADModelLF (train_zoo_e2e; C₂ = 0): the same five steps of the f32
  pair at the CLI's default learning rate, read by ``ZOO_LOSS_GATES``, and
  the step-1 gradient of every parameter tensor on each route against the
  plain f32 route's, read by ``ZOO_GRAD_GATES``.

First as the code is, then once for each fault in FAULTS, planted in the
output of the training backward kernel's wrapper for the length of the
fused runs; one JSON line per model and fault with the readings and, per
gate, whether it would stop the run.  Then, for NetRVLADModelLF, the step-1
gradients with the backward kernel replaced by each of ROUNDINGS: where the
fused bf16 route's distance from f32 comes from.
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from learnablepoolingmethods_torch import train  # noqa: E402
from learnablepoolingmethods_torch.data.fixtures import write_frame_level_fixture  # noqa: E402
from learnablepoolingmethods_torch.ops import netvlad_train  # noqa: E402


def _zero_cluster0(t):
    t = t.clone()
    t[..., 0] = 0
    return t


# fault → (output of (dX, dL, dC₂) it changes, how).  At C₂ = 0 (NetRVLAD)
# dC₂ reaches no parameter, so its two faults cannot show there
FAULTS = {
    "dC2 zeroed": (2, torch.zeros_like),
    "dL zeroed": (1, torch.zeros_like),
    "dX zeroed": (0, torch.zeros_like),
    "dC2 doubled": (2, lambda t: 2 * t),
    "dL halved": (1, lambda t: t / 2),
    "dL of cluster 0 zeroed": (1, _zero_cluster0),
}


def planted(backward, which: int, change):
    def faulty(*args):
        out = list(backward(*args))
        out[which] = change(out[which])
        return tuple(out)
    # the wrapper counts its launches on the module attribute, now this one
    faulty.launches = 0
    return faulty


def _backward_dv1_f32(x, logits, c2, dv3):
    """The backward kernel's plain version with dV₁ kept in f32 for X·dV₁
    and A·dV₁ᵀ (the kernel rounds it to x's dtype)."""
    a, s, dv1 = netvlad_train.netvlad_dv1_plain(x, logits, c2, dv3)
    da = torch.einsum("bfd,bdk->bfk", x.float(), dv1) - torch.sum(dv1 * c2[None], dim=1, keepdim=True)
    dl = a * (da - torch.sum(a * da, dim=-1, keepdim=True))
    dx = torch.einsum("bfk,bdk->bfd", a.to(x.dtype).float(), dv1)
    return dx.to(x.dtype), dl, torch.sum(-dv1 * s, dim=0)


def _backward_reference(x, logits, c2, dv3):
    """The VJP of netvlad_aggregate_reference: f32 throughout, A never
    rounded."""
    with torch.enable_grad():
        xf, lf, cf = (t.detach().float().requires_grad_() for t in (x, logits, c2))
        out = netvlad_train.netvlad_aggregate_reference(xf, lf, cf)
        dx, dl, dc2 = torch.autograd.grad(out, (xf, lf, cf), dv3.float().reshape(out.shape))
    return dx.to(x.dtype), dl, dc2


# the backward of the fused routes → what it rounds
ROUNDINGS = {
    "kernel": (None, "the CUDA kernel: A and dV₁ rounded to x's dtype"),
    "plain version": (netvlad_train.netvlad_aggregate_backward_plain, "the same rounding in PyTorch"),
    "dV1 in f32": (_backward_dv1_f32, "A rounded, dV₁ not"),
    "reference": (_backward_reference, "neither rounded"),
}


def zoo_losses(data: str, workdir: str, route: str) -> list:
    """The five losses of NetRVLADModelLF's ``route`` in the train CLI."""
    run = f"NetRVLADModelLF/{route}"
    trainer = train.main(chip_smoke.ZOO_STEP_FLAGS + chip_smoke.zoo_model_flags(run) + [
        f"--train_data_pattern={data}", f"--train_dir={os.path.join(workdir, route)}"])
    return [h["loss"] for h in trainer.history]


def willow(data: str, workdir: str, fault: str, plain: dict) -> dict:
    fused = [f for f, _, _ in chip_smoke.LOSS_GATES]
    runs, _ = chip_smoke.train_runs(data, workdir, fused)
    gaps = chip_smoke.loss_gaps({**plain, **runs})
    return {"loss_rel_gap": gaps, "losses": {r: runs[r]["losses"] for r in fused},
            "gate_stops_it": {f: max(gaps[f]) > limit or gaps[f][0] > 1e-5
                              for f, _, limit in chip_smoke.LOSS_GATES}}


def netrvlad(dev, data: str, workdir: str, first, plain: dict) -> dict:
    grads = chip_smoke.step1_gradient_gaps(dev, "NetRVLADModelLF", *first)
    worst = {route: max(g.items(), key=lambda kv: kv[1]) for route, g in grads.items()}
    out = {"step1_gradient_worst": worst,
           "gate_stops_it": {route: gap > chip_smoke.ZOO_GRAD_GATES[route]
                             for route, (_, gap) in worst.items()}}
    for fused, plain_route, limit in chip_smoke.ZOO_LOSS_GATES:
        losses = zoo_losses(data, workdir, fused)
        gap = [abs(a - b) / abs(b) for a, b in zip(losses, plain[plain_route])]
        out[f"{fused}_loss_rel_gap"] = gap
        out["gate_stops_it"][f"{fused} loss"] = max(gap) > limit or gap[0] > 1e-5
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_loss_gate_faults: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    models = sys.argv[1].split(",") if len(sys.argv) > 1 else ["NetVLADModelLF", "NetRVLADModelLF"]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sound = netvlad_train.netvlad_aggregate_backward
    with tempfile.TemporaryDirectory(prefix="loss_gate_faults_") as workdir:
        data = os.path.join(workdir, "train-0.tfrecord")
        write_frame_level_fixture(data, 512, seed=0)
        plain, first = {}, None
        if "NetVLADModelLF" in models:
            plain["NetVLADModelLF"], _ = chip_smoke.train_runs(
                data, workdir, [p for _, p, _ in chip_smoke.LOSS_GATES])
        if "NetRVLADModelLF" in models:
            plain["NetRVLADModelLF"] = {p: zoo_losses(data, workdir, p) for _, p, _ in chip_smoke.ZOO_LOSS_GATES}
            args = chip_smoke.zoo_args("NetRVLADModelLF/plain_f32")
            first = chip_smoke.zoo_first_batch(*args, data), chip_smoke.zoo_init(*args)
        for fault, spec in {"none": None, **FAULTS}.items():
            if spec is not None:
                netvlad_train.netvlad_aggregate_backward = planted(sound, *spec)
            try:
                for model in models:
                    line = (willow(data, workdir, fault, plain[model]) if model == "NetVLADModelLF"
                            else netrvlad(dev, data, workdir, first, plain[model]))
                    chip_smoke.emit({"model": model, "fault": fault, **line})
            finally:
                netvlad_train.netvlad_aggregate_backward = sound
        if "NetRVLADModelLF" in models:
            for name, (backward, what) in ROUNDINGS.items():
                if backward is not None:
                    netvlad_train.netvlad_aggregate_backward = backward
                try:
                    grads = chip_smoke.step1_gradient_gaps(dev, "NetRVLADModelLF", *first)
                finally:
                    netvlad_train.netvlad_aggregate_backward = sound
                chip_smoke.emit({"model": "NetRVLADModelLF", "backward": name, "rounds": what,
                                 "step1_gradient_rel_distance": {
                                     route: {n: g for n, g in grads[route].items()
                                             if "cluster_bn" in n or g == max(grads[route].values())}
                                     for route in ("fused", "fused_f32")}})
        chip_smoke.emit({"plain_losses": plain})
    print(chip_smoke.phase_env(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
