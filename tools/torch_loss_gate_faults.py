"""Planted gradient faults against chip_smoke.py's fused-vs-plain loss gates.

    python3 tools/torch_loss_gate_faults.py

from the root of a checkout, on one NVIDIA GPU (Hopper, sm_90a).  It runs
chip_smoke.py's train_e2e comparison: five steps of the PyTorch port's
train CLI at full Willow width (B=256, S=30) on 512 synthetic videos, the
fused route against the plain one from the same weights and batches, in
bf16 and in f32.  First as the code is, then once for each fault in FAULTS,
planted in the output of the training backward kernel's wrapper for the
length of the fused runs.  It prints one JSON line per fault with the
relative loss gap of each step and, per gate of ``chip_smoke.LOSS_GATES``,
whether the gate would stop the run.  It imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from learnablepoolingmethods_torch.data.fixtures import write_frame_level_fixture  # noqa: E402
from learnablepoolingmethods_torch.ops import netvlad_train  # noqa: E402


def _zero_cluster0(t):
    t = t.clone()
    t[..., 0] = 0
    return t


# fault → (output of (dX, dL, dC₂) it changes, how)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_loss_gate_faults: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fused = [f for f, _, _ in chip_smoke.LOSS_GATES]
    with tempfile.TemporaryDirectory(prefix="loss_gate_faults_") as workdir:
        data = os.path.join(workdir, "train-0.tfrecord")
        write_frame_level_fixture(data, 512, seed=0)
        plain, _ = chip_smoke.train_runs(data, workdir, [p for _, p, _ in chip_smoke.LOSS_GATES])
        sound = netvlad_train.netvlad_aggregate_backward
        for fault, spec in {"none": None, **FAULTS}.items():
            if spec is not None:
                netvlad_train.netvlad_aggregate_backward = planted(sound, *spec)
            try:
                runs, _ = chip_smoke.train_runs(data, workdir, fused)
            finally:
                netvlad_train.netvlad_aggregate_backward = sound
            gaps = chip_smoke.loss_gaps({**plain, **runs})
            chip_smoke.emit({
                "fault": fault, "loss_rel_gap": gaps,
                "losses": {r: runs[r]["losses"] for r in fused},
                "gate_stops_it": {f: max(gaps[f]) > limit or gaps[f][0] > 1e-5
                                  for f, _, limit in chip_smoke.LOSS_GATES},
            })
    chip_smoke.emit({"plain_losses": {r: plain[r]["losses"] for r in plain}})
    print(chip_smoke.phase_env(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
