"""Planted faults against chip_smoke.py's item-12b gates.

    python3 tools/torch_12b_gate_faults.py

from the root of a checkout, on one NVIDIA GPU (Hopper, sm_90a).  It
imports nothing of JAX.  Each fault is planted in a copy of the kernel
sources (built into a scratch directory and loaded in place of the real
library) or in the train step, the gate that must stop it is run, and one
JSON line says what the gate read and whether it failed:

- FusedAdam with ν rounded to nearest: chip_smoke.sr_nu_ema against
  FUSED_ADAM_EMA_GATE (the kernel-against-plain check cannot see it: a
  round-to-nearest ν is one of the two neighbours);
- FusedAdam with the per-leaf clip skipped: chip_smoke.check_fused_adam on
  the whole Willow tree (m bit for bit, p on a bf16 neighbour);
- the W8A16 kernel with its first K-split dropped from the reduction:
  chip_smoke.check_int8 at the Willow rgb FC, B=32 (INT8_GATE);
- --use_remat with the BN statistics updated in the recompute too:
  chip_smoke.remat_gaps against REMAT_GATE.

First the gates on the code as it is (each must pass), then each fault.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from learnablepoolingmethods_torch.config import FeatureConfig, ModelConfig  # noqa: E402
from learnablepoolingmethods_torch.core import step as step_lib  # noqa: E402
from learnablepoolingmethods_torch.core.weights import init_variables_np  # noqa: E402
from learnablepoolingmethods_torch.ops import kernel_build  # noqa: E402

# fault → (source, the line as it is, the line planted)
SOURCE_FAULTS = {
    "fused_adam: nu rounded to nearest": (
        "fused_adam", "vo[j] = stochastic_round(v[j], bits[j] >> 16);", "vo[j] = __float2bfloat16_rn(v[j]);"),
    "fused_adam: clip skipped": (
        "fused_adam", "const float scale = clip ? scales[li] : 1.0f;", "const float scale = 1.0f;"),
    "int8_matmul: first K-split dropped": (
        "int8_matmul", "for (int sp = 0; sp < splits; ++sp)", "for (int sp = 1; sp < splits; ++sp)"),
}


@contextlib.contextmanager
def planted_source(source: str, line: str, fault: str):
    """kernel_build loads ``source`` from a copy of csrc/ with ``line``
    replaced by ``fault``, built into a scratch directory."""
    saved = kernel_build.CSRC_DIR, kernel_build.BUILD_DIR
    with tempfile.TemporaryDirectory(prefix="lpm_fault_") as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(saved[0], csrc)
        path = os.path.join(csrc, f"{source}.cu")
        with open(path) as f:
            text = f.read()
        if text.count(line) != 1:
            raise RuntimeError(f"{source}.cu: the line to replace occurs {text.count(line)} times")
        with open(path, "w") as f:
            f.write(text.replace(line, fault))
        kernel_build.CSRC_DIR, kernel_build.BUILD_DIR = type(saved[0])(csrc), type(saved[1])(os.path.join(tmp, "b"))
        kernel_build._loaded.clear()
        kernel_build._functions.clear()
        try:
            yield
        finally:
            kernel_build.CSRC_DIR, kernel_build.BUILD_DIR = saved
            kernel_build._loaded.clear()
            kernel_build._functions.clear()


@contextlib.contextmanager
def bn_updated_twice():
    """The remat recompute updates the BN statistics again."""
    saved = step_lib.batch_stats_frozen
    step_lib.batch_stats_frozen = lambda model, frozen=True: contextlib.nullcontext()
    try:
        yield
    finally:
        step_lib.batch_stats_frozen = saved


def gates(dev):
    """Each gate → a function returning (reading, passes)."""
    def ema():
        read = chip_smoke.sr_nu_ema(dev)
        return read, read["sr"] <= chip_smoke.FUSED_ADAM_EMA_GATE

    def clip():
        try:
            return chip_smoke.check_fused_adam("willow", chip_smoke.willow_leaves(dev), 1.0, {}), True
        except AssertionError as e:
            return str(e), False

    def int8():
        k, n = chip_smoke.INT8_SHAPES["willow_rgb"]
        x, q, s, _ = chip_smoke.int8_inputs(torch.Generator(device=dev).manual_seed(7), 32, k, n, dev)
        try:
            return chip_smoke.check_int8("willow_rgb B=32", x, q, s, None, {}), True
        except AssertionError as e:
            return str(e), False

    def remat():
        mcfg = ModelConfig()
        tree = init_variables_np(mcfg, FeatureConfig(("rgb", "audio"), (1024, 128), True, 300), seed=0)
        read = chip_smoke.remat_gaps(dev, tree)
        return read, read["loss_gap"] <= chip_smoke.REMAT_GATE and read["batch_stats_gap"] <= chip_smoke.REMAT_GATE

    return {"fused_adam: nu rounded to nearest": ema, "fused_adam: clip skipped": clip,
            "int8_matmul: first K-split dropped": int8, "remat: BN updated twice": remat}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_12b_gate_faults: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = chip_smoke.phase_env()
    kernel_build.build(("fused_adam", "int8_matmul"))
    ok = True
    for fault, gate in gates(dev).items():
        reading, passes = gate()
        chip_smoke.emit({"fault": fault, "planted": False, "gate_passes": passes, "reading": reading, "card": smi})
        ok &= passes
        ctx = planted_source(*SOURCE_FAULTS[fault]) if fault in SOURCE_FAULTS else bn_updated_twice()
        with ctx:
            reading, passes = gate()
        chip_smoke.emit({"fault": fault, "planted": True, "gate_fails": not passes, "reading": reading,
                         "card": smi})
        ok &= not passes
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
