"""Planted faults against chip_smoke.py's gates of the native runner's f32
routes of ROADMAP item 14c.5 (AttentionPoolingModel, LstmModel, GruModel).

    python3 tools/torch_route_gate_faults.py

from the root of a checkout, on one NVIDIA GPU (Hopper, sm_90a).  It
imports nothing of JAX.  The runner's sources are copied to a temporary
directory with one fault in each new kernel, built there and loaded in
place of the real library:

- ``lstm_cell`` with its input and forget gates swapped;
- ``gru_layer`` (the GRU route's kernel) writing the final carry one frame
  before each row's last;
- ``pool_attention`` without q / √hd.

Then chip_smoke.phase_native_routes runs each route alone at full width,
first with the trace gates open (NATIVE_ROUTE_GATES, the probabilities
against the torch route, must fail), then with them (ALL_FRAMES_TRACE_GATES
must fail).  One JSON line a route and gate says whether the gate failed
and with what message; the last line says whether every fault was caught.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from learnablepoolingmethods_torch.core import native_runtime  # noqa: E402
from learnablepoolingmethods_torch.ops import kernel_build  # noqa: E402

RUNS = ("AttentionPoolingModel", "LstmModel", "GruModel")
# (text, its replacement) in the runner's source, each once: the LSTM's
# gates swapped, the GRU layer's carry a frame early, the queries unscaled
FAULTS = (
    ("__fmul_rn(sigmoid(z[1]), c_in[i]), __fmul_rn(sigmoid(z[0]), tanhf(z[2]))",
     "__fmul_rn(sigmoid(z[0]), c_in[i]), __fmul_rn(sigmoid(z[1]), tanhf(z[2]))"),
    ("if (carry && t == last_frame(frames[i], F)) carry[b * H + j] = h;",
     "if (carry && t == last_frame(frames[i], F) - 1) carry[b * H + j] = h;"),
    ("__fdiv_rn(q[(long long)(q0 + r) * D + (long long)head * hd + d], scale)",
     "__fdiv_rn(q[(long long)(q0 + r) * D + (long long)head * hd + d], 1.f)"),
)


def faulty_sources(tmp: Path) -> Path:
    """csrc/ copied into ``tmp`` with FAULTS."""
    csrc = tmp / "csrc"
    shutil.copytree(kernel_build.CSRC_DIR, csrc)
    runner = csrc / kernel_build.sources(native_runtime.LIBRARY)[0].name
    src = runner.read_text()
    for old, new in FAULTS:
        if src.count(old) != 1:
            raise AssertionError(f"the fault's text is not in {runner.name} once: {old}")
        src = src.replace(old, new)
    runner.write_text(src)
    return csrc


def main() -> int:
    tmp = Path(tempfile.mkdtemp(prefix="route_faults_"))
    try:
        kernel_build.CSRC_DIR, kernel_build.BUILD_DIR = faulty_sources(tmp), tmp / "build"
        native_runtime.SERVE_BUILD_DIR = tmp / "host"
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        smi = cs.phase_env()
        kernel_build.build([native_runtime.LIBRARY])
        cs.NATIVE_ROUTES_HTTP = ()  # lpm_serve answers as the in-process runner does
        cs.check_route_kernels = lambda dev, errors: ({}, {}, {})  # the faults break these too
        runs = {run: cs.NATIVE_ROUTE_RUNS[run] for run in RUNS}
        trace_gates = dict(cs.ALL_FRAMES_TRACE_GATES)
        caught = []
        for gates in ("probability", "trace"):
            for route in ("attention_pooling",) + native_runtime.RNN_ROUTES:
                cs.ALL_FRAMES_TRACE_GATES[route] = (
                    {"default": float("inf")} if gates == "probability" else trace_gates[route])
            for run, spec in runs.items():
                cs.NATIVE_ROUTE_RUNS = {run: spec}
                with tempfile.TemporaryDirectory() as workdir:
                    try:
                        cs.phase_native_routes(dev, workdir, smi, {"path": None, "seconds": 0})
                        line = {"run": run, "gates": gates, "caught": False}
                    except AssertionError as e:
                        line = {"run": run, "gates": gates, "caught": True, "by": str(e)[:600]}
                caught.append(line["caught"])
                print(json.dumps({"phase": "route_gate_faults", **line, "card": smi}), flush=True)
        print(json.dumps({"all_faults_caught": all(caught)}), flush=True)
        return 0 if all(caught) else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
