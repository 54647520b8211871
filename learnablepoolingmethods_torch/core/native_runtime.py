"""The native runner: the Willow fast route served with no Python in its
execution path (ref: learnablepoolingmethods_tpu/core/native_runtime.py).

The JAX package runs its exported StableHLO module with XLA's PJRT CPU
client (``native/stablehlo_runner.cc``).  The card's machine has neither,
so the port's runner is a CUDA C++ program of the fast NetVLAD route
(``csrc/native_runner.cu``): row 1's kernel, cuBLAS for the hidden FC and
the MoE, and the tail kernels of ``ops/native_tail.py``.  It reads the
artifact that ``export_model(..., with_stablehlo=True)`` writes:

    native_manifest.txt   the JAX package's line format and lines, and the
                          port's: the route, the sampling key, iterations,
                          moe_num_mixtures and one named line per array
    weights.bin           the arrays of ops/fast_infer.py#prepare_fast_params
                          (BN folded; bf16 and f32 as the kernels read
                          them), dense, row-major, little-endian, in the
                          manifest's order

``NativeExecutable`` binds the runner in-process through ``ctypes``;
``build_serving_binary`` links it into ``lpm_serve``
(``native/serving_main.cc``), the HTTP server with no Python at all.  Both
run on the card only: there is no CPU runner and no fallback.
``plain_run`` is the runner's plain PyTorch version, the fast route's
plain versions over the artifact's arrays, for the tests and
``chip_smoke.py``.

    exe = NativeExecutable.from_export_dir(export_dir)   # weights uploaded once
    values, indices = exe.run(features_u8, num_frames)   # a batch of the export's size
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from learnablepoolingmethods_torch.config import ModelConfig
from learnablepoolingmethods_torch.data.native_loader import NATIVE_DIR
from learnablepoolingmethods_torch.ops import kernel_build
from learnablepoolingmethods_torch.ops.fast_infer import build_fast_netvlad_inference
from learnablepoolingmethods_torch.utils.misc import resolve_device

MANIFEST_FILE = "native_manifest.txt"
WEIGHTS_FILE = "weights.bin"
# csrc/native_manifest.h kRoute: the fast NetVLAD route of NetVLADModelLF
ROUTE = "fast_netvlad_frontend"
# the runner's arrays (prepare_fast_params' keys, "/" into its modality
# dicts), in weights.bin's order
ARRAYS = ("in_scale", "in_bias", "rgb/cluster", "rgb/scale", "rgb/bias", "rgb/c2",
          "aud/cluster", "aud/scale", "aud/bias", "aud/c2", "w_rgb", "w_aud", "hidden_b",
          "gate_w", "g_scale", "g_bias", "gates_kernel", "experts_kernel", "experts_bias")
TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the launches the runner counts (csrc/native_runner.cu kCounterNames)
COUNTERS = ("netvlad_frontend", "hidden_sum", "gating", "moe_combine", "topk")

LIBRARY = "native_runner"
SERVE_SOURCES = ("serving_main.cc", "tfrecord_reader.cc")
SERVE_CXX_FLAGS = ("-O2", "-std=c++17", "-pthread")
SERVE_BUILD_DIR = kernel_build.BUILD_DIR.parent / "host"
ERR_CAP = 4096


def array_of(arrays: dict, name: str):
    """The array ``name`` of ``ARRAYS`` in ``prepare_fast_params``' nested
    layout ("rgb/cluster" is ``arrays["rgb"]["cluster"]``)."""
    head, _, leaf = name.rpartition("/")
    return arrays[head][leaf] if head else arrays[name]


def read_manifest(export_dir: str) -> dict:
    """``native_manifest.txt`` → {"model", "batch_size", "top_k", …,
    "sampling_key": (k0, k1), "features": [(name, size)], "call_inputs" and
    "outputs": [(tag, shape)], "weights": [(name, tag, shape)]}.  Raises
    ValueError for a JAX export's manifest, which has no route line."""
    path = os.path.join(export_dir, MANIFEST_FILE)
    if not os.path.exists(path):
        raise ValueError(f"{export_dir} has no {MANIFEST_FILE}: export it with with_stablehlo=True")
    out = {"features": [], "call_inputs": [], "outputs": [], "weights": []}
    with open(path) as f:
        lines = [line.split() for line in f if line.strip()]
    if not lines or lines[0] != ["lpm_native_manifest", "1"]:
        raise ValueError(f"{path}: not a native manifest")
    if not any(words[0] == "route" for words in lines):
        raise ValueError(f"{path} has no route line: it is a JAX with_stablehlo export, which the port's runner "
                         "does not read; re-export it through learnablepoolingmethods_torch's "
                         "export_model(..., with_stablehlo=True)")
    for key, *rest in lines[1:]:
        if key in ("model", "route"):
            out[key] = rest[0]
        elif key == "sampling_key":
            out[key] = (int(rest[0]), int(rest[1]))
        elif key == "feature":
            out["features"].append((rest[0], int(rest[1])))
        elif key in ("call_input", "output"):
            out[f"{key}s"].append((rest[0], tuple(int(d) for d in rest[2:])))
        elif key == "weight":
            out["weights"].append((rest[0], rest[1], tuple(int(d) for d in rest[3:])))
        else:
            out[key] = int(rest[0])
    if out["route"] != ROUTE:
        raise ValueError(f"{path}: route {out['route']!r}, this runner's is {ROUTE!r}")
    return out


def read_artifact(export_dir: str) -> Tuple[dict, Dict[str, object]]:
    """(manifest, arrays): the arrays of ``weights.bin`` as CPU tensors in
    ``prepare_fast_params``' nested layout.  Raises ValueError when the
    file's size is not the sum of the manifest's arrays."""
    manifest = read_manifest(export_dir)
    blob = np.fromfile(os.path.join(export_dir, WEIGHTS_FILE), np.uint8)
    arrays, off = {}, 0
    for name, tag, shape in manifest["weights"]:
        dtype = np.int16 if tag == "bf16" else np.float32
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        if off + n > blob.size:
            break
        t = torch.from_numpy(blob[off:off + n].view(dtype).reshape(shape).copy())
        arrays[name] = t.view(torch.bfloat16) if tag == "bf16" else t
        off += n
    want = sum(int(np.prod(s, dtype=np.int64)) * (2 if t == "bf16" else 4) for _, t, s in manifest["weights"])
    if blob.size != want:
        raise ValueError(f"{WEIGHTS_FILE} has {blob.size} bytes, the manifest accounts for {want} — "
                         "re-export the artifact")
    nested: Dict[str, object] = {}
    for name, t in arrays.items():
        head, _, leaf = name.rpartition("/")
        (nested.setdefault(head, {}) if head else nested)[leaf] = t
    return manifest, nested


def _sizes(manifest: dict) -> dict:
    m = manifest["moe_num_mixtures"]
    (_, experts_bias), = [(n, s) for n, _, s in manifest["weights"] if n == "experts_bias"]
    return dict(batch=manifest["batch_size"], frames=manifest["max_frames"],
                width=sum(size for _, size in manifest["features"]), k=manifest["outputs"][0][1][1],
                vocab=experts_bias[0] // m)


def plain_run(manifest: dict, arrays: dict, features, num_frames, return_probs: bool = False):
    """The runner's plain PyTorch version: the fused fast route
    (``build_fast_netvlad_inference``) on the CPU, where each kernel's
    wrapper takes its plain version (row 1's is
    ``netvlad_frontend_reference``: ℓ2 in f32, one bf16 rounding, as the
    kernel), over the artifact's arrays, drawing frames from the manifest's
    key.  It equals ``load_exported_model(prefer_fast=True, device="cpu")``'s
    serve bit for bit (the staged route, ``use_kernels=False``, rounds
    elsewhere).  → (values, indices) [B, k], or the probabilities [B, V]."""
    sizes = _sizes(manifest)
    mcfg = ModelConfig(vocab_size=sizes["vocab"], moe_num_mixtures=manifest["moe_num_mixtures"],
                       iterations=manifest["iterations"])
    fn = build_fast_netvlad_inference(mcfg, top_k=sizes["k"], return_probs=return_probs)
    key = torch.tensor(manifest["sampling_key"], dtype=torch.int64)
    with torch.no_grad():
        return fn(arrays, torch.as_tensor(features).cpu(), torch.as_tensor(num_frames).cpu(), key)


def _card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the native runner runs on the card (a CUDA device), not on {dev}: it has no CPU "
                         "version; serve on the CPU through load_exported_model")
    return dev


class NativeExecutable:
    """An export's native artifact loaded into the runner on the card:
    ``run(features, num_frames)`` → (values, indices) as the fast route's
    serve returns them, for a batch of exactly the export's size."""

    _handle = None

    def __init__(self, manifest: dict, handle=None):
        self.manifest = manifest
        sizes = _sizes(manifest)
        self.batch_size, self.top_k, self.vocab_size = sizes["batch"], sizes["k"], sizes["vocab"]
        self._inputs = (((self.batch_size, sizes["frames"], sizes["width"]), np.uint8),
                        ((self.batch_size,), np.int32))
        self._handle = handle

    @classmethod
    def from_export_dir(cls, export_dir: str, device="cuda") -> "NativeExecutable":
        """Load the artifact on ``device`` (a CUDA device; the CPU raises
        ValueError), building the runner at its first use.  Raises
        ValueError for a JAX export and RuntimeError with the runner's
        message when it does not load."""
        dev = _card(device)
        manifest = read_manifest(export_dir)
        resolve_device(dev)
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        err = ctypes.create_string_buffer(ERR_CAP)
        handle = _fn("lpm_runner_load", [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_longlong],
                     ctypes.c_void_p)(os.fsencode(export_dir), index, err, ERR_CAP)
        if not handle:
            raise RuntimeError(f"native runner: {err.value.decode(errors='replace')}")
        return cls(manifest, handle)

    def _check(self, features, num_frames):
        args = (np.ascontiguousarray(features), np.ascontiguousarray(num_frames))
        for a, (shape, dtype) in zip(args, self._inputs):
            if a.shape != shape or a.dtype != dtype:
                raise ValueError(f"input mismatch: got {a.dtype}{list(a.shape)}, export expects "
                                 f"{np.dtype(dtype).name}{list(shape)} — pad the batch to the exported batch "
                                 f"size {self.batch_size}")
        if self._handle is None:
            raise RuntimeError("the native runner is closed")
        return args

    def _call(self, symbol: str, args, outs) -> None:
        err = ctypes.create_string_buffer(ERR_CAP)
        ptrs = [a.ctypes.data for a in (*args, *outs)]
        fn = _fn(symbol, [ctypes.c_void_p] * (1 + len(ptrs)) + [ctypes.c_char_p, ctypes.c_longlong])
        if fn(self._handle, *ptrs, err, ERR_CAP) != 0:
            raise RuntimeError(f"native runner: {err.value.decode(errors='replace')}")

    def run(self, features, num_frames):
        """→ (values [B, k] f32, indices [B, k] int32) as NumPy arrays; B
        must equal the exported batch size (serving pads to it)."""
        args = self._check(features, num_frames)
        values = np.empty((self.batch_size, self.top_k), np.float32)
        indices = np.empty((self.batch_size, self.top_k), np.int32)
        self._call("lpm_runner_run", args, (values, indices))
        return values, indices

    def probs(self, features, num_frames) -> np.ndarray:
        """The class probabilities [B, V] f32 (the route's ``return_probs``)."""
        args = self._check(features, num_frames)
        out = np.empty((self.batch_size, self.vocab_size), np.float32)
        self._call("lpm_runner_probs", args, (out,))
        return out

    def launches(self) -> Dict[str, int]:
        """The runner's own launches of row 1 and of each tail kernel since
        it loaded or :meth:`reset_launches`."""
        fn = _fn("lpm_runner_launches", [ctypes.c_void_p, ctypes.c_char_p], ctypes.c_longlong)
        return {name: fn(self._handle, name.encode()) for name in COUNTERS}

    def reset_launches(self) -> None:
        _fn("lpm_runner_reset_launches", [ctypes.c_void_p], None)(self._handle)

    def close(self) -> None:
        """Free the runner's memory on the card."""
        if self._handle is not None:
            _fn("lpm_runner_destroy", [ctypes.c_void_p], None)(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def _fn(symbol: str, argtypes, restype=ctypes.c_int):
    return kernel_build.load_function(LIBRARY, symbol, argtypes, restype)


def serving_binary_command(runner, output) -> list:
    """The g++ command that links ``lpm_serve``: the server and the record
    parser (``native/``) with ``runner``, a library or source that defines
    the runner's C API."""
    runner = Path(runner)
    return ["g++", *SERVE_CXX_FLAGS, f"-I{kernel_build.CSRC_DIR}", "-o", str(output),
            *(str(NATIVE_DIR / s) for s in SERVE_SOURCES), str(runner), f"-Wl,-rpath,{runner.parent}"]


def build_serving_binary() -> Path:
    """``lpm_serve`` linked with the runner at first use, into
    ``build/host/`` (named by a hash of its sources, flags and runner; a
    file of this process renamed into place).  Builds the runner first if
    need be; raises RuntimeError with g++'s output on failure."""
    runner = kernel_build.library_path(LIBRARY)
    if not runner.exists():
        kernel_build.build([LIBRARY])
    digest = hashlib.sha256(" ".join(SERVE_CXX_FLAGS + (runner.name,)).encode())
    headers = [kernel_build.CSRC_DIR / h for h in kernel_build.LIBRARY_PARTS[LIBRARY]["headers"]]
    for path in [NATIVE_DIR / s for s in SERVE_SOURCES] + headers:
        digest.update(path.read_bytes())
    target = SERVE_BUILD_DIR / f"lpm_serve-{digest.hexdigest()[:16]}"
    if target.exists():
        return target
    SERVE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run(serving_binary_command(runner, tmp), capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build lpm_serve:\n{out.stdout}{out.stderr}")
    os.replace(tmp, target)
    return target
