"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, which the wrappers call
through ``ctypes``.  A library of ``LIBRARY_PARTS`` also compiles other
sources into itself and links more (the native runner: row 1's source and
cuBLAS).  Libraries go to ``build/kernels/`` at the root of the
checkout (git-ignored), named by a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is reused.  Nothing here runs
at import time: a module that wraps a kernel imports this one freely, and
the first launch builds what it needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("fused_frontend", "netvlad_fused", "netvlad_train", "netfv_fused", "softdbow_fused",
                  "masked_attention", "fused_adam", "int8_matmul", "dropout", "native_runner")
# libraries built from more than their own source: name → the other
# ``csrc/*.cu`` compiled into it, the headers beside the ``.cuh`` files that
# it includes, and its link flags (-Bsymbolic: its call of row 1's entry
# point binds to its own copy, whatever else the process has loaded)
LIBRARY_PARTS = {
    "native_runner": dict(sources=("fused_frontend",), headers=("native_manifest.h",),
                          link=("-lcublas", "-Xlinker", "-Bsymbolic")),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[tuple, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def sources(name: str) -> list:
    """The ``.cu`` files that library ``name`` compiles."""
    return [CSRC_DIR / f"{n}.cu" for n in (name, *LIBRARY_PARTS.get(name, {}).get("sources", ()))]


def link_flags(name: str) -> list:
    """Library ``name``'s link flags; a library that links the toolkit's
    libraries finds them through its RUNPATH outside a process that has
    loaded them already (``lpm_serve``)."""
    flags = list(LIBRARY_PARTS.get(name, {}).get("link", ()))
    if flags:
        flags += ["-Xlinker", f"-rpath={Path(_nvcc()).resolve().parent.parent / 'lib64'}"]
    return flags


def library_path(name: str) -> Path:
    """Where library ``name`` builds to, keyed by its sources and flags."""
    parts = LIBRARY_PARTS.get(name, {})
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + parts.get("link", ())).encode())
    headers = sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / h for h in parts.get("headers", ())]
    for src in headers + sources(name):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns the seconds each took (0 for
    one already built); raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources(name)), *link_flags(name)]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            target,
            time.perf_counter(),
        )
    failures = []
    for name, (proc, tmp, target, start) in procs.items():
        output, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{output}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def ptxas_report_start(name: str) -> subprocess.Popen:
    """Start compiling ``csrc/<name>.cu`` once more with ``-Xptxas -v`` into
    a scratch file of the build directory; :func:`ptxas_report_finish` reads
    what ptxas says of each kernel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    scratch = BUILD_DIR / f"ptxas-{name}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(scratch), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.scratch = scratch
    return proc


def ptxas_report_finish(proc: subprocess.Popen) -> list:
    """Per kernel of a :func:`ptxas_report_start` compile: registers, static
    shared memory (the kernels' dynamic shared memory is sized at launch)
    and spills, the names demangled where ``c++filt`` is at hand."""
    output, _ = proc.communicate()
    proc.scratch.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{output}")
    kernels, current = [], None
    for line in output.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            current = {"kernel": entry.group(1)}
            kernels.append(current)
        elif current is not None and "spill stores" in line:
            nums = [int(n) for n in re.findall(r"(\d+) bytes", line)]
            current["spill_stores"], current["spill_loads"] = nums[1], nums[2]
        elif current is not None and "Used" in line:
            current["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["static_smem"] = int(smem.group(1)) if smem else 0
    demangler = shutil.which("c++filt")
    if demangler and kernels:
        names = subprocess.run([demangler], input="\n".join(k["kernel"] for k in kernels),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(kernels):
            for k, n in zip(kernels, names):
                k["kernel"] = n.split("(")[0].removeprefix("void ")
    return kernels


def load_function(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of library ``name``, building the library
    first if needed; a kernel's entry point returns a ``cudaError_t`` as
    ``int`` (the default ``restype``).  Bound once and then reused, since the
    wrappers call it on every launch."""
    fn = _functions.get((name, symbol))
    if fn is not None:
        return fn
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    _functions[(name, symbol)] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
