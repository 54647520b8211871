"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, which the wrappers call through
``ctypes``: its own, or the library of ``LIBRARY_PARTS`` that compiles it
(the native runner holds the sources of rows 1, 2, 5, 6 and 7 and links
cuBLAS; the rows' wrappers load them from it, so each exists in one copy).
Each source of such a library is compiled to an object beside every other
compile, and the objects are linked once all are done.  Libraries go to
``build/kernels/`` at the root of the checkout (git-ignored), named by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing here runs at import time: a module that
wraps a kernel imports this one freely, and the first launch builds what it
needs.
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
from typing import Dict, Iterable, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# the libraries: each compiles its own ``csrc/<name>.cu`` and its parts
KERNEL_SOURCES = ("netvlad_train", "fused_adam", "int8_matmul", "dropout", "native_runner")
# libraries built from more than their own source: name → the other
# ``csrc/*.cu`` compiled into it, the headers beside the ``.cuh`` files that
# it includes, and its link flags
LIBRARY_PARTS = {
    "native_runner": dict(sources=("fused_frontend", "netvlad_fused", "softdbow_fused", "netfv_fused",
                                   "masked_attention"),
                          headers=("native_manifest.h",), link=("-lcublas",)),
}
# a source compiled into another library → that library
HOME = {part: name for name, spec in LIBRARY_PARTS.items() for part in spec["sources"]}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[tuple, ctypes._CFuncPtr] = {}
# source → what nvcc said of it, for the sources :func:`build` compiled with
# ``-Xptxas -v`` in this process
_ptxas_output: Dict[str, str] = {}


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


def _start(cmd: list) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(names: Iterable[str] = KERNEL_SOURCES, ptxas: Iterable[str] = ()) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together (a library of several sources is
    linked from its objects when they are done); the sources named in
    ``ptxas`` with ``-Xptxas -v`` (:func:`ptxas_report` reads it).  Returns
    the seconds each took (0 for one already built); raises with the
    compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c"]
    verbose = set(ptxas)
    jobs = {}  # name → (the compiles' processes, sources and outputs, tmp, target, start)
    seconds = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        srcs = sources(name)

        def report(src):
            return ["-Xptxas", "-v"] if src.stem in verbose else []

        if len(srcs) == 1:
            procs = [(_start([_nvcc(), *NVCC_FLAGS, *report(srcs[0]), "-o", str(tmp), str(srcs[0]),
                              *link_flags(name)]), srcs[0], tmp)]
        else:
            procs = [(_start([_nvcc(), *compile_flags, *report(src), "-o", str(obj), str(src)]), src, obj)
                     for src in srcs for obj in [target.with_suffix(f".{src.stem}.{os.getpid()}.o")]]
        jobs[name] = (procs, tmp, target, time.perf_counter())
    failures = []
    for name, (procs, tmp, target, start) in jobs.items():
        outputs = [(proc.communicate()[0], proc.returncode, out) for proc, _, out in procs]
        for (_, src, _), (text, _, _) in zip(procs, outputs):
            if src.stem in verbose:
                _ptxas_output[src.stem] = text
        bad = [text for text, rc, _ in outputs if rc != 0]
        if len(procs) > 1:
            objs = [str(out) for _, _, out in outputs]
            if not bad:
                link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *objs, *link_flags(name)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                bad = [link.stdout] if link.returncode != 0 else []
            for obj in objs:
                Path(obj).unlink(missing_ok=True)
        seconds[name] = time.perf_counter() - start
        if bad:
            failures.append(f"nvcc failed for {name}:\n" + "\n".join(bad))
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def ptxas_report(name: str) -> Optional[list]:
    """Per kernel of ``csrc/<name>.cu`` as ptxas reported it when
    :func:`build` compiled it with ``ptxas=`` naming it in this process
    (None if it did not): registers, static shared memory (the kernels'
    dynamic shared memory is sized at launch), stack frame and spills, the names
    demangled where ``c++filt`` is at hand."""
    output = _ptxas_output.get(name)
    if output is None:
        return None
    kernels, current = [], None
    for line in output.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            current = {"kernel": entry.group(1)}
            kernels.append(current)
        elif current is not None and "spill stores" in line:
            nums = [int(n) for n in re.findall(r"(\d+) bytes", line)]
            current["stack_frame"], current["spill_stores"], current["spill_loads"] = nums
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


# SASS opcodes by the SM's integer pipe that issues them (Hopper): IMAD
# forms on the FMA pipe, the rest of the integer and logic work on the ALU
FMA_PIPE_OPS = ("IMAD", "IMUL")
ALU_PIPE_OPS = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "IABS", "IMNMX", "FLO", "POPC", "BMSK")


def sass_opcodes(name: str, kernel: str) -> Dict[str, Dict[str, int]]:
    """The SASS opcodes (with their modifiers) of the built library
    ``name``'s kernels whose mangled name contains ``kernel``, counted per
    kernel, from the toolkit's ``cuobjdump -sass``; with each kernel's
    counts by integer pipe under ``"fma_pipe"`` and ``"alu_pipe"``."""
    cuobjdump = Path(_nvcc()).resolve().parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library_path(HOME.get(name, name)))],
                          capture_output=True, text=True, check=True).stdout
    out: Dict[str, Dict[str, int]] = {}
    counts = None
    for line in sass.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            counts = out.setdefault(func.group(1), {}) if kernel in func.group(1) else None
            continue
        op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if counts is not None and op:
            counts[op.group(1)] = counts.get(op.group(1), 0) + 1
    for counts in out.values():
        base = {op: n for op, n in counts.items()}
        counts["fma_pipe"] = sum(n for op, n in base.items() if op.split(".")[0] in FMA_PIPE_OPS)
        counts["alu_pipe"] = sum(n for op, n in base.items() if op.split(".")[0] in ALU_PIPE_OPS)
    return out


def load_function(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of source ``name``'s library (its own, or
    the one of ``LIBRARY_PARTS`` that compiles it), building the library
    first if needed; a kernel's entry point returns a ``cudaError_t`` as
    ``int`` (the default ``restype``).  Bound once and then reused, since the
    wrappers call it on every launch."""
    fn = _functions.get((name, symbol))
    if fn is not None:
        return fn
    home = HOME.get(name, name)
    lib = _loaded.get(home)
    if lib is None:
        path = library_path(home)
        if not path.exists():
            build([home])
        lib = _loaded[home] = ctypes.CDLL(str(path))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    _functions[(name, symbol)] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
