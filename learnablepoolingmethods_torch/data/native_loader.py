"""ctypes binding of the C++ TFRecord reader and CSV formatter
(ref: data/native_loader.py).

``native/tfrecord_reader.cc`` and ``native/csv_formatter.cc`` (this
package's own copies) are compiled by ``g++ -O3 -march=native -shared
-fPIC`` at first use into one library under ``build/host/`` at the root of
the checkout (git-ignored), named by a hash of the sources and flags, as
``ops/kernel_build.py`` names the CUDA libraries.  Each build writes a file
of its own process and renames it into place, so processes that build at
once all load a whole library.  Nothing builds at import time.

The parse functions return packed NumPy arrays.  ctypes releases the GIL
for each C call, so ``parse_files_parallel``'s thread pool parses on many
cores: the counterpart of the reference's ``--num_readers`` reader threads
(ref: train.py#get_input_data_tensors).

There is no fallback: every entry point raises with the compiler's output
when the library does not build.  ``is_available``/``load_error`` answer
callers that ask first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCES = ("tfrecord_reader.cc", "csv_formatter.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
ID_WIDTH = 32

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def library_path() -> Path:
    """Where the sources build to, keyed by their bytes and the flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        digest.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libtfrecord_reader-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    RuntimeError with g++'s output when the build fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native loader needs g++: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the native loader:\n{out.stdout}{out.stderr}")
    os.replace(tmp, target)
    return target


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i32p, c_i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    c_u8p, c_f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    lib.lpm_count_records.restype = ctypes.c_int64
    lib.lpm_count_records.argtypes = [ctypes.c_char_p]
    frame_args = [ctypes.c_int32, c_i32p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
                  ctypes.c_int64, ctypes.c_int32, c_u8p, c_i32p, c_f32p, ctypes.c_char_p]
    video_args = [c_i32p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
                  ctypes.c_int32, c_f32p, c_f32p, ctypes.c_char_p]
    for name, args in (("frame", frame_args), ("video", video_args)):
        whole, ranged = getattr(lib, f"lpm_parse_{name}_file"), getattr(lib, f"lpm_parse_{name}_file_range")
        whole.restype = ranged.restype = ctypes.c_int64
        whole.argtypes = [ctypes.c_char_p, *args]
        ranged.argtypes = [ctypes.c_char_p, ctypes.c_int64, *args]
    lib.lpm_chunk_offsets.restype = ctypes.c_int64
    lib.lpm_chunk_offsets.argtypes = [ctypes.c_char_p, ctypes.c_int64, c_i64p, ctypes.c_int64]
    lib.lpm_parse_frame_record.restype = ctypes.c_int32
    lib.lpm_parse_frame_record.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, c_i32p,
                                           ctypes.c_int32, ctypes.c_char_p, c_u8p, c_i32p]
    lib.lpm_parse_video_record.restype = ctypes.c_int32
    lib.lpm_parse_video_record.argtypes = [ctypes.c_char_p, ctypes.c_int64, c_i32p, ctypes.c_int32,
                                           ctypes.c_char_p, c_f32p]
    lib.lpm_format_csv.restype = ctypes.c_int64
    lib.lpm_format_csv.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
                                   c_f32p, c_i32p, ctypes.c_char_p, ctypes.c_int64]
    return lib


def load() -> ctypes.CDLL:
    """The library, built and loaded at the first call of the process.
    Raises RuntimeError, with the build's error, when it does not load."""
    global _lib, _load_error
    with _lock:
        if _lib is None and _load_error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError) as e:
                _load_error = f"{type(e).__name__}: {e}"
        if _lib is None:
            raise RuntimeError(f"native loader unavailable: {_load_error}")
        return _lib


def is_available() -> bool:
    """Whether the library builds and loads (building it if need be)."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def load_error() -> Optional[str]:
    """Why the library did not load, or None."""
    is_available()
    return _load_error


def _pack_names(names: Sequence[str]) -> bytes:
    return b"".join(n.encode() + b"\0" for n in names)


def _ids(vids, n: int) -> List[bytes]:
    return [vids.raw[i * ID_WIDTH:(i + 1) * ID_WIDTH].rstrip(b"\0") for i in range(n)]


def count_records(path: str) -> int:
    n = load().lpm_count_records(path.encode())
    if n < 0:
        raise IOError(f"cannot read {path}")
    return int(n)


def chunk_offsets(path: str, chunk_records: int) -> List[int]:
    """Byte offsets where every ``chunk_records``-record chunk starts (a
    framing-only fseek walk).  Feed each offset to ``parse_frame_file`` /
    ``parse_video_file`` with ``start_offset=``/``max_records=`` to parse a
    file in bounded-memory chunks."""
    lib = load()
    cap = 1024
    while True:
        out = (ctypes.c_int64 * cap)()
        n = lib.lpm_chunk_offsets(path.encode(), chunk_records, out, cap)
        if n < 0:
            raise IOError(f"cannot read {path}")
        if n < cap:
            return list(out[: int(n)])
        cap *= 8


def parse_frame_file(
    path: str,
    max_frames: int = 300,
    feature_sizes: Sequence[int] = (1024, 128),
    feature_names: Sequence[str] = ("rgb", "audio"),
    num_classes: int = 3862,
    start_offset: int = 0,
    max_records: Optional[int] = None,
):
    """→ dict(features [N,F,D] uint8, num_frames [N], labels [N,V], video_id list).

    ``start_offset``/``max_records`` select one chunk (offsets from
    ``chunk_offsets``); the default parses the whole file."""
    lib = load()
    cap = count_records(path) if max_records is None else int(max_records)
    frames = np.zeros((cap, max_frames, sum(feature_sizes)), np.uint8)
    num_frames = np.zeros(cap, np.int32)
    labels = np.zeros((cap, num_classes), np.float32)
    vids = ctypes.create_string_buffer(cap * ID_WIDTH)
    sizes = (ctypes.c_int32 * len(feature_sizes))(*feature_sizes)
    n = lib.lpm_parse_frame_file_range(
        path.encode(), start_offset, max_frames, sizes, len(feature_sizes),
        _pack_names(feature_names), num_classes, cap, ID_WIDTH,
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vids,
    )
    if n < 0:
        raise IOError(f"native parse failed for {path}")
    n = int(n)
    return {"features": frames[:n], "num_frames": num_frames[:n], "labels": labels[:n],
            "video_id": _ids(vids, n)}


def parse_video_file(
    path: str,
    feature_sizes: Sequence[int] = (1024, 128),
    feature_names: Sequence[str] = ("mean_rgb", "mean_audio"),
    num_classes: int = 3862,
    start_offset: int = 0,
    max_records: Optional[int] = None,
):
    """→ dict(features [N,D] float32, labels [N,V], video_id list)."""
    lib = load()
    cap = count_records(path) if max_records is None else int(max_records)
    feats = np.zeros((cap, sum(feature_sizes)), np.float32)
    labels = np.zeros((cap, num_classes), np.float32)
    vids = ctypes.create_string_buffer(cap * ID_WIDTH)
    sizes = (ctypes.c_int32 * len(feature_sizes))(*feature_sizes)
    n = lib.lpm_parse_video_file_range(
        path.encode(), start_offset, sizes, len(feature_sizes),
        _pack_names(feature_names), num_classes, cap, ID_WIDTH,
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vids,
    )
    if n < 0:
        raise IOError(f"native parse failed for {path}")
    n = int(n)
    return {"features": feats[:n], "labels": labels[:n], "video_id": _ids(vids, n)}


def parse_frame_record(
    record: bytes,
    max_frames: int = 300,
    feature_sizes: Sequence[int] = (1024, 128),
    feature_names: Sequence[str] = ("rgb", "audio"),
):
    """One serialized SequenceExample → (features [F,D] uint8, num_frames)."""
    lib = load()
    frames = np.zeros((max_frames, sum(feature_sizes)), np.uint8)
    nf = ctypes.c_int32(0)
    sizes = (ctypes.c_int32 * len(feature_sizes))(*feature_sizes)
    rc = lib.lpm_parse_frame_record(
        record, len(record), max_frames, sizes, len(feature_sizes), _pack_names(feature_names),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ctypes.byref(nf),
    )
    if rc != 0:
        raise ValueError("malformed record")
    return frames, int(nf.value)


def parse_video_record(
    record: bytes,
    feature_sizes: Sequence[int] = (1024, 128),
    feature_names: Sequence[str] = ("mean_rgb", "mean_audio"),
):
    """One serialized Example → features [D] float32."""
    lib = load()
    feats = np.zeros((sum(feature_sizes),), np.float32)
    sizes = (ctypes.c_int32 * len(feature_sizes))(*feature_sizes)
    rc = lib.lpm_parse_video_record(
        record, len(record), sizes, len(feature_sizes), _pack_names(feature_names),
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise ValueError("malformed record")
    return feats


def format_csv(video_ids, values, indices) -> bytes:
    """Kaggle CSV lines at C speed, byte for byte ``utils/misc.py
    #format_lines`` (ref: inference.py#format_lines).

    video_ids: sequence of bytes/str; values [N, k] float; indices [N, k] int.
    """
    lib = load()
    values = np.ascontiguousarray(values, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    n, k = values.shape
    ids = [v.encode() if isinstance(v, str) else bytes(v) for v in video_ids]
    id_width = max((len(v) for v in ids), default=1) + 1  # +1 keeps a NUL after each id
    packed = bytearray(n * id_width)
    for i, v in enumerate(ids):
        packed[i * id_width: i * id_width + len(v)] = v
    cap = n * (id_width + 2 + k * 56) + 16
    out = ctypes.create_string_buffer(cap)
    written = lib.lpm_format_csv(
        n, k, bytes(packed), id_width,
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out, cap,
    )
    if written == -2:
        raise ValueError("csv formatter: score magnitude too large to format (>= ~1e32)")
    if written < 0:
        raise RuntimeError("csv formatter buffer overflow")
    return out.raw[:written]


def parse_files_parallel(
    paths: List[str],
    frame_level: bool,
    num_workers: int = 8,
    chunk_records: int = 0,
    **kwargs,
) -> Iterator[dict]:
    """Parse many files on ``num_workers`` threads (the GIL is released in
    the C calls), yielding one dict per file, or per chunk, in input order.

    At most ``num_workers + 1`` parses are in flight: a consumer slower than
    the parsers (the packed cache's build writing its memmap) would
    otherwise hold every finished parse in memory.  ``chunk_records > 0``
    splits each file into chunks of that many records (offsets from
    ``chunk_offsets``, parsed through the C range entry points), so peak
    memory is ``(num_workers + 1) × chunk_records`` padded rows whatever the
    size of a file or of the data."""
    fn = parse_frame_file if frame_level else parse_video_file

    def tasks() -> Iterator[dict]:
        for p in paths:
            if chunk_records > 0:
                for off in chunk_offsets(p, chunk_records):
                    yield dict(path=p, start_offset=off, max_records=chunk_records, **kwargs)
            else:
                yield dict(path=p, **kwargs)

    load()  # build once before the threads need it
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        it = tasks()
        inflight: deque = deque()
        for t in it:
            inflight.append(pool.submit(fn, **t))
            if len(inflight) > num_workers:
                break
        while inflight:
            fut = inflight.popleft()
            nxt = next(it, None)
            if nxt is not None:
                inflight.append(pool.submit(fn, **nxt))
            yield fut.result()
