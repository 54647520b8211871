"""flax's msgpack state-dict format, read and written without ``msgpack``.

``flax.serialization.to_bytes`` of a tree of dicts and NumPy arrays is a
msgpack map per dict whose leaves are extension objects (ref:
flax/serialization.py#_msgpack_ext_pack, #_chunk):

- an array is ``ExtType(1, packb((shape, dtype.name, C-order bytes)))``, a
  NumPy scalar the same under code 3 (which :func:`dump` writes as a 0-d
  array, as ``jax.device_get`` turns it into one);
- an array of more than :data:`MAX_CHUNK_SIZE` bytes is the map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat[:n], ...}}`` with ``n = MAX_CHUNK_SIZE // itemsize``
  (Willow's hidden FC, 278,528 × 1024 f32, is one);
- every object takes msgpack's smallest encoding.

:func:`dump` writes a tree's dicts in sorted key order, the order that
``jax.device_get`` leaves and the JAX package's export therefore writes, so
the bytes equal flax's.  ``bfloat16`` arrays travel as their uint16 bit
patterns in :class:`BFloat16Bits` (NumPy has no bfloat16, and the port
does not need ``ml_dtypes``); an array whose dtype is named ``bfloat16``
(ml_dtypes') is written under that name too.
"""

from __future__ import annotations

import io
import struct
from collections.abc import Mapping
from typing import Any, BinaryIO

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class BFloat16Bits(np.ndarray):
    """A bfloat16 array held as its uint16 bit patterns (``arr.view(
    BFloat16Bits)``); the codec writes and reads it under the dtype name
    ``bfloat16``."""


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if isinstance(arr, BFloat16Bits) else arr.dtype.name


def _uint(n: int, fix_limit: int, fix: int, codes: bytes) -> bytes:
    """A length or count header: the fix form below ``fix_limit``, else the
    first of ``codes`` (8-, 16-, 32-bit) whose width holds ``n``."""
    if n < fix_limit:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack cannot hold a length of {n}")


def _int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if n < limit:
                return bytes([code]) + struct.pack(fmt, n)
    for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15), (0xD2, ">i", 31), (0xD3, ">q", 63)):
        if n >= -(1 << bits):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack cannot hold the integer {n}")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _uint(len(data), 32, 0xA0, b"\xd9\xda\xdb") + data


def _bin_header(n: int) -> bytes:
    return _uint(n, 0, 0, b"\xc4\xc5\xc6")


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _uint(n, 0, 0, b"\xc7\xc8\xc9")
    return head + bytes([code])


def _write_array(f: BinaryIO, arr: np.ndarray, code: int) -> None:
    """The extension object of one array: its header, then its bytes
    straight from the array's memory."""
    data = arr if arr.flags.c_contiguous else arr.copy(order="C")  # keeps a 0-d array 0-d
    shape = _uint(data.ndim, 16, 0x90, b"\x00\xdc\xdd") + b"".join(_int(d) for d in data.shape)
    head = b"\x93" + shape + _str(_dtype_name(arr)) + _bin_header(data.nbytes)
    f.write(_ext_header(len(head) + data.nbytes, code))
    f.write(head)
    if data.nbytes:
        f.write(memoryview(data.reshape(-1).view(np.uint8)))


def _write_map_header(f: BinaryIO, n: int) -> None:
    f.write(_uint(n, 16, 0x80, b"\x00\xde\xdf"))


def _write(f: BinaryIO, obj: Any, sort_keys: bool) -> None:
    if isinstance(obj, Mapping):
        _write_map_header(f, len(obj))
        keys = sorted(obj, key=str) if sort_keys else list(obj)
        for key in keys:
            f.write(_str(str(key)))
            _write(f, obj[key], sort_keys)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > MAX_CHUNK_SIZE:
            _write_chunked(f, obj)
        else:
            _write_array(f, obj, _EXT_NDARRAY)
    elif isinstance(obj, np.generic):  # a 0-d array, as jax.device_get makes it
        _write_array(f, np.asarray(obj), _EXT_NDARRAY)
    elif obj is None:
        f.write(b"\xc0")
    elif isinstance(obj, bool):
        f.write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        f.write(_int(obj))
    elif isinstance(obj, float):
        f.write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        f.write(_str(obj))
    else:
        raise TypeError(f"flax's msgpack format holds dicts, arrays and scalars, not {type(obj).__name__}")


def _write_chunked(f: BinaryIO, arr: np.ndarray) -> None:
    """flax's chunked form of an array over MAX_CHUNK_SIZE bytes, its keys
    in flax's order of insertion."""
    n = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    chunks = [flat[i:i + n] for i in range(0, flat.size, n)]
    _write_map_header(f, 3)
    f.write(_str(_CHUNKED) + b"\xc3")
    f.write(_str("shape"))
    _write(f, {str(i): int(d) for i, d in enumerate(arr.shape)}, sort_keys=False)
    f.write(_str("chunks"))
    _write_map_header(f, len(chunks))
    for i, chunk in enumerate(chunks):
        f.write(_str(str(i)))
        _write_array(f, chunk, _EXT_NDARRAY)


def dump(tree: Any, f: BinaryIO) -> None:
    """Write ``tree`` (nested dicts of NumPy arrays and scalars) to the file
    ``f`` as flax's ``to_bytes`` of ``jax.device_get(tree)`` would."""
    _write(f, tree, sort_keys=True)


def to_bytes(tree: Any) -> bytes:
    """:func:`dump` into bytes."""
    buf = io.BytesIO()
    dump(tree, buf)
    return buf.getvalue()


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map(b & 0x0F)
        if b < 0xA0:
            return self.array(b & 0x0F)
        if b < 0xC0:
            return bytes(self.take(b & 0x1F)).decode("utf-8")
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xC6:
                return self.take(n)
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return bytes(self.take(n)).decode("utf-8")
            return self.array(n) if b <= 0xDD else self.map(n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        consts = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in consts:
            return consts[b]
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def ext(self, n: int):
        code = self.unpack(">b")
        end = self.pos + n
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"flax's msgpack format has no extension type {code}")
        items = self.read()
        if self.pos != end or not isinstance(items, list) or len(items) != 3:
            raise ValueError("malformed array in msgpack data")
        shape, name, data = items
        dtype = np.dtype(np.uint16 if name == "bfloat16" else name)
        arr = np.frombuffer(data, dtype=dtype).reshape(shape)
        if name == "bfloat16":
            arr = arr.view(BFloat16Bits)
        return arr if code == _EXT_NDARRAY else arr[()]


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        arr = np.concatenate(chunks).reshape(shape)
        return arr.view(BFloat16Bits) if isinstance(chunks[0], BFloat16Bits) else arr
    return {key: _unchunk(value) for key, value in tree.items()}


def from_bytes(data) -> Any:
    """The tree that :func:`dump` or flax's ``to_bytes`` wrote, as nested
    dicts of NumPy arrays (flax's ``msgpack_restore``).  Arrays are views of
    ``data`` where no chunks were joined, writable when ``data`` is (a
    ``bytearray``)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def load(path: str) -> Any:
    """:func:`from_bytes` of the file ``path``, read into one writable
    buffer."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        buf = bytearray(f.tell())
        f.seek(0)
        f.readinto(buf)
    return from_bytes(buf)
