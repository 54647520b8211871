"""TF-free TFRecord + tf.Example/tf.SequenceExample wire-format reader.

The reference ingests via TF queue runners (ref: readers.py#BaseReader.
prepare_reader + tf.TFRecordReader).  The rebuild's inference hot path must
not depend on TensorFlow (SURVEY.md §7 hard parts: "TF-free inference hot
path"), so this module implements, in pure Python over ``struct``:

- the TFRecord framing: ``uint64 length | uint32 masked-crc(length) |
  payload | uint32 masked-crc(payload)`` (CRC verification optional — the
  fixtures' CRCs are validated against TF in tests), and
- a minimal protobuf wire-format decoder for exactly the message shapes the
  YT-8M dataset uses (Example / SequenceExample with bytes/float/int64
  feature lists).

This is also the executable spec for the native C++ batch loader
(this package's ``native/tfrecord_reader.cc``, ``data/native_loader.py``),
which parallelizes the same decode.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")

# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

# CRC32C (Castagnoli polynomial 0x82F63B78): google_crc32c's C code where it
# is installed, else NumPy over 64-byte chunks (a fixture of hundreds of MB
# in seconds; a byte-at-a-time Python table runs at about 5 MB/s).
_CRC_POLY = 0x82F63B78
_CRC_CHUNK = 64


def _crc_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(_CRC_POLY), table >> 1).astype(np.uint32)
    return table


_CRC_TABLE = _crc_table()
_BYTE_BITS = (np.arange(256)[:, None] >> np.arange(8)) & 1  # [256, 8]
_ADVANCE: Dict[int, np.ndarray] = {}


def _apply(tables: np.ndarray, reg: np.ndarray) -> np.ndarray:
    return (tables[0][reg & 0xFF] ^ tables[1][(reg >> 8) & 0xFF] ^ tables[2][(reg >> 16) & 0xFF]
            ^ tables[3][reg >> 24])


def _advance_tables(span: int) -> np.ndarray:
    """[4, 256] tables of the linear map that feeds ``span`` zero bytes
    through a CRC register, one table a register byte."""
    if span not in _ADVANCE:
        basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
        if span == _CRC_CHUNK:
            for _ in range(span):
                basis = _CRC_TABLE[basis & 0xFF] ^ (basis >> 8)
        else:
            half = _advance_tables(span // 2)
            basis = _apply(half, _apply(half, basis))
        picked = np.where(_BYTE_BITS[None], basis.reshape(4, 1, 8), np.uint32(0))
        _ADVANCE[span] = np.bitwise_xor.reduce(picked, axis=2)
    return _ADVANCE[span]


def _crc32c_numpy(data: bytes) -> int:
    n = len(data)
    a = np.zeros(-(-max(n, 4) // _CRC_CHUNK) * _CRC_CHUNK, np.uint8)
    a[a.size - n:] = np.frombuffer(data, np.uint8)
    if n < 4:
        # the all-ones start as a register, for the few bytes of a tiny input
        reg = np.array([0xFFFFFFFF], np.uint32)
        for b in a[a.size - n:]:
            reg = _CRC_TABLE[(reg ^ b) & 0xFF] ^ (reg >> 8)
        return int(reg[0]) ^ 0xFFFFFFFF
    # a reflected CRC's all-ones start is its first four bytes inverted under
    # a zero start, and leading zero bytes leave a zero register unchanged
    a[a.size - n:a.size - n + 4] ^= 0xFF
    chunks = a.reshape(-1, _CRC_CHUNK)
    reg = np.zeros(chunks.shape[0], np.uint32)
    for i in range(_CRC_CHUNK):
        reg = _CRC_TABLE[(reg ^ chunks[:, i]) & 0xFF] ^ (reg >> 8)
    # fold neighbours: reg(A || B) = advance(reg(A), |B|) ^ reg(B)
    span = _CRC_CHUNK
    while reg.size > 1:
        if reg.size % 2:
            reg = np.concatenate([np.zeros(1, np.uint32), reg])
        reg = _apply(_advance_tables(span), reg[0::2]) ^ reg[1::2]
        span *= 2
    return int(reg[0]) ^ 0xFFFFFFFF


try:
    from google_crc32c import value as _crc32c  # type: ignore
except ImportError:  # pragma: no cover - the card's machine has no google_crc32c
    _crc32c = _crc32c_numpy


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def read_tfrecords(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw serialized records from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = _U64.unpack_from(header, 0)
            (len_crc,) = _U32.unpack_from(header, 8)
            if verify_crc and _masked_crc(header[:8]) != len_crc:
                raise ValueError(f"corrupt TFRecord length CRC in {path}")
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError(f"truncated TFRecord payload in {path}")
            tail = f.read(4)
            if len(tail) < 4:
                raise ValueError(f"truncated TFRecord CRC in {path}")
            if verify_crc:
                (data_crc,) = _U32.unpack(tail)
                if _masked_crc(payload) != data_crc:
                    raise ValueError(f"corrupt TFRecord data CRC in {path}")
            yield payload


def write_tfrecord(f, payload: bytes) -> None:
    """Append one framed record (with valid masked CRCs) to an open file."""
    header = _U64.pack(len(payload))
    f.write(header)
    f.write(_U32.pack(_masked_crc(header)))
    f.write(payload)
    f.write(_U32.pack(_masked_crc(payload)))


# ---------------------------------------------------------------------------
# Protobuf wire format (just enough for Example / SequenceExample)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object, int]]:
    """Yield (field_number, wire_type, value, end_pos) over a message buffer.

    wire 0 → varint int; wire 2 → bytes (memoryview); wire 5 → 4-byte fixed32
    (returned raw); wire 1 → 8-byte fixed64 (raw).
    """
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val, pos


class Feature:
    """Decoded tf.train.Feature: at most one of bytes/floats/ints."""

    __slots__ = ("bytes_list", "float_list", "int64_list")

    def __init__(self):
        self.bytes_list: List[bytes] = []
        self.float_list: np.ndarray = None
        self.int64_list: List[int] = []


def _parse_feature(buf: bytes) -> Feature:
    feat = Feature()
    for field, wire, val, _ in _iter_fields(buf):
        if field == 1:  # BytesList
            for f2, w2, v2, _ in _iter_fields(val):
                if f2 == 1:
                    feat.bytes_list.append(bytes(v2))
        elif field == 2:  # FloatList (packed or repeated fixed32)
            floats = []
            for f2, w2, v2, _ in _iter_fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed
                        floats.append(np.frombuffer(v2, dtype="<f4"))
                    else:  # single fixed32
                        floats.append(np.frombuffer(v2, dtype="<f4"))
            feat.float_list = (
                np.concatenate(floats) if floats else np.zeros(0, np.float32)
            )
        elif field == 3:  # Int64List (packed varints or repeated)
            for f2, w2, v2, _ in _iter_fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed varints
                        p = 0
                        while p < len(v2):
                            iv, p = _read_varint(v2, p)
                            feat.int64_list.append(iv)
                    else:
                        feat.int64_list.append(v2)
    return feat


def _parse_features_map(buf: bytes) -> Dict[str, Feature]:
    """tf.train.Features: map<string, Feature> as repeated entry messages."""
    out: Dict[str, Feature] = {}
    for field, _, val, _ in _iter_fields(buf):
        if field == 1:  # map entry
            key, fval = None, None
            for f2, _, v2, _ in _iter_fields(val):
                if f2 == 1:
                    key = bytes(v2).decode("utf-8")
                elif f2 == 2:
                    fval = _parse_feature(v2)
            if key is not None and fval is not None:
                out[key] = fval
    return out


def parse_example(record: bytes) -> Dict[str, Feature]:
    """Decode a serialized tf.train.Example → {name: Feature}."""
    for field, _, val, _ in _iter_fields(record):
        if field == 1:  # features
            return _parse_features_map(val)
    return {}


def parse_sequence_example_lists(
    record: bytes,
) -> Tuple[Dict[str, Feature], Dict[str, memoryview]]:
    """Decode a tf.train.SequenceExample's context, and find its feature
    lists → (context map, {name: the FeatureList message, undecoded})."""
    context: Dict[str, Feature] = {}
    feature_lists: Dict[str, memoryview] = {}
    for field, _, val, _ in _iter_fields(memoryview(record)):
        if field == 1:  # context: Features
            context = _parse_features_map(val)
        elif field == 2:  # feature_lists: FeatureLists
            for f2, _, v2, _ in _iter_fields(val):
                if f2 == 1:  # map entry
                    key, parts = None, []
                    for f3, _, v3, _ in _iter_fields(v2):
                        if f3 == 1:
                            key = bytes(v3).decode("utf-8")
                        elif f3 == 2:  # FeatureList; repeats merge
                            parts.append(v3)
                    if key is not None:
                        feature_lists[key] = parts[0] if len(parts) == 1 else memoryview(
                            b"".join(bytes(p) for p in parts))
    return context, feature_lists


def parse_feature_list(buf) -> List[Feature]:
    """Decode a FeatureList message → its Features."""
    return [_parse_feature(v) for f, _, v, _ in _iter_fields(buf) if f == 1]


def encode_varint(n: int) -> bytes:
    """A non-negative int as a protobuf varint."""
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def frame_header(size: int) -> bytes:
    """The bytes ahead of each frame in a FeatureList whose every Feature is
    a BytesList of one ``size``-byte value, as a frame-level record stores
    its frames: the entry's tag and length, the Feature's, the value's."""
    value = b"\x0a" + encode_varint(size)
    feature = b"\x0a" + encode_varint(len(value) + size) + value
    return b"\x0a" + encode_varint(len(feature) + size) + feature


def feature_list_frames(buf) -> np.ndarray:
    """A non-empty FeatureList's frames as a ``[frames, size]`` uint8 matrix:
    the first bytes value of each Feature.  Where every entry is a
    frame_header and its frame, the frames are one strided view of ``buf``;
    otherwise each Feature is decoded."""
    field, wire, first, end = next(_iter_fields(buf))
    if field == 1 and wire == 2:
        values = _parse_feature(first).bytes_list
        header = frame_header(len(values[0])) if len(values) == 1 else b""
        stride = len(header) + len(values[0]) if header else 0
        if stride == end and len(buf) % stride == 0:
            rows = np.frombuffer(buf, np.uint8).reshape(len(buf) // stride, stride)
            if (rows[:, :len(header)] == np.frombuffer(header, np.uint8)).all():
                return rows[:, len(header):]
    return np.stack([np.frombuffer(f.bytes_list[0], dtype=np.uint8) for f in parse_feature_list(buf)])
