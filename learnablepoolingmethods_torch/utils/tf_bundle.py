"""A numpy reader of TensorFlow's V2 tensor bundle, the checkpoint format
``tf.train.Saver`` has written by default since TF 1.x and ``tf.train.Checkpoint``
writes, so that a reference-trained checkpoint is read where tensorflow is
not installed.

A bundle ``<prefix>`` is two or more files:

- ``<prefix>.index``, a LevelDB-format table: data blocks of entries with
  shared-prefix keys and restart points, an index block that maps each data
  block's last key to its ``BlockHandle`` (offset, size), a metaindex block,
  and a 48-byte footer (the metaindex and index handles, padded to 40 bytes,
  then the magic 0xdb4775248b80fb57).  Every block ends in a 5-byte trailer:
  its compression byte (0: none) and the masked CRC-32C of block and byte.
  Key ``""`` holds the ``BundleHeaderProto`` (shard count, endianness); every
  other key is a variable's name mapped to its ``BundleEntryProto`` (dtype,
  shape, shard, offset, size, masked CRC-32C of the bytes).
- ``<prefix>.data-<shard>-of-<n>``: each tensor's bytes at its offset,
  little-endian, row-major.

:class:`BundleReader` reads DT_FLOAT, DT_DOUBLE, DT_INT32, DT_INT64 and
DT_BFLOAT16 (widened to float32, exactly) and checks every CRC; anything
else (a V1 single-file checkpoint, compressed blocks, string or sliced
tensors, a big-endian bundle) raises and names what it found.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5

# tensorflow/core/framework/types.proto → numpy
_DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"), 9: np.dtype("<i8")}
DT_BFLOAT16 = 14
_DTYPE_NAMES = {1: "DT_FLOAT", 2: "DT_DOUBLE", 3: "DT_INT32", 4: "DT_UINT8", 5: "DT_INT16", 6: "DT_INT8",
                7: "DT_STRING", 8: "DT_COMPLEX64", 9: "DT_INT64", 10: "DT_BOOL", 14: "DT_BFLOAT16",
                18: "DT_COMPLEX128", 19: "DT_HALF", 20: "DT_RESOURCE", 21: "DT_VARIANT"}


def _crc32c_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table[i] = c
    return table


_CRC_TABLE = _crc32c_table()
_CRC_LIST = [int(v) for v in _CRC_TABLE]
_CHUNKS = 4096  # lanes of the vectorised CRC


def _crc_raw(state: int, data: bytes) -> int:
    for b in data:
        state = _CRC_LIST[(state ^ b) & 0xFF] ^ (state >> 8)
    return state


def _gf2_apply(op: List[int], v: int) -> int:
    """The 32×32 GF(2) matrix ``op`` (its columns as ints) times ``v``."""
    out, i = 0, 0
    while v:
        if v & 1:
            out ^= op[i]
        v >>= 1
        i += 1
    return out


def _zeros_operator(n: int) -> List[int]:
    """The linear map of feeding n zero bytes to the raw CRC register."""
    byte_op = [_crc_raw(1 << i, b"\0") for i in range(32)]
    result = [1 << i for i in range(32)]  # identity
    while n:
        if n & 1:
            result = [_gf2_apply(byte_op, c) for c in result]
        byte_op = [_gf2_apply(byte_op, c) for c in byte_op]
        n >>= 1
    return result


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``.  Long inputs are cut into 4096
    equal chunks whose raw CRCs are formed side by side with numpy and then
    chained: raw(s, A‖B) = Z_|B|(raw(s, A)) ⊕ raw(0, B), Z_n the map of n
    zero bytes."""
    buf = np.frombuffer(memoryview(data), np.uint8) if not isinstance(data, np.ndarray) else data.view(np.uint8).ravel()
    n = buf.size // _CHUNKS
    state = 0xFFFFFFFF
    if n >= 64:
        lanes = np.ascontiguousarray(buf[: n * _CHUNKS].reshape(_CHUNKS, n).T)
        raw = np.zeros(_CHUNKS, np.uint32)
        for row in lanes:
            raw = _CRC_TABLE[(raw ^ row) & 0xFF] ^ (raw >> np.uint32(8))
        shift = _zeros_operator(n)
        for r in raw.tolist():
            state = _gf2_apply(shift, state) ^ r
        buf = buf[n * _CHUNKS:]
    return _crc_raw(state, buf.tobytes()) ^ 0xFFFFFFFF


def masked_crc32c(data) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a serialized protobuf message:
    ints for varint and fixed fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 2:
            size, pos = _varint(buf, pos)
            value, pos = bytes(buf[pos:pos + size]), pos + size
        elif wire == 5:
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire} of field {field} is not read")
        yield field, wire, value


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


class BundleEntry:
    """One variable's ``BundleEntryProto``."""

    def __init__(self, name: str, proto: bytes):
        self.name, self.dtype, self.shape = name, 0, []
        self.shard_id = self.offset = self.size = self.crc32c = 0
        self.sliced = False
        for field, _, value in _proto_fields(proto):
            if field == 1:
                self.dtype = value
            elif field == 2:  # TensorShapeProto: repeated Dim dim = 2 {int64 size = 1}
                for f2, _, dim in _proto_fields(value):
                    if f2 == 2:
                        self.shape.append(next((_signed64(v) for f3, _, v in _proto_fields(dim) if f3 == 1), 0))
                    elif f2 == 3 and dim:
                        raise ValueError(f"{name}: a tensor of unknown rank is not read")
            elif field == 3:
                self.shard_id = value
            elif field == 4:
                self.offset = value
            elif field == 5:
                self.size = value
            elif field == 6:
                self.crc32c = value
            elif field == 7:
                self.sliced = True


def _read_block(index: bytes, offset: int, size: int) -> bytes:
    block = index[offset:offset + size]
    trailer = index[offset + size:offset + size + BLOCK_TRAILER_BYTES]
    if len(block) != size or len(trailer) != BLOCK_TRAILER_BYTES:
        raise ValueError(f"index block at {offset} (+{size}) runs past the end of the file")
    if trailer[0] != 0:
        raise ValueError(f"index block at {offset} is compressed (type {trailer[0]}); only uncompressed "
                         "blocks are read")
    if masked_crc32c(block + trailer[:1]) != struct.unpack("<I", trailer[1:])[0]:
        raise ValueError(f"index block at {offset}: CRC-32C mismatch")
    return block


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) of a table block: entries of (shared, non-shared, value
    length) varints, the key's new bytes and the value, up to the restart
    array (uint32 offsets and their count at the end)."""
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * num_restarts
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + vlen]
        pos += vlen


def resolve_prefix(path: str) -> str:
    """A bundle's prefix from itself, its ``.index`` file, or a directory
    whose ``checkpoint`` state file names the latest one (as
    ``tf.train.load_checkpoint`` takes them)."""
    if os.path.isdir(path):
        state = os.path.join(path, "checkpoint")
        if not os.path.isfile(state):
            raise FileNotFoundError(f"{path} holds no 'checkpoint' state file naming a bundle")
        with open(state) as f:
            m = re.search(r'^model_checkpoint_path:\s*"(.*)"\s*$', f.read(), re.M)
        if not m:
            raise ValueError(f"{state} names no model_checkpoint_path")
        prefix = m.group(1)
        return prefix if os.path.isabs(prefix) else os.path.join(path, prefix)
    if path.endswith(".index"):
        return path[: -len(".index")]
    return path


class BundleReader:
    """The variables of the V2 bundle at ``path`` (a prefix, its ``.index``,
    or a directory with a ``checkpoint`` state file)."""

    def __init__(self, path: str):
        self.prefix = resolve_prefix(path)
        index_path = self.prefix + ".index"
        if not os.path.isfile(index_path):
            if os.path.isfile(self.prefix):
                raise ValueError(f"{self.prefix} is a V1 (single-file) checkpoint; only the V2 bundle "
                                 "(<prefix>.index and <prefix>.data-*) is read")
            raise FileNotFoundError(f"no checkpoint bundle at {self.prefix} ({index_path} is missing)")
        with open(index_path, "rb") as f:
            index = f.read()
        if len(index) < FOOTER_BYTES:
            raise ValueError(f"{index_path} is shorter than a table footer")
        footer = index[-FOOTER_BYTES:]
        magic = struct.unpack("<Q", footer[-8:])[0]
        if magic != TABLE_MAGIC:
            raise ValueError(f"{index_path}: table magic {magic:#x}, expected {TABLE_MAGIC:#x}")
        pos = 0
        _, pos = _varint(footer, pos)  # the metaindex handle: TF writes it empty
        _, pos = _varint(footer, pos)
        index_offset, pos = _varint(footer, pos)
        index_size, pos = _varint(footer, pos)
        self.entries: Dict[str, BundleEntry] = {}
        self.num_shards = 1
        self.num_blocks = 0  # data blocks of the index table
        for _, handle in _block_entries(_read_block(index, index_offset, index_size)):
            self.num_blocks += 1
            offset, p = _varint(handle, 0)
            size, _ = _varint(handle, p)
            for key, value in _block_entries(_read_block(index, offset, size)):
                if key == b"":
                    self._read_header(value)
                else:
                    name = key.decode()
                    self.entries[name] = BundleEntry(name, value)

    def _read_header(self, proto: bytes) -> None:
        for field, _, value in _proto_fields(proto):
            if field == 1:
                self.num_shards = value
            elif field == 2 and value != 0:
                raise ValueError(f"{self.prefix}: a big-endian bundle is not read")

    def keys(self) -> List[str]:
        return sorted(self.entries)

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self.entries[name].shape)

    def get_tensor(self, name: str) -> np.ndarray:
        """The variable ``name`` as a numpy array (bf16 widened to f32)."""
        entry = self.entries[name]
        if entry.sliced:
            raise ValueError(f"{name} is stored in slices (a partitioned variable); not read")
        if entry.dtype not in _DTYPES and entry.dtype != DT_BFLOAT16:
            raise ValueError(f"{name} has dtype {_DTYPE_NAMES.get(entry.dtype, entry.dtype)}; read are "
                             "DT_FLOAT, DT_DOUBLE, DT_INT32, DT_INT64 and DT_BFLOAT16")
        data_path = f"{self.prefix}.data-{entry.shard_id:05d}-of-{self.num_shards:05d}"
        with open(data_path, "rb") as f:
            f.seek(entry.offset)
            raw = f.read(entry.size)
        if len(raw) != entry.size:
            raise ValueError(f"{name}: {data_path} ends before its {entry.size} bytes at {entry.offset}")
        if masked_crc32c(raw) != entry.crc32c:
            raise ValueError(f"{name}: CRC-32C mismatch in {data_path}")
        count = int(np.prod(entry.shape, dtype=np.int64))
        if entry.dtype == DT_BFLOAT16:
            bits = np.frombuffer(raw, "<u2", count).astype(np.uint32) << 16
            return bits.view(np.float32).reshape(entry.shape)
        return np.frombuffer(raw, _DTYPES[entry.dtype], count).reshape(entry.shape).astype(
            _DTYPES[entry.dtype].newbyteorder("="))
