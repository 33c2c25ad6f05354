"""Datasource plugin API + extra built-in readers.

Reference: `python/ray/data/datasource/datasource.py` (`Datasource` with
`get_read_tasks` / `ReadTask`) and the format readers under
`python/ray/data/datasource/` (numpy, tfrecords, binary). A datasource
describes WHERE the blocks come from; `read_datasource()` compiles it into
the same streaming `ReadSource` every built-in reader uses, so custom
sources get read->map fusion, generator backpressure, and locality for free.

TFRecords are parsed WITHOUT tensorflow: the record framing (u64 length +
masked-crc32c + payload + crc) and the `tf.train.Example` protobuf wire
format (features: map<string, Feature{bytes|float|int64 list}>) are simple
enough to decode directly — protobuf wire format, not a protobuf library.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class ReadTask:
    """One unit of reading: a zero-arg callable producing a block.

    num_rows/size_bytes are advisory ESTIMATES carried for reference-API
    parity (`datasource.py ReadTask`); the streaming executor derives exact
    metadata from the produced block after the read, so they do not steer
    scheduling here."""

    def __init__(self, read_fn: Callable[[], Dict[str, np.ndarray]],
                 num_rows: Optional[int] = None,
                 size_bytes: Optional[int] = None):
        self.read_fn = read_fn
        self.num_rows = num_rows
        self.size_bytes = size_bytes

    def __call__(self):
        return self.read_fn()


class Datasource:
    """Implement `get_read_tasks(parallelism)` to plug any storage system
    into `ray_tpu_torch.data.read_datasource` (reference: custom datasources,
    `data/datasource/datasource.py:30`)."""

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


def _run_read_task(task: ReadTask):
    return task()


# ----------------------------------------------------------- built-in sources
def _read_npy_files(files: List[str], _payload) -> Dict[str, np.ndarray]:
    arrays = [np.load(f, allow_pickle=False) for f in files]
    return {"data": np.concatenate(arrays) if len(arrays) > 1 else arrays[0]}


def _read_binary_files(files: List[str], include_paths: bool) -> Dict[str, np.ndarray]:
    payloads = []
    for f in files:
        with open(f, "rb") as fh:
            payloads.append(fh.read())
    block: Dict[str, np.ndarray] = {"bytes": np.array(payloads, dtype=object)}
    if include_paths:
        block["path"] = np.array(files, dtype=object)
    return block


# --------------------------------------------------------------- tfrecord I/O
def _iter_tfrecords(path: str):
    """Yield raw record payloads from a TFRecord file (framing only; CRCs
    skipped — corrupt files surface as struct errors, same failure class as
    the reference's non-validating fast path)."""
    with open(path, "rb") as fh:
        while True:
            head = fh.read(12)
            if len(head) < 12:
                return
            (length,) = struct.unpack("<Q", head[:8])
            payload = fh.read(length)
            fh.read(4)  # payload crc
            if len(payload) < length:
                return
            yield payload


def _parse_example(payload: bytes) -> Dict[str, Any]:
    """Decode a tf.train.Example protobuf by wire format.

    Example{ features: Features{ feature: map<string, Feature> } };
    Feature is a oneof of BytesList(field 1)/FloatList(2)/Int64List(3),
    each wrapping a repeated `value` field 1.
    """

    def read_varint(buf: memoryview, i: int) -> Tuple[int, int]:
        shift = out = 0
        while True:
            b = buf[i]
            i += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out, i
            shift += 7

    def read_fields(buf: memoryview):
        i = 0
        while i < len(buf):
            key, i = read_varint(buf, i)
            field, wire = key >> 3, key & 7
            if wire == 2:  # length-delimited
                n, i = read_varint(buf, i)
                yield field, buf[i:i + n]
                i += n
            elif wire == 0:
                v, i = read_varint(buf, i)
                yield field, v
            elif wire == 5:  # 32-bit
                yield field, bytes(buf[i:i + 4])
                i += 4
            elif wire == 1:  # 64-bit
                yield field, bytes(buf[i:i + 8])
                i += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")

    def parse_list(buf: memoryview, kind: int):
        values: List[Any] = []
        for field, val in read_fields(buf):
            if field != 1:
                continue
            if kind == 1:  # bytes
                values.append(bytes(val))
            elif kind == 2:  # packed floats (or single 32-bit)
                raw = bytes(val) if isinstance(val, (bytes, memoryview)) else val
                values.extend(
                    struct.unpack(f"<{len(raw) // 4}f", raw)
                )
            else:  # int64: varint (possibly packed)
                def signed(v: int) -> int:
                    # Two's-complement int64: protobuf encodes negatives as
                    # 10-byte varints of the unsigned 64-bit pattern.
                    return v - (1 << 64) if v >= (1 << 63) else v

                if isinstance(val, int):
                    values.append(signed(val))
                else:
                    j = 0
                    mv = memoryview(val)
                    while j < len(mv):
                        v, j = read_varint(mv, j)
                        values.append(signed(v))
        return values

    row: Dict[str, Any] = {}
    mv = memoryview(payload)
    for f1, features_buf in read_fields(mv):
        if f1 != 1:  # Example.features
            continue
        for f2, entry in read_fields(features_buf):
            if f2 != 1:  # Features.feature (map entry)
                continue
            name = None
            value: Any = None
            for f3, part in read_fields(entry):
                if f3 == 1:
                    name = bytes(part).decode()
                elif f3 == 2:  # Feature
                    for kind, lst in read_fields(part):
                        value = parse_list(lst, kind)
            if name is not None:
                row[name] = value
    return row


def _read_tfrecord_files(files: List[str], _payload) -> Dict[str, np.ndarray]:
    rows = []
    for f in files:
        for payload in _iter_tfrecords(f):
            row = _parse_example(payload)
            # Single-element lists flatten to scalars (the common Example
            # shape); multi-element lists stay lists (object column).
            rows.append({
                k: (v[0] if isinstance(v, list) and len(v) == 1 else v)
                for k, v in row.items()
            })
    from ray_tpu_torch.data.block import BlockAccessor

    return BlockAccessor.from_rows(rows)


_CRC32C_TABLE = None


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven — TFRecord framing checksums."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            table.append(crc)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def write_tfrecords(rows: List[Dict[str, Any]], path: str) -> None:
    """Minimal TFRecord+Example writer with real masked-crc32c framing, so
    CRC-validating readers (tf.data.TFRecordDataset) accept the output."""

    def varint(n: int) -> bytes:
        # Negatives encode as the unsigned 64-bit two's-complement pattern
        # (a plain right-shift of a negative Python int never terminates).
        n &= (1 << 64) - 1
        out = b""
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                out += bytes([b | 0x80])
            else:
                return out + bytes([b])

    def field(num: int, wire: int, payload: bytes) -> bytes:
        return varint((num << 3) | wire) + (
            varint(len(payload)) + payload if wire == 2 else payload
        )

    def feature(value: Any) -> bytes:
        values = value if isinstance(value, list) else [value]
        if all(isinstance(v, (bytes, str)) for v in values):
            lst = b"".join(
                field(1, 2, v.encode() if isinstance(v, str) else v)
                for v in values
            )
            return field(1, 2, lst)
        if all(isinstance(v, int) for v in values):
            lst = b"".join(field(1, 0, varint(v)) for v in values)
            return field(3, 2, lst)
        packed = struct.pack(f"<{len(values)}f", *[float(v) for v in values])
        return field(2, 2, field(1, 2, packed))

    with open(path, "wb") as fh:
        for row in rows:
            entries = b""
            for name, value in row.items():
                entry = field(1, 2, name.encode()) + field(2, 2, feature(value))
                entries += field(1, 2, entry)
            example = field(1, 2, entries)
            length = struct.pack("<Q", len(example))
            fh.write(length)
            fh.write(struct.pack("<I", _masked_crc(length)))
            fh.write(example)
            fh.write(struct.pack("<I", _masked_crc(example)))
