"""The Avro object-container format, in pure Python.

A copy of ``isoforest_tpu/io/avro.py``: the read path (header, block
decode, :func:`read_container`, codecs ``null``, ``deflate`` and
``snappy``, the best-effort :func:`read_blocks_tolerant` of a degraded
load, and the read-fault seam of :mod:`..resilience.faults`) and the write path (:func:`encode_value`,
:func:`write_container`, codecs ``null`` and ``deflate``), so the port
reads and writes model files without the JAX package. It covers the subset
of the Avro 1.x specification the model layout needs: primitives, records,
arrays, maps, unions and the container framing (magic ``Obj\\x01``,
metadata map, 16-byte sync marker, record blocks).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Dict, Iterable, List, Tuple

MAGIC = b"Obj\x01"
SYNC_SIZE = 16


def snappy_decompress(data: bytes) -> bytes:
    """Decode a raw snappy block (the format Avro's snappy codec wraps)."""
    pos = 0
    expected = 0
    shift = 0
    while True:  # uncompressed length, varint
        b = data[pos]
        pos += 1
        expected |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                length = int.from_bytes(data[pos : pos + extra], "little")
                pos += extra
            length += 1
            out += data[pos : pos + length]
            pos += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x07) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0:
            raise ValueError("corrupt snappy stream: zero copy offset")
        start = len(out) - offset
        if start < 0:
            raise ValueError("corrupt snappy stream: offset before start")
        for _ in range(length):  # copies may overlap, so byte by byte
            out.append(out[start])
            start += 1
    if len(out) != expected:
        raise ValueError(f"snappy length mismatch: expected {expected}, got {len(out)}")
    return bytes(out)


def encode_long(value: int) -> bytes:
    """Zigzag varint of an int or long."""
    out = bytearray()
    n = (value << 1) ^ (value >> 63) if value >= 0 else ((-value) << 1) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read_long(self) -> int:
        result = 0
        shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (result >> 1) ^ -(result & 1)

    def read_bytes(self) -> bytes:
        return self.read_raw(self.read_long())

    def read_raw(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out


def _normalise(schema: Any) -> Any:
    """Accept schema JSON strings or already-parsed dict/list forms."""
    if isinstance(schema, str) and schema[:1] in ("{", "["):
        return json.loads(schema)
    return schema


def encode_value(schema: Any, value: Any, out: bytearray) -> None:
    """Append the binary encoding of ``value`` under ``schema`` to ``out``.
    A union takes its ``null`` branch for None, else its first other branch."""
    schema = _normalise(schema)
    if isinstance(schema, list):
        for i, branch in enumerate(schema):
            if (branch == "null") == (value is None):
                out += encode_long(i)
                encode_value(branch, value, out)
                return
        raise ValueError(f"union {schema!r} has no branch for {value!r}")
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            for field in schema["fields"]:
                encode_value(field["type"], value[field["name"]], out)
            return
        if t in ("array", "map"):
            items = list(value.items() if t == "map" else value)
            if items:
                out += encode_long(len(items))
                for item in items:
                    if t == "array":
                        encode_value(schema["items"], item, out)
                    else:
                        encode_value("string", item[0], out)
                        encode_value(schema["values"], item[1], out)
            out += encode_long(0)
            return
        encode_value(t, value, out)
        return
    if schema == "null":
        return
    if schema == "boolean":
        out.append(1 if value else 0)
    elif schema in ("int", "long"):
        out += encode_long(int(value))
    elif schema == "float":
        out += struct.pack("<f", float(value))
    elif schema == "double":
        out += struct.pack("<d", float(value))
    elif schema in ("string", "bytes"):
        data = value.encode() if isinstance(value, str) else bytes(value)
        out += encode_long(len(data))
        out += data
    else:
        raise ValueError(f"unsupported Avro schema: {schema!r}")


def decode_value(schema: Any, reader: _Reader) -> Any:
    schema = _normalise(schema)
    if isinstance(schema, list):  # union: branch index, then the value
        return decode_value(schema[reader.read_long()], reader)
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            return {f["name"]: decode_value(f["type"], reader) for f in schema["fields"]}
        if t in ("array", "map"):
            items: List[Any] = []
            entries: Dict[str, Any] = {}
            while True:
                count = reader.read_long()
                if count == 0:
                    break
                if count < 0:
                    reader.read_long()  # block byte size, unused
                    count = -count
                for _ in range(count):
                    if t == "array":
                        items.append(decode_value(schema["items"], reader))
                    else:
                        key = reader.read_bytes().decode()
                        entries[key] = decode_value(schema["values"], reader)
            return items if t == "array" else entries
        return decode_value(t, reader)
    if schema == "null":
        return None
    if schema == "boolean":
        return reader.read_raw(1) != b"\x00"
    if schema in ("int", "long"):
        return reader.read_long()
    if schema == "float":
        return struct.unpack("<f", reader.read_raw(4))[0]
    if schema == "double":
        return struct.unpack("<d", reader.read_raw(8))[0]
    if schema == "string":
        return reader.read_bytes().decode()
    if schema == "bytes":
        return reader.read_bytes()
    raise ValueError(f"unsupported Avro schema: {schema!r}")


def _read_container_header(path: str):
    """Parse the container header -> (reader at the first block, file bytes,
    schema, codec, sync marker)."""
    from ..resilience import faults

    with open(path, "rb") as fh:
        data = faults.filter_read_bytes(path, fh.read())
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not an Avro object container file")
    reader = _Reader(data, 4)
    meta: Dict[str, bytes] = {}
    while True:
        count = reader.read_long()
        if count == 0:
            break
        if count < 0:
            reader.read_long()
            count = -count
        for _ in range(count):
            key = reader.read_bytes().decode()
            meta[key] = reader.read_bytes()
    sync = reader.read_raw(SYNC_SIZE)
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    return reader, data, schema, codec, sync


def _decode_block(path: str, data: bytes, reader: _Reader, codec: str):
    """Read and decompress the block at the reader's position -> (count, body)."""
    count = reader.read_long()
    size = reader.read_long()
    if size < 0 or size > len(data) - reader.pos:
        raise ValueError(f"{path}: block size {size} exceeds remaining file")
    block = reader.read_raw(size)
    if codec == "deflate":
        block = zlib.decompress(block, -15)
    elif codec == "snappy":
        # the block ends in the big-endian CRC32 of the plaintext
        body = snappy_decompress(block[:-4])
        if zlib.crc32(body) & 0xFFFFFFFF != struct.unpack(">I", block[-4:])[0]:
            raise ValueError(f"{path}: snappy block CRC mismatch")
        block = body
    elif codec != "null":
        raise ValueError(f"unsupported read codec {codec!r}")
    return count, block


def read_blocks(path: str) -> Tuple[Any, List[Tuple[int, bytes]]]:
    """Read a container -> (parsed schema, [(record count, plaintext body)])."""
    reader, data, schema, codec, sync = _read_container_header(path)
    blocks: List[Tuple[int, bytes]] = []
    while reader.pos < len(data):
        blocks.append(_decode_block(path, data, reader, codec))
        if reader.read_raw(SYNC_SIZE) != sync:
            raise ValueError(f"{path}: sync marker mismatch")
    return schema, blocks


def read_blocks_tolerant(path: str):
    """Best-effort :func:`read_blocks` for a degraded load
    (``on_corrupt="drop"``): a block that fails to decode, or whose sync
    marker does not match, is reported and ends the read (the framing after
    it cannot be trusted). Returns ``(schema, blocks, issues)``."""
    reader, data, schema, codec, sync = _read_container_header(path)
    blocks: List[Tuple[int, bytes]] = []
    issues: List[str] = []
    index = 0
    while reader.pos < len(data):
        try:
            block = _decode_block(path, data, reader, codec)
        except Exception as exc:
            issues.append(f"{os.path.basename(path)} block {index}: {exc}")
            break
        if reader.read_raw(SYNC_SIZE) != sync:
            issues.append(
                f"{os.path.basename(path)} block {index}: sync marker "
                "mismatch (truncated or shifted frame); discarding the "
                "block and the remainder of the file"
            )
            break
        blocks.append(block)
        index += 1
    return schema, blocks, issues


def read_container(path: str) -> Tuple[Any, List[dict]]:
    """Read an Avro object-container file -> (parsed schema, records)."""
    schema, blocks = read_blocks(path)
    records: List[dict] = []
    for count, block in blocks:
        block_reader = _Reader(block)
        for _ in range(count):
            records.append(decode_value(schema, block_reader))
    return schema, records


def _write_header(fh, schema_json: str, codec: str, sync: bytes) -> None:
    header = bytearray(MAGIC)
    meta = {"avro.schema": schema_json.encode(), "avro.codec": codec.encode()}
    header += encode_long(len(meta))
    for k, v in meta.items():
        kb = k.encode()
        header += encode_long(len(kb)) + kb + encode_long(len(v)) + v
    header += encode_long(0)
    header += sync
    fh.write(bytes(header))


def _compress_block(payload: bytes, codec: str, level: int = 9) -> bytes:
    if codec == "deflate":
        comp = zlib.compressobj(level, zlib.DEFLATED, -15)
        return comp.compress(payload) + comp.flush()
    if codec != "null":
        raise ValueError(f"unsupported write codec {codec!r}")
    return payload


def write_container(
    path: str,
    schema: Any,
    records: Iterable[dict],
    codec: str = "deflate",
    block_records: int = 4096,
) -> None:
    """Write an Avro object-container file, ``block_records`` records a block."""
    schema_json = schema if isinstance(schema, str) else json.dumps(schema)
    parsed = _normalise(schema_json)
    sync = os.urandom(SYNC_SIZE)
    with open(path, "wb") as fh:
        _write_header(fh, schema_json, codec, sync)

        def flush(batch: List[dict]) -> None:
            if not batch:
                return
            body = bytearray()
            for rec in batch:
                encode_value(parsed, rec, body)
            payload = _compress_block(bytes(body), codec)
            fh.write(encode_long(len(batch)) + encode_long(len(payload)) + payload + sync)

        batch: List[dict] = []
        for rec in records:
            batch.append(rec)
            if len(batch) >= block_records:
                flush(batch)
                batch = []
        flush(batch)
