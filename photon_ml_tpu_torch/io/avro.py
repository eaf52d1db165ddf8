"""Pure-Python Apache Avro object-container-file codec (own copy of
``photon_ml_tpu/io/avro.py``, with the same format and the same API).

The Avro 1.x binary encoding (zig-zag varints, length-prefixed strings and
bytes, blocked arrays and maps, union indexes, record fields in order) and
the container framing (magic ``Obj\\x01``, a metadata map holding
``avro.schema`` and ``avro.codec``, a 16-byte sync marker after every
block; the ``null`` and ``deflate`` codecs). Types: null, boolean, int,
long, float, double, bytes, string, record, array, map, union, enum, fixed.
Schemas are plain dicts (JSON); named types resolve against the file's
schema. Files interchange with the JAX package and with any Avro tooling.

The reference walks the schema dict for every value it reads or writes.
Here a schema is compiled once per file into one closure per node, which
does the same work with fewer dictionary lookups; the bytes are the same.
The readers' default path is the columnar C++ decoder of
``io/native_ingest.py`` (``native/avro_ingest.cc``); this codec is its
plain version and the writer.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Callable, Iterable, Iterator

MAGIC = b"Obj\x01"
SYNC_SIZE = 16

_PRIMITIVES = {"null", "boolean", "int", "long", "float", "double", "bytes", "string"}

_unpack_f = struct.Struct("<f").unpack_from
_unpack_d = struct.Struct("<d").unpack_from
_pack_f = struct.Struct("<f").pack
_pack_d = struct.Struct("<d").pack


# ---------------------------------------------------------------------------
# schema handling
# ---------------------------------------------------------------------------
def _normalize(schema: Any) -> Any:
    """'string' → {'type': 'string'}; lists (unions) stay lists."""
    if isinstance(schema, str):
        return {"type": schema}
    return schema


def _collect_named(schema: Any, registry: dict[str, Any]) -> None:
    """Register named types (record, enum, fixed) so later references by
    name resolve (Avro defines a named type once and references it)."""
    if isinstance(schema, list):
        for s in schema:
            _collect_named(s, registry)
        return
    if not isinstance(schema, dict):
        return
    t = schema.get("type")
    if t in ("record", "enum", "fixed"):
        name = schema.get("name")
        if name:
            registry[name] = schema
            ns = schema.get("namespace")
            if ns:
                registry[f"{ns}.{name}"] = schema
    if t == "record":
        for f in schema.get("fields", ()):
            _collect_named(f.get("type"), registry)
    elif t == "array":
        _collect_named(schema.get("items"), registry)
    elif t == "map":
        _collect_named(schema.get("values"), registry)


def _resolve(schema: Any, registry: dict[str, Any]) -> Any:
    if isinstance(schema, str) and schema not in _PRIMITIVES:
        if schema not in registry:
            raise ValueError(f"unresolved Avro type reference: {schema!r}")
        return registry[schema]
    return schema


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------
def _read_long(buf: bytes, pos: int) -> tuple[int, int]:
    b = buf[pos]
    pos += 1
    acc = b & 0x7F
    shift = 7
    while b & 0x80:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        shift += 7
    return (acc >> 1) ^ -(acc & 1), pos  # zig-zag


def _write_long(buf: bytearray, v: int) -> None:
    v = (v << 1) ^ (v >> 63)  # zig-zag (Python ints: the shift is arithmetic)
    while v > 0x7F:
        buf.append((v & 0x7F) | 0x80)
        v >>= 7
    buf.append(v)


def _read_bytes(buf: bytes, pos: int) -> tuple[bytes, int]:
    n, pos = _read_long(buf, pos)
    end = pos + n
    if end > len(buf):
        raise EOFError("truncated Avro data")
    return buf[pos:end], end


# ---------------------------------------------------------------------------
# decoder: schema → reader(buf, pos) -> (value, pos)
# ---------------------------------------------------------------------------
Reader = Callable[[bytes, int], tuple[Any, int]]


def _read_null(buf, pos):
    return None, pos


def _read_boolean(buf, pos):
    if pos >= len(buf):
        raise EOFError("truncated Avro data")
    return buf[pos] != 0, pos + 1


def _read_float(buf, pos):
    return _unpack_f(buf, pos)[0], pos + 4


def _read_double(buf, pos):
    return _unpack_d(buf, pos)[0], pos + 8


def _read_string(buf, pos):
    raw, pos = _read_bytes(buf, pos)
    return raw.decode("utf-8"), pos


_PRIMITIVE_READERS: dict[str, Reader] = {
    "null": _read_null,
    "boolean": _read_boolean,
    "int": _read_long,
    "long": _read_long,
    "float": _read_float,
    "double": _read_double,
    "bytes": _read_bytes,
    "string": _read_string,
}


def _reader(schema: Any, registry: dict[str, Any], memo: dict[int, Reader]) -> Reader:
    schema = _resolve(schema, registry)
    if isinstance(schema, list):  # union
        branches = [_reader(s, registry, memo) for s in schema]

        def read_union(buf, pos):
            idx, pos = _read_long(buf, pos)
            return branches[idx](buf, pos)

        return read_union
    schema = _normalize(schema)
    t = schema["type"]
    if isinstance(t, (dict, list)):  # e.g. {"type": {"type": "array", ...}}
        return _reader(t, registry, memo)
    if t in _PRIMITIVE_READERS:
        return _PRIMITIVE_READERS[t]
    if t == "fixed":
        size = schema["size"]

        def read_fixed(buf, pos):
            end = pos + size
            if end > len(buf):
                raise EOFError("truncated Avro data")
            return buf[pos:end], end

        return read_fixed
    if t == "enum":
        symbols = schema["symbols"]

        def read_enum(buf, pos):
            i, pos = _read_long(buf, pos)
            return symbols[i], pos

        return read_enum
    if t == "array":
        item = _reader(schema["items"], registry, memo)

        def read_array(buf, pos):
            out = []
            while True:
                count, pos = _read_long(buf, pos)
                if count == 0:
                    return out, pos
                if count < 0:
                    count = -count
                    _, pos = _read_long(buf, pos)  # block byte size: unused
                for _ in range(count):
                    v, pos = item(buf, pos)
                    out.append(v)

        return read_array
    if t == "map":
        value = _reader(schema["values"], registry, memo)

        def read_map(buf, pos):
            out = {}
            while True:
                count, pos = _read_long(buf, pos)
                if count == 0:
                    return out, pos
                if count < 0:
                    count = -count
                    _, pos = _read_long(buf, pos)
                for _ in range(count):
                    k, pos = _read_string(buf, pos)
                    out[k], pos = value(buf, pos)

        return read_map
    if t == "record":
        key = id(schema)
        if key in memo:  # a recursive reference to a record being compiled
            return memo[key]
        fields: list[tuple[str, Reader]] = []

        def read_record(buf, pos):
            out = {}
            for name, read in fields:
                out[name], pos = read(buf, pos)
            return out, pos

        memo[key] = read_record
        fields += [(f["name"], _reader(f["type"], registry, memo)) for f in schema["fields"]]
        return read_record
    raise ValueError(f"unsupported Avro type: {t!r}")


# ---------------------------------------------------------------------------
# encoder: schema → writer(buf, value)
# ---------------------------------------------------------------------------
Writer = Callable[[bytearray, Any], None]


def _write_null(buf, v):
    return None


def _write_boolean(buf, v):
    buf.append(1 if v else 0)


def _write_int(buf, v):
    _write_long(buf, int(v))


def _write_float(buf, v):
    buf += _pack_f(float(v))


def _write_double(buf, v):
    buf += _pack_d(float(v))


def _write_bytes(buf, v):
    _write_long(buf, len(v))
    buf += v


def _write_string(buf, v):
    raw = v.encode("utf-8")
    _write_long(buf, len(raw))
    buf += raw


_PRIMITIVE_WRITERS: dict[str, Writer] = {
    "null": _write_null,
    "boolean": _write_boolean,
    "int": _write_int,
    "long": _write_int,
    "float": _write_float,
    "double": _write_double,
    "bytes": _write_bytes,
    "string": _write_string,
}


def _union_index(kinds: list, value: Any) -> int:
    """The first branch whose type matches the value's Python type; else the
    first non-null branch (numeric promotions such as int → double)."""
    for i, k in enumerate(kinds):
        if value is None:
            if k == "null":
                return i
        elif k != "null":
            if isinstance(value, bool):
                if k == "boolean":
                    return i
            elif isinstance(value, str):
                if k in ("string", "enum"):
                    return i
            elif isinstance(value, (bytes, bytearray)):
                if k in ("bytes", "fixed"):
                    return i
            elif isinstance(value, int) and k in ("int", "long"):
                return i
            elif isinstance(value, float) and k in ("float", "double"):
                return i
            elif isinstance(value, dict) and k in ("record", "map"):
                return i
            elif isinstance(value, (list, tuple)) and k == "array":
                return i
    if value is not None:
        for i, k in enumerate(kinds):
            if k != "null":
                return i
    raise ValueError(f"no union branch for value {value!r}")


def _writer(schema: Any, registry: dict[str, Any], memo: dict[int, Writer]) -> Writer:
    schema = _resolve(schema, registry)
    if isinstance(schema, list):  # union
        branches = [_writer(s, registry, memo) for s in schema]
        kinds = [_normalize(_resolve(s, registry))["type"] for s in schema]

        def write_union(buf, v):
            idx = _union_index(kinds, v)
            _write_long(buf, idx)
            branches[idx](buf, v)

        return write_union
    schema = _normalize(schema)
    t = schema["type"]
    if isinstance(t, (dict, list)):
        return _writer(t, registry, memo)
    if t in _PRIMITIVE_WRITERS:
        return _PRIMITIVE_WRITERS[t]
    if t == "fixed":
        size = schema["size"]

        def write_fixed(buf, v):
            if len(v) != size:
                raise ValueError("fixed size mismatch")
            buf += v

        return write_fixed
    if t == "enum":
        symbols = schema["symbols"]

        def write_enum(buf, v):
            _write_long(buf, symbols.index(v))

        return write_enum
    if t == "array":
        item = _writer(schema["items"], registry, memo)

        def write_array(buf, v):
            if v:
                _write_long(buf, len(v))
                for x in v:
                    item(buf, x)
            buf.append(0)

        return write_array
    if t == "map":
        value = _writer(schema["values"], registry, memo)

        def write_map(buf, v):
            if v:
                _write_long(buf, len(v))
                for k, x in v.items():
                    _write_string(buf, k)
                    value(buf, x)
            buf.append(0)

        return write_map
    if t == "record":
        key = id(schema)
        if key in memo:
            return memo[key]
        fields: list[tuple[str, Any, Writer]] = []

        def write_record(buf, v):
            for name, default, write in fields:
                write(buf, v.get(name, default))

        memo[key] = write_record
        fields += [
            (f["name"], f.get("default"), _writer(f["type"], registry, memo))
            for f in schema["fields"]
        ]
        return write_record
    raise ValueError(f"unsupported Avro type: {t!r}")


def _compile(schema: Any, build) -> Any:
    registry: dict[str, Any] = {}
    _collect_named(schema, registry)
    return build(schema, registry, {})


# ---------------------------------------------------------------------------
# container files
# ---------------------------------------------------------------------------
def write_avro_file(
    path: str,
    schema: dict,
    records: Iterable[dict],
    codec: str = "deflate",
    sync_interval: int = 4000,
) -> None:
    """Write records to an Avro object container file, ``sync_interval``
    records a block."""
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec {codec!r}")
    write = _compile(schema, _writer)
    sync = os.urandom(SYNC_SIZE)

    header = bytearray(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(), "avro.codec": codec.encode()}
    _write_long(header, len(meta))
    for k, v in meta.items():
        _write_bytes(header, k.encode())
        _write_bytes(header, v)
    _write_long(header, 0)
    header += sync

    def flush_block(out, buf: bytearray, count: int) -> None:
        if count == 0:
            return
        data = bytes(buf)
        if codec == "deflate":
            data = zlib.compress(data)[2:-4]  # raw deflate, as the spec asks
        blk = bytearray()
        _write_long(blk, count)
        _write_long(blk, len(data))
        out.write(bytes(blk))
        out.write(data)
        out.write(sync)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as out:
        out.write(bytes(header))
        buf = bytearray()
        count = 0
        for rec in records:
            write(buf, rec)
            count += 1
            if count >= sync_interval:
                flush_block(out, buf, count)
                buf = bytearray()
                count = 0
        flush_block(out, buf, count)


def _read_header(path: str, data: bytes) -> tuple[dict[str, bytes], int]:
    """The container's metadata map and the position after it."""
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not an Avro container file")
    pos = 4
    meta: dict[str, bytes] = {}
    while True:
        count, pos = _read_long(data, pos)
        if count == 0:
            return meta, pos
        if count < 0:
            count = -count
            _, pos = _read_long(data, pos)
        for _ in range(count):
            k, pos = _read_bytes(data, pos)
            meta[k.decode()], pos = _read_bytes(data, pos)


def read_avro_schema(path: str) -> dict:
    """The file's writer schema, from the container header alone."""
    with open(path, "rb") as f:
        data = f.read(1 << 20)  # the header fits in 1 MB
    meta, _ = _read_header(path, data)
    if "avro.schema" not in meta:
        raise ValueError(f"{path}: container has no avro.schema header")
    return json.loads(meta["avro.schema"])


def read_avro_file(path: str) -> tuple[dict, list[dict]]:
    """Read an Avro object container file → (schema, records)."""
    with open(path, "rb") as f:
        data = f.read()
    meta, pos = _read_header(path, data)
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec {codec!r}")
    sync, pos = data[pos:pos + SYNC_SIZE], pos + SYNC_SIZE
    if len(sync) != SYNC_SIZE:
        raise EOFError("truncated Avro data")
    read = _compile(schema, _reader)

    records: list[dict] = []
    while pos < len(data):
        count, pos = _read_long(data, pos)
        size, pos = _read_long(data, pos)
        end = pos + size
        if end + SYNC_SIZE > len(data):
            raise EOFError("truncated Avro data")
        block = data[pos:end]
        if codec == "deflate":
            block = zlib.decompress(block, wbits=-15)
        p = 0
        for _ in range(count):
            rec, p = read(block, p)
            records.append(rec)
        if data[end:end + SYNC_SIZE] != sync:
            raise ValueError(f"{path}: sync marker mismatch (corrupt file)")
        pos = end + SYNC_SIZE
    return schema, records


def list_avro_files(path: str) -> list[str]:
    """The data files ``path`` denotes: itself when a file, else its sorted
    non-hidden ``*.avro`` part files."""
    if os.path.isfile(path):
        return [path]
    names = sorted(n for n in os.listdir(path) if n.endswith(".avro") and not n.startswith("."))
    if not names:
        raise FileNotFoundError(f"no .avro files under {path}")
    return [os.path.join(path, n) for n in names]


def iter_avro_directory(path: str) -> Iterator[dict]:
    """Every record of ``path``: a file or a directory of part files (like
    the reference's HDFS output directories)."""
    for p in list_avro_files(path):
        yield from read_avro_file(p)[1]
