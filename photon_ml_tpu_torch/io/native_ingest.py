"""Native columnar Avro ingest: the schema-program compiler and the ctypes
wrapper of ``native/avro_ingest.cc`` (port of
``photon_ml_tpu/io/native_ingest.py``).

The C++ decoder runs a small opcode program compiled here from a file's
writer schema and returns columns: numeric fields, CSR feature bags with a
first-seen-order table of interned keys (each distinct feature string
crosses the C boundary once), per-row entity-tag ids and raw uids.

``compile_program`` raises ``OutsideEnvelope``, naming the field, for a
schema shape the decoder does not take (unions other than [null, X] and
the uid's [null, string, long], bag items that are not (name, term, value)
records, maps of non-strings, a nullable response, ...); the reader then
reads that file set with the Python codec, as the reference does. Every
other failure raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np

from photon_ml_tpu_torch.native import build

# opcode codes (as in avro_ingest.cc)
_END, _SKIP, _CAPNUM, _BAG, _TAGMAP, _UID, _SKIPOPT = 0, 1, 2, 3, 4, 5, 6
_KIND_LONG, _KIND_DOUBLE, _KIND_FLOAT, _KIND_STRING, _KIND_BOOL = 0, 1, 2, 3, 4
_KIND_NULL, _KIND_MAP_STR, _KIND_NTV_ARRAY = 5, 6, 7

# the six field orders of (name, term, value), as avro_ingest.cc's kPerm
_PERMS = {
    (0, 1, 2): 0, (0, 2, 1): 1, (1, 0, 2): 2,
    (2, 0, 1): 3, (1, 2, 0): 4, (2, 1, 0): 5,
}

_PRIMITIVE_KIND = {
    "long": _KIND_LONG, "int": _KIND_LONG, "double": _KIND_DOUBLE,
    "float": _KIND_FLOAT, "string": _KIND_STRING, "bytes": _KIND_STRING,
    "boolean": _KIND_BOOL, "null": _KIND_NULL,
}


class OutsideEnvelope(ValueError):
    """The writer schema has a shape the native decoder does not take."""

    def __init__(self, field_name: str, why: str):
        super().__init__(f"field {field_name!r}: {why}")
        self.field = field_name


@dataclass
class Program:
    ops: np.ndarray  # (n_ops, 4) uint32
    defaults: np.ndarray  # (n_slots,) float64
    slots: dict  # numeric field name -> slot
    bags: list  # bag field names in bag-id order
    capture_uid: bool


@dataclass
class ColumnarFile:
    """One file's decoded columns, copied out of the native handle."""

    num_rows: int
    numeric: dict  # field -> (n,) float64
    # bag -> dict(rowptr (n+1,) int64, ids (nnz,) int64, values (nnz,) float32,
    #             uniq_keys list[str] in first-seen order)
    bags: dict = field(default_factory=dict)
    # tag -> dict(ids (n,) int32 into uniq_values, -1 where the record lacks
    #             the tag; uniq_values list[str] in first-seen order)
    tags: dict = field(default_factory=dict)
    uids: list | None = None


def _resolve_named(schema, registry):
    if isinstance(schema, str):
        return registry.get(schema, schema)
    if isinstance(schema, dict) and schema.get("type") == "record":
        registry[schema["name"]] = schema
        ns = schema.get("namespace")
        if ns:
            registry[f"{ns}.{schema['name']}"] = schema
    return schema


def _ntv_record(schema, registry) -> tuple[int, bool] | None:
    """(field-order index, value is float) when ``schema`` is a (name, term,
    value) record in any field order; else None."""
    schema = _resolve_named(schema, registry)
    if not isinstance(schema, dict) or schema.get("type") != "record":
        return None
    fields = schema.get("fields", [])
    if len(fields) != 3:
        return None
    pos = {}
    value_is_float = False
    for i, f in enumerate(fields):
        t = f["type"]
        if f["name"] == "name" and t == "string":
            pos["name"] = i
        elif f["name"] == "term" and t == "string":
            pos["term"] = i
        elif f["name"] == "value" and t in ("double", "float"):
            pos["value"] = i
            value_is_float = t == "float"
        else:
            return None
    perm = _PERMS.get((pos.get("name"), pos.get("term"), pos.get("value")))
    return None if perm is None else (perm, value_is_float)


def _unwrap_nullable(t):
    """(inner type, union flags) of a plain type or a [null, X] union (bit 0:
    nullable, bit 1: null is the second branch); (None, 0) for other unions."""
    if not isinstance(t, list):
        return t, 0
    if len(t) != 2 or "null" not in t:
        return None, 0
    inner = t[0] if t[1] == "null" else t[1]
    return inner, 1 | (2 if t[1] == "null" else 0)


def compile_program(
    schema: dict,
    bag_fields: list[str],
    numeric_fields: dict,  # field name -> default value
    tag_field: str | None,
    uid_field: str | None,
    non_nullable: frozenset[str] = frozenset(),
) -> Program:
    """The decoder's program for ``schema``; raises ``OutsideEnvelope``.
    ``non_nullable`` numeric fields must not be nullable in the schema: the
    decoder would put the default where the record holds null, and the
    Python path raises on a null label instead."""
    if not isinstance(schema, dict) or schema.get("type") != "record":
        raise OutsideEnvelope(str(schema.get("name") if isinstance(schema, dict) else schema),
                              "the schema is not a record")
    registry: dict = {}
    _resolve_named(schema, registry)
    ops: list[tuple[int, int, int, int]] = []
    defaults: list[float] = []
    slots: dict = {}
    bags_found: dict = {}
    uid_found = False

    for f in schema.get("fields", []):
        fname, ftype = f["name"], f["type"]
        if fname == uid_field:
            uid_found = True
            if ftype == "string":
                ops.append((_UID, 0, 0, 0))
            elif isinstance(ftype, list) and ftype[:2] == ["null", "string"] and ftype[2:] in ([], ["long"]):
                ops.append((_UID, 0, 0, 1 | (4 if ftype[2:] else 0)))
            else:
                raise OutsideEnvelope(fname, f"uid of type {ftype!r}")
            continue
        if fname in numeric_fields:
            inner, flags = _unwrap_nullable(ftype)
            kind = {"long": 0, "int": 0, "double": 1, "float": 2}.get(inner) if isinstance(inner, str) else None
            if kind is None:
                raise OutsideEnvelope(fname, f"numeric field of type {ftype!r}")
            if flags and fname in non_nullable:
                raise OutsideEnvelope(fname, "nullable, and a null here is an error")
            slots[fname] = len(defaults)
            defaults.append(float(numeric_fields[fname]))
            ops.append((_CAPNUM, slots[fname], kind, flags))
            continue
        if fname == tag_field:
            inner, flags = _unwrap_nullable(ftype)
            if not (isinstance(inner, dict) and inner.get("type") == "map" and inner.get("values") == "string"):
                raise OutsideEnvelope(fname, f"id tags of type {ftype!r}")
            ops.append((_TAGMAP, 0, 0, flags))
            continue

        inner, flags = _unwrap_nullable(ftype)
        if inner is None:
            raise OutsideEnvelope(fname, f"union {ftype!r}")
        is_bag = fname in bag_fields
        if isinstance(inner, dict) and inner.get("type") == "array":
            ntv = _ntv_record(inner.get("items"), registry)
            if ntv is None:
                raise OutsideEnvelope(fname, "array items are not (name, term, value) records")
            perm, value_is_float = ntv
            if is_bag:
                bag_id = bags_found.setdefault(fname, len(bags_found))
                c = (1 if value_is_float else 0) | (2 if flags & 1 else 0) | (4 if flags & 2 else 0)
                ops.append((_BAG, bag_id, perm, c))
            elif value_is_float or perm not in (0, 2) or flags:
                # the generic skip takes an 8-byte value last in the record
                raise OutsideEnvelope(fname, "an unread array of this record shape")
            else:
                ops.append((_SKIP, _KIND_NTV_ARRAY, 0, 0))
            continue
        if is_bag:
            raise OutsideEnvelope(fname, "a feature bag that is not an array of (name, term, value)")
        if isinstance(inner, dict) and inner.get("type") == "map":
            if inner.get("values") != "string":
                raise OutsideEnvelope(fname, f"map of {inner.get('values')!r}")
            kind = _KIND_MAP_STR
        else:
            kind = _PRIMITIVE_KIND.get(inner) if isinstance(inner, str) else None
            if kind is None:
                raise OutsideEnvelope(fname, f"type {ftype!r}")
        ops.append((_SKIPOPT, kind, 0, flags) if flags else (_SKIP, kind, 0, 0))

    missing = [b for b in bag_fields if b not in bags_found]
    if missing:
        raise OutsideEnvelope(missing[0], "feature bag absent from the schema")
    ops.append((_END, 0, 0, 0))
    return Program(
        ops=np.asarray(ops, np.uint32),
        defaults=np.asarray(defaults, np.float64),
        slots=slots,
        bags=sorted(bags_found, key=bags_found.get),
        # the decoder fills the uid arrays through the UID op alone
        capture_uid=uid_field is not None and uid_found,
    )


def _strings(lib_blob, offsets: np.ndarray) -> list[str]:
    blob = ctypes.string_at(lib_blob, int(offsets[-1])) if len(offsets) > 1 else b""
    return [blob[offsets[i]:offsets[i + 1]].decode("utf-8", "replace") for i in range(len(offsets) - 1)]


def _array(ptr, n: int, dtype) -> np.ndarray:
    """A numpy copy of ``n`` items behind ``ptr`` (an empty vector's pointer
    may be NULL: never wrapped)."""
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def decode_file(path: str, program: Program, tags: list[str]) -> ColumnarFile:
    """Decode one file with the native library (built on first use); raises
    ``ValueError`` with the decoder's message for a file it cannot read. The
    call releases the GIL, so files decode in parallel threads."""
    lib = build.load()
    ops = np.ascontiguousarray(program.ops, np.uint32)
    defaults = np.ascontiguousarray(program.defaults, np.float64)
    tag_bytes = [t.encode() for t in tags]
    tag_lens = np.asarray([len(t) for t in tag_bytes], np.uint32)
    errbuf = ctypes.create_string_buffer(256)
    handle = lib.pavro_ingest(
        path.encode(),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(ops),
        defaults.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(defaults),
        b"".join(tag_bytes), tag_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(tags),
        len(program.bags), 1 if program.capture_uid else 0,
        errbuf, len(errbuf),
    )
    if not handle:
        raise ValueError(f"{path}: native Avro decode failed: {errbuf.value.decode(errors='replace')}")
    try:
        n = int(lib.pavro_num_rows(handle))
        out = ColumnarFile(
            num_rows=n,
            numeric={f: _array(lib.pavro_numeric(handle, s), n, np.float64) for f, s in program.slots.items()},
        )
        for b, bag in enumerate(program.bags):
            nnz = int(lib.pavro_bag_nnz(handle, b))
            n_uniq = int(lib.pavro_bag_num_uniq(handle, b))
            out.bags[bag] = {
                "rowptr": _array(lib.pavro_bag_rowptr(handle, b), n + 1, np.int64),
                "ids": _array(lib.pavro_bag_ids(handle, b), nnz, np.int64),
                "values": _array(lib.pavro_bag_values(handle, b), nnz, np.float32),
                "uniq_keys": _strings(lib.pavro_bag_uniq_blob(handle, b),
                                      _array(lib.pavro_bag_uniq_offsets(handle, b), n_uniq + 1, np.int64)),
            }
        for t, tag in enumerate(tags):
            n_uniq = int(lib.pavro_tag_num_uniq(handle, t))
            out.tags[tag] = {
                "ids": _array(lib.pavro_tag_ids(handle, t), n, np.int32),
                "uniq_values": _strings(lib.pavro_tag_uniq_blob(handle, t),
                                        _array(lib.pavro_tag_uniq_offsets(handle, t), n_uniq + 1, np.int64)),
            }
        if program.capture_uid:
            offs = _array(lib.pavro_uid_offsets(handle), n + 1, np.int64)
            kinds = _array(lib.pavro_uid_kinds(handle), n, np.uint8)
            blob = ctypes.string_at(lib.pavro_uid_blob(handle), int(offs[-1])) if n and offs[-1] else b""
            uids: list = [None] * n
            for i in np.flatnonzero(kinds).tolist():
                s = blob[offs[i]:offs[i + 1]].decode("utf-8", "replace")
                uids[i] = int(s) if kinds[i] == 2 else s
            out.uids = uids
        return out
    finally:
        lib.pavro_free(handle)
