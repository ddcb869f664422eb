"""``.vlc`` snapshot persistence — byte-compatible with the reference format.

The reference saves a collection as pretty-printed JSON with a
version/format header, metadata, and the serde-serialized index wrapper
(reference: src/persistence.rs:63-126), written atomically via a ``.tmp``
file + rename (reference: src/persistence.rs:129-146). The index payload is
externally tagged: ``{"Flat": {...}}`` or ``{"HNSW": {...}}``
(reference: src/lib.rs:270-276).

Loading validates ``version == "1.0.0"`` and
``format == "vectorlite-collection"`` (reference: src/persistence.rs:160-174)
and recomputes next_id as max_id + 1 (reference: src/client.rs:295-308).
HNSW graphs load from the graph dump the JAX package writes beside the
reference payload, or are rebuilt by re-inserting every stored vector
(reference: src/index/hnsw.rs:272-360).

Port of ``vectorlite_tpu/persist/vlc.py``: the same bytes on save, Flat
and HNSW, through the native codec (``csrc/vlc_emit.cpp``, bound as
``native.VLC``) or its Python twin.
"""

from __future__ import annotations

import json
import os
import threading
from datetime import datetime, timezone
from pathlib import Path

import numpy as _np

from ..errors import (
    FileNotFound,
    InvalidFormat,
    SerializationError,
    VectorLiteError,
    VersionMismatch,
)
from ..index.flat import FlatIndex, FlatRowsView
from ..index.hnsw import HNSWIndex
from ..native import VLC
from ..store.collection import Collection

FORMAT_VERSION = "1.0.0"
FORMAT_NAME = "vectorlite-collection"


# ----------------------------------------------------- serde_json emitter
#
# The reference writes `serde_json::to_string_pretty` output
# (reference: src/persistence.rs:137): 2-space indent, raw UTF-8 (no
# \uXXXX escaping of non-ASCII), and ryu float formatting. Python's
# json.dump diverges on exactly the edge cases: it escapes non-ASCII by
# default, prints exponents as `1e+308`/`1e-05` (ryu: `1e308`/`1e-5`),
# and switches decimal->scientific at different magnitudes. This emitter
# reproduces serde_json's format so golden-file byte equality holds on
# edge-case corpora too (tests/golden/flat_*.vlc).

_ESCAPES = {
    '"': '\\"', "\\": "\\\\", "\n": "\\n", "\r": "\\r", "\t": "\\t",
    "\b": "\\b", "\f": "\\f",
}


def _emit_str(s: str) -> str:
    out = ['"']
    for ch in s:
        esc = _ESCAPES.get(ch)
        if esc is not None:
            out.append(esc)
        elif ord(ch) < 0x20:
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(ch)  # raw UTF-8, like serde_json
    out.append('"')
    return "".join(out)


def _emit_f64(x: float) -> str:
    """ryu `Buffer::format` (the pretty d2s serde_json uses).

    Decimal notation while the decimal point position kk is in
    (-5, 16]; scientific otherwise, with bare exponents (`1e308`,
    `5e-324`) and no trailing `.0` on scientific mantissas. Python's
    repr supplies the shortest round-trip digits; only the rendering
    differs. Non-finite f64 serializes as null (serde_json behavior).
    """
    if x != x or x in (float("inf"), float("-inf")):
        return "null"
    r = repr(float(x))
    sign = ""
    if r.startswith("-"):
        sign, r = "-", r[1:]
    if "e" in r:
        mant, exp = r.split("e")
        exp = int(exp)
    else:
        mant, exp = r, 0
    if "." in mant:
        int_part, frac = mant.split(".")
    else:
        int_part, frac = mant, ""
    digits = (int_part + frac).lstrip("0") or "0"
    if digits == "0":
        return sign + "0.0"
    # kk: value = 0.D1D2... * 10^kk with D1 != 0
    lead_zeros = len(int_part + frac) - len((int_part + frac).lstrip("0"))
    kk = len(int_part) - lead_zeros + exp
    digits = digits.rstrip("0") or "0"
    if 0 < kk <= 16:
        if len(digits) <= kk:  # integer-valued: pad and add .0
            return sign + digits + "0" * (kk - len(digits)) + ".0"
        return sign + digits[:kk] + "." + digits[kk:]
    if -5 < kk <= 0:
        return sign + "0." + "0" * (-kk) + digits
    # scientific: D1[.rest]eE
    mant_s = digits[0] + ("." + digits[1:] if len(digits) > 1 else "")
    return sign + f"{mant_s}e{kk - 1}"


_EMIT_CHUNK = 262_144

# Per-thread scratch for the native emitter: a Flat snapshot renders one
# short array PER ROW (1M calls at 1M vectors), so per-call
# create_string_buffer + .raw (which copies the whole capacity) would
# dominate. Thread-local because the autosave daemon renders
# concurrently with foreground saves.
_emit_tls = threading.local()


def _emit_scratch(cap: int):
    import ctypes

    buf = getattr(_emit_tls, "buf", None)
    if buf is None or _emit_tls.cap < cap:
        buf = ctypes.create_string_buffer(cap)
        _emit_tls.buf = buf
        _emit_tls.cap = cap
    return buf


def _emit_ndarray(arr, indent: int, out: list) -> bool:
    """Fast path: render a 1-D numeric ndarray through the native
    emitter (csrc/vlc_emit.cpp). Byte-identical to the per-element
    Python path; returns False when unavailable so the caller falls back
    to ``.tolist()``."""
    import ctypes

    if arr.ndim != 1:
        return False
    if _np.issubdtype(arr.dtype, _np.floating):
        kind = "f"
    elif _np.issubdtype(arr.dtype, _np.integer):
        kind = "i"
    else:
        return False
    lib = VLC.library()
    if lib is None:
        return False
    n = arr.shape[0]
    if n == 0:
        out.append("[]")
        return True
    if kind == "f":
        data = _np.ascontiguousarray(arr, dtype=_np.float64)
        fn = "vlc_emit_f64_elems"
        ptr_t = ctypes.c_double
    else:
        data = _np.ascontiguousarray(arr, dtype=_np.int64)
        fn = "vlc_emit_i64_elems"
        ptr_t = ctypes.c_int64
    out.append("[\n")
    elem_indent = indent + 1
    cap = (2 * elem_indent + 27) * min(n, _EMIT_CHUNK) + 16
    buf = _emit_scratch(cap)
    addr = ctypes.addressof(buf)
    for start in range(0, n, _EMIT_CHUNK):
        chunk = data[start : start + _EMIT_CHUNK]
        last = start + _EMIT_CHUNK >= n
        ln = VLC.call(
            fn,
            chunk.ctypes.data_as(ctypes.POINTER(ptr_t)),
            len(chunk),
            elem_indent,
            1 if last else 0,
            buf,
            cap,
        )
        if ln < 0:  # cannot happen with the cap above; guard anyway
            raise SerializationError("native vlc emitter buffer overflow")
        out.append(ctypes.string_at(addr, ln).decode("ascii"))
    out.append("  " * indent + "]")
    return True


_ROW_KEYS = ("id", "values", "text", "metadata")


def _emit_vector_rows(rows, indent: int, out: list) -> bool:
    """Bulk fast path for the Flat ``data`` array: when every element is
    a reference-shaped Vector row (``{"id", "values", "text",
    "metadata"}`` with an ndarray values row — what
    FlatIndex.index_to_json builds), whole chunks of rows render through
    one native call each (csrc/vlc_emit.cpp ``vlc_emit_rows``) instead
    of ~30 Python-level emitter steps per row. Metadata stays fully
    general: non-null values are pre-rendered by the Python emitter and
    spliced verbatim. Byte-identical to the per-row path; returns False,
    having emitted nothing, when the native codec is unavailable or any
    row doesn't fit the shape."""
    import ctypes

    if len(rows) < 64:
        return False
    lib = VLC.library()
    if lib is None:
        return False
    d = None
    for r in rows:
        if type(r) is not dict or tuple(r) != _ROW_KEYS:
            return False
        rid = r["id"]
        if type(rid) is not int or not 0 <= rid < 1 << 64:
            return False
        v = r["values"]
        if not (
            isinstance(v, _np.ndarray)
            and v.ndim == 1
            and _np.issubdtype(v.dtype, _np.floating)
        ):
            return False
        if d is None:
            d = int(v.shape[0])
        elif int(v.shape[0]) != d:
            return False
        if type(r["text"]) is not str:
            return False
    try:
        all_texts = [r["text"].encode("utf-8") for r in rows]
    except UnicodeEncodeError:
        # unpaired surrogates: decline BEFORE emitting anything; the
        # generic path then raises at file-write time as before
        return False
    ei = indent + 1
    pad_v = 2 * ei + 4
    row_fixed = 6 * pad_v + 96 + d * (pad_v + 26)
    i64p = ctypes.POINTER(ctypes.c_int64)
    out.append("[\n")
    n = len(rows)
    chunk_rows = max(64, _EMIT_CHUNK // max(d, 1))
    for start in range(0, n, chunk_rows):
        chunk = rows[start : start + chunk_rows]
        cn = len(chunk)
        last = start + chunk_rows >= n
        ids = _np.fromiter(
            (r["id"] for r in chunk), dtype=_np.uint64, count=cn
        )
        vals = _np.empty((cn, d), dtype=_np.float64)
        for i, r in enumerate(chunk):
            vals[i] = r["values"]
        text_parts = all_texts[start : start + chunk_rows]
        meta_parts = []
        for r in chunk:
            m = r["metadata"]
            if m is None:
                meta_parts.append(b"null")
            else:
                tmp: list = []
                _emit(m, ei + 1, tmp)
                meta_parts.append("".join(tmp).encode("utf-8"))
        text_offs = _np.zeros(cn + 1, dtype=_np.int64)
        _np.cumsum([len(t) for t in text_parts], out=text_offs[1:])
        meta_offs = _np.zeros(cn + 1, dtype=_np.int64)
        _np.cumsum([len(m) for m in meta_parts], out=meta_offs[1:])
        cap = (
            cn * row_fixed
            + 6 * int(text_offs[-1])
            + int(meta_offs[-1])
            + 16
        )
        buf = _emit_scratch(cap)
        ln = VLC.call(
            "vlc_emit_rows",
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cn,
            d,
            b"".join(text_parts),
            text_offs.ctypes.data_as(i64p),
            b"".join(meta_parts),
            meta_offs.ctypes.data_as(i64p),
            ei,
            1 if last else 0,
            buf,
            cap,
        )
        if ln < 0:  # cannot happen with the cap above; guard anyway
            raise SerializationError("native vlc row emitter overflow")
        out.append(
            ctypes.string_at(ctypes.addressof(buf), ln).decode("utf-8")
        )
    out.append("  " * indent + "]")
    return True


def _emit_keyed_arrays(obj: dict, indent: int, out: list) -> bool:
    """Bulk fast path for the HNSW ``vector_values`` map: a dict whose
    values are all 1-D float ndarrays (reference serde shape:
    src/index/hnsw.rs:197-213) renders through
    native ``vlc_emit_keyed_arrays`` in chunks. Same contract as
    ``_emit_vector_rows``: byte-identical or declines untouched."""
    import ctypes

    if len(obj) < 64:
        return False
    lib = VLC.library()
    if lib is None:
        return False
    for k, v in obj.items():
        if type(k) is not str:
            return False
        if not (
            isinstance(v, _np.ndarray)
            and v.ndim == 1
            and _np.issubdtype(v.dtype, _np.floating)
        ):
            return False
    items = list(obj.items())
    try:
        all_keys = [k.encode("utf-8") for k, _ in items]
    except UnicodeEncodeError:
        return False
    ei = indent + 1
    pad_v = 2 * ei + 2
    i64p = ctypes.POINTER(ctypes.c_int64)
    out.append("{\n")
    n = len(items)
    avg_d = max(1, sum(int(v.shape[0]) for _, v in items) // n)
    chunk_rows = max(64, _EMIT_CHUNK // avg_d)
    for start in range(0, n, chunk_rows):
        chunk = items[start : start + chunk_rows]
        cn = len(chunk)
        last = start + chunk_rows >= n
        key_parts = all_keys[start : start + chunk_rows]
        lens = _np.fromiter(
            (int(v.shape[0]) for _, v in chunk), dtype=_np.int64, count=cn
        )
        vals = _np.concatenate(
            [_np.ascontiguousarray(v, dtype=_np.float64) for _, v in chunk]
        ) if int(lens.sum()) else _np.empty(0, dtype=_np.float64)
        key_offs = _np.zeros(cn + 1, dtype=_np.int64)
        _np.cumsum([len(k) for k in key_parts], out=key_offs[1:])
        cap = (
            cn * (2 * pad_v + 32)
            + int(lens.sum()) * (pad_v + 26)
            + 6 * int(key_offs[-1])
            + 16
        )
        buf = _emit_scratch(cap)
        ln = VLC.call(
            "vlc_emit_keyed_arrays",
            b"".join(key_parts),
            key_offs.ctypes.data_as(i64p),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            lens.ctypes.data_as(i64p),
            cn,
            ei,
            1 if last else 0,
            buf,
            cap,
        )
        if ln < 0:
            raise SerializationError("native vlc keyed emitter overflow")
        out.append(
            ctypes.string_at(ctypes.addressof(buf), ln).decode("utf-8")
        )
    out.append("  " * indent + "}")
    return True


def _emit(obj, indent: int, out: list) -> None:
    pad = "  " * indent
    pad_in = "  " * (indent + 1)
    if obj is None:
        out.append("null")
    elif obj is True:
        out.append("true")
    elif obj is False:
        out.append("false")
    elif isinstance(obj, str):
        out.append(_emit_str(obj))
    elif isinstance(obj, int):
        out.append(str(obj))
    elif isinstance(obj, float):
        out.append(_emit_f64(obj))
    elif isinstance(obj, dict):
        if not obj:
            out.append("{}")
            return
        if _emit_keyed_arrays(obj, indent, out):
            return
        out.append("{\n")
        for i, (k, v) in enumerate(obj.items()):
            out.append(pad_in)
            out.append(_emit_str(str(k)))
            out.append(": ")
            _emit(v, indent + 1, out)
            out.append(",\n" if i + 1 < len(obj) else "\n")
        out.append(pad + "}")
    elif isinstance(obj, _np.ndarray):
        if not _emit_ndarray(obj, indent, out):
            _emit(obj.tolist(), indent, out)
    elif isinstance(obj, (list, tuple, FlatRowsView)):
        # FlatRowsView (FlatIndex.index_to_json) renders list-identically
        # but materializes rows lazily, so saves never hold a second
        # copy of the corpus; the native bulk row path consumes it via
        # len/iter/slice like a list
        if not len(obj):
            out.append("[]")
            return
        if not isinstance(obj, tuple) and _emit_vector_rows(
            obj, indent, out
        ):
            return
        out.append("[\n")
        for i, v in enumerate(obj):
            out.append(pad_in)
            _emit(v, indent + 1, out)
            out.append(",\n" if i + 1 < len(obj) else "\n")
        out.append(pad + "]")
    else:
        raise SerializationError(
            f"Unsupported type in .vlc payload: {type(obj)!r}"
        )


def dumps_pretty(payload) -> str:
    """serde_json::to_string_pretty-compatible serialization."""
    out: list = []
    _emit(payload, 0, out)
    return "".join(out)


class _FileSink:
    """List-shaped adapter that streams emitter fragments to a file.

    ``_emit`` only ever calls ``out.append(str)``; buffering fragments
    and flushing at ~8 MB keeps a large snapshot's save memory bounded
    by one buffer instead of the whole rendered document (a 1Mx384
    corpus renders to ~12 GB of JSON — materializing that as a single
    string, as ``dumps_pretty`` would, is an OOM)."""

    def __init__(self, f, limit: int = 8 << 20):
        self._f = f
        self._buf: list = []
        self._n = 0
        self._limit = limit

    def append(self, s: str) -> None:
        self._buf.append(s)
        self._n += len(s)
        if self._n >= self._limit:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            self._f.write("".join(self._buf))
            self._buf.clear()
            self._n = 0


def _now_rfc3339() -> str:
    """chrono-style UTC timestamp, e.g. 2026-08-16T04:45:47.810123Z."""
    dt = datetime.now(timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z"


def collection_to_json(collection: Collection) -> dict:
    """Build the CollectionData payload (reference: src/persistence.rs:98-120)."""
    with collection.index_read() as index:
        index_payload = {index.index_type: index.index_to_json()}
        return {
            "header": {
                "version": FORMAT_VERSION,
                "format": FORMAT_NAME,
                "created_at": _now_rfc3339(),
            },
            "metadata": {
                "name": collection.name,
                "created_at": _now_rfc3339(),
                "vector_count": len(index),
                "dimension": index.dimension,
                "index_type": index.index_type,
            },
            "index": index_payload,
        }


def collection_from_json(obj: dict, **index_kwargs) -> Collection:
    if not isinstance(obj, dict):
        # valid JSON, wrong shape (e.g. a top-level array) — a typed
        # error, not an AttributeError escaping to a 500
        raise InvalidFormat(
            f"Expected a collection object, got {type(obj).__name__}"
        )
    header = obj.get("header")
    header = header if isinstance(header, dict) else {}
    version = header.get("version")
    if version != FORMAT_VERSION:
        raise VersionMismatch(FORMAT_VERSION, str(version))
    fmt = header.get("format")
    if fmt != FORMAT_NAME:
        raise InvalidFormat(
            f"Expected format '{FORMAT_NAME}', got '{fmt}'"
        )
    index_obj = obj.get("index")
    if not isinstance(index_obj, dict):
        raise InvalidFormat("Missing or malformed 'index' payload")
    try:
        index = _index_from_payload(index_obj, **index_kwargs)
    except VectorLiteError:
        raise
    except MemoryError:
        # a valid-but-huge snapshot on a memory-tight host is an
        # environment problem, not file corruption — don't relabel it
        raise
    except Exception as e:
        # Any untyped failure inside index deserialization (wrong field
        # type, short row, junk graph array — found by structured
        # fuzzing) is a malformed snapshot: surface it the way serde
        # does, as a parse error, never a raw TypeError/AttributeError.
        raise SerializationError(
            f"Malformed index payload: {type(e).__name__}: {e}"
        ) from None
    meta = obj.get("metadata")
    name = meta.get("name", "") if isinstance(meta, dict) else ""
    return Collection(name, index)


def _index_from_payload(index_obj: dict, **index_kwargs):
    if "Flat" in index_obj:
        index = FlatIndex.index_from_json(index_obj["Flat"], **index_kwargs)
    elif "HNSW" in index_obj:
        # an HNSW index takes only the device and the mesh of the Flat
        # kwargs
        index = HNSWIndex.index_from_json(
            index_obj["HNSW"],
            **{key: index_kwargs[key] for key in ("device", "mesh") if key in index_kwargs},
        )
    else:
        raise InvalidFormat(f"Unknown index payload: {list(index_obj)}")
    return index


def save_collection_to_file(collection: Collection, path) -> None:
    path = Path(path)
    payload = collection_to_json(collection)
    if path.parent != Path(""):
        os.makedirs(path.parent, exist_ok=True)
    # tmp + atomic rename (reference: src/persistence.rs:137-143); the
    # tmp name is unique per process/thread so concurrent saves to the
    # same (or same-stem) paths never interleave writes
    tmp_path = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    )
    try:
        with open(tmp_path, "w", encoding="utf-8") as f:
            sink = _FileSink(f)
            _emit(payload, 0, sink)
            sink.flush()
        os.replace(tmp_path, path)
    finally:
        if tmp_path.exists():
            tmp_path.unlink(missing_ok=True)


def _native_parse(raw: bytes):
    """Parse a snapshot via csrc/vlc_emit.cpp's vlc_parse_doc: the
    bulk numeric arrays land directly in f64/i64 ndarrays and only a
    small skeleton goes through json.loads. Returns None when the
    native codec is unavailable or declines (buffers, malformed input —
    the caller's json.loads then produces the canonical error)."""
    import ctypes
    import secrets

    lib = VLC.library()
    if lib is None:
        return None
    n = len(raw)
    # np.empty buffers stay virtual until touched, so generous caps are
    # cheap; every extracted value is >= ~4 bytes of text (indent +
    # digits + comma), and each extracted array >= ~16 bytes.
    dcap = n // 4 + 1024
    icap = n // 4 + 1024
    acap = n // 16 + 1024
    skel = _np.empty(n + 16, dtype=_np.uint8)
    dvals = _np.empty(dcap, dtype=_np.float64)
    ivals = _np.empty(icap, dtype=_np.int64)
    lens = _np.empty(acap, dtype=_np.int64)
    counts = _np.zeros(4, dtype=_np.int64)
    nonce = "vlcarr" + secrets.token_hex(12)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = VLC.call(
        "vlc_parse_doc",
        raw,
        n,
        nonce.encode("ascii"),
        skel.ctypes.data_as(ctypes.c_void_p),
        len(skel),
        dvals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dcap,
        ivals.ctypes.data_as(i64p),
        icap,
        lens.ctypes.data_as(i64p),
        acap,
        counts.ctypes.data_as(i64p),
    )
    if rc != 0:
        return None
    skel_len, narr, nd, ni = (int(x) for x in counts)
    try:
        obj = json.loads(skel[:skel_len].tobytes().decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError, RecursionError):
        # RecursionError: pathologically nested input ([[[[... beyond
        # the interpreter stack); decline so the caller's json.loads
        # raises the canonical SerializationError instead of a 500
        return None
    # Slice the value buffers back into per-array ndarrays as VIEWS (a
    # .copy() pass over a 1Mx384 corpus would touch 3 GB more). Views
    # keep dvals/ivals alive via .base; consecutive document arrays
    # stay adjacent, which lets FlatIndex reshape the base buffer into
    # the [N, D] matrix without any stack copy.
    arrays = []
    doff = ioff = 0
    for k in range(narr):
        ln = int(lens[k])
        if ln >= 0:
            arrays.append(dvals[doff : doff + ln])
            doff += ln
        else:
            arrays.append(ivals[ioff : ioff - ln])
            ioff += -ln
    if doff != nd or ioff != ni:
        return None
    prefix = nonce + ":"

    def resolve(node):
        """An extracted array rides as ["<nonce>:<idx>"]; swap it back."""
        if (
            isinstance(node, list)
            and len(node) == 1
            and isinstance(node[0], str)
            and node[0].startswith(prefix)
        ):
            return arrays[int(node[0][len(prefix):])]
        return node

    # Iterative walk: fuzzing found that a pathologically nested doc
    # can clear json.loads (C scanner) yet blow the Python stack in a
    # recursive rewrite.
    obj = resolve(obj)
    stack = [obj]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, list):
            items = enumerate(node)
        else:
            continue
        for k, v in items:
            r = resolve(v)
            if r is not v:
                node[k] = r
            elif isinstance(v, (dict, list)):
                stack.append(v)
    return obj


def load_collection_from_bytes(raw: bytes, **index_kwargs) -> Collection:
    """Parse a .vlc document from memory (the HTTP snapshot-restore
    body path; file loads delegate here). Same native-parser-first,
    json.loads-fallback pipeline and typed-error contract as loading
    from disk."""
    obj = None
    if os.environ.get("VECTORLITE_NO_NATIVE") != "1":
        obj = _native_parse(raw)
    if obj is None:
        try:
            obj = json.loads(raw.decode("utf-8"))
        except (
            json.JSONDecodeError, UnicodeDecodeError, RecursionError,
        ) as e:
            # RecursionError: nesting beyond the interpreter stack —
            # serde_json rejects these with a recursion-limit parse
            # error too (its default limit is 128 levels)
            raise SerializationError(str(e)) from None
    return collection_from_json(obj, **index_kwargs)


def load_collection_from_file(path, **index_kwargs) -> Collection:
    """``index_kwargs`` (``device``, ``device_dtype``: the loading client's
    ``flat_index_kwargs()``) go to the Flat index constructor, so a loaded
    collection serves where and as the loading client does.

    The document is mmap'd for the native parser, so the raw JSON
    stays in the page cache instead of anonymous RAM (a 10M x 384
    snapshot is ~30 GB of text — reading it into a bytes object would
    dwarf the memmap truth mode's savings). ACCESS_COPY provides the
    writable buffer interface ``from_buffer`` requires while leaving
    the file untouched (the parser never writes); the parser copies
    everything it extracts into its own buffers, so the mapping closes
    before the collection is built. Only the json.loads fallback
    (native codec absent or document malformed) still reads the whole
    file into memory."""
    import ctypes

    path = Path(path)
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        raise FileNotFound(str(path)) from None
    with f:
        size = os.fstat(f.fileno()).st_size
        if size and os.environ.get("VECTORLITE_NO_NATIVE") != "1":
            import mmap as _mmap

            mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_COPY)
            obj = None
            try:
                buf = (ctypes.c_char * size).from_buffer(mm)
                try:
                    obj = _native_parse(buf)
                finally:
                    del buf  # release the exported buffer before close
            finally:
                mm.close()
            if obj is not None:
                return collection_from_json(obj, **index_kwargs)
        raw = f.read()
    return load_collection_from_bytes(raw, **index_kwargs)
