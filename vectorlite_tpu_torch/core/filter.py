"""Metadata ``where`` filters for search (TPU-native extension).

The reference stores arbitrary JSON metadata per vector
(reference: src/lib.rs:163-174) but offers no way to constrain a search
by it. This module adds the standard vector-DB ``where`` clause:

    {"genre": "news"}                       field equality (implicit $eq)
    {"year": {"$gte": 2020, "$lt": 2024}}   range operators
    {"tag": {"$in": ["a", "b"]}}            membership
    {"draft": {"$exists": False}}           presence
    {"$or": [{...}, {...}]}                 boolean composition
    {"$and": [...]}, {"$not": {...}}

Semantics:
* A vector matches a field condition only when its metadata is a JSON
  object that CONTAINS the key (except ``$exists: False``, which matches
  missing keys — including vectors with no metadata at all).
* Top-level keys combine with AND (like the implicit struct-field AND of
  every mainstream filter dialect).
* Equality is deep JSON equality; ``bool`` and numbers are distinct
  types (``True != 1``), matching serde_json's Value equality rather
  than Python's bool/int coercion.
* Ordering operators ($gt/$gte/$lt/$lte) apply to numbers and strings;
  a type mismatch (e.g. ``{"$gt": 5}`` against ``"abc"``) makes the
  condition false, never an error — filters describe data they may not
  fully know.

Validation happens once per search in :func:`compile_where`; a malformed
clause raises :class:`~vectorlite_tpu.errors.InvalidFilter` (HTTP 400).
The compiled predicate is a plain Python closure — the host owns
metadata, so filtering produces a [N] validity mask that intersects the
device kernels' ``valid`` input (index/flat.py) or post-filters graph
results (index/hnsw.py).
"""

from __future__ import annotations

import json
import threading
from typing import Any, Callable, Optional

from ..errors import InvalidFilter

Predicate = Callable[[Any], bool]

_COMPARE_OPS = ("$gt", "$gte", "$lt", "$lte")
_KNOWN_OPS = ("$eq", "$ne", "$in", "$nin", "$exists") + _COMPARE_OPS


def _json_eq(a: Any, b: Any) -> bool:
    """Deep JSON equality with serde_json-style strict typing: booleans
    never equal numbers (Python's ``True == 1`` would otherwise leak
    through)."""
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _json_eq(v, b[k]) for k, v in a.items()
        )
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(
            _json_eq(x, y) for x, y in zip(a, b)
        )
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b  # ints match equal floats (Mongo-style numerics)
    return type(a) is type(b) and a == b


def _ordered(value: Any, bound: Any, op: str) -> bool:
    """$gt/$gte/$lt/$lte: numbers compare with numbers, strings with
    strings; anything else is simply not a match."""
    num = lambda x: isinstance(x, (int, float)) and not isinstance(x, bool)
    if num(value) and num(bound):
        pass
    elif isinstance(value, str) and isinstance(bound, str):
        pass
    else:
        return False
    if op == "$gt":
        return value > bound
    if op == "$gte":
        return value >= bound
    if op == "$lt":
        return value < bound
    return value <= bound


def _compile_condition(key: str, cond: Any) -> Predicate:
    """One ``field: condition`` entry -> predicate over a metadata value."""
    if not isinstance(cond, dict) or not any(
        isinstance(k, str) and k.startswith("$") for k in cond
    ):
        # bare value: implicit $eq (a plain dict value with no $-keys is
        # matched structurally, like Mongo/Chroma)
        expected = cond
        return lambda meta: (
            isinstance(meta, dict)
            and key in meta
            and _json_eq(meta[key], expected)
        )

    checks: list[Predicate] = []
    for op, arg in cond.items():
        if op not in _KNOWN_OPS:
            raise InvalidFilter(
                f"unknown operator '{op}' for field '{key}' "
                f"(supported: {', '.join(_KNOWN_OPS)})"
            )
        if op == "$exists":
            if not isinstance(arg, bool):
                raise InvalidFilter(
                    f"$exists for field '{key}' takes true/false"
                )
            if arg:
                checks.append(
                    lambda meta: isinstance(meta, dict) and key in meta
                )
            else:
                checks.append(
                    lambda meta: not isinstance(meta, dict) or key not in meta
                )
        elif op in ("$in", "$nin"):
            if not isinstance(arg, list):
                raise InvalidFilter(
                    f"{op} for field '{key}' takes an array"
                )
            values = list(arg)
            if op == "$in":
                checks.append(
                    lambda meta, values=values: isinstance(meta, dict)
                    and key in meta
                    and any(_json_eq(meta[key], v) for v in values)
                )
            else:
                checks.append(
                    lambda meta, values=values: isinstance(meta, dict)
                    and key in meta
                    and not any(_json_eq(meta[key], v) for v in values)
                )
        elif op == "$eq":
            checks.append(
                lambda meta, arg=arg: isinstance(meta, dict)
                and key in meta
                and _json_eq(meta[key], arg)
            )
        elif op == "$ne":
            checks.append(
                lambda meta, arg=arg: isinstance(meta, dict)
                and key in meta
                and not _json_eq(meta[key], arg)
            )
        else:  # ordering
            checks.append(
                lambda meta, arg=arg, op=op: isinstance(meta, dict)
                and key in meta
                and _ordered(meta[key], arg, op)
            )
    return lambda meta: all(c(meta) for c in checks)


def compile_where(where: Any) -> Predicate:
    """Validate + compile a ``where`` clause into ``meta -> bool``.

    Raises :class:`InvalidFilter` on malformed input. ``{}`` compiles to
    match-everything (callers usually treat None/{} as "no filter"
    before getting here).
    """
    if not isinstance(where, dict):
        raise InvalidFilter("where clause must be a JSON object")
    preds: list[Predicate] = []
    for key, cond in where.items():
        if not isinstance(key, str):
            raise InvalidFilter("field names must be strings")
        if key in ("$and", "$or"):
            if not isinstance(cond, list) or not cond:
                raise InvalidFilter(f"{key} takes a non-empty array")
            subs = [compile_where(c) for c in cond]
            if key == "$and":
                preds.append(
                    lambda meta, subs=subs: all(s(meta) for s in subs)
                )
            else:
                preds.append(
                    lambda meta, subs=subs: any(s(meta) for s in subs)
                )
        elif key == "$not":
            sub = compile_where(cond)
            preds.append(lambda meta, sub=sub: not sub(meta))
        elif key.startswith("$"):
            raise InvalidFilter(
                f"unknown logical operator '{key}' "
                "(supported: $and, $or, $not)"
            )
        else:
            preds.append(_compile_condition(key, cond))
    if not preds:
        return lambda meta: True
    if len(preds) == 1:
        return preds[0]
    return lambda meta: all(p(meta) for p in preds)


def where_cache_key(where: dict) -> Optional[str]:
    """Canonical cache key for a clause, or None when unhashable (the
    caller then just skips mask caching)."""
    try:
        return json.dumps(where, sort_keys=True, separators=(",", ":"))
    except (TypeError, ValueError):
        return None


class FilterCache:
    """Bounded, lock-guarded store for per-clause filter artifacts.

    Shared by FlatIndex (slot masks) and HNSWIndex (node lists): keys
    are canonical clause JSON, entries are opaque lists the owning index
    interprets (epoch/watermark/payload). The cache only owns keying,
    bounding (drop-oldest at ``max_entries``), and thread safety; `None`
    keys (non-serializable clauses) are never stored."""

    def __init__(self, max_entries: int = 32):
        self._lock = threading.Lock()
        self._entries: dict = {}
        self._max = max_entries

    def get(self, key: Optional[str]):
        if key is None:
            return None
        with self._lock:
            return self._entries.get(key)

    def put(self, key: Optional[str], entry):
        if key is None:
            return entry
        with self._lock:
            if (
                key not in self._entries
                and len(self._entries) >= self._max
            ):
                try:
                    self._entries.pop(next(iter(self._entries)))
                except (KeyError, StopIteration):
                    pass
            self._entries[key] = entry
        return entry


def canonicalize(where: dict):
    """Return (clause, cache_key) with the clause round-tripped through
    its canonical JSON when serializable.

    Compiling the ROUND-TRIPPED form keeps cache-key identity and match
    semantics in lockstep: json.dumps turns tuples into arrays and int
    dict keys into strings, so ``{"a": (1, 2)}`` and ``{"a": [1, 2]}``
    share a key — they must therefore share a predicate too, or a cached
    mask would answer for a clause with different semantics. A
    non-serializable clause compiles raw and returns key None (callers
    skip caching and coalescing for it)."""
    key = where_cache_key(where)
    if key is None:
        return where, None
    return json.loads(key), key
