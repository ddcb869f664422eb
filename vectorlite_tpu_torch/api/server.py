"""HTTP API — the reference's routes and their contract, on the standard
library.

Port of ``vectorlite_tpu/api/server.py``: the same routes, request and
response shapes, default ``k=10``, case-insensitive index-type/metric
parsing, permissive CORS, the ``{"message": ...}`` error body with the
reference status codes, opt-in API-key auth, the body cap, ``/stats``,
``/metrics``, ``/debug/trace`` and ``/openapi.yaml``. The transport is
``_http`` (``http.server``, one thread a connection) in place of
aiohttp, so the server runs where only the standard library, torch and
numpy are installed.

Locking mirrors the reference: vector ops take the client-map **read**
lock (each collection has its own lock), while create/delete/load take
the **write** lock (reference: src/server.rs:212, 235, 336). Each
connection's thread runs its handler directly under that lock; there is
no event loop to keep free.

``index_type: "hnsw"`` creates an HNSW collection (an explicit ``metric``
is required); a search's ``ef`` reaches its beam.
"""

from __future__ import annotations

import json
import logging
import math
import os
import signal
import time
from pathlib import Path
from typing import Optional
from urllib.parse import quote

from ..core.metrics import SimilarityMetric
from ..errors import CollectionAlreadyExists, CollectionNotFound, VectorLiteError, VectorNotFound
from ..observability import LatencyRecorder, capture_device_trace
from ..store.client import IndexType, VectorLiteClient
from ..store.collection import Collection
from ..utils import RWLock, env_number
from ._http import (
    App,
    BodyTooLarge,
    HTTPError,
    Request,
    Response,
    Server,
    StreamResponse,
    json_response,
    text_response,
)

logger = logging.getLogger("vectorlite_tpu_torch.server")

_CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "*",
    "Access-Control-Allow-Headers": "*",
}


def _bad(message: str) -> HTTPError:
    return HTTPError.message(400, message)


def _client(request: Request) -> VectorLiteClient:
    return request.app.state["client"]


def _lock(request: Request) -> RWLock:
    return request.app.state["lock"]


def _middleware(api_key: Optional[str]):
    """The JAX app's middleware stack, outermost first: OPTIONS gets 204
    and the CORS headers before anything else; then auth (when a key is
    set; ``GET /health`` stays open); then the route, or aiohttp's 404 /
    405. A ``VectorLiteError`` becomes its ``{"message": ...}`` and
    status, anything else a 500; every answer gets the CORS headers and
    a ``/stats`` sample keyed ``"<METHOD> <route template>"``."""
    import hmac

    key_bytes = api_key.encode("utf-8") if api_key else None

    def check_key(request: Request) -> None:
        supplied = ""
        header = request.headers.get("Authorization", "")
        # auth-scheme is case-insensitive (RFC 7235 §2.1)
        if header[:7].lower() == "bearer ":
            supplied = header[7:]
        elif "X-API-Key" in request.headers:
            supplied = request.headers["X-API-Key"]
        if not hmac.compare_digest(supplied.encode("utf-8"), key_bytes):
            raise HTTPError(401, '{"message": "Invalid or missing API key"}')

    def middleware(request: Request):
        # permissive CORS incl. preflight (reference: src/server.rs:374)
        if request.method == "OPTIONS":
            return Response(status=204, headers=_CORS_HEADERS)
        start = time.perf_counter()
        try:
            if key_bytes is not None and request.path != "/health":
                check_key(request)
            if request.route is None:
                raise request.handler  # the router's 404 or 405
            response = request.handler(request)
        except VectorLiteError as e:
            # reference: src/server.rs:168-179
            response = json_response({"message": e.message}, status=e.status_code)
        except HTTPError as e:
            response = e.response
        except (ConnectionError, TimeoutError):
            raise  # the client went away: the transport closes the connection
        except Exception as e:  # noqa: BLE001 - every error is an answer
            logger.exception("unhandled error")
            response = json_response({"message": f"Internal server error: {e}"}, status=500)
        request.app.state["stats"].record(
            f"{request.method} {request.route or request.path}",
            time.perf_counter() - start,
            ok=response.status < 500,
        )
        if not request.streamed:
            response.headers.update(_CORS_HEADERS)
        return response

    return middleware


def _json_body(request: Request) -> dict:
    try:
        body = request.json()
    except BodyTooLarge:
        # keep the 413 (don't mislabel an over-size body as bad JSON),
        # but give it the canonical {"message": ...} shape
        raise HTTPError.message(
            413, "Request body too large (raise VECTORLITE_MAX_BODY_MB or shrink the batch)"
        ) from None
    except (ConnectionError, TimeoutError):
        raise
    except Exception:  # noqa: BLE001 - any undecodable body is a 400
        raise _bad("Invalid JSON body") from None
    if not isinstance(body, dict):
        raise _bad("Expected JSON object")
    return body


def _require_field(body: dict, name: str):
    if name not in body:
        raise _bad(f"Missing required field: {name}")
    return body[name]


def _require_str(body: dict, name: str) -> str:
    """Required string field. The reference's DTOs type these as serde
    String (src/server.rs:71-100), so a number/null/object here is a
    deserialization reject, not something to coerce via str()."""
    value = _require_field(body, name)
    if not isinstance(value, str):
        raise _bad(f"Field {name} must be a string")
    return value


def _optional_str(body: dict, name: str, default=None):
    """Optional string field: absent -> default, any other non-string
    (null excepted) -> 400."""
    value = body.get(name, default)
    if value is not None and not isinstance(value, str):
        raise _bad(f"Field {name} must be a string")
    return value


# ------------------------------------------------------------------ handlers


def health_check(request: Request) -> Response:
    # reference: src/server.rs:182-187
    return json_response({"status": "healthy", "service": "vectorlite"})


def list_collections(request: Request) -> Response:
    with _lock(request).read():
        collections = _client(request).list_collections()
    return json_response({"collections": collections})


def create_collection(request: Request) -> Response:
    body = _json_body(request)
    name = _require_str(body, "name")
    index_type = IndexType.parse(_require_str(body, "index_type"))
    # serde String + #[serde(default)]: absent -> "", present non-string
    # (incl. null) -> type reject; empty string means "not specified"
    # (reference: src/server.rs:75-77, 206-210)
    metric_str = body.get("metric", "")
    if not isinstance(metric_str, str):
        raise _bad("Field metric must be a string")
    metric = SimilarityMetric.parse(metric_str) if metric_str else None
    with _lock(request).write():
        _client(request).create_collection(name, index_type, metric)
    logger.info("Created collection: %s", name)
    return json_response({"name": name})


def get_collection_info(request: Request) -> Response:
    name = request.match_info["name"]
    with _lock(request).read():
        info = _client(request).get_collection_info(name)
    return json_response({"info": info.to_json()})


def delete_collection(request: Request) -> Response:
    name = request.match_info["name"]
    with _lock(request).write():
        _client(request).delete_collection(name)
    logger.info("Deleted collection: %s", name)
    return json_response({"name": name})


def add_text(request: Request) -> Response:
    name = request.match_info["name"]
    body = _json_body(request)
    text = _require_str(body, "text")
    metadata = body.get("metadata")
    with _lock(request).read():
        vid = _client(request).add_text_to_collection(name, text, metadata)
    logger.info("Added text to collection '%s' with ID: %s", name, vid)
    return json_response({"id": vid})


#: k bounds from the API contract (reference: docs/openapi.yaml:624-630)
K_MIN, K_MAX = 1, 1000


def _parse_k(body: dict) -> int:
    """Default k=10 (reference: src/server.rs:263); non-integers and values
    outside the contract's 1..1000 are a 400."""
    k = body.get("k", None)
    if k is None:
        return 10
    if not isinstance(k, int) or isinstance(k, bool):
        raise _bad("Field k must be an integer")
    if not K_MIN <= k <= K_MAX:
        raise _bad(f"Field k must be between {K_MIN} and {K_MAX}")
    return k


def _finite_number(value, message: str) -> float:
    """A JSON number that converts to a finite float, else a 400."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise _bad(message)
    try:
        f = float(value)  # a ~10^400 JSON int overflows float conversion
    except OverflowError:
        raise _bad(message) from None
    if not math.isfinite(f):
        raise _bad(message)
    return f


def _parse_min_score(body: dict):
    """Optional similarity floor (extension): absent/null means no
    floor; results with score < min_score are dropped after the top-k
    cut, so fewer than k hits can come back."""
    v = body.get("min_score", None)
    if v is None:
        return None
    return _finite_number(v, "Field min_score must be a finite number")


def _parse_ef(body: dict):
    """Optional per-request HNSW beam width (extension): absent/null
    means the collection's configured ef_search. Exact Flat search
    accepts and ignores it."""
    ef = body.get("ef", None)
    if ef is None:
        return None
    if not isinstance(ef, int) or isinstance(ef, bool) or not 0 <= ef <= 65536:
        raise _bad("Field ef must be an integer between 0 and 65536")
    return ef


def _parse_search_metric(body: dict):
    """Search-side metric: absent/null means auto-detect, but a PRESENT
    string, "" included, must parse or 400 (the reference's
    SearchTextRequest.similarity_metric is Option<String>,
    src/server.rs:264-266)."""
    metric_raw = _optional_str(body, "similarity_metric")
    if metric_raw is None:
        return None
    return SimilarityMetric.parse(metric_raw)


def _parse_where(body: dict):
    """Optional metadata filter: absent/null means unfiltered; anything
    present must be a JSON object (its operators are validated by
    core/filter.py, raising InvalidFilter -> 400)."""
    where = body.get("where", None)
    if where is None:
        return None
    if not isinstance(where, dict):
        raise _bad("Invalid filter: where clause must be a JSON object")
    return where


def _search_options(body: dict) -> dict:
    return dict(k=_parse_k(body), metric=_parse_search_metric(body), where=_parse_where(body),
                ef=_parse_ef(body), min_score=_parse_min_score(body))


def _results(rows) -> list:
    return [r.to_json() for r in rows]


def search_text(request: Request) -> Response:
    name = request.match_info["name"]
    body = _json_body(request)
    query = _require_str(body, "query")
    o = _search_options(body)
    with _lock(request).read():
        results = _client(request).search_text_in_collection(
            name, query, o["k"], o["metric"], where=o["where"], ef=o["ef"],
            min_score=o["min_score"],
        )
    logger.info("Search completed for collection '%s' with %d results", name, len(results))
    return json_response({"results": _results(results)})


def _parse_alpha(body: dict) -> float:
    """Hybrid fusion weight: the dense leg's share, in [0, 1]."""
    message = "Field alpha must be a number in [0, 1]"
    v = body.get("alpha", 0.5)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise _bad(message)
    try:
        f = float(v)
    except OverflowError:
        raise _bad(message) from None
    if not 0.0 <= f <= 1.0:
        raise _bad(message)
    return f


def _parse_pool(body: dict):
    """Per-leg candidate pool for hybrid fusion (optional)."""
    v = body.get("pool", None)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int) or not 1 <= v <= 1000:
        raise _bad("Field pool must be an integer in [1, 1000]")
    return int(v)


def search_hybrid(request: Request) -> Response:
    """Hybrid dense + BM25 search with reciprocal-rank fusion (extension).
    Body: {"query", "k"?, "alpha"? (dense weight, default 0.5), "pool"?,
    "similarity_metric"?, "where"?, "ef"?, "min_score"?}. Scores in the
    response are fused RRF scores, not similarities."""
    name = request.match_info["name"]
    body = _json_body(request)
    query = _require_str(body, "query")
    o = _search_options(body)
    alpha = _parse_alpha(body)
    pool = _parse_pool(body)
    with _lock(request).read():
        results = _client(request).search_hybrid_in_collection(
            name, query, o["k"], o["metric"], where=o["where"], ef=o["ef"],
            min_score=o["min_score"], alpha=alpha, pool=pool,
        )
    logger.info("Hybrid search completed for collection '%s' with %d results", name,
                len(results))
    return json_response({"results": _results(results)})


def add_texts(request: Request) -> Response:
    """Batched insert (extension): one embedder forward for the whole
    batch. Body: {"texts": [...], "metadatas": [...]?}."""
    name = request.match_info["name"]
    body = _json_body(request)
    texts = _require_field(body, "texts")
    if not isinstance(texts, list) or not all(isinstance(t, str) for t in texts):
        raise _bad("Field texts must be a list of strings")
    metadatas = body.get("metadatas")
    try:
        with _lock(request).read():
            ids = _client(request).add_texts_to_collection(name, texts, metadatas)
    except ValueError as e:
        raise _bad(str(e)) from None
    logger.info("Added %d texts to collection '%s'", len(ids), name)
    return json_response({"ids": ids})


def search_texts(request: Request) -> Response:
    """Batched search (extension): the whole query batch rides one
    device program. Body: {"queries": [...], "k"?, "similarity_metric"?}."""
    name = request.match_info["name"]
    body = _json_body(request)
    queries = _require_field(body, "queries")
    if not isinstance(queries, list) or not all(isinstance(q, str) for q in queries):
        raise _bad("Field queries must be a list of strings")
    o = _search_options(body)
    with _lock(request).read():
        batches = _client(request).search_texts_in_collection(
            name, queries, o["k"], o["metric"], where=o["where"], ef=o["ef"],
            min_score=o["min_score"],
        )
    return json_response({"results": [_results(batch) for batch in batches]})


def _parse_number_array(value, field: str) -> list[float]:
    """A JSON array of finite numbers (serde Vec<f64> semantics: bools,
    strings, nulls, and NaN/Infinity are all 400s, not coercions). The
    element checks run as C-level maps: a batch of 256 x 384 is ~98K
    elements (the JSON decoder gives exactly int, float, bool, str, list,
    dict or None, so the type set is the JAX app's isinstance test)."""
    if not isinstance(value, list) or not value or not set(map(type, value)) <= {int, float}:
        raise _bad(f"Field {field} must be a non-empty array of numbers")
    if not all(map(math.isfinite, value)):
        raise _bad(f"Field {field} must contain only finite numbers")
    return list(map(float, value))


def _reject_ragged(rows: list, field: str) -> None:
    if rows and any(len(r) != len(rows[0]) for r in rows):
        raise _bad(f"All {field} must share one dimension")


def add_vectors(request: Request) -> Response:
    """Extension route: bulk insert of PRECOMPUTED embeddings — no
    embedder in the loop. Body: {"vectors": [{"values": [...],
    "text"?, "metadata"?, "id"?}, ...]}. Explicit ids are all-or-none per
    request and must be fresh u64s (409 on reuse). Returns {"ids": [...]}."""
    name = request.match_info["name"]
    body = _json_body(request)
    vectors = _require_field(body, "vectors")
    if not isinstance(vectors, list) or not all(isinstance(v, dict) for v in vectors):
        raise _bad("Field vectors must be a list of objects")
    rows: list[list[float]] = []
    texts: list[str] = []
    metadatas: list = []
    ids: list = []
    for i, v in enumerate(vectors):
        if "values" not in v:
            raise _bad(f"Missing required field: vectors[{i}].values")
        rows.append(_parse_number_array(v["values"], f"vectors[{i}].values"))
        text = v.get("text", "")
        if text is None:
            text = ""
        if not isinstance(text, str):
            raise _bad(f"Field vectors[{i}].text must be a string")
        texts.append(text)
        metadatas.append(v.get("metadata"))
        vid = v.get("id")
        if vid is not None and (
            isinstance(vid, bool) or not isinstance(vid, int) or vid < 0 or vid >= 1 << 64
        ):
            raise _bad(f"Field vectors[{i}].id must be a u64 integer")
        ids.append(vid)
    _reject_ragged(rows, "vectors[i].values")
    if any(i is None for i in ids):
        if any(i is not None for i in ids):
            raise _bad("Either every vector must carry an id or none")
        ids = None
    try:
        with _lock(request).read():
            out_ids = _client(request).add_vectors_to_collection(
                name, rows, texts, metadatas, ids)
    except ValueError as e:
        raise _bad(str(e)) from None
    logger.info("Added %d precomputed vectors to collection '%s'", len(out_ids), name)
    return json_response({"ids": out_ids})


def search_vector(request: Request) -> Response:
    """Extension route: search by one raw query vector (the reference
    only exposes this at the library level, src/lib.rs:293-298).
    Body: {"vector": [...], "k"?, "similarity_metric"?, "where"?}."""
    name = request.match_info["name"]
    body = _json_body(request)
    query = _parse_number_array(_require_field(body, "vector"), "vector")
    o = _search_options(body)
    try:
        with _lock(request).read():
            results = _client(request).search_vector_in_collection(
                name, query, o["k"], o["metric"], where=o["where"], ef=o["ef"],
                min_score=o["min_score"],
            )
    except ValueError as e:
        raise _bad(str(e)) from None
    return json_response({"results": _results(results)})


def search_vectors(request: Request) -> Response:
    """Extension route: batched raw-vector search — the whole query batch
    rides one device program. Body: {"vectors": [[...], ...], "k"?,
    "similarity_metric"?, "where"?}."""
    name = request.match_info["name"]
    body = _json_body(request)
    raw = _require_field(body, "vectors")
    if not isinstance(raw, list) or not raw:
        raise _bad("Field vectors must be a non-empty list of arrays")
    queries = [_parse_number_array(q, f"vectors[{i}]") for i, q in enumerate(raw)]
    _reject_ragged(queries, "vectors")
    o = _search_options(body)
    try:
        with _lock(request).read():
            batches = _client(request).search_vectors_in_collection(
                name, queries, o["k"], o["metric"], where=o["where"], ef=o["ef"],
                min_score=o["min_score"],
            )
    except ValueError as e:
        raise _bad(str(e)) from None
    return json_response({"results": [_results(batch) for batch in batches]})


def _parse_vector_id(request: Request) -> int:
    """Vector ids are u64 in the reference (Path<u64>, src/server.rs), so
    a negative or > 2^64-1 path segment is a parse reject (400), not a
    well-formed id that happens to be absent (404)."""
    raw = request.match_info["id"]
    # Python int() accepts "1_0", unicode digits and " 5 "; Rust's u64
    # FromStr accepts only [+]ASCII-digits, so gate on that first
    digits = raw[1:] if raw.startswith("+") else raw
    try:
        if not (digits.isascii() and digits.isdigit()):
            raise ValueError
        vid = int(digits)  # past 4300 digits CPython raises ValueError
    except ValueError:
        raise _bad("Invalid vector id") from None
    if vid >= 1 << 64:
        raise _bad("Invalid vector id")
    return vid


def _parse_where_param(request: Request) -> Optional[dict]:
    """Decode the ``where`` query param (URL-encoded JSON clause) or None
    when absent; 400 on anything that is not a JSON object."""
    where_raw = request.query.get("where")
    if where_raw is None:
        return None
    try:
        where = json.loads(where_raw)
    except json.JSONDecodeError:
        where = "<invalid>"
    if not isinstance(where, dict):
        raise _bad("Invalid filter: where clause must be a JSON object")
    return where


def _parse_ids_param(ids_raw: str) -> list[int]:
    """ids=1,2,3: at most 1000 strict u64s (no sign, no whitespace, no
    1_0 separators; length-capped so int() never meets CPython's
    4300-digit limit)."""
    tokens = ids_raw.split(",")
    bad = _bad("Query param ids must be a comma-separated list of at most 1000 u64 ids")
    if not ids_raw or len(tokens) > 1000:
        raise bad
    ids = []
    for tok in tokens:
        if not tok.isascii() or not tok.isdigit() or len(tok) > 20 or int(tok) >= 1 << 64:
            raise bad
        ids.append(int(tok))
    return ids


def list_vectors(request: Request) -> Response:
    """Extension route: paged vector listing, optionally where-filtered.
    Query params: offset (default 0), limit (default 100, max 1000),
    include_values (0/1), where (URL-encoded JSON clause); ids=1,2,3 is a
    bulk get (found vectors in the requested order, missing ids skipped;
    combines with where= and include_values=, ignores offset/limit)."""
    name = request.match_info["name"]

    def int_param(key: str, default: int, lo: int, hi: int) -> int:
        raw = request.query.get(key)
        if raw is None:
            return default
        try:
            val = int(raw)
        except ValueError:
            val = -1
        if not lo <= val <= hi:
            raise _bad(f"Query param {key} must be an integer in [{lo}, {hi}]")
        return val

    offset = int_param("offset", 0, 0, (1 << 63) - 1)
    limit = int_param("limit", 100, 0, 1000)
    include_values = request.query.get("include_values", "0") in ("1", "true")
    where = _parse_where_param(request)
    client = _client(request)
    ids_raw = request.query.get("ids")
    if ids_raw is not None:
        ids = _parse_ids_param(ids_raw)
        with _lock(request).read():
            vectors = client.get_vectors_from_collection(name, ids, where, include_values)
        return json_response({"vectors": [v.to_json() for v in vectors], "total": len(vectors)})
    with _lock(request).read():
        vectors, total = client.list_vectors_in_collection(
            name, offset, limit, where, include_values)
    return json_response({
        "vectors": [v.to_json() for v in vectors],
        "total": total,
        "offset": offset,
        "limit": limit,
    })


def get_vector(request: Request) -> Response:
    name = request.match_info["name"]
    vid = _parse_vector_id(request)
    with _lock(request).read():
        vector = _client(request).get_vector_from_collection(name, vid)
    if vector is None:
        raise VectorNotFound(vid)
    return json_response({"vector": vector.to_json()})


def delete_vector(request: Request) -> Response:
    name = request.match_info["name"]
    vid = _parse_vector_id(request)
    with _lock(request).read():
        _client(request).delete_from_collection(name, vid)
    logger.info("Deleted vector %s from collection '%s'", vid, name)
    return json_response({})


def delete_vectors_where(request: Request) -> Response:
    """Extension route: bulk delete by metadata filter. ``where`` is
    REQUIRED so a bare DELETE on the listing URL can never wipe a
    collection by accident; ``where={}`` is an explicit clear-all.
    Returns {"deleted": n}."""
    name = request.match_info["name"]
    where = _parse_where_param(request)
    if where is None:
        raise _bad("Query param where is required (use where={} to delete every vector)")
    with _lock(request).read():
        deleted = _client(request).delete_where_in_collection(name, where)
    logger.info("Deleted %d vectors from collection '%s' by filter", deleted, name)
    return json_response({"deleted": deleted})


def update_vector_metadata(request: Request) -> Response:
    """Extension route: replace one vector's metadata in place. Body must
    carry the "metadata" key; null clears. The embedding is untouched."""
    name = request.match_info["name"]
    vid = _parse_vector_id(request)
    body = _json_body(request)
    if "metadata" not in body:
        raise _bad("Field metadata is required (null clears)")
    with _lock(request).read():
        _client(request).update_metadata_in_collection(name, vid, body["metadata"])
    logger.info("Updated metadata for vector %s in collection '%s'", vid, name)
    return json_response({"id": vid})


def replace_vector(request: Request) -> Response:
    """Extension route: PUT full replacement under the same id — the
    body's "text" is re-embedded and text/values/metadata are all swapped
    (metadata omitted = cleared). 404 when the id is not live."""
    name = request.match_info["name"]
    vid = _parse_vector_id(request)
    body = _json_body(request)
    text = _require_str(body, "text")
    metadata = body.get("metadata")
    with _lock(request).read():
        _client(request).update_text_in_collection(name, vid, text, metadata)
    logger.info("Replaced vector %s in collection '%s'", vid, name)
    return json_response({"id": vid})


def _collection(request: Request, name: str) -> Collection:
    collection = _client(request).get_collection(name)
    if collection is None:
        raise CollectionNotFound(name)
    return collection


def compact_collection(request: Request) -> Response:
    """Extension route: reclaim tombstoned slots."""
    name = request.match_info["name"]
    with _lock(request).read():
        reclaimed = _collection(request, name).compact()
    logger.info("Compacted collection '%s': reclaimed %d", name, reclaimed)
    return json_response({"reclaimed": int(reclaimed)})


def save_collection(request: Request) -> Response:
    name = request.match_info["name"]
    body = _json_body(request)
    file_path = _require_str(body, "file_path")
    with _lock(request).read():
        _collection(request, name).save_to_file(Path(file_path))
    logger.info("Saved collection '%s' to file: %s", name, file_path)
    return json_response({"file_path": file_path})


def _register_loaded(request: Request, name: str, loaded: Collection) -> int:
    """Register ``loaded`` under ``name`` (409 if taken); its row count.
    The collection is re-wrapped so next_id is recomputed (reference:
    src/server.rs:344-353)."""
    client = _client(request)
    with _lock(request).write():
        if client.has_collection(name):
            raise CollectionAlreadyExists(name)
        with loaded.index_read() as index:
            client.add_collection(Collection(name, index))
            return len(index)


def load_collection(request: Request) -> Response:
    body = _json_body(request)
    file_path = _require_str(body, "file_path")
    requested_name = _optional_str(body, "collection_name")
    loaded = Collection.load_from_file(Path(file_path), **_client(request).flat_index_kwargs())
    name = requested_name or loaded.name
    _register_loaded(request, name, loaded)
    logger.info("Loaded collection '%s' from file: %s", name, file_path)
    return json_response({"collection_name": name})


class _Utf8Writer:
    """write(str) target for persist.vlc._FileSink (which batches the
    emitter's fragments into ~1 MB writes): each batch becomes one chunk
    of the response."""

    def __init__(self, writer):
        self._writer = writer

    def write(self, s: str) -> None:
        self._writer.write(s.encode("utf-8"))


def download_snapshot(request: Request) -> StreamResponse:
    """GET /collections/{name}/snapshot (extension): stream the
    collection's .vlc document — byte-identical to what POST /save
    writes. The payload is built under the read lock (index_to_json
    snapshots the small tables and lazily references the truth matrix),
    then rendered straight into the chunked response in ~1 MB writes: a
    1M x 384 corpus renders to ~12 GB of JSON, and neither the corpus
    copy nor the rendered document is ever resident. A client that goes
    away stops the renderer at its next write."""
    from ..persist import vlc as _vlc

    name = request.match_info["name"]
    with _lock(request).read():
        payload = _vlc.collection_to_json(_collection(request, name))
    writer = request.stream({
        "Content-Type": "application/json",
        "Content-Disposition": f"attachment; filename*=UTF-8''{quote(name, safe='')}.vlc",
        **_CORS_HEADERS,
    })
    try:
        sink = _vlc._FileSink(_Utf8Writer(writer), limit=1 << 20)
        _vlc._emit(payload, 0, sink)
        sink.flush()
    except (ConnectionError, TimeoutError):
        raise
    except Exception as e:  # noqa: BLE001 - the headers are gone; end the stream
        logger.error("snapshot render failed: %s", e)
    writer.close()
    logger.info("Streamed snapshot of collection '%s'", name)
    return StreamResponse()


def restore_snapshot(request: Request) -> Response:
    """POST /collections/{name}/snapshot (extension): the body is a raw
    .vlc document (e.g. a previous snapshot download); creates collection
    ``{name}`` from it, with /collections/load's conflict and validation
    semantics. The URL name wins over the document's own.

    The body is streamed to a temp file, so the request-body cap (sized
    for JSON DTOs) does not apply; uploads are bounded instead by
    VECTORLITE_MAX_SNAPSHOT_MB (default 65536 = 64 GiB, 0 = unlimited)."""
    import tempfile

    from ..persist.vlc import load_collection_from_file

    name = request.match_info["name"]
    cap_mb = env_number("VECTORLITE_MAX_SNAPSHOT_MB", 65536, float)
    limit = int(cap_mb * 1024**2) if cap_mb > 0 else None
    fd, tmp = tempfile.mkstemp(suffix=".vlc.upload")
    try:
        total = 0
        with os.fdopen(fd, "wb") as f:
            for chunk in request.iter_body():
                total += len(chunk)
                if limit is not None and total > limit:
                    raise HTTPError.message(
                        413, f"Snapshot exceeds VECTORLITE_MAX_SNAPSHOT_MB ({cap_mb:g} MiB)")
                f.write(chunk)
        loaded = load_collection_from_file(tmp, **_client(request).flat_index_kwargs())
        count = _register_loaded(request, name, loaded)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    logger.info("Restored collection '%s' from snapshot (%d vectors)", name, count)
    return json_response({"collection_name": name, "vector_count": int(count)})


# --------------------------------------------------------------------- app


def get_stats(request: Request) -> Response:
    """Per-route latency percentiles, the coalescer's and the filter
    cache's counters, and the autosave and WAL blocks when present."""
    from ..observability import coalesce_stats, filter_stats

    state = request.app.state
    body = state["stats"].snapshot()
    body["coalesce"] = coalesce_stats.snapshot()
    body["filters"] = filter_stats.snapshot()
    if state.get("autosave") is not None:
        body["autosave"] = state["autosave"].stats()
    if state.get("wal") is not None:
        body["wal"] = state["wal"].stats()
    return json_response(body)


def get_metrics(request: Request) -> Response:
    """Prometheus text-format scrape endpoint: the counters of /stats
    plus live per-collection gauges."""
    from ..observability import coalesce_stats, filter_stats, render_prometheus

    client = _client(request)
    with _lock(request).read():
        collections = {
            name: client.get_collection_info(name).count for name in client.list_collections()
        }
    state = request.app.state
    autosave, wal = state.get("autosave"), state.get("wal")
    body = render_prometheus(
        state["stats"].snapshot(),
        coalesce_stats.snapshot(),
        filter_stats.snapshot(),
        collections,
        autosave.stats() if autosave is not None else None,
        wal.stats() if wal is not None else None,
    )
    return text_response(body, "text/plain")


def debug_trace(request: Request) -> Response:
    """Capture a torch.profiler trace of the process (extension; gated by
    the same variable as the JAX package's route)."""
    if not os.environ.get("VECTORLITE_JAX_PROFILE_DIR"):
        return json_response(
            {"message": "Set VECTORLITE_JAX_PROFILE_DIR to enable tracing"}, status=400)
    seconds = float(request.query.get("seconds", "2"))
    return json_response({"trace_dir": capture_device_trace(seconds)})


def openapi_spec(request: Request) -> Response:
    """Serve the API contract (docs/openapi.yaml, the cross-implementation
    contract; reference: docs/openapi.yaml:1-839)."""
    spec = _openapi_spec_text()
    if spec is None:
        raise HTTPError.message(404, "OpenAPI spec not available")
    return text_response(spec, "application/yaml")


_spec_cache: "str | None" = None


def _openapi_spec_text():
    """Contract text: the repo's docs/openapi.yaml in a source checkout,
    else the copy packaged beside this module (a test pins them
    identical). Failures are not cached, so a transient read error heals
    on retry."""
    global _spec_cache
    if _spec_cache is not None:
        return _spec_cache
    here = Path(__file__).resolve()
    for path in (here.parents[2] / "docs" / "openapi.yaml", here.parent / "openapi.yaml"):
        try:
            _spec_cache = path.read_text(encoding="utf-8")
            return _spec_cache
        except OSError:
            continue
    return None


_ROUTES = (
    ("GET", "/openapi.yaml", openapi_spec),
    ("GET", "/stats", get_stats),
    ("GET", "/metrics", get_metrics),
    ("POST", "/debug/trace", debug_trace),
    ("GET", "/health", health_check),
    ("GET", "/collections", list_collections),
    ("POST", "/collections", create_collection),
    ("GET", "/collections/{name}", get_collection_info),
    ("DELETE", "/collections/{name}", delete_collection),
    ("POST", "/collections/{name}/text", add_text),
    ("POST", "/collections/{name}/search/text", search_text),
    # batched extensions (one device program per batch)
    ("POST", "/collections/{name}/texts", add_texts),
    ("POST", "/collections/{name}/search/texts", search_texts),
    ("POST", "/collections/{name}/search/hybrid", search_hybrid),
    # raw-vector extensions (precomputed embeddings in, vector queries in)
    ("POST", "/collections/{name}/vectors", add_vectors),
    ("POST", "/collections/{name}/search/vector", search_vector),
    ("POST", "/collections/{name}/search/vectors", search_vectors),
    ("GET", "/collections/{name}/vectors", list_vectors),
    ("GET", "/collections/{name}/vectors/{id}", get_vector),
    ("DELETE", "/collections/{name}/vectors", delete_vectors_where),
    ("DELETE", "/collections/{name}/vectors/{id}", delete_vector),
    ("PATCH", "/collections/{name}/vectors/{id}", update_vector_metadata),
    ("PUT", "/collections/{name}/vectors/{id}", replace_vector),
    ("POST", "/collections/{name}/compact", compact_collection),
    ("POST", "/collections/{name}/save", save_collection),
    ("POST", "/collections/load", load_collection),
    ("GET", "/collections/{name}/snapshot", download_snapshot),
    ("POST", "/collections/{name}/snapshot", restore_snapshot),
)


def create_app(client: VectorLiteClient, *, autosave=None, api_key=None, wal=None) -> App:
    """The routes of reference: src/server.rs:361-377, plus /stats,
    /metrics, /debug/trace and /openapi.yaml. ``autosave`` is an optional
    started ``store.autosave.AutosaveDaemon``; the app owns its shutdown
    (final flush) and surfaces its counters at /stats. ``wal`` is an
    optional attached ``store.wal.WalManager``; the app surfaces its
    counters at /stats and closes the logs on shutdown, after the
    autosave's final flush. ``api_key`` (default: $VECTORLITE_API_KEY)
    enables bearer-token auth on every route except GET /health; ``""``
    forces an open server even when the variable is set."""
    if api_key is None:
        api_key = os.environ.get("VECTORLITE_API_KEY") or None
    # bulk routes (/texts, /vectors) carry multi-MB JSON bodies
    max_body_mb = env_number("VECTORLITE_MAX_BODY_MB", 256, float)
    if max_body_mb <= 0:
        logger.warning(
            "VECTORLITE_MAX_BODY_MB=%s is not a positive number; using the 256 MiB default",
            max_body_mb,
        )
        max_body_mb = 256
    if api_key:
        logger.info("API-key auth enabled (all routes except GET /health)")
    app = App(max_body=int(max_body_mb * 1024**2), middleware=_middleware(api_key))
    app.state.update(client=client, lock=RWLock(), stats=LatencyRecorder(),
                     autosave=autosave, wal=wal)
    if autosave is not None:
        app.on_cleanup.append(lambda: autosave.stop(flush=True))
    if wal is not None:
        # after the autosave's final flush above, so the last checkpoint
        # lands before the logs close
        app.on_cleanup.append(wal.close)
    for method, template, handler in _ROUTES:
        app.add_route(method, template, handler)
    return app


def bind(app: App, host: str = "127.0.0.1", port: int = 0) -> Server:
    """The app bound to (host, port) (0 picks a free port), not yet
    serving: ``.start()`` serves from a thread, ``.serve_forever()`` from
    the caller's; ``.close()`` stops and runs the app's clean-up."""
    return Server(app, host, port)


def start_server(
    client: VectorLiteClient,
    host: str = "127.0.0.1",
    port: int = 3001,
    *,
    autosave=None,
    api_key=None,
    wal=None,
) -> None:
    """Blocking serve loop (reference: src/server.rs:379-392). SIGINT and
    SIGTERM stop it; the app's clean-up (the autosave's final flush, then
    the logs' close) runs on the way out."""
    app = create_app(client, autosave=autosave, api_key=api_key, wal=wal)
    server = bind(app, host, port)

    def stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, stop)
    logger.info("VectorLite server starting on %s:%s", host, server.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("VectorLite server stopping")
    finally:
        server.close()
