"""HTTP SDK client for a running vectorlite server (stdlib-only).

Port of ``vectorlite_tpu/remote.py``: the same client over the same
contract, returning this package's ``SearchResult`` and ``Vector`` and
raising errors of its ``VectorLiteError`` hierarchy. It talks to either
package's server.

The reference points API consumers at OpenAPI-generated JS/Go clients
(reference: README.md:82-83); this module ships the Python equivalent
in-tree: :class:`RemoteClient` mirrors the local
:class:`~vectorlite_tpu_torch.VectorLiteClient` method surface over the
reference-compatible REST contract (docs/openapi.yaml), including the
TPU-native extensions (batched routes, ``where`` filters, compaction,
stats). Only ``urllib`` is used — no extra dependencies.

Server-side typed errors (``{"message": ...}`` bodies with the
reference's status codes) surface as :class:`RemoteError`; transport
failures as :class:`RemoteConnectionError`. Both subclass
:class:`~vectorlite_tpu_torch.errors.VectorLiteError` so callers can keep one
except-clause across local and remote clients.
"""

from __future__ import annotations

import contextlib
import json
import operator
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional, Sequence

from .core.types import SearchResult, Vector
from .errors import VectorLiteError

__all__ = ["RemoteClient", "RemoteError", "RemoteConnectionError"]


def _vector_from_json(v: dict) -> Vector:
    """Vector from a /vectors response element (shared by the listing
    and bulk-get paths; values/text may be omitted or null when
    include_values is off)."""
    return Vector(
        id=int(v["id"]),
        values=v.get("values") or [],
        text=v.get("text") or "",
        metadata=v.get("metadata"),
    )


class RemoteError(VectorLiteError):
    """A typed error returned by the server (4xx/5xx with the canonical
    ``{"message": ...}`` body). ``status_code`` carries the HTTP status
    so ``is_client_error()``/``is_server_error()`` keep working."""

    def __init__(self, status: int, message: str):
        self.status_code = int(status)
        super().__init__(message)


class RemoteConnectionError(VectorLiteError):
    """The server could not be reached (refused, DNS, timeout)."""

    status_code = 503

    def __init__(self, detail: str):
        super().__init__(f"Connection error: {detail}")


@contextlib.contextmanager
def _mapped_transport_errors():
    """The one transport→typed-error mapping (server ``{"message":...}``
    bodies → RemoteError; anything network-shaped → RemoteConnectionError),
    shared by the JSON plumbing and both snapshot streams. Mid-body
    failures (read timeout, reset, IncompleteRead) surface after urlopen
    returned — same contract."""
    import http.client

    try:
        yield
    except urllib.error.HTTPError as e:
        err_body = e.read()
        try:
            message = json.loads(err_body.decode("utf-8"))["message"]
        except Exception:
            message = err_body.decode("utf-8", "replace") or str(e)
        raise RemoteError(e.code, message) from None
    except urllib.error.URLError as e:
        raise RemoteConnectionError(str(e.reason)) from None
    except (TimeoutError, OSError, http.client.HTTPException) as e:
        raise RemoteConnectionError(str(e) or type(e).__name__) from None


def _metric_str(metric) -> Optional[str]:
    if metric is None:
        return None
    name = getattr(metric, "name", None)
    if name is not None:  # SimilarityMetric enum
        return name.replace("_", "").lower()
    return str(metric)


def _index_type_str(index_type) -> str:
    name = getattr(index_type, "name", None)
    if name is not None:  # IndexType enum
        return name.lower()
    return str(index_type)


def _result(obj: dict) -> SearchResult:
    return SearchResult(
        id=int(obj["id"]),
        score=float(obj["score"]),
        text=obj.get("text") or "",
        metadata=obj.get("metadata"),
    )


class RemoteClient:
    """Synchronous client for one vectorlite server.

    >>> rc = RemoteClient("http://127.0.0.1:3001")
    >>> rc.create_collection("docs", "flat")
    >>> rc.add_text("docs", "hello", {"lang": "en"})
    0
    >>> rc.search_text("docs", "hello", k=3, where={"lang": "en"})
    [SearchResult(id=0, ...)]
    """

    def __init__(
        self,
        base_url: str,
        *,
        timeout: float = 30.0,
        api_key: Optional[str] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout = float(timeout)
        self.api_key = api_key

    # ------------------------------------------------------------ plumbing

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        *,
        raw: bool = False,
    ) -> Any:
        url = self.base_url + path
        data = None
        headers = {"accept": "application/json"}
        if self.api_key:
            headers["authorization"] = f"Bearer {self.api_key}"
        if body is not None:
            data = json.dumps(body).encode("utf-8")
            headers["content-type"] = "application/json"
        req = urllib.request.Request(
            url, data=data, method=method, headers=headers
        )
        with _mapped_transport_errors():
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw_body = resp.read()
        if raw:
            return raw_body.decode("utf-8")
        if not raw_body:
            return None
        return json.loads(raw_body.decode("utf-8"))

    # --------------------------------------------------------- collections

    def create_collection(
        self, name: str, index_type, similarity_metric=None
    ) -> None:
        body: dict = {
            "name": name,
            "index_type": _index_type_str(index_type),
        }
        metric = _metric_str(similarity_metric)
        if metric is not None:
            body["metric"] = metric
        self._request("POST", "/collections", body)

    def list_collections(self) -> list[str]:
        return self._request("GET", "/collections")["collections"]

    def has_collection(self, name: str) -> bool:
        return name in self.list_collections()

    def delete_collection(self, name: str) -> None:
        self._request(
            "DELETE", f"/collections/{urllib.parse.quote(name, safe='')}"
        )

    def get_collection_info(self, name: str) -> dict:
        out = self._request(
            "GET", f"/collections/{urllib.parse.quote(name, safe='')}"
        )
        return out["info"]

    # ------------------------------------------------------------- vectors

    def add_text(
        self, collection: str, text: str, metadata: Optional[Any] = None
    ) -> int:
        body: dict = {"text": text}
        if metadata is not None:
            body["metadata"] = metadata
        out = self._request(
            "POST",
            f"/collections/{urllib.parse.quote(collection, safe='')}/text",
            body,
        )
        return int(out["id"])

    def add_texts(
        self,
        collection: str,
        texts: Sequence[str],
        metadatas: Optional[Sequence[Any]] = None,
    ) -> list[int]:
        """Batched insert (extension route: one on-chip forward)."""
        body: dict = {"texts": list(texts)}
        if metadatas is not None:
            body["metadatas"] = list(metadatas)
        out = self._request(
            "POST",
            f"/collections/{urllib.parse.quote(collection, safe='')}/texts",
            body,
        )
        return [int(i) for i in out["ids"]]

    def add_vectors(
        self,
        collection: str,
        values: Sequence[Sequence[float]],
        texts: Optional[Sequence[str]] = None,
        metadatas: Optional[Sequence[Any]] = None,
        ids: Optional[Sequence[int]] = None,
    ) -> list[int]:
        """Bulk insert of precomputed embeddings (extension route: no
        embedder in the loop). Explicit ``ids`` are all-or-none and
        must be fresh u64s (RemoteError 409 on reuse)."""
        values = [list(row) for row in values]
        n = len(values)
        for name, seq in (("texts", texts), ("metadatas", metadatas),
                          ("ids", ids)):
            if seq is not None and len(seq) != n:
                raise ValueError(
                    f"values/{name} length mismatch: {n} rows, "
                    f"{len(seq)} {name}"
                )
        vectors = []
        for i, row in enumerate(values):
            v: dict = {"values": [float(x) for x in row]}
            if texts is not None and texts[i]:
                v["text"] = texts[i]
            if metadatas is not None and metadatas[i] is not None:
                v["metadata"] = metadatas[i]
            if ids is not None:
                vid = ids[i]
                # strict: int(5.5) would silently truncate client-side;
                # __index__ accepts int/np.integer, rejects float/bool
                if isinstance(vid, bool):
                    raise ValueError("vector ids must be integers, got bool")
                try:
                    v["id"] = operator.index(vid)
                except TypeError:
                    raise ValueError(
                        f"vector ids must be integers, got "
                        f"{type(vid).__name__}"
                    ) from None
            vectors.append(v)
        out = self._request(
            "POST",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            "/vectors",
            {"vectors": vectors},
        )
        return [int(i) for i in out["ids"]]

    def search_vector(
        self,
        collection: str,
        vector: Sequence[float],
        k: int = 10,
        similarity_metric=None,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
    ) -> list[SearchResult]:
        """Search by one raw query vector (extension route)."""
        body: dict = {"vector": [float(x) for x in vector], "k": int(k)}
        if ef is not None:
            body["ef"] = int(ef)
        if min_score is not None:
            body["min_score"] = float(min_score)
        metric = _metric_str(similarity_metric)
        if metric is not None:
            body["similarity_metric"] = metric
        if where is not None:
            body["where"] = where
        out = self._request(
            "POST",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            "/search/vector",
            body,
        )
        return [_result(r) for r in out["results"]]

    def search_vectors(
        self,
        collection: str,
        vectors: Sequence[Sequence[float]],
        k: int = 10,
        similarity_metric=None,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
    ) -> list[list[SearchResult]]:
        """Batched raw-vector search (extension route: one device
        program for the whole batch)."""
        body: dict = {
            "vectors": [[float(x) for x in q] for q in vectors],
            "k": int(k),
        }
        if ef is not None:
            body["ef"] = int(ef)
        if min_score is not None:
            body["min_score"] = float(min_score)
        metric = _metric_str(similarity_metric)
        if metric is not None:
            body["similarity_metric"] = metric
        if where is not None:
            body["where"] = where
        out = self._request(
            "POST",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            "/search/vectors",
            body,
        )
        return [[_result(r) for r in row] for row in out["results"]]

    def search_text(
        self,
        collection: str,
        query: str,
        k: int = 10,
        similarity_metric=None,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
    ) -> list[SearchResult]:
        body: dict = {"query": query, "k": int(k)}
        if ef is not None:
            body["ef"] = int(ef)
        if min_score is not None:
            body["min_score"] = float(min_score)
        metric = _metric_str(similarity_metric)
        if metric is not None:
            body["similarity_metric"] = metric
        if where is not None:
            body["where"] = where
        out = self._request(
            "POST",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            "/search/text",
            body,
        )
        return [_result(r) for r in out["results"]]

    def search_hybrid(
        self,
        collection: str,
        query: str,
        k: int = 10,
        similarity_metric=None,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
        alpha: float = 0.5,
        pool: Optional[int] = None,
    ) -> list[SearchResult]:
        """Hybrid dense + BM25 search with reciprocal-rank fusion
        (extension route). ``alpha`` weights the dense leg in [0, 1];
        returned scores are fused RRF scores, not similarities."""
        body: dict = {"query": query, "k": int(k), "alpha": float(alpha)}
        if pool is not None:
            body["pool"] = int(pool)
        if ef is not None:
            body["ef"] = int(ef)
        if min_score is not None:
            body["min_score"] = float(min_score)
        metric = _metric_str(similarity_metric)
        if metric is not None:
            body["similarity_metric"] = metric
        if where is not None:
            body["where"] = where
        out = self._request(
            "POST",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            "/search/hybrid",
            body,
        )
        return [_result(r) for r in out["results"]]

    def search_texts(
        self,
        collection: str,
        queries: Sequence[str],
        k: int = 10,
        similarity_metric=None,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
    ) -> list[list[SearchResult]]:
        """Batched search (extension route: one device program)."""
        body: dict = {"queries": list(queries), "k": int(k)}
        if ef is not None:
            body["ef"] = int(ef)
        if min_score is not None:
            body["min_score"] = float(min_score)
        metric = _metric_str(similarity_metric)
        if metric is not None:
            body["similarity_metric"] = metric
        if where is not None:
            body["where"] = where
        out = self._request(
            "POST",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            "/search/texts",
            body,
        )
        return [[_result(r) for r in row] for row in out["results"]]

    def get_vector(self, collection: str, id: int) -> Vector:
        out = self._request(
            "GET",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            f"/vectors/{int(id)}",
        )
        v = out["vector"]
        return Vector(
            id=int(v["id"]),
            values=v["values"],
            text=v.get("text") or "",
            metadata=v.get("metadata"),
        )

    def delete_vector(self, collection: str, id: int) -> None:
        self._request(
            "DELETE",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            f"/vectors/{int(id)}",
        )

    def delete_where(self, collection: str, where: dict) -> int:
        """Bulk delete by metadata filter (extension route). ``where``
        is required; ``{}`` is an explicit clear-all. Returns the
        number of vectors removed."""
        params = urllib.parse.urlencode({"where": json.dumps(where)})
        out = self._request(
            "DELETE",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            f"/vectors?{params}",
        )
        return int(out["deleted"])

    def list_vectors(
        self,
        collection: str,
        offset: int = 0,
        limit: int = 100,
        where: Optional[dict] = None,
        include_values: bool = False,
    ) -> tuple[list[Vector], int]:
        """Paged listing (extension route); returns (vectors, total)."""
        params = {"offset": str(int(offset)), "limit": str(int(limit))}
        if include_values:
            params["include_values"] = "1"
        if where is not None:
            params["where"] = json.dumps(where)
        out = self._request(
            "GET",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            f"/vectors?{urllib.parse.urlencode(params)}",
        )
        vectors = [_vector_from_json(v) for v in out["vectors"]]
        return vectors, int(out["total"])

    def get_vectors(
        self,
        collection: str,
        ids: Sequence[int],
        where: Optional[dict] = None,
        include_values: bool = True,
    ) -> list[Vector]:
        """Bulk get by explicit ids (extension): found vectors in the
        requested order, missing ids skipped; optional ``where``
        post-filter. An empty ids list returns [] without a request,
        matching the local SDK (the server rejects a bare ids=)."""
        ids = list(ids)
        if not ids:
            return []
        params = {"ids": ",".join(str(int(i)) for i in ids)}
        if include_values:
            params["include_values"] = "1"
        if where is not None:
            params["where"] = json.dumps(where)
        out = self._request(
            "GET",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            f"/vectors?{urllib.parse.urlencode(params)}",
        )
        return [_vector_from_json(v) for v in out["vectors"]]

    def update_text(
        self,
        collection: str,
        id: int,
        text: str,
        metadata: Optional[Any] = None,
    ) -> None:
        """Re-embed + replace a vector under the same id (extension
        route; PUT semantics — metadata replaced too, omit to clear)."""
        self._request(
            "PUT",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            f"/vectors/{int(id)}",
            {"text": text, "metadata": metadata},
        )

    def update_metadata(
        self, collection: str, id: int, metadata: Optional[Any]
    ) -> None:
        """Replace one vector's metadata (extension route; None clears)."""
        self._request(
            "PATCH",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            f"/vectors/{int(id)}",
            {"metadata": metadata},
        )

    # ------------------------------------------------------- ops & persist

    def save_collection(self, collection: str, file_path: str) -> None:
        self._request(
            "POST",
            f"/collections/{urllib.parse.quote(collection, safe='')}/save",
            {"file_path": file_path},
        )

    def load_collection(
        self, file_path: str, collection_name: Optional[str] = None
    ) -> str:
        body: dict = {"file_path": file_path}
        if collection_name is not None:
            body["collection_name"] = collection_name
        out = self._request("POST", "/collections/load", body)
        return out["collection_name"]

    def download_snapshot(self, collection: str, dest) -> int:
        """Stream ``GET /collections/{name}/snapshot`` into ``dest`` — a
        path (written via tmp + atomic rename, like the server's own
        save) or a binary file object. Returns bytes written. The
        document is the same .vlc content ``save_collection`` writes
        server-side, so it round-trips through ``restore_snapshot``,
        ``load_collection``, and the reference engine alike."""
        import os

        url = (
            self.base_url
            + f"/collections/{urllib.parse.quote(collection, safe='')}"
            + "/snapshot"
        )
        headers = {"accept": "application/json"}
        if self.api_key:
            headers["authorization"] = f"Bearer {self.api_key}"
        req = urllib.request.Request(url, headers=headers)
        with _mapped_transport_errors():
            resp = urllib.request.urlopen(req, timeout=self.timeout)

        def pump(f) -> int:
            written = 0
            with resp:
                while True:
                    with _mapped_transport_errors():
                        chunk = resp.read(1 << 20)
                    if not chunk:
                        return written
                    f.write(chunk)
                    written += len(chunk)

        if hasattr(dest, "write"):
            return pump(dest)
        tmp = f"{dest}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                written = pump(f)
            os.replace(tmp, dest)
            return written
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def restore_snapshot(self, name: str, src) -> int:
        """Upload a .vlc document (path, bytes, or binary file object)
        as ``POST /collections/{name}/snapshot``, creating collection
        ``name`` server-side. Returns the restored vector count.

        A path or a real file is STREAMED from disk with an explicit
        Content-Length (http.client reads file bodies in blocks), so a
        multi-GB snapshot from ``download_snapshot`` round-trips without
        ever being resident client-side; only bytes / non-seekable
        file objects are buffered (they already are)."""
        import os

        close_me = None
        try:
            if isinstance(src, (bytes, bytearray)):
                data: Any = bytes(src)
                length = len(data)
            else:
                f = src if hasattr(src, "read") else None
                if f is None:
                    f = close_me = open(src, "rb")
                try:
                    length = os.fstat(f.fileno()).st_size - f.tell()
                    data = f
                except (OSError, AttributeError, ValueError):
                    # no fileno (BytesIO, sockets): fall back to buffering
                    data = f.read()
                    length = len(data)
            url = (
                self.base_url
                + f"/collections/{urllib.parse.quote(name, safe='')}"
                + "/snapshot"
            )
            headers = {
                "accept": "application/json",
                "content-type": "application/json",
                "content-length": str(length),
            }
            if self.api_key:
                headers["authorization"] = f"Bearer {self.api_key}"
            req = urllib.request.Request(
                url, data=data, method="POST", headers=headers
            )
            with _mapped_transport_errors():
                with urllib.request.urlopen(
                    req, timeout=self.timeout
                ) as resp:
                    out = json.loads(resp.read().decode("utf-8"))
        finally:
            if close_me is not None:
                close_me.close()
        return int(out["vector_count"])

    def compact(self, collection: str) -> int:
        out = self._request(
            "POST",
            f"/collections/{urllib.parse.quote(collection, safe='')}"
            "/compact",
        )
        return int(out["reclaimed"])

    def health(self) -> dict:
        return self._request("GET", "/health")

    def stats(self) -> dict:
        return self._request("GET", "/stats")

    def metrics(self) -> str:
        """Prometheus text-format exposition (extension route)."""
        return self._request("GET", "/metrics", raw=True)
