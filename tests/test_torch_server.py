"""The port's HTTP surface over a real socket, on the CPU.

Counterpart of tests/test_server.py (which mirrors the reference's
tower::oneshot suites, reference: tests/http_integration_test.rs,
tests/persistence_api_test.rs): status codes, JSON body shapes and the
``{"message": ...}`` error contract, against the port's standard-library
server bound to an ephemeral localhost port. ``served`` and
``SyncClient`` here are what the port's other HTTP test files drive it
with. HNSW collections are created, written and searched as in the JAX
app (metric required, metric mismatch refused, per-request ``ef``).
"""

import contextlib
from http.client import HTTPConnection
import json as _json
import urllib.parse

import pytest

from vectorlite_tpu_torch import VectorLiteClient
from vectorlite_tpu_torch.api.server import bind, create_app
from vectorlite_tpu_torch.embed.mock import ConstantEmbeddingFunction


class SyncResponse:
    def __init__(self, status, headers, body):
        self.status = status
        self.headers = headers
        self._body = body

    def json(self):
        return _json.loads(self._body.decode("utf-8"))

    def text(self):
        return self._body.decode("utf-8")

    def read(self):
        return self._body


def _quote_target(path: str) -> str:
    """Percent-encode what a request line cannot carry (spaces, non-ASCII),
    as aiohttp's client does; existing escapes stay."""
    raw_path, sep, query = path.partition("?")
    return (urllib.parse.quote(raw_path, safe="/%:@!$&'()*+,;=")
            + sep + urllib.parse.quote(query, safe="=&%:@!$'()*+,;/?"))


class SyncClient:
    """aiohttp's TestClient surface, synchronous, over one keep-alive
    http.client connection."""

    def __init__(self, port: int):
        self.port = port
        self._conn = HTTPConnection("127.0.0.1", port, timeout=120)

    def request(self, method, path, *, json=None, data=None, headers=None):
        headers = dict(headers or {})
        body = data
        if json is not None:
            body = _json.dumps(json)
            headers.setdefault("Content-Type", "application/json")
        if isinstance(body, str):
            body = body.encode("utf-8")
        self._conn.request(method, _quote_target(path), body=body, headers=headers)
        resp = self._conn.getresponse()
        out = SyncResponse(resp.status, resp.headers, resp.read())
        if resp.will_close:
            self._conn.close()
        return out

    def get(self, path, **kw):
        return self.request("GET", path, **kw)

    def post(self, path, **kw):
        return self.request("POST", path, **kw)

    def put(self, path, **kw):
        return self.request("PUT", path, **kw)

    def patch(self, path, **kw):
        return self.request("PATCH", path, **kw)

    def delete(self, path, **kw):
        return self.request("DELETE", path, **kw)

    def options(self, path, **kw):
        return self.request("OPTIONS", path, **kw)

    def head(self, path, **kw):
        return self.request("HEAD", path, **kw)

    def close(self):
        self._conn.close()


@contextlib.contextmanager
def served(app):
    """``app`` served on 127.0.0.1:<ephemeral> from a thread; yields a
    SyncClient; closes the server (and runs the app's clean-up) after."""
    server = bind(app).start()
    tc = SyncClient(server.port)
    try:
        yield tc
    finally:
        tc.close()
        server.close()


def make_client():
    # constant [1,2,3] mock (reference: tests/http_integration_test.rs:20-28)
    return VectorLiteClient(ConstantEmbeddingFunction([1.0, 2.0, 3.0]), device="cpu")


def make_text_client(dim=16):
    """Text-deterministic mock, for tests that must distinguish
    embeddings."""
    from vectorlite_tpu_torch.embed.mock import MockEmbeddingFunction

    return VectorLiteClient(MockEmbeddingFunction(dim), device="cpu")


def http(fn, client=None):
    with served(create_app(client or make_client())) as tc:
        return fn(tc)


class TestHealthAndCollections:
    def test_health(self):
        def go(tc):
            resp = tc.get("/health")
            assert resp.status == 200
            body = resp.json()
            assert body["status"] == "healthy"
            assert body["service"] == "vectorlite"

        http(go)

    def test_list_collections_empty(self):
        def go(tc):
            resp = tc.get("/collections")
            assert resp.status == 200
            assert (resp.json())["collections"] == []

        http(go)

    def test_create_collection(self):
        def go(tc):
            resp = tc.post(
                "/collections",
                json={"name": "test_collection", "index_type": "flat"},
            )
            assert resp.status == 200
            assert (resp.json())["name"] == "test_collection"
            resp = tc.get("/collections")
            assert (resp.json())["collections"] == ["test_collection"]

        http(go)

    def test_create_duplicate_collection_409(self):
        def go(tc):
            payload = {"name": "test_collection", "index_type": "flat"}
            assert (tc.post("/collections", json=payload)).status == 200
            resp = tc.post("/collections", json=payload)
            assert resp.status == 409
            body = resp.json()
            assert (
                body["message"]
                == "Collection 'test_collection' already exists"
            )

        http(go)

    def test_create_invalid_index_type_400(self):
        def go(tc):
            resp = tc.post(
                "/collections", json={"name": "x", "index_type": "btree"}
            )
            assert resp.status == 400
            body = resp.json()
            assert (
                body["message"]
                == "Invalid index type: btree. Must be 'flat' or 'hnsw'"
            )

        http(go)

    @pytest.mark.parametrize("body,status", [
        ({"name": "h", "index_type": "hnsw"}, 400),
        ({"name": "h", "index_type": "HNSW", "metric": "Euclidean"}, 200),
    ])
    def test_create_hnsw(self, body, status):
        """Without a metric the create is the JAX app's 400 and no
        collection exists; with one, the HNSW collection takes a text and
        finds it, and its info counts it."""
        def go(tc):
            resp = tc.post("/collections", json=body)
            assert resp.status == status
            assert resp.headers["Access-Control-Allow-Origin"] == "*"
            if status == 400:
                assert "HNSW index requires an explicit similarity metric" in (
                    resp.json()["message"])
                assert tc.get("/collections").json()["collections"] == []
                assert tc.post("/collections/h/text", json={"text": "x"}).status == 404
                return
            assert tc.post("/collections/h/text", json={"text": "x"}).status == 200
            resp = tc.post("/collections/h/search/text", json={"query": "x"})
            assert resp.status == 200
            assert [h["id"] for h in resp.json()["results"]] == [0]
            assert tc.get("/collections/h").json()["info"]["count"] == 1

        http(go)

    def test_get_collection_info(self):
        def go(tc):
            tc.post(
                "/collections",
                json={"name": "test_collection", "index_type": "flat"},
            )
            resp = tc.get("/collections/test_collection")
            assert resp.status == 200
            info = (resp.json())["info"]
            assert info["name"] == "test_collection"
            assert info["count"] == 0
            assert info["is_empty"] is True
            assert info["dimension"] == 3

        http(go)

    def test_get_missing_collection_404(self):
        def go(tc):
            resp = tc.get("/collections/missing")
            assert resp.status == 404
            assert (resp.json())["message"] == (
                "Collection 'missing' not found"
            )

        http(go)

    def test_delete_collection(self):
        def go(tc):
            tc.post(
                "/collections",
                json={"name": "test_collection", "index_type": "flat"},
            )
            resp = tc.delete("/collections/test_collection")
            assert resp.status == 200
            assert (resp.json())["name"] == "test_collection"
            resp = tc.delete("/collections/test_collection")
            assert resp.status == 404

        http(go)


class TestVectorOps:
    def test_add_text(self):
        def go(tc):
            tc.post(
                "/collections",
                json={"name": "test_collection", "index_type": "flat"},
            )
            resp = tc.post(
                "/collections/test_collection/text",
                json={"text": "Hello world"},
            )
            assert resp.status == 200
            assert (resp.json())["id"] == 0

        http(go)

    def test_add_text_missing_collection_404(self):
        def go(tc):
            resp = tc.post(
                "/collections/missing/text", json={"text": "x"}
            )
            assert resp.status == 404

        http(go)

    def test_search_text(self):
        def go(tc):
            tc.post(
                "/collections",
                json={"name": "test_collection", "index_type": "flat"},
            )
            tc.post(
                "/collections/test_collection/text",
                json={"text": "Hello world"},
            )
            resp = tc.post(
                "/collections/test_collection/search/text",
                json={
                    "query": "Hello",
                    "k": 5,
                    "similarity_metric": "cosine",
                },
            )
            assert resp.status == 200
            results = (resp.json())["results"]
            assert len(results) == 1
            assert results[0]["id"] == 0
            assert results[0]["text"] == "Hello world"

        http(go)

    def test_search_default_k(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            for i in range(12):
                tc.post(
                    "/collections/c/text", json={"text": f"t{i}"}
                )
            resp = tc.post(
                "/collections/c/search/text", json={"query": "q"}
            )
            # default k = 10 (reference: src/server.rs:263)
            assert len((resp.json())["results"]) == 10

        http(go)

    def test_search_invalid_metric_400(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            resp = tc.post(
                "/collections/c/search/text",
                json={"query": "q", "similarity_metric": "bogus"},
            )
            assert resp.status == 400

        http(go)

    def test_search_metric_mismatch_400(self):
        """An HNSW graph serves only its build metric."""
        def go(tc):
            tc.post(
                "/collections",
                json={"name": "h", "index_type": "hnsw", "metric": "euclidean"},
            )
            tc.post("/collections/h/text", json={"text": "x"})
            resp = tc.post(
                "/collections/h/search/text",
                json={"query": "q", "similarity_metric": "cosine"},
            )
            assert resp.status == 400
            assert "Metric mismatch" in resp.json()["message"]
            resp = tc.post(
                "/collections/h/search/text",
                json={"query": "q", "similarity_metric": "euclidean"},
            )
            assert resp.status == 200

        http(go)

    def test_search_any_metric_on_flat_with_metric(self):
        """A Flat collection's create-time metric only sets the default:
        every metric searches it (the JAX app's metric-mismatch 400 is an
        HNSW rule)."""
        def go(tc):
            tc.post(
                "/collections",
                json={"name": "f", "index_type": "flat", "metric": "euclidean"},
            )
            tc.post("/collections/f/text", json={"text": "x"})
            for metric in ("cosine", "euclidean", "DotProduct", "manhattan"):
                resp = tc.post(
                    "/collections/f/search/text",
                    json={"query": "q", "similarity_metric": metric},
                )
                assert resp.status == 200, metric
                assert [h["id"] for h in resp.json()["results"]] == [0]

        http(go)

    def test_get_vector(self):
        def go(tc):
            tc.post(
                "/collections",
                json={"name": "test_collection", "index_type": "flat"},
            )
            tc.post(
                "/collections/test_collection/text",
                json={"text": "Hello world"},
            )
            resp = tc.get("/collections/test_collection/vectors/0")
            assert resp.status == 200
            vector = (resp.json())["vector"]
            assert vector["id"] == 0
            assert vector["values"] == [1.0, 2.0, 3.0]

        http(go)

    def test_get_missing_vector_404(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            resp = tc.get("/collections/c/vectors/99")
            assert resp.status == 404
            assert (resp.json())["message"] == (
                "Vector ID 99 does not exist"
            )

        http(go)

    def test_delete_vector(self):
        def go(tc):
            tc.post(
                "/collections",
                json={"name": "test_collection", "index_type": "flat"},
            )
            tc.post(
                "/collections/test_collection/text",
                json={"text": "Hello world"},
            )
            resp = tc.delete("/collections/test_collection/vectors/0")
            assert resp.status == 200
            assert (resp.json()) == {}

        http(go)

    def test_put_replaces_vector_in_place(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            tc.post(
                "/collections/c/texts",
                json={"texts": ["alpha", "beta"],
                      "metadatas": [{"v": 1}, {"v": 1}]},
            )
            resp = tc.put(
                "/collections/c/vectors/0",
                json={"text": "gamma", "metadata": {"v": 2}},
            )
            assert resp.status == 200
            assert (resp.json()) == {"id": 0}
            # same id, new text/values/metadata: a search for the new
            # text must hit id 0 exactly (mock embeddings are
            # text-deterministic)
            resp = tc.post(
                "/collections/c/search/text", json={"query": "gamma", "k": 1}
            )
            hit = (resp.json())["results"][0]
            assert hit["id"] == 0 and hit["text"] == "gamma"
            assert hit["metadata"] == {"v": 2} and hit["score"] > 0.999
            # metadata omitted = cleared; count unchanged
            resp = tc.put(
                "/collections/c/vectors/0", json={"text": "delta"}
            )
            assert resp.status == 200
            resp = tc.get("/collections/c/vectors/0")
            body = (resp.json())["vector"]
            assert body["text"] == "delta" and body["metadata"] is None
            info = (tc.get("/collections/c")).json()
            assert info["info"]["count"] == 2
            # missing text -> 400; absent id / collection -> 404
            resp = tc.put(
                "/collections/c/vectors/0", json={"metadata": {}}
            )
            assert resp.status == 400
            resp = tc.put(
                "/collections/c/vectors/99", json={"text": "x"}
            )
            assert resp.status == 404
            resp = tc.put(
                "/collections/zz/vectors/0", json={"text": "x"}
            )
            assert resp.status == 404

        http(go, make_text_client())

    def test_metadata_roundtrip(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            meta = {"author": "Kevin Malone", "year": 2005}
            tc.post(
                "/collections/c/text",
                json={"text": "beach", "metadata": meta},
            )
            resp = tc.post(
                "/collections/c/search/text", json={"query": "beach"}
            )
            results = (resp.json())["results"]
            assert results[0]["metadata"] == meta

        http(go)


class TestPersistenceApi:
    """Mirrors reference: tests/persistence_api_test.rs."""

    def test_save_and_load(self, tmp_path):
        path = str(tmp_path / "c.vlc")

        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            tc.post("/collections/c/text", json={"text": "hello"})
            resp = tc.post(
                "/collections/c/save", json={"file_path": path}
            )
            assert resp.status == 200
            assert (resp.json())["file_path"] == path

            resp = tc.post(
                "/collections/load",
                json={"file_path": path, "collection_name": "restored"},
            )
            assert resp.status == 200
            assert (resp.json())["collection_name"] == "restored"

            resp = tc.get("/collections/restored")
            info = (resp.json())["info"]
            assert info["count"] == 1

        http(go)

    def test_save_missing_collection_404(self, tmp_path):
        def go(tc):
            resp = tc.post(
                "/collections/missing/save",
                json={"file_path": str(tmp_path / "x.vlc")},
            )
            assert resp.status == 404

        http(go)

    def test_load_missing_file_404(self, tmp_path):
        def go(tc):
            resp = tc.post(
                "/collections/load",
                json={"file_path": str(tmp_path / "nope.vlc")},
            )
            assert resp.status == 404
            assert (resp.json())["message"].startswith(
                "File not found:"
            )

        http(go)

    def test_load_existing_name_409(self, tmp_path):
        path = str(tmp_path / "c.vlc")

        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            tc.post(
                "/collections/c/save", json={"file_path": path}
            )
            resp = tc.post(
                "/collections/load", json={"file_path": path}
            )
            assert resp.status == 409

        http(go)

    def test_load_uses_name_from_file(self, tmp_path):
        path = str(tmp_path / "c.vlc")

        def go(tc):
            tc.post(
                "/collections", json={"name": "orig", "index_type": "flat"}
            )
            tc.post(
                "/collections/orig/save", json={"file_path": path}
            )
            tc.delete("/collections/orig")
            resp = tc.post(
                "/collections/load", json={"file_path": path}
            )
            assert (resp.json())["collection_name"] == "orig"

        http(go)


class TestObservability:
    def test_stats_endpoint(self):
        def go(tc):
            tc.get("/health")
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            resp = tc.get("/stats")
            assert resp.status == 200
            stats = resp.json()
            assert any("GET /health" in k for k in stats)
            post_key = next(k for k in stats if k == "POST /collections")
            assert stats[post_key]["count"] == 1
            assert stats[post_key]["p50_ms"] >= 0

        http(go)

    def test_debug_trace_gated(self):
        def go(tc):
            resp = tc.post("/debug/trace")
            assert resp.status == 400
            assert "VECTORLITE_JAX_PROFILE_DIR" in (
                resp.json()
            )["message"]

        http(go)


class TestReviewRegressions:
    def test_k_out_of_contract_bounds_400(self):
        # contract: k in 1..1000 (reference: docs/openapi.yaml:624-630)
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            tc.post("/collections/c/text", json={"text": "x"})
            for bad_k in (0, -3, 1001):
                resp = tc.post(
                    "/collections/c/search/text",
                    json={"query": "x", "k": bad_k},
                )
                assert resp.status == 400, bad_k
                assert "between 1 and 1000" in (resp.json())["message"]
            resp = tc.post(
                "/collections/c/search/text", json={"query": "x", "k": 1000}
            )
            assert resp.status == 200

        http(go)

    def test_k_non_integer_400(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            resp = tc.post(
                "/collections/c/search/text",
                json={"query": "x", "k": "abc"},
            )
            assert resp.status == 400
            assert "integer" in (resp.json())["message"]

        http(go)

    def test_non_string_fields_400(self):
        """serde-typed DTO parity: the reference types text/query/name/
        index_type/file_path as String (src/server.rs:71-100), so a
        number/null/object body value is a reject, not a str() coercion."""
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            cases = [
                ("/collections", {"name": 7, "index_type": "flat"}),
                ("/collections", {"name": "x", "index_type": None}),
                ("/collections/c/text", {"text": 7}),
                ("/collections/c/text", {"text": None}),
                ("/collections/c/text", {"text": {"a": 1}}),
                ("/collections/c/search/text", {"query": 7}),
                ("/collections/c/search/text", {"query": ["q"]}),
                ("/collections/c/save", {"file_path": 7}),
                ("/collections/load", {"file_path": None}),
                (
                    "/collections/load",
                    {"file_path": "/tmp/x.vlc", "collection_name": 9},
                ),
                (
                    "/collections",
                    {"name": "m", "index_type": "flat", "metric": 0},
                ),
                (
                    "/collections",
                    {"name": "m", "index_type": "flat", "metric": None},
                ),
                (
                    "/collections/c/search/text",
                    {"query": "q", "similarity_metric": {"a": 1}},
                ),
            ]
            for path, body in cases:
                resp = tc.post(path, json=body)
                assert resp.status == 400, (path, body)
                msg = (resp.json())["message"]
                assert "must be a string" in msg, (path, body, msg)

        http(go)

    def test_vector_id_u64_bounds_400(self):
        """Path<u64> parity: negative or 2^64+ ids fail path parsing
        (400) rather than reading as absent ids (404)."""
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            # u64 FromStr parity: underscores, unicode digits, and
            # whitespace are Python int() quirks, not valid u64 text
            for bad in (
                "-1", str(1 << 64), "abc", "1e5", "1_0",
                "%D9%A1%D9%A0", "%205%20",
            ):
                resp = tc.get(f"/collections/c/vectors/{bad}")
                assert resp.status == 400, bad
            # leading '+' IS accepted by Rust's u64 FromStr
            resp = tc.get("/collections/c/vectors/+3")
            assert resp.status == 404
            # u64::MAX itself is a VALID id -> absent, 404
            resp = tc.get(
                f"/collections/c/vectors/{(1 << 64) - 1}"
            )
            assert resp.status == 404

        http(go)

    def test_search_empty_metric_string_400(self):
        """Option<String> parity: similarity_metric present-but-empty
        reaches parse and errors (reference: src/server.rs:264-266) —
        only create's #[serde(default)] metric treats "" as unset."""
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            resp = tc.post(
                "/collections/c/search/text",
                json={"query": "x", "similarity_metric": ""},
            )
            assert resp.status == 400
            assert "Invalid similarity metric" in (
                resp.json()
            )["message"]
            # absent and null still auto-detect
            for body in (
                {"query": "x"},
                {"query": "x", "similarity_metric": None},
            ):
                resp = tc.post(
                    "/collections/c/search/text", json=body
                )
                assert resp.status == 200, body
            # create still treats "" as unset
            resp = tc.post(
                "/collections",
                json={"name": "c2", "index_type": "flat", "metric": ""},
            )
            assert resp.status == 200

        http(go)

    def test_cors_preflight_and_error_headers(self):
        def go(tc):
            resp = tc.options("/collections/c/search/text")
            assert resp.status == 204
            assert resp.headers["Access-Control-Allow-Origin"] == "*"
            # CORS headers must also ride error responses
            resp = tc.get("/collections/missing")
            assert resp.status == 404
            assert resp.headers["Access-Control-Allow-Origin"] == "*"

        http(go)

    def test_add_texts_metadata_length_mismatch(self):
        import pytest

        from vectorlite_tpu_torch import IndexType

        client = make_client()
        client.create_collection("c", IndexType.FLAT)
        with pytest.raises(ValueError):
            client.add_texts_to_collection("c", ["a", "b"], [{"m": 1}])
        # no partial inserts
        assert client.get_collection_info("c").count == 0


class TestBatchedEndpoints:
    def test_add_and_search_texts(self):
        from vectorlite_tpu_torch import MockEmbeddingFunction, VectorLiteClient

        # hash-based mock: distinct texts get distinct embeddings
        client = VectorLiteClient(MockEmbeddingFunction(dimension=16), device="cpu")

        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            resp = tc.post(
                "/collections/c/texts",
                json={
                    "texts": ["a", "b", "c"],
                    "metadatas": [{"i": 0}, None, None],
                },
            )
            assert resp.status == 200
            assert (resp.json())["ids"] == [0, 1, 2]
            resp = tc.post(
                "/collections/c/search/texts",
                json={"queries": ["a", "c"], "k": 1},
            )
            assert resp.status == 200
            results = (resp.json())["results"]
            assert len(results) == 2
            assert results[0][0]["id"] == 0
            assert results[1][0]["id"] == 2

        http(go, client=client)

    def test_batch_validation(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            resp = tc.post(
                "/collections/c/texts", json={"texts": "not a list"}
            )
            assert resp.status == 400
            resp = tc.post(
                "/collections/c/texts",
                json={"texts": ["a", "b"], "metadatas": [1]},
            )
            assert resp.status == 400
            resp = tc.post(
                "/collections/c/search/texts",
                json={"queries": [1, 2]},
            )
            assert resp.status == 400

        http(go)


class TestRawVectorEndpoints:
    """Raw-vector extension routes: bulk precomputed-embedding insert +
    search-by-vector. Uses the module factory so test_server_mesh can
    route the whole class through the 8-device sharded client."""

    def test_add_and_search_roundtrip(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "r", "index_type": "flat"}
            )
            resp = tc.post(
                "/collections/r/vectors",
                json={
                    "vectors": [
                        {"values": [1.0, 0.0, 0.0], "text": "a",
                         "metadata": {"i": 0}},
                        {"values": [0.0, 1.0, 0.0], "text": "b"},
                        {"values": [0.0, 0.0, 1.0]},
                    ]
                },
            )
            assert resp.status == 200
            assert (resp.json())["ids"] == [0, 1, 2]
            resp = tc.post(
                "/collections/r/search/vector",
                json={"vector": [0.0, 1.0, 0.0], "k": 1},
            )
            assert resp.status == 200
            hit = (resp.json())["results"][0]
            assert hit["id"] == 1 and hit["text"] == "b"
            resp = tc.post(
                "/collections/r/search/vectors",
                json={"vectors": [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]],
                      "k": 1},
            )
            assert resp.status == 200
            rows = (resp.json())["results"]
            assert [row[0]["id"] for row in rows] == [2, 0]
            # where filter rides the same path
            resp = tc.post(
                "/collections/r/search/vector",
                json={"vector": [0.0, 1.0, 0.0], "k": 3,
                      "where": {"i": 0}},
            )
            assert [h["id"] for h in (resp.json())["results"]] == [0]

        http(go)

    def test_explicit_ids_and_conflicts(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "r", "index_type": "flat"}
            )
            body = {"vectors": [{"values": [0.5, 0.5, 0.0], "id": 77}]}
            resp = tc.post("/collections/r/vectors", json=body)
            assert resp.status == 200
            assert (resp.json())["ids"] == [77]
            resp = tc.post("/collections/r/vectors", json=body)
            assert resp.status == 409
            # auto ids continue past the explicit max
            resp = tc.post(
                "/collections/r/vectors",
                json={"vectors": [{"values": [0.0, 1.0, 0.0]}]},
            )
            assert (resp.json())["ids"] == [78]
            resp = tc.get("/collections/r/vectors/77")
            assert resp.status == 200
            got = (resp.json())["vector"]
            assert got["values"] == [0.5, 0.5, 0.0]

        http(go)

    def test_validation_statuses(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "r", "index_type": "flat"}
            )
            for body in (
                {"vectors": "nope"},
                {"vectors": [{"text": "no values"}]},
                {"vectors": [{"values": [1, "x", 3]}]},
                {"vectors": [{"values": [1, 2, 3], "id": 1},
                             {"values": [1, 2, 3]}]},  # mixed ids
                {"vectors": [{"values": [1, 2]}, {"values": [1, 2, 3]}]},
            ):
                resp = tc.post("/collections/r/vectors", json=body)
                assert resp.status == 400, body
                assert "message" in (resp.json())
            resp = tc.post(
                "/collections/r/search/vector", json={"vector": []}
            )
            assert resp.status == 400
            resp = tc.post(
                "/collections/nope/search/vectors",
                json={"vectors": [[1.0, 2.0, 3.0]]},
            )
            assert resp.status == 404

        http(go)


def test_body_size_limit_is_canonical_413(monkeypatch):
    """Over-size bodies must be a 413 with the {"message": ...} shape,
    not a misleading 400 "Invalid JSON body"; VECTORLITE_MAX_BODY_MB
    configures the cap (default 256 MiB — bulk routes carry multi-MB
    JSON)."""
    monkeypatch.setenv("VECTORLITE_MAX_BODY_MB", "0.001")

    def go(tc):
        resp = tc.post(
            "/collections/c/texts", json={"texts": ["x" * 10000]}
        )
        assert resp.status == 413
        assert "too large" in (resp.json())["message"]

    http(go)


def test_body_size_limit_invalid_env_falls_back(monkeypatch):
    """A cap of 0 would refuse every body and a negative one too; neither
    is a sane reading of VECTORLITE_MAX_BODY_MB=0/-1, so non-positive
    values fall back to the 256 MiB default (loudly, via a warning log),
    as in the JAX app."""
    for bad in ("0", "-1"):
        monkeypatch.setenv("VECTORLITE_MAX_BODY_MB", bad)

        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            resp = tc.post(
                "/collections/c/texts", json={"texts": ["x" * 10000]}
            )
            assert resp.status == 200  # normal body accepted

        http(go)


def test_flat_with_metric_allowed():
    # reference: metric is optional and unused for Flat collections
    def go(tc):
        resp = tc.post(
            "/collections",
            json={"name": "fm", "index_type": "flat", "metric": "euclidean"},
        )
        assert resp.status == 200
        # searches may still use any metric
        tc.post("/collections/fm/text", json={"text": "x"})
        resp = tc.post(
            "/collections/fm/search/text",
            json={"query": "x", "similarity_metric": "manhattan"},
        )
        assert resp.status == 200

    http(go)


class TestCompactRoute:
    def test_compact(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "cp", "index_type": "flat"}
            )
            for t in ("a", "b", "c"):
                tc.post("/collections/cp/text", json={"text": t})
            r = tc.post("/collections/cp/compact")
            assert r.status == 200
            assert (r.json())["reclaimed"] == 0
            tc.delete("/collections/cp/vectors/0")
            tc.delete("/collections/cp/vectors/1")
            r = tc.post("/collections/cp/compact")
            assert (r.json())["reclaimed"] == 2
            r = tc.post("/collections/nope/compact")
            assert r.status == 404
            body = r.json()
            assert "not found" in body["message"]

        http(go)


class TestApiKeyAuth:
    """Opt-in bearer-token auth (extension; the reference server is
    unauthenticated). Enabled via create_app(api_key=...) or
    $VECTORLITE_API_KEY; GET /health stays open for healthchecks."""

    def _app(self, key="sekrit"):
        return create_app(make_client(), api_key=key)

    def test_requires_key(self):
        def runner():
            with served(self._app()) as tc:
                # no credentials -> 401 with the canonical body
                resp = tc.get("/collections")
                assert resp.status == 401
                assert (resp.json())["message"] == (
                    "Invalid or missing API key"
                )
                # wrong key -> 401
                resp = tc.get(
                    "/collections",
                    headers={"Authorization": "Bearer nope"},
                )
                assert resp.status == 401
                # 401s still carry CORS headers (error middleware wraps)
                assert resp.headers["Access-Control-Allow-Origin"] == "*"
                # bearer works
                resp = tc.get(
                    "/collections",
                    headers={"Authorization": "Bearer sekrit"},
                )
                assert resp.status == 200
                # X-API-Key alternative works
                resp = tc.post(
                    "/collections",
                    json={"name": "c", "index_type": "flat"},
                    headers={"X-API-Key": "sekrit"},
                )
                assert resp.status == 200
                # writes really went through
                resp = tc.get(
                    "/collections", headers={"X-API-Key": "sekrit"}
                )
                assert (resp.json())["collections"] == ["c"]

        runner()

    def test_health_exempt_and_preflight_open(self):
        def runner():
            with served(self._app()) as tc:
                resp = tc.get("/health")
                assert resp.status == 200
                # CORS preflight must not demand credentials
                resp = tc.options("/collections")
                assert resp.status == 204

        runner()

    def test_env_var_enables(self, monkeypatch):
        monkeypatch.setenv("VECTORLITE_API_KEY", "envkey")

        def go(tc):
            resp = tc.get("/collections")
            assert resp.status == 401
            resp = tc.get(
                "/collections", headers={"Authorization": "Bearer envkey"}
            )
            assert resp.status == 200

        http(go)

    def test_default_is_open(self):
        # no key set anywhere -> reference behavior (no auth)
        def go(tc):
            resp = tc.get("/collections")
            assert resp.status == 200

        http(go)


class TestEfOverride:
    """Per-request HNSW beam width (extension): "ef" in any search
    body. 0 = reference-exact beam (min(k, len), reference:
    src/index/hnsw.rs:437-448); absent = the collection's configured
    ef_search; Flat accepts and ignores it (exact search trivially
    satisfies any recall request)."""

    def _mk(self, tc):
        return tc.post(
            "/collections",
            json={
                "name": "h",
                "index_type": "hnsw",
                "metric": "cosine",
            },
        )

    def test_ef_accepted_on_hnsw_and_flat(self):
        client = make_text_client()

        def go(tc):
            self._mk(tc)
            tc.post(
                "/collections", json={"name": "f", "index_type": "flat"}
            )
            for name in ("h", "f"):
                tc.post(
                    f"/collections/{name}/texts",
                    json={"texts": [f"doc {i}" for i in range(20)]},
                )
                for ef in (0, 4, 65536):
                    resp = tc.post(
                        f"/collections/{name}/search/text",
                        json={"query": "doc 3", "k": 3, "ef": ef},
                    )
                    assert resp.status == 200, (name, ef)
                    results = (resp.json())["results"]
                    assert results and results[0]["text"] == "doc 3"
            # batched + raw-vector routes take it too
            resp = tc.post(
                "/collections/h/search/texts",
                json={"queries": ["doc 1", "doc 2"], "k": 2, "ef": 8},
            )
            assert resp.status == 200
            assert len((resp.json())["results"]) == 2

        http(go, client=client)

    def test_ef_validation(self):
        def go(tc):
            self._mk(tc)
            for bad in (-1, 65537, True, 1.5, "8", {}):
                resp = tc.post(
                    "/collections/h/search/text",
                    json={"query": "x", "ef": bad},
                )
                assert resp.status == 400, bad
                assert (resp.json())["message"] == (
                    "Field ef must be an integer between 0 and 65536"
                )
            # null = absent (serde Option semantics)
            resp = tc.post(
                "/collections/h/search/text",
                json={"query": "x", "ef": None},
            )
            assert resp.status == 200

        http(go, client=make_text_client())


class TestMinScore:
    """Similarity floor (extension): "min_score" in any search body
    drops hits scoring below it — fewer than k results can return."""

    def test_min_score_filters(self):
        client = make_text_client()

        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            tc.post(
                "/collections/c/texts",
                json={"texts": ["alpha", "beta", "gamma"]},
            )
            # self-match scores ~1.0; others score well below
            resp = tc.post(
                "/collections/c/search/text",
                json={"query": "alpha", "k": 3, "min_score": 0.999},
            )
            results = (resp.json())["results"]
            assert [r["text"] for r in results] == ["alpha"]
            # floor above everything -> empty, not an error
            resp = tc.post(
                "/collections/c/search/text",
                json={"query": "alpha", "k": 3, "min_score": 1.5},
            )
            assert (resp.json())["results"] == []
            # negative floors pass everything (cosine can be negative)
            resp = tc.post(
                "/collections/c/search/text",
                json={"query": "alpha", "k": 3, "min_score": -10},
            )
            assert len((resp.json())["results"]) == 3
            # batched route honors it per row
            resp = tc.post(
                "/collections/c/search/texts",
                json={
                    "queries": ["alpha", "beta"],
                    "k": 3,
                    "min_score": 0.999,
                },
            )
            rows = (resp.json())["results"]
            assert [[r["text"] for r in row] for row in rows] == [
                ["alpha"],
                ["beta"],
            ]

        http(go, client=client)

    def test_min_score_validation(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            for bad in (True, "0.5", float("nan"), {}, []):
                body = {"query": "x", "min_score": bad}
                # NaN can't ride json.dumps by default; build raw
                import math

                if isinstance(bad, float) and math.isnan(bad):
                    raw = '{"query": "x", "min_score": NaN}'
                    resp = tc.post(
                        "/collections/c/search/text",
                        data=raw,
                        headers={"content-type": "application/json"},
                    )
                else:
                    resp = tc.post(
                        "/collections/c/search/text", json=body
                    )
                assert resp.status == 400, bad
                assert (resp.json())["message"] == (
                    "Field min_score must be a finite number"
                )
            # null = absent
            resp = tc.post(
                "/collections/c/search/text",
                json={"query": "x", "min_score": None},
            )
            assert resp.status == 200

        http(go, client=make_text_client())


class TestBulkGetByIds:
    """ids= on the listing route (extension): explicit-id bulk get,
    requested order, missing ids skipped, where/include_values honored."""

    def test_bulk_get(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            tc.post(
                "/collections/c/texts",
                json={
                    "texts": [f"t{i}" for i in range(6)],
                    "metadatas": [{"even": i % 2 == 0} for i in range(6)],
                },
            )
            resp = tc.get("/collections/c/vectors?ids=4,0,99,2")
            assert resp.status == 200
            body = resp.json()
            # requested order, missing 99 skipped
            assert [v["id"] for v in body["vectors"]] == [4, 0, 2]
            assert body["total"] == 3
            # values included by default on bulk get? include_values
            # governs it, same as listing
            assert body["vectors"][0]["values"] == []
            resp = tc.get(
                "/collections/c/vectors?ids=4,0,2&include_values=1"
            )
            body = resp.json()
            assert len(body["vectors"][0]["values"]) == 3
            # where post-filters
            import urllib.parse

            w = urllib.parse.quote('{"even": true}')
            resp = tc.get(
                f"/collections/c/vectors?ids=4,3,2,1&where={w}"
            )
            body = resp.json()
            assert [v["id"] for v in body["vectors"]] == [4, 2]

        http(go)

    def test_bulk_get_validation(self):
        def go(tc):
            tc.post(
                "/collections", json={"name": "c", "index_type": "flat"}
            )
            for bad in ("", "1,-2", "1,x", "1, 2", "1_0", "2**70",
                        str(1 << 64)):
                resp = tc.get(f"/collections/c/vectors?ids={bad}")
                assert resp.status == 400, bad
                assert "comma-separated" in (resp.json())["message"]
            resp = tc.get(
                "/collections/c/vectors?ids=" + ",".join(["1"] * 1001)
            )
            assert resp.status == 400
            resp = tc.get("/collections/missing/vectors?ids=1")
            assert resp.status == 404

        http(go)


# ----------------------------------------------------------------------
# The HTTP cases of tests/test_hybrid.py, test_raw_vectors.py,
# test_filter.py, test_observability.py, test_autosave.py and
# test_wal.py, against the port's server.

HYBRID_DOCS = [
    "the quick brown fox jumps",  # 0
    "lazy dogs sleep all day",  # 1
    "quick quick zebra runs",  # 2
    "an unrelated document entirely",  # 3
    "fox dens and fox cubs",  # 4
]


class TestHybridHttp:
    def _serve(self, fn):
        def go(tc):
            tc.post("/collections", json={"name": "h", "index_type": "flat"})
            tc.post("/collections/h/texts", json={"texts": HYBRID_DOCS})
            return fn(tc)

        return http(go, make_text_client())

    def test_route_happy_path(self):
        def go(tc):
            resp = tc.post(
                "/collections/h/search/hybrid",
                json={"query": "zebra", "k": 3, "alpha": 0.3},
            )
            assert resp.status == 200
            results = resp.json()["results"]
            assert any(r["text"] == HYBRID_DOCS[2] for r in results)
            for r in results:
                assert set(r) == {"id", "score", "text", "metadata"}

        self._serve(go)

    @pytest.mark.parametrize("body,frag", [
        ({"query": "x", "alpha": 2}, "alpha"),
        ({"query": "x", "alpha": True}, "alpha"),
        # a ~10^400 JSON int overflows float(): 400, not 500
        ({"query": "x", "alpha": 10 ** 400}, "alpha"),
        ({"query": "x", "pool": 0}, "pool"),
        ({"query": "x", "pool": "big"}, "pool"),
        ({"k": 3}, "query"),
    ])
    def test_route_validation(self, body, frag):
        def go(tc):
            resp = tc.post("/collections/h/search/hybrid", json=body)
            assert resp.status == 400, body
            assert frag in resp.json()["message"].lower()
            resp = tc.post("/collections/nope/search/hybrid", json={"query": "x"})
            assert resp.status == 404

        self._serve(go)


class TestRawVectorsHttp:
    def test_http_roundtrip(self):
        def go(tc):
            r = tc.post("/collections", json={"name": "c", "index_type": "flat"})
            assert r.status == 200
            r = tc.post("/collections/c/vectors", json={"vectors": [
                {"values": [1, 0, 0, 0], "text": "x", "metadata": {"m": 1}},
                {"values": [0, 1, 0, 0]},
            ]})
            assert r.status == 200 and r.json()["ids"] == [0, 1]
            # explicit id + GET by id
            r = tc.post("/collections/c/vectors",
                        json={"vectors": [{"values": [0, 0, 1, 0], "id": 42}]})
            assert r.json()["ids"] == [42]
            r = tc.get("/collections/c/vectors/42")
            assert r.status == 200
            assert r.json()["vector"]["values"] == [0.0, 0.0, 1.0, 0.0]
            # single raw search
            r = tc.post("/collections/c/search/vector",
                        json={"vector": [1, 0, 0, 0], "k": 1})
            hit = r.json()["results"][0]
            assert hit["id"] == 0 and hit["metadata"] == {"m": 1}
            # batched raw search
            r = tc.post("/collections/c/search/vectors",
                        json={"vectors": [[0, 1, 0, 0], [0, 0, 1, 0]], "k": 1})
            assert [row[0]["id"] for row in r.json()["results"]] == [1, 42]

        http(go, make_text_client(4))

    @pytest.mark.parametrize("body,frag", [
        ({"vectors": "nope"}, "list of objects"),
        ({"vectors": [{"text": "no values"}]}, "vectors[0].values"),
        ({"vectors": [{"values": [1, True, 3, 4]}]}, "array of numbers"),
        ({"vectors": [{"values": [1, 2, 3, 4], "id": -1}]}, "u64"),
        ({"vectors": [{"values": [1, 2, 3, 4], "text": 7}]}, "must be a string"),
        ({"vectors": [{"values": [1, 2, 3]}, {"values": [1, 2, 3, 4]}]},
         "share one dimension"),
    ])
    def test_http_validation(self, body, frag):
        def go(tc):
            tc.post("/collections", json={"name": "c", "index_type": "flat"})
            r = tc.post("/collections/c/vectors", json=body)
            assert r.status == 400, (body, r.text())
            assert frag in r.json()["message"], body
            # NaN literal: Python's json.loads accepts it, serde_json
            # rejects it; the route's posture matches serde
            r = tc.post("/collections/c/search/vector", data=b'{"vector": [NaN, 0, 0, 0]}',
                        headers={"content-type": "application/json"})
            assert r.status == 400 and "finite" in r.json()["message"]
            # dim mismatch against a non-empty index
            tc.post("/collections/c/vectors", json={"vectors": [{"values": [1, 0, 0, 0]}]})
            r = tc.post("/collections/c/search/vector", json={"vector": [1, 0]})
            assert r.status == 400

        http(go, make_text_client(4))


class TestFilteredHttp:
    def test_search_with_where(self):
        def go(tc):
            tc.post("/collections", json={"name": "c", "index_type": "flat"})
            for i, text in enumerate(["apple pie", "banana bread", "cherry"]):
                resp = tc.post("/collections/c/text", json={
                    "text": text, "metadata": {"kind": "fruit" if i < 2 else "other"}})
                assert resp.status == 200
            resp = tc.post("/collections/c/search/text", json={
                "query": "apple pie", "k": 10, "where": {"kind": "fruit"}})
            results = resp.json()["results"]
            assert {r["id"] for r in results} == {0, 1}
            assert all(r["metadata"]["kind"] == "fruit" for r in results)
            resp = tc.post("/collections/c/search/texts", json={
                "queries": ["apple pie", "cherry"], "where": {"kind": "other"}})
            batches = resp.json()["results"]
            assert [{r["id"] for r in b} for b in batches] == [{2}, {2}]

        http(go, make_text_client(8))

    def test_delete_where_route(self):
        def go(tc):
            tc.post("/collections", json={"name": "c", "index_type": "flat"})
            resp = tc.post("/collections/c/texts", json={
                "texts": [f"doc {i}" for i in range(6)],
                "metadatas": [{"p": i % 2} for i in range(6)],
            })
            assert resp.status == 200
            # where is required: a bare DELETE must never wipe
            assert tc.delete("/collections/c/vectors").status == 400
            assert tc.delete("/collections/c/vectors?where=[1]").status == 400
            assert tc.delete('/collections/c/vectors?where={"$oops":1}').status == 400
            resp = tc.delete('/collections/c/vectors?where={"p":1}')
            assert resp.status == 200 and resp.json()["deleted"] == 3
            body = tc.get("/collections/c/vectors").json()
            assert body["total"] == 3
            assert {v["id"] for v in body["vectors"]} == {0, 2, 4}
            assert tc.delete('/collections/c/vectors?where={"p":1}').json()["deleted"] == 0
            assert tc.delete('/collections/zz/vectors?where={"p":1}').status == 404
            assert tc.delete("/collections/c/vectors?where={}").json()["deleted"] == 3
            assert tc.get("/collections/c").json()["info"]["count"] == 0

        http(go, make_text_client(8))

    def test_patch_metadata_route(self):
        def go(tc):
            tc.post("/collections", json={"name": "c", "index_type": "flat"})
            tc.post("/collections/c/text", json={"text": "apple", "metadata": {"kind": "old"}})
            resp = tc.patch("/collections/c/vectors/0", json={"metadata": {"kind": "new"}})
            assert resp.status == 200 and resp.json()["id"] == 0
            resp = tc.post("/collections/c/search/text",
                           json={"query": "apple", "where": {"kind": "new"}})
            assert {r["id"] for r in resp.json()["results"]} == {0}
            assert tc.patch("/collections/c/vectors/0", json={"metadata": None}).status == 200
            assert tc.get("/collections/c/vectors/0").json()["vector"]["metadata"] is None
            assert tc.patch("/collections/c/vectors/0", json={}).status == 400
            assert tc.patch("/collections/c/vectors/99", json={"metadata": {}}).status == 404
            assert tc.patch("/collections/zz/vectors/0", json={"metadata": {}}).status == 404

        http(go, make_text_client(8))

    def test_list_vectors_route(self):
        def go(tc):
            tc.post("/collections", json={"name": "c", "index_type": "flat"})
            for i in range(5):
                tc.post("/collections/c/text", json={"text": f"d{i}", "metadata": {"p": i % 2}})
            resp = tc.get("/collections/c/vectors?limit=2&offset=1")
            body = resp.json()
            assert resp.status == 200 and body["total"] == 5
            assert [v["id"] for v in body["vectors"]] == [1, 2]
            assert body["vectors"][0]["values"] == []  # light by default
            body = tc.get('/collections/c/vectors?where={"p":1}&include_values=1').json()
            assert body["total"] == 2
            assert [v["id"] for v in body["vectors"]] == [1, 3]
            assert len(body["vectors"][0]["values"]) > 0
            assert tc.get("/collections/c/vectors?where=notjson").status == 400
            assert tc.get("/collections/c/vectors?limit=-1").status == 400

        http(go, make_text_client(8))

    def test_filter_stats_exposed(self):
        from vectorlite_tpu_torch.observability import filter_stats

        def go(tc):
            tc.post("/collections", json={"name": "c", "index_type": "flat"})
            tc.post("/collections/c/text", json={"text": "a", "metadata": {"t": 1}})
            before = filter_stats.snapshot()
            for _ in range(2):
                tc.post("/collections/c/search/text", json={"query": "a", "where": {"t": 1}})
            f = tc.get("/stats").json()["filters"]
            assert f["lookups"] >= before.get("lookups", 0) + 2
            assert f["full_builds"] >= 1 and f["cache_hits"] >= 1

        http(go, make_text_client(8))

    def test_where_errors(self):
        def go(tc):
            tc.post("/collections", json={"name": "c", "index_type": "flat"})
            resp = tc.post("/collections/c/search/text",
                           json={"query": "x", "where": "not-an-object"})
            assert resp.status == 400 and "Invalid filter" in resp.json()["message"]
            resp = tc.post("/collections/c/search/text",
                           json={"query": "x", "where": {"f": {"$bogus": 1}}})
            assert resp.status == 400
            assert resp.json()["message"].startswith("Invalid filter: unknown")

        http(go, make_text_client(8))


class TestObservabilityHttp:
    def test_http_scrape(self):
        def go(tc):
            tc.post("/collections", json={"name": "m", "index_type": "flat"})
            tc.post("/collections/m/text", json={"text": "hello"})
            resp = tc.get("/metrics")
            assert resp.status == 200
            assert resp.headers["Content-Type"] == "text/plain; charset=utf-8"
            body = resp.text()
            assert 'vectorlite_collection_vectors{collection="m"} 1' in body
            assert 'vectorlite_requests_total{route="POST /collections/{name}/text"} 1' in body

        http(go, VectorLiteClient(ConstantEmbeddingFunction([1.0, 2.0]), device="cpu"))

    def test_stats_keys_are_route_templates(self):
        """Samples are keyed "<METHOD> <route template>" (aiohttp's
        route.canonical); a request no route matched is keyed by its
        path."""
        def go(tc):
            tc.post("/collections", json={"name": "a b", "index_type": "flat"})
            tc.get("/collections/a%20b")
            tc.get("/collections/zz")
            tc.get("/nowhere")
            tc.head("/health")
            stats = tc.get("/stats").json()
            assert stats["GET /collections/{name}"]["count"] == 2
            assert stats["GET /nowhere"]["count"] == 1
            assert stats["HEAD /health"]["count"] == 1
            assert not [k for k in stats if k.startswith("OPTIONS")]

        http(go)

    def test_debug_trace_captures_a_chrome_trace(self, tmp_path, monkeypatch):
        """With VECTORLITE_JAX_PROFILE_DIR set, POST /debug/trace records
        the process with torch.profiler for ?seconds= and writes a Chrome
        trace there; a second capture while one runs is a 500."""
        import threading

        monkeypatch.setenv("VECTORLITE_JAX_PROFILE_DIR", str(tmp_path))

        def go(tc):
            tc.post("/collections", json={"name": "c", "index_type": "flat"})
            tc.post("/collections/c/texts", json={"texts": [f"t{i}" for i in range(20)]})
            out = {}
            other = SyncClient(tc.port)

            def capture():
                out["resp"] = other.post("/debug/trace?seconds=0.5")

            worker = threading.Thread(target=capture)
            worker.start()
            import time

            time.sleep(0.1)
            busy = tc.post("/debug/trace?seconds=0.1")
            for _ in range(5):
                tc.post("/collections/c/search/text", json={"query": "t3", "k": 2})
            worker.join(timeout=60)
            assert not worker.is_alive()
            other.close()
            resp = out["resp"]
            assert resp.status == 200 and resp.json() == {"trace_dir": str(tmp_path)}
            assert busy.status == 500 and "already running" in busy.json()["message"]
            traces = list(tmp_path.glob("trace_*.json"))
            assert len(traces) == 1
            assert "traceEvents" in _json.loads(traces[0].read_text())
            bad = tc.post("/debug/trace?seconds=soon")
            assert bad.status == 500 and bad.json()["message"].startswith(
                "Internal server error:")

        http(go, make_text_client())


class TestDurabilityHttp:
    def test_stats_exposes_autosave(self, tmp_path):
        from vectorlite_tpu_torch.store.autosave import AutosaveDaemon

        client = make_text_client()
        d = AutosaveDaemon(client, tmp_path, interval_s=60.0).start()
        with served(create_app(client, autosave=d)) as tc:
            body = tc.get("/stats").json()
        assert body["autosave"]["directory"] == str(tmp_path)
        assert body["autosave"]["interval_s"] == 60.0
        # closing the server ran d.stop(flush=True): the thread is gone
        assert d._thread is None

    def test_stats_and_metrics_expose_wal(self, tmp_path):
        from vectorlite_tpu_torch.store.wal import WalManager

        client = make_text_client()
        manager = WalManager(tmp_path / "wal")
        client.set_collection_observer(manager)
        with served(create_app(client, wal=manager)) as tc:
            tc.post("/collections", json={"name": "w", "index_type": "flat"})
            tc.post("/collections/w/text", json={"text": "x"})
            stats = tc.get("/stats").json()
            assert stats["wal"]["collections"]["w"]["appends"] >= 2
            assert 'vectorlite_wal_appends_total{collection="w"}' in tc.get("/metrics").text()

    def test_shutdown_flushes_autosave_then_closes_the_logs(self, tmp_path):
        """On close the autosave's final flush runs first, then the logs
        close, so the last checkpoint lands in an open log."""
        order = []

        class Autosave:
            def stats(self):
                return {}

            def stop(self, flush):
                order.append(("autosave", flush))

        class Wal:
            def stats(self):
                return {}

            def close(self):
                order.append(("wal",))

        with served(create_app(make_client(), autosave=Autosave(), wal=Wal())) as tc:
            assert tc.get("/health").status == 200
            assert order == []
        assert order == [("autosave", True), ("wal",)]


# ----------------------------------------------------------------------
# What the transport does in aiohttp's place.


class TestTransport:
    def test_keep_alive_serves_many_requests_on_one_connection(self):
        def go(tc):
            tc.post("/collections", json={"name": "c", "index_type": "flat"})
            sock = tc._conn.sock
            for i in range(20):
                assert tc.post("/collections/c/text", json={"text": f"t{i}"}).status == 200
                assert tc.get("/collections/nowhere/x").status == 404
            assert tc._conn.sock is sock
            assert tc.get("/collections/c").json()["info"]["count"] == 20

        http(go)

    def test_chunked_request_body(self):
        def go(tc):
            conn = HTTPConnection("127.0.0.1", tc.port, timeout=30)
            conn.request("POST", "/collections",
                         body=iter([b'{"name": "c", ', b'"index_type": "flat"}']),
                         headers={"Transfer-Encoding": "chunked"}, encode_chunked=True)
            resp = conn.getresponse()
            assert resp.status == 200 and _json.loads(resp.read()) == {"name": "c"}
            conn.close()
            assert tc.get("/collections").json()["collections"] == ["c"]

        http(go)

    def test_percent_encoded_names(self):
        def go(tc):
            for name in ("a/b", "sp ace", "pct%25", "ünï"):
                assert tc.post("/collections", json={"name": name, "index_type": "flat"}).status == 200
                quoted = urllib.parse.quote(name, safe="")
                assert tc.get(f"/collections/{quoted}").json()["info"]["name"] == name
                resp = tc.post(f"/collections/{quoted}/text", json={"text": "x"})
                assert resp.status == 200
            assert sorted(tc.get("/collections").json()["collections"]) == sorted(
                ["a/b", "sp ace", "pct%25", "ünï"])

        http(go)

    def test_head_and_unknown_methods(self):
        def go(tc):
            resp = tc.head("/health")
            assert resp.status == 200 and resp.read() == b""
            assert int(resp.headers["Content-Length"]) == len(
                tc.get("/health").read())
            resp = tc.request("BREW", "/health")
            assert resp.status == 405 and resp.headers["Allow"] == "GET,HEAD"
            resp = tc.request("BREW", "/nowhere")
            assert resp.status == 404

        http(go)

    def test_concurrent_requests_from_many_threads(self):
        """64 threads, each on its own connection, add and search at once;
        every write is acknowledged once and every search answers."""
        from concurrent.futures import ThreadPoolExecutor

        def go(tc):
            tc.post("/collections", json={"name": "c", "index_type": "flat"})

            def worker(w):
                own = SyncClient(tc.port)
                try:
                    ids = []
                    for i in range(5):
                        r = own.post("/collections/c/text", json={"text": f"w{w} t{i}"})
                        assert r.status == 200
                        ids.append(r.json()["id"])
                        r = own.post("/collections/c/search/text",
                                     json={"query": f"w{w} t{i}", "k": 1})
                        assert r.status == 200 and r.json()["results"]
                    return ids
                finally:
                    own.close()

            with ThreadPoolExecutor(max_workers=64) as pool:
                ids = [i for f in [pool.submit(worker, w) for w in range(64)] for i in f.result()]
            assert sorted(ids) == list(range(320))
            assert tc.get("/collections/c").json()["info"]["count"] == 320

        http(go, make_text_client())

    def test_large_body_past_the_cap_closes_without_reading_it(self, monkeypatch):
        """A Content-Length at or past the cap is refused before the body
        is read; the connection closes (an unread body cannot be skipped)
        and the next connection is served."""
        import socket

        monkeypatch.setenv("VECTORLITE_MAX_BODY_MB", "1")

        def go(tc):
            with socket.create_connection(("127.0.0.1", tc.port)) as sock:
                sock.sendall(b"POST /collections/c/text HTTP/1.1\r\nHost: x\r\n"
                             b"Content-Type: application/json\r\n"
                             b"Content-Length: 104857600\r\n\r\n" + b"{" * 1000)
                head = sock.recv(65536)
            assert head.startswith(b"HTTP/1.1 413 ")
            assert b"Connection: close" in head
            assert tc.get("/health").status == 200

        http(go)


@pytest.mark.cuda
def test_http_search_on_the_card(monkeypatch, tmp_path):
    """A 2^16-row collection on the card served over HTTP: a search/vectors
    batch (with a where filter: K1 with the mask) and a search/text answer
    as the SDK does, and K1 launched for them; a device trace taken while
    another thread's requests search names the port's kernel."""
    import threading

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the scan kernels are CUDA C++ and run only on an NVIDIA card")
    from vectorlite_tpu_torch.embed.mock import MockEmbeddingFunction
    from vectorlite_tpu_torch.index import flat
    from vectorlite_tpu_torch.kernels import _build, scan
    from vectorlite_tpu_torch.observability import capture_device_trace

    monkeypatch.setattr(flat, "_PALLAS_MIN_CAPACITY", 1 << 14)
    monkeypatch.setenv("VECTORLITE_JAX_PROFILE_DIR", str(tmp_path))
    rng = np.random.default_rng(12)
    rows = rng.standard_normal((1 << 16, 384)).astype(np.float32)
    emb = MockEmbeddingFunction(384)
    client = VectorLiteClient(emb)
    client.create_collection("c", "flat")
    client.add_vectors_to_collection("c", rows, metadatas=[{"b": i % 4} for i in range(len(rows))])
    queries = rng.standard_normal((64, 384)).round(6)
    where = {"b": {"$gte": 0}}
    k1 = {scan.SCAN_TOPK_EXACT_TF32.symbol, scan.SCAN_TOPK_EXACT.symbol}

    def launched():
        return {kern.symbol: kern.launches for kern in _build.KERNELS if kern.launches}

    with served(create_app(client)) as tc:
        _build.reset_launch_counts()
        resp = tc.post("/collections/c/search/vectors",
                       json={"vectors": queries.tolist(), "k": 10, "where": where})
        text = tc.post("/collections/c/search/text", json={"query": "card query", "k": 10})
        moved = launched()
        assert resp.status == 200 and text.status == 200
        assert set(moved) & k1, moved
        want = client.search_vectors_in_collection("c", queries, 10, where=where)
        want_text = client.search_text_in_collection("c", "card query", 10)
        for row, ref in zip(resp.json()["results"] + [text.json()["results"]],
                            want + [want_text]):
            np.testing.assert_allclose([h["score"] for h in row], [h.score for h in ref],
                                       rtol=1e-5, atol=1e-5)
            for got, exp in zip(row, ref):
                assert got["id"] == exp.id or abs(got["score"] - exp.score) <= 1e-5

        stop = threading.Event()

        def searching():
            own = SyncClient(tc.port)
            while not stop.is_set():
                own.post("/collections/c/search/vectors",
                         json={"vectors": queries[:8].tolist(), "k": 10, "where": where})
            own.close()

        worker = threading.Thread(target=searching)
        worker.start()
        try:
            trace_dir = capture_device_trace(1.0)
        finally:
            stop.set()
            worker.join(timeout=60)
    assert not worker.is_alive()
    (trace,) = list(tmp_path.glob("trace_*.json"))
    assert trace_dir == str(tmp_path)
    names = {ev.get("name", "") for ev in _json.loads(trace.read_text())["traceEvents"]}
    ours = _build.device_kernel_names()
    assert any(kern in name for name in names for kern in ours), sorted(names)[:50]
