"""API-contract conformance of the port's server: walk every route/method
documented in docs/openapi.yaml against it and assert every observed
status is documented (and that the spec itself is served).

Counterpart of tests/test_contract.py. The reference ships
docs/openapi.yaml as the cross-implementation contract (reference:
docs/openapi.yaml:1-839; k bounds 1..1000 at 624-630). The port serves
it from docs/ or from its packaged copy,
vectorlite_tpu_torch/api/openapi.yaml. The scenario creates and searches
an HNSW collection too, as the JAX package's does.
"""

from pathlib import Path

import pytest
import yaml

from test_torch_server import served
from vectorlite_tpu_torch import VectorLiteClient
from vectorlite_tpu_torch.api.server import create_app
from vectorlite_tpu_torch.embed.mock import ConstantEmbeddingFunction

SPEC_PATH = Path(__file__).resolve().parents[1] / "docs" / "openapi.yaml"

#: scenario steps: (method, path-template, concrete path, json body,
#: expected status). Ordered — later steps depend on earlier state.
SCENARIO = [
    ("GET", "/health", "/health", None, 200),
    ("GET", "/collections", "/collections", None, 200),
    # create: ok, duplicate, invalid index_type, missing field
    ("POST", "/collections", "/collections",
     {"name": "c", "index_type": "flat"}, 200),
    ("POST", "/collections", "/collections",
     {"name": "c", "index_type": "flat"}, 409),
    ("POST", "/collections", "/collections",
     {"name": "x", "index_type": "btree"}, 400),
    # HNSW: the metric is required; a search in another metric is a 400
    ("POST", "/collections", "/collections",
     {"name": "h", "index_type": "hnsw"}, 400),
    ("POST", "/collections", "/collections",
     {"name": "h", "index_type": "hnsw", "metric": "cosine"}, 200),
    ("POST", "/collections/{name}/text", "/collections/h/text",
     {"text": "hello world"}, 200),
    ("POST", "/collections/{name}/search/text",
     "/collections/h/search/text", {"query": "hello", "k": 3, "ef": 16}, 200),
    ("POST", "/collections/{name}/search/text",
     "/collections/h/search/text",
     {"query": "hello", "similarity_metric": "euclidean"}, 400),
    ("GET", "/collections/{name}", "/collections/c", None, 200),
    ("GET", "/collections/{name}", "/collections/nope", None, 404),
    # add text: ok, missing field, missing collection
    ("POST", "/collections/{name}/text", "/collections/c/text",
     {"text": "hello world"}, 200),
    ("POST", "/collections/{name}/text", "/collections/c/text",
     {"wrong": 1}, 400),
    ("POST", "/collections/{name}/text", "/collections/nope/text",
     {"text": "hi"}, 404),
    # search: ok, k out of contract bounds (1..1000), missing collection
    ("POST", "/collections/{name}/search/text",
     "/collections/c/search/text", {"query": "hello", "k": 3}, 200),
    ("POST", "/collections/{name}/search/text",
     "/collections/c/search/text", {"query": "hello", "k": 0}, 400),
    ("POST", "/collections/{name}/search/text",
     "/collections/c/search/text", {"query": "hello", "k": 1001}, 400),
    ("POST", "/collections/{name}/search/text",
     "/collections/nope/search/text", {"query": "hello"}, 404),
    # batched extensions
    ("POST", "/collections/{name}/texts", "/collections/c/texts",
     {"texts": ["a", "b"]}, 200),
    ("POST", "/collections/{name}/texts", "/collections/c/texts",
     {"texts": "not-a-list"}, 400),
    ("POST", "/collections/{name}/texts", "/collections/nope/texts",
     {"texts": ["a"]}, 404),
    ("POST", "/collections/{name}/search/texts",
     "/collections/c/search/texts", {"queries": ["a", "b"], "k": 2}, 200),
    ("POST", "/collections/{name}/search/texts",
     "/collections/c/search/texts", {"queries": ["a"], "k": 9999}, 400),
    ("POST", "/collections/{name}/search/texts",
     "/collections/nope/search/texts", {"queries": ["a"]}, 404),
    # hybrid search extension
    ("POST", "/collections/{name}/search/hybrid",
     "/collections/c/search/hybrid",
     {"query": "hello", "k": 3, "alpha": 0.5}, 200),
    ("POST", "/collections/{name}/search/hybrid",
     "/collections/c/search/hybrid", {"query": "hello", "alpha": 7}, 400),
    ("POST", "/collections/{name}/search/hybrid",
     "/collections/nope/search/hybrid", {"query": "hello"}, 404),
    # raw-vector extensions: bulk add (auto ids, explicit ids, dup id,
    # bad values, mixed ids, missing collection)
    ("POST", "/collections/{name}/vectors", "/collections/c/vectors",
     {"vectors": [{"values": [1.0, 0.0, 0.0], "text": "raw"},
                  {"values": [0.0, 1.0, 0.0], "metadata": {"x": 1}}]}, 200),
    ("POST", "/collections/{name}/vectors", "/collections/c/vectors",
     {"vectors": [{"values": [0.5, 0.5, 0.0], "id": 500}]}, 200),
    ("POST", "/collections/{name}/vectors", "/collections/c/vectors",
     {"vectors": [{"values": [0.5, 0.5, 0.0], "id": 500}]}, 409),
    ("POST", "/collections/{name}/vectors", "/collections/c/vectors",
     {"vectors": [{"values": ["oops", 1, 2]}]}, 400),
    ("POST", "/collections/{name}/vectors", "/collections/c/vectors",
     {"vectors": [{"values": [1.0, 0.0, 0.0], "id": 501},
                  {"values": [0.0, 1.0, 0.0]}]}, 400),
    ("POST", "/collections/{name}/vectors", "/collections/nope/vectors",
     {"vectors": [{"values": [1.0, 2.0, 3.0]}]}, 404),
    # raw-vector search: single + batched
    ("POST", "/collections/{name}/search/vector",
     "/collections/c/search/vector", {"vector": [1.0, 0.0, 0.0], "k": 2},
     200),
    ("POST", "/collections/{name}/search/vector",
     "/collections/c/search/vector", {"vector": []}, 400),
    ("POST", "/collections/{name}/search/vector",
     "/collections/nope/search/vector", {"vector": [1.0, 0.0, 0.0]}, 404),
    ("POST", "/collections/{name}/search/vectors",
     "/collections/c/search/vectors",
     {"vectors": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], "k": 1}, 200),
    ("POST", "/collections/{name}/search/vectors",
     "/collections/c/search/vectors", {"vectors": [[1.0], [1.0, 2.0]]},
     400),
    ("POST", "/collections/{name}/search/vectors",
     "/collections/nope/search/vectors", {"vectors": [[1.0, 0.0, 0.0]]},
     404),
    # observability extensions
    ("GET", "/stats", "/stats", None, 200),
    ("GET", "/metrics", "/metrics", None, 200),
    ("POST", "/debug/trace", "/debug/trace", None, 400),  # env unset
    ("GET", "/openapi.yaml", "/openapi.yaml", None, 200),
    # compact extension
    ("POST", "/collections/{name}/compact", "/collections/c/compact",
     None, 200),
    ("POST", "/collections/{name}/compact", "/collections/nope/compact",
     None, 404),
    # listing extension: ok, filtered, bad limit, missing collection
    ("GET", "/collections/{name}/vectors",
     "/collections/c/vectors?limit=2", None, 200),
    ("GET", "/collections/{name}/vectors",
     "/collections/c/vectors?where=%7B%22x%22%3A1%7D", None, 200),
    ("GET", "/collections/{name}/vectors",
     "/collections/c/vectors?limit=9999", None, 400),
    ("GET", "/collections/{name}/vectors",
     "/collections/nope/vectors", None, 404),
    # vectors: ok + missing
    ("GET", "/collections/{name}/vectors/{id}",
     "/collections/c/vectors/0", None, 200),
    ("GET", "/collections/{name}/vectors/{id}",
     "/collections/c/vectors/12345", None, 404),
    # metadata update extension: ok, missing field, missing vector
    ("PATCH", "/collections/{name}/vectors/{id}",
     "/collections/c/vectors/0", {"metadata": {"k": "v"}}, 200),
    ("PATCH", "/collections/{name}/vectors/{id}",
     "/collections/c/vectors/0", {"wrong": 1}, 400),
    ("PATCH", "/collections/{name}/vectors/{id}",
     "/collections/c/vectors/12345", {"metadata": None}, 404),
    # full replacement extension: ok, missing text, missing vector
    ("PUT", "/collections/{name}/vectors/{id}",
     "/collections/c/vectors/0", {"text": "replaced"}, 200),
    ("PUT", "/collections/{name}/vectors/{id}",
     "/collections/c/vectors/0", {"metadata": {"no": "text"}}, 400),
    ("PUT", "/collections/{name}/vectors/{id}",
     "/collections/c/vectors/12345", {"text": "x"}, 404),
    # bulk delete-by-filter extension: no-match ok, missing where, 404
    ("DELETE", "/collections/{name}/vectors",
     "/collections/c/vectors?where=%7B%22x%22%3A1%7D", None, 200),
    ("DELETE", "/collections/{name}/vectors",
     "/collections/c/vectors", None, 400),
    ("DELETE", "/collections/{name}/vectors",
     "/collections/nope/vectors?where=%7B%7D", None, 404),
    ("DELETE", "/collections/{name}/vectors/{id}",
     "/collections/c/vectors/0", None, 200),
    ("DELETE", "/collections/{name}/vectors/{id}",
     "/collections/nope/vectors/0", None, 404),
    # save / load (paths patched in at runtime)
    ("POST", "/collections/{name}/save", "/collections/c/save",
     {"file_path": "__TMP__/c.vlc"}, 200),
    ("POST", "/collections/{name}/save", "/collections/nope/save",
     {"file_path": "__TMP__/nope.vlc"}, 404),
    ("POST", "/collections/load", "/collections/load",
     {"file_path": "__TMP__/missing.vlc"}, 404),
    ("POST", "/collections/load", "/collections/load",
     {"file_path": "__TMP__/c.vlc"}, 409),  # name "c" already exists
    ("POST", "/collections/load", "/collections/load",
     {"file_path": "__TMP__/c.vlc", "collection_name": "c2"}, 200),
    # snapshot-over-HTTP extension: download (ok + 404), restore
    # ("__SNAPSHOT__" = the bytes captured from the GET above: 409 on
    # an existing name, 200 restored-as, 500 on a garbage document)
    ("GET", "/collections/{name}/snapshot", "/collections/c/snapshot",
     None, 200),
    ("GET", "/collections/{name}/snapshot", "/collections/nope/snapshot",
     None, 404),
    ("POST", "/collections/{name}/snapshot", "/collections/c/snapshot",
     "__SNAPSHOT__", 409),
    ("POST", "/collections/{name}/snapshot", "/collections/c3/snapshot",
     "__SNAPSHOT__", 200),
    ("POST", "/collections/{name}/snapshot", "/collections/bad/snapshot",
     b"{not a snapshot", 500),
    ("DELETE", "/collections/{name}", "/collections/c", None, 200),
    ("DELETE", "/collections/{name}", "/collections/c", None, 404),
]


@pytest.fixture(scope="module")
def spec():
    return yaml.safe_load(SPEC_PATH.read_text())


def documented(spec):
    """{(path-template, METHOD): {documented statuses}}"""
    out = {}
    for path, item in spec["paths"].items():
        for method, op in item.items():
            if method in ("get", "post", "delete", "put", "patch"):
                out[(path, method.upper())] = {
                    int(s) for s in op.get("responses", {})
                }
    return out


def test_every_documented_route_conforms(spec, tmp_path):
    routes = documented(spec)
    exercised = {}

    def go():
        app = create_app(
            VectorLiteClient(ConstantEmbeddingFunction([1.0, 2.0, 3.0]), device="cpu")
        )
        with served(app) as tc:
            snapshot_doc = b""
            for method, template, path, body, want in SCENARIO:
                if body == "__SNAPSHOT__" or isinstance(
                    body, (bytes, bytearray)
                ):
                    raw = snapshot_doc if body == "__SNAPSHOT__" else body
                    resp = tc.request(method, path, data=raw)
                else:
                    if body:
                        body = {
                            k: (v.replace("__TMP__", str(tmp_path))
                                if isinstance(v, str) else v)
                            for k, v in body.items()
                        }
                    resp = tc.request(method, path, json=body)
                if (
                    method == "GET"
                    and template.endswith("/snapshot")
                    and resp.status == 200
                ):
                    snapshot_doc = resp.read()
                assert resp.status == want, (
                    f"{method} {path}: got {resp.status}, want {want}: "
                    f"{resp.text()}"
                )
                # error bodies must carry the {"message": ...} shape
                if resp.status >= 400:
                    payload = resp.json()
                    assert "message" in payload, (method, path)
                exercised.setdefault((template, method), set()).add(want)

    go()

    # every documented (route, method) is exercised ...
    missing = set(routes) - set(exercised)
    assert not missing, f"routes never exercised: {missing}"
    # ... and every status we observed is documented for that route
    for key, statuses in exercised.items():
        undocumented = statuses - routes[key]
        assert not undocumented, (
            f"{key}: observed {undocumented} not in spec {routes[key]}"
        )


def test_spec_is_served():
    def go():
        app = create_app(
            VectorLiteClient(ConstantEmbeddingFunction([1.0, 2.0, 3.0]), device="cpu")
        )
        with served(app) as tc:
            resp = tc.get("/openapi.yaml")
            assert resp.status == 200
            assert "yaml" in resp.headers["Content-Type"]
            body = yaml.safe_load(resp.text())
            assert body["openapi"].startswith("3.")
            assert "/collections/{name}/search/text" in body["paths"]

    go()


def test_spec_k_bounds_match_server():
    """The served contract's k bounds are the enforced bounds."""
    from vectorlite_tpu_torch.api.server import K_MAX, K_MIN

    spec_obj = yaml.safe_load(SPEC_PATH.read_text())
    search = spec_obj["paths"]["/collections/{name}/search/text"]["post"]
    schema = search["requestBody"]["content"]["application/json"]["schema"]
    k_schema = schema["properties"]["k"]
    assert k_schema["minimum"] == K_MIN
    assert k_schema["maximum"] == K_MAX


def test_packaged_spec_matches_docs_copy():
    """The wheel ships vectorlite_tpu_torch/api/openapi.yaml so
    /openapi.yaml works outside a source checkout; it must stay
    byte-identical to the repo contract in docs/."""
    root = Path(__file__).parent.parent
    docs = (root / "docs" / "openapi.yaml").read_bytes()
    packaged = (root / "vectorlite_tpu_torch" / "api" / "openapi.yaml").read_bytes()
    assert docs == packaged


def test_packaged_spec_is_served_outside_a_checkout(monkeypatch, tmp_path):
    """Without docs/ two levels above the package the route serves the
    copy beside the module; with neither it is a 404."""
    import shutil

    from vectorlite_tpu_torch.api import server

    api = tmp_path / "site" / "pkg" / "api"
    api.mkdir(parents=True)
    monkeypatch.setattr(server, "_spec_cache", None)
    monkeypatch.setattr(server, "__file__", str(api / "server.py"))
    assert server._openapi_spec_text() is None
    packaged = Path(__file__).parent.parent / "vectorlite_tpu_torch" / "api" / "openapi.yaml"
    shutil.copy(packaged, api / "openapi.yaml")
    assert server._openapi_spec_text() == packaged.read_text(encoding="utf-8")


def test_batch_route_k_bounds_declared():
    """The served spec must declare the same 1..1000 k bounds the server
    enforces on the batched search route (it already did for the single
    route). The inline-map k schema is unique to the batched route."""
    from pathlib import Path

    spec = (
        Path(__file__).parent.parent / "docs" / "openapi.yaml"
    ).read_text()
    assert (
        "k: {type: integer, default: 10, minimum: 1, maximum: 1000}"
        in spec
    ), "batched route k lost its bounds"
