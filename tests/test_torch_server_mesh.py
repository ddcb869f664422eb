"""The port's HTTP surface against a mesh-sharded client (VECTORLITE_MESH=8
on the CPU: 8 CPU shards), as tests/test_server_mesh.py holds the JAX one.

Re-runs the route suites of test_torch_server.py with every collection
made by its ``make_client`` / ``make_text_client`` factories sharded over
the mesh (HNSW collections get the mesh too), then holds sharded against
single-device results through HTTP, filtered routes and the ``pq``
profile on the mesh.
"""

import numpy as np
import pytest

import test_torch_server as ts
from test_torch_server import http
from vectorlite_tpu_torch import VectorLiteClient
from vectorlite_tpu_torch.api.server import create_app
from vectorlite_tpu_torch.config import VectorLiteConfig
from vectorlite_tpu_torch.embed.mock import (
    ConstantEmbeddingFunction,
    MockEmbeddingFunction,
)


def make_mesh_client(embedder=None, profile="default"):
    cfg = VectorLiteConfig.profile(profile)
    cfg.mesh_devices = 8
    return VectorLiteClient(
        embedder or ConstantEmbeddingFunction([1.0, 2.0, 3.0]), config=cfg, device="cpu"
    )


@pytest.fixture(autouse=True)
def _route_suite_through_mesh(monkeypatch):
    monkeypatch.setattr(ts, "make_client", make_mesh_client)
    monkeypatch.setattr(
        ts, "make_text_client", lambda dim=16: make_mesh_client(MockEmbeddingFunction(dim))
    )


# The single-device suites, every factory-made client sharded.
class TestHealthAndCollectionsMesh(ts.TestHealthAndCollections):
    pass


class TestVectorOpsMesh(ts.TestVectorOps):
    pass


class TestPersistenceApiMesh(ts.TestPersistenceApi):
    pass


class TestBatchedEndpointsMesh(ts.TestBatchedEndpoints):
    pass


class TestRawVectorEndpointsMesh(ts.TestRawVectorEndpoints):
    pass


class TestReviewRegressionsMesh(ts.TestReviewRegressions):
    pass


class TestCompactRouteMesh(ts.TestCompactRoute):
    pass


class TestEfOverrideMesh(ts.TestEfOverride):
    pass


class TestMinScoreMesh(ts.TestMinScore):
    pass


class TestBulkGetByIdsMesh(ts.TestBulkGetByIds):
    pass


class TestHybridHttpMesh(ts.TestHybridHttp):
    pass


class TestRawVectorsHttpMesh(ts.TestRawVectorsHttp):
    pass


class TestFilteredHttpMesh(ts.TestFilteredHttp):
    pass


class TestDurabilityHttpMesh(ts.TestDurabilityHttp):
    pass


def test_mesh_client_shards_its_collections():
    client = make_mesh_client(MockEmbeddingFunction(8))
    client.create_collection("f", "flat")
    client.create_collection("h", "hnsw", client_metric())
    mesh = client.mesh()
    assert mesh is not None and mesh.size == 8
    assert client.get_collection("f")._index._mesh is mesh
    assert client.get_collection("h")._index._mesh is mesh
    assert client.flat_index_kwargs()["mesh"] is mesh


def client_metric():
    from vectorlite_tpu_torch import SimilarityMetric

    return SimilarityMetric.COSINE


def test_sharded_matches_single_through_http():
    """Same corpus, same queries: the same ranked ids whether the
    collection is served from one device or sharded over eight."""
    texts = [f"document number {i} about topic {i % 13}" for i in range(97)]
    queries = ["topic 4 document", "number 55", "unrelated query text"]

    def run(client):
        def go(tc):
            assert tc.post("/collections", json={"name": "c", "index_type": "flat"}).status == 200
            assert tc.post("/collections/c/texts", json={"texts": texts}).status == 200
            out = []
            for q in queries:
                r = tc.post("/collections/c/search/text", json={"query": q, "k": 7})
                assert r.status == 200
                out.append(r.json()["results"])
            r = tc.post("/collections/c/search/texts", json={"queries": queries * 3, "k": 7})
            out += r.json()["results"]
            return out

        return http(go, client)

    embedder = MockEmbeddingFunction(dimension=24)
    single = run(VectorLiteClient(embedder, device="cpu"))
    sharded = run(make_mesh_client(embedder))
    assert len(single) == len(sharded) == 4 * len(queries)
    for s_row, m_row in zip(single, sharded):
        assert [h["id"] for h in s_row] == [h["id"] for h in m_row]
        # one query scans in f64 on the host on one device, in f32 per
        # shard on the mesh
        np.testing.assert_allclose([h["score"] for h in m_row], [h["score"] for h in s_row],
                                   rtol=1e-5, atol=1e-6)


def test_filtered_routes_on_mesh():
    """where filters, PATCH metadata, paged listing, PUT replacement and
    bulk delete-by-filter on a sharded collection."""

    def go(tc):
        tc.post("/collections", json={"name": "c", "index_type": "flat"})
        tc.post("/collections/c/texts", json={
            "texts": [f"doc {i}" for i in range(12)],
            "metadatas": [{"p": i % 3} for i in range(12)],
        })
        r = tc.post("/collections/c/search/text",
                    json={"query": "doc 4", "k": 12, "where": {"p": 1}})
        assert r.status == 200
        assert {h["id"] for h in r.json()["results"]} == {1, 4, 7, 10}
        assert tc.patch("/collections/c/vectors/1", json={"metadata": {"p": 9}}).status == 200
        r = tc.post("/collections/c/search/text",
                    json={"query": "doc 4", "k": 12, "where": {"p": 1}})
        assert {h["id"] for h in r.json()["results"]} == {4, 7, 10}
        body = tc.get('/collections/c/vectors?where={"p":9}').json()
        assert body["total"] == 1 and body["vectors"][0]["id"] == 1
        r = tc.put("/collections/c/vectors/2",
                   json={"text": "doc replaced", "metadata": {"p": 7}})
        assert r.status == 200
        hit = tc.post("/collections/c/search/text",
                      json={"query": "doc replaced", "k": 1}).json()["results"][0]
        assert hit["id"] == 2 and hit["metadata"] == {"p": 7}
        r = tc.delete('/collections/c/vectors?where={"p":{"$in":[0,2]}}')
        assert r.status == 200 and r.json()["deleted"] == 7
        r = tc.post("/collections/c/search/text", json={"query": "doc 4", "k": 12})
        assert {h["id"] for h in r.json()["results"]} == {1, 2, 4, 7, 10}

    http(go, make_mesh_client(MockEmbeddingFunction(24)))


def test_pq_profile_on_mesh_through_http(monkeypatch):
    """The product-quantization rung on a sharded collection, driven
    through HTTP: ingest past the PQ gate, search (per-shard ADC, the
    merge, the exact re-score), delete, search again."""
    monkeypatch.setenv("VECTORLITE_PQ_MIN_ROWS", "1024")
    monkeypatch.setenv("VECTORLITE_PQ_TRAIN_SAMPLE", "512")
    monkeypatch.setenv("VECTORLITE_HOST_SCAN_ROWS", "0")
    client = make_mesh_client(MockEmbeddingFunction(24), profile="pq")

    def go(tc):
        tc.post("/collections", json={"name": "c", "index_type": "flat"})
        r = tc.post("/collections/c/texts",
                    json={"texts": [f"doc number {i}" for i in range(1200)]})
        assert r.status == 200
        hit = tc.post("/collections/c/search/text",
                      json={"query": "doc number 123", "k": 1}).json()["results"][0]
        assert hit["id"] == 123 and hit["score"] > 0.999
        idx = client.get_collection("c")._index
        assert idx._pq and idx._pq_active and idx._mesh is not None
        assert len(idx._dev_codes) == 8
        assert tc.delete("/collections/c/vectors/123").status == 200
        r = tc.post("/collections/c/search/text", json={"query": "doc number 123", "k": 1})
        assert r.json()["results"][0]["id"] != 123

    http(go, client)


def test_hnsw_collection_on_mesh_through_http():
    """An HNSW collection on the mesh serves as on one device (the native
    host search), and its device beam runs over the shards."""
    client = make_mesh_client(MockEmbeddingFunction(16))
    one = VectorLiteClient(MockEmbeddingFunction(16), device="cpu")
    texts = [f"note {i} on subject {i % 5}" for i in range(64)]

    def go(tc):
        r = tc.post("/collections",
                    json={"name": "h", "index_type": "hnsw", "metric": "cosine"})
        assert r.status == 200
        assert tc.post("/collections/h/texts", json={"texts": texts}).status == 200
        r = tc.post("/collections/h/search/text", json={"query": "note 9", "k": 3, "ef": 0})
        return [h["id"] for h in r.json()["results"]]

    assert http(go, client) == http(go, one)
    index = client.get_collection("h")._index
    q = MockEmbeddingFunction(16).embed_batch_arrays(texts[:5])
    beam = index.search_batch(q, 3, client_metric(), ef=32, use_device=True)
    assert [r[0].id for r in beam] == [0, 1, 2, 3, 4]
