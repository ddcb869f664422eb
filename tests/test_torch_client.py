"""The port's SDK client against the JAX client on the same texts and
vectors: identical mock embeddings, identical search results."""

import numpy as np
import pytest

import vectorlite_tpu as jv
import vectorlite_tpu_torch as tv
from vectorlite_tpu_torch.errors import VectorLiteError

TEXTS = [f"document number {i} about topic {i % 7}" for i in range(40)]


def make_clients():
    j = jv.VectorLiteClient(jv.MockEmbeddingFunction(384))
    t = tv.VectorLiteClient(tv.MockEmbeddingFunction(384), device="cpu")
    for client, m in ((j, jv), (t, tv)):
        client.create_collection("docs", m.IndexType.FLAT)
        client.add_texts_to_collection(
            "docs", TEXTS, [{"topic": i % 7} for i in range(len(TEXTS))]
        )
        client.add_text_to_collection("docs", "one more text", {"topic": 99})
    return j, t


class hits:
    """Search hits for comparison: ids, texts and metadata exactly,
    scores within 1e-5 (batches of more than four queries score in f32
    on the device path)."""

    def __init__(self, rows):
        self.keys = [(h.id, h.text, h.metadata) for h in rows]
        self.scores = np.array([h.score for h in rows])

    def __eq__(self, other):
        return self.keys == other.keys and np.allclose(
            self.scores, other.scores, rtol=1e-5, atol=1e-5
        )


def test_mock_embeddings_identical():
    a = jv.MockEmbeddingFunction(384)
    b = tv.MockEmbeddingFunction(384)
    for text in ("hello", "", "topic 3"):
        assert a.generate_embedding(text) == b.generate_embedding(text)
    assert np.array_equal(
        a.embed_batch_arrays(TEXTS[:5]), b.embed_batch_arrays(TEXTS[:5])
    )


def test_client_flat_round_trip_matches_jax():
    j, t = make_clients()
    for q in ("topic 3", "document number 12"):
        assert hits(j.search_text_in_collection("docs", q, 5)) == hits(
            t.search_text_in_collection("docs", q, 5)
        )
    assert [hits(r) for r in j.search_texts_in_collection("docs", TEXTS[:6], 4)] == [
        hits(r) for r in t.search_texts_in_collection("docs", TEXTS[:6], 4)
    ]
    emb = jv.MockEmbeddingFunction(384)
    queries = emb.embed_batch_arrays(TEXTS[10:18])
    assert [hits(r) for r in j.search_vectors_in_collection("docs", queries, 3)] == [
        hits(r) for r in t.search_vectors_in_collection("docs", queries, 3)
    ]
    where = {"topic": 3}
    assert hits(j.search_text_in_collection("docs", "topic 3", 4, where=where)) == hits(
        t.search_text_in_collection("docs", "topic 3", 4, where=where)
    )
    for client in (j, t):
        client.delete_from_collection("docs", 3)
        client.delete_from_collection("docs", 12345)  # absent ids succeed
    assert hits(j.search_text_in_collection("docs", TEXTS[3], 3)) == hits(
        t.search_text_in_collection("docs", TEXTS[3], 3)
    )
    assert t.get_vector_from_collection("docs", 3) is None
    jvv = j.get_vector_from_collection("docs", 4)
    tvv = t.get_vector_from_collection("docs", 4)
    assert (jvv.id, jvv.values, jvv.text, jvv.metadata) == (
        tvv.id, tvv.values, tvv.text, tvv.metadata
    )
    assert t.get_collection_info("docs").to_json() == j.get_collection_info(
        "docs"
    ).to_json()
    assert t.compact_collection("docs") == 1
    j.delete_collection("docs")  # stops the JAX client's coalescer thread


def test_add_vectors_explicit_ids():
    t = tv.VectorLiteClient(tv.MockEmbeddingFunction(8), device="cpu")
    t.create_collection("v", "flat")
    ids = t.add_vectors_to_collection("v", np.eye(8), ids=list(range(100, 108)))
    assert ids == list(range(100, 108))
    assert t.add_texts_to_collection("v", ["x"]) == [108]
    hit = t.search_vector_in_collection("v", np.eye(8)[2], 1)[0]
    assert hit.id == 102 and hit.score == pytest.approx(1.0)


def test_hnsw_collections_match_jax():
    """The HNSW branch: an explicit metric is required, the profile's
    graph settings reach the index, and texts search as in the JAX
    client."""
    t = tv.VectorLiteClient(tv.MockEmbeddingFunction(8), device="cpu",
                            config=tv.VectorLiteConfig.profile("memory-optimized"))
    j = jv.VectorLiteClient(jv.MockEmbeddingFunction(8),
                            config=jv.VectorLiteConfig.profile("memory-optimized"))
    with pytest.raises(VectorLiteError, match="explicit similarity metric"):
        t.create_collection("h", tv.IndexType.HNSW)
    for client, m in ((t, tv), (j, jv)):
        client.create_collection("h", "HNSW", m.SimilarityMetric.EUCLIDEAN)
        client.add_texts_to_collection("h", [f"text {i}" for i in range(50)])
    index = t.get_collection("h")._index
    assert (index.index_type, index.m, index.m0, index.device.type) == ("HNSW", 8, 16, "cpu")
    assert t.get_collection("h").detected_metric() is tv.SimilarityMetric.EUCLIDEAN
    got = t.search_text_in_collection("h", "text 7", 5, ef=0)
    want = j.search_text_in_collection("h", "text 7", 5, ef=0)
    assert [(h.id, h.text) for h in got] == [(h.id, h.text) for h in want]
    assert [h.score for h in got] == pytest.approx([h.score for h in want], abs=1e-5)


def test_mesh_is_refused(monkeypatch):
    monkeypatch.setenv("VECTORLITE_MESH", "2")
    t = tv.VectorLiteClient(tv.MockEmbeddingFunction(8), device="cpu")
    with pytest.raises(ValueError, match="VECTORLITE_MESH"):
        t.create_collection("m", "flat")


def test_search_steps_show_in_a_profiler_trace():
    import torch

    t = tv.VectorLiteClient(tv.MockEmbeddingFunction(8), device="cpu")
    t.create_collection("p", "flat")
    t.add_vectors_to_collection("p", np.eye(8))
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]
    ) as prof:
        t.search_vectors_in_collection("p", np.eye(8)[:2], 1)
    assert "vectorlite.index.search_batch" in {e.name for e in prof.events()}
