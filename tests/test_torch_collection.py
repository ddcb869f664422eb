"""The port's collection surface against the JAX package's on the same
seeded texts, vectors and metadata: bulk mutations, listing, gets,
hybrid search, the mutation counter, every ``*_in_collection`` method and
the search coalescer (the cases of tests/test_coalesce.py,
test_hybrid.py and test_concurrency.py).

Scores are held within 1e-5: batches of more than four queries score in
f32 on the device path (of either package), the host scan in f64."""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import vectorlite_tpu as jv
import vectorlite_tpu_torch as tv
from vectorlite_tpu_torch.errors import EmbeddingError, InvalidFilter, VectorNotFound
from vectorlite_tpu_torch.observability import coalesce_stats
from vectorlite_tpu_torch.store.coalesce import MAX_BATCH, SearchCoalescer

DIM = 32
N = 300
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]


def corpus(seed=0):
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 7)))) + f" n{i}"
             for i in range(N)]
    metas = [{"bucket": i % 6, "tag": str(rng.choice(["x", "y", "z"]))} for i in range(N)]
    return texts, metas


def make_clients(dim=DIM, seed=0):
    texts, metas = corpus(seed)
    j = jv.VectorLiteClient(jv.MockEmbeddingFunction(dim))
    t = tv.VectorLiteClient(tv.MockEmbeddingFunction(dim), device="cpu")
    for client, m in ((j, jv), (t, tv)):
        client.create_collection("c", m.IndexType.FLAT)
        client.add_texts_to_collection("c", texts, metas)
    return j, t


def close(*clients):
    for client in clients:
        for name in client.list_collections():
            client.delete_collection(name)  # stops the coalescer threads


def keys(rows):
    return [(h.id, h.text, h.metadata) for h in rows]


def assert_hits_equal(a, b):
    assert keys(a) == keys(b)
    np.testing.assert_allclose([h.score for h in a], [h.score for h in b],
                               rtol=1e-5, atol=1e-5)


def vec_keys(vectors):
    return [(v.id, v.text, v.metadata, list(v.values)) for v in vectors]


@pytest.mark.parametrize("where", [{"bucket": 2}, {"tag": {"$in": ["x", "z"]}},
                                   {"$and": [{"bucket": {"$gte": 3}}, {"tag": "y"}]}, {}],
                         ids=["eq", "in", "and", "all"])
def test_delete_where_matches_jax(where):
    j, t = make_clients()
    n = j.delete_where_in_collection("c", where)
    assert t.delete_where_in_collection("c", where) == n
    assert t.get_collection_info("c").count == j.get_collection_info("c").count == N - n
    assert vec_keys(t.list_vectors_in_collection("c", 0, N)[0]) == vec_keys(
        j.list_vectors_in_collection("c", 0, N)[0])
    assert t.delete_where_in_collection("c", where) == 0  # nothing left to match
    with pytest.raises(InvalidFilter):
        t.delete_where_in_collection("c", {"bucket": {"$nope": 1}})
    close(j, t)


@pytest.mark.parametrize("offset, limit, where, values", [
    (0, 10, None, False), (37, 50, None, True), (290, 100, None, False),
    (0, 100, {"bucket": 1}, False), (20, 7, {"tag": "y"}, True), (1000, 5, None, False),
    (0, 0, {"bucket": 5}, False),
], ids=["first", "values", "tail", "where", "where-values", "past-end", "empty-page"])
def test_list_vectors_pages_match_jax(offset, limit, where, values):
    j, t = make_clients()
    for client in (j, t):
        client.delete_from_collection("c", 40)
        client.delete_where_in_collection("c", {"bucket": 4})
    jp, jtotal = j.list_vectors_in_collection("c", offset, limit, where, values)
    tp, ttotal = t.list_vectors_in_collection("c", offset, limit, where, values)
    assert ttotal == jtotal
    assert vec_keys(tp) == vec_keys(jp)
    close(j, t)


def test_updates_then_filtered_search_match_jax():
    j, t = make_clients()
    queries = ["alpha beta", "zeta n3", "theta gamma gamma"]
    for client in (j, t):
        for vid in range(0, N, 7):
            client.update_metadata_in_collection("c", vid, {"bucket": 9, "moved": True})
        client.update_metadata_in_collection("c", 8, None)
        client.update_text_in_collection("c", 5, "rewritten alpha text", {"bucket": 9})
        client.update_text_in_collection("c", 6, "no metadata now")
    for where in ({"bucket": 9}, {"moved": {"$exists": True}}, {"bucket": {"$ne": 9}}):
        for q in queries:
            assert_hits_equal(t.search_text_in_collection("c", q, 8, where=where),
                              j.search_text_in_collection("c", q, 8, where=where))
        assert_hits_equal_rows(t.search_texts_in_collection("c", queries * 3, 5, where=where),
                               j.search_texts_in_collection("c", queries * 3, 5, where=where))
    assert t.get_vector_from_collection("c", 8).metadata is None
    moved = t.get_vector_from_collection("c", 5)
    assert (moved.text, moved.metadata) == ("rewritten alpha text", {"bucket": 9})
    assert t.get_vector_from_collection("c", 6).metadata is None
    # a rewritten record moves to the end of insertion order, as in JAX
    assert [v.id for v in t.list_vectors_in_collection("c", N - 2, 5)[0]] == [
        v.id for v in j.list_vectors_in_collection("c", N - 2, 5)[0]] == [5, 6]
    with pytest.raises(VectorNotFound):
        t.update_metadata_in_collection("c", 10_000, {})
    with pytest.raises(VectorNotFound):
        t.update_text_in_collection("c", 10_000, "x")
    close(j, t)


def assert_hits_equal_rows(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert_hits_equal(ra, rb)


@pytest.mark.parametrize("where, values", [(None, True), (None, False), ({"tag": "x"}, True)],
                         ids=["values", "no-values", "where"])
def test_get_vectors_order_and_missing_match_jax(where, values):
    j, t = make_clients()
    for client in (j, t):
        client.delete_from_collection("c", 17)
    ids = [250, 3, 17, 99_999, 3, 0, 42]
    got = t.get_vectors_from_collection("c", ids, where, values)
    assert vec_keys(got) == vec_keys(j.get_vectors_from_collection("c", ids, where, values))
    if where is None:
        assert [v.id for v in got] == [250, 3, 3, 0, 42]
    close(j, t)


@pytest.mark.parametrize("alpha, pool, where", [
    (0.5, None, None), (0.0, None, None), (1.0, None, None), (0.3, 7, None),
    (0.5, None, {"bucket": 3}), (0.8, 64, {"tag": {"$ne": "y"}}),
], ids=["default", "bm25-only", "dense-only", "pool7", "where", "pool64-where"])
def test_search_hybrid_matches_jax(alpha, pool, where):
    j, t = make_clients()
    for q in ("alpha beta", "gamma n12", "zeta zeta eta", "nothing matches this"):
        got = t.search_hybrid_in_collection("c", q, 6, where=where, alpha=alpha, pool=pool)
        want = j.search_hybrid_in_collection("c", q, 6, where=where, alpha=alpha, pool=pool)
        assert keys(got) == keys(want)
        # RRF scores are sums of 1/(60 + rank): exact once the ranks agree
        assert [h.score for h in got] == [h.score for h in want]
        assert all(h.score <= 2 / 61 for h in got)
    close(j, t)


def test_hybrid_sidecar_follows_mutations_like_jax():
    j, t = make_clients()
    q = "alpha unique-term"
    for client in (j, t):
        client.search_hybrid_in_collection("c", q, 5)  # builds the sidecar
        client.add_text_to_collection("c", "a unique-term document", {"bucket": 1})
        client.add_vectors_to_collection("c", np.ones((2, DIM)))  # empty texts
        client.update_text_in_collection("c", 11, "unique-term again", None)
        client.delete_from_collection("c", 12)
    assert t.get_collection("c")._bm25 is not None
    assert_hits_equal(t.search_hybrid_in_collection("c", q, 8),
                      j.search_hybrid_in_collection("c", q, 8))
    for client in (j, t):
        client.delete_where_in_collection("c", {"bucket": 1})
    assert t.get_collection("c")._bm25 is None  # dropped; rebuilt on demand
    assert_hits_equal(t.search_hybrid_in_collection("c", q, 8),
                      j.search_hybrid_in_collection("c", q, 8))
    with pytest.raises(ValueError, match="alpha"):
        t.search_hybrid_in_collection("c", q, 3, alpha=1.5)
    assert t.search_hybrid_in_collection("c", q, 0) == []
    assert t.search_hybrid_in_collection("c", q, 4, min_score=1.0) == []
    close(j, t)


def test_mutation_count_matches_jax():
    j, t = make_clients()
    steps = [
        lambda c: c.add_text_to_collection("c", "one more"),
        lambda c: c.add_texts_to_collection("c", ["x", "y"]),
        lambda c: c.add_texts_to_collection("c", []),  # no-op
        lambda c: c.add_vectors_to_collection("c", np.ones((3, DIM))),
        lambda c: c.delete_from_collection("c", 1),
        lambda c: c.delete_where_in_collection("c", {"bucket": 2}),
        lambda c: c.delete_where_in_collection("c", {"bucket": 2}),  # matches nothing
        lambda c: c.update_metadata_in_collection("c", 3, {"k": 1}),
        lambda c: c.update_text_in_collection("c", 4, "new"),
        lambda c: c.get_collection("c").compact(),
        lambda c: c.get_collection("c").compact(),  # nothing to reclaim
        lambda c: c.search_text_in_collection("c", "alpha", 3),  # reads do not count
    ]
    for step in steps:
        step(j)
        step(t)
        assert (t.get_collection("c").mutation_count()
                == j.get_collection("c").mutation_count())
    assert t.get_collection("c").mutation_count() > 50
    close(j, t)


def test_ef_is_accepted_and_ignored_by_flat():
    j, t = make_clients()
    for ef in (None, 0, 16, 400):
        assert_hits_equal(t.search_text_in_collection("c", "beta delta", 5, ef=ef),
                          j.search_text_in_collection("c", "beta delta", 5))
        assert_hits_equal_rows(
            t.search_texts_in_collection("c", ["a", "b n4"], 5, ef=ef),
            j.search_texts_in_collection("c", ["a", "b n4"], 5))
        q = tv.MockEmbeddingFunction(DIM).embed_batch_arrays(["a", "b", "c", "d", "e"])
        assert_hits_equal_rows(t.search_vectors_in_collection("c", q, 3, ef=ef),
                               j.search_vectors_in_collection("c", q, 3))
        assert_hits_equal(t.search_vector_in_collection("c", q[0], 3, ef=ef),
                          j.search_vector_in_collection("c", q[0], 3))
        assert_hits_equal(t.search_hybrid_in_collection("c", "alpha", 4, ef=ef),
                          j.search_hybrid_in_collection("c", "alpha", 4))
    close(j, t)


class Recorder:
    def __init__(self):
        self.events = []

    def collection_registered(self, collection):
        self.events.append(("registered", collection.name))

    def collection_deleted(self, name):
        self.events.append(("deleted", name))


def test_collection_observer_hears_every_registration():
    t = tv.VectorLiteClient(tv.MockEmbeddingFunction(8), device="cpu")
    t.create_collection("before", "flat")
    rec = Recorder()
    t.set_collection_observer(rec)
    t.create_collection("a", "flat")
    t.add_collection(tv.Collection("b", tv.FlatIndex(8, device="cpu")))
    t.delete_collection("a")
    assert rec.events == [("registered", "before"), ("registered", "a"),
                          ("registered", "b"), ("deleted", "a")]
    t.set_collection_observer(None)
    t.delete_collection("b")
    assert len(rec.events) == 4


# ------------------------------------------------------------ coalescer


def test_concurrent_searches_match_direct_path_and_jax(monkeypatch):
    j, t = make_clients()
    metrics = list(tv.SimilarityMetric)
    jobs = [(f"{WORDS[i % 8]} n{i}", 1 + i % 9, metrics[i % 4],
             {"bucket": i % 6} if i % 3 == 0 else None) for i in range(96)]
    before = coalesce_stats.snapshot()

    def one(job):
        q, k, m, w = job
        return t.search_text_in_collection("c", q, k, m, where=w)

    with ThreadPoolExecutor(max_workers=32) as pool:
        got = list(pool.map(one, jobs))
    after = coalesce_stats.snapshot()
    assert after["requests"] - before.get("requests", 0) == len(jobs)
    assert 1 <= after["batches"] - before.get("batches", 0) <= len(jobs)
    assert after["max_batch"] <= MAX_BATCH
    monkeypatch.setenv("VECTORLITE_COALESCE", "0")
    for (q, k, m, w), rows in zip(jobs, got):
        assert_hits_equal(rows, t.search_text_in_collection("c", q, k, m, where=w))
        jm = jv.SimilarityMetric(m.value)
        assert_hits_equal(rows, j.search_text_in_collection("c", q, k, jm, where=w))
    close(j, t)


def test_coalesce_disabled_by_env(monkeypatch):
    monkeypatch.setenv("VECTORLITE_COALESCE", "0")
    _, t = make_clients()
    t.search_text_in_collection("c", "alpha", 2)
    assert t.get_collection("c")._coalescer is None
    monkeypatch.delenv("VECTORLITE_COALESCE")
    before = coalesce_stats.snapshot().get("requests", 0)
    t.search_text_in_collection("c", "alpha", 2)
    assert t.get_collection("c")._coalescer is not None
    assert coalesce_stats.snapshot()["requests"] == before + 1
    # an ef-carrying request takes the direct path
    t.search_text_in_collection("c", "alpha", 2, ef=8)
    assert coalesce_stats.snapshot()["requests"] == before + 1
    close(t)


class FlakyEmbedder(tv.MockEmbeddingFunction):
    """Raises on texts containing 'poison'; a batch with one fails whole."""

    def generate_embedding(self, text):
        if "poison" in text:
            raise RuntimeError(f"bad text: {text}")
        return super().generate_embedding(text)


def test_one_bad_text_fails_alone():
    t = tv.VectorLiteClient(FlakyEmbedder(16), device="cpu")
    t.create_collection("c", "flat")
    t.add_texts_to_collection("c", [f"document {i}" for i in range(16)])
    texts = ["document 1", "poison pill", "document 2", "document 3", "poison two",
             "document 4"]
    barrier = threading.Barrier(len(texts))
    results, errors = {}, {}

    def worker(i, text):
        barrier.wait()
        try:
            results[i] = t.search_text_in_collection("c", text, 3)
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i, x)) for i, x in enumerate(texts)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert set(errors) == {1, 4}
    assert all(isinstance(e, EmbeddingError) for e in errors.values())
    assert set(results) == {0, 2, 3, 5} and all(len(r) == 3 for r in results.values())
    close(t)


def test_invalid_clause_fails_only_its_group():
    _, t = make_clients()
    with ThreadPoolExecutor(max_workers=4) as pool:
        ok = pool.submit(t.search_text_in_collection, "c", "alpha", 3)
        bad = pool.submit(lambda: t.search_text_in_collection(
            "c", "beta", 3, where={"bucket": {"$nope": 1}}))
        assert len(ok.result()) == 3
        with pytest.raises(InvalidFilter):
            bad.result()
    close(t)


def test_backlog_forms_one_batch():
    """Entries queued while a batch is in flight drain in one _process."""
    _, t = make_clients()
    co = t.get_collection("c")._get_coalescer()
    sizes = []
    orig = co._process
    co._process = lambda batch: (sizes.append(len(batch)), orig(batch))[1]
    gate, release = threading.Event(), threading.Event()

    class Gated(tv.MockEmbeddingFunction):
        def generate_embedding(self, text):
            if text == "gate":
                gate.set()
                release.wait(5.0)
            return super().generate_embedding(text)

    gated = Gated(DIM)
    first = threading.Thread(target=co.submit,
                             args=("gate", 1, tv.SimilarityMetric.COSINE, gated))
    first.start()
    assert gate.wait(5.0)
    followers = [threading.Thread(target=co.submit,
                                  args=(f"alpha n{i}", 2, tv.SimilarityMetric.COSINE, gated))
                 for i in range(6)]
    for th in followers:
        th.start()
    for _ in range(500):
        with co._cv:
            if len(co._queue) == 6:
                break
        threading.Event().wait(0.01)
    release.set()
    for th in (first, *followers):
        th.join(10.0)
    assert sizes[0] == 1 and max(sizes[1:]) == 6
    close(t)


def test_close_is_idempotent_and_delete_closes():
    _, t = make_clients()
    coll = t.get_collection("c")
    t.search_text_in_collection("c", "alpha", 2)
    coll.close()
    coll.close()
    assert len(t.search_text_in_collection("c", "beta", 2)) == 2  # a fresh coalescer
    co = coll._coalescer
    t.delete_collection("c")
    with pytest.raises(RuntimeError, match="closed"):
        co.submit("x", 1, tv.SimilarityMetric.COSINE, None)
    assert isinstance(co, SearchCoalescer)


@pytest.mark.cuda
def test_coalesced_search_matches_direct_on_the_card(monkeypatch):
    """Concurrent single-text searches on a card collection at kernel
    scale (K1 with the guard's verdict, K3 without it) against a direct
    search_batch of the same queries."""
    if not torch.cuda.is_available():
        pytest.skip("the scan kernels are CUDA C++ and run only on an NVIDIA card")
    from vectorlite_tpu_torch.index import flat

    monkeypatch.setattr(flat, "_PALLAS_MIN_CAPACITY", 1 << 14)
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((40_000, 128)).astype(np.float32)
    texts = [f"query {i}" for i in range(256)]
    emb = tv.MockEmbeddingFunction(128)
    queries = emb.embed_batch_arrays(texts)
    for guard in ("1", "0"):
        monkeypatch.setenv("VECTORLITE_SPEED_GUARD", guard)
        t = tv.VectorLiteClient(emb)
        t.create_collection("c", "flat")
        t.add_vectors_to_collection("c", rows)
        with ThreadPoolExecutor(max_workers=32) as pool:
            got = list(pool.map(lambda q: t.search_text_in_collection("c", q, 10), texts))
        want = t.get_collection("c").search_vectors(queries, 10, tv.SimilarityMetric.COSINE)
        for a, b in zip(got, want):
            np.testing.assert_allclose([h.score for h in a], [h.score for h in b],
                                       rtol=1e-5, atol=1e-5)
            for pos, (ha, hb) in enumerate(zip(a, b)):
                assert ha.id == hb.id or abs(ha.score - hb.score) <= 1e-5, pos
        close(t)
