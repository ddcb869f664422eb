"""The port's HNSW index (vectorlite_tpu_torch/index/hnsw.py) against the
JAX package's, on the CPU.

With one build thread and the same seed, the native builders of both
packages (and their pure-Python twins) give the same graph: adjacency,
levels, entry point and upper layers, for each of the four metrics, and
the same ``search_batch`` results. Filtered search (brute-force floor and
widened beam), delete / delete_where / compact, listing, metadata updates
and ``index_to_json`` agree too, as do the graph-dump and rebuild load
paths. The port's copy of the ThreadSanitizer harness runs as
tests/test_native.py runs the JAX package's. (The cases of
tests/test_hnsw.py and tests/test_native.py.)
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import vectorlite_tpu as jv
import vectorlite_tpu_torch as tv
from vectorlite_tpu_torch import native
from vectorlite_tpu_torch.errors import (
    DimensionMismatch,
    DuplicateVectorId,
    MetricMismatch,
    VectorNotFound,
)
from vectorlite_tpu_torch.index.hnsw import (
    HNSWIndex,
    convert_distance_to_similarity,
    reference_score,
)

METRICS = ["COSINE", "EUCLIDEAN", "DOT_PRODUCT", "MANHATTAN"]
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _jax_search_pool_off():
    """The JAX package's native search pool can read a builder freed right
    after a batched search (ROADMAP §3): its batched HNSW searches here
    run on the calling thread."""
    import os

    before = os.environ.get("VECTORLITE_SEARCH_THREADS")
    os.environ["VECTORLITE_SEARCH_THREADS"] = "1"
    yield
    if before is None:
        del os.environ["VECTORLITE_SEARCH_THREADS"]
    else:
        os.environ["VECTORLITE_SEARCH_THREADS"] = before


@pytest.fixture(autouse=True)
def _one_build_thread(monkeypatch):
    monkeypatch.setenv("VECTORLITE_BUILD_THREADS", "1")
    monkeypatch.delenv("VECTORLITE_NO_NATIVE", raising=False)


def pair(metric, d, native_builder=None, **kw):
    j = jv.HNSWIndex(d, jv.SimilarityMetric[metric], native=native_builder, **kw)
    t = HNSWIndex(d, tv.SimilarityMetric[metric], native=native_builder, device="cpu", **kw)
    return j, t


def corpus(n, d, seed=0, clusters=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d))
    return centers[rng.integers(0, clusters, n)] + 0.3 * rng.standard_normal((n, d))


def same_graph(j, t):
    want, got = j.graph_arrays(), t.graph_arrays()
    assert (got[0] == want[0]).all()
    assert (got[1] == want[1]).all()
    assert got[2] == want[2]
    assert (got[3] == want[3]).all()
    assert len(got[4]) == len(want[4])
    for a, b in zip(got[4], want[4]):
        assert (a == b).all()


def hits(rows):
    return [[(h.id, h.text, h.metadata) for h in row] for row in rows]


def scores(rows):
    return np.array([h.score for row in rows for h in row])


def same_results(got, want):
    assert hits(got) == hits(want)
    np.testing.assert_allclose(scores(got), scores(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("builder", [None, False], ids=["native", "python"])
@pytest.mark.parametrize("metric", METRICS)
def test_graph_and_search_match_jax(metric, builder):
    d, n = 24, 1500 if builder is None else 300
    data = corpus(n, d, seed=1)
    j, t = pair(metric, d, builder, seed=9)
    assert (t._nb is None) == (builder is False)
    texts = [f"t{i}" for i in range(n)]
    metas = [{"i": i, "even": i % 2 == 0} for i in range(n)]
    half = n // 2
    for index in (j, t):
        index.add_batch_arrays(list(range(half)), data[:half], texts[:half], metas[:half])
        vector = tv.Vector if isinstance(index, HNSWIndex) else jv.Vector
        for i in range(half, half + 20):  # single inserts in between
            index.add(vector(id=i, values=list(data[i]), text=texts[i], metadata=metas[i]))
        index.add_batch_arrays(list(range(half + 20, n)), data[half + 20:],
                               texts[half + 20:], metas[half + 20:])
    same_graph(j, t)
    q = corpus(12, d, seed=2)
    m_j, m_t = jv.SimilarityMetric[metric], tv.SimilarityMetric[metric]
    for ef in (None, 0, 40):
        same_results(t.search_batch(q, 7, m_t, ef=ef), j.search_batch(q, 7, m_j, ef=ef))
    same_results([t.search(q[0], 5, m_t)], [j.search(q[0], 5, m_j)])
    assert t.max_id() == j.max_id() == n - 1 and len(t) == len(j) == n


@pytest.mark.parametrize("metric", METRICS)
def test_filters_deletes_and_compaction_match_jax(metric):
    d, n = 16, 3000
    data = corpus(n, d, seed=4)
    j, t = pair(metric, d, seed=5)
    metas = [{"bucket": i % 10, "rare": i % 997 == 0} for i in range(n)]
    for index in (j, t):
        index.add_batch_arrays(list(range(n)), data, [f"t{i}" for i in range(n)], metas)
    m_j, m_t = jv.SimilarityMetric[metric], tv.SimilarityMetric[metric]
    q = corpus(6, d, seed=6)
    wheres = [{"rare": True}, {"bucket": 3}, {"bucket": {"$in": [1, 2, 3, 4, 5, 6]}},
              {"bucket": {"$gte": 0}}, {"bucket": 99}]
    for where in wheres:  # brute floor, widened beam, no-op filter, empty
        same_results(t.search_batch(q, 10, m_t, where=where),
                     j.search_batch(q, 10, m_j, where=where))
    for index in (j, t):
        index.delete(17)
        index.update_metadata(18, {"bucket": 3, "patched": True})
        assert index.delete_where({"bucket": 7}) == 299  # 17 went before
    with pytest.raises(VectorNotFound):
        t.delete(17)
    same_results(t.search_batch(q, 10, m_t, where={"bucket": 3}),
                 j.search_batch(q, 10, m_j, where={"bucket": 3}))
    same_results(t.search_batch(q, 10, m_t), j.search_batch(q, 10, m_j))
    page_t, total_t = t.list_vectors(5, 20, {"bucket": 3}, include_values=True)
    page_j, total_j = j.list_vectors(5, 20, {"bucket": 3}, include_values=True)
    assert total_t == total_j
    assert [(v.id, v.values, v.metadata) for v in page_t] == [
        (v.id, v.values, v.metadata) for v in page_j]
    assert t.get_vector(18).metadata == {"bucket": 3, "patched": True}
    assert t.get_vector(17) is None and t.get_vector(19, include_values=False).values == []
    assert t.compact() == j.compact() == 300
    same_graph(j, t)
    same_results(t.search_batch(q, 10, m_t), j.search_batch(q, 10, m_j))
    assert t.compact() == 0


@pytest.mark.parametrize("metric", METRICS)
def test_index_to_json_and_back_match_jax(metric):
    d, n = 12, 400
    data = corpus(n, d, seed=8)
    j, t = pair(metric, d)
    for index in (j, t):
        index.add_batch_arrays(list(range(n)), data, None, [{"i": i} for i in range(n)])
    pj, pt = j.index_to_json(), t.index_to_json()
    assert sorted(pt) == sorted(pj) == ["dim", "graph", "id_to_index", "index_to_id",
                                        "metadata", "metric", "vector_values"]
    for key in ("dim", "metric", "id_to_index", "index_to_id", "metadata"):
        assert pt[key] == pj[key], key
    for vid, row in pj["vector_values"].items():
        assert pt["vector_values"][vid].tobytes() == row.tobytes()
    gj, gt = pj["graph"], pt["graph"]
    for key in ("format", "num_nodes", "entry", "top_level", "m", "m0"):
        assert gt[key] == gj[key], key
    assert (gt["adj0"] == gj["adj0"]).all() and (gt["levels"] == gj["levels"]).all()
    assert all((a == b).all() for a, b in zip(gt["upper"], gj["upper"], strict=True))
    # the graph dump restores; without it the index is rebuilt by insertion
    q = corpus(4, d, seed=9)
    m_t = tv.SimilarityMetric[metric]
    for payload in (pt, {k: v for k, v in pt.items() if k != "graph"}):
        back = HNSWIndex.index_from_json(payload, device="cpu")
        assert back.device.type == "cpu"
        same_graph(jv.HNSWIndex.index_from_json(payload), back)
    same_results(HNSWIndex.index_from_json(pt, device="cpu").search_batch(q, 5, m_t),
                 t.search_batch(q, 5, m_t))
    assert "graph" not in t.index_to_json(include_graph=False)


def test_corrupt_graph_dump_falls_back_to_rebuild():
    d = 8
    data = corpus(200, d, seed=3)
    t = HNSWIndex(d, tv.SimilarityMetric.EUCLIDEAN, device="cpu")
    t.add_batch_arrays(list(range(200)), data)
    payload = t.index_to_json()
    payload["graph"]["top_level"] = 40
    back = HNSWIndex.index_from_json(payload, device="cpu")
    assert len(back) == 200
    assert back.search(data[3], 1, tv.SimilarityMetric.EUCLIDEAN)[0].id == 3


def test_basic_contract():
    t = HNSWIndex(4, tv.SimilarityMetric.COSINE, device="cpu")
    assert (t.index_type, t.dimension, t.metric(), t.is_empty()) == (
        "HNSW", 4, tv.SimilarityMetric.COSINE, True)
    assert t.search([1, 0, 0, 0], 3, tv.SimilarityMetric.COSINE) == []
    t.add(tv.Vector(id=5, values=[1, 0, 0, 0], text="a"))
    with pytest.raises(DuplicateVectorId):
        t.add(tv.Vector(id=5, values=[1, 0, 0, 0], text=""))
    with pytest.raises(DimensionMismatch):
        t.add(tv.Vector(id=6, values=[1, 0], text=""))
    with pytest.raises(MetricMismatch):
        t.search([1, 0, 0, 0], 1, tv.SimilarityMetric.EUCLIDEAN)
    with pytest.raises(DimensionMismatch):
        t.search([1, 0], 1, tv.SimilarityMetric.COSINE)
    with pytest.raises(ValueError, match="0"):
        HNSWIndex(0, tv.SimilarityMetric.COSINE, device="cpu")
    with pytest.raises(ValueError, match="several devices"):
        HNSWIndex(4, tv.SimilarityMetric.COSINE, device="cpu", mesh=object())
    assert t.search([1, 0, 0, 0], 3, tv.SimilarityMetric.COSINE)[0].id == 5


@pytest.mark.parametrize("metric", METRICS)
def test_score_conversions_match_jax(metric, monkeypatch):
    from vectorlite_tpu.index import hnsw as jh

    for d in (0.0, 0.001, 0.5, 1.0, 3.7, 999.5, 1500.0):
        assert convert_distance_to_similarity(d, tv.SimilarityMetric[metric]) == (
            jh.convert_distance_to_similarity(d, jv.SimilarityMetric[metric]))
        assert reference_score(d, tv.SimilarityMetric[metric]) == jh.reference_score(
            d, jv.SimilarityMetric[metric])


def test_device_copy_follows_appends_in_place():
    """``_sync_device`` uploads once, then writes appended rows and dirty
    adjacency rows into the same tensors."""
    d = 8
    data = corpus(600, d, seed=12)
    t = HNSWIndex(d, tv.SimilarityMetric.EUCLIDEAN, device="cpu")
    t.add_batch_arrays(list(range(300)), data[:300])
    t._sync_device()
    vecs = t._dev[0]
    t.add_batch_arrays(list(range(300, 400)), data[300:400])
    t._sync_device()
    assert t._dev[0] is vecs  # capacity 512 holds both
    assert (t._dev[0][:400].numpy() == t._vecs[:400]).all()
    assert (t._dev[2][:400].numpy() == t._adj[0][:400]).all()
    t.add_batch_arrays(list(range(400, 600)), data[400:600])  # capacity grows
    t._sync_device()
    assert t._dev[0].shape[0] == t._capacity == 1024
    assert (t._dev[2][:600].numpy() == t._adj[0][:600]).all()


def test_tsan_harness_runs_clean(tmp_path):
    """The port's copy of the ThreadSanitizer harness over the parallel
    builder (tests/test_native.py's recipe). Skips where the toolchain
    lacks -fsanitize=thread."""
    src = ROOT / "vectorlite_tpu_torch" / "csrc" / "tsan_harness.cpp"
    exe = tmp_path / "vl_tsan"
    build = subprocess.run(
        ["g++", "-fsanitize=thread", "-O1", "-g", "-std=c++17", "-pthread",
         str(src), "-o", str(exe)],
        capture_output=True, text=True,
    )
    if build.returncode != 0:
        pytest.skip(f"tsan unsupported: {build.stderr[:200]}")
    run = subprocess.run([str(exe)], capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "ThreadSanitizer" not in run.stderr, run.stderr[-2000:]
    assert "tsan harness OK" in run.stdout


def test_batched_search_outlives_no_index(monkeypatch):
    """Batched native searches on the search pool, each index dropped at
    once after its search: the caller returns only when no pool worker is
    inside its job any more (a late worker would read a freed builder)."""
    import gc

    monkeypatch.setenv("VECTORLITE_SEARCH_THREADS", "4")
    rng = np.random.default_rng(0)
    for i in range(25):
        t = HNSWIndex(8, tv.SimilarityMetric.EUCLIDEAN, device="cpu")
        t.add_batch_arrays(list(range(64)), rng.standard_normal((64, 8)))
        rows = t.search_batch(rng.standard_normal((3, 8)), 4, tv.SimilarityMetric.EUCLIDEAN)
        assert [len(r) for r in rows] == [4, 4, 4]
        del t
        gc.collect()


def test_builder_builds_for_the_host_isa():
    from vectorlite_tpu_torch.kernels import _build

    assert "tsan_harness" not in _build.sources()
    assert "hnsw_builder" in _build.sources()
    assert "-march=native" in _build._flags("hnsw_builder")
    assert "-march=native" not in _build._flags("host_rescore")
    assert native.HNSW.library() is not None


def test_no_native_serves_the_python_twin(monkeypatch):
    monkeypatch.setenv("VECTORLITE_NO_NATIVE", "1")
    t = HNSWIndex(4, tv.SimilarityMetric.COSINE, device="cpu")
    assert t._nb is None
    with pytest.raises(RuntimeError, match="native hnsw builder unavailable"):
        HNSWIndex(4, tv.SimilarityMetric.COSINE, device="cpu", native=True)


def test_searches_run_on_cpu_tensors_only_when_asked():
    t = HNSWIndex(4, tv.SimilarityMetric.COSINE, device="cpu")
    t.add_batch_arrays([0, 1], np.eye(4)[:2])
    t._sync_device()
    assert all(x.device == torch.device("cpu") for x in t._dev)
