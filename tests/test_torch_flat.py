"""The port's FlatIndex (CPU, plain versions of the kernels) against the
JAX FlatIndex on the same seeded corpus, deletes and compaction included.

Regimes: the f64 host scan (B <= 4), the full-score device path below
the kernel threshold, and the kernel path, reached on small corpora by
lowering the port's ``_PALLAS_MIN_CAPACITY``.
"""

import numpy as np
import pytest
import torch

from vectorlite_tpu.core.metrics import SimilarityMetric as JMetric
from vectorlite_tpu.index.flat import FlatIndex as JFlat
from vectorlite_tpu_torch.core.metrics import SimilarityMetric
from vectorlite_tpu_torch.core.types import SearchResult
from vectorlite_tpu_torch.index import flat as tflat
from vectorlite_tpu_torch.index.flat import FlatIndex

N, D = 4096, 64
METRICS = ["COSINE", "EUCLIDEAN", "DOT_PRODUCT", "MANHATTAN"]


def build(index, rows, deleted, compact):
    ids = list(range(10, 10 + len(rows)))
    index.add_batch_arrays(
        ids, rows, texts=[f"t{i}" for i in ids],
        metadatas=[{"g": i % 3} for i in ids],
    )
    for vid in deleted:
        index.delete(vid)
    if compact:
        index.compact()
        # refill past the compaction so slots and ids diverge
        extra = len(rows) - index._size
        more = np.asarray(rows[:extra]) * 0.5
        index.add_batch_arrays(list(range(100000, 100000 + extra)), more)
    return index


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(64, D))
    rows = centers[rng.integers(0, 64, N)] + 0.3 * rng.normal(size=(N, D))
    deleted = [int(x) for x in rng.choice(np.arange(10, 10 + N), 300, replace=False)]
    queries = rng.normal(size=(16, D))
    return rows, deleted, queries


@pytest.fixture(params=[False, True], ids=["tombstones", "compacted"])
def pair(request, corpus):
    rows, deleted, queries = corpus
    jax_index = build(JFlat(D), rows, deleted, request.param)
    port = build(FlatIndex(D, device="cpu"), rows, deleted, request.param)
    carried = FlatIndex.index_from_json(jax_index.index_to_json(), device="cpu")
    return jax_index, port, carried, queries


def search(index, q, metric, **kw):
    m = (JMetric if isinstance(index, JFlat) else SimilarityMetric)[metric]
    return index.search_batch_arrays(q, 10, m, **kw)


@pytest.mark.parametrize("metric", METRICS)
def test_host_scan_regime(pair, metric):
    jax_index, port, carried, queries = pair
    j_ids, j_s = search(jax_index, queries[:4], metric)
    for index in (port, carried):
        ids, s = search(index, queries[:4], metric)
        assert np.array_equal(ids, j_ids)
        np.testing.assert_allclose(s, j_s, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("metric", METRICS)
def test_device_regime_below_kernels(pair, metric, monkeypatch):
    jax_index, port, carried, queries = pair
    j_ids, j_s = search(jax_index, queries, metric)
    for index in (port, carried):
        ids, s = search(index, queries, metric)
        assert np.array_equal(ids, j_ids)
        np.testing.assert_allclose(s, j_s, rtol=1e-5, atol=1e-5)


@pytest.fixture
def kernel_regime(monkeypatch):
    monkeypatch.setattr(tflat, "_PALLAS_MIN_CAPACITY", 1024)


@pytest.mark.parametrize("metric", METRICS)
def test_kernel_regime_exact(pair, metric, kernel_regime):
    jax_index, port, carried, queries = pair
    j_ids, j_s = search(jax_index, queries, metric, approx=False)
    for index in (port, carried):
        ids, s = search(index, queries, metric, approx=False)
        assert np.array_equal(ids, j_ids)
        np.testing.assert_allclose(s, j_s, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["COSINE", "EUCLIDEAN", "DOT_PRODUCT"])
def test_kernel_regime_speed_path(pair, metric, kernel_regime):
    """K3 over the int8 scan copy + exact f32 re-score of the pool: every
    returned score is the exact score of its id, recall@10 >= 0.99."""
    jax_index, port, carried, queries = pair
    j_ids, _ = search(jax_index, queries, metric, approx=False)
    for index in (port, carried):
        ids, s = search(index, queries, metric)
        assert index._dev_scan is not None and index._dev_scan.dtype == torch.int8
        hits = sum(len(set(a) & set(b)) for a, b in zip(ids, j_ids))
        assert hits / j_ids.size >= 0.99
        # the JAX package's exact score of each returned id
        for b_i in range(len(queries)):
            j_full_ids, j_full_s = search(
                jax_index, queries[b_i : b_i + 1], metric, approx=False
            )
            exact = dict(zip(j_full_ids[0], j_full_s[0]))
            for vid, score in zip(ids[b_i], s[b_i]):
                if vid in exact:
                    assert abs(score - exact[vid]) <= 1e-5 * max(1, abs(exact[vid]))


@pytest.mark.parametrize("approx", [False, None], ids=["K2", "K3"])
@pytest.mark.parametrize("metric", ["COSINE", "EUCLIDEAN", "DOT_PRODUCT"])
def test_kernel_regime_quantized(corpus, metric, approx, kernel_regime):
    rows, deleted, queries = corpus
    jax_index = build(JFlat(D, device_dtype="int8"), rows, deleted, False)
    port = build(
        FlatIndex(D, device_dtype="int8", device="cpu"), rows, deleted, False
    )
    j_ids, j_s = search(jax_index, queries, metric)
    ids, s = search(port, queries, metric, approx=approx)
    assert np.array_equal(ids, j_ids)
    np.testing.assert_allclose(s, j_s, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("metric", ["COSINE", "DOT_PRODUCT"])
def test_where_filter_is_exact(pair, metric, kernel_regime):
    jax_index, port, carried, queries = pair
    where = {"g": 1}
    j_ids, j_s = search(jax_index, queries, metric, where=where)
    for index in (port, carried):
        ids, s = search(index, queries, metric, where=where)
        assert np.array_equal(ids, j_ids)
        np.testing.assert_allclose(s, j_s, rtol=1e-5, atol=1e-5)


def test_search_batch_objects_match(pair):
    jax_index, port, _, queries = pair
    j = jax_index.search_batch(queries[:8], 5, JMetric.COSINE)
    t = port.search_batch(queries[:8], 5, SimilarityMetric.COSINE)
    assert [[(h.id, h.text, h.metadata) for h in row] for row in j] == [
        [(h.id, h.text, h.metadata) for h in row] for row in t
    ]


def test_appends_after_build_reach_the_device(corpus, kernel_regime):
    """Rows added after the device build are copied in place (dirty-row
    sync) and found by the kernels."""
    rows, _, queries = corpus
    port = FlatIndex(D, device="cpu")
    port.add_batch_arrays(list(range(2048)), rows[:2048])
    port.add_batch_arrays(list(range(2048, 2500)), rows[2048:2500])
    search(port, queries, "COSINE", approx=False)  # builds at capacity 4096
    port.add_batch_arrays([7777], queries[:1] * 3.0)
    ids, _ = search(port, queries[:8], "COSINE", approx=False)
    assert ids[0][0] == 7777
    ids, _ = search(port, queries[:8], "COSINE")
    assert ids[0][0] == 7777


def spy_on(monkeypatch, calls, module, name):
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize(
    "metric, k, route",
    [
        ("MANHATTAN", 10, "pallas_search_topk_l1"),
        ("COSINE", 300, "pallas_search_topk"),
        ("EUCLIDEAN", 700, "pallas_search_topk"),
    ],
)
def test_kernel_regime_routes_to_kernels(pair, metric, k, route, kernel_regime,
                                         monkeypatch):
    """At kernel scale no f32 search falls back to the full-score path:
    Manhattan takes K4 and an exact k above K1's shared-memory lists
    takes K1, as the reference sends both to its Pallas kernels."""
    jax_index, port, _, queries = pair
    calls = []
    for name in ("pallas_search_topk", "pallas_search_topk_l1",
                 "pallas_search_block_topk_rescored"):
        spy_on(monkeypatch, calls, tflat.scan, name)
    spy_on(monkeypatch, calls, tflat, "search_topk")
    m = SimilarityMetric[metric]
    ids, s = port.search_batch_arrays(queries, k, m, approx=False)
    assert calls == [route]
    j_ids, j_s = jax_index.search_batch_arrays(queries, k, JMetric[metric],
                                               approx=False)
    np.testing.assert_allclose(s, j_s, rtol=1e-5, atol=1e-5)
    # deep in a ranking of k in the hundreds, f32 sums taken in another
    # order may swap neighbours whose scores lie within 1e-5
    for b_i, p in zip(*np.nonzero(ids != j_ids)):
        gaps = np.abs(j_s[b_i] - j_s[b_i, p])
        gaps[p] = np.inf
        assert gaps.min() <= 1e-5


def test_quantized_manhattan_takes_the_full_score_path(corpus, kernel_regime,
                                                       monkeypatch):
    """Neither package has a kernel for manhattan over int8 rows: both
    serve it from the full int8 score matrix and re-score in f64."""
    rows, deleted, queries = corpus
    jax_index = build(JFlat(D, device_dtype="int8"), rows, deleted, False)
    port = build(
        FlatIndex(D, device_dtype="int8", device="cpu"), rows, deleted, False
    )
    calls = []
    spy_on(monkeypatch, calls, tflat, "search_topk_int8")
    ids, s = search(port, queries, "MANHATTAN")
    assert calls == ["search_topk_int8"]
    j_ids, j_s = search(jax_index, queries, "MANHATTAN")
    assert np.array_equal(ids, j_ids)
    np.testing.assert_allclose(s, j_s, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("native", ["native", "numpy"])
@pytest.mark.parametrize("metric", METRICS)
def test_quantized_rescore_native_and_numpy(corpus, metric, native,
                                            kernel_regime, monkeypatch):
    """The quantized profile's f64 re-score of the pool gives the JAX
    package's ids and scores whether the native streaming loop or its
    numpy twin (VECTORLITE_NO_NATIVE=1) serves it."""
    from vectorlite_tpu_torch.native import RESCORE

    if native == "numpy":
        monkeypatch.setenv("VECTORLITE_NO_NATIVE", "1")
    rows, deleted, queries = corpus
    jax_index = build(JFlat(D, device_dtype="int8"), rows, deleted, False)
    port = build(
        FlatIndex(D, device_dtype="int8", device="cpu"), rows, deleted, False
    )
    calls = RESCORE.calls
    ids, s = search(port, queries, metric)
    assert RESCORE.calls == calls + (native == "native")
    j_ids, j_s = search(jax_index, queries, metric)
    assert np.array_equal(ids, j_ids)
    np.testing.assert_allclose(s, j_s, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("profile, k, pool", [
    ("f32", 1000, 1024), ("memory-optimized", 200, 512), ("quantized", 500, 1024),
])
def test_kernel_regime_deep_lists_match_f64_truth(corpus, profile, k, pool, kernel_regime,
                                                  monkeypatch):
    """Lists past 256 at kernel scale: approx=False at k 1,000 over f32 rows
    (K1, k_pad 1,024), the memory-optimized profile's exact path at k 200
    (K1 over bf16 rows, the 2x pool of 512) and the quantized profile's at
    k 500 (K2, the 2x pool of 1,024) reach the exact kernels with those
    lists, on the tile exact_tile grows (the whole 4,096 rows here), and
    return float64 truth's ids beyond 1e-5 near-ties; the re-scored
    profiles return its scores."""
    rows, deleted, queries = corpus
    dtype = {"f32": "auto", "memory-optimized": torch.bfloat16, "quantized": "int8"}[profile]
    port = build(FlatIndex(D, device_dtype=dtype, device="cpu"), rows, deleted, False)
    seen = []
    for name in ("pallas_search_topk", "pallas_search_topk_int8"):
        fn = getattr(tflat.scan, name)
        monkeypatch.setattr(tflat.scan, name, lambda *a, fn=fn, **kw: seen.append(
            (kw["k"], kw["tile_n"])) or fn(*a, **kw))
    ids, s = port.search_batch_arrays(queries, k, SimilarityMetric.COSINE, approx=False)
    assert seen == [(pool, tflat._PALLAS_TILE_BF16 if profile == "memory-optimized"
                     else tflat._PALLAS_TILE_F32)]
    assert tflat.scan.exact_tile(port._capacity, seen[0][1], pool) == N
    live = np.setdiff1d(np.arange(10, 10 + N), deleted)
    v = np.asarray(rows, np.float64)[live - 10]
    truth = (queries @ v.T) / (np.linalg.norm(queries, axis=1)[:, None]
                               * np.linalg.norm(v, axis=1)[None, :])
    order = np.argsort(-truth, axis=1, kind="stable")[:, :k]
    t_ids, t_s = live[order], np.take_along_axis(truth, order, 1)
    np.testing.assert_allclose(s, t_s, rtol=1e-5, atol=1e-5)
    for b_i, p in zip(*np.nonzero(ids != t_ids)):
        gaps = np.abs(t_s[b_i] - t_s[b_i, p])
        gaps[p] = np.inf
        assert gaps.min() <= 1e-5
    if profile != "f32":
        np.testing.assert_allclose(s, t_s, rtol=1e-12, atol=1e-12)


def per_hit_results(index, scores, slots):
    """The result build as ``search_batch`` once ran it: one numpy scalar
    at a time, each row cut at its first ``-inf``."""
    out = []
    for row_scores, row_slots in zip(scores, slots):
        hits = []
        for s, slot in zip(row_scores, row_slots):
            if s == -np.inf:
                break
            hits.append(
                SearchResult(
                    id=int(index._ids[slot]),
                    score=float(s),
                    text=index._texts[slot] or "",
                    metadata=index._metas[slot],
                )
            )
        out.append(hits)
    return out


def parity_index(n, *, deleted=0, compact=False, empty=False):
    """``n`` rows of 16-d; every third row has no text, every fifth no
    metadata, the rest a dict ({"rare": True} on three rows); ``deleted``
    rows deleted (their slots' text and metadata are None), then maybe
    compacted."""
    index = FlatIndex(16, device="cpu")
    if empty:
        return index, np.random.default_rng(3).normal(size=(4, 16))
    rng = np.random.default_rng(n + deleted)
    rows = rng.normal(size=(n, 16))
    ids = [7 * i + 2**40 for i in range(n)]
    index.add_batch_arrays(
        ids, rows,
        texts=[None if i % 3 == 0 else f"t{i}" for i in range(n)],
        metadatas=[None if i % 5 == 0 else {"g": i % 4, "rare": i in (6, 13, 21)}
                   for i in range(n)],
    )
    for vid in rng.choice(ids, deleted, replace=False).tolist():
        index.delete(vid)
    if compact:
        index.compact()
    # queries: corpus rows (cosine scores reach 1, so the clamp acts) and others
    return index, np.concatenate([rows[:8], rng.normal(size=(8, 16))])


PARITY_CASES = {
    "b1000_k10": (dict(n=2048), 1000, 10, {}),
    "b1": (dict(n=2048), 1, 10, {}),
    "k_past_live_padded": (dict(n=24), 16, 40, {"pad": True}),
    "where_fewer_than_k": (dict(n=512), 16, 10, {"where": {"rare": True}}),
    "where_fewer_than_k_b1": (dict(n=512), 1, 10, {"where": {"rare": True}}),
    "deleted": (dict(n=1024, deleted=200), 64, 10, {}),
    "compacted": (dict(n=2048, deleted=1500, compact=True), 64, 10, {}),
    "k0": (dict(n=64), 8, 0, {}),
    "empty": (dict(n=0, empty=True), 4, 10, {}),
}


@pytest.mark.parametrize("metric", ["COSINE", "EUCLIDEAN"])
@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_result_build_matches_the_per_hit_loop(case, metric, monkeypatch):
    """``search_batch`` builds the same hit lists as the per-hit loop over
    the (scores, slots) it searched: ids and scores equal and of the
    Python types, texts equal, each metadata the same object. With
    ``pad`` the arrays gain ``-inf`` columns (slots out of range, never
    read), row i loses its last i % 5 hits to ``-inf``, and every
    seventh row gets one ``-inf`` at position 2 with finite scores after
    it, which the loop's ``break`` cuts at 2."""
    build_kw, b, k, opts = PARITY_CASES[case]
    index, queries = parity_index(**build_kw)
    queries = np.resize(queries, (b, 16)) * (1 + np.arange(b) % 7)[:, None]
    seen = []
    searched = index._search_slots

    def spy(*a, **kw):
        scores, slots = searched(*a, **kw)
        if opts.get("pad"):
            scores = np.pad(scores, ((0, 0), (0, 16)), constant_values=-np.inf)
            slots = np.pad(slots, ((0, 0), (0, 16)), constant_values=2**31 - 1)
            for i in range(len(scores)):
                scores[i, scores.shape[1] - 16 - i % 5 :] = -np.inf
                if i % 7 == 6:
                    scores[i, 2] = -np.inf
        seen.append((scores, slots))
        return scores, slots

    monkeypatch.setattr(index, "_search_slots", spy)
    got = index.search_batch(queries, k, SimilarityMetric[metric],
                             where=opts.get("where"))
    if k == 0 or index._count == 0:
        assert seen == [] and got == [[] for _ in range(b)]
        return
    (scores, slots), = seen
    want = per_hit_results(index, scores, slots)
    assert [len(row) for row in got] == [len(row) for row in want]
    assert sum(map(len, want)) > 0
    if opts.get("pad"):
        assert {len(row) for row in want} == {2, 20, 21, 22, 23, 24}
    if "where" in opts:
        assert all(len(row) == 3 for row in want)
    for g_row, w_row in zip(got, want):
        for g, w in zip(g_row, w_row):
            assert type(g) is SearchResult
            assert type(g.id) is int and type(g.score) is float
            assert g.id == w.id and g.score == w.score and g.text == w.text
            assert g.metadata is w.metadata
