"""The port's pipelined ``FlatIndex.search_batch_stream`` against its own
``search_batch_arrays`` and the JAX package's ``search_batch_stream`` on
the same seeded inputs: the stream tests of tests/test_flat.py,
tests/test_filter.py and tests/test_concurrency.py, plus the stream on a
mesh and at kernel scale (its card test is in test_torch_mesh_card.py).

Ungrouped, each yielded batch is bit-equal to the array path's. Grouped
(``group`` > 1) the batches of a group are one launch, and on the CPU the
f32 scores of the plain matmul can move by an ulp with the launch's row
count: ids stay equal, scores within rtol 1e-6. Against JAX: ids equal,
scores within rtol 1e-5 / atol 1e-6 (f32 device scores).
"""

import threading

import numpy as np
import pytest
import torch

from vectorlite_tpu.core.metrics import SimilarityMetric as JM
from vectorlite_tpu.index.flat import FlatIndex as JFlat
from vectorlite_tpu_torch.core.metrics import SimilarityMetric as TM
from vectorlite_tpu_torch.dist.sharding import make_mesh
from vectorlite_tpu_torch.index import flat as tflat
from vectorlite_tpu_torch.index.flat import FlatIndex


def pair(rng, n=600, d=16, metas=None):
    data = rng.normal(size=(n, d))
    j, p = JFlat(d), FlatIndex(d, device="cpu")
    for idx in (j, p):
        idx.add_batch_arrays(np.arange(n, dtype=np.uint64), data, metadatas=metas)
    return j, p, data


def stream(idx, batches, k, metric, **kw):
    m = (JM if isinstance(idx, JFlat) else TM)[metric]
    return list(idx.search_batch_stream(iter(batches), k, m, **kw))


def assert_like_arrays(idx, batches, got, k, metric, exact=True, **kw):
    assert len(got) == len(batches)
    for q, (ids, scores) in zip(batches, got):
        ref_ids, ref_scores = idx.search_batch_arrays(q, k, TM[metric], **kw)
        np.testing.assert_array_equal(ids, ref_ids)
        if exact:
            np.testing.assert_array_equal(scores, ref_scores)
        else:
            np.testing.assert_allclose(scores, ref_scores, rtol=1e-6, atol=1e-7)
        assert ids.dtype == np.int64 and scores.dtype == np.float64


def assert_like_jax(got, want):
    assert len(got) == len(want)
    for (ids, scores), (j_ids, j_scores) in zip(got, want):
        np.testing.assert_array_equal(ids, j_ids)
        np.testing.assert_allclose(scores, j_scores, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_matches_arrays_path(rng, depth):
    j, p, data = pair(rng)
    batches = [data[i * 7 : i * 7 + 5] + 0.01 * i for i in range(6)]
    got = stream(p, batches, 4, "COSINE", depth=depth)
    assert_like_arrays(p, batches, got, 4, "COSINE")
    assert_like_jax(got, stream(j, batches, 4, "COSINE", depth=depth))


def test_empty_index_and_k_zero(rng):
    j, p, data = pair(rng, n=10)
    for idx in (j, p):
        out = stream(idx, [data[:3]], 0, "COSINE")
        assert out[0][0].shape == (3, 0) and out[0][1].shape == (3, 0)
    for empty in (JFlat(16), FlatIndex(16, device="cpu")):
        out = stream(empty, [data[:2], data[:7]], 5, "COSINE")
        assert [o[0].shape for o in out] == [(2, 5), (7, 5)]
        assert all((o[0] == -1).all() and (o[1] == -np.inf).all() for o in out)


def test_dimension_mismatch_raises(rng):
    from vectorlite_tpu_torch.errors import DimensionMismatch

    _, p, _ = pair(rng)
    with pytest.raises(DimensionMismatch):
        stream(p, [np.zeros((6, 5))], 3, "COSINE")


@pytest.mark.parametrize("group", [2, 3, 8])
@pytest.mark.parametrize("depth", [1, 3])
def test_grouped_fetch_matches_arrays_path(rng, depth, group):
    """Groups of G batches in one launch, a partial group at the end."""
    j, p, data = pair(rng)
    batches = [data[i * 9 : i * 9 + 6] + 0.01 * i for i in range(7)]
    got = stream(p, batches, 4, "COSINE", depth=depth, group=group)
    assert_like_arrays(p, batches, got, 4, "COSINE", exact=False)
    assert_like_jax(got, stream(j, batches, 4, "COSINE", depth=depth, group=group))


def test_grouped_fetch_mixed_batch_sizes(rng):
    j, p, data = pair(rng)
    sizes = [6, 6, 9, 9, 9, 5, 6]
    # fresh draws: a query at a stored row puts the expanded f32 euclidean
    # form (|q|^2 + |v|^2 - 2 q.v) in its cancellation noise, which the
    # two packages round differently
    batches = [rng.normal(size=(s, 16)) for s in sizes]
    got = stream(p, batches, 3, "EUCLIDEAN", group=4)
    assert [g[0].shape[0] for g in got] == sizes
    assert_like_arrays(p, batches, got, 3, "EUCLIDEAN", exact=False)
    assert_like_jax(got, stream(j, batches, 3, "EUCLIDEAN", group=4))


def test_grouped_fetch_ready_interleave(rng):
    """Host-scan batches (B <= 4 on a small corpus) are ready at once
    between grouped device batches; an open group popped before it fills
    flushes on demand instead of waiting."""
    j, p, data = pair(rng)
    batches = [data[:6]] + [data[i : i + 2] for i in range(8)]
    got = stream(p, batches, 4, "COSINE", depth=1, group=8)
    assert_like_arrays(p, batches, got, 4, "COSINE")
    want = stream(j, batches, 4, "COSINE", depth=1, group=8)
    for (ids, _), (j_ids, _) in zip(got, want):
        np.testing.assert_array_equal(ids, j_ids)


def test_k_change_mid_stream_closes_the_group(rng):
    """Deletes between two batches leave three live rows: k_eff changes,
    the open group flushes, and both batches equal the array path on the
    index as it then is (three hits, then -1 / -inf)."""
    _, p, data = pair(rng, n=20)

    def batches():
        yield data[:6]
        for vid in range(17):
            p.delete(vid)
        yield data[6:12]

    got = list(p.search_batch_stream(batches(), 5, TM.COSINE, group=4))
    assert len(got) == 2
    for q, (ids, scores) in zip((data[:6], data[6:12]), got):
        ref_ids, ref_scores = p.search_batch_arrays(q, 5, TM.COSINE)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_allclose(scores, ref_scores, rtol=1e-6)
        assert ((ids >= 0).sum(axis=1) == 3).all()


@pytest.mark.parametrize("metric", ["COSINE", "EUCLIDEAN", "DOT_PRODUCT", "MANHATTAN"])
def test_stream_at_kernel_scale(metric, rng, monkeypatch):
    """Above the kernel threshold (lowered): the speed path (K3 twin +
    re-score), approx=False (K1 twin) and Manhattan (K4 twin), streamed."""
    monkeypatch.setattr(tflat, "_PALLAS_MIN_CAPACITY", 1024)
    monkeypatch.setenv("VECTORLITE_SPEED_GUARD", "0")
    _, p, data = pair(rng, n=4000, d=32)
    batches = [data[i * 16 : i * 16 + 16] + 0.01 for i in range(5)]
    for approx in (None, False):
        got = stream(p, batches, 10, metric, depth=2, approx=approx)
        assert_like_arrays(p, batches, got, 10, metric, approx=approx)


@pytest.mark.parametrize("shards", [8, 3])
def test_stream_on_a_mesh(shards, rng):
    data = rng.normal(size=(700, 16))
    idx = FlatIndex(16, mesh=make_mesh(["cpu"] * shards))
    idx.add_batch_arrays(np.arange(700), data, metadatas=[{"g": i % 4} for i in range(700)])
    batches = [data[i * 5 : i * 5 + 8] for i in range(6)] + [data[:1]]
    for kw in ({}, {"where": {"g": 2}}):
        got = stream(idx, batches, 5, "COSINE", depth=2, **kw)
        assert_like_arrays(idx, batches, got, 5, "COSINE", **kw)
        got = stream(idx, batches, 5, "COSINE", depth=2, group=4, **kw)
        assert_like_arrays(idx, batches, got, 5, "COSINE", exact=False, **kw)


def test_fetch_workers_never_take_the_device_lock(rng):
    """Only the dispatch thread takes the device lock (around the sync and
    the launch); fetch workers wait on the result and do host work."""
    _, p, data = pair(rng)
    takers = []
    real = p._dev_lock

    class Recording:
        def __enter__(self):
            takers.append(threading.current_thread().name)
            return real.__enter__()

        def __exit__(self, *exc):
            return real.__exit__(*exc)

    p._dev_lock = Recording()
    batches = [data[i * 6 : i * 6 + 6] for i in range(6)]
    for group in (1, 3):
        takers.clear()
        list(p.search_batch_stream(iter(batches), 3, TM.COSINE, depth=2, group=group))
        assert takers and all(name.startswith("vl-stream-dispatch") for name in takers)
        assert len(takers) == len(batches) // group


def test_stream_path_filtered(monkeypatch):
    """With a where clause every yielded batch matches the filter and
    agrees with the array path and with JAX's stream."""
    monkeypatch.setenv("VECTORLITE_HOST_SCAN_ROWS", "0")
    rng = np.random.default_rng(3)
    n, d = 128, 8
    data = rng.normal(size=(n, d))
    metas = [{"tag": "even" if i % 2 == 0 else "odd", "rank": i} if i % 5 else None
             for i in range(n)]
    j, p = JFlat(d), FlatIndex(d, device="cpu")
    for idx in (j, p):
        idx.add_batch_arrays(np.arange(n, dtype=np.uint64), data,
                             texts=[f"t{i}" for i in range(n)], metadatas=metas)
    where = {"tag": "odd"}
    batches = [data[:4], data[4:8]]
    got = stream(p, batches, 5, "COSINE", where=where)
    assert_like_arrays(p, batches, got, 5, "COSINE", where=where)
    for ids, _ in got:
        live = ids[ids >= 0]
        assert all(metas[i] is not None and metas[i]["tag"] == "odd" for i in live)
    assert_like_jax(got, stream(j, batches, 5, "COSINE", where=where))


def test_stream_with_concurrent_writers(rng):
    """The stream iterates while another thread appends and deletes: each
    yielded batch is consistent (live ids, finite scores) and the stream
    runs to its end."""
    d, n0 = 12, 400
    data = rng.normal(size=(n0 + 600, d))
    idx = FlatIndex(d, device="cpu")
    idx.add_batch_arrays(np.arange(n0, dtype=np.uint64), data[:n0])
    stop = threading.Event()

    def churn():
        i = n0
        while not stop.is_set() and i < len(data):
            idx.add_batch_arrays(np.arange(i, i + 20, dtype=np.uint64), data[i : i + 20])
            idx.delete(int(i - 100))
            i += 20

    t = threading.Thread(target=churn)
    t.start()
    try:
        count = 0
        for ids, scores in idx.search_batch_stream(
            (data[j * 3 : j * 3 + 4] for j in range(30)), 5, TM.COSINE, depth=3
        ):
            assert ids.shape == (4, 5)
            assert np.all(np.isfinite(scores[ids >= 0]))
            count += 1
        assert count == 30
    finally:
        stop.set()
        t.join()
