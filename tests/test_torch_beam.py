"""The port's level-0 beam (vectorlite_tpu_torch/kernels/beam.py) against
the JAX package's ``beam_search_l0``, on the CPU.

The same graph (the port's index, built as the JAX package builds it),
entry points and queries go through both beams: ids equal except among
distances within 1e-5 of each other, distances within 1e-5. Then the
cases of tests/test_beam.py on the port's index with ``use_device=True``:
overlap with the native host search, recall against Flat, sorted and
converted scores, tombstones, and appends seen by the device copy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorlite_tpu as jv
import vectorlite_tpu_torch as tv
from vectorlite_tpu.kernels import beam as jbeam
from vectorlite_tpu_torch.kernels import beam as tbeam

METRICS = ["COSINE", "EUCLIDEAN", "DOT_PRODUCT", "MANHATTAN"]


@pytest.fixture(autouse=True, scope="module")
def _one_build_thread():
    """Sequential native builds: both packages' graphs are then the same."""
    import os

    before = os.environ.get("VECTORLITE_BUILD_THREADS")
    os.environ["VECTORLITE_BUILD_THREADS"] = "1"
    yield
    if before is None:
        del os.environ["VECTORLITE_BUILD_THREADS"]
    else:
        os.environ["VECTORLITE_BUILD_THREADS"] = before


def ids_match(got_ids, got_d, want_ids, want_d, tol=1e-5):
    """Equal ids per slot, except where the slot's distance has a
    neighbor within ``tol`` (a near-tie either side may order)."""
    np.testing.assert_allclose(got_d, want_d, atol=tol, rtol=0)
    for gi, gd, wi, wd in zip(got_ids, got_d, want_ids, want_d):
        finite = np.isfinite(wd)
        for s in np.nonzero(gi != wi)[0]:
            near = np.abs(wd[finite] - wd[s]) <= tol
            assert near.sum() >= 2, (s, gi[s], wi[s], wd[s])


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(3)
    out = {}
    for metric in METRICS:
        data = rng.standard_normal((900, 20)) * (0.1 if metric == "DOT_PRODUCT" else 1)
        index = tv.HNSWIndex(20, tv.SimilarityMetric[metric], seed=5, device="cpu")
        index.add_batch_arrays(list(range(len(data))), data)
        out[metric] = (index, data)
    return out


@pytest.mark.parametrize("ef", [8, 64])
@pytest.mark.parametrize("metric", METRICS)
def test_beam_matches_jax(graphs, metric, ef):
    index, data = graphs[metric]
    rng = np.random.default_rng(ef)
    q = (rng.standard_normal((16, data.shape[1])) * data.std()).astype(np.float32)
    index._sync_device()
    vecs, sqn, adj = index._dev
    n = index._num_nodes
    entries = np.array([index._descend_entry(x) for x in q], np.int32)
    want_ids, want_d = jbeam.beam_search_l0(
        jnp.asarray(vecs[:n].numpy()), jnp.asarray(sqn[:n].numpy()),
        jnp.asarray(adj[:n].numpy()), jnp.asarray(entries), jnp.asarray(q),
        metric=jv.SimilarityMetric[metric], ef=ef, max_iters=4 * ef + 32)
    got_ids, got_d = tbeam.beam_search_l0(
        vecs, sqn, adj, torch.from_numpy(entries), torch.from_numpy(q),
        metric=tv.SimilarityMetric[metric], ef=ef, max_iters=4 * ef + 32)
    assert got_ids.dtype == torch.int32 and got_d.dtype == torch.float32
    ids_match(got_ids.numpy(), got_d.numpy(), np.asarray(want_ids), np.asarray(want_d))


@pytest.mark.parametrize("max_iters", [1, 9, 17])
def test_iteration_cap_matches_jax(graphs, max_iters):
    """A cap that stops the loop mid-search (between two reads of the
    active flag) leaves the beam the JAX loop leaves."""
    index, data = graphs["EUCLIDEAN"]
    q = np.random.default_rng(1).standard_normal((8, data.shape[1])).astype(np.float32)
    index._sync_device()
    vecs, sqn, adj = index._dev
    entries = np.zeros(8, np.int32)
    want = jbeam.beam_search_l0(
        jnp.asarray(vecs.numpy()), jnp.asarray(sqn.numpy()), jnp.asarray(adj.numpy()),
        jnp.asarray(entries), jnp.asarray(q), metric=jv.SimilarityMetric.EUCLIDEAN,
        ef=16, max_iters=max_iters)
    got = tbeam.beam_search_l0(
        vecs, sqn, adj, torch.from_numpy(entries), torch.from_numpy(q),
        metric=tv.SimilarityMetric.EUCLIDEAN, ef=16, max_iters=max_iters)
    ids_match(got[0].numpy(), got[1].numpy(), np.asarray(want[0]), np.asarray(want[1]))


@pytest.mark.parametrize("metric", METRICS)
def test_index_device_search_matches_jax(metric):
    """The whole use_device=True path (host descent, padding, beam,
    tombstones, conversion) against the JAX index on the same data."""
    rng = np.random.default_rng(7)
    data = rng.standard_normal((700, 16)) * 0.1
    j = jv.HNSWIndex(16, jv.SimilarityMetric[metric], seed=2)
    t = tv.HNSWIndex(16, tv.SimilarityMetric[metric], seed=2, device="cpu")
    for index in (j, t):
        index.add_batch_arrays(list(range(700)), data)
        index.delete(3)
    q = rng.standard_normal((5, 16)) * 0.1
    got = t.search_batch(q, 10, tv.SimilarityMetric[metric], use_device=True)
    want = j.search_batch(q, 10, jv.SimilarityMetric[metric], use_device=True)
    for g, w in zip(got, want):
        gd = np.array([h.score for h in g])
        wd = np.array([h.score for h in w])
        ids_match(np.array([[h.id for h in g]]), gd[None], np.array([[h.id for h in w]]),
                  wd[None])
        assert 3 not in [h.id for h in g]


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(3)
    n, d = 800, 24
    data = rng.normal(size=(n, d)).astype(np.float64)
    idx = tv.HNSWIndex(d, tv.SimilarityMetric.EUCLIDEAN, seed=5, device="cpu")
    for i in range(n):
        idx.add(tv.Vector(id=i, values=list(data[i]), text="t"))
    flat = tv.FlatIndex(d, device="cpu")
    flat.add_batch_arrays(list(range(n)), data)
    return idx, flat, data, rng


def test_matches_host_path(built):
    """tests/test_beam.py:26-40: overlap with the native search >= 0.9."""
    idx, _, data, rng = built
    queries = rng.normal(size=(16, data.shape[1]))
    host = idx.search_batch(queries, 10, tv.SimilarityMetric.EUCLIDEAN, use_device=False)
    dev = idx.search_batch(queries, 10, tv.SimilarityMetric.EUCLIDEAN, use_device=True)
    overlaps = [len({r.id for r in h} & {r.id for r in d}) / max(len(h), 1)
                for h, d in zip(host, dev)]
    assert np.mean(overlaps) >= 0.9, overlaps


def test_recall_vs_flat_and_scores(built):
    idx, flat, data, rng = built
    recalls = []
    for _ in range(16):
        q = rng.normal(size=data.shape[1])
        truth = {r.id for r in flat.search(q, 10, tv.SimilarityMetric.EUCLIDEAN)}
        got = {r.id for r in idx.search(q, 10, tv.SimilarityMetric.EUCLIDEAN, use_device=True)}
        recalls.append(len(truth & got) / 10)
    assert np.mean(recalls) >= 0.9, recalls
    res = idx.search(data[5], 5, tv.SimilarityMetric.EUCLIDEAN, use_device=True)
    assert res[0].id == 5 and abs(res[0].score - 1.0) < 1e-4
    assert [r.score for r in res] == sorted((r.score for r in res), reverse=True)


def test_tombstones_and_appends_on_the_device(built):
    idx, _, data, _ = built
    idx.delete(7)
    try:
        res = idx.search(data[7], 5, tv.SimilarityMetric.EUCLIDEAN, use_device=True)
        assert 7 not in [r.id for r in res]
    finally:
        idx.add(tv.Vector(id=7, values=list(data[7]), text="t"))
    new_vec = data[1] * 0.5 + data[2] * 0.5
    idx.add(tv.Vector(id=9999, values=list(new_vec), text="t"))
    res = idx.search(new_vec, 1, tv.SimilarityMetric.EUCLIDEAN, use_device=True)
    assert res[0].id == 9999
    idx.delete(9999)


def test_use_device_policy_follows_the_reference():
    """Without the native builder, batches of 8+ on 4,096+ nodes take the
    device beam; with it, the native search serves."""
    t = tv.HNSWIndex(4, tv.SimilarityMetric.COSINE, device="cpu", native=False)
    t._num_nodes = 4096
    t._id_to_index = {0: 0}
    calls = []
    t._search_device = lambda q, k, ef: calls.append(len(q)) or [[] for _ in q]
    t.search_batch(np.ones((8, 4)), 1, tv.SimilarityMetric.COSINE)
    assert calls == [8]
