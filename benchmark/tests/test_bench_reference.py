"""The plain reference against brute-force float64 numpy at toy sizes."""

import numpy as np
import pytest

from benchmark import reference


def brute(rows, queries, metric):
    r, q = rows.astype(np.float64), queries.astype(np.float64)
    out = np.empty((len(q), len(r)))
    for i, qi in enumerate(q):
        for j, rj in enumerate(r):
            if metric == "cosine":
                out[i, j] = min(qi @ rj / (np.linalg.norm(qi) * np.linalg.norm(rj)), 1.0)
            elif metric == "euclidean":
                out[i, j] = 1.0 / (1.0 + np.linalg.norm(qi - rj))
            elif metric == "dot":
                out[i, j] = qi @ rj
            else:
                out[i, j] = 1.0 / (1.0 + np.abs(qi - rj).sum())
    return out


@pytest.mark.parametrize("metric", reference.METRICS)
@pytest.mark.parametrize("masked", [False, True])
def test_kth_best_and_row_scores_match_brute_force(metric, masked, monkeypatch):
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((300, 24)).astype(np.float32)
    queries = rng.standard_normal((7, 24)).astype(np.float32)
    allowed = (np.arange(300) % 3 != 0) if masked else None
    monkeypatch.setattr(reference, "BLOCK_ROWS", 64)  # several blocks
    full = brute(rows, queries, metric)
    if masked:
        full[:, ~allowed] = -np.inf
    k = 5
    kth = reference.kth_best(rows, queries, k, metric, allowed, "cpu")
    assert np.allclose(kth, np.sort(full, axis=1)[:, -k], rtol=0, atol=1e-12)
    ids = np.argsort(-full, axis=1)[:, :k]
    ids[0, -1] = -1
    got = reference.row_scores(rows, queries, ids, metric)
    want = np.take_along_axis(brute(rows, queries, metric), np.maximum(ids, 0), axis=1)
    want[0, -1] = -np.inf
    assert np.allclose(got, want, rtol=0, atol=1e-12)


def test_where_mask_operators():
    cols = {"pos": np.arange(10)}
    m = reference.where_mask
    assert m(None, cols, 10) is None
    assert m({"pos": {"$gte": 7}}, cols, 10).tolist() == [False] * 7 + [True] * 3
    assert m({"pos": 3}, cols, 10).sum() == 1
    assert m({"$or": [{"pos": {"$lt": 2}}, {"pos": {"$in": [5, 6]}}]}, cols, 10).sum() == 4
    assert m({"$not": {"pos": {"$ne": 4}}}, cols, 10).tolist().index(True) == 4
    assert m({"pos": {"$gt": 2, "$lte": 4}}, cols, 10).sum() == 2
    assert not m({"other": 1}, cols, 10).any()
    with pytest.raises(ValueError):
        m({"pos": {"$regex": "x"}}, cols, 10)
