"""The comparison that decides ``correct``: the answers the timed path
returned, against the plain reference.

Numbers, each held to its own limit from ``limits/<workload>.json``:

- ``malformed``: answers that are not k distinct rows of the corpus with
  finite scores in non-increasing order (limit 0);
- ``off_filter``: returned rows that fail the traffic's ``where`` clause
  (limit 0; only where the mix has one);
- ``score_err``: the widest gap between a returned score and the float64
  score of the row it names;
- ``rank_gap``: the widest gap by which a returned row's float64 score
  lies below the query's float64 k-th best over the allowed rows.
"""

from __future__ import annotations

import numpy as np

from . import reference


def metadata_columns(config: dict) -> dict:
    """The metadata fields as arrays, for the reference's clause."""
    n = int(config["rows"])
    return {f: np.arange(n) for f, kind in (config.get("metadata") or {}).items()
            if kind == "row"}


def answers_as_arrays(answers: list, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids [Q, k] int64 with -1 where absent, scores [Q, k] f64 with
    -inf, each answer's length [Q]) from lists of hits that carry ``.id``
    and ``.score``."""
    q = len(answers)
    ids = np.full((q, k), -1, np.int64)
    scores = np.full((q, k), -np.inf, np.float64)
    lengths = np.zeros(q, np.int64)
    for i, hits in enumerate(answers):
        lengths[i] = len(hits)
        for j, h in enumerate(hits[:k]):
            ids[i, j] = int(h.id)
            scores[i, j] = float(h.score)
    return ids, scores, lengths


def judge(answers: list, queries: np.ndarray, rows: np.ndarray, config: dict,
          traffic: dict, device) -> dict:
    """The numbers above for ``answers`` (one list of hits a query of
    ``queries``)."""
    k = int(traffic["k"])
    metric = config["metric"]
    n = rows.shape[0]
    ids, scores, lengths = answers_as_arrays(answers, k)
    in_range = (ids >= 0) & (ids < n)
    dup = (np.diff(np.sort(ids, axis=1), axis=1) == 0).any(axis=1)
    ordered = (np.diff(scores, axis=1) <= 0).all(axis=1)
    bad = (lengths != k) | ~in_range.all(axis=1) | dup | ~np.isfinite(scores).all(axis=1) | ~ordered
    numbers = {"malformed": int(bad.sum())}

    allowed = reference.where_mask(traffic.get("where"), metadata_columns(config), n)
    if allowed is not None:
        hit = np.where(in_range, ids, 0)
        numbers["off_filter"] = int((in_range & ~allowed[hit]).sum())

    ids_ok = np.where(in_range, ids, -1)
    truth = reference.row_scores(rows, queries, ids_ok, metric)
    kth = reference.kth_best(rows, queries, k, metric, allowed, device)
    valid = in_range & np.isfinite(scores)
    err = np.abs(np.where(valid, scores, 0.0) - np.where(valid, truth, 0.0))
    numbers["score_err"] = float(err.max(initial=0.0))
    gap = np.where(in_range, kth[:, None] - truth, 0.0)
    numbers["rank_gap"] = float(np.maximum(gap, 0.0).max(initial=0.0))
    return numbers


def judge_samples(samples: list, pool: np.ndarray, rows: np.ndarray, config: dict,
                  traffic: dict, device) -> dict:
    """``judge`` over a window's kept calls ((pool rows, answers) each),
    with the count of answers checked; no answers give only the count."""
    if not samples:
        return {"checked": 0}
    idx = np.concatenate([i for i, _ in samples])
    answers = [hits for _, a in samples for hits in a]
    numbers = judge(answers, pool[idx], rows, config, traffic, device)
    numbers["checked"] = len(answers)
    return numbers


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {value, limit}}).
    A number the limits name but the comparison did not give fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, checks
