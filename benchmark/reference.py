"""The plain reference: exact k-nearest rows in float64, in plain PyTorch.

It works every answer out again from the corpus and the queries the
benchmark made, and imports nothing of the program. Scores follow the
SDK's definitions (higher is better): cosine ``q.v / (|q| |v|)``,
euclidean ``1 / (1 + |q - v|)``, dot ``q.v``, manhattan
``1 / (1 + sum |q - v|)``.
"""

from __future__ import annotations

import numpy as np
import torch

#: corpus rows a block: [Q, BLOCK] float64 scores, 2 GiB at Q = 4,096
BLOCK_ROWS = 1 << 16

METRICS = ("cosine", "euclidean", "dot", "manhattan")


def _scores(q: torch.Tensor, v: torch.Tensor, metric: str) -> torch.Tensor:
    """[Q, n] float64 scores of rows ``v`` for queries ``q`` (both f64)."""
    if metric == "manhattan":
        return 1.0 / (1.0 + torch.cdist(q, v, p=1.0))
    dot = q @ v.T
    if metric == "dot":
        return dot
    qn = torch.linalg.vector_norm(q, dim=1)
    vn = torch.linalg.vector_norm(v, dim=1)
    if metric == "cosine":
        denom = qn[:, None] * vn[None, :]
        return torch.where(denom > 0, dot / denom.clamp_min(1e-300), 0.0).clamp_max(1.0)
    if metric == "euclidean":
        d2 = (qn * qn)[:, None] + (vn * vn)[None, :] - 2.0 * dot
        return 1.0 / (1.0 + d2.clamp_min(0.0).sqrt())
    raise ValueError(f"unknown metric {metric!r}")


def kth_best(rows: np.ndarray, queries: np.ndarray, k: int, metric: str,
             allowed: np.ndarray | None, device) -> np.ndarray:
    """[Q] float64: each query's k-th best score over the allowed rows."""
    q = torch.from_numpy(queries).to(device, torch.float64)
    best = torch.full((q.shape[0], k), -torch.inf, dtype=torch.float64, device=device)
    mask = None if allowed is None else torch.from_numpy(allowed).to(device)
    for lo in range(0, rows.shape[0], BLOCK_ROWS):
        hi = min(lo + BLOCK_ROWS, rows.shape[0])
        v = torch.from_numpy(rows[lo:hi]).to(device, torch.float64)
        s = _scores(q, v, metric)
        if mask is not None:
            s.masked_fill_(~mask[lo:hi][None, :], -torch.inf)
        top = torch.topk(s, min(k, hi - lo), dim=1).values
        best = torch.topk(torch.cat([best, top], dim=1), k, dim=1).values
    return best[:, k - 1].cpu().numpy()


def row_scores(rows: np.ndarray, queries: np.ndarray, ids: np.ndarray,
               metric: str) -> np.ndarray:
    """[Q, k] float64 scores of rows ``ids`` ([Q, k], -1 where absent,
    scored -inf) for their queries, on the host."""
    safe = np.clip(ids, 0, rows.shape[0] - 1)
    v = rows[safe].astype(np.float64)  # [Q, k, D]
    q = queries.astype(np.float64)[:, None, :]
    if metric == "dot":
        out = np.einsum("qkd,qkd->qk", v, np.broadcast_to(q, v.shape))
    elif metric == "cosine":
        dot = np.einsum("qkd,qkd->qk", v, np.broadcast_to(q, v.shape))
        denom = np.linalg.norm(v, axis=2) * np.linalg.norm(q, axis=2)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = np.minimum(np.where(denom > 0, dot / np.maximum(denom, 1e-300), 0.0), 1.0)
    elif metric == "euclidean":
        out = 1.0 / (1.0 + np.linalg.norm(v - q, axis=2))
    elif metric == "manhattan":
        out = 1.0 / (1.0 + np.abs(v - q).sum(axis=2))
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return np.where(ids >= 0, out, -np.inf)


def where_mask(where: dict | None, columns: dict, n: int) -> np.ndarray | None:
    """[n] bool: the rows a ``where`` clause keeps, evaluated over the
    metadata columns (field -> [n] array); None for no clause. Covers the
    comparison, membership and boolean operators; anything else raises."""
    if not where:
        return None

    def field(name, cond):
        col = columns.get(name)
        if col is None:
            return np.zeros(n, bool)
        if not isinstance(cond, dict):
            cond = {"$eq": cond}
        out = np.ones(n, bool)
        for op, arg in cond.items():
            if op == "$eq":
                out &= col == arg
            elif op == "$ne":
                out &= col != arg
            elif op == "$gt":
                out &= col > arg
            elif op == "$gte":
                out &= col >= arg
            elif op == "$lt":
                out &= col < arg
            elif op == "$lte":
                out &= col <= arg
            elif op == "$in":
                out &= np.isin(col, list(arg))
            elif op == "$nin":
                out &= ~np.isin(col, list(arg))
            else:
                raise ValueError(f"the reference has no operator {op!r}")
        return out

    def clause(c):
        out = np.ones(n, bool)
        for key, val in c.items():
            if key == "$and":
                for sub in val:
                    out &= clause(sub)
            elif key == "$or":
                any_ = np.zeros(n, bool)
                for sub in val:
                    any_ |= clause(sub)
                out &= any_
            elif key == "$not":
                out &= ~clause(val)
            else:
                out &= field(key, val)
        return out

    return clause(where)
