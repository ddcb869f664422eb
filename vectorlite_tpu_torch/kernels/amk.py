"""Selection surrogates, the operand rule of the reference's matmuls, and
the exact f32 re-score of a candidate pool.

Port of three helpers of ``vectorlite_tpu/kernels/amk.py`` that the IVF
rung (kernels/ivf.py) and the mesh (dist/sharding.py) run:
``_rank_scores`` (:98), ``_matmul`` (:109) and ``_exact_rescore_device``
(:152), the last in two steps here (``sorted_pool``, ``rescore_rows``) for
the mesh, which gathers the pool's rows from its shards. The module's engines,
``amk_search_topk_rescored`` and ``amk_select_int8``, are not here: they
select with ``jax.lax.approx_max_k``, a feature of the TPU compiler with
no CUDA counterpart, and the port's speed path is the lane-group kernel
K3 with an exact re-score (kernels/scan.py) instead.
"""

from __future__ import annotations

import torch

from ..core.metrics import SimilarityMetric, disable_tf32
from .topk import stable_topk

NEG_INF = float("-inf")


def _rank_scores(dot, metric: SimilarityMetric, sqnorms):
    """Monotonic selection surrogate of a [B, N] dot against rows whose
    squared norms are the shared [N] column ``sqnorms``: dot for dot
    product, ``dot * rsqrt(|v|^2)`` for cosine (1/|q| is constant per
    query), ``dot - 0.5 |v|^2`` for euclidean."""
    if metric is SimilarityMetric.DOT_PRODUCT:
        return dot
    if metric is SimilarityMetric.COSINE:
        return dot * torch.rsqrt(torch.clamp(sqnorms, min=1e-30))[None, :]
    if metric is SimilarityMetric.EUCLIDEAN:
        return dot - 0.5 * sqnorms[None, :]
    raise NotImplementedError("manhattan has no matmul-form surrogate")


def _matmul(queries, values):
    """[B, D] x [N, D]^T with f32 accumulation. A bf16 operand rounds the
    queries to bf16 first (each bf16 x bf16 product is exact in f32, so
    casting both up reproduces the reference's bf16 pass); f32 operands
    multiply in full f32, TF32 off."""
    disable_tf32()
    if values.dtype == torch.bfloat16:
        q = queries.to(torch.bfloat16).to(torch.float32)
    else:
        q = queries.to(torch.float32)
    return q @ values.to(torch.float32).T


def _exact_rescore_device(
    i_sel, values_exact, valid, queries, metric, k, live_hi, row_scales=None,
):
    """Gather the pool's rows and re-score them exactly in f32: returns
    (scores [B, k], slots [B, k]).

    ``i_sel`` is sorted by slot first, so the stable top-k breaks equal
    scores to the lowest slot; duplicates (a pool can name a slot twice)
    are masked to -inf after the sort, so no slot is returned twice. The
    row norms come from the gathered rows. With ``valid`` None the slots
    are a contiguous live prefix and a slot is live iff ``slot <
    live_hi``; otherwise ``valid[slot]`` decides. ``row_scales``
    dequantizes int8 rows."""
    i_sel, dup = sorted_pool(i_sel)
    rows = values_exact[i_sel].to(torch.float32)  # [B, k_sel, D]
    if row_scales is not None:
        rows = rows * row_scales[i_sel][..., None]
    ok = i_sel < live_hi if valid is None else valid[i_sel]
    return rescore_rows(i_sel, rows, ok & ~dup, queries, metric, k)


def sorted_pool(i_sel):
    """A candidate pool sorted by slot (int64), and the mask of the
    entries that repeat the slot before them."""
    i_sel = torch.sort(i_sel.to(torch.int64), dim=1).values
    dup = torch.zeros_like(i_sel, dtype=torch.bool)
    dup[:, 1:] = i_sel[:, 1:] == i_sel[:, :-1]
    return i_sel, dup


def rescore_rows(i_sel, rows, ok, queries, metric, k):
    """Exact f32 scores of the gathered pool ``rows`` [B, P, D] (``i_sel``
    sorted by slot), -inf where ``ok`` is false, and their stable top k:
    (scores [B, k], slots [B, k])."""
    disable_tf32()
    q = queries.to(torch.float32)
    dot = torch.bmm(rows, q[:, :, None])[..., 0]
    if metric is SimilarityMetric.DOT_PRODUCT:
        exact = dot
    elif metric is SimilarityMetric.COSINE:
        rowsq = torch.sum(rows * rows, dim=-1)
        qsq = torch.sum(q * q, dim=-1, keepdim=True)
        denom = torch.sqrt(qsq) * torch.sqrt(rowsq)
        exact = torch.where(
            denom > 0.0, dot / torch.clamp(denom, min=1e-30),
            torch.zeros((), dtype=dot.dtype, device=dot.device),
        )
    elif metric is SimilarityMetric.EUCLIDEAN:
        rowsq = torch.sum(rows * rows, dim=-1)
        qsq = torch.sum(q * q, dim=-1, keepdim=True)
        d_sq = torch.clamp(qsq + rowsq - 2.0 * dot, min=0.0)
        exact = 1.0 / (1.0 + torch.sqrt(d_sq))
    else:
        raise NotImplementedError("manhattan has no matmul-form re-score")
    exact = torch.where(ok, exact, NEG_INF)
    s_top, pos = stable_topk(exact, k)
    return s_top, torch.gather(i_sel, 1, pos)
