"""Full-score-matrix search step for corpora below the tiled-scan size.

One ``[B, N]`` score matrix plus a top-k, on the device the tensors live
on. Ties break toward the lower slot index, which reproduces the
reference's stable descending sort over insertion order (reference:
src/index/flat.rs:116): ``torch.topk`` makes no such promise on CUDA, so
selection is a stable descending sort followed by a slice.
"""

from __future__ import annotations

import torch

from ..core.metrics import SimilarityMetric, batched_scores, batched_scores_int8

NEG_INF = float("-inf")


def stable_topk(scores: torch.Tensor, k: int):
    """(values, positions) of the k largest entries of each row; equal
    values keep their positional order (lowest position first)."""
    s, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], pos[..., :k]


def search_topk(
    values: torch.Tensor,  # [cap, D] device dtype
    sqnorms: torch.Tensor,  # [cap] f32
    valid: torch.Tensor,  # [cap] bool
    queries: torch.Tensor,  # [B, D] f32
    *,
    metric: SimilarityMetric,
    k: int,
):
    """Return (scores [B, k], slot_indices [B, k]); invalid slots score -inf."""
    scores = batched_scores(values, sqnorms, queries, metric)
    scores = torch.where(valid[None, :], scores, NEG_INF)
    return stable_topk(scores, k)


def search_topk_int8(
    values_q: torch.Tensor,  # [cap, D] int8
    scales: torch.Tensor,  # [cap] f32
    sqnorms: torch.Tensor,  # [cap] f32 exact squared norms
    valid: torch.Tensor,  # [cap] bool
    queries: torch.Tensor,  # [B, D] f32
    *,
    metric: SimilarityMetric,
    k: int,
):
    """int8-scored top-k (quantized profile); callers re-score the k
    winners exactly on the host."""
    scores = batched_scores_int8(values_q, scales, sqnorms, queries, metric)
    scores = torch.where(valid[None, :], scores, NEG_INF)
    return stable_topk(scores, k)


def update_rows(buffer: torch.Tensor, rows: torch.Tensor, start: int) -> None:
    """Write ``rows`` into ``buffer[start:start+len(rows)]`` in place.

    The reference donates and replaces an immutable buffer; a torch
    tensor is updated where it lies, so no second corpus-sized buffer
    exists even for a moment."""
    buffer[start : start + rows.shape[0]].copy_(rows.to(buffer.dtype))


def row_sqnorms(rows: torch.Tensor) -> torch.Tensor:
    r = rows.to(torch.float32)
    return torch.sum(r * r, dim=-1)


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()
