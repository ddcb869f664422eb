"""Batched HNSW beam search on the index's device.

Port of ``vectorlite_tpu/kernels/beam.py``, which the JAX package writes in
XLA (a ``lax.while_loop``), not Pallas, so here it is torch on whatever
device the graph tensors lie on: the same state, the same step and the
same stop rule.

* state: per-query beam of (node, distance) pairs kept sorted ascending,
  plus an expanded flag per slot — all ``[B, EF]``;
* one iteration = pick each query's best unexpanded node, gather its
  adjacency row, gather + score its neighbors (``[B, M0, D]`` gathers
  feeding one batched reduction), mask already-in-beam duplicates,
  merge-and-resort the beam (stable, so equal distances keep beam order);
* termination: a query goes inactive when its best unexpanded candidate is
  worse than its current beam tail, the loop when all queries are
  inactive or ``max_iters`` hits.

Once no query is active an iteration changes nothing (no slot expands,
every neighbor scores +inf, the stable re-sort keeps the beam), so the
host reads the "any active" flag once every ``CHECK_EVERY`` iterations
instead of after each: the result is that of the reference's loop, with
fewer device-to-host waits.

Upper-level routing (greedy 1-NN descent over levels >= 1) stays on the
host.
"""

from __future__ import annotations

import torch

from ..core.metrics import SimilarityMetric, disable_tf32

INF = float("inf")

#: iterations between two reads of the loop's "any query active" flag
CHECK_EVERY = 8


def _neighbor_dists(
    queries,  # [B, D] f32
    q_norm,  # [B, 1]
    nvecs,  # [B, M, D] gathered neighbor vectors
    n_sq,  # [B, M] gathered squared norms
    metric: SimilarityMetric,
):
    """Internal HNSW distances (smaller = closer), matching index/hnsw.py
    _dist_to_many (reference formulas: src/index/hnsw.rs:113-174, unscaled)."""
    if metric is SimilarityMetric.MANHATTAN:
        return torch.sum(torch.abs(nvecs - queries[:, None, :]), dim=-1)
    if metric is SimilarityMetric.EUCLIDEAN:
        diff = nvecs - queries[:, None, :]
        return torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0))
    # a product and a sum over D rather than a batched matrix product: the
    # sum takes each (query, neighbour) alone, so the mesh beam's parts of
    # a batch score as the whole batch does (dist/hnsw_mesh.py), where the
    # card's batched product picked its kernel by the batch (dots up to
    # 1.5e-5 apart between 256 queries and four parts of 64)
    dot = torch.sum(nvecs * queries[:, None, :], dim=-1)
    if metric is SimilarityMetric.DOT_PRODUCT:
        return 1000.0 - torch.clamp(dot, -1000.0, 1000.0)
    # cosine: 1 - cos, zero-norm -> 1.0 (clamped: f32 cos can pass 1)
    denom = q_norm * torch.sqrt(n_sq)
    cos = torch.where(denom > 0.0, dot / torch.clamp(denom, min=1e-30), 0.0)
    return torch.where(denom > 0.0, torch.clamp(1.0 - cos, min=0.0), 1.0)


def beam_search_l0(
    vecs: torch.Tensor,  # [N, D] f32
    sqnorms: torch.Tensor,  # [N] f32
    adj: torch.Tensor,  # [N, M0] int32, -1 padded
    entries: torch.Tensor,  # [B] int32 entry node per query
    queries: torch.Tensor,  # [B, D] f32
    *,
    metric: SimilarityMetric,
    ef: int,
    max_iters: int,
):
    """Returns (beam_ids [B, EF] int32 sorted by distance, beam_dist
    [B, EF] f32). Unfilled slots are (-1, +inf)."""
    disable_tf32()
    dev = vecs.device
    b = queries.shape[0]
    queries = queries.to(torch.float32)
    q_norm = torch.sqrt(torch.sum(queries * queries, dim=-1, keepdim=True))
    rows = torch.arange(b, device=dev)
    entries = entries.to(device=dev, dtype=torch.long)

    d0 = _neighbor_dists(
        queries, q_norm, vecs[entries][:, None, :], sqnorms[entries][:, None], metric
    )[:, 0]
    beam_ids = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    beam_ids[:, 0] = entries.to(torch.int32)
    beam_dist = torch.full((b, ef), INF, dtype=torch.float32, device=dev)
    beam_dist[:, 0] = d0
    expanded = torch.zeros((b, ef), dtype=torch.bool, device=dev)

    def step(beam_ids, beam_dist, expanded):
        # best unexpanded slot per query
        sel_space = torch.where(expanded | (beam_ids < 0), INF, beam_dist)
        sel = torch.argmin(sel_space, dim=1)
        sel_dist = sel_space[rows, sel]
        tail = beam_dist[:, -1]  # the beam is sorted ascending
        active = (sel_dist < INF) & (sel_dist <= tail)

        expanded = expanded.clone()
        expanded[rows, sel] = expanded[rows, sel] | active
        node = torch.where(active, beam_ids[rows, sel].long(), 0)
        nbrs = adj[node]  # [B, M0]
        valid = (nbrs >= 0) & active[:, None]
        nbrs_safe = torch.clamp(nbrs, min=0).long()
        nd = _neighbor_dists(queries, q_norm, vecs[nbrs_safe], sqnorms[nbrs_safe], metric)
        # dedup against the current beam
        in_beam = torch.any(nbrs[:, :, None] == beam_ids[:, None, :], dim=-1)
        keep = valid & ~in_beam
        nd = torch.where(keep, nd, INF)
        nbrs_masked = torch.where(keep, nbrs, -1)

        # merge + resort to the EF best
        all_ids = torch.cat([beam_ids, nbrs_masked], dim=1)
        all_dist = torch.cat([beam_dist, nd], dim=1)
        all_exp = torch.cat([expanded, torch.zeros_like(keep)], dim=1)
        _, order = torch.sort(all_dist, dim=1, stable=True)
        order = order[:, :ef]
        beam_ids = torch.gather(all_ids, 1, order)
        beam_dist = torch.gather(all_dist, 1, order)
        expanded = torch.gather(all_exp, 1, order)
        return beam_ids, beam_dist, expanded

    it = 0
    while it < max_iters:
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            beam_ids, beam_dist, expanded = step(beam_ids, beam_dist, expanded)
            it += 1
        # is any query still improvable next round?
        nxt = torch.where(expanded | (beam_ids < 0), INF, beam_dist)
        nxt_best = torch.min(nxt, dim=1).values
        if not bool(torch.any((nxt_best < INF) & (nxt_best <= beam_dist[:, -1]))):
            break
    return beam_ids, beam_dist
