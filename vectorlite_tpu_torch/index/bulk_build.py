"""Bulk HNSW construction: the candidate scan on the device, the links on
the host.

Port of ``vectorlite_tpu/index/bulk_build.py``. Classic HNSW insertion
runs one graph beam search per vector on the host. For bulk ingestion the
candidate search is one exact scan instead:

1. The whole corpus buffer (the index's pow2-capacity rows) is uploaded
   once as one ``[cap, D]`` f32 matrix; per-batch candidate validity is
   the horizon ``arange(cap) < batch_end``.
2. Per query chunk, one scan (``_chunk_candidates``) gives each new node
   its top ``SCAN_K`` rows among all earlier rows (plus the current batch,
   so intra-batch edges form), converts scores to internal distances and
   removes the node itself: one small ([B, K] x2) host fetch per chunk.
   The scan is ``scan.pallas_search_topk``: on the card K1 over the f32
   rows at k = 256, the wide mode of the tensor-core body
   (``scan_topk_wide_tf32``, tiles of at most 32,768 rows); on the CPU
   its plain twin. The JAX package selects with XLA's ``approx_max_k`` on
   a TPU, which has no CUDA counterpart; here the selection is exact, as
   PQ's ``approx_max_k`` became ``select_topk``.
3. The native builder (hnsw_bulk_link_heuristic_l0) runs the diversity
   heuristic with on-demand distances and wires forward + reverse links.
4. The nodes drawing level >= 1 go through the classic native insert
   (they carry the upper-layer routing structure and the entry point).
5. One NN-descent refine round (``hnsw_refine_l0``,
   ``VECTORLITE_BULK_REFINE``, default 1) lets nodes adopt the better rows
   their neighbors found: without it a purely local kNN graph navigates
   worse than the classic build's.

Manhattan has no matmul form and keeps the classic path.
``VECTORLITE_BULK_PROFILE=1`` prints the scan / link / upper / refine
split.
"""

from __future__ import annotations

import ctypes as c
import numpy as np
import torch

from ..core.metrics import SimilarityMetric

#: candidates handed to the linking heuristic per node: the nearest
#: NEAR_K plus MID_K mid-range rows strided from ranks [NEAR_K, SCAN_K).
#: Mid-range entries let the diversity heuristic keep shortcut edges —
#: with nearest-only candidates the 1M graph degrades to a hard-to-
#: navigate pure kNN graph (recall@64 0.831 vs classic 0.906).
SCAN_K = 256
NEAR_K = 48
MID_K = 16
CAND_K = NEAR_K + MID_K
#: vectors per insertion batch (defines the candidate horizon)
INSERT_BATCH = 4096
#: query rows per fused device call (one host fetch each)
QUERY_CHUNK = 1024


def _scan_tile(cap: int) -> int:
    """The tile of the candidate scan: the whole (pow2) capacity up to
    the widest tile K1's wide mode takes (its lists name rows by 16-bit
    offsets in a tile), so the merge after it sorts few lists."""
    from ..kernels.scan import WIDE_MAX_TILE

    return min(cap, WIDE_MAX_TILE)


def _chunk_candidates(
    values,  # [cap, D] f32 on the device
    sqnorms,  # [cap] f32
    batch_end: int,
    queries,  # [B, D] f32
    node_ids,  # [B] int32 global row of each query (for self-removal)
    *,
    metric,
    k,
):
    """One scan: top-k over [0, batch_end), similarity -> internal
    distance conversion, self-removal. Returns (rows [B, NEAR_K + MID_K]
    int32 with -1 for removed, dists [B, NEAR_K + MID_K] f32), ascending
    by distance. Candidate-pairwise work happens in native code."""
    from ..kernels.scan import pallas_search_topk

    cap = values.shape[0]
    valid_rows = torch.arange(cap, device=values.device) < batch_end
    scores, rows = pallas_search_topk(
        values, sqnorms, valid_rows, queries, metric=metric, k=k,
        tile_n=_scan_tile(cap),
    )

    # similarity -> internal HNSW distance (ascending order preserved)
    if metric is SimilarityMetric.COSINE:
        # clamp: f32 rounding can push cosine scores past 1.0, which would
        # make the internal distance slightly negative (same fix as the
        # three search implementations)
        cd = torch.clamp(1.0 - scores, min=0.0)
    elif metric is SimilarityMetric.EUCLIDEAN:
        cd = 1.0 / torch.clamp(scores, min=1e-30) - 1.0
    else:  # dot product
        cd = 1000.0 - torch.clamp(scores, -1000.0, 1000.0)

    ok = (rows != node_ids[:, None]) & torch.isfinite(scores)
    rows = torch.where(ok, rows, -1).to(torch.int32)
    cd = torch.where(ok, cd, float("inf")).to(torch.float32)
    # nearest NEAR_K + strided mid-range sample, ascending by distance
    stride = (k - NEAR_K) // MID_K
    sel = torch.cat([
        torch.arange(NEAR_K, device=rows.device),
        NEAR_K + stride * torch.arange(MID_K, device=rows.device),
    ])
    return rows[:, sel], cd[:, sel]


def bulk_build(index, start: int, count: int) -> None:
    """Build graph links for rows [start, start+count) of `index`.

    Preconditions (enforced by HNSWIndex.add_batch): native builder
    present, vector rows already written to the shared buffers, id maps
    populated, metric has a matmul form.
    """
    # engagement marker: benchmarks/tests assert the auto policy
    # actually took this path (bench/bulk_1m.py --mode auto)
    index._bulk_built = True
    import os
    import time

    from .hnsw import _build_threads

    lib = index._nb_lib
    nb = index._nb
    metric = index._metric
    end_total = start + count
    # host-bound link/refine phases parallelize over the row-lock pool
    # (single-core hosts pass 1 and keep the sequential path)
    threads = _build_threads()
    # VECTORLITE_BULK_PROFILE=1 prints the scan/link/upper phase split
    profile = os.environ.get("VECTORLITE_BULK_PROFILE") == "1"
    t_scan = t_link = t_upper = 0.0

    levels = np.empty(count, np.int32)
    lib.hnsw_draw_levels(
        nb, count, levels.ctypes.data_as(c.POINTER(c.c_int32))
    )

    # one upload of the full (pow2-capacity) corpus buffer
    dev = index._device
    values = torch.from_numpy(index._vecs).to(dev, torch.float32, copy=True)
    sqnorms = torch.sum(values * values, dim=-1)

    for b_lo in range(0, count, INSERT_BATCH):
        b_hi = min(b_lo + INSERT_BATCH, count)
        batch_levels = levels[b_lo:b_hi]
        batch_nodes = np.arange(start + b_lo, start + b_hi, dtype=np.int64)

        # classic insert for upper-level nodes (entry/routing structure)
        t0 = time.perf_counter()
        for off in np.nonzero(batch_levels > 0)[0]:
            lib.hnsw_insert_leveled(
                nb, int(batch_nodes[off]), int(batch_levels[off])
            )
        t_upper += time.perf_counter() - t0
        low_mask_all = batch_levels == 0
        if not low_mask_all.any():
            continue

        batch_end = start + b_hi  # candidate horizon
        t0 = time.perf_counter()
        idx_parts, dist_parts, node_parts = [], [], []
        for q_lo in range(b_lo, b_hi, QUERY_CHUNK):
            q_hi = min(q_lo + QUERY_CHUNK, b_hi)
            n_q = q_hi - q_lo
            q = index._vecs[start + q_lo : start + q_hi].astype(np.float32)
            ids = np.arange(start + q_lo, start + q_hi, dtype=np.int32)
            if n_q < QUERY_CHUNK:
                pad = QUERY_CHUNK - n_q
                q = np.concatenate(
                    [q, np.zeros((pad, q.shape[1]), np.float32)]
                )
                ids = np.concatenate([ids, np.full(pad, -1, np.int32)])
            rows, dists = _chunk_candidates(
                values,
                sqnorms,
                batch_end,
                torch.from_numpy(q).to(dev),
                torch.from_numpy(ids).to(dev),
                metric=metric,
                k=SCAN_K,
            )
            rows, dists = rows.cpu().numpy(), dists.cpu().numpy()
            low = low_mask_all[q_lo - b_lo : q_hi - b_lo]
            if not low.any():
                continue
            idx_parts.append(np.ascontiguousarray(rows[:n_q][low], np.int32))
            dist_parts.append(
                np.ascontiguousarray(dists[:n_q][low], np.float32)
            )
            node_parts.append(
                np.arange(start + q_lo, start + q_hi, dtype=np.int64)[low]
            )

        t_scan += time.perf_counter() - t0
        if not node_parts:
            continue
        t0 = time.perf_counter()
        cand_idx = np.ascontiguousarray(np.concatenate(idx_parts))
        cand_dist = np.ascontiguousarray(np.concatenate(dist_parts))
        low_nodes = np.ascontiguousarray(np.concatenate(node_parts))
        lib.hnsw_bulk_link_heuristic_l0(
            nb,
            low_nodes.ctypes.data_as(c.POINTER(c.c_int64)),
            len(low_nodes),
            CAND_K,
            cand_idx.ctypes.data_as(c.POINTER(c.c_int32)),
            cand_dist.ctypes.data_as(c.POINTER(c.c_float)),
            threads,
        )
        t_link += time.perf_counter() - t0

    # NN-descent refinement (native hnsw_refine_l0): each node re-runs
    # the diversity heuristic over neighbors + neighbors-of-neighbors,
    # letting nodes adopt the better rows their neighbors found.
    # VECTORLITE_BULK_REFINE sets the round count (default 1; 0 off).
    from ..utils import env_number

    rounds = env_number(
        "VECTORLITE_BULK_REFINE", 1, cast=lambda s: int(float(s))
    )
    t0 = time.perf_counter()
    if rounds > 0:
        lib.hnsw_refine_l0(nb, rounds, threads)
    t_refine = time.perf_counter() - t0

    index._num_nodes = end_total
    index._entry = int(lib.hnsw_entry(nb))
    index._top_level = int(lib.hnsw_top_level(nb))
    # the last bulk build's phase split, seconds
    index._bulk_split = {
        "scan": t_scan, "link": t_link, "upper": t_upper, "refine": t_refine,
    }
    if profile:
        import sys

        print(
            f"[bulk_build] n={count} scan={t_scan:.1f}s "
            f"link={t_link:.1f}s upper={t_upper:.1f}s "
            f"refine={t_refine:.1f}s (rounds={rounds})",
            file=sys.stderr,
            flush=True,
        )
