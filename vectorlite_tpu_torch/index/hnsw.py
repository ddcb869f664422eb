"""HNSW index — flat adjacency arrays, host build, batched search.

Capability port of the reference HNSWIndex (reference: src/index/hnsw.rs),
re-designed around flat arrays instead of the Rust ``hnsw`` crate's pointer
graph:

* **Adjacency** — per-level int32 ``[cap, M_level]`` arrays padded with -1
  (level 0 has M0 slots, upper levels M), plus per-node levels and a single
  entry point. This layout is directly consumable by the batched device beam
  search kernel (kernels/beam.py) — neighbor expansion is a vectorized gather.
* **Distances** — full-precision float32, NOT the reference's u64 fixed-point
  (f64 × 1000) quantization (reference: src/index/hnsw.rs:113-174). The
  distance→similarity conversion reproduces the reference formulas with the
  quantization removed (reference: src/index/hnsw.rs:51-75), which makes
  scores strictly more accurate; documented deviation.
* **Delete** — soft tombstone: the graph node remains and keeps routing, only
  the id/metadata mappings are dropped so the node can never be returned
  (reference: src/index/hnsw.rs:400-414).
* **Persistence** — stores vectors + metadata only; the graph is rebuilt by
  re-inserting every vector on load (reference: src/index/hnsw.rs:272-360).

Profiles (reference: src/index/hnsw.rs:95-109, compile-time in the reference,
runtime here): default M=16/M0=32, memory-optimized M=8/M0=16,
high-accuracy M=32/M0=64.

Port of ``vectorlite_tpu/index/hnsw.py``. The graph is built and searched
on the host by the native builder (``csrc/hnsw_builder.cpp``, bound as
``native.HNSW``) or by the Python twin below when it is off or failed to
build; both give the JAX package's graph for a seed at one build thread.
The index takes an explicit ``device`` as ``FlatIndex`` does (``None`` is
the CUDA card, and raises without one): its device copy (``_sync_device``)
feeds the level-0 beam (``kernels/beam.py``) and the bulk build's scan
(``index/bulk_build.py``, K1's wide mode on the card). A ``mesh`` is
refused until the multi-device port.
"""

from __future__ import annotations

import heapq
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..core.metrics import SimilarityMetric
from ..core.types import SearchResult, Vector
from ..errors import (
    DimensionMismatch,
    DuplicateVectorId,
    MetricMismatch,
    VectorNotFound,
)

_MIN_CAPACITY = 256

#: Beam width used during construction (standard HNSW ef_construction).
DEFAULT_EF_CONSTRUCTION = 100

#: Default search beam. The reference searches with ef == k
#: (reference: src/index/hnsw.rs:437-448) which caps recall at small k;
#: we default to a wider beam (pass ef_search=None at search time to widen,
#: or construct with ef_search=0 for exact reference behavior).
#: 128 keeps 1M-scale recall@10 >= 0.95 at under a millisecond a query
#: on the native host search (PERF.md, chip_smoke.py phase 9).
DEFAULT_EF_SEARCH = 128


def convert_distance_to_similarity(
    distance: float, metric: SimilarityMetric
) -> float:
    """Distance -> similarity, reference formulas without the x1000
    quantization (reference: src/index/hnsw.rs:51-75).

    Internal distances here: euclidean = L2, manhattan = L1,
    cosine = 1 - cos, dotproduct = 1000 - clamp(dot, -1000, 1000)
    (the reference's pre-scaling values).
    """
    # direct env probe (not env_number): this runs once per returned
    # hit on the serving path; a dict lookup is ~100 ns while the
    # helper's function-local import paid the import-machinery lock
    # per hit. Stays uncached so tests/operators can flip it live.
    if os.environ.get("VECTORLITE_REFERENCE_SCORES") == "1":
        return reference_score(distance, metric)
    if metric is SimilarityMetric.EUCLIDEAN:
        return 1.0 / (1.0 + distance)
    if metric is SimilarityMetric.COSINE:
        return 1.0 - distance
    if metric is SimilarityMetric.MANHATTAN:
        return 1.0 / (1.0 + distance)
    # DotProduct (reference: src/index/hnsw.rs:67-73)
    return min(max((1000.0 - distance) / 1000.0, 0.0), 1.0)


def reference_score(distance: float, metric: SimilarityMetric) -> float:
    """Bit-faithful reproduction of the reference's HNSW score pipeline
    (VECTORLITE_REFERENCE_SCORES=1 routes serving through this).

    The reference stores distances as ``trunc(raw * 1000) as u64``
    (reference: src/index/hnsw.rs:113-174), divides by 1000 at the call
    site (hnsw.rs:478) and converts (hnsw.rs:51-75). For cosine and dot
    the conversion divides by 1000 AGAIN, so reference scores live in
    ~[0.998, 1.0]:

      euclidean/manhattan: 1 / (1 + trunc(1000*d)/1000)
          -> drift vs our exact 1/(1+d) is bounded by the quantization
             step: |delta| <= 1e-3, monotonicity preserved up to 1e-3
             raw-distance ties (quantified in tests/test_score_parity.py)
      cosine:  1 - trunc(1000*(1-cos))/1e6          (~[0.998, 1])
      dot:     clamp((1000 - trunc(1000-clamp(dot))/1000)/1000, 0, 1)

    Our default mode returns un-quantized, un-compressed scores
    (documented deviation, README "HNSW score scale"); this mode exists
    for drop-in numeric compatibility during migrations.
    """
    q = float(int(distance * 1000.0)) / 1000.0  # u64 trunc + /1000
    if metric is SimilarityMetric.EUCLIDEAN:
        return 1.0 / (1.0 + q)
    if metric is SimilarityMetric.COSINE:
        return 1.0 - q / 1000.0
    if metric is SimilarityMetric.MANHATTAN:
        return 1.0 / (1.0 + q)
    return min(max((1000.0 - q) / 1000.0, 0.0), 1.0)


def _threads_from_env(var: str) -> int:
    """Worker count for native thread fan-out (build or batched search).

    The env var overrides; defaults to the host CPU count (1 on
    single-core boxes -> sequential, deterministic builds)."""
    import os

    from ..utils import env_number

    return max(1, env_number(var, os.cpu_count() or 1))


def _build_threads() -> int:
    return _threads_from_env("VECTORLITE_BUILD_THREADS")


def _search_threads() -> int:
    return _threads_from_env("VECTORLITE_SEARCH_THREADS")


class HNSWIndex:
    """Approximate nearest-neighbor index over flat adjacency arrays."""

    def __init__(
        self,
        dim: int,
        metric: SimilarityMetric,
        *,
        m: int = 16,
        m0: int = 32,
        ef_construction: int = DEFAULT_EF_CONSTRUCTION,
        ef_search: int = DEFAULT_EF_SEARCH,
        seed: int = 0x7E57,
        store_f64: bool = True,
        native: Optional[bool] = None,
        mesh=None,
        device=None,
    ):
        if dim == 0:
            raise ValueError("HNSW index dimension cannot be 0")
        if mesh is not None:
            raise ValueError(
                "serving an HNSW graph over several devices is not ported "
                "yet; one device serves every collection"
            )
        self.dim = int(dim)
        self._metric = metric
        self._device = resolve_device(device)
        self.m = int(m)
        self.m0 = int(m0)
        self.ef_construction = int(ef_construction)
        self.ef_search = int(ef_search)
        self._ml = 1.0 / math.log(self.m)
        self._rng = np.random.default_rng(seed)
        self._store_f64 = store_f64

        cap = _MIN_CAPACITY
        self._capacity = cap
        self._vecs = np.zeros((cap, self.dim), dtype=np.float32)
        self._vecs64 = (
            np.zeros((cap, self.dim), dtype=np.float64) if store_f64 else None
        )
        self._sqnorms = np.zeros(cap, dtype=np.float32)
        self._norms = np.zeros(cap, dtype=np.float32)
        self._levels = np.full(cap, -1, dtype=np.int32)
        # adjacency: level -> int32 [cap, M_level], -1 padded
        self._adj: list[np.ndarray] = [
            np.full((cap, self.m0), -1, dtype=np.int32)
        ]
        self._num_nodes = 0
        self._entry = -1
        self._top_level = -1

        # id bookkeeping (reference: src/index/hnsw.rs:197-213)
        self._id_to_index: dict[int, int] = {}
        self._index_to_id: dict[int, int] = {}
        self._texts: dict[int, str] = {}
        self._metas: dict[int, object] = {}
        # metadata-filter cache (core/filter.py:FilterCache). _epoch is
        # the STRUCTURAL epoch: delete/metadata updates bump it (full
        # rebuild; compact swaps in a fresh index state wholesale);
        # appends only advance _num_nodes and extend entries
        # incrementally (see _where_nodes).
        self._epoch = 0
        from ..core.filter import FilterCache

        self._where_cache = FilterCache()
        # device-search cache: vectors synced by append watermark, level-0
        # adjacency rows by dirty set (links/prunes touch scattered rows)
        self._dev = None  # (vecs, sqnorms, adj0) tensors on the device
        self._dev_n = 0
        self._vec_synced = 0
        self._adj_dirty: set[int] = set()
        # sync + dispatch atomicity (update_rows donates old buffers)
        import threading

        self._dev_lock = threading.Lock()

        # native C++ builder (graph construction + host search); the
        # level-0 adjacency / vectors / levels buffers above are shared
        # with it (see native/hnsw_builder.cpp memory contract)
        self._nb = None
        self._nb_lib = None
        if native is not False:
            from ..native import HNSW

            lib = HNSW.library()
            if lib is not None:
                self._nb_lib = lib
                metric_code = {
                    SimilarityMetric.COSINE: 0,
                    SimilarityMetric.EUCLIDEAN: 1,
                    SimilarityMetric.MANHATTAN: 2,
                    SimilarityMetric.DOT_PRODUCT: 3,
                }[metric]
                self._nb = lib.hnsw_new(
                    self.dim,
                    metric_code,
                    self.m,
                    self.m0,
                    self.ef_construction,
                    seed & 0xFFFFFFFFFFFFFFFF,
                )
                self._native_bind()
            elif native is True:
                raise RuntimeError("native hnsw builder unavailable")

    def __del__(self):
        nb = getattr(self, "_nb", None)
        if nb is not None and self._nb_lib is not None:
            self._nb_lib.hnsw_free(nb)
            self._nb = None

    def _native_bind(self) -> None:
        import ctypes as c

        self._nb_lib.hnsw_bind(
            self._nb,
            self._vecs.ctypes.data_as(c.POINTER(c.c_float)),
            self._sqnorms.ctypes.data_as(c.POINTER(c.c_float)),
            self._norms.ctypes.data_as(c.POINTER(c.c_float)),
            self._levels.ctypes.data_as(c.POINTER(c.c_int32)),
            self._adj[0].ctypes.data_as(c.POINTER(c.c_int32)),
            self._capacity,
        )

    def _native_drain_dirty(self) -> None:
        import ctypes as c

        if self._nb is None:
            return
        n = self._nb_lib.hnsw_dirty_count(self._nb)
        if n <= 0:
            return
        buf = np.empty(n, dtype=np.int32)
        got = self._nb_lib.hnsw_drain_dirty(
            self._nb, buf.ctypes.data_as(c.POINTER(c.c_int32)), n
        )
        self._adj_dirty.update(int(x) for x in buf[:got])

    # ----------------------------------------------------------- distances

    def _dist_to_many(self, q32: np.ndarray, nodes: np.ndarray) -> np.ndarray:
        """Distance from query to a set of internal nodes, vectorized."""
        v = self._vecs[nodes]
        m = self._metric
        if m is SimilarityMetric.EUCLIDEAN:
            d = v - q32
            return np.sqrt(np.maximum(np.einsum("nd,nd->n", d, d), 0.0))
        if m is SimilarityMetric.MANHATTAN:
            return np.sum(np.abs(v - q32), axis=-1)
        dot = v @ q32
        if m is SimilarityMetric.DOT_PRODUCT:
            # reference: src/index/hnsw.rs:162-174
            return 1000.0 - np.clip(dot, -1000.0, 1000.0)
        # cosine distance = 1 - cos; zero-norm -> max distance 1.0
        # (reference: src/index/hnsw.rs:125-148, pre-scaling)
        qn = float(np.sqrt(np.dot(q32, q32)))
        vn = self._norms[nodes]
        denom = qn * vn
        with np.errstate(invalid="ignore", divide="ignore"):
            cos = np.where(denom > 0.0, dot / np.maximum(denom, 1e-30), 0.0)
        # clamp: f32 cos can exceed 1 by an ulp for identical vectors
        out = np.maximum(1.0 - cos, 0.0)
        out = np.where((vn == 0.0) | (qn == 0.0), 1.0, out)
        return out.astype(np.float32)

    # ------------------------------------------------------------ graph ops

    def _ensure_capacity(self, n: int) -> None:
        if n <= self._capacity:
            return
        new_cap = self._capacity
        while new_cap < n:
            new_cap *= 2
        # Rows >= _num_nodes were never inserted, so they still hold the
        # initial fill (0 / -1); copy only the live prefix and fill the
        # rest once. np.zeros is calloc-backed (virtual zero pages), so
        # the zero-filled matrices cost O(live) writes — where the old
        # concatenate([a, np.full(...)]) wrote every byte of the new
        # buffer twice.
        live = self._num_nodes

        def pad2(a, fill=0):
            new = np.zeros((new_cap,) + a.shape[1:], dtype=a.dtype)
            new[:live] = a[:live]
            if fill != 0:
                new[live:] = fill
            return new

        self._vecs = pad2(self._vecs)
        if self._vecs64 is not None:
            self._vecs64 = pad2(self._vecs64)
        self._sqnorms = pad2(self._sqnorms)
        self._norms = pad2(self._norms)
        self._levels = pad2(self._levels, -1)
        self._adj = [pad2(a, -1) for a in self._adj]
        self._capacity = new_cap
        if self._nb is not None:
            self._native_bind()  # buffers were reallocated

    def _ensure_level(self, level: int) -> None:
        while len(self._adj) <= level:
            self._adj.append(
                np.full((self._capacity, self.m), -1, dtype=np.int32)
            )

    def _neighbors(self, node: int, level: int) -> np.ndarray:
        row = self._adj[level][node]
        return row[row >= 0]

    def _search_layer(
        self, q32: np.ndarray, eps: list[int], ef: int, level: int
    ) -> list[tuple[float, int]]:
        """Classic HNSW ef-search on one layer. Returns up to ef
        (distance, node) pairs, ascending by distance."""
        eps_arr = np.asarray(sorted(set(eps)), dtype=np.int64)
        dists = self._dist_to_many(q32, eps_arr)
        visited = set(int(n) for n in eps_arr)
        # candidates: min-heap by distance; results: max-heap (negated)
        cand = [(float(d), int(n)) for d, n in zip(dists, eps_arr)]
        heapq.heapify(cand)
        result = [(-d, n) for d, n in cand]
        heapq.heapify(result)
        while len(result) > ef:
            heapq.heappop(result)

        adj = self._adj[level]
        while cand:
            d_c, c = heapq.heappop(cand)
            d_worst = -result[0][0]
            if d_c > d_worst and len(result) >= ef:
                break
            row = adj[c]
            neigh = row[row >= 0]
            fresh = [int(n) for n in neigh if int(n) not in visited]
            if not fresh:
                continue
            visited.update(fresh)
            fresh_arr = np.asarray(fresh, dtype=np.int64)
            nd = self._dist_to_many(q32, fresh_arr)
            for d, n in zip(nd, fresh):
                d = float(d)
                if len(result) < ef or d < -result[0][0]:
                    heapq.heappush(cand, (d, n))
                    heapq.heappush(result, (-d, n))
                    if len(result) > ef:
                        heapq.heappop(result)
        out = [(-nd, n) for nd, n in result]
        out.sort()
        return out

    def _select_heuristic(
        self, candidates: list[tuple[float, int]], m: int
    ) -> list[int]:
        """Malkov's diversity heuristic (no closest-backfill, matching the
        native builder): keep a candidate only if it is closer to the query
        than to every already-kept neighbor. Plain closest-M severs the
        inter-cluster edges and fragments the level-0 graph on clustered
        corpora — see native/hnsw_builder.cpp."""
        if len(candidates) <= m:
            return [n for _, n in candidates]
        selected: list[int] = []
        for d, n in candidates:  # ascending
            if len(selected) >= m:
                break
            if not selected:
                selected.append(n)
                continue
            d_to_sel = self._dist_between(n, np.asarray(selected))
            if np.all(d_to_sel >= d):
                selected.append(n)
        return selected

    def _dist_between(self, node: int, others: np.ndarray) -> np.ndarray:
        return self._dist_to_many(self._vecs[node], others)

    def _link(self, node: int, neighbors: list[int], level: int) -> None:
        m_max = self.m0 if level == 0 else self.m
        row = self._adj[level][node]
        row[: len(neighbors)] = neighbors[:m_max]
        if level == 0:
            self._adj_dirty.add(node)
            self._adj_dirty.update(neighbors)
        # reverse links with pruning
        for nb in neighbors:
            nrow = self._adj[level][nb]
            free = np.nonzero(nrow < 0)[0]
            if free.size:
                nrow[free[0]] = node
                continue
            # prune the overflowing row with the diversity heuristic
            cand_nodes = np.concatenate([nrow, [node]]).astype(np.int64)
            d = self._dist_between(nb, cand_nodes)
            order = np.argsort(d, kind="stable")
            cands = [(float(d[i]), int(cand_nodes[i])) for i in order]
            kept = self._select_heuristic(cands, m_max)
            new_row = np.full(m_max, -1, np.int32)
            new_row[: len(kept)] = kept[:m_max]
            self._adj[level][nb] = new_row

    def _insert_node(self, values32: np.ndarray) -> int:
        node = self._num_nodes
        self._ensure_capacity(node + 1)
        self._vecs[node] = values32
        if self._nb is not None:
            self._nb_lib.hnsw_insert_batch(self._nb, node, 1)
            self._num_nodes = node + 1
            self._entry = int(self._nb_lib.hnsw_entry(self._nb))
            self._top_level = int(self._nb_lib.hnsw_top_level(self._nb))
            return node
        sq = float(np.dot(values32, values32))
        self._sqnorms[node] = sq
        self._norms[node] = math.sqrt(sq)
        level = int(-math.log(max(self._rng.random(), 1e-300)) * self._ml)
        self._levels[node] = level
        self._ensure_level(level)
        self._num_nodes = node + 1

        if self._entry < 0:
            self._entry = node
            self._top_level = level
            return node

        q32 = self._vecs[node]
        ep = [self._entry]
        # greedy descent above the node's level
        for lvl in range(self._top_level, level, -1):
            best = self._search_layer(q32, ep, 1, lvl)
            ep = [best[0][1]] if best else ep
        # ef-search + link from min(level, top) down to 0
        for lvl in range(min(level, self._top_level), -1, -1):
            cands = self._search_layer(q32, ep, self.ef_construction, lvl)
            m_max = self.m0 if lvl == 0 else self.m
            neigh = self._select_heuristic(cands, m_max)
            self._link(node, neigh, lvl)
            ep = [n for _, n in cands] or ep
        if level > self._top_level:
            self._entry = node
            self._top_level = level
        return node

    # ------------------------------------------------------------------ API

    def add(self, vector: Vector) -> None:
        if len(vector.values) != self.dim:
            raise DimensionMismatch(self.dim, len(vector.values))
        vid = int(vector.id)
        if vid in self._id_to_index:
            raise DuplicateVectorId(vid)
        v64 = np.asarray(vector.values, dtype=np.float64)
        node = self._insert_node(v64.astype(np.float32))
        if self._vecs64 is not None:
            self._vecs64[node] = v64
        self._id_to_index[vid] = node
        self._index_to_id[node] = vid
        self._texts[vid] = vector.text
        self._metas[vid] = vector.metadata

    def add_batch(self, vectors: Sequence[Vector]) -> None:
        """Bulk insert: one native call for the whole batch (used by
        rebuild-on-load and high-throughput ingestion)."""
        if self._nb is None:
            for v in vectors:
                self.add(v)
            return
        batch_ids: set[int] = set()
        for v in vectors:
            if len(v.values) != self.dim:
                raise DimensionMismatch(self.dim, len(v.values))
            vid = int(v.id)
            if vid in self._id_to_index or vid in batch_ids:
                raise DuplicateVectorId(vid)
            batch_ids.add(vid)
        start = self._num_nodes
        count = len(vectors)
        self._ensure_capacity(start + count)
        for i, v in enumerate(vectors):
            node = start + i
            v64 = np.asarray(v.values, dtype=np.float64)
            self._vecs[node] = v64.astype(np.float32)
            if self._vecs64 is not None:
                self._vecs64[node] = v64
            vid = int(v.id)
            self._id_to_index[vid] = node
            self._index_to_id[node] = vid
            self._texts[vid] = v.text
            self._metas[vid] = v.metadata
        self._link_batch(start, count)

    def add_batch_arrays(
        self,
        ids: Sequence[int],
        values: np.ndarray,  # [B, D]
        texts: Optional[Sequence[str]] = None,
        metadatas: Optional[Sequence] = None,
    ) -> None:
        """Array-native bulk insert: the embedding block is written into
        the shared native buffers in one vectorized copy (no per-row
        Vector objects). Validation is all-or-nothing like add_batch."""
        from .base import validate_batch_arrays

        int_ids, values = validate_batch_arrays(
            ids, values, self.dim, self._id_to_index.keys(),
            texts=texts, metadatas=metadatas,
        )
        n = len(int_ids)
        if n == 0:
            return
        if self._nb is None:
            for i, vid in enumerate(int_ids):
                self.add(
                    Vector(
                        id=vid,
                        values=values[i],
                        text=texts[i] if texts is not None else "",
                        metadata=(
                            metadatas[i] if metadatas is not None else None
                        ),
                    )
                )
            return
        start = self._num_nodes
        self._ensure_capacity(start + n)
        self._vecs[start : start + n] = values.astype(np.float32)
        if self._vecs64 is not None:
            self._vecs64[start : start + n] = values
        nodes = range(start, start + n)
        self._id_to_index.update(zip(int_ids, nodes))
        self._index_to_id.update(zip(nodes, int_ids))
        self._texts.update(
            zip(int_ids, texts if texts is not None else [""] * n)
        )
        self._metas.update(
            zip(int_ids, metadatas if metadatas is not None else [None] * n)
        )
        self._link_batch(start, n)

    def _link_batch(self, start: int, count: int) -> None:
        """Link rows [start, start+count) into the graph natively.

        Build-size policy (VECTORLITE_BULK_BUILD, default "auto"): the
        bulk build + NN-descent refine (index/bulk_build.py) auto-engages
        when this batch takes the graph past VECTORLITE_BULK_AUTO_ROWS
        (default 400K) on a CUDA device, where the JAX package asks for a
        TPU backend: the regime where the JAX package measured it the
        recall-per-byte choice (its bench/report_bulk_1m.json); below the
        threshold the classic SIMD build keeps small graphs.
        "always"/"never" force either path; Manhattan has no matmul
        form and always builds classic. The link/refine phases thread
        over the row-lock pool (VECTORLITE_BUILD_THREADS)."""
        mode = os.environ.get("VECTORLITE_BULK_BUILD", "auto")
        if mode == "auto":
            from ..utils import env_number

            threshold = int(
                env_number("VECTORLITE_BULK_AUTO_ROWS", 400_000)
            )
            use_bulk = (
                self._metric is not SimilarityMetric.MANHATTAN
                and start + count >= threshold
                and self._device.type == "cuda"
            )
        else:
            use_bulk = (
                self._metric is not SimilarityMetric.MANHATTAN
                and mode == "always"
            )
        if use_bulk:
            from .bulk_build import bulk_build

            bulk_build(self, start, count)
            return
        # hnswlib-recipe parallel build: per-row lock pool + per-thread
        # visited scratch in the native builder (the reference builds
        # single-threaded under the collection RwLock; rayon is only used
        # for batch *embedding*, src/embeddings.rs:269-276)
        threads = _build_threads()
        if threads > 1 and count >= 512:
            self._nb_lib.hnsw_insert_batch_parallel(
                self._nb, start, count, threads
            )
        else:
            self._nb_lib.hnsw_insert_batch(self._nb, start, count)
        self._num_nodes = start + count
        self._entry = int(self._nb_lib.hnsw_entry(self._nb))
        self._top_level = int(self._nb_lib.hnsw_top_level(self._nb))

    def delete(self, id: int) -> None:
        """Soft tombstone (reference: src/index/hnsw.rs:400-414)."""
        vid = int(id)
        node = self._id_to_index.pop(vid, None)
        if node is None:
            raise VectorNotFound(vid)
        self._index_to_id.pop(node, None)
        self._texts.pop(vid, None)
        self._metas.pop(vid, None)
        self._epoch += 1

    def delete_where(self, where) -> int:
        """Bulk soft-tombstone every live vector whose metadata matches
        ``where`` (extension — the reference deletes only by
        id, reference: src/index/hnsw.rs:400-414). Graph nodes keep
        routing, as with single delete; ``compact()`` reclaims them.
        ``{}`` is an explicit match-all; raises InvalidFilter on a
        malformed clause. Returns the count deleted."""
        _, vids = self._where_nodes(where)
        if not vids:
            return 0
        # vids is the cache entry's own set: iterate a snapshot, and the
        # epoch bump below invalidates the (now stale) entry.
        doomed = list(vids)
        for vid in doomed:
            node = self._id_to_index.pop(vid, None)
            if node is not None:
                self._index_to_id.pop(node, None)
            self._texts.pop(vid, None)
            self._metas.pop(vid, None)
        self._epoch += 1
        return len(doomed)

    def compact(self) -> int:
        """Rebuild the graph from live vectors, reclaiming tombstones.

        Extension past the reference, which leaks soft-deleted nodes
        forever (they keep routing searches and holding memory,
        reference: src/index/hnsw.rs:400-414). O(N·insert) — an offline
        maintenance operation in the same cost class as the reference's
        load-time rebuild; callers hold the collection write lock.
        Returns the number of tombstoned nodes reclaimed.
        """
        dead = self._num_nodes - len(self._id_to_index)
        if dead <= 0:
            return 0
        # live vectors in insertion (node) order, preserving id sequence
        live = sorted(self._id_to_index.items(), key=lambda kv: kv[1])
        src = self._vecs64 if self._vecs64 is not None else self._vecs
        vectors = [
            Vector(
                id=vid,
                values=[float(x) for x in src[node]],
                text=self._texts.get(vid, ""),
                metadata=self._metas.get(vid),
            )
            for vid, node in live
        ]
        fresh = HNSWIndex(
            self.dim,
            self._metric,
            m=self.m,
            m0=self.m0,
            ef_construction=self.ef_construction,
            ef_search=self.ef_search,
            store_f64=self._store_f64,
            native=self._nb is not None,
            device=self._device,
        )
        fresh.add_batch(vectors)
        # Adopt the rebuilt state wholesale (same object identity).
        # The old state dict stays with `fresh`, whose __del__ then
        # frees the OLD native builder; the adopted dict must be a
        # different object or that same __del__ would free the new one.
        old_state, new_state = self.__dict__, dict(fresh.__dict__)
        fresh.__dict__ = old_state  # fresh's __del__ frees the OLD builder
        self.__dict__ = new_state
        return dead


    def search(
        self,
        query: Sequence[float],
        k: int,
        metric: SimilarityMetric,
        *,
        ef: Optional[int] = None,
        use_device: Optional[bool] = None,
        where: Optional[dict] = None,
    ) -> list[SearchResult]:
        return self.search_batch(
            [query], k, metric, ef=ef, use_device=use_device, where=where
        )[0]

    def search_batch(
        self,
        queries: Sequence[Sequence[float]],
        k: int,
        metric: SimilarityMetric,
        *,
        ef: Optional[int] = None,
        use_device: Optional[bool] = None,
        where: Optional[dict] = None,
    ) -> list[list[SearchResult]]:
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim != 2:
            raise ValueError("queries must be [B, D]")
        if q.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, q.shape[1])
        # HNSW graphs are metric-specific (reference: src/index/hnsw.rs:425-430)
        if metric is not self._metric:
            raise MetricMismatch(metric, self._metric)
        if where is not None:
            return self._search_filtered(q, k, metric, ef, use_device, where)
        k = int(k)
        live = len(self._id_to_index)
        if live == 0 or k <= 0:
            return [[] for _ in range(len(q))]

        # Beam width: the reference uses ef == min(k, len)
        # (reference: src/index/hnsw.rs:437-448); our default widens it.
        if ef is None:
            ef = self.ef_search
        ef_eff = min(k, live) if ef <= 0 else max(min(k, live), ef)

        if use_device is None:
            # Measured policy: the native C++ host search wins whenever
            # available (pointer-chasing beats sequential device beam
            # iterations); the device beam wins over the *Python* host
            # fallback for batched queries on larger graphs. Batched
            # exact search should generally use FlatIndex instead —
            # see README "Measured".
            use_device = (
                self._nb is None and self._num_nodes >= 4096 and len(q) >= 8
            )
        if use_device:
            return self._search_device(q, k, ef_eff)
        if self._nb is not None and len(q) > 1:
            # one FFI crossing for the whole block, thread fan-out inside
            return self._native_search_block(q, k, ef_eff)
        out = []
        for qi in q:
            out.append(self._search_one(qi, k, ef_eff))
        return out

    # -------------------------------------------------- metadata filtering

    #: below this match count (or 4k) filtered search scores the matching
    #: rows exactly instead of traversing the graph — brute force over a
    #: few thousand rows beats any beam there and returns EXACT top-k
    _FILTER_BRUTE_MAX = 2048

    def _where_nodes(self, where):
        """Matching live nodes for a ``where`` clause (core/filter.py),
        cached per structural epoch with append-incremental extension
        (nodes are assigned sequentially, so rows [upto, _num_nodes)
        are exactly the appends since the entry was built). Compiled
        from the canonical JSON so cache-key identity implies predicate
        identity. Returns (nodes int64 ascending, matching-vid set).
        Raises InvalidFilter on a malformed clause.

        Entry layout: [struct_epoch, evaluated_upto, nodes, vid_set]."""
        from ..core.filter import canonicalize, compile_where
        from ..observability import filter_stats

        where, key = canonicalize(where)
        ent = self._where_cache.get(key)
        if ent is not None and ent[0] == self._epoch:
            if ent[1] == self._num_nodes:
                filter_stats.record("hit")
                return ent[2], ent[3]
            pred = compile_where(where)
            fresh = self._match_node_range(pred, ent[1], self._num_nodes)
            filter_stats.record("extend", self._num_nodes - ent[1])
            nodes = np.concatenate(
                [ent[2], np.fromiter((p[0] for p in fresh), np.int64,
                                     count=len(fresh))]
            )
            vids = set(ent[3])
            vids.update(p[1] for p in fresh)
            ent = [self._epoch, self._num_nodes, nodes, vids]
            self._where_cache.put(key, ent)
            return nodes, vids
        pred = compile_where(where)
        pairs = self._match_node_range(pred, 0, self._num_nodes)
        nodes = np.fromiter(
            (p[0] for p in pairs), dtype=np.int64, count=len(pairs)
        )
        vids = {p[1] for p in pairs}
        self._where_cache.put(
            key, [self._epoch, self._num_nodes, nodes, vids]
        )
        filter_stats.record("build", self._num_nodes)
        return nodes, vids

    def _match_node_range(self, pred, lo: int, hi: int):
        """(node, vid) pairs in [lo, hi) whose live metadata matches,
        ascending by node."""
        metas = self._metas
        index_to_id = self._index_to_id
        out = []
        for node in range(lo, hi):
            vid = index_to_id.get(node)
            if vid is not None and pred(metas.get(vid)):
                out.append((node, vid))
        return out

    def _search_filtered(
        self, q, k, metric, ef, use_device, where
    ) -> list[list[SearchResult]]:
        """Metadata-filtered search (extension — the
        reference has no filtered search).

        Selective filters (matches <= max(4k, _FILTER_BRUTE_MAX)) are
        scored EXACTLY by brute force over the matching rows — cheaper
        than any traversal and immune to the classic filtered-HNSW
        recall collapse. Broader filters run the normal beam with ef
        widened by the selectivity ratio and post-filter the hits,
        escalating ef up to two more rounds when metadata clusters
        starve the beam; results there inherit HNSW's approximate
        contract."""
        b = q.shape[0]
        k = int(k)
        nodes, vid_set = self._where_nodes(where)
        m = len(nodes)
        if m == 0 or k <= 0:
            return [[] for _ in range(b)]
        if m == len(self._id_to_index):
            # matches every live node: the filter is a no-op
            return self.search_batch(
                q, k, metric, ef=ef, use_device=use_device
            )
        k_eff = min(k, m)
        live = len(self._id_to_index)
        ef_base = self.ef_search if ef is None else int(ef)
        ef_base = min(k, live) if ef_base <= 0 else max(ef_base, k_eff)
        # widen the beam by the selectivity ratio so ~2x k_eff matches
        # are expected among the candidates
        scale = -(-live // m)  # ceil
        ef_try = min(live, max(ef_base, 2 * k_eff * scale, 64))
        # Brute-force the matching rows when (a) the match set is small
        # in absolute terms, or (b) the widened beam would visit at
        # least as many nodes as a direct scan of the matches — the beam
        # pays graph overhead per node on top of the same distance
        # evals, so ef_try >= m makes brute strictly cheaper AND exact.
        if m <= max(4 * k_eff, self._FILTER_BRUTE_MAX) or ef_try >= m:
            out = []
            for qi in q:
                d = self._dist_to_many(qi, nodes)
                order = np.argsort(d, kind="stable")[:k_eff]
                out.append(
                    self._cands_to_hits(
                        [(float(d[j]), int(nodes[j])) for j in order],
                        k_eff,
                    )
                )
            return out
        results: list = [None] * b
        pending = list(range(b))
        for _ in range(3):
            res = self.search_batch(
                q[pending],
                ef_try,
                metric,
                ef=ef_try,
                use_device=use_device,
            )
            still = []
            for row, bi in zip(res, pending):
                hits = [h for h in row if h.id in vid_set][:k_eff]
                results[bi] = hits
                if len(hits) < k_eff and ef_try < live:
                    still.append(bi)
            pending = still
            if not pending:
                break
            ef_try = min(live, ef_try * 4)
        return results

    def _native_search_block(
        self, q: np.ndarray, k: int, ef: int
    ) -> list[list[SearchResult]]:
        import ctypes as c

        b = q.shape[0]
        qc = np.ascontiguousarray(q, dtype=np.float32)
        out_ids = np.empty((b, ef), np.int32)
        out_d = np.empty((b, ef), np.float32)
        out_n = np.empty(b, np.int32)
        self._nb_lib.hnsw_search_batch(
            self._nb,
            qc.ctypes.data_as(c.POINTER(c.c_float)),
            b,
            ef,
            out_ids.ctypes.data_as(c.POINTER(c.c_int32)),
            out_d.ctypes.data_as(c.POINTER(c.c_float)),
            out_n.ctypes.data_as(c.POINTER(c.c_int32)),
            _search_threads(),
        )
        results = []
        for i in range(b):
            n = int(out_n[i])
            cands = [
                (float(out_d[i, j]), int(out_ids[i, j])) for j in range(n)
            ]
            results.append(self._cands_to_hits(cands, k))
        return results

    def _native_search(self, q32: np.ndarray, ef: int):
        import ctypes as c

        q = np.ascontiguousarray(q32, dtype=np.float32)
        out_ids = np.empty(ef, np.int32)
        out_d = np.empty(ef, np.float32)
        n = self._nb_lib.hnsw_search(
            self._nb,
            q.ctypes.data_as(c.POINTER(c.c_float)),
            ef,
            out_ids.ctypes.data_as(c.POINTER(c.c_int32)),
            out_d.ctypes.data_as(c.POINTER(c.c_float)),
        )
        return [(float(out_d[i]), int(out_ids[i])) for i in range(n)]

    def _descend_entry(self, q32: np.ndarray) -> int:
        """Host greedy 1-NN descent over levels >= 1."""
        if self._nb is not None:
            import ctypes as c

            q = np.ascontiguousarray(q32, dtype=np.float32)
            return int(
                self._nb_lib.hnsw_descend(
                    self._nb, q.ctypes.data_as(c.POINTER(c.c_float))
                )
            )
        ep = [self._entry]
        for lvl in range(self._top_level, 0, -1):
            best = self._search_layer(q32, ep, 1, lvl)
            ep = [best[0][1]] if best else ep
        return ep[0]

    def _sync_device(self) -> None:
        """Bring the device copy (vectors, squared norms, level-0
        adjacency, each ``_capacity`` rows) up to the host buffers: a full
        upload when the capacity changed or the state is fresh, else the
        appended rows written in place (``update_rows``) and the dirty
        adjacency rows scattered."""
        from ..kernels.topk import update_rows

        self._native_drain_dirty()
        n = self._num_nodes
        dev = self._device
        if (
            self._dev is None
            or self._dev[0].shape[0] != self._capacity
            or n < self._dev_n
        ):
            # full (re)build: capacity grew or state is fresh (a copy on
            # the CPU too, never a view of the buffers the builder writes)
            self._dev = tuple(
                torch.from_numpy(a).to(dev, copy=True)
                for a in (self._vecs, self._sqnorms, self._adj[0])
            )
        else:
            vecs, sqn, adj = self._dev
            if n > self._vec_synced:
                lo = self._vec_synced
                update_rows(vecs, torch.from_numpy(self._vecs[lo:n]).to(dev), lo)
                update_rows(sqn, torch.from_numpy(self._sqnorms[lo:n]).to(dev), lo)
            if self._adj_dirty:
                idx = np.fromiter(
                    (i for i in self._adj_dirty if i < n),
                    dtype=np.int64,
                )
                adj[torch.from_numpy(idx).to(dev)] = torch.from_numpy(
                    self._adj[0][idx]
                ).to(dev)
        self._dev_n = n
        self._vec_synced = n
        self._adj_dirty.clear()

    def _search_device(
        self, q: np.ndarray, k: int, ef: int
    ) -> list[list[SearchResult]]:
        from ..kernels.beam import beam_search_l0
        from ..kernels.topk import next_pow2

        b = q.shape[0]
        entries = np.fromiter(
            (self._descend_entry(qi) for qi in q), dtype=np.int32, count=b
        )
        ef_pad = next_pow2(max(ef, 8))
        b_pad = next_pow2(b)
        if b_pad > b:
            q = np.concatenate([q, np.zeros((b_pad - b, self.dim), np.float32)])
            entries = np.concatenate(
                [entries, np.zeros(b_pad - b, np.int32)]
            )
        with self._dev_lock:
            self._sync_device()
            vecs, sqn, adj = self._dev
            beam_ids, beam_dist = beam_search_l0(
                vecs,
                sqn,
                adj,
                torch.from_numpy(entries).to(self._device),
                torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(self._device),
                metric=self._metric,
                ef=ef_pad,
                max_iters=4 * ef_pad + 32,
            )
        beam_ids = beam_ids.cpu().numpy()[:b]
        beam_dist = beam_dist.cpu().numpy()[:b]
        out: list[list[SearchResult]] = []
        for row_ids, row_dist in zip(beam_ids, beam_dist):
            hits: list[SearchResult] = []
            for node, d in zip(row_ids, row_dist):
                if node < 0 or d == np.inf:
                    continue
                vid = self._index_to_id.get(int(node))
                if vid is None:
                    continue  # tombstoned
                hits.append(
                    SearchResult(
                        id=vid,
                        score=convert_distance_to_similarity(
                            float(d), self._metric
                        ),
                        text=self._texts.get(vid, ""),
                        metadata=self._metas.get(vid),
                    )
                )
                if len(hits) >= k:
                    break
            out.append(hits)
        return out

    def _search_one(self, q32: np.ndarray, k: int, ef: int):
        if self._nb is not None:
            cands = self._native_search(q32, ef)
        else:
            ep = [self._entry]
            for lvl in range(self._top_level, 0, -1):
                best = self._search_layer(q32, ep, 1, lvl)
                ep = [best[0][1]] if best else ep
            cands = self._search_layer(q32, ep, ef, 0)
        return self._cands_to_hits(cands, k)

    def _cands_to_hits(self, cands, k: int) -> list[SearchResult]:
        hits: list[SearchResult] = []
        for d, node in cands:  # ascending distance == descending similarity
            vid = self._index_to_id.get(node)
            if vid is None:
                continue  # tombstoned: routed through but never returned
            hits.append(
                SearchResult(
                    id=vid,
                    score=convert_distance_to_similarity(
                        float(d), self._metric
                    ),
                    text=self._texts.get(vid, ""),
                    metadata=self._metas.get(vid),
                )
            )
            if len(hits) >= k:
                break
        return hits

    def __len__(self) -> int:
        return len(self._id_to_index)

    def is_empty(self) -> bool:
        return not self._id_to_index

    def get_vector(
        self, id: int, *, include_values: bool = True
    ) -> Optional[Vector]:
        vid = int(id)
        node = self._id_to_index.get(vid)
        if node is None:
            return None
        if not include_values:
            values = []
        elif self._vecs64 is not None:
            values = [float(x) for x in self._vecs64[node]]
        else:
            values = [float(x) for x in self._vecs[node]]
        return Vector(
            id=vid,
            values=values,
            text=self._texts.get(vid, ""),
            metadata=self._metas.get(vid),
        )

    def update_metadata(self, id: int, metadata) -> None:
        """Replace a vector's metadata in place (extension —
        the reference can only delete + re-add). ``None`` clears; the
        graph and vectors are untouched."""
        vid = int(id)
        if vid not in self._id_to_index:
            raise VectorNotFound(vid)
        self._metas[vid] = metadata
        self._epoch += 1

    def list_vectors(
        self,
        offset: int = 0,
        limit: int = 100,
        where: Optional[dict] = None,
        include_values: bool = False,
    ) -> tuple:
        """Page through live vectors in insertion (node) order,
        optionally where-filtered (extension; see FlatIndex.list_vectors
        for the contract). Returns (page, total matching count)."""
        offset = max(0, int(offset))
        limit = max(0, int(limit))
        if where is not None:
            nodes, _ = self._where_nodes(where)
            node_list = [int(n) for n in nodes]
        else:
            node_list = sorted(self._index_to_id)
        total = len(node_list)
        src = self._vecs64 if self._vecs64 is not None else self._vecs
        out = []
        for node in node_list[offset : offset + limit]:
            vid = self._index_to_id.get(node)
            if vid is None:
                continue
            out.append(
                Vector(
                    id=vid,
                    values=(
                        [float(x) for x in src[node]]
                        if include_values
                        else []
                    ),
                    text=self._texts.get(vid, ""),
                    metadata=self._metas.get(vid),
                )
            )
        return out, total

    @property
    def dimension(self) -> int:
        return self.dim

    @property
    def device(self) -> torch.device:
        return self._device

    def metric(self) -> Optional[SimilarityMetric]:
        return self._metric

    @property
    def index_type(self) -> str:
        return "HNSW"

    def max_id(self) -> Optional[int]:
        if not self._id_to_index:
            return None
        return max(self._id_to_index)

    # ----------------------------------------------------------- persistence

    def index_to_json(self, include_graph: Optional[bool] = None) -> dict:
        """Reference serde shape (reference: src/index/hnsw.rs:197-213),
        plus an optional ``graph`` extension: a CSR dump of the adjacency
        so our loader can skip the reference's O(N*insert) rebuild
        (reference: src/index/hnsw.rs:272-360). The reference's serde
        deserializer ignores unknown fields, so files with the extension
        still load in the Rust engine. The dump is only emitted when no
        tombstones exist (tombstoned routing nodes' vectors are not part
        of the reference payload); disable via VECTORLITE_VLC_GRAPH=0."""
        import os

        if include_graph is None:
            include_graph = os.environ.get("VECTORLITE_VLC_GRAPH") != "0"
        payload = self._base_payload()
        if include_graph and len(self._id_to_index) == self._num_nodes > 0:
            n = self._num_nodes
            _, adj0, entry, levels, upper = self.graph_arrays()
            payload["graph"] = {
                "format": "vectorlite-tpu-csr-v1",
                "num_nodes": n,
                "entry": int(entry),
                "top_level": int(self._top_level),
                "m": self.m,
                "m0": self.m0,
                # int64 ndarrays stream through the native emitter
                # (persist/vlc.py); byte-identical to int lists
                "levels": np.array(levels, dtype=np.int64),
                "adj0": np.array(adj0.ravel(), dtype=np.int64),
                "upper": [
                    np.array(a.ravel(), dtype=np.int64) for a in upper
                ],
            }
        return payload

    def _base_payload(self) -> dict:
        vector_values = {}
        for vid, node in self._id_to_index.items():
            src = self._vecs64 if self._vecs64 is not None else self._vecs
            # COPIED f64 row (np.array, not a view): rendered after the
            # collection lock drops; streamed by the native emitter
            vector_values[str(vid)] = np.array(src[node], dtype=np.float64)
        return {
            "dim": self.dim,
            "metric": self._metric.variant_name(),
            "id_to_index": {
                str(vid): node for vid, node in self._id_to_index.items()
            },
            "index_to_id": {
                str(node): vid for node, vid in self._index_to_id.items()
            },
            "metadata": {
                str(vid): {
                    "text": self._texts.get(vid, ""),
                    "metadata": self._metas.get(vid),
                }
                for vid in self._id_to_index
            },
            "vector_values": vector_values,
        }

    @classmethod
    def index_from_json(cls, obj: dict, **kwargs) -> "HNSWIndex":
        """Rebuild by re-inserting every stored vector
        (reference: src/index/hnsw.rs:272-360). Only dim/metric/metadata/
        vector_values are read; id_to_index/index_to_id are regenerated."""
        dim = int(obj["dim"])
        if dim == 0:
            raise ValueError("Invalid dimension: cannot be 0")
        metric = SimilarityMetric.from_serde(obj["metric"])
        metadata = obj.get("metadata", {})
        vector_values = obj.get("vector_values", {})
        for vid_str, values in vector_values.items():
            if len(values) != dim:
                raise ValueError(
                    f"Vector dimension mismatch: expected {dim}, "
                    f"got {len(values)}"
                )

        graph = obj.get("graph")
        if (
            graph
            and graph.get("format") == "vectorlite-tpu-csr-v1"
            and graph.get("num_nodes") == len(vector_values)
        ):
            index = cls(
                dim,
                metric,
                m=int(graph["m"]),
                m0=int(graph["m0"]),
                **kwargs,
            )
            try:
                index._restore_graph(graph, obj)
                return index
            except Exception:  # noqa: BLE001
                # corrupt/incompatible dump: fall through to a rebuild
                index = None

        index = cls(dim, metric, **kwargs)
        vectors = []
        for vid_str in sorted(vector_values, key=int):
            meta = metadata.get(vid_str) or {}
            vectors.append(
                Vector(
                    id=int(vid_str),
                    values=np.asarray(
                        vector_values[vid_str], dtype=np.float64
                    ),
                    text=meta.get("text", ""),
                    metadata=meta.get("metadata"),
                )
            )
        index.add_batch(vectors)
        return index

    def _restore_graph(self, graph: dict, obj: dict) -> None:
        """Load the CSR dump instead of re-inserting every vector."""
        n = int(graph["num_nodes"])
        id_to_index = {
            int(vid): int(node)
            for vid, node in obj["id_to_index"].items()
        }
        if len(id_to_index) != n:
            raise ValueError("id_to_index does not cover the graph")
        metadata = obj.get("metadata", {})
        vector_values = obj["vector_values"]

        self._ensure_capacity(n)
        # Vectorized ingest: one [n, D] gather + fancy-indexed scatter
        # instead of per-node numpy calls (~6 us/node — material at 1M).
        # A ragged/mis-dimensioned row raises ValueError here, which the
        # caller's except-fallback turns into a rebuild.
        nodes = np.fromiter(id_to_index.values(), dtype=np.int64, count=n)
        mat = np.empty((n, self.dim), dtype=np.float64)
        for i, vid in enumerate(id_to_index):
            mat[i] = vector_values[str(vid)]
        mat32 = mat.astype(np.float32)
        self._vecs[nodes] = mat32
        if self._vecs64 is not None:
            self._vecs64[nodes] = mat
        sq = np.einsum("ij,ij->i", mat32, mat32)
        self._sqnorms[nodes] = sq
        self._norms[nodes] = np.sqrt(sq)
        for vid, node in id_to_index.items():
            self._id_to_index[vid] = node
            self._index_to_id[node] = vid
            meta = metadata.get(str(vid)) or {}
            self._texts[vid] = meta.get("text", "")
            self._metas[vid] = meta.get("metadata")

        adj0 = np.asarray(graph["adj0"], dtype=np.int32).reshape(n, self.m0)
        levels = np.asarray(graph["levels"], dtype=np.int32)
        upper = [
            np.asarray(a, dtype=np.int32).reshape(n, self.m)
            for a in graph.get("upper", [])
        ]
        # Reject corrupt dumps (out-of-range neighbor indices or negative
        # levels) so the caller's except-fallback rebuilds from vectors
        # instead of silently scanning zero-filled adjacency rows.
        if adj0.size and (adj0.min() < -1 or adj0.max() >= n):
            raise ValueError("adj0 neighbor index out of range")
        if levels.size != n or (levels.size and levels.min() < 0):
            raise ValueError("invalid levels array")
        for a in upper:
            if a.size and (a.min() < -1 or a.max() >= n):
                raise ValueError("upper neighbor index out of range")
        self._adj[0][:n] = adj0
        self._levels[:n] = levels
        self._num_nodes = n
        self._entry = int(graph["entry"])
        self._top_level = int(graph["top_level"])
        if not (0 <= self._entry < n):
            raise ValueError("invalid entry point")
        # top_level must match the shipped upper arrays and the native
        # builder's fixed 32-slot bound — a dump claiming more levels
        # would index past them on the first descend
        if not (0 <= self._top_level <= len(upper)) or len(upper) > 32:
            raise ValueError("top_level/upper level count out of range")
        if levels.size and int(levels.max()) > self._top_level:
            raise ValueError("node level exceeds top_level")
        self._adj_dirty.update(range(n))

        if self._nb is not None:
            import ctypes as c

            flat_upper = (
                np.concatenate([a.ravel() for a in upper])
                if upper
                else np.zeros(0, np.int32)
            )
            flat_upper = np.ascontiguousarray(flat_upper, dtype=np.int32)
            self._nb_lib.hnsw_restore(
                self._nb,
                n,
                self._entry,
                self._top_level,
                len(upper),
                flat_upper.ctypes.data_as(c.POINTER(c.c_int32)),
            )
        else:
            for a in upper:
                self._adj.append(
                    np.concatenate(
                        [
                            a,
                            np.full(
                                (self._capacity - n, self.m), -1, np.int32
                            ),
                        ]
                    )
                )

    # --------------------------------------------------- device-search hooks

    def graph_arrays(self):
        """Flat CSR-style arrays for the device beam-search kernel:
        (vectors f32 [n,D], level0 adjacency int32 [n,M0], entry, levels,
        upper adjacency list). Consumed by kernels/beam.py."""
        import ctypes as c

        n = self._num_nodes
        if self._nb is not None:
            n_upper = self._nb_lib.hnsw_num_upper_levels(self._nb)
            upper = []
            for lvl in range(1, n_upper + 1):
                buf = np.empty((n, self.m), np.int32)
                self._nb_lib.hnsw_get_upper(
                    self._nb,
                    lvl,
                    buf.ctypes.data_as(c.POINTER(c.c_int32)),
                    n,
                )
                upper.append(buf)
        else:
            upper = [a[:n] for a in self._adj[1:]]
        return (
            self._vecs[:n],
            self._adj[0][:n],
            self._entry,
            self._levels[:n],
            upper,
        )
