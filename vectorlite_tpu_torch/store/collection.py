"""Collection: a named index behind a readers-writer lock with atomic ids.

Mirrors the reference ``Collection`` (reference: src/client.rs:243-497):

* per-collection RW lock + atomic next_id counter,
* id allocated **before** embedding — a failed embed burns the id
  (reference: src/client.rs:350-353),
* embedding computed **outside** the lock; the write lock is held only for
  the index mutation (reference: src/client.rs:349-379),
* next_id recovered as max_id + 1 when constructed from a loaded index
  (reference: src/client.rs:295-308).

Port of ``vectorlite_tpu/store/collection.py`` for Flat and HNSW indexes: adds
(texts and raw vectors), searches (text, raw vectors, coalesced single
texts, BM25 hybrid), deletes (by id and by filter), updates, listing,
gets, compaction and ``.vlc`` save/load. Every mutation bumps the
mutation counter the autosave daemon reads and, with a write-ahead log
attached (store/wal.py), appends its op under the write lock.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

from ..core.metrics import SimilarityMetric
from ..core.types import SearchResult, Vector
from ..embed.base import EmbeddingFunction
from ..errors import EmbeddingError, VectorLiteError, VectorNotFound
from ..observability import profile_span
from ..utils import AtomicCounter, RWLock, env_number

# BM25 sidecar GC: past this tombstone fraction (and floor size) the
# sidecar is dropped and lazily rebuilt from live texts, bounding
# per-query work at ~2x live docnums under update/delete churn.
_BM25_DROP_WASTE = 0.5
_BM25_DROP_MIN_DOCNUMS = 4096


@dataclass
class CollectionInfo:
    """Reference: src/client.rs:272-282."""

    name: str
    count: int
    is_empty: bool
    dimension: int

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "count": self.count,
            "is_empty": self.is_empty,
            "dimension": self.dimension,
        }


class Collection:
    def __init__(self, name: str, index):
        self._name = name
        self._index = index
        self._lock = RWLock()
        max_id = index.max_id()
        self._next_id = AtomicCounter(0 if max_id is None else max_id + 1)
        self._coalescer = None
        self._coalescer_lock = threading.Lock()
        # monotone write version: bumped on every successful mutation so
        # the autosave daemon (store/autosave.py) skips clean collections
        # without taking the index lock
        self._mutations = AtomicCounter(0)
        # BM25 sidecar for hybrid search: built on the first search_hybrid
        # from the index's live texts, then kept in step by the mutation
        # hooks; delete_where drops it (the matched ids are unknown here)
        self._bm25 = None
        self._bm25_build_lock = threading.Lock()
        # write-ahead log (store/wal.py), attached by WalManager through
        # the client's collection observer; None = snapshots alone
        self._wal = None

    def mutation_count(self) -> int:
        return self._mutations.load()

    def _wal_render(self, op):
        """Serialize a WAL op BEFORE mutating (CollectionWAL.render); None
        without a WAL. ``op`` is a dict or a zero-argument callable that
        builds one, called only when a WAL is attached."""
        wal = self._wal
        if wal is None:
            return None
        return (wal, wal.render(op() if callable(op) else op))

    def _commit(self, pre, n: int = 1) -> None:
        """Finish a successful mutation under the write lock: bump the
        dirty counter first (autosave must see the change even if the
        log append below fails), then append the pre-rendered op (log
        order == apply order)."""
        self._mutations.fetch_add(n)
        if pre is not None:
            wal, rendered = pre
            wal.append(rendered=rendered)

    @staticmethod
    def _wal_add_op(ids, values, texts, metadatas) -> dict:
        from .wal import pack_values

        op: dict = {
            "op": "add",
            "ids": [int(i) for i in ids],
            "vals": pack_values(values),  # bit-exact base64 f64 rows
        }
        if texts is not None:
            op["texts"] = list(texts)
        if metadatas is not None:
            op["metas"] = list(metadatas)
        return op

    @property
    def name(self) -> str:
        return self._name

    def next_id(self) -> int:
        return self._next_id.load()

    def add_text(
        self,
        text: str,
        embedding_function: EmbeddingFunction,
        metadata: Optional[Any] = None,
    ) -> int:
        # id allocated before embedding; burned if the embed fails
        # (reference: src/client.rs:350-353)
        vid = self._next_id.fetch_add(1)
        embedding = _run_embed(embedding_function, text)
        vector = Vector(id=vid, values=embedding, text=text, metadata=metadata)
        pre = self._wal_render(
            lambda: self._wal_add_op([vid], [embedding], [text], [metadata])
        )
        with self._lock.write(), profile_span("vectorlite.index.add"):
            self._index.add(vector)
            self._bm25_note_add([vid], [text])
            self._commit(pre)
        return vid

    # Alias mirroring the reference's two-method surface
    # (reference: src/client.rs:317-379).
    add_text_with_metadata = add_text

    def add_texts(
        self,
        texts: Sequence[str],
        embedding_function: EmbeddingFunction,
        metadatas: Optional[Sequence[Any]] = None,
    ) -> list[int]:
        """Batched insert — one embedder call, one short write lock."""
        texts = list(texts)
        if metadatas is not None and len(metadatas) != len(texts):
            raise ValueError(
                f"metadatas length {len(metadatas)} != texts length "
                f"{len(texts)}"
            )
        ids = [self._next_id.fetch_add(1) for _ in texts]
        try:
            with profile_span("vectorlite.embed.batch"):
                embeddings = _embed_arrays(embedding_function, texts)
        except VectorLiteError:
            raise
        except Exception as e:  # noqa: BLE001
            raise EmbeddingError(str(e)) from e
        if len(embeddings) != len(texts):
            raise EmbeddingError(
                f"embedder returned {len(embeddings)} embeddings for "
                f"{len(texts)} texts"
            )
        pre = self._wal_render(
            lambda: self._wal_add_op(ids, embeddings, texts, metadatas)
        )
        with self._lock.write(), profile_span("vectorlite.index.add_batch"):
            self._index.add_batch_arrays(ids, embeddings, texts, metadatas)
            self._bm25_note_add(ids, texts)
            if ids:
                self._commit(pre)
        return ids

    def add_vectors(
        self,
        values,
        texts: Optional[Sequence[str]] = None,
        metadatas: Optional[Sequence[Any]] = None,
        ids: Optional[Sequence[int]] = None,
    ) -> list[int]:
        """Bulk insert of PRECOMPUTED embeddings (extension): no embedder
        in the loop. ``ids=None`` allocates from the atomic counter;
        explicit ids must be fresh u64s (DuplicateVectorId on reuse) and
        push the counter past their max. All-or-nothing."""
        values = _as_matrix(values, self._index.dimension, "values")
        n = int(values.shape[0])
        if ids is None:
            int_ids = [self._next_id.fetch_add(1) for _ in range(n)]
        else:
            int_ids = []
            for i in ids:
                # strict: a float id would silently truncate (5.5 -> 5)
                if isinstance(i, bool) or not isinstance(i, (int, np.integer)):
                    raise ValueError(
                        "vector ids must be integers, got "
                        f"{type(i).__name__}"
                    )
                vid = int(i)
                if vid < 0 or vid >= 1 << 64:
                    raise ValueError(
                        f"vector id {vid} is outside the u64 range"
                    )
                int_ids.append(vid)
            if len(int_ids) != n:
                raise ValueError(
                    f"ids/values row mismatch: {len(int_ids)} ids, {n} rows"
                )
            if int_ids:
                # burn the id range BEFORE inserting, as text adds do
                self._next_id.bump_to(max(int_ids) + 1)
        # length checks before the WAL pre-render, which indexes texts[i]
        # and metadatas[i] (the index re-checks inside the lock)
        if texts is not None and len(texts) != n:
            raise ValueError(
                f"ids/texts length mismatch: {n} ids, {len(texts)} texts"
            )
        if metadatas is not None and len(metadatas) != n:
            raise ValueError(
                f"ids/metadatas length mismatch: {n} ids, "
                f"{len(metadatas)} metadatas"
            )
        pre = self._wal_render(
            lambda: self._wal_add_op(int_ids, values, texts, metadatas)
        )
        with self._lock.write(), profile_span("vectorlite.index.add_batch"):
            self._index.add_batch_arrays(int_ids, values, texts, metadatas)
            self._bm25_note_add(int_ids, texts)
            if int_ids:
                self._commit(pre)
        return int_ids

    @staticmethod
    def _apply_min_score(rows: list, min_score) -> list:
        """Post-filter: drop hits below a similarity floor (extension);
        rows are sorted descending, so this is a prefix truncation."""
        if min_score is None:
            return rows
        return [r for r in rows if r.score >= min_score]

    def _search_kwargs(self, where, ef) -> dict:
        """Per-request search options. ``ef`` (beam width) only applies
        to HNSW: an exact Flat scan meets any recall it asks for, so it
        is accepted and ignored there."""
        kwargs: dict = {"where": where}
        if ef is not None and getattr(self._index, "ef_search", None) is not None:
            kwargs["ef"] = int(ef)
        return kwargs

    def search_vectors(
        self,
        queries,
        k: int,
        metric: SimilarityMetric,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
    ) -> list[list[SearchResult]]:
        """Search by RAW query vectors, batched (extension; the reference
        exposes ``VectorIndex::search`` only at the library level,
        reference: src/lib.rs:293-298)."""
        queries = _as_matrix(queries, self._index.dimension, "queries")
        with self._lock.read(), profile_span("vectorlite.index.search_batch"):
            rows = self._index.search_batch(
                queries, k, metric, **self._search_kwargs(where, ef)
            )
        return [self._apply_min_score(row, min_score) for row in rows]

    def search_text(
        self,
        query_text: str,
        k: int,
        metric: SimilarityMetric,
        embedding_function: EmbeddingFunction,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
    ) -> list[SearchResult]:
        # ef-carrying requests take the direct path: coalescing groups by
        # (k, metric, where), and a per-request beam width would fragment
        # the groups
        if ef is None and env_number("VECTORLITE_COALESCE", 1):
            # concurrent single-text searches merge into one embedder call
            # and one batched dispatch (store/coalesce.py), with the rows
            # the direct path below returns. A clause with no canonical
            # JSON (SDK only) would share the unfiltered group's None key,
            # so it takes the direct path.
            from ..core.filter import where_cache_key

            if where is None or where_cache_key(where) is not None:
                return self._apply_min_score(
                    self._get_coalescer().submit(
                        query_text, k, metric, embedding_function,
                        where=where,
                    ),
                    min_score,
                )
        # embed outside the lock (reference: src/client.rs:393-401)
        query = _run_embed(embedding_function, query_text)
        with self._lock.read(), profile_span("vectorlite.index.search"):
            results = self._index.search(
                query, k, metric, **self._search_kwargs(where, ef)
            )
        return self._apply_min_score(results, min_score)

    # ------------------------------------------------------ hybrid search

    def _bm25_note_add(self, ids, texts) -> None:
        """Mutation hook (under the write lock): keep the BM25 sidecar in
        step when it exists. ``texts=None`` (raw-vector inserts) registers
        empty documents so corpus statistics track the collection."""
        bm25 = self._bm25
        if bm25 is None:
            return
        for i, vid in enumerate(ids):
            bm25.add(int(vid), texts[i] if texts is not None else "")
        self._bm25_gc(bm25)

    def _bm25_gc(self, bm25) -> None:
        """Tombstone reclamation (under the write lock): postings keep no
        texts to compact from, so once tombstones dominate a non-trivial
        sidecar it is dropped; the next hybrid search rebuilds it."""
        if (
            bm25.total_docnums() >= _BM25_DROP_MIN_DOCNUMS
            and bm25.waste() > _BM25_DROP_WASTE
        ):
            self._bm25 = None

    def _bm25_synced(self):
        """The BM25 sidecar, built from the index's live texts on first
        use. Callers hold the read lock; the build mutex serializes
        concurrent first builders."""
        bm25 = self._bm25
        if bm25 is not None:
            return bm25
        from ..text.bm25 import BM25Index

        with self._bm25_build_lock:
            if self._bm25 is not None:
                return self._bm25
            bm25 = BM25Index()
            offset = 0
            while True:
                vectors, _total = self._index.list_vectors(
                    offset, 10_000, None, False
                )
                if not vectors:
                    break
                for v in vectors:
                    bm25.add(v.id, v.text)
                offset += len(vectors)
            self._bm25 = bm25
            return bm25

    def search_hybrid(
        self,
        query_text: str,
        k: int,
        metric: SimilarityMetric,
        embedding_function: EmbeddingFunction,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
        alpha: float = 0.5,
        pool: Optional[int] = None,
        rrf_k: int = 60,
    ) -> list[SearchResult]:
        """Hybrid dense + lexical search (extension): the embedding leg
        and a BM25 leg over the stored texts, fused by weighted
        reciprocal-rank fusion ``alpha/(rrf_k + dense_rank) +
        (1-alpha)/(rrf_k + bm25_rank)``.

        ``alpha`` weights the dense leg in [0, 1]. Each leg contributes
        its top ``pool`` candidates (default ``max(4k, 32)``, at most
        1000). ``where``/``ef`` apply to both legs; ``min_score`` filters
        the fused score. Results are sorted by fused score, ties by
        ascending id. The legs take separate read locks."""
        k = int(k)
        if k <= 0:
            return []
        alpha = float(alpha)
        if not (0.0 <= alpha <= 1.0):
            raise ValueError("alpha must be within [0, 1]")
        pool = int(pool) if pool is not None else min(max(4 * k, 32), 1000)
        pool = max(pool, k)
        dense = self.search_text(
            query_text, pool, metric, embedding_function, where=where, ef=ef,
        )
        pred = None
        if where is not None:
            from ..core.filter import compile_where

            pred = compile_where(where)
        with self._lock.read(), profile_span("vectorlite.index.bm25"):
            bm25 = self._bm25_synced()
            if pred is not None:
                def keep(did: int) -> bool:
                    v = self._index.get_vector(did, include_values=False)
                    return v is not None and pred(v.metadata)

                sparse = bm25.search(query_text, pool, keep)
            else:
                sparse = bm25.search(query_text, pool)
            fused: dict = {}
            for rank, r in enumerate(dense, 1):
                fused[r.id] = alpha / (rrf_k + rank)
            for rank, (did, _score) in enumerate(sparse, 1):
                fused[did] = fused.get(did, 0.0) + (1.0 - alpha) / (
                    rrf_k + rank
                )
            order = sorted(fused.items(), key=lambda t: (-t[1], t[0]))
            by_id = {r.id: r for r in dense}
            results: list[SearchResult] = []
            for did, score in order:
                if len(results) == k or score <= 0.0:
                    # a zero fused score: the candidate's only leg is
                    # weighted out (alpha 0 or 1)
                    break
                hit = by_id.get(did)
                if hit is None:
                    v = self._index.get_vector(did, include_values=False)
                    if v is None:  # deleted between the two legs
                        continue
                    text, meta = v.text, v.metadata
                else:
                    text, meta = hit.text, hit.metadata
                results.append(
                    SearchResult(
                        id=int(did), score=float(score), text=text,
                        metadata=meta,
                    )
                )
        return self._apply_min_score(results, min_score)

    def _get_coalescer(self):
        co = self._coalescer
        if co is None:
            from .coalesce import SearchCoalescer

            with self._coalescer_lock:
                co = self._coalescer
                if co is None:
                    co = self._coalescer = SearchCoalescer(self)
        return co

    def close(self) -> None:
        """Stop the search coalescer's thread. Safe to call more than
        once; a later search starts a fresh coalescer."""
        with self._coalescer_lock:
            co, self._coalescer = self._coalescer, None
        if co is not None:
            co.close()

    def search_texts(
        self,
        query_texts: Sequence[str],
        k: int,
        metric: SimilarityMetric,
        embedding_function: EmbeddingFunction,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
    ) -> list[list[SearchResult]]:
        """Batched text search: one embedder call, one device dispatch."""
        with profile_span("vectorlite.embed.batch"):
            queries = _embed_arrays(embedding_function, list(query_texts))
        with self._lock.read(), profile_span("vectorlite.index.search_batch"):
            rows = self._index.search_batch(
                queries, k, metric, **self._search_kwargs(where, ef)
            )
        return [self._apply_min_score(row, min_score) for row in rows]

    def delete(self, id: int) -> None:
        pre = self._wal_render({"op": "del", "id": int(id)})
        with self._lock.write():
            self._index.delete(id)
            if self._bm25 is not None:
                self._bm25.remove(int(id))
                self._bm25_gc(self._bm25)
            self._commit(pre)

    def delete_where(self, where) -> int:
        """Bulk delete by metadata filter; ``{}`` matches every row.
        Returns the number of vectors removed."""
        pre = self._wal_render({"op": "delw", "where": where})
        with self._lock.write():
            n = self._index.delete_where(where)
            if n:
                # the matched ids are unknown here: drop the BM25
                # sidecar, the next hybrid search rebuilds it
                self._bm25 = None
                self._commit(pre, n)
        return n

    def update_text(
        self,
        id: int,
        text: str,
        embedding_function: EmbeddingFunction,
        metadata: Optional[Any] = None,
    ) -> None:
        """Re-embed ``text`` and replace the record under the same id (PUT
        semantics: text, values and metadata are all replaced; omit
        metadata to clear it). Raises VectorNotFound when the id is not
        live. A tombstone and a re-insert: the record moves to the end of
        insertion order."""
        embedding = _run_embed(embedding_function, text)  # outside the lock
        vector = Vector(id=int(id), values=embedding, text=text, metadata=metadata)

        def put_op():
            from .wal import pack_values

            return {
                "op": "put",
                "id": int(id),
                "vals": pack_values([embedding]),
                "text": text,
                "metadata": metadata,
            }

        pre = self._wal_render(put_op)
        with self._lock.write(), profile_span("vectorlite.index.update"):
            if self._index.get_vector(int(id)) is None:
                raise VectorNotFound(int(id))
            self._index.delete(int(id))
            self._index.add(vector)
            self._bm25_note_add([int(id)], [text])  # re-index = replace
            self._commit(pre)

    def update_metadata(self, id: int, metadata) -> None:
        """Replace one vector's metadata (``None`` clears)."""
        pre = self._wal_render({"op": "meta", "id": int(id), "metadata": metadata})
        with self._lock.write():
            self._index.update_metadata(id, metadata)
            self._commit(pre)

    def list_vectors(
        self,
        offset: int = 0,
        limit: int = 100,
        where: Optional[dict] = None,
        include_values: bool = False,
    ):
        """Paged listing, optionally where-filtered: (vectors, total)."""
        with self._lock.read():
            return self._index.list_vectors(offset, limit, where, include_values)

    def get_vector(self, id: int) -> Optional[Vector]:
        with self._lock.read():
            return self._index.get_vector(id)

    def get_vectors(
        self,
        ids: Sequence[int],
        where: Optional[dict] = None,
        include_values: bool = True,
    ) -> list[Vector]:
        """Bulk get by explicit ids: the vectors found, in the requested
        order; missing ids are skipped. One read lock for the batch. An
        optional ``where`` post-filters by stored metadata."""
        pred = None
        if where is not None:
            from ..core.filter import compile_where

            pred = compile_where(where)
        out: list[Vector] = []
        with self._lock.read():
            for vid in ids:
                v = self._index.get_vector(int(vid), include_values=include_values)
                if v is None:
                    continue
                if pred is not None and not pred(v.metadata):
                    continue
                out.append(v)
        return out

    def get_info(self) -> CollectionInfo:
        with self._lock.read():
            return CollectionInfo(
                name=self._name,
                count=len(self._index),
                is_empty=self._index.is_empty(),
                dimension=self._index.dimension,
            )

    def index_read(self):
        """Context manager yielding the index under the read lock."""
        return _IndexReadGuard(self._lock, self._index)

    def detected_metric(self) -> SimilarityMetric:
        """Metric auto-detect: HNSW -> its metric, Flat -> Cosine default
        (reference: src/client.rs:143-155)."""
        with self._lock.read():
            m = self._index.metric()
        return m if m is not None else SimilarityMetric.COSINE

    def compact(self) -> int:
        """Reclaim tombstoned nodes (HNSW rebuild / Flat slot compaction)
        under the write lock. Returns the number of slots reclaimed."""
        pre = self._wal_render({"op": "compact"})
        with self._lock.write():
            reclaimed = int(self._index.compact())
            if reclaimed:
                self._commit(pre)
        return reclaimed

    def save_to_file(self, path) -> None:
        from ..persist.vlc import save_collection_to_file

        save_collection_to_file(self, path)

    @classmethod
    def load_from_file(cls, path, **index_kwargs) -> "Collection":
        """Load a ``.vlc`` file; ``index_kwargs`` (``device``,
        ``device_dtype``: a client's ``flat_index_kwargs()``) go to the
        index (an HNSW index takes the ``device``), so the collection
        serves where the client does."""
        from ..persist.vlc import load_collection_from_file

        return load_collection_from_file(path, **index_kwargs)


class _IndexReadGuard:
    def __init__(self, lock: RWLock, index):
        self._lock = lock
        self._index = index

    def __enter__(self):
        self._cm = self._lock.read()
        self._cm.__enter__()
        return self._index

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


def _as_matrix(values, dim: int, field: str) -> np.ndarray:
    """Coerce raw-vector input to a finite f64 [B, D] matrix; ValueError
    on ragged/non-numeric/non-finite input. An empty batch normalizes to
    shape (0, dim). Width mismatches against a non-empty index are left to
    the index's own DimensionMismatch check."""
    try:
        values = np.asarray(values, dtype=np.float64)
    except (TypeError, ValueError):
        raise ValueError(
            f"{field} must be a rectangular numeric [B, D] matrix"
        ) from None
    if values.ndim == 1 and values.size == 0:
        return values.reshape(0, dim)
    if values.ndim != 2:
        raise ValueError(f"{field} must be a [B, D] matrix")
    if values.shape[0] > 0 and values.shape[1] == 0:
        raise ValueError(f"{field} rows must be non-empty")
    if not np.all(np.isfinite(values)):
        raise ValueError(f"{field} must contain only finite numbers")
    return values


def _run_embed(embedding_function: EmbeddingFunction, text: str) -> list:
    try:
        with profile_span("vectorlite.embed"):
            return embedding_function.generate_embedding(text)
    except VectorLiteError:
        raise
    except Exception as e:  # noqa: BLE001
        raise EmbeddingError(str(e)) from e


def _embed_arrays(embedding_function: EmbeddingFunction, texts) -> np.ndarray:
    """Prefer the array-native batch ([B, D] ndarray); fall back to the
    list protocol for minimal embedders."""
    if hasattr(embedding_function, "embed_batch_arrays"):
        return np.asarray(embedding_function.embed_batch_arrays(texts))
    if not texts:
        return np.zeros((0, embedding_function.dimension), np.float64)
    return np.asarray(embedding_function.embed_batch(texts), dtype=np.float64)
