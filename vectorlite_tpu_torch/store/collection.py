"""Collection: a named index behind a readers-writer lock with atomic ids.

Mirrors the reference ``Collection`` (reference: src/client.rs:243-497):

* per-collection RW lock + atomic next_id counter,
* id allocated **before** embedding — a failed embed burns the id
  (reference: src/client.rs:350-353),
* embedding computed **outside** the lock; the write lock is held only for
  the index mutation (reference: src/client.rs:349-379),
* next_id recovered as max_id + 1 when constructed from a loaded index
  (reference: src/client.rs:295-308).

The Flat paths are ported: adds (texts and raw vectors), searches (text
and raw vectors), delete, compact and get. The search coalescer, the
write-ahead log, BM25 hybrid search, filtered deletes, listing, updates
and file persistence come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

from ..core.metrics import SimilarityMetric
from ..core.types import SearchResult, Vector
from ..embed.base import EmbeddingFunction
from ..errors import EmbeddingError, VectorLiteError
from ..observability import profile_span
from ..utils import AtomicCounter, RWLock


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
        with self._lock.write(), profile_span("vectorlite.index.add"):
            self._index.add(vector)
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
        with self._lock.write(), profile_span("vectorlite.index.add_batch"):
            self._index.add_batch_arrays(ids, embeddings, texts, metadatas)
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
        with self._lock.write(), profile_span("vectorlite.index.add_batch"):
            self._index.add_batch_arrays(int_ids, values, texts, metadatas)
        return int_ids

    @staticmethod
    def _apply_min_score(rows: list, min_score) -> list:
        """Post-filter: drop hits below a similarity floor (extension);
        rows are sorted descending, so this is a prefix truncation."""
        if min_score is None:
            return rows
        return [r for r in rows if r.score >= min_score]

    def search_vectors(
        self,
        queries,
        k: int,
        metric: SimilarityMetric,
        where: Optional[dict] = None,
        min_score: Optional[float] = None,
    ) -> list[list[SearchResult]]:
        """Search by RAW query vectors, batched (extension; the reference
        exposes ``VectorIndex::search`` only at the library level,
        reference: src/lib.rs:293-298)."""
        queries = _as_matrix(queries, self._index.dimension, "queries")
        with self._lock.read(), profile_span("vectorlite.index.search_batch"):
            rows = self._index.search_batch(queries, k, metric, where=where)
        return [self._apply_min_score(row, min_score) for row in rows]

    def search_text(
        self,
        query_text: str,
        k: int,
        metric: SimilarityMetric,
        embedding_function: EmbeddingFunction,
        where: Optional[dict] = None,
        min_score: Optional[float] = None,
    ) -> list[SearchResult]:
        # embed outside the lock (reference: src/client.rs:393-401)
        query = _run_embed(embedding_function, query_text)
        with self._lock.read(), profile_span("vectorlite.index.search"):
            results = self._index.search(query, k, metric, where=where)
        return self._apply_min_score(results, min_score)

    def search_texts(
        self,
        query_texts: Sequence[str],
        k: int,
        metric: SimilarityMetric,
        embedding_function: EmbeddingFunction,
        where: Optional[dict] = None,
        min_score: Optional[float] = None,
    ) -> list[list[SearchResult]]:
        """Batched text search: one embedder call, one device dispatch."""
        with profile_span("vectorlite.embed.batch"):
            queries = _embed_arrays(embedding_function, list(query_texts))
        with self._lock.read(), profile_span("vectorlite.index.search_batch"):
            rows = self._index.search_batch(queries, k, metric, where=where)
        return [self._apply_min_score(row, min_score) for row in rows]

    def delete(self, id: int) -> None:
        with self._lock.write():
            self._index.delete(id)

    def get_vector(self, id: int) -> Optional[Vector]:
        with self._lock.read():
            return self._index.get_vector(id)

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
        """Metric auto-detect: Flat -> Cosine default
        (reference: src/client.rs:143-155)."""
        with self._lock.read():
            m = self._index.metric()
        return m if m is not None else SimilarityMetric.COSINE

    def compact(self) -> int:
        """Reclaim tombstoned slots under the write lock. Returns the
        number of slots reclaimed."""
        with self._lock.write():
            return int(self._index.compact())


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
