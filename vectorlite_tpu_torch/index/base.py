"""Index protocol — the uniform interface over Flat and HNSW indexes.

Mirrors the reference ``VectorIndex`` trait (reference: src/lib.rs:224-245)
plus the wrapper-level ``metric()``/``index_type()`` accessors
(reference: src/lib.rs:329-346). Python duck typing replaces the Rust enum
dispatch; both index classes implement this protocol directly.
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence, runtime_checkable

from ..core.metrics import SimilarityMetric
from ..core.types import SearchResult, Vector


@runtime_checkable
class VectorIndex(Protocol):
    def add(self, vector: Vector) -> None: ...

    def delete(self, id: int) -> None: ...

    def search(
        self, query: Sequence[float], k: int, metric: SimilarityMetric
    ) -> list[SearchResult]: ...

    def __len__(self) -> int: ...

    def is_empty(self) -> bool: ...

    def get_vector(self, id: int) -> Optional[Vector]:
        """Protocol minimum is ``get_vector(id)``. The in-tree indexes
        additionally accept ``include_values: bool = True`` (skip
        materializing the D-float values row); Collection detects the
        kwarg by signature and falls back to the positional form, so
        third-party indexes only need this minimum."""
        ...

    @property
    def dimension(self) -> int: ...

    def metric(self) -> Optional[SimilarityMetric]:
        """The metric the index was built for; None = all metrics (Flat)."""
        ...

    @property
    def index_type(self) -> str:
        """"Flat" or "HNSW" (reference: src/persistence.rs:104-107)."""
        ...

    def max_id(self) -> Optional[int]: ...

    def index_to_json(self) -> dict:
        """Serialize to the reference .vlc ``index`` payload shape."""
        ...


def validate_batch_arrays(
    ids, values, dim: int, existing_ids, texts=None, metadatas=None
):
    """Shared validation for the array-native bulk-insert paths
    (FlatIndex/HNSWIndex.add_batch_arrays): all-or-nothing, C-speed set
    algebra on the happy path, per-id scan only to name the offender.

    Returns ``(int_ids, values_f64)``; raises DimensionMismatch for a
    wrong vector width, ValueError for an ids/rows/texts/metadatas count
    mismatch (the vectorized fills downstream would otherwise silently
    truncate or resize), and DuplicateVectorId for a repeat within the
    batch or against ``existing_ids`` (a set-like of ints, e.g.
    dict.keys())."""
    import numpy as np

    from ..errors import DimensionMismatch, DuplicateVectorId

    values = np.asarray(values, dtype=np.float64)
    n = len(ids)
    if n == 0 and values.size == 0:
        # documented no-op: an empty batch from a generic caller arrives
        # as shape (0,), which must not trip the width check below
        return [], values.reshape(0, dim)
    if values.ndim != 2 or values.shape[1] != dim:
        got = values.shape[1] if values.ndim == 2 else -1
        raise DimensionMismatch(dim, int(got))
    if values.shape[0] != n:
        raise ValueError(
            f"ids/values row mismatch: {n} ids, {values.shape[0]} rows"
        )
    if texts is not None and len(texts) != n:
        raise ValueError(
            f"ids/texts length mismatch: {n} ids, {len(texts)} texts"
        )
    if metadatas is not None and len(metadatas) != n:
        raise ValueError(
            f"ids/metadatas length mismatch: {n} ids, "
            f"{len(metadatas)} metadatas"
        )
    int_ids = [int(i) for i in ids]
    batch_set = set(int_ids)
    if len(batch_set) != n or existing_ids & batch_set:
        seen: set[int] = set()
        for vid in int_ids:
            if vid in existing_ids or vid in seen:
                raise DuplicateVectorId(vid)
            seen.add(vid)
    return int_ids, values
