"""Embedding function protocol — the pluggable seam every test mocks.

Mirrors the reference ``EmbeddingFunction`` trait
(reference: src/embeddings.rs:135-141), extended with a true batched
``embed_batch`` (the reference's batch path is a rayon par_iter over
single-text calls, reference: src/embeddings.rs:269-276; on TPU we batch
the forward pass instead).
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class EmbeddingFunction(Protocol):
    def generate_embedding(self, text: str) -> list[float]:
        """Embed a single text; raises errors.EmbeddingError on failure."""
        ...

    @property
    def dimension(self) -> int: ...

    def embed_batch(self, texts: Sequence[str]) -> list[list[float]]:
        """Default batched path; real embedders override with one forward."""
        ...

    def embed_batch_arrays(self, texts: Sequence[str]) -> np.ndarray:
        """Array-native batch: ``[B, D]`` ndarray with no per-value Python
        object materialization. This is the serving ingestion/search path —
        the reference has no analogue (its batch is a rayon par_iter of
        single-text calls, reference: src/embeddings.rs:269-276)."""
        ...


class BatchByLoopMixin:
    """Fallbacks for embedders without a native batch path."""

    def embed_batch(self, texts: Sequence[str]) -> list[list[float]]:
        return [self.generate_embedding(t) for t in texts]

    def embed_batch_arrays(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dimension), np.float64)
        return np.asarray(self.embed_batch(texts), dtype=np.float64)
