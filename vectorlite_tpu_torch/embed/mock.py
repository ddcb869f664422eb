"""Deterministic mock embedders for tests and CI (no model files needed).

Mirrors the reference's mock-embeddings feature: a hash-seeded,
L2-normalized, deterministic-per-text embedding
(reference: src/embeddings.rs:296-342) and the constant-vector mocks the
HTTP tests use (reference: tests/http_integration_test.rs:10-29).
The hash is blake2b (stable across processes) rather than Rust's
DefaultHasher; only determinism matters, not cross-language hash parity.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

from .base import BatchByLoopMixin


class MockEmbeddingFunction(BatchByLoopMixin):
    """Hash-based deterministic varied embedding, L2-normalized."""

    def __init__(self, dimension: int = 384):
        self._dimension = int(dimension)

    def generate_embedding(self, text: str) -> list[float]:
        seed = int.from_bytes(
            hashlib.blake2b(text.encode("utf-8"), digest_size=8).digest(),
            "little",
        )
        rng = np.random.default_rng(seed)
        emb = rng.uniform(-1.0, 1.0, self._dimension)
        norm = float(np.sqrt(np.dot(emb, emb)))
        if norm > 0.0:
            emb = emb / norm
        return [float(x) for x in emb]

    @property
    def dimension(self) -> int:
        return self._dimension


class ConstantEmbeddingFunction(BatchByLoopMixin):
    """Returns a fixed vector regardless of text — the HTTP-test mock
    (reference: tests/http_integration_test.rs:20-28)."""

    def __init__(self, values: Sequence[float], dimension: int | None = None):
        self._values = [float(v) for v in values]
        self._dimension = int(dimension) if dimension else len(self._values)

    def generate_embedding(self, text: str) -> list[float]:
        return list(self._values)

    @property
    def dimension(self) -> int:
        return self._dimension
