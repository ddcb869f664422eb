"""Core record types.

Mirrors the reference's ``Vector`` (reference: src/lib.rs:163-174) and
``SearchResult`` (reference: src/lib.rs:193-203). These are host-side record
types; on device, vectors live as a struct-of-arrays ``[N, D]`` matrix inside
the indexes — the per-record representation only exists at the API boundary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

#: Default vector dimension for embedding models (reference: src/lib.rs:142).
DEFAULT_VECTOR_DIMENSION = 768


@dataclass
class Vector:
    """A vector with an ID, values, original text, and optional metadata."""

    id: int
    values: list[float]
    text: str
    metadata: Optional[Any] = None

    def to_json(self) -> dict:
        # Field order matches the reference serde output for byte-compatible
        # .vlc snapshots (reference: src/lib.rs:163-174).
        return {
            "id": self.id,
            "values": [float(v) for v in self.values],
            "text": self.text,
            "metadata": self.metadata,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Vector":
        return cls(
            id=int(obj["id"]),
            values=[float(v) for v in obj["values"]],
            text=obj["text"],
            metadata=obj.get("metadata"),
        )


@dataclass
class SearchResult:
    """A search hit: id, similarity score (higher is better), text, metadata."""

    id: int
    score: float
    text: str
    metadata: Optional[Any] = None

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "score": float(self.score),
            "text": self.text,
            "metadata": self.metadata,
        }


def validate_values(values: Sequence[float]) -> list[float]:
    return [float(v) for v in values]
