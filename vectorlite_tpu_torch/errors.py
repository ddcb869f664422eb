"""Typed error hierarchy with HTTP status-code mapping.

Mirrors the reference error system (reference: src/errors.rs:10-105): 13 typed
variants whose display strings and HTTP mappings are reproduced exactly so the
HTTP surface is drop-in compatible (reference: src/errors.rs:71-91 for the
status-code table, src/server.rs:168-179 for the ``{"message": ...}`` body).
"""

from __future__ import annotations


class VectorLiteError(Exception):
    """Base error. Subclasses define ``status_code`` and a formatted message."""

    status_code: int = 500

    @property
    def message(self) -> str:
        return str(self)

    def is_client_error(self) -> bool:
        # reference: src/errors.rs:94-96
        return self.status_code in (400, 404, 409)

    def is_server_error(self) -> bool:
        # reference: src/errors.rs:99-101
        return self.status_code == 500


class CollectionNotFound(VectorLiteError):
    status_code = 404

    def __init__(self, name: str):
        self.name = name
        super().__init__(f"Collection '{name}' not found")


class DimensionMismatch(VectorLiteError):
    status_code = 400

    def __init__(self, expected: int, actual: int):
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"Vector dimension mismatch: expected {expected}, got {actual}"
        )


class DuplicateVectorId(VectorLiteError):
    status_code = 409

    def __init__(self, id: int):
        self.id = id
        super().__init__(f"Vector ID {id} already exists")


class VectorNotFound(VectorLiteError):
    status_code = 404

    def __init__(self, id: int):
        self.id = id
        super().__init__(f"Vector ID {id} does not exist")


class CollectionAlreadyExists(VectorLiteError):
    status_code = 409

    def __init__(self, name: str):
        self.name = name
        super().__init__(f"Collection '{name}' already exists")


class InvalidIndexType(VectorLiteError):
    status_code = 400

    def __init__(self, index_type: str):
        self.index_type = index_type
        super().__init__(
            f"Invalid index type: {index_type}. Must be 'flat' or 'hnsw'"
        )


class InvalidSimilarityMetric(VectorLiteError):
    status_code = 400

    def __init__(self, metric: str):
        self.metric = metric
        super().__init__(
            f"Invalid similarity metric: {metric}. "
            "Must be 'cosine', 'euclidean', 'manhattan', or 'dotproduct'"
        )


class MetricMismatch(VectorLiteError):
    status_code = 400

    def __init__(self, requested, index):
        self.requested = requested
        self.index = index
        # The reference renders the enum variants with Debug formatting,
        # e.g. "Cosine" (reference: src/errors.rs:41-42).
        super().__init__(
            f"Metric mismatch: search requested {requested.variant_name()} "
            f"but index was built for {index.variant_name()}"
        )


class MetricRequired(VectorLiteError):
    status_code = 400

    def __init__(self):
        # Trailing space reproduced from reference: src/errors.rs:45.
        super().__init__(
            "HNSW index requires an explicit similarity metric. "
            "Add field 'metric' with one of the following: "
            "['cosine', 'euclidean', 'manhattan', 'dotproduct'] "
        )


class InvalidFilter(VectorLiteError):
    """Malformed metadata ``where`` clause (TPU-native extension — the
    reference has no filtered search; this maps to 400 like its other
    invalid-request errors, reference: src/errors.rs:71-91)."""

    status_code = 400

    def __init__(self, detail: str):
        self.detail = detail
        super().__init__(f"Invalid filter: {detail}")


class EmbeddingError(VectorLiteError):
    status_code = 500

    def __init__(self, detail: str):
        self.detail = detail
        super().__init__(f"Embedding generation failed: {detail}")


class FileNotFound(VectorLiteError):
    status_code = 404

    def __init__(self, path: str):
        self.path = path
        super().__init__(f"File not found: {path}")


class PersistenceError(VectorLiteError):
    """Wraps persistence-layer failures (reference: src/persistence.rs:36-54).

    The reference maps ``PersistenceError::FileNotFound`` to 404 and everything
    else to 500 (reference: src/errors.rs:84-87); we use the dedicated
    :class:`FileNotFound` type for the 404 case, so this class is always 500.
    """

    status_code = 500

    def __init__(self, detail: str):
        self.detail = detail
        super().__init__(f"Persistence error: {detail}")


class VersionMismatch(PersistenceError):
    def __init__(self, expected: str, actual: str):
        self.expected = expected
        self.actual = actual
        VectorLiteError.__init__(
            self,
            f"Persistence error: Version mismatch: "
            f"expected {expected}, got {actual}",
        )


class InvalidFormat(PersistenceError):
    def __init__(self, detail: str):
        VectorLiteError.__init__(
            self, f"Persistence error: Invalid file format: {detail}"
        )


class SerializationError(PersistenceError):
    def __init__(self, detail: str):
        VectorLiteError.__init__(
            self, f"Persistence error: Serialization error: {detail}"
        )


class LockError(VectorLiteError):
    status_code = 500

    def __init__(self, detail: str):
        super().__init__(f"Failed to acquire lock: {detail}")


class InternalError(VectorLiteError):
    status_code = 500

    def __init__(self, detail: str):
        super().__init__(f"Internal server error: {detail}")

