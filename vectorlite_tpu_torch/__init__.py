"""vectorlite-tpu on PyTorch and CUDA — the port's package.

The same in-memory vector database as ``vectorlite_tpu`` (the JAX
package, which stays the reference), written in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (``csrc/``). This package imports nothing
of JAX or of ``vectorlite_tpu``; the modules that carry no JAX are kept
as copies of their own.

Ported so far, each from the SDK client down to its kernels: the Flat
search path (the scan kernels K1-K4), the ``pq`` profile (the ADC rank
kernel K5, with the native f64 re-score) and the IVF rung (the partition
probe K6); beside them, outside the SDK, the tournament-merge engine (K7)
and the scan-decomposition probe (K8), on a tensor-core body over bf16
rows. Around them: the collection surface (search coalescing, bulk
mutations, listing, BM25 hybrid search) and persistence (``.vlc`` files,
the write-ahead log, autosave). See ROADMAP.md for what is still to come.
Entry points run on the CUDA card unless given ``device="cpu"``.
"""

from .core.types import DEFAULT_VECTOR_DIMENSION, SearchResult, Vector
from .core.metrics import (
    SimilarityMetric,
    cosine_similarity,
    dot_product,
    euclidean_similarity,
    manhattan_similarity,
)
from .errors import InvalidFilter, VectorLiteError
from .index.flat import FlatIndex
from .embed.base import EmbeddingFunction
from .embed.mock import ConstantEmbeddingFunction, MockEmbeddingFunction
from .store.client import IndexType, Settings, VectorLiteClient
from .store.collection import Collection, CollectionInfo
from .config import VectorLiteConfig

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_VECTOR_DIMENSION",
    "Vector",
    "SearchResult",
    "SimilarityMetric",
    "cosine_similarity",
    "euclidean_similarity",
    "manhattan_similarity",
    "dot_product",
    "VectorLiteError",
    "InvalidFilter",
    "FlatIndex",
    "EmbeddingFunction",
    "MockEmbeddingFunction",
    "ConstantEmbeddingFunction",
    "VectorLiteClient",
    "Collection",
    "CollectionInfo",
    "IndexType",
    "Settings",
    "VectorLiteConfig",
]
