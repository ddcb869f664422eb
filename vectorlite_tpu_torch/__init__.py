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
mutations, listing, BM25 hybrid search), persistence (``.vlc`` files,
the write-ahead log, autosave) and the HTTP serving surface on the
standard library (``api.server``, ``cli``, ``remote.RemoteClient``,
``tools``); the HNSW index (native host build and search, the device
beam, the bulk build on K1's wide mode) and the MiniLM embedder on the
card; the device mesh (``dist/``: the kernels per shard, ``torch.distributed``
across processes) and the pipelined ``FlatIndex.search_batch_stream``. Entry
points run on the CUDA card unless given ``device="cpu"`` (``--device cpu``).
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
from .index.hnsw import HNSWIndex
from .embed.base import EmbeddingFunction
from .embed.mock import ConstantEmbeddingFunction, MockEmbeddingFunction
from .store.client import IndexType, Settings, VectorLiteClient
from .store.collection import Collection, CollectionInfo
from .config import VectorLiteConfig

__version__ = "0.1.0"


def __getattr__(name):
    # the HTTP client and the embedder load on first use, as in the JAX
    # package
    if name in ("MiniLMEmbedder", "EmbeddingGenerator"):
        from .embed.minilm import MiniLMEmbedder

        return MiniLMEmbedder
    if name in ("RemoteClient", "RemoteError", "RemoteConnectionError"):
        from . import remote

        return getattr(remote, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    "HNSWIndex",
    "EmbeddingFunction",
    "MockEmbeddingFunction",
    "ConstantEmbeddingFunction",
    "VectorLiteClient",
    "Collection",
    "CollectionInfo",
    "IndexType",
    "Settings",
    "VectorLiteConfig",
    "MiniLMEmbedder",
    "EmbeddingGenerator",
    "RemoteClient",
    "RemoteError",
    "RemoteConnectionError",
]
