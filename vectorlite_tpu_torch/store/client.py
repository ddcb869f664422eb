"""VectorLiteClient — the collection registry and top-level SDK entry point.

Mirrors the reference ``VectorLiteClient`` (reference: src/client.rs:65-192):
a map of named collections plus a shared embedding function. Collection
dimension always comes from the embedder (reference: src/client.rs:88);
HNSW creation requires an explicit metric (reference: src/client.rs:96).

``VECTORLITE_MESH=n`` (n > 1) shards every collection over a mesh of n
devices (dist/sharding.py): the first n CUDA cards, or n CPU shards when
the client runs on the CPU. A
collection observer (``set_collection_observer``, e.g. ``store.wal.WalManager``) hears
of every registration and deletion.
"""

from __future__ import annotations

import enum
from typing import Any, Optional

import torch

from ..config import VectorLiteConfig, resolve_device
from ..core.metrics import SimilarityMetric
from ..core.types import SearchResult, Vector
from ..embed.base import EmbeddingFunction
from ..errors import (
    CollectionAlreadyExists,
    CollectionNotFound,
    InvalidIndexType,
    MetricRequired,
)
from ..index.flat import FlatIndex
from ..index.hnsw import HNSWIndex
from .collection import Collection, CollectionInfo


class IndexType(enum.Enum):
    """Reference: src/client.rs:217-232."""

    FLAT = "Flat"
    HNSW = "HNSW"

    @classmethod
    def parse(cls, s: str) -> "IndexType":
        """Case-insensitive parse (reference: src/server.rs:149-155)."""
        t = s.lower()
        if t == "flat":
            return cls.FLAT
        if t == "hnsw":
            return cls.HNSW
        raise InvalidIndexType(s)


class Settings:
    """Reserved for future configuration (reference: src/client.rs:73)."""


class VectorLiteClient:
    def __init__(
        self,
        embedding_function: EmbeddingFunction,
        *,
        config: Optional[VectorLiteConfig] = None,
        device=None,
    ):
        self._collections: dict[str, Collection] = {}
        self._embedding_function = embedding_function
        self._config = config or VectorLiteConfig.from_env()
        self._device = resolve_device(
            device if device is not None else self._config.device
        )
        self._mesh = None  # built lazily from config.mesh_devices
        self._observer = None  # see set_collection_observer

    def set_collection_observer(self, observer) -> None:
        """Register a lifecycle observer (e.g. ``wal.WalManager``):
        ``collection_registered(collection)`` fires after every
        registration (create, load, restore, add_collection) and
        ``collection_deleted(name)`` after removal. One observer slot;
        collections already registered are announced at once. None
        detaches."""
        self._observer = observer
        if observer is not None:
            for collection in self._collections.values():
                observer.collection_registered(collection)

    @property
    def device(self) -> torch.device:
        return self._device

    def mesh(self):
        """The mesh of ``config.mesh_devices`` (VECTORLITE_MESH) devices, or
        None for one device: on a CUDA device the first n cards (more than
        are visible raises), on the CPU n CPU shards."""
        n = getattr(self._config, "mesh_devices", 0) or 0
        if n <= 1:
            return None
        if self._mesh is None:
            from ..dist.sharding import make_mesh

            if self._device.type == "cuda":
                visible = torch.cuda.device_count()
                if n > visible:
                    raise ValueError(
                        f"VECTORLITE_MESH={n} but only {visible} CUDA "
                        f"device(s) are visible"
                    )
                devices = [torch.device("cuda", i) for i in range(n)]
            else:
                devices = [self._device] * n
            self._mesh = make_mesh(devices)
        return self._mesh

    def flat_index_kwargs(self) -> dict:
        """Construction kwargs for Flat indexes (the dtype profile, the
        device and, with VECTORLITE_MESH, the mesh), shared by
        create_collection and the .vlc and WAL load paths."""
        kwargs = {"device_dtype": self._config.device_dtype, "device": self._device}
        mesh = self.mesh()
        if mesh is not None:
            kwargs["mesh"] = mesh
        return kwargs

    def hnsw_index_kwargs(self) -> dict:
        """Construction kwargs for HNSW indexes: the profile's graph
        degrees and beam widths, and the device."""
        cfg = self._config
        return {
            "m": cfg.hnsw_m,
            "m0": cfg.hnsw_m0,
            "ef_construction": cfg.hnsw_ef_construction,
            "ef_search": cfg.hnsw_ef_search,
            "device": self._device,
            "mesh": self.mesh(),
        }

    @property
    def embedding_function(self) -> EmbeddingFunction:
        return self._embedding_function

    def create_collection(
        self,
        name: str,
        index_type: IndexType,
        metric: Optional[SimilarityMetric] = None,
    ) -> None:
        if isinstance(index_type, str):
            index_type = IndexType.parse(index_type)
        if name in self._collections:
            raise CollectionAlreadyExists(name)
        dimension = self._embedding_function.dimension
        if index_type is IndexType.FLAT:
            index = FlatIndex(dimension, **self.flat_index_kwargs())
        else:
            if metric is None:
                # no default: force explicit choice (reference: src/client.rs:96)
                raise MetricRequired()
            index = HNSWIndex(dimension, metric, **self.hnsw_index_kwargs())
        self._collections[name] = collection = Collection(name, index)
        if self._observer is not None:
            self._observer.collection_registered(collection)

    def get_collection(self, name: str) -> Optional[Collection]:
        return self._collections.get(name)

    def list_collections(self) -> list[str]:
        return list(self._collections.keys())

    def delete_collection(self, name: str) -> None:
        collection = self._collections.pop(name, None)
        if collection is None:
            raise CollectionNotFound(name)
        collection.close()
        if self._observer is not None:
            self._observer.collection_deleted(name)

    def has_collection(self, name: str) -> bool:
        return name in self._collections

    def add_text_to_collection(
        self,
        collection_name: str,
        text: str,
        metadata: Optional[Any] = None,
    ) -> int:
        return self._require(collection_name).add_text_with_metadata(
            text, self._embedding_function, metadata
        )

    def add_texts_to_collection(
        self, collection_name: str, texts, metadatas=None
    ) -> list[int]:
        """Batched insert (extension)."""
        return self._require(collection_name).add_texts(
            texts, self._embedding_function, metadatas
        )

    def add_vectors_to_collection(
        self,
        collection_name: str,
        values,
        texts=None,
        metadatas=None,
        ids=None,
    ) -> list[int]:
        """Bulk insert of precomputed embeddings (extension)."""
        return self._require(collection_name).add_vectors(
            values, texts, metadatas, ids
        )

    def search_vector_in_collection(
        self,
        collection_name: str,
        query,
        k: int,
        similarity_metric: Optional[SimilarityMetric] = None,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
    ) -> list[SearchResult]:
        """Search by one raw query vector (extension)."""
        return self.search_vectors_in_collection(
            collection_name, [query], k, similarity_metric, where=where,
            ef=ef, min_score=min_score,
        )[0]

    def search_vectors_in_collection(
        self,
        collection_name: str,
        queries,
        k: int,
        similarity_metric: Optional[SimilarityMetric] = None,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
    ) -> list[list[SearchResult]]:
        """Batched search by raw query vectors (extension). Metric
        auto-detect: HNSW -> its metric, Flat -> cosine (reference:
        src/client.rs:143-155)."""
        collection = self._require(collection_name)
        metric = similarity_metric or collection.detected_metric()
        return collection.search_vectors(
            queries, k, metric, where=where, ef=ef, min_score=min_score
        )

    def search_text_in_collection(
        self,
        collection_name: str,
        query_text: str,
        k: int,
        similarity_metric: Optional[SimilarityMetric] = None,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
    ) -> list[SearchResult]:
        collection = self._require(collection_name)
        metric = similarity_metric or collection.detected_metric()
        return collection.search_text(
            query_text, k, metric, self._embedding_function, where=where,
            ef=ef, min_score=min_score,
        )

    def search_texts_in_collection(
        self,
        collection_name: str,
        query_texts,
        k: int,
        similarity_metric: Optional[SimilarityMetric] = None,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
    ) -> list[list[SearchResult]]:
        """Batched text search (extension)."""
        collection = self._require(collection_name)
        metric = similarity_metric or collection.detected_metric()
        return collection.search_texts(
            query_texts, k, metric, self._embedding_function, where=where,
            ef=ef, min_score=min_score,
        )

    def search_hybrid_in_collection(
        self,
        collection_name: str,
        query_text: str,
        k: int,
        similarity_metric: Optional[SimilarityMetric] = None,
        where: Optional[dict] = None,
        ef: Optional[int] = None,
        min_score: Optional[float] = None,
        alpha: float = 0.5,
        pool: Optional[int] = None,
    ) -> list[SearchResult]:
        """Hybrid dense + BM25 search with reciprocal-rank fusion
        (extension; see Collection.search_hybrid). ``alpha`` weights the
        dense leg in [0, 1]."""
        collection = self._require(collection_name)
        metric = similarity_metric or collection.detected_metric()
        return collection.search_hybrid(
            query_text, k, metric, self._embedding_function, where=where,
            ef=ef, min_score=min_score, alpha=alpha, pool=pool,
        )

    def delete_from_collection(self, collection_name: str, id: int) -> None:
        self._require(collection_name).delete(id)

    def delete_where_in_collection(
        self, collection_name: str, where: dict
    ) -> int:
        """Bulk delete by metadata filter (extension). Returns the number
        of vectors removed."""
        return self._require(collection_name).delete_where(where)

    def update_text_in_collection(
        self, collection_name: str, id: int, text: str, metadata=None
    ) -> None:
        """Re-embed and replace a vector under the same id (extension; PUT
        semantics: metadata is replaced too, omit it to clear)."""
        self._require(collection_name).update_text(
            id, text, self._embedding_function, metadata
        )

    def update_metadata_in_collection(
        self, collection_name: str, id: int, metadata
    ) -> None:
        """Replace one vector's metadata (extension)."""
        self._require(collection_name).update_metadata(id, metadata)

    def get_vectors_from_collection(
        self,
        collection_name: str,
        ids,
        where: Optional[dict] = None,
        include_values: bool = True,
    ):
        """Bulk get by explicit ids (extension): the vectors found, in the
        requested order; missing ids are skipped."""
        return self._require(collection_name).get_vectors(
            ids, where, include_values
        )

    def list_vectors_in_collection(
        self,
        collection_name: str,
        offset: int = 0,
        limit: int = 100,
        where: Optional[dict] = None,
        include_values: bool = False,
    ):
        """Paged vector listing, optionally where-filtered (extension).
        Returns (vectors, total_matching)."""
        return self._require(collection_name).list_vectors(
            offset, limit, where, include_values
        )

    def compact_collection(self, collection_name: str) -> int:
        """Reclaim tombstoned slots (extension)."""
        return self._require(collection_name).compact()

    def get_vector_from_collection(
        self, collection_name: str, id: int
    ) -> Optional[Vector]:
        return self._require(collection_name).get_vector(id)

    def get_collection_info(self, collection_name: str) -> CollectionInfo:
        return self._require(collection_name).get_info()

    def add_collection(self, collection: Collection) -> None:
        """Register a collection directly (reference: src/client.rs:183-191)."""
        name = collection.name
        if name in self._collections:
            raise CollectionAlreadyExists(name)
        self._collections[name] = collection
        if self._observer is not None:
            self._observer.collection_registered(collection)

    def _require(self, name: str) -> Collection:
        collection = self._collections.get(name)
        if collection is None:
            raise CollectionNotFound(name)
        return collection
