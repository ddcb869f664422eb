"""The system under test, built and called through the SDK as a user's
process does: ``VectorLiteClient`` -> a collection -> ``add_vectors`` for
the corpus, and the traffic's call for each batch.

The program is imported here only: the reference, the comparison and
the generator never import it.
"""

from __future__ import annotations

import time

import numpy as np

COLLECTION = "bench"
#: a deployment's metric -> the SDK's SimilarityMetric member
METRICS = {"cosine": "COSINE", "euclidean": "EUCLIDEAN", "dot": "DOT_PRODUCT",
           "manhattan": "MANHATTAN"}


class SdkSystem:
    """One client, one collection, the corpus ingested; ``call(queries)``
    is the traffic's SDK call on a [B, D] float32 batch."""

    def __init__(self, config: dict, traffic: dict, rows: np.ndarray,
                 metadata, device, timings: dict):
        from vectorlite_tpu_torch import (
            IndexType, MockEmbeddingFunction, SimilarityMetric, VectorLiteClient)
        from vectorlite_tpu_torch.config import VectorLiteConfig

        self.k = int(traffic["k"])
        self.where = traffic.get("where")
        self.metric = SimilarityMetric[METRICS[config["metric"]]]
        t0 = time.perf_counter()
        # the client takes a collection's width from its embedding
        # function; the benchmark sends raw vectors and never embeds
        self.client = VectorLiteClient(
            MockEmbeddingFunction(int(config["dim"])),
            config=VectorLiteConfig.profile(config["profile"]), device=device)
        self.client.create_collection(COLLECTION, IndexType.parse(config["index"]))
        ids = self.client.add_vectors_to_collection(COLLECTION, rows, metadatas=metadata)
        timings["load_s"] = time.perf_counter() - t0
        if len(ids) != rows.shape[0] or ids[0] != 0 or ids[-1] != rows.shape[0] - 1:
            raise RuntimeError("a fresh collection numbers its rows 0..N-1")
        call = traffic["call"]
        if call != "search_vectors":
            raise ValueError(f"unknown call {call!r}")

    def call(self, queries: np.ndarray) -> list:
        return self.client.search_vectors_in_collection(
            COLLECTION, queries, self.k, self.metric, where=self.where)

    def close(self) -> None:
        self.client.delete_collection(COLLECTION)
        self.client = None
