"""The corpus and the query pool of a deployment, made from the seed.

A seeded anisotropic Gaussian mixture, the recipe of
``bench/probe_scale8m.py:50 make_clustered`` written in PyTorch: unit
cluster centres, noise whose standard deviation decays with the
dimension index as ``noise / (1 + i) ** decay`` (a PCA spectrum like
real embeddings'), rows L2-normalised where the deployment's vectors
are. The queries are a held-out stream of the same mixture: the same
centres, drawn after the corpus from the same generator.

Everything is drawn on ``device`` by one ``torch.Generator`` in a few
large calls; the rows come back to the host as float32, which is what
a user hands to the SDK.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: rows drawn per call: four calls at 1M rows keep the device's transient
#: at ~1 GB a call instead of the whole corpus twice
CHUNK_ROWS = 1 << 18


@dataclass
class Data:
    rows: np.ndarray  # [N, D] float32
    queries: np.ndarray  # [P, D] float32, the query pool
    metadata: list | None  # one dict a row, or None


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _draw(g, centers, scale, n, normalize, out: np.ndarray) -> None:
    """``n`` mixture rows into ``out`` (host float32), a chunk at a time."""
    device = centers.device
    for lo in range(0, n, CHUNK_ROWS):
        m = min(CHUNK_ROWS, n - lo)
        cid = torch.randint(0, centers.shape[0], (m,), generator=g, device=device)
        rows = torch.randn((m, centers.shape[1]), generator=g, device=device)
        rows.mul_(scale).add_(centers[cid])
        if normalize:
            rows.div_(torch.linalg.vector_norm(rows, dim=1, keepdim=True))
        torch.from_numpy(out[lo : lo + m]).copy_(rows)


def make_data(config: dict, pool: int, seed: int, device) -> Data:
    """The deployment's rows, ``pool`` queries and its metadata."""
    n, d = int(config["rows"]), int(config["dim"])
    gen = config["generator"]
    if gen["kind"] != "gaussian_mixture":
        raise ValueError(f"unknown generator {gen['kind']!r}")
    g = generator(seed, device)
    centers = torch.randn((int(gen["clusters"]), d), generator=g, device=device)
    centers.div_(torch.linalg.vector_norm(centers, dim=1, keepdim=True))
    dims = torch.arange(d, dtype=torch.float32, device=device)
    scale = float(gen["noise"]) / (1.0 + dims) ** float(gen["decay"])
    rows = np.empty((n, d), np.float32)
    queries = np.empty((pool, d), np.float32)
    _draw(g, centers, scale, n, bool(gen["normalize"]), rows)
    _draw(g, centers, scale, pool, bool(gen["normalize"]), queries)
    return Data(rows, queries, make_metadata(config))


def make_metadata(config: dict) -> list | None:
    """One dict a row: each field of ``config["metadata"]`` that reads
    ``"row"`` holds the row's position."""
    fields = config.get("metadata")
    if not fields:
        return None
    for field, kind in fields.items():
        if kind != "row":
            raise ValueError(f"unknown metadata kind {kind!r} for {field!r}")
    names = list(fields)
    return [{name: i for name in names} for i in range(int(config["rows"]))]
