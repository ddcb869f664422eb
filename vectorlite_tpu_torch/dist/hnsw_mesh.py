"""HNSW over a mesh: the level-0 graph replicated, query batches split.

Port of ``vectorlite_tpu/dist/hnsw_mesh.py``. The level-0 vectors, squared
norms and adjacency are kept once on each distinct device of the mesh,
and a batch of queries is split into one equal part a shard; each shard
runs the batched beam (``kernels/beam.py``) over its part against its
device's copy, and the beams are concatenated in order. No step of one
query reads another's state, so each query's beam is the one the
single-device beam gives. The graph build stays on the host (the native
builder), and the mesh beam serves the batches a caller sends with
``use_device=True``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.metrics import SimilarityMetric
from ..kernels.beam import beam_search_l0
from .sharding import Mesh


def replicate_graph(mesh: Mesh, vecs, sqnorms, adj):
    """One copy of the level-0 arrays on each distinct mesh device (a
    tensor already there is used as it is); returns per-shard lists
    (vecs, sqnorms, adj), shards of one device sharing its copy. Called
    from the index's device sync, under its device lock."""
    copies = {}
    for dev in mesh.distinct_devices():
        copies[dev] = tuple(torch.as_tensor(a).to(dev) for a in (vecs, sqnorms, adj))
    return tuple([copies[d][j] for d in mesh.devices] for j in range(3))


def mesh_beam_search(
    mesh: Mesh,
    vecs,  # per-shard lists from replicate_graph
    sqnorms,
    adj,
    entries,  # [B] int32 per-query level-0 entry nodes (host descent)
    queries,  # [B, D] f32; B must be a multiple of the mesh size
    *,
    metric: SimilarityMetric,
    ef: int,
    max_iters: int,
):
    """Returns (beam_ids [B, ef] int32, beam_dist [B, ef] f32) on the
    mesh's first device: each query's beam as the single-device beam
    gives it, computed a shard's part of the batch at a time."""
    n = mesh.size
    b = queries.shape[0]
    if b % n:
        raise ValueError(f"batch {b} must be a multiple of the mesh size {n}")
    per = b // n
    q = torch.as_tensor(np.asarray(queries, np.float32))
    e = torch.as_tensor(np.asarray(entries, np.int32))
    ids, dists = [], []
    for s, g in enumerate(mesh.shard_ids()):
        dev = mesh.devices[s]
        part = slice(g * per, (g + 1) * per)
        i, d = beam_search_l0(
            vecs[s], sqnorms[s], adj[s], e[part].to(dev), q[part].to(dev),
            metric=metric, ef=ef, max_iters=max_iters,
        )
        ids.append(i.to(mesh.first))
        dists.append(d.to(mesh.first))
    ids, dists = torch.cat(ids), torch.cat(dists)
    if mesh.world > 1:
        from .multihost import gather_ranks

        ids = gather_ranks(mesh, ids).reshape(b, -1)
        dists = gather_ranks(mesh, dists).reshape(b, -1)
    return ids, dists
