"""Multi-device scale-out: corpus-sharded search over a mesh of devices.

Port of ``vectorlite_tpu/dist/``. The JAX package shards the ``[N, D]``
corpus over a ``jax.sharding.Mesh`` and merges per-device top-ks with an
all-gather under ``shard_map``; here a mesh is a tuple of explicit
``torch.device``s (``sharding.make_mesh``), each shard a tensor of its
own, and the merge a gather of the per-shard winners to the first device
(across processes, a ``torch.distributed`` all-gather: ``multihost``).

* ``sharding`` — placement (``shard_corpus``, ``update_rows_sharded``)
  and the sharded engines: exact (K1/K4 per shard), speed path (K3 +
  exact re-score), int8 (K2), PQ (K5) and the IVF probe (K6).
* ``multihost`` — the multi-process regime: NCCL on CUDA, gloo on the
  CPU, chosen by the mesh's device.
* ``hnsw_mesh`` — the HNSW level-0 graph replicated on every mesh device,
  query batches split across the shards.

Serving integration: ``FlatIndex(mesh=...)`` (index/flat.py) and
``HNSWIndex(mesh=...)`` (index/hnsw.py), so ids, tombstones, compaction
and ``.vlc`` serde are shared with the single-device path;
``VECTORLITE_MESH=n`` builds the mesh in the client (store/client.py).
"""
