"""The port's multi-process mesh regime (vectorlite_tpu_torch/dist/
multihost.py) on the CPU over gloo, as tests/test_multihost.py holds the
JAX one: the single-process helpers, then two OS processes x 4 CPU shards
joined by a torch.distributed group (file:// rendezvous in the test's
temporary directory), running the exact scan, the speed path, an in-place
insert across the two processes' shards and a FlatIndex on the mesh,
each checked in both processes against the one-process answer."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from vectorlite_tpu_torch.dist import multihost
from vectorlite_tpu_torch.dist.sharding import make_mesh

REPO = Path(__file__).resolve().parents[1]


def test_place_and_fetch_single_process_paths():
    """On one process the helpers are the sharded placement and a host
    copy: the same values, the shards' rows."""
    mesh = make_mesh(["cpu"] * 4)
    host = np.arange(4 * 8 * 3, dtype=np.float32).reshape(4 * 8, 3)
    parts = multihost.place_global(mesh, host)
    assert [p.shape for p in parts] == [(8, 3)] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), host)
    np.testing.assert_array_equal(multihost.fetch_replicated(parts[1]), host[8:16])
    multihost.barrier(mesh)  # no process group: a no-op


def test_backend_follows_the_device():
    assert multihost.backend_for("cpu") == "gloo"
    assert multihost.backend_for(torch.device("cuda", 0)) == "nccl"
    assert multihost.backend_for("cuda") == "nccl"


def test_one_process_group_and_the_backend_check(tmp_path):
    """A one-process gloo group makes a mesh of world size 1 whose merge
    takes the collective path; a CUDA mesh refuses a gloo group."""
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric
    from vectorlite_tpu_torch.dist.sharding import shard_corpus, sharded_search_topk
    from vectorlite_tpu_torch.kernels.topk import search_topk

    multihost.init_process_group(
        "cpu", rank=0, world_size=1, init_method=f"file://{tmp_path / 'rdv'}"
    )
    try:
        with pytest.raises(ValueError, match="needs a nccl process group"):
            make_mesh(["cuda:0"], group=tdist.group.WORLD)
        mesh = make_mesh(["cpu"] * 2, group=tdist.group.WORLD)
        assert (mesh.rank, mesh.world, mesh.size) == (0, 1, 2)
        rng = np.random.default_rng(0)
        v = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
        sq, valid = (v * v).sum(1), torch.ones(64, dtype=torch.bool)
        q = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
        s, i = sharded_search_topk(*shard_corpus(mesh, v, sq, valid), q,
                                   metric=SimilarityMetric.COSINE, k=5, mesh=mesh)
        ws, wi = search_topk(v, sq, valid, q, metric=SimilarityMetric.COSINE, k=5)
        assert torch.equal(i, wi.long()) and torch.allclose(s, ws)
        multihost.barrier(mesh)
    finally:
        tdist.destroy_process_group()


RANK_BODY = r"""
import sys
import numpy as np
import torch
from vectorlite_tpu_torch.core.metrics import SimilarityMetric as M
from vectorlite_tpu_torch.dist import multihost
from vectorlite_tpu_torch.dist.sharding import (
    make_mesh, sharded_search_amk, sharded_search_topk, update_rows_sharded,
)
from vectorlite_tpu_torch.index import flat
from vectorlite_tpu_torch.index.flat import FlatIndex
from vectorlite_tpu_torch.kernels.topk import search_topk

rank, rdv = int(sys.argv[1]), sys.argv[2]
# each shard (and the one-device index) on the kernels' plain twins
flat._PALLAS_MIN_CAPACITY = 32
flat._PALLAS_TILE_F32 = flat._PALLAS_TILE_BF16 = flat._PALLAS_TILE_BLOCK = 256
multihost.init_process_group("cpu", rank=rank, world_size=2, init_method="file://" + rdv)
mesh = make_mesh(["cpu"] * 4, group=torch.distributed.group.WORLD)
assert (mesh.size, list(mesh.shard_ids())) == (8, list(range(4 * rank, 4 * rank + 4)))

# every process passes the same host truth and keeps its shards' rows
n, d, b, k = 64 * 8, 128, 4, 4
host = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
values = multihost.place_global(mesh, host)
assert [v.shape for v in values] == [(64, d)] * 4
np.testing.assert_array_equal(values[0].numpy(), host[256 * rank : 256 * rank + 64])
sq = multihost.place_global(mesh, np.einsum("nd,nd->n", host, host))
valid = multihost.place_global(mesh, np.ones(n, bool))
q = host[:b] + 1e-3
full = torch.from_numpy(host)

# exact scan: per-shard K1 twin + the merge across both processes
s, rows = sharded_search_topk(values, sq, valid, q, metric=M.COSINE, k=k, mesh=mesh)
got = multihost.fetch_replicated(rows)
assert list(got[:, 0]) == list(range(b)), got
ws, wi = search_topk(full, (full * full).sum(1), torch.ones(n, dtype=torch.bool),
                     torch.from_numpy(q), metric=M.COSINE, k=k)
np.testing.assert_array_equal(got, wi.numpy())

# speed path: K3 twin over a bf16 scan copy + exact re-score, watermark
scan = [v.to(torch.bfloat16) for v in values]
_, rows_amk = sharded_search_amk(scan, values, sq, valid, q, metric=M.COSINE, k=k,
                                 k_sel=32, mesh=mesh, tombstones=False, live_hi=n)
assert list(multihost.fetch_replicated(rows_amk)[:, 0]) == list(range(b))

# an in-place insert burst across the two processes' shards (255-256)
block = host[:2] * -1.0
update_rows_sharded(values, block, 255, mesh=mesh)
sq2 = [(v * v).sum(1) for v in values]
_, rows2 = sharded_search_topk(values, sq2, valid, block + 1e-3, metric=M.COSINE,
                               k=1, mesh=mesh)
assert list(multihost.fetch_replicated(rows2)[:, 0]) == [255, 256]

# a FlatIndex on the two-process mesh against one on one CPU device
one = FlatIndex(d, device="cpu")
idx = FlatIndex(d, mesh=mesh)
for index in (one, idx):
    index.add_batch_arrays(list(range(7, 7 * n + 7, 7)), host.astype(np.float64))
    index.delete(14)
qq = np.random.default_rng(1).normal(size=(6, d))
for metric in M:
    for approx in (False, True):
        a = idx.search_batch_arrays(qq, 5, metric, approx=approx)
        w = one.search_batch_arrays(qq, 5, metric, approx=approx)
        np.testing.assert_array_equal(a[0], w[0])
        np.testing.assert_allclose(a[1], w[1], rtol=1e-5, atol=1e-6)
multihost.barrier(mesh)
torch.distributed.destroy_process_group()
print(f"rank {rank} ok", flush=True)
"""


def test_two_processes_gloo_2x4(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    rdv = str(tmp_path / "rendezvous")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", RANK_BODY, str(rank), rdv], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"rank {rank} ok" in out
