"""The device mesh and the pipelined stream on the card (``pytest -m
cuda``): on ``cuda:0`` repeated 3 and 4 times, each per-shard kernel route
(K1-K6) against the same sharded call on a CPU mesh of their plain twins,
with ragged shards (a tile-aligned body and a padded tail a shard); a
burst of 4,096 rows across a shard boundary; the stream at depth 2. This
file imports no JAX: the plain twins are the reference here. On the CPU
the card tests skip, and the helpers' CPU tests run.
"""

import numpy as np
import pytest
import torch

from vectorlite_tpu_torch.core.metrics import SimilarityMetric as TM
from vectorlite_tpu_torch.dist import sharding as tsh
from vectorlite_tpu_torch.dist.sharding import make_mesh
from vectorlite_tpu_torch.index import flat as tflat
from vectorlite_tpu_torch.index.flat import FlatIndex


def t(x):
    return torch.from_numpy(np.array(x))


def tmesh(n):
    return tsh.make_mesh(["cpu"] * n)


def card_mesh_inputs(shards, rows_per_shard, d=384, b=64, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("K1-K6 are CUDA C++ and run only on an NVIDIA card")
    rng = np.random.default_rng([seed, shards, rows_per_shard])
    n = shards * rows_per_shard
    values = rng.normal(size=(n, d)).astype(np.float32)
    sq = np.einsum("nd,nd->n", values, values).astype(np.float32)
    valid = rng.random(n) > 0.05
    q = rng.normal(size=(b, d)).astype(np.float32)
    return values, sq, valid, q


def assert_near(got, want, rtol=1e-5):
    """Scores within rtol; ids equal except among scores within rtol of
    each other (f32 sums of the same products in another order)."""
    gs, gi = (x.cpu().numpy() for x in got)
    ws, wi = (x.cpu().numpy() for x in want)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=rtol, atol=rtol)
    for r, c in zip(*np.nonzero(gi != wi)):
        gaps = np.abs(ws[r] - ws[r, c])
        gaps[c] = np.inf
        assert gaps.min() <= rtol * max(1.0, abs(ws[r, c])), (r, c)


def launched(fn):
    from vectorlite_tpu_torch.kernels import _build

    before = {kk.symbol: kk.launches for kk in _build.KERNELS}
    out = fn()
    torch.cuda.synchronize()
    return out, {kk.symbol: kk.launches - before[kk.symbol] for kk in _build.KERNELS
                 if kk.launches != before[kk.symbol]}


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [3, 4])
def test_sharded_kernel_routes_match_plain_on_the_card(shards, monkeypatch):
    """cuda:0 repeated: K1 (k 10 and k 100), K4, K2 and K3 per shard on
    ragged shards (40,000 rows: a tile-aligned body and a padded tail),
    each against the same sharded call on a CPU mesh of the plain twins."""
    from vectorlite_tpu_torch.core.metrics import quantize_rows_int8

    monkeypatch.setattr(tflat, "_PALLAS_MIN_CAPACITY", 1 << 14)
    values, sq, valid, q = card_mesh_inputs(shards, 40_000)
    card, cpu = tsh.make_mesh(["cuda:0"] * shards), tmesh(shards)

    def both(fn, *arrays):
        return [fn(m, *[tsh.shard_rows(m, a) for a in arrays]) for m in (card, cpu)]

    for metric, k, sym in (("COSINE", 10, "scan_topk_exact_tf32"),
                           ("EUCLIDEAN", 100, "scan_topk_wide_tf32"),
                           ("MANHATTAN", 10, "scan_topk_l1_fadd")):
        (got, moved), want = launched(lambda: tsh.sharded_search_topk(
            *[tsh.shard_rows(card, a) for a in (values, sq, valid)], t(q),
            metric=TM[metric], k=k, mesh=card)), tsh.sharded_search_topk(
            *[tsh.shard_rows(cpu, a) for a in (values, sq, valid)], t(q),
            metric=TM[metric], k=k, mesh=cpu)
        assert moved == {sym: 2 * shards}  # the body and the tail of each shard
        assert_near(got, want)
    v8, sc = (x.numpy() for x in quantize_rows_int8(t(values)))
    (got, moved), want = launched(lambda: tsh.sharded_search_topk_int8(
        *[tsh.shard_rows(card, a) for a in (v8, sc, sq, valid)], t(q),
        metric=TM.COSINE, k=10, mesh=card)), tsh.sharded_search_topk_int8(
        *[tsh.shard_rows(cpu, a) for a in (v8, sc, sq, valid)], t(q),
        metric=TM.COSINE, k=10, mesh=cpu)
    assert moved == {"scan_topk_exact_s8": 2 * shards}
    assert_near(got, want)
    scan_card = tsh.shard_rows(card, values, torch.bfloat16)
    (got, moved), want = launched(lambda: tsh.sharded_search_amk(
        scan_card, *[tsh.shard_rows(card, a) for a in (values, sq, valid)], t(q),
        metric=TM.COSINE, k=10, k_sel=128, mesh=card)), tsh.sharded_search_amk(
        tsh.shard_rows(cpu, values, torch.bfloat16),
        *[tsh.shard_rows(cpu, a) for a in (values, sq, valid)], t(q),
        metric=TM.COSINE, k=10, k_sel=128, mesh=cpu)
    assert moved == {"scan_block_topw_bf16": 2 * shards}
    assert_near(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [3, 4])
def test_sharded_pq_and_ivf_match_plain_on_the_card(shards):
    """K5 and K6 per shard on cuda:0 repeated, against the CPU mesh."""
    from vectorlite_tpu_torch.kernels import ivf as tivf
    from vectorlite_tpu_torch.kernels import pq as tpq

    values, sq, valid, q = card_mesh_inputs(shards, 8192, d=64, b=16)
    card, cpu = tsh.make_mesh(["cuda:0"] * shards), tmesh(shards)
    cb = tpq.train_codebooks(t(values[:4096]), 32, kc=16, iters=3)
    codes = tpq.pack_nibbles(tpq.encode_rows(cb, t(values))).numpy()
    outs = []
    for m in (card, cpu):
        outs.append(launched(lambda m=m: tsh.sharded_search_pq(
            tsh.shard_rows(m, codes), cb.to(m.first), tsh.shard_rows(m, sq),
            tsh.shard_rows(m, valid), t(q), metric=TM.COSINE, k=10, chunk=1 << 16,
            mesh=m, packed=True)))
    assert outs[0][1] == {"pq_rank_mma": shards}
    assert_near(outs[0][0], outs[1][0], rtol=1e-4)
    # IVF: 12 cells of 2,048 rows, the cells split over the shards
    c, p_width = 12, 2048
    lay_rows = values[: c * p_width]
    slots = np.arange(c * p_width, dtype=np.int32)
    cents = lay_rows.reshape(c, p_width, -1).mean(axis=1)
    outs = []
    for m in (card, cpu):
        sh = lambda a, dtype=None, m=m: tsh.shard_rows(m, a, dtype)  # noqa: E731
        outs.append(launched(lambda sh=sh, m=m: tsh.sharded_search_ivf(
            sh(lay_rows, torch.bfloat16), sh(slots), sh(sq[: c * p_width]),
            sh(valid[: c * p_width]), sh(cents), sh(np.einsum("cd,cd->c", cents, cents)),
            sh(values), sh(valid), t(q), shards * 8192, metric=TM.COSINE, k=10, k_sel=128,
            nprobe_per_shard=2, p_width=p_width, mesh=m, tombstones=True)))
    assert outs[0][1] == {tivf.GATHER_SCORE.symbol: shards}
    assert_near(outs[0][0], outs[1][0])


def burst_start(shards, burst=4096, min_rows=1 << 14):
    """The row count ``a`` whose capacity puts a shard boundary at ``a +
    burst / 2`` with room for the burst, shards of at least ``min_rows``."""
    cap = -(-256 // shards) * shards
    while True:
        for g in range(1, shards):
            a = g * (cap // shards) - burst // 2
            if cap // 2 < a and a + burst <= cap and cap // shards >= min_rows:
                return a, cap
        cap *= 2


def test_burst_start_straddles_a_boundary():
    for shards in (3, 4, 8):
        a, cap = burst_start(shards)
        idx = FlatIndex(8, mesh=tmesh(shards))
        idx.add_batch_arrays(np.arange(a), np.zeros((a, 8)))
        assert idx._capacity == cap and (a + 2048) % (cap // shards) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [3, 4])
def test_mesh_index_burst_across_a_boundary_on_the_card(shards, monkeypatch):
    """FlatIndex on cuda:0 repeated against one on the card: after the
    first search places the corpus, a burst of 4,096 rows straddling a
    shard boundary, then a delete, each followed by an equal search (exact
    and speed paths)."""
    monkeypatch.setattr(tflat, "_PALLAS_MIN_CAPACITY", 1 << 14)
    monkeypatch.setenv("VECTORLITE_SPEED_GUARD", "0")
    a, cap = burst_start(shards)
    values, _, _, q = card_mesh_inputs(1, a + 4096)
    one = FlatIndex(384, device="cuda")
    idx = FlatIndex(384, mesh=tsh.make_mesh(["cuda:0"] * shards))
    for index in (one, idx):
        index.add_batch_arrays(np.arange(a), values[:a])
        index.search_batch_arrays(q, 10, TM.COSINE)
    placed = list(idx._dev_values)
    for index in (one, idx):
        index.add_batch_arrays(np.arange(a, a + 4096), values[a:])
    q2 = np.concatenate([q[:32], values[a + 2040 : a + 2072]])
    for approx in (False, None):
        got = idx.search_batch_arrays(q2, 10, TM.COSINE, approx=approx)
        want = one.search_batch_arrays(q2, 10, TM.COSINE, approx=approx)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
        assert list(got[0][32:, 0]) == list(range(a + 2040, a + 2072))
    assert idx._capacity == cap and all(x is y for x, y in zip(idx._dev_values, placed))
    for index in (one, idx):
        index.delete(a + 2048)
    got = idx.search_batch_arrays(q2, 10, TM.COSINE, approx=False)
    want = one.search_batch_arrays(q2, 10, TM.COSINE, approx=False)
    np.testing.assert_array_equal(got[0], want[0])
    assert a + 2048 not in got[0]


def list_stream(idx, batches, k, metric, **kw):
    return list(idx.search_batch_stream(iter(batches), k, TM[metric], **kw))


def assert_like_arrays(idx, batches, got, k, metric, exact=True, **kw):
    assert len(got) == len(batches)
    for q, (ids, scores) in zip(batches, got):
        ref_ids, ref_scores = idx.search_batch_arrays(q, k, TM[metric], **kw)
        np.testing.assert_array_equal(ids, ref_ids)
        if exact:
            np.testing.assert_array_equal(scores, ref_scores)
        else:
            np.testing.assert_allclose(scores, ref_scores, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shards", [0, 3, 4])
def test_stream_on_the_card(mesh_shards, monkeypatch):
    """depth 2, groups of 1 and 4, on one card and on cuda:0 repeated:
    the fetch goes into pinned buffers behind an event; every batch equals
    its search_batch_arrays (ids; scores bit-equal ungrouped)."""
    if not torch.cuda.is_available():
        pytest.skip("the stream's pinned fetch runs only on an NVIDIA card")
    monkeypatch.setattr(tflat, "_PALLAS_MIN_CAPACITY", 1 << 14)
    monkeypatch.setenv("VECTORLITE_SPEED_GUARD", "0")
    rng = np.random.default_rng(0)
    n, d = 3 * 40_000, 384
    data = rng.normal(size=(n, d)).astype(np.float32)
    kw = ({"mesh": make_mesh(["cuda:0"] * mesh_shards)} if mesh_shards
          else {"device": "cuda"})
    idx = FlatIndex(d, **kw)
    idx.add_batch_arrays(np.arange(n), data)
    batches = [rng.normal(size=(64, d)) for _ in range(8)]
    for approx in (None, False):
        got = list_stream(idx, batches, 10, "COSINE", depth=2, approx=approx)
        assert_like_arrays(idx, batches, got, 10, "COSINE", approx=approx)
        got = list_stream(idx, batches, 10, "COSINE", depth=2, group=4, approx=approx)
        assert_like_arrays(idx, batches, got, 10, "COSINE", exact=False, approx=approx)


@pytest.mark.parametrize("metric", ["COSINE", "EUCLIDEAN", "DOT_PRODUCT", "MANHATTAN"])
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_beam_distances_do_not_depend_on_the_batch(device, metric):
    """The mesh beam splits a batch into one part a shard and promises
    each query the single-device beam (dist/hnsw_mesh.py), so the beam's
    neighbour distances (kernels/beam.py) of 256 queries must equal, bit
    for bit, those of their four parts of 64. A batched matrix product
    failed this on the card (dots up to 1.5e-5 apart): the smoke's mesh
    beam then listed other rows than one card's."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from vectorlite_tpu_torch.kernels import beam

    g = torch.Generator().manual_seed(1)
    q = torch.randn(256, 384, generator=g).to(device)
    nvecs = torch.randn(256, 32, 384, generator=g).to(device)
    n_sq = (nvecs * nvecs).sum(-1)
    q_norm = torch.sqrt((q * q).sum(-1, keepdim=True))
    m = TM[metric]
    whole = beam._neighbor_dists(q, q_norm, nvecs, n_sq, m)
    parts = torch.cat([beam._neighbor_dists(q[i:i + 64], q_norm[i:i + 64], nvecs[i:i + 64],
                                            n_sq[i:i + 64], m) for i in range(0, 256, 64)])
    assert torch.equal(whole, parts)
