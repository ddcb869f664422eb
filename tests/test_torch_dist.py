"""The port's device mesh (vectorlite_tpu_torch/dist) against the JAX
package's on the same seeded numpy inputs.

JAX runs on its 8 virtual CPU devices (tests/conftest.py), the port on 8
CPU shards, and on 3 for the ragged case (shards whose rows are not a
multiple of the tile). Ids agree exactly (ties to the lowest row), scores
within rtol 1e-5 / atol 1e-6 unless stated. The kernel regime is reached
at test sizes by lowering the port's ``_PALLAS_MIN_CAPACITY`` and tiles,
so each shard runs the plain twins of K1-K4 as the card runs the kernels,
over a tile-aligned body and a padded tail.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vectorlite_tpu.core.metrics import SimilarityMetric as JM
from vectorlite_tpu.dist import sharding as jsh
from vectorlite_tpu.index.flat import FlatIndex as JFlat
from vectorlite_tpu.kernels import pallas_scan as jscan
from vectorlite_tpu_torch.core.metrics import SimilarityMetric as TM
from vectorlite_tpu_torch.core.types import Vector
from vectorlite_tpu_torch.dist import sharding as tsh
from vectorlite_tpu_torch.index import flat as tflat
from vectorlite_tpu_torch.index.flat import FlatIndex

METRICS = ["COSINE", "EUCLIDEAN", "DOT_PRODUCT", "MANHATTAN"]
DOT_METRICS = ["COSINE", "EUCLIDEAN", "DOT_PRODUCT"]


def jmesh(n):
    return jsh.make_mesh(jax.devices()[:n])


def tmesh(n):
    return tsh.make_mesh(["cpu"] * n)


@pytest.fixture(params=["full-score", "kernel"])
def regime(request, monkeypatch):
    """Below the kernel threshold (the full-score path) or above it, with
    tiles small enough that a shard has a body and a ragged tail."""
    if request.param == "kernel":
        monkeypatch.setattr(tflat, "_PALLAS_MIN_CAPACITY", 64)
        monkeypatch.setattr(tflat, "_PALLAS_TILE_F32", 256)
        monkeypatch.setattr(tflat, "_PALLAS_TILE_BF16", 256)
        monkeypatch.setattr(tflat, "_PALLAS_TILE_BLOCK", 256)
    return request.param


def corpus(rng, n, d, invalid=0.1):
    values = rng.normal(size=(n, d)).astype(np.float32)
    sq = np.einsum("nd,nd->n", values, values).astype(np.float32)
    valid = rng.random(n) > invalid
    return values, sq, valid


def t(x):
    return torch.from_numpy(np.array(x))


def check(jout, tout, rtol=1e-5, atol=1e-6):
    js, ji = (np.asarray(x) for x in jout)
    ts, ti = (x.cpu().numpy() for x in tout)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=atol)


# 2,064 rows: 8 shards of 258 (a 256-row body + 2) and 3 of 688 (512 + 176)
N_RAGGED = 2064


@pytest.mark.parametrize("shards", [8, 3])
@pytest.mark.parametrize("metric", METRICS)
def test_sharded_topk_matches_jax(metric, shards, regime, rng):
    d, b, k = 48, 8, 10
    values, sq, valid = corpus(rng, N_RAGGED, d)
    q = rng.normal(size=(b, d)).astype(np.float32)
    jm = jmesh(shards)
    jout = jsh.sharded_search_topk(
        *jsh.shard_corpus(jm, jnp.asarray(values), jnp.asarray(sq), jnp.asarray(valid)),
        jnp.asarray(q), metric=JM[metric], k=k, mesh=jm,
    )
    tm = tmesh(shards)
    tout = tsh.sharded_search_topk(
        *tsh.shard_corpus(tm, t(values), t(sq), t(valid)), t(q),
        metric=TM[metric], k=k, mesh=tm,
    )
    check(jout, tout)


@pytest.mark.parametrize("shards", [8, 3])
@pytest.mark.parametrize("metric", METRICS)
def test_sharded_int8_matches_jax(metric, shards, regime, rng):
    from vectorlite_tpu.core.metrics import quantize_rows_int8 as jquant

    d, b, k = 48, 8, 10
    values, sq, valid = corpus(rng, N_RAGGED, d)
    q = rng.normal(size=(b, d)).astype(np.float32)
    vq, sc = (np.asarray(x) for x in jquant(jnp.asarray(values)))
    jm = jmesh(shards)
    place = lambda x, nd: jax.device_put(jnp.asarray(x), jsh.row_sharding(jm, nd))  # noqa: E731
    jout = jsh.sharded_search_topk_int8(
        place(vq, 2), place(sc, 1), place(sq, 1), place(valid, 1), jnp.asarray(q),
        metric=JM[metric], k=k, mesh=jm,
    )
    tm = tmesh(shards)
    tout = tsh.sharded_search_topk_int8(
        *(tsh.shard_rows(tm, t(x)) for x in (vq, sc, sq, valid)), t(q),
        metric=TM[metric], k=k, mesh=tm,
    )
    check(jout, tout)


def test_cross_shard_tie_break_global_row_order(rng):
    n, d, b, k = 1024, 32, 8, 4
    base = rng.normal(size=d).astype(np.float32)
    data = rng.normal(size=(n, d)).astype(np.float32) * 10
    for row in (5, 400, 900):  # rows on different shards
        data[row] = base
    sq = np.einsum("nd,nd->n", data, data).astype(np.float32)
    valid = np.ones(n, bool)
    q = np.repeat(base[None, :], b, axis=0)
    jm = jmesh(8)
    _, ji = jsh.sharded_search_topk(
        *jsh.shard_corpus(jm, jnp.asarray(data), jnp.asarray(sq), jnp.asarray(valid)),
        jnp.asarray(q), metric=JM.COSINE, k=k, mesh=jm,
    )
    tm = tmesh(8)
    _, ti = tsh.sharded_search_topk(
        *tsh.shard_corpus(tm, t(data), t(sq), t(valid)), t(q),
        metric=TM.COSINE, k=k, mesh=tm,
    )
    assert list(ti.numpy()[0][:3]) == [5, 400, 900]
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("shards,start,m", [(8, 6, 5), (3, 20, 30), (8, 0, 64)])
def test_update_rows_sharded_across_a_boundary(shards, start, m, rng):
    cap, d = 8 * 3 * 4, 8  # 96 rows: 12 a shard at 8, 32 at 3
    base = rng.normal(size=(cap, d)).astype(np.float32)
    rows = rng.normal(size=(m, d)).astype(np.float32)
    tm = tmesh(shards)
    buf = tsh.shard_rows(tm, base)
    kept = [x for x in buf]
    assert tsh.update_rows_sharded(buf, rows, start, mesh=tm) is buf
    assert all(a is b for a, b in zip(buf, kept))  # written in place
    want = base.copy()
    want[start : start + m] = rows
    np.testing.assert_array_equal(torch.cat(buf).numpy(), want)
    if shards == 8:
        jm = jmesh(8)
        jbuf = jax.device_put(base.copy(), jsh.row_sharding(jm, 2))
        jout = jsh.update_rows_sharded(jbuf, jnp.asarray(rows), start, mesh=jm)
        np.testing.assert_array_equal(np.asarray(jout), want)


def test_shard_placement_round_trip(rng):
    tm = tmesh(4)
    host = rng.normal(size=(64, 5)).astype(np.float32)
    parts = tsh.shard_rows(tm, host)
    assert [p.shape for p in parts] == [(16, 5)] * 4
    assert len({p.data_ptr() for p in parts}) == 4  # a tensor of its own each
    np.testing.assert_array_equal(torch.cat(parts).numpy(), host)
    with pytest.raises(ValueError, match="split"):
        tsh.shard_rows(tm, host[:63])
    assert tm.size == 4 and list(tm.shard_ids()) == [0, 1, 2, 3]
    assert tm.distinct_devices() == [torch.device("cpu")]


def test_make_mesh_checks_its_devices(monkeypatch):
    with pytest.raises(ValueError, match="all be CUDA devices or all the CPU"):
        tsh.make_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one"):
        tsh.make_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsh.make_mesh()


# ------------------------------------------------------------ speed path


def jax_block_rescored_by_shard(values, sq, valid, q, metric, k, k_sel, shards,
                                tile):
    """The JAX speed path's selection (pallas_search_block_topk_rescored,
    interpret mode) applied shard by shard and merged shard-major."""
    n = values.shape[0]
    rows = n // shards
    s_all, i_all = [], []
    for g in range(shards):
        part = slice(g * rows, (g + 1) * rows)
        s, i = jscan.pallas_search_block_topk_rescored(
            jnp.asarray(values[part]), jnp.asarray(values[part]),
            jnp.asarray(sq[part]), jnp.asarray(valid[part]), jnp.asarray(q),
            metric=JM[metric], k=min(k, rows), k_sel=min(k_sel, rows),
            tile_n=tile, interpret=True, winners=2,
        )
        s_all.append(np.asarray(s))
        i_all.append(np.asarray(i).astype(np.int64) + g * rows)
    s = np.concatenate(s_all, axis=1)
    i = np.concatenate(i_all, axis=1)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, 1), np.take_along_axis(i, order, 1)


@pytest.mark.parametrize("shards", [4, 3])
@pytest.mark.parametrize("metric", DOT_METRICS)
def test_sharded_amk_matches_jax_block_rescored(metric, shards, monkeypatch, rng):
    monkeypatch.setattr(tflat, "_PALLAS_MIN_CAPACITY", 64)
    monkeypatch.setattr(tflat, "_PALLAS_TILE_BLOCK", 256)
    d, b, k, k_sel = 48, 8, 10, 64
    values, sq, valid = corpus(rng, 512 * shards, d, invalid=0.15)
    q = rng.normal(size=(b, d)).astype(np.float32)
    want = jax_block_rescored_by_shard(values, sq, valid, q, metric, k, k_sel, shards, 256)
    tm = tmesh(shards)
    v = tsh.shard_rows(tm, values)
    tout = tsh.sharded_search_amk(
        v, v, tsh.shard_rows(tm, sq), tsh.shard_rows(tm, valid), t(q),
        metric=TM[metric], k=k, k_sel=k_sel, mesh=tm,
    )
    check(want, tout)


@pytest.mark.parametrize("metric", DOT_METRICS)
def test_sharded_amk_watermark_fast_path(metric, monkeypatch, rng):
    """tombstones=False with the global watermark: each shard clips it to
    its own rows, and the results equal the validity-gather path's on a
    contiguous live prefix (a watermark inside the third of 8 shards)."""
    monkeypatch.setattr(tflat, "_PALLAS_MIN_CAPACITY", 64)
    monkeypatch.setattr(tflat, "_PALLAS_TILE_BLOCK", 256)
    n, live, d, b, k = 2048, 577, 48, 8, 10
    values = rng.normal(size=(n, d)).astype(np.float32)
    values[live:] = 0.0
    valid = np.zeros(n, bool)
    valid[:live] = True
    sq = np.einsum("nd,nd->n", values, values).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    tm = tmesh(8)
    v = tsh.shard_rows(tm, values)
    args = (v, v, tsh.shard_rows(tm, sq), tsh.shard_rows(tm, valid), t(q))
    kw = dict(metric=TM[metric], k=k, k_sel=64, mesh=tm)
    ref = tsh.sharded_search_amk(*args, **kw)
    fast = tsh.sharded_search_amk(*args, tombstones=False, live_hi=live, **kw)
    np.testing.assert_array_equal(fast[1].numpy(), ref[1].numpy())
    np.testing.assert_allclose(fast[0].numpy(), ref[0].numpy(), rtol=1e-5, atol=1e-6)
    jm = jmesh(8)
    jv = jax.device_put(jnp.asarray(values), jsh.row_sharding(jm, 2))
    jout = jsh.sharded_search_amk(
        jv, jv, jax.device_put(jnp.asarray(sq), jsh.row_sharding(jm, 1)),
        jax.device_put(jnp.asarray(valid), jsh.row_sharding(jm, 1)), jnp.asarray(q),
        metric=JM[metric], k=k, k_sel=64, recall_target=0.99, mesh=jm,
        tombstones=False, live_hi=jnp.int32(live),
    )
    # on the CPU the JAX selection (approx_max_k) is exact, and K3's pool
    # of 64 holds this corpus's true top 10: the same winners
    check(jout, fast)


# ------------------------------------------------------------------- PQ


@pytest.mark.parametrize("shards", [8, 3])
@pytest.mark.parametrize("metric", METRICS)
def test_sharded_pq_matches_jax(metric, shards, rng):
    from vectorlite_tpu.kernels import pq as jpq
    from vectorlite_tpu_torch.kernels import pq as tpq

    n, d, m, b, k = 24 * 64, 32, 16, 4, 8
    values = rng.normal(size=(n, d)).astype(np.float32)
    sq = np.einsum("nd,nd->n", values, values).astype(np.float32)
    valid = rng.random(n) > 0.1
    q = rng.normal(size=(b, d)).astype(np.float32)
    cb = jpq.train_codebooks(values[:1024], m, kc=16, iters=3)
    codes = np.asarray(jpq.pack_nibbles(jpq.encode_rows(cb, jnp.asarray(values))))
    jm = jmesh(shards)
    place = lambda x, nd: jax.device_put(jnp.asarray(x), jsh.row_sharding(jm, nd))  # noqa: E731
    jout = jsh.sharded_search_pq(
        place(codes, 2), cb, place(sq, 1), place(valid, 1), jnp.asarray(q),
        metric=JM[metric], k=k, chunk=256, mesh=jm, packed=True,
    )
    tm = tmesh(shards)
    tout = tsh.sharded_search_pq(
        tsh.shard_rows(tm, codes), tpq.codebooks_from_reference(np.asarray(cb), device="cpu"),
        tsh.shard_rows(tm, sq), tsh.shard_rows(tm, valid), t(q),
        metric=TM[metric], k=k, chunk=256, mesh=tm, packed=True,
    )
    check(jout, tout)


# ------------------------------------------------------------------- IVF


def ivf_layout(rng, c=16, d=64, n=1500, cap=2048):
    """A JAX-trained layout (as test_dist.py's IVF test builds it) with
    a pad wide enough that no row spills: the probe of every cell
    covers every live row."""
    from vectorlite_tpu.kernels import ivf as ivf_k

    rows64 = rng.normal(size=(n, d))
    live = np.arange(n)
    cents = ivf_k.train_centroids(rows64.astype(np.float32), c, iters=4, chunk=500)
    assign = ivf_k.assign_rows(rows64, live, cents)
    part_slots, extra = ivf_k.build_layout(assign, live, c, pad_factor=4.0)
    assert len(extra) == 0
    p_width = part_slots.shape[1]
    ps = part_slots.reshape(-1).astype(np.int32)
    rows32 = np.zeros((c * p_width, d), np.float32)
    rows32[ps >= 0] = rows64[ps[ps >= 0]].astype(np.float32)
    vals32 = np.zeros((cap, d), np.float32)
    vals32[:n] = rows64.astype(np.float32)
    cents = np.asarray(cents)
    return dict(
        rows64=rows64, rows32=rows32, ps=ps, psq=np.einsum("nd,nd->n", rows32, rows32),
        pok=ps >= 0, cents=cents, csq=np.einsum("cd,cd->c", cents, cents),
        vals32=vals32, valid=np.ones(cap, bool), n=n, p_width=p_width, c=c,
    )


@pytest.mark.parametrize("shards", [8, 4])
@pytest.mark.parametrize("probe", ["all", "two"])
def test_sharded_ivf_matches_jax(shards, probe, rng):
    lay = ivf_layout(rng)
    b, k = 6, 10
    q = lay["rows64"][:b].astype(np.float32)
    nprobe = lay["c"] // shards if probe == "all" else min(2, lay["c"] // shards)
    kw = dict(k=k, k_sel=128, nprobe_per_shard=nprobe, p_width=lay["p_width"])
    jm = jmesh(shards)
    js, ji = jsh.sharded_search_ivf(
        jnp.asarray(lay["rows32"], jnp.bfloat16), jnp.asarray(lay["ps"]),
        jnp.asarray(lay["psq"]), jnp.asarray(lay["pok"]), jnp.asarray(lay["cents"]),
        jnp.asarray(lay["csq"]), jnp.asarray(lay["vals32"]), jnp.asarray(lay["valid"]),
        jnp.asarray(q), jnp.int32(lay["n"]), metric=JM.COSINE, mesh=jm, **kw,
    )
    tm = tmesh(shards)
    sh = lambda x, dtype=None: tsh.shard_rows(tm, x, dtype)  # noqa: E731
    ts, ti = tsh.sharded_search_ivf(
        sh(lay["rows32"], torch.bfloat16), sh(lay["ps"]), sh(lay["psq"]), sh(lay["pok"]),
        sh(lay["cents"]), sh(lay["csq"]), sh(lay["vals32"]), sh(lay["valid"]),
        t(q), lay["n"], metric=TM.COSINE, mesh=tm, **kw,
    )
    check((js, ji), (ts, ti))
    if probe == "all":
        v, qq = lay["rows64"], lay["rows64"][:b]
        sc = (qq @ v.T) / (np.linalg.norm(qq, axis=1, keepdims=True)
                           * np.linalg.norm(v, axis=1)[None, :])
        truth = np.argsort(-sc, axis=1, kind="stable")[:, :k]
        for row in range(b):
            assert set(ti.numpy()[row].tolist()) == set(truth[row].tolist())


def test_sharded_ivf_tombstones_gather_the_mask(rng):
    lay = ivf_layout(rng)
    b, k = 6, 10
    q = lay["rows64"][:b].astype(np.float32)
    tm = tmesh(4)
    dead = np.zeros_like(lay["valid"])
    valid = lay["valid"].copy()
    valid[:b] = False  # each query's own row is its nearest: now deleted
    sh = lambda x, dtype=None: tsh.shard_rows(tm, x, dtype)  # noqa: E731
    _, ti = tsh.sharded_search_ivf(
        sh(lay["rows32"], torch.bfloat16), sh(lay["ps"]), sh(lay["psq"]), sh(lay["pok"]),
        sh(lay["cents"]), sh(lay["csq"]), sh(lay["vals32"]), sh(valid),
        t(q), lay["n"], metric=TM.COSINE, k=k, k_sel=128, nprobe_per_shard=4,
        p_width=lay["p_width"], mesh=tm, tombstones=True,
    )
    assert not np.isin(ti.numpy(), np.arange(b)).any()
    assert not dead.any()


# --------------------------------------------------------- FlatIndex(mesh)


def build_pair(shards, n=700, d=32, seed=0, **kw):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d))
    ids = list(range(0, 7 * n, 7))
    metas = [{"g": i % 3} for i in range(n)]
    j = JFlat(d, mesh=jmesh(shards), **kw)
    p = FlatIndex(d, mesh=tmesh(shards), **kw)
    for idx in (j, p):
        idx.add_batch_arrays(ids, data, texts=[f"t{i}" for i in ids], metadatas=metas)
    return j, p, data, rng


def same_arrays(j_out, t_out, rtol=1e-5, atol=1e-6):
    np.testing.assert_array_equal(t_out[0], j_out[0])
    np.testing.assert_allclose(t_out[1], j_out[1], rtol=rtol, atol=atol)


@pytest.mark.parametrize("shards", [8, 3])
@pytest.mark.parametrize("metric", METRICS)
def test_mesh_flat_index_matches_jax_through_mutations(metric, shards):
    """One add / delete / search / compact / add / search sequence on the
    JAX mesh index and the port's: the same ids and f32 scores at every
    step, a where filter included."""
    j, p, data, rng = build_pair(shards)
    assert p._capacity % shards == 0 and p._capacity == j._capacity
    q = rng.normal(size=(9, 32))
    jm, tm = JM[metric], TM[metric]
    same_arrays(j.search_batch_arrays(q, 5, jm), p.search_batch_arrays(q, 5, tm))
    for vid in range(0, 7 * 400, 7):
        j.delete(vid)
        p.delete(vid)  # past half dead: compaction
    assert p._size == j._size and len(p) == len(j) == 300
    more = rng.normal(size=(50, 32))
    for idx in (j, p):
        idx.add_batch_arrays(list(range(10**6, 10**6 + 50)), more,
                             metadatas=[{"g": 1}] * 50)
    same_arrays(j.search_batch_arrays(q, 5, jm), p.search_batch_arrays(q, 5, tm))
    same_arrays(j.search_batch_arrays(q, 7, jm, where={"g": 1}),
                p.search_batch_arrays(q, 7, tm, where={"g": 1}))
    # a single query on the mesh scans on the device, as in JAX; a row's
    # distance to itself is f32 cancellation noise in the expanded
    # euclidean form (|q|^2 + |v|^2 - 2 q.v), in both packages
    same_arrays(j.search_batch_arrays(more[3:4], 1, jm),
                p.search_batch_arrays(more[3:4], 1, tm),
                atol=1e-2 if metric == "EUCLIDEAN" else 1e-6)
    assert p.search_batch_arrays(more[3:4], 1, tm)[0][0, 0] == 10**6 + 3


@pytest.mark.parametrize("shards", [8, 3])
def test_mesh_amk_matches_exact(shards, monkeypatch):
    """The mesh speed path (K3 per shard + exact re-score) against the
    per-shard exact path on the same index: on this corpus the pools hold
    the true winners, so any difference is a merge, offset or re-score
    fault. Kernel scale, ragged tails included."""
    monkeypatch.setattr(tflat, "_PALLAS_MIN_CAPACITY", 64)
    monkeypatch.setattr(tflat, "_PALLAS_TILE_F32", 256)
    monkeypatch.setattr(tflat, "_PALLAS_TILE_BLOCK", 256)
    rng = np.random.default_rng(1)
    n, d, k = 1500, 32, 7
    data = rng.normal(size=(n, d))
    idx = FlatIndex(d, mesh=tmesh(shards))
    idx.add_batch_arrays(np.arange(n) * 3, data)
    q = rng.normal(size=(6, d))
    for metric in (TM.COSINE, TM.EUCLIDEAN, TM.DOT_PRODUCT):
        a = idx.search_batch_arrays(q, k, metric, approx=True)
        e = idx.search_batch_arrays(q, k, metric, approx=False)
        same_arrays(e, a)
    idx.delete(3 * 17)
    a = idx.search_batch_arrays(data[17:18] + 1e-3, 2, TM.COSINE, approx=True)
    assert a[0][0, 0] != 3 * 17


def test_mesh_scan_copy_and_guard(monkeypatch):
    """At kernel scale the mesh keeps a bf16 scan copy a shard (the JAX
    mesh's) when the budget of its distinct devices allows, and refuses it
    when the precision guard trips."""
    monkeypatch.setattr(tflat, "_PALLAS_MIN_CAPACITY", 64)
    monkeypatch.setenv("VECTORLITE_SPEED_GUARD", "0")
    rng = np.random.default_rng(2)
    idx = FlatIndex(16, mesh=tmesh(4))
    idx.add_batch_arrays(np.arange(300), rng.normal(size=(300, 16)))
    idx.search_batch_arrays(rng.normal(size=(8, 16)), 3, TM.COSINE)
    assert [s.dtype for s in idx._dev_scan] == [torch.bfloat16] * 4
    assert [s.shape[0] for s in idx._dev_values] == [idx._capacity // 4] * 4
    monkeypatch.setenv("VECTORLITE_AUTO_BF16_GB", str(300 * 16 * 6 / 2 ** 30 / 8))
    idx2 = FlatIndex(16, mesh=tmesh(4))
    idx2.add_batch_arrays(np.arange(300), rng.normal(size=(300, 16)))
    idx2.search_batch_arrays(rng.normal(size=(8, 16)), 3, TM.COSINE)
    assert idx2._dev_scan is None  # one CPU device's budget, counted once


def test_delete_and_incremental_insert_write_in_place():
    """The first search places the corpus; an insert burst then writes
    only the shards it lands on (the same tensors, updated), deletes flip
    the sharded mask."""
    rng = np.random.default_rng(3)
    n, d = 250, 16  # within the first capacity (256): no regrowth
    data = rng.normal(size=(n, d))
    idx = FlatIndex(d, mesh=tmesh(8))
    for i in range(200):
        idx.add(Vector(id=i, values=list(map(float, data[i])), text=""))
    idx.search_batch_arrays(data[:2], 3, TM.COSINE)
    placed = list(idx._dev_values)
    idx.delete(5)
    idx.delete(999999)  # absent id: succeeds
    for i in range(200, 250):  # slots 200-249 straddle shards 6 and 7
        idx.add(Vector(id=i, values=list(map(float, data[i])), text=""))
    ids, _ = idx.search_batch_arrays(data[220:222], 2, TM.EUCLIDEAN)
    assert list(ids[:, 0]) == [220, 221]
    assert all(a is b for a, b in zip(idx._dev_values, placed))
    ids, _ = idx.search_batch_arrays(data[5:6], 1, TM.EUCLIDEAN)
    assert ids[0, 0] != 5 and len(idx) == 249


def test_growth_across_capacity_keeps_the_split():
    rng = np.random.default_rng(4)
    d = 16
    idx = FlatIndex(d, mesh=tmesh(3))
    data = rng.normal(size=(600, d))
    for i in range(300):
        idx.add(Vector(id=i, values=list(map(float, data[i])), text=""))
    idx.search_batch_arrays(data[:4], 2, TM.COSINE)
    for i in range(300, 600):
        idx.add(Vector(id=i, values=list(map(float, data[i])), text=""))
    ids, _ = idx.search_batch_arrays(data[590:592], 1, TM.COSINE)
    assert list(ids[:, 0]) == [590, 591]
    assert idx._capacity % 3 == 0


@pytest.mark.parametrize("shards", [8, 3])
def test_quantized_profile_on_mesh(shards):
    j, p, data, rng = build_pair(shards, n=400, d=24, device_dtype="int8")
    single = FlatIndex(24, device_dtype="int8", device="cpu")
    single.add_batch_arrays(list(range(0, 7 * 400, 7)), data)
    q = rng.normal(size=(5, 24))
    for metric in METRICS:
        got = p.search_batch_arrays(q, 4, TM[metric])
        # both re-score the winners in exact f64
        same_arrays(j.search_batch_arrays(q, 4, JM[metric]), got, rtol=1e-9, atol=1e-12)
        same_arrays(single.search_batch_arrays(q, 4, TM[metric]), got, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("metric", ["COSINE", "MANHATTAN"])
def test_pq_profile_on_mesh(metric, monkeypatch):
    """The sharded ADC scan returns what the JAX mesh's does, with the
    JAX codebooks carried across; appends ride the sharded writes and
    deletes the sharded mask."""
    from vectorlite_tpu_torch.kernels import pq as tpq

    monkeypatch.setenv("VECTORLITE_PQ_MIN_ROWS", "1024")
    monkeypatch.setenv("VECTORLITE_PQ_TRAIN_SAMPLE", "1024")
    monkeypatch.setenv("VECTORLITE_HOST_SCAN_ROWS", "0")
    rng = np.random.default_rng(5)
    n, d, k = 2048, 32, 5
    data = rng.normal(size=(n, d))
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    j = JFlat(d, mesh=jmesh(8), device_dtype="pq")
    j.add_batch_arrays(list(range(n)), data)
    j.search_batch_arrays(data[:8], 1, JM.COSINE)
    monkeypatch.setattr(
        tpq, "train_codebooks",
        lambda *a, **kw: tpq.codebooks_from_reference(np.asarray(j._dev_codebooks), device="cpu"),
    )
    p = FlatIndex(d, mesh=tmesh(8), device_dtype="pq")
    p.add_batch_arrays(list(range(n)), data)
    q = data[rng.integers(0, n, 3)] + 0.01 * rng.normal(size=(3, d))
    got = p.search_batch_arrays(q, k, TM[metric])
    assert p._pq_active and len(p._dev_codes) == 8
    same_arrays(j.search_batch_arrays(q, k, JM[metric]), got, rtol=1e-9, atol=1e-12)
    fresh = rng.normal(size=(4, d))
    fresh /= np.linalg.norm(fresh, axis=1, keepdims=True)
    for idx in (j, p):
        idx.add_batch_arrays([9000, 9001, 9002, 9003], fresh)
    same_arrays(j.search_batch_arrays(fresh, 1, JM.COSINE),
                p.search_batch_arrays(fresh, 1, TM.COSINE), rtol=1e-9, atol=1e-12)
    ids, sc = p.search_batch_arrays(fresh[2:3], 1, TM.COSINE)
    assert ids[0, 0] == 9002 and sc[0, 0] == pytest.approx(1.0)
    p.delete(9002)
    assert p.search_batch_arrays(fresh[2:3], 1, TM.COSINE)[0][0, 0] != 9002


def test_compaction_on_mesh():
    rng = np.random.default_rng(6)
    d = 8
    idx = FlatIndex(d, mesh=tmesh(8))
    data = rng.normal(size=(2000, d))
    idx.add_batch_arrays(list(range(2000)), data)
    idx.search_batch_arrays(data[:1], 1, TM.COSINE)
    for i in range(0, 2000, 2):
        idx.delete(i)
    ids, _ = idx.search_batch_arrays(data[1001:1002], 1, TM.EUCLIDEAN)
    assert ids[0, 0] == 1001 and len(idx) == 1000


def test_vlc_round_trip_keeps_the_mesh(tmp_path):
    from vectorlite_tpu_torch.persist.vlc import (
        load_collection_from_file,
        save_collection_to_file,
    )
    from vectorlite_tpu_torch.store.collection import Collection

    rng = np.random.default_rng(7)
    d = 12
    data = rng.normal(size=(50, d))
    mesh = tmesh(8)
    idx = FlatIndex(d, mesh=mesh)
    idx.add_batch_arrays(list(range(50)), data)
    save_collection_to_file(Collection("m", idx), tmp_path / "m.vlc")
    loaded = load_collection_from_file(tmp_path / "m.vlc", mesh=mesh)
    with loaded.index_read() as li:
        assert li._mesh is mesh
        assert li.search(list(map(float, data[3])), 1, TM.COSINE)[0].id == 3


# ------------------------------------------------------------- HNSW mesh


def hnsw_pair(seed, mesh_n, n=512, d=32):
    from vectorlite_tpu.core.types import Vector as JVector
    from vectorlite_tpu.index.hnsw import HNSWIndex as JH
    from vectorlite_tpu_torch.index.hnsw import HNSWIndex as TH

    data = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    j = JH(d, JM.COSINE, mesh=None if mesh_n is None else jmesh(mesh_n), native=False, seed=7)
    p = TH(d, TM.COSINE, mesh=None if mesh_n is None else tmesh(mesh_n),
           native=False, seed=7, device="cpu")
    j.add_batch([JVector(id=i, values=[float(x) for x in data[i]], text="") for i in range(n)])
    p.add_batch([Vector(id=i, values=[float(x) for x in data[i]], text="") for i in range(n)])
    return j, p, data


@pytest.fixture(scope="module")
def hnsw8():
    return hnsw_pair(123, 8)


def test_mesh_beam_matches_jax_and_one_device(hnsw8):
    j, p, data = hnsw8
    _, single, _ = hnsw_pair(123, None)
    q = [list(map(float, data[i] + 1e-3)) for i in range(16)]
    res_j = j.search_batch(q, 5, JM.COSINE, ef=32, use_device=True)
    res_p = p.search_batch(q, 5, TM.COSINE, ef=32, use_device=True)
    res_1 = single.search_batch(q, 5, TM.COSINE, ef=32, use_device=True)
    for rj, rp, r1 in zip(res_j, res_p, res_1):
        assert [r.id for r in rp] == [r.id for r in rj] == [r.id for r in r1]
        np.testing.assert_allclose([r.score for r in rp], [r.score for r in rj], rtol=1e-6)
        assert [r.score for r in rp] == [r.score for r in r1]


def test_mesh_beam_search_function_matches_jax(hnsw8):
    from vectorlite_tpu.dist import hnsw_mesh as jhm
    from vectorlite_tpu_torch.dist import hnsw_mesh as thm

    j, p, data = hnsw8
    vecs, sq, adj = (np.array(a) for a in (p._vecs, p._sqnorms, p._adj[0]))
    q = data[:16] + 1e-3
    entries = np.full(16, p._entry, np.int32)
    jm = jmesh(8)
    ji, jd = jhm.mesh_beam_search(
        jm, *jhm.replicate_graph(jm, jnp.asarray(vecs), jnp.asarray(sq), jnp.asarray(adj)),
        entries, q, metric=JM.COSINE, ef=16, max_iters=96,
    )
    tm = tmesh(8)
    ti, td = thm.mesh_beam_search(
        tm, *thm.replicate_graph(tm, t(vecs), t(sq), t(adj)), entries, q,
        metric=TM.COSINE, ef=16, max_iters=96,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        thm.mesh_beam_search(tm, *thm.replicate_graph(tm, t(vecs), t(sq), t(adj)),
                             entries[:4], q[:4], metric=TM.COSINE, ef=16, max_iters=8)


def test_non_pow2_mesh_batch_padding():
    _, p, data = hnsw_pair(0, 3, n=256)
    q = [list(map(float, data[i] + 1e-3)) for i in range(4)]
    res = p.search_batch(q, 5, TM.COSINE, ef=32, use_device=True)
    assert len(res) == 4 and all(len(r) == 5 for r in res)
    assert [r[0].id for r in res] == [0, 1, 2, 3]


def test_mesh_beam_recall_and_small_batch(hnsw8):
    _, p, data = hnsw8
    b, k = 8, 5
    q = data[:b] + 1e-3
    sims = (q @ data.T) / (np.linalg.norm(q, axis=1, keepdims=True)
                           * np.linalg.norm(data, axis=1)[None, :])
    truth = np.argsort(-sims, axis=1)[:, :k]
    res = p.search_batch([list(map(float, r)) for r in q], k, TM.COSINE, ef=64,
                         use_device=True)
    recall = np.mean([len({r.id for r in row} & set(truth[i])) / k
                      for i, row in enumerate(res)])
    assert recall >= 0.9, recall
    one = p.search_batch([list(map(float, data[3] + 1e-3))], 3, TM.COSINE, ef=32,
                         use_device=True)
    assert one[0][0].id == 3


def test_mesh_graph_follows_mutations(hnsw8):
    """Appends and deletes after a device search reach every replica."""
    _, p, data = hnsw_pair(9, 4, n=256)
    q = [list(map(float, data[i] + 1e-3)) for i in range(4)]
    p.search_batch(q, 3, TM.COSINE, ef=32, use_device=True)
    new = np.random.default_rng(10).normal(size=(1, 32)).astype(np.float32)
    new /= np.linalg.norm(new)
    p.add(Vector(id=10**6, values=[float(x) for x in new[0]], text=""))
    p.delete(2)
    res = p.search_batch([list(map(float, new[0]))] + q[:3], 3, TM.COSINE, ef=32,
                         use_device=True)
    assert res[0][0].id == 10**6
    assert all(h.id != 2 for row in res for h in row)
