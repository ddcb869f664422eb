"""The port's tournament-merge engine (K7's plain twin on the CPU) against
the JAX Pallas kernel in interpret mode, on the same seeded numpy inputs.

Scores agree within rtol/atol 1e-5 (f32 sums taken in another order); row
ids agree exactly, forced ties inside and across lane groups and lane
groups with fewer than W live rows included."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vectorlite_tpu.core.metrics import SimilarityMetric as JMetric
from vectorlite_tpu.kernels import pallas_merge as jmerge
from vectorlite_tpu_torch.core.metrics import SimilarityMetric, quantize_rows_int8
from vectorlite_tpu_torch.kernels import merge
from vectorlite_tpu_torch.kernels.topk import stable_topk

METRICS = ["COSINE", "EUCLIDEAN", "DOT_PRODUCT"]
N, D, B, TILE = 2048, 64, 8, 512
SHORT_GROUP = 5  # lane group left with one live row
TIED_GROUP = 9  # lane group holding three copies of the query centre


def inputs(rng, dtype="f32", invalid_frac=0.1):
    """Queries near a common centre; rows N(0, 1) with the centre copied
    into rows 9, 9 + 128, 9 + 3*128 (a tie inside lane group 9, best for
    every query) and 40, 77 (a tie across lane groups); 10% of rows
    invalid, and lane group 5 down to one live row. Returns the numpy
    arrays and (jax operands, torch operands)."""
    centre = rng.normal(size=D).astype(np.float32)
    values = rng.normal(size=(N, D)).astype(np.float32)
    for row in (TIED_GROUP, TIED_GROUP + 128, TIED_GROUP + 3 * 128, 40, 77):
        values[row] = centre
    q = (centre + 0.1 * rng.normal(size=(B, D))).astype(np.float32)
    valid = rng.random(N) >= invalid_frac
    valid[[TIED_GROUP, TIED_GROUP + 128, TIED_GROUP + 3 * 128, 40, 77]] = True
    valid[SHORT_GROUP::128] = False
    valid[SHORT_GROUP + 128 * 7] = True
    sq = np.einsum("nd,nd->n", values, values).astype(np.float32)
    jv, tv = jnp.asarray(values), torch.from_numpy(values)
    if dtype == "bf16":
        jv, tv = jv.astype(jnp.bfloat16), tv.to(torch.bfloat16)
    jops = (jv, jnp.asarray(sq), jnp.asarray(valid), jnp.asarray(q))
    tops = (tv, torch.from_numpy(sq), torch.from_numpy(valid), torch.from_numpy(q))
    return (values, valid, q), jops, tops


def check(jout, tout, rtol=1e-5):
    js, ji = (np.asarray(x) for x in jout)
    ts, ti = (x.numpy() for x in tout)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("winners", [1, 2, 3])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_merge_matches_pallas(dtype, metric, winners, rng):
    """The whole W*128 pool and the top 10, against the reference."""
    _, jops, tops = inputs(rng, dtype)
    for k in (10, winners * merge.LANES):
        jout = jmerge.pallas_search_merge_topk(
            *jops, metric=JMetric[metric], k=k, tile_n=TILE, winners=winners,
            interpret=True,
        )
        tout = merge.pallas_search_merge_topk(
            *tops, metric=SimilarityMetric[metric], k=k, tile_n=TILE,
            winners=winners,
        )
        check(jout, tout)
    # the tie inside lane group 9 keeps its lowest rows; the short lane
    # group's empty slots are (-inf, 0)
    s, i = merge.merge_topw_plain(
        *tops, metric=SimilarityMetric[metric], winners=winners
    )
    tied = [TIED_GROUP, TIED_GROUP + 128, TIED_GROUP + 3 * 128][:winners]
    assert torch.equal(i[:, :, TIED_GROUP], torch.tensor(tied)[:, None].int().expand(-1, B))
    assert torch.all(s[1:, :, SHORT_GROUP] == float("-inf"))
    assert torch.all(i[1:, :, SHORT_GROUP] == 0)
    assert torch.all(i[0, :, SHORT_GROUP] == SHORT_GROUP + 128 * 7)


@pytest.mark.parametrize("mode", ["tombstones", "live_hi", "live_hi_none"])
@pytest.mark.parametrize("metric", METRICS)
def test_merge_rescored_matches_pallas(metric, mode, rng):
    """Selection + exact f32 re-score from a bf16 scan copy: tombstones
    (validity decides) or a live prefix given by live_hi or counted."""
    (values, valid, q), _, _ = inputs(rng)
    if mode != "tombstones":
        valid = np.arange(N) < N - 300  # a live prefix
    sq = np.einsum("nd,nd->n", values, values).astype(np.float32)
    jv = jnp.asarray(values)
    tv = torch.from_numpy(values)
    kw = dict(k=10, k_sel=96, tile_n=TILE, winners=2,
              tombstones=mode == "tombstones")
    jlive = tlive = None
    if mode == "live_hi":
        jlive, tlive = jnp.asarray(np.int32(N - 300)), torch.tensor(N - 300)
    jout = jmerge.pallas_search_merge_topk_rescored(
        jv.astype(jnp.bfloat16), jv, jnp.asarray(sq), jnp.asarray(valid),
        jnp.asarray(q), metric=JMetric[metric], interpret=True, live_hi=jlive,
        **kw,
    )
    tout = merge.pallas_search_merge_topk_rescored(
        tv.to(torch.bfloat16), tv, torch.from_numpy(sq), torch.from_numpy(valid),
        torch.from_numpy(q), metric=SimilarityMetric[metric], live_hi=tlive,
        **kw,
    )
    check(jout, tout)
    assert np.all(valid[tout[1].numpy()])


@pytest.mark.parametrize("tile_n", [128, 512, 2048])
def test_tile_does_not_change_the_result(tile_n, rng):
    """A lane group is row mod 128 whatever the tile: the port's output is
    the same at every tile, and equal to the reference's at that tile."""
    _, jops, tops = inputs(rng, "bf16")
    kw = dict(metric=SimilarityMetric.COSINE, k=2 * merge.LANES, winners=2)
    tout = merge.pallas_search_merge_topk(*tops, tile_n=tile_n, **kw)
    base = merge.pallas_search_merge_topk(*tops, tile_n=TILE, **kw)
    assert torch.equal(tout[0], base[0]) and torch.equal(tout[1], base[1])
    jout = jmerge.pallas_search_merge_topk(
        *jops, metric=JMetric.COSINE, k=2 * merge.LANES, tile_n=tile_n,
        winners=2, interpret=True,
    )
    check(jout, tout)


def test_merge_keeps_the_lowest_rows_among_equal_scores(rng):
    """Rows 0 and 128 tie in lane group 0 and row 256 then beats both: the
    port keeps the lower tied row (row 0) with W = 2, as a stable sort of
    the lane group does. The reference's insertion network passes the
    displaced row 0 down only if it beats row 128 strictly, so it keeps
    row 128; the two agree on every score."""
    n, d, b = 512, 16, 2
    values = rng.normal(size=(n, d)).astype(np.float32) * 0.01
    q = np.ones((b, d), np.float32)
    values[0] = values[128] = 1.0
    values[256] = 2.0
    sq = np.einsum("nd,nd->n", values, values).astype(np.float32)
    valid = np.ones(n, bool)
    kw = dict(k=2 * merge.LANES, tile_n=128, winners=2)
    jout = jmerge.pallas_search_merge_topk(
        jnp.asarray(values), jnp.asarray(sq), jnp.asarray(valid), jnp.asarray(q),
        metric=JMetric.DOT_PRODUCT, interpret=True, **kw,
    )
    tout = merge.pallas_search_merge_topk(
        torch.from_numpy(values), torch.from_numpy(sq), torch.from_numpy(valid),
        torch.from_numpy(q), metric=SimilarityMetric.DOT_PRODUCT, **kw,
    )
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=1e-5)
    assert list(tout[1][0, :2].numpy()) == [256, 0]
    assert list(np.asarray(jout[1])[0, :2]) == [256, 128]
    # the port's pool is each lane group's stable top 2
    s = torch.from_numpy(q @ values.T).view(b, n // 128, 128).transpose(1, 2)
    _, j = stable_topk(s, 2)
    want = (torch.arange(128)[None, :, None] + 128 * j).permute(2, 0, 1)
    assert torch.equal(merge.merge_topw_plain(
        torch.from_numpy(values), torch.from_numpy(sq), torch.from_numpy(valid),
        torch.from_numpy(q), metric=SimilarityMetric.DOT_PRODUCT, winners=2,
    )[1], want.int())


def test_merge_refusals(rng):
    """Int8 rows (the reference would scale them by the squared norms),
    manhattan (no kernel in the reference either) and a bad tiling."""
    (values, valid, q), _, tops = inputs(rng)
    tv, tsq, tvalid, tq = tops
    kw = dict(metric=SimilarityMetric.COSINE, k=10)
    v8, _ = quantize_rows_int8(tv)
    with pytest.raises(TypeError):
        merge.pallas_search_merge_topk(v8, tsq, tvalid, tq, tile_n=TILE, **kw)
    with pytest.raises(TypeError):
        merge.pallas_search_merge_topk_rescored(
            v8, tv, tsq, tvalid, tq, tile_n=TILE, **kw)
    with pytest.raises(NotImplementedError):
        merge.pallas_search_merge_topk(
            tv, tsq, tvalid, tq, metric=SimilarityMetric.MANHATTAN, k=10,
            tile_n=TILE)
    for tile_n in (384 * 2, 4096, 100):  # not dividing N, above N, not x128
        with pytest.raises(ValueError):
            merge.pallas_search_merge_topk(tv, tsq, tvalid, tq, tile_n=tile_n, **kw)


def test_cuda_wrapper_needs_the_card_and_checks_winners(monkeypatch):
    """On a non-CPU tensor the engine launches K7 or raises; more than three
    rungs do not fit K7's shared memory."""
    meta = dict(device="meta")
    args = (torch.zeros((1024, 32), **meta), torch.zeros(1024, **meta),
            torch.ones(1024, dtype=torch.bool, **meta), torch.zeros((2, 32), **meta))
    with pytest.raises(ValueError, match="no kernel"):
        merge.pallas_search_merge_topk(
            *args, metric=SimilarityMetric.COSINE, k=4, tile_n=512)
    with pytest.raises(ValueError, match="winners"):
        merge.merge_topw_cuda(
            *args, metric=SimilarityMetric.COSINE, winners=4, tile_n=512)


def test_shared_header_enters_every_cuda_library_key(tmp_path, monkeypatch):
    """K7/K8 (lanes.cu) and K1-K4 (scan.cu) share scan_kernel.cuh: an
    edited header must key both libraries anew, and leave host code's."""
    from vectorlite_tpu_torch.kernels import _build

    for name in ("scan.cu", "lanes.cu"):
        assert '#include "scan_kernel.cuh"' in (_build.CSRC / name).read_text()
    for name in ("scan.cu", "lanes.cu", "host.cpp", "body.cuh"):
        (tmp_path / name).write_text(name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._target(n) for n in ("scan", "lanes", "host")}
    (tmp_path / "body.cuh").write_text("edited")
    after = {n: _build._target(n) for n in ("scan", "lanes", "host")}
    assert before["scan"] != after["scan"] and before["lanes"] != after["lanes"]
    assert before["host"] == after["host"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_merge_kernel_matches_plain_on_the_card(dtype, rng):
    if not torch.cuda.is_available():
        pytest.skip("K7 is CUDA C++ and runs only on an NVIDIA card")
    _, _, tops = inputs(rng, dtype)
    dev = torch.device("cuda")
    args = [t.to(dev) for t in tops]
    for metric in METRICS:
        for winners in (1, 2, 3):
            kw = dict(metric=SimilarityMetric[metric], winners=winners)
            got = merge.merge_topw_cuda(*args, tile_n=TILE, **kw)
            want = merge.merge_topw_plain(*args, **kw)
            assert torch.equal(got[1], want[1])
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
