"""The port's scan wrappers (plain versions on CPU) against the JAX
Pallas kernels in interpret mode, on the same seeded numpy inputs.

Scores agree within rtol/atol 1e-5 (f32 sums taken in another order);
row ids agree exactly, ties included."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vectorlite_tpu.core.metrics import SimilarityMetric as JMetric
from vectorlite_tpu.core.metrics import quantize_rows_int8 as jquantize
from vectorlite_tpu.kernels import pallas_scan as jscan
from vectorlite_tpu.kernels.pallas_l1 import pallas_search_topk_l1 as jl1
from vectorlite_tpu.kernels.topk import search_topk as jsearch_topk
from vectorlite_tpu_torch.core.metrics import SimilarityMetric, quantize_rows_int8
from vectorlite_tpu_torch.kernels import scan

METRICS = ["COSINE", "EUCLIDEAN", "DOT_PRODUCT"]


def corpus(rng, n, d, invalid_frac=0.0, scale=1.0):
    values = (rng.normal(size=(n, d)) * scale).astype(np.float32)
    valid = rng.random(n) >= invalid_frac
    return values, valid


def both(values, valid, dtype="f32"):
    """(jax operands, torch operands): rows, sqnorms, valid."""
    sq = np.einsum("nd,nd->n", values, values).astype(np.float32)
    jv = jnp.asarray(values)
    tv = torch.from_numpy(values)
    if dtype == "bf16":
        jv = jv.astype(jnp.bfloat16)
        tv = tv.to(torch.bfloat16)
    return (
        (jv, jnp.asarray(sq), jnp.asarray(valid)),
        (tv, torch.from_numpy(sq), torch.from_numpy(valid)),
    )


def check(jout, tout, rtol=1e-5):
    js, ji = (np.asarray(x) for x in jout)
    ts, ti = (x.numpy() for x in tout)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_exact_matches_pallas(metric, dtype, rng):
    n, d, b, k = 2048, 64, 8, 10
    values, valid = corpus(rng, n, d, invalid_frac=0.1)
    q = rng.normal(size=(b, d)).astype(np.float32)
    (jv, jsq, jvalid), (tv, tsq, tvalid) = both(values, valid, dtype)
    jout = jscan.pallas_search_topk(
        jv, jsq, jvalid, jnp.asarray(q),
        metric=JMetric[metric], k=k, tile_n=512, interpret=True,
    )
    tout = scan.pallas_search_topk(
        tv, tsq, tvalid, torch.from_numpy(q),
        metric=SimilarityMetric[metric], k=k, tile_n=512,
    )
    check(jout, tout)


def test_tie_break_lowest_row(rng):
    n, d, b, k = 1024, 64, 8, 4
    base = rng.normal(size=(1, d)).astype(np.float32)
    data = rng.normal(size=(n, d)).astype(np.float32) * 10
    for row in (7, 300, 900):
        data[row] = base
    (jv, jsq, jvalid), (tv, tsq, tvalid) = both(data, np.ones(n, bool))
    q = np.repeat(base, b, axis=0)
    jout = jscan.pallas_search_topk(
        jv, jsq, jvalid, jnp.asarray(q),
        metric=JMetric.COSINE, k=k, tile_n=256, interpret=True,
    )
    tout = scan.pallas_search_topk(
        tv, tsq, tvalid, torch.from_numpy(q),
        metric=SimilarityMetric.COSINE, k=k, tile_n=256,
    )
    assert list(tout[1][0][:3].numpy()) == [7, 300, 900]
    check(jout, tout)


def test_k_larger_than_tile(rng):
    n, d, b, k = 512, 32, 8, 96
    values, valid = corpus(rng, n, d)
    q = rng.normal(size=(b, d)).astype(np.float32)
    (jv, jsq, jvalid), (tv, tsq, tvalid) = both(values, valid)
    jout = jscan.pallas_search_topk(
        jv, jsq, jvalid, jnp.asarray(q),
        metric=JMetric.DOT_PRODUCT, k=k, tile_n=128, interpret=True,
    )
    tout = scan.pallas_search_topk(
        tv, tsq, tvalid, torch.from_numpy(q),
        metric=SimilarityMetric.DOT_PRODUCT, k=k, tile_n=128,
    )
    check(jout, tout)


@pytest.mark.parametrize("metric", METRICS)
def test_k_beyond_shared_lists(metric, rng):
    """k_tile above 256 (the kernel keeps such lists in its output rows):
    the exact wrapper still serves it, equal to the full-score top-k."""
    n, d, b, k = 2048, 32, 4, 300
    values, valid = corpus(rng, n, d, invalid_frac=0.1)
    q = rng.normal(size=(b, d)).astype(np.float32)
    (jv, jsq, jvalid), (tv, tsq, tvalid) = both(values, valid)
    jout = jsearch_topk(
        jv, jsq, jvalid, jnp.asarray(q), metric=JMetric[metric], k=k
    )
    tout = scan.pallas_search_topk(
        tv, tsq, tvalid, torch.from_numpy(q),
        metric=SimilarityMetric[metric], k=k, tile_n=512,
    )
    check(jout, tout)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_l1_matches_pallas(dtype, rng):
    n, d, b, k = 2048, 64, 8, 10
    values, valid = corpus(rng, n, d, invalid_frac=0.1)
    q = rng.normal(size=(b, d)).astype(np.float32)
    (jv, _, jvalid), (tv, _, tvalid) = both(values, valid, dtype)
    jout = jl1(jv, jvalid, jnp.asarray(q), k=k, tile_n=512, interpret=True)
    tout = scan.pallas_search_topk_l1(
        tv, tvalid, torch.from_numpy(q), k=k, tile_n=512
    )
    check(jout, tout)


def test_l1_tie_break_and_large_k(rng):
    """Equal rows come back lowest row first; k above the tile and above
    the shared-list bound keeps the reference's order."""
    n, d, b = 1024, 16, 4
    values, valid = corpus(rng, n, d)
    for row in (5, 600, 1000):
        values[row] = values[0] + 0.01
    q = np.repeat(values[:1] + 0.01, b, axis=0)
    (jv, jsq, jvalid), (tv, _, tvalid) = both(values, valid)
    jq = jnp.asarray(q)
    refs = {
        4: jl1(jv, jvalid, jq, k=4, tile_n=256, interpret=True),
        300: jsearch_topk(jv, jsq, jvalid, jq, metric=JMetric.MANHATTAN, k=300),
    }
    for k, jout in refs.items():
        tout = scan.pallas_search_topk_l1(
            tv, tvalid, torch.from_numpy(q), k=k, tile_n=256 if k == 4 else 512
        )
        assert list(tout[1][0][:3].numpy()) == [5, 600, 1000]
        check(jout, tout)


def test_manhattan_has_one_route(rng):
    """Manhattan is K4's alone: the dot-form wrappers refuse it, and K4
    takes no int8 rows."""
    values, valid = corpus(rng, 512, 32)
    tv, tvalid = torch.from_numpy(values), torch.from_numpy(valid)
    tq = torch.from_numpy(rng.normal(size=(2, 32)).astype(np.float32))
    sq = torch.sum(tv * tv, dim=-1)
    with pytest.raises(ValueError):
        scan.pallas_search_topk(
            tv, sq, tvalid, tq, metric=SimilarityMetric.MANHATTAN, k=4,
            tile_n=256,
        )
    tq8, ts8 = quantize_rows_int8(tv)
    with pytest.raises(ValueError):
        scan.pallas_search_topk_int8(
            tq8, ts8, sq, tvalid, tq, metric=SimilarityMetric.MANHATTAN, k=4,
            tile_n=256,
        )


def quantized(values):
    jq, js = jquantize(jnp.asarray(values))
    tq, ts = quantize_rows_int8(torch.from_numpy(values))
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    return (jq, js), (tq, ts)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_int8_matches_pallas(metric, rng):
    n, d, b, k = 1024, 128, 8, 10
    values, valid = corpus(rng, n, d, invalid_frac=0.05)
    q = rng.normal(size=(b, d)).astype(np.float32)
    (_, jsq, jvalid), (_, tsq, tvalid) = both(values, valid)
    (jq, js), (tq, ts) = quantized(values)
    jout = jscan.pallas_search_topk_int8(
        jq, js, jsq, jvalid, jnp.asarray(q),
        metric=JMetric[metric], k=k, tile_n=256, interpret=True,
    )
    tout = scan.pallas_search_topk_int8(
        tq, ts, tsq, tvalid, torch.from_numpy(q),
        metric=SimilarityMetric[metric], k=k, tile_n=256,
    )
    check(jout, tout)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_matches_pallas(metric, dtype, rng):
    n, d, b, k = 4096, 64, 8, 32
    values, valid = corpus(rng, n, d, invalid_frac=0.1)
    q = rng.normal(size=(b, d)).astype(np.float32)
    (jv, jsq, jvalid), (tv, tsq, tvalid) = both(values, valid, dtype)
    jout = jscan.pallas_search_block_topk(
        jv, jsq, jvalid, jnp.asarray(q),
        metric=JMetric[metric], k=k, tile_n=1024, interpret=True, winners=2,
    )
    tout = scan.pallas_search_block_topk(
        tv, tsq, tvalid, torch.from_numpy(q),
        metric=SimilarityMetric[metric], k=k, tile_n=1024, winners=2,
    )
    check(jout, tout)


@pytest.mark.parametrize("metric", METRICS)
def test_block_int8_matches_pallas(metric, rng):
    n, d, b, k = 4096, 64, 8, 32
    values, valid = corpus(rng, n, d, invalid_frac=0.1)
    q = rng.normal(size=(b, d)).astype(np.float32)
    (_, jsq, jvalid), (_, tsq, tvalid) = both(values, valid)
    (jq, js), (tq, ts) = quantized(values)
    jout = jscan.pallas_search_block_topk_int8(
        jq, js, jsq, jvalid, jnp.asarray(q),
        metric=JMetric[metric], k=k, tile_n=1024, interpret=True, winners=2,
    )
    tout = scan.pallas_search_block_topk_int8(
        tq, ts, tsq, tvalid, torch.from_numpy(q),
        metric=SimilarityMetric[metric], k=k, tile_n=1024, winners=2,
    )
    check(jout, tout)


@pytest.mark.parametrize("metric", METRICS)
def test_rescored_matches_pallas(metric, rng):
    n, d, b, k, k_sel = 4096, 64, 8, 10, 32
    values, valid = corpus(rng, n, d, invalid_frac=0.1)
    q = rng.normal(size=(b, d)).astype(np.float32)
    (jv, jsq, jvalid), (tv, tsq, tvalid) = both(values, valid)
    jout = jscan.pallas_search_block_topk_rescored(
        jv, jv, jsq, jvalid, jnp.asarray(q),
        metric=JMetric[metric], k=k, k_sel=k_sel, tile_n=1024,
        interpret=True, winners=2,
    )
    tout = scan.pallas_search_block_topk_rescored(
        tv, tv, tsq, tvalid, torch.from_numpy(q),
        metric=SimilarityMetric[metric], k=k, k_sel=k_sel, tile_n=1024,
        winners=2,
    )
    check(jout, tout)


def test_int8_scan_copy_selects_with_real_scales(rng):
    """An int8 scan copy must rank on dot * scale. The reference's
    pallas_search_block_topk puts the squared norms in the scale slot
    (pallas_scan.py:317), ranking on dot * |v|^2 instead: the port's
    selection equals pallas_search_block_topk_int8's, not that one's."""
    n, d, b, k = 1024, 64, 4, 16
    values, valid = corpus(rng, n, d)
    values *= rng.uniform(0.1, 10.0, size=(n, 1)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    (_, jsq, jvalid), (tv, tsq, tvalid) = both(values, valid)
    (jq, js), (tq, ts) = quantized(values)
    kw = dict(metric=JMetric.DOT_PRODUCT, k=k, tile_n=256, interpret=True,
              winners=2)
    right = jscan.pallas_search_block_topk_int8(
        jq, js, jsq, jvalid, jnp.asarray(q), **kw
    )
    wrong = jscan.pallas_search_block_topk(jq, jsq, jvalid, jnp.asarray(q), **kw)
    port = scan.pallas_search_block_topk_int8(
        tq, ts, tsq, tvalid, torch.from_numpy(q),
        metric=SimilarityMetric.DOT_PRODUCT, k=k, tile_n=256, winners=2,
    )
    check(right, port)
    assert not np.array_equal(np.asarray(wrong[1]), port[1].numpy())
    with pytest.raises(TypeError):
        scan.pallas_search_block_topk(
            tq, tsq, tvalid, torch.from_numpy(q),
            metric=SimilarityMetric.DOT_PRODUCT, k=k, tile_n=256,
        )
    # the speed path's selection over an int8 copy is the int8 one
    pool = scan.pallas_search_block_topk_rescored(
        tq, tv, tsq, tvalid, torch.from_numpy(q),
        metric=SimilarityMetric.DOT_PRODUCT, k=k, k_sel=k, tile_n=256,
        scan_scales=ts,
    )
    assert np.array_equal(
        np.sort(pool[1].numpy(), axis=1), np.sort(port[1].numpy(), axis=1)
    )


def test_all_invalid_is_neg_inf(rng):
    values, _ = corpus(rng, 512, 32)
    sq = torch.from_numpy(np.einsum("nd,nd->n", values, values))
    s, _ = scan.pallas_search_topk(
        torch.from_numpy(values), sq, torch.zeros(512, dtype=torch.bool),
        torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32)),
        metric=SimilarityMetric.COSINE, k=4, tile_n=256,
    )
    assert torch.all(s == float("-inf"))


def test_cuda_wrapper_needs_the_card():
    """Off the CPU a wrapper launches its kernel or raises: there is no
    silent plain path for a device tensor."""
    values = torch.zeros((256, 32), device="meta")
    with pytest.raises(ValueError):
        scan.pallas_search_topk(
            values, torch.zeros(256, device="meta"),
            torch.ones(256, dtype=torch.bool, device="meta"),
            torch.zeros((2, 32), device="meta"),
            metric=SimilarityMetric.COSINE, k=4, tile_n=256,
        )
