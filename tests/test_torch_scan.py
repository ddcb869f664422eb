"""The port's scan wrappers (plain versions on CPU) against the JAX
Pallas kernels in interpret mode, on the same seeded numpy inputs.

Scores agree within rtol/atol 1e-5 (f32 sums taken in another order);
row ids agree exactly, ties included."""

import contextlib
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vectorlite_tpu.core.metrics import SimilarityMetric as JMetric
from vectorlite_tpu.core.metrics import quantize_rows_int8 as jquantize
from vectorlite_tpu.kernels import pallas_scan as jscan
from vectorlite_tpu.kernels.pallas_l1 import pallas_search_topk_l1 as jl1
from vectorlite_tpu.kernels.topk import search_topk as jsearch_topk
from vectorlite_tpu_torch.core.metrics import (
    SimilarityMetric,
    metric_from_dot,
    quantize_rows_int8,
)
from vectorlite_tpu_torch.kernels import scan, scan_mma

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


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_exact_wide_k_matches_pallas(dtype, rng):
    """k 100 (lists past 32, the wide mode's range on the card): the JAX
    K1 / K2 in interpret mode against the port, cosine, tile_n 512."""
    n, d, b, k = 2048, 64, 8, 100
    values, valid = corpus(rng, n, d, invalid_frac=0.1)
    q = rng.normal(size=(b, d)).astype(np.float32)
    (jv, jsq, jvalid), (tv, tsq, tvalid) = both(values, valid, "f32" if dtype == "int8" else dtype)
    kw = dict(k=k, tile_n=512)
    if dtype == "int8":
        (jq, js), (tq, ts) = quantized(values)
        jout = jscan.pallas_search_topk_int8(
            jq, js, jsq, jvalid, jnp.asarray(q), metric=JMetric.COSINE, interpret=True, **kw)
        tout = scan.pallas_search_topk_int8(
            tq, ts, tsq, tvalid, torch.from_numpy(q), metric=SimilarityMetric.COSINE, **kw)
    else:
        jout = jscan.pallas_search_topk(
            jv, jsq, jvalid, jnp.asarray(q), metric=JMetric.COSINE, interpret=True, **kw)
        tout = scan.pallas_search_topk(
            tv, tsq, tvalid, torch.from_numpy(q), metric=SimilarityMetric.COSINE, **kw)
    check(jout, tout)


@pytest.mark.parametrize("k", [300, 512, 1000, 2049, 4096])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_exact_deep_k_matches_pallas(dtype, k, rng):
    """k past 256 (the radix select's range on the card): the JAX K1 / K2 in
    interpret mode at tile_n 256 (each tile's top 256, merged) against the
    port at the same tile_n, which grows its own tile with k (exact_tile:
    the whole 8,192 rows here, one list of k). Cosine, 10% invalid rows;
    ids exact, scores within 1e-5. The reference unrolls one step a list
    entry, so tile_n 256 keeps each case near 7 s on one CPU core."""
    n, d, b = 8192, 64, 8
    values, valid = corpus(rng, n, d, invalid_frac=0.1)
    q = rng.normal(size=(b, d)).astype(np.float32)
    (jv, jsq, jvalid), (tv, tsq, tvalid) = both(values, valid, "f32" if dtype == "int8" else dtype)
    kw = dict(k=k, tile_n=256)
    assert scan.exact_tile(n, 256, k) == n
    if dtype == "int8":
        (jq, js), (tq, ts) = quantized(values)
        jout = jscan.pallas_search_topk_int8(
            jq, js, jsq, jvalid, jnp.asarray(q), metric=JMetric.COSINE, interpret=True, **kw)
        tout = scan.pallas_search_topk_int8(
            tq, ts, tsq, tvalid, torch.from_numpy(q), metric=SimilarityMetric.COSINE, **kw)
    else:
        jout = jscan.pallas_search_topk(
            jv, jsq, jvalid, jnp.asarray(q), metric=JMetric.COSINE, interpret=True, **kw)
        tout = scan.pallas_search_topk(
            tv, tsq, tvalid, torch.from_numpy(q), metric=SimilarityMetric.COSINE, **kw)
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


@pytest.mark.parametrize("k", [33, 100, 300])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_l1_select_k_matches_pallas(dtype, k, rng):
    """Manhattan past k 32 (the FADD stream's scores into the radix select
    on the card): the JAX K4 in interpret mode at tile_n 256 (each tile's
    top min(k, 256), merged) against the port at the same tile_n, which
    grows its tile past k 32 (exact_tile: all 4,096 rows here, one list of
    k). 10% invalid rows; rows 5, 600, 1000 and 3000 one row, the nearest
    to query 0 (ties to the lowest row); every 7th row a copy of row 3
    (ties across tiles). Ids exact, scores within 1e-5."""
    n, d, b = 4096, 40, 6
    values, valid = corpus(rng, n, d, invalid_frac=0.1)
    values[::7] = values[3]
    for row in (5, 600, 1000, 3000):
        values[row] = values[0] + 0.01
    valid[[5, 600, 1000, 3000]] = True
    q = rng.normal(size=(b, d)).astype(np.float32)
    q[0] = values[0] + 0.01
    (jv, _, jvalid), (tv, _, tvalid) = both(values, valid, dtype)
    assert scan.exact_tile(n, 256, k, SimilarityMetric.MANHATTAN) == n
    assert scan.exact_route(tv.dtype, k, SimilarityMetric.MANHATTAN, n).symbol == (
        "scan_topk_l1_select" + ("_bf16" if dtype == "bf16" else ""))
    jout = jl1(jv, jvalid, jnp.asarray(q), k=k, tile_n=256, interpret=True)
    tout = scan.pallas_search_topk_l1(tv, tvalid, torch.from_numpy(q), k=k, tile_n=256)
    assert list(tout[1][0][:4].numpy()) == [5, 600, 1000, 3000]
    check(jout, tout)


def test_l1_tie_break_and_large_k(rng):
    """Equal rows come back lowest row first; k above the tile (and past
    the FADD stream's lists) keeps the reference's order."""
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


# ------------------------------------- K3's int8 tensor-core form, host side


def int8_query_cases():
    """f32 queries for the int8 split: N(0, 1), zeros, a max|q| that is a
    power of two, magnitudes 1e30 and 1e-30, one large element among tiny
    ones."""
    rng = np.random.default_rng(5)
    normal = rng.normal(size=(7, 100)).astype(np.float32)
    pow2 = rng.uniform(-1.0, 1.0, (3, 64)).astype(np.float32)
    pow2[:, 5] = 2.0
    pow2[1, 9] = -4.0
    spike = (rng.normal(size=(2, 64)) * 1e-6).astype(np.float32)
    spike[:, 17] = 3.0
    return {
        "normal": normal,
        "zeros": np.zeros((3, 32), np.float32),
        "max-pow2": pow2,
        "1e30": (rng.normal(size=(2, 64)) * 1e30).astype(np.float32),
        "1e-30": (rng.normal(size=(2, 64)) * 1e-30).astype(np.float32),
        "one-large": spike,
    }


@pytest.mark.parametrize("case", list(int8_query_cases()))
def test_int8_query_split_is_within_its_bound(case):
    """Three int8 terms in [-127, 127] and a scale s1 = max|q| / 127 (f32;
    1 for a zero query): q - s1 (t1 + t2 / 254 + t3 / 254^2) is at most
    s1 / (2 254^2) an element (kernels/scan_mma.py, csrc/scan_mma.cuh)."""
    q = torch.from_numpy(int8_query_cases()[case])
    terms, s1 = scan_mma.split_query_int8(q)
    assert terms.dtype == torch.int8 and terms.shape == (3, *q.shape)
    assert s1.dtype == torch.float32 and s1.shape == (q.shape[0],)
    assert int(terms.to(torch.int32).abs().max()) <= 127
    amax = q.abs().amax(dim=1).double()
    want = torch.where(amax > 0, (amax / 127.0).float().double(), torch.ones_like(amax))
    assert torch.equal(s1.double(), want)
    s = s1.double()[:, None]
    back = s * (terms[0].double() + terms[1].double() / 254 + terms[2].double() / 254 ** 2)
    bound = s / (2 * 254 ** 2)
    assert torch.all((back - q.double()).abs() <= bound * (1 + 1e-9))
    if case == "zeros":
        assert not terms.any()
    if case == "one-large":  # the large element takes t1 = +-127, the tiny ones t1 = 0
        assert torch.equal(terms[0][:, 17].abs(), torch.full((2,), 127, dtype=torch.int8))
        assert not terms[0][:, :17].any()


@pytest.mark.parametrize("d", [64, 100, 384])
@pytest.mark.parametrize("b", [5, 64, 70])
def test_int8_query_operand_is_the_swizzled_terms(b, d, rng):
    """The int8 operand read as the kernel addresses it (block j's slice s
    term t at ((j S + s) 3 + t) x 8192 bytes, S = ceil(D / 128); in it
    query r's 16-byte chunk c at chunk c ^ (r mod 8) of its 128-byte row)
    gives back each term; every slot past B and D is zero; the scales are
    the split's."""
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    op, scales = scan_mma.query_operand_int8(q)
    nb, ns = -(-b // 64), -(-d // 128)
    assert op.dtype == torch.int8 and op.is_contiguous()
    assert op.shape == (nb, ns, 3, 64, 128)
    terms, s1 = scan_mma.split_query_int8(q)
    assert torch.equal(scales, s1)
    flat = op.reshape(-1)
    r = torch.arange(b)[:, None]
    col = torch.arange(d)[None, :]
    rr, kc = r % 64, col % 128
    for t in range(3):
        off = ((((r // 64) * ns + col // 128) * 3 + t) * 64 + rr) * 128 + \
            ((kc // 16) ^ (rr % 8)) * 16 + kc % 16
        assert torch.equal(flat[off], terms[t])
    assert int(torch.count_nonzero(op)) == int(torch.count_nonzero(terms))


def int8_tensor_core_dots(queries, rows8, row_scales):
    """The int8 form's contraction on the CPU: each term's exact integer
    dot (int64 matmul, what s32 wgmma accumulates), then the kernel's f32
    epilogue: (acc3 / 254^2 + acc2 / 254 + acc1) s1, times the row scale."""
    terms, s1 = scan_mma.split_query_int8(queries)
    acc = [(terms[t].to(torch.int64) @ rows8.to(torch.int64).T).to(torch.float32)
           for t in range(3)]
    x = (acc[2] * (1.0 / 64516.0) + acc[1] * (1.0 / 254.0)) + acc[0]
    return (x * s1[:, None]) * row_scales[None, :]


@pytest.mark.parametrize("d, b", [(64, 8), (100, 5), (384, 70)])
def test_int8_term_contraction_matches_tile_scores(d, b, rng):
    """The int8 form's dots (three exact term passes) against the plain
    version's f32 dots of the same int8 rows times their scales, within
    the raw-dot tolerance of chip_smoke.py (1e-5 x max(1, max |dot|))."""
    n = 512
    values = (rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, (n, 1))).astype(np.float32)
    rows8, scales = quantize_rows_int8(torch.from_numpy(values))
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    got = int8_tensor_core_dots(q, rows8, scales)
    want = scan.tile_scores(rows8, scales, torch.zeros(n), torch.ones(n, dtype=torch.bool),
                            q, SimilarityMetric.DOT_PRODUCT)
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("metric", METRICS)
def test_int8_emulated_selection_matches_pallas(metric, rng):
    """K3's selection over the int8 form's emulated scores (the metric and
    validity applied as the plain version does) against the JAX K3 int8 in
    interpret mode: ids equal except among scores within 1e-5, scores
    within rtol/atol 1e-5."""
    n, d, b, k, tile_n = 2048, 64, 8, 32, 512
    values, valid = corpus(rng, n, d, invalid_frac=0.1)
    q = rng.normal(size=(b, d)).astype(np.float32)
    (_, jsq, jvalid), (_, tsq, tvalid) = both(values, valid)
    (jq, js), (tq, ts) = quantized(values)
    jout = jscan.pallas_search_block_topk_int8(
        jq, js, jsq, jvalid, jnp.asarray(q),
        metric=JMetric[metric], k=k + 1, tile_n=tile_n, interpret=True, winners=2,
    )
    tq32 = torch.from_numpy(q)
    dot = int8_tensor_core_dots(tq32, tq, ts)
    qsq = torch.sum(tq32 * tq32, dim=-1, keepdim=True)
    s = torch.where(tvalid[None, :],
                    metric_from_dot(dot, qsq, tsq[None, :], SimilarityMetric[metric]),
                    float("-inf"))
    got = plain_topk(scan.block_topw_of_scores(s, tile_n=tile_n, winners=2), b, k)
    assert_topk_matches(got, tuple(torch.from_numpy(np.array(x)) for x in jout))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("winners", [1, 2, 3, 4])
def test_block_wrapper_routes_rows_by_dtype_and_winners(dtype, winners, monkeypatch):
    """block_topw_cuda picks K3's kernel from the rows' dtype and W before
    any launch: int8 rows to scan_block_topw_s8 (the int8 query operand and
    its scales, the row scales), bf16 rows to scan_block_topw_bf16 (the
    bf16 operand), f32 rows to scan_block_topw_tf32 (the two tf32 terms of
    query_operand_tf32), each up to MMA_MAX_WINNERS; larger W to the
    CUDA-core scan_block_topw (the transposed f32 queries, a dtype code).
    One launch, nothing reaches the plain version; a fake card lets the
    host side run here."""
    n, d, b, tile_n = 1024, 100, 5, 512
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    rows = torch.zeros((n, d), dtype=dt)
    scales = torch.ones(n) if dtype == "int8" else None
    launched = []
    kernels = (scan.SCAN_BLOCK_TOPW, scan.SCAN_BLOCK_TOPW_S8, scan.SCAN_BLOCK_TOPW_BF16,
               scan.SCAN_BLOCK_TOPW_TF32)
    for kern in kernels:
        monkeypatch.setattr(kern, "launch",
                            lambda *a, kern=kern: launched.append((kern.symbol, a)))
    monkeypatch.setattr(scan, "block_topw_plain", lambda *a, **k: launched.append("plain"))
    ops = []
    for name in ("query_operand", "query_operand_int8", "query_operand_tf32"):
        real = getattr(scan_mma, name)
        monkeypatch.setattr(scan_mma, name,
                            lambda q, real=real, name=name: ops.append((name, real(q))) or ops[-1][1])
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    s, i = scan.block_topw_cuda(rows, scales, torch.zeros(n), torch.ones(n, dtype=torch.bool),
                                torch.zeros((b, d)), metric=SimilarityMetric.EUCLIDEAN,
                                tile_n=tile_n, winners=winners)
    assert s.shape == i.shape == (b, n // tile_n, winners * 128)
    assert scan.MMA_MAX_WINNERS[torch.float32] == 3
    mma = winners <= scan.MMA_MAX_WINNERS[dt]
    want = {"int8": "scan_block_topw_s8", "bf16": "scan_block_topw_bf16",
            "f32": "scan_block_topw_tf32"}[dtype]
    want = want if mma else "scan_block_topw"
    assert [sym for sym, _ in launched] == [want]
    assert scan.block_route(dt, winners).symbol == want
    operand = {"scan_block_topw_s8": ["query_operand_int8"],
               "scan_block_topw_bf16": ["query_operand"],
               "scan_block_topw_tf32": ["query_operand_tf32"]}.get(want, [])
    assert [name for name, _ in ops] == operand
    args = launched[0][1]
    if want == "scan_block_topw_s8":
        assert all(isinstance(x, int) for x in args[:7])
        assert args[9:15] == (n, d, b, tile_n, winners, 1)
    elif want in ("scan_block_topw_bf16", "scan_block_topw_tf32"):
        assert all(isinstance(x, int) for x in args[:5])
        assert args[0] == ops[0][1].data_ptr() and args[2] == rows.data_ptr()
        assert args[7:13] == (n, d, b, tile_n, winners, 1)
        assert len(args) == 14
    else:
        assert args[3] == {"f32": 0, "bf16": 1, "int8": 2}[dtype]
        assert args[9:15] == (n, d, b, tile_n, winners, 1)


# ------------------------- K1/K2 on the tensor-core body's TOPK mode, host side


def tf32_query_cases():
    """f32 queries for the tf32 split: N(0, 1), zeros, exact tf32 values,
    magnitudes 1e30 and 1e-30, halfway cases for the rounding."""
    rng = np.random.default_rng(6)
    halfway = np.array([[1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11), 1.5 + 2.0 ** -11]],
                       dtype=np.float32)
    return {
        "normal": rng.normal(size=(7, 100)).astype(np.float32),
        "zeros": np.zeros((3, 32), np.float32),
        "tf32": np.array([[1.0, -0.5, 3.0, 2.0 ** -10]], dtype=np.float32),
        "1e30": (rng.normal(size=(2, 64)) * 1e30).astype(np.float32),
        "1e-30": (rng.normal(size=(2, 64)) * 1e-30).astype(np.float32),
        "halfway": halfway,
    }


@pytest.mark.parametrize("case", list(tf32_query_cases()))
def test_tf32_query_split_is_within_its_bound(case):
    """hi = rna(q) and lo = rna(q - hi) (csrc/scan_mma.cuh round_tf32): hi's
    and lo's low 13 bits are zero, q - hi is exact in f32, |q - hi| <=
    2^-11 |q| and |q - hi - lo| <= 2^-22 |q|; halfway cases round away
    from zero."""
    q = torch.from_numpy(tf32_query_cases()[case])
    terms = scan_mma.split_query_tf32(q)
    assert terms.dtype == torch.float32 and terms.shape == (2, *q.shape)
    hi, lo = terms
    for t in (hi, lo):
        assert not torch.any(t.view(torch.int32) & 0x1FFF)
    q64, hi64, lo64 = q.double(), hi.double(), lo.double()
    assert torch.equal((q - hi).double(), q64 - hi64)  # the f32 difference is exact
    assert torch.all((q64 - hi64).abs() <= 2.0 ** -11 * q64.abs())
    assert torch.all((q64 - hi64 - lo64).abs() <= 2.0 ** -22 * q64.abs())
    if case == "tf32":
        assert torch.equal(hi, q) and not lo.any()
    if case == "halfway":
        want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 4 * 2.0 ** -11), 1.5 + 2.0 ** -10])
        assert torch.equal(hi[0], want)


@pytest.mark.parametrize("d", [64, 100, 384])
@pytest.mark.parametrize("b", [5, 64, 70])
def test_tf32_query_operand_is_the_swizzled_terms(b, d, rng):
    """The tf32 operand read as the kernel addresses it (block j's slice s
    term t at ((j S + s) 2 + t) x 8192 bytes, S = ceil(D / 32); in it query
    r's 16-byte chunk c at chunk c ^ (r mod 8) of its 128-byte row) gives
    back each term; every slot past B and D is zero."""
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    op = scan_mma.query_operand_tf32(q)
    nb, ns = -(-b // 64), -(-d // 32)
    assert op.dtype == torch.float32 and op.is_contiguous()
    assert op.shape == (nb, ns, 2, 64, 32)
    terms = scan_mma.split_query_tf32(q)
    flat = op.reshape(-1)
    r = torch.arange(b)[:, None]
    col = torch.arange(d)[None, :]
    rr, kc = r % 64, col % 32
    for t in range(2):
        off = ((((r // 64) * ns + col // 32) * 2 + t) * 64 + rr) * 32 + \
            ((kc // 4) ^ (rr % 8)) * 4 + kc % 4
        assert torch.equal(flat[off], terms[t])
    assert int(torch.count_nonzero(op)) == int(torch.count_nonzero(terms))


def tf32_tensor_core_dots(queries, rows):
    """The tf32 form's contraction on the CPU: queries and rows split as
    the kernel splits them, hi.hi + hi.lo + lo.hi summed in float64 (the
    products of tf32 values are exact; the card's f32 sums add their own
    rounding, as the plain f32 product's do)."""
    qh, ql = (t.double() for t in scan_mma.split_query_tf32(queries))
    xh, xl = (t.double() for t in scan_mma.split_query_tf32(rows))
    return qh @ xh.T + qh @ xl.T + ql @ xh.T


@pytest.mark.parametrize("d", [384, 768])
def test_tf32_contraction_beats_the_plain_f32_product(d):
    """3xTF32 against float64 truth: its rms error stays below the plain
    f32 product's (1.47e-6 / 2.10e-6 against 4.9e-6 / 8.2e-6 at D 384 /
    768, N(0, 1) queries and rows), every dot within 3.01 u^2 sum |q||x| (u
    = 2^-11: the header's bound), and the dots agree with tile_scores within
    the raw-dot tolerance of chip_smoke.py (1e-5 x max(1, max |dot|))."""
    g = np.random.default_rng([7, d])
    q = torch.from_numpy(g.normal(size=(64, d)).astype(np.float32))
    x = torch.from_numpy(g.normal(size=(2048, d)).astype(np.float32))
    truth = q.double() @ x.double().T
    got = tf32_tensor_core_dots(q, x)
    n = x.shape[0]
    plain = scan.tile_scores(x, None, torch.zeros(n), torch.ones(n, dtype=torch.bool), q,
                             SimilarityMetric.DOT_PRODUCT).double()
    rms = lambda e: float(e.pow(2).mean().sqrt())  # noqa: E731
    assert rms(got - truth) < 0.5 * rms(plain - truth)
    bound = 3.01 * 2.0 ** -22 * (q.double().abs() @ x.double().abs().T)
    assert torch.all((got - truth).abs() <= bound)
    tol = 1e-5 * max(1.0, float(plain.abs().max()))
    assert float((got - plain).abs().max()) <= tol



def tf32_block_scores(values, sqnorms, valid, queries, metric):
    """K3 over f32 rows on 3xTF32 (csrc/lanes.cu scan_block_topw_tf32),
    emulated up to its selection: the contraction of tf32_tensor_core_dots
    (summed in float64), the kernel's epilogue (cosine by the norms'
    reciprocals, euclidean clamped), -inf where invalid, as f32 scores
    [B, N]."""
    dot = tf32_tensor_core_dots(queries, values)
    qsq = (queries.double() ** 2).sum(-1, keepdim=True)
    sq = sqnorms.double()[None, :]
    if metric is SimilarityMetric.COSINE:
        inv = lambda x: torch.where(x > 0, 1.0 / torch.sqrt(x), torch.zeros_like(x))  # noqa: E731
        s = dot * inv(qsq) * inv(sq)
    elif metric is SimilarityMetric.EUCLIDEAN:
        s = 1.0 / (1.0 + torch.sqrt(torch.clamp(qsq + sq - 2.0 * dot, min=0.0)))
    else:
        s = dot
    return torch.where(valid[None, :], s.float(), float("-inf"))


def tied_block_inputs(rng, shape):
    """(rows, valid, queries, tile_n). "tied": 2,048 x 64 rows, queries
    near a common centre copied into rows 9, 9 + 128, 9 + 384 (a tie in
    lane group 9, best for every query) and 40, 77 (a tie across lane
    groups), 10% invalid; "random": 4,096 x 384 N(0, 1) rows scaled into
    [0.5, 2], 5% invalid. Both leave lane group 5 of tile 0 one live row."""
    if shape == "tied":
        n, d, b, tile_n = 2048, 64, 8, 512
        centre = rng.normal(size=d).astype(np.float32)
        v = rng.normal(size=(n, d)).astype(np.float32)
        tied = [9, 9 + 128, 9 + 384, 40, 77]
        v[tied] = centre
        q = (centre + 0.1 * rng.normal(size=(b, d))).astype(np.float32)
        valid = rng.random(n) >= 0.1
        valid[tied] = True
    else:
        n, d, b, tile_n = 4096, 384, 8, 1024
        v = (rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, (n, 1))).astype(np.float32)
        q = rng.normal(size=(b, d)).astype(np.float32)
        valid = rng.random(n) >= 0.05
    valid[5:tile_n:128] = False
    valid[5 + 128 * 3] = True
    return v, valid, q, tile_n


@pytest.mark.parametrize("shape", ["tied", "random"])
@pytest.mark.parametrize("winners", [1, 2, 3])
@pytest.mark.parametrize("metric", METRICS)
def test_tf32_block_emulation_matches_pallas(metric, winners, shape, rng):
    """K3's 3xTF32 form (tf32_block_scores) through K3's selection
    (block_topw_of_scores): its lane lists hold the plain version's lists
    of W + 1 (assert_lane_lists_match: the same -inf pattern and empty
    slots, scores under the 1e-5 rule, raw dots within 1e-5 x max |dot| and
    held to float64 as on the card, ids equal beyond 1e-5 near-ties), and
    the top 32 of its pool holds the JAX K3 (_block_topw_kernel in
    interpret mode, top 33): scores within rtol/atol 1e-5, ids equal
    except among scores within 1e-5."""
    v, valid, q, tile_n = tied_block_inputs(rng, shape)
    b, k = q.shape[0], 32
    (jv, jsq, jvalid), (tv, tsq, tvalid) = both(v, valid)
    tq = torch.from_numpy(q)
    m = SimilarityMetric[metric]
    got = scan.block_topw_of_scores(tf32_block_scores(tv, tsq, tvalid, tq, m),
                                    tile_n=tile_n, winners=winners)
    want = scan.block_topw_plain(tv, None, tsq, tvalid, tq, metric=m, tile_n=tile_n,
                                 winners=winners + 1)
    exact = None
    if metric == "DOT_PRODUCT":
        exact = torch.where(tvalid[None, :], tq.double() @ tv.double().T, float("-inf"))
    assert_lane_lists_match(got, want, winners, raw_dots=metric == "DOT_PRODUCT",
                            exact=exact)
    jout = jscan.pallas_search_block_topk(
        jv, jsq, jvalid, jnp.asarray(q),
        metric=JMetric[metric], k=k + 1, tile_n=tile_n, interpret=True, winners=winners,
    )
    assert_topk_matches(plain_topk(got, b, k),
                        tuple(torch.from_numpy(np.array(x)) for x in jout))


def topk_mode_model(s, tile_n, k):
    """A Python model of the TOPK mode's selection over a [B, N] score
    matrix: per tile and query two lists, one a warpgroup (rows 0-63 and
    64-127 of each 128-row chunk); a list starts as the top k of its first
    chunk's 64 rows, then each half chunk's rows that precede its k-th
    entry enter in row order; at the tile's end each entry's place is its
    index plus the other list's entries that precede it. Order: (score
    descending, row ascending). Returns ([B, T, k] scores, int32 rows)."""
    b, n = s.shape
    n_tiles = n // tile_n
    out_s = np.empty((b, n_tiles, k), np.float32)
    out_i = np.empty((b, n_tiles, k), np.int32)
    key = lambda e: (-e[0], e[1])  # noqa: E731
    for q in range(b):
        for t in range(n_tiles):
            lists = []
            for wg in range(2):
                lst = None
                for c in range(tile_n // 128):
                    base = t * tile_n + c * 128 + wg * 64
                    rows = [(float(s[q, r]), r) for r in range(base, base + 64)]
                    if lst is None:
                        lst = sorted(rows, key=key)[:k]
                        continue
                    for half in (rows[:32], rows[32:]):
                        kth = key(lst[-1])
                        for e in [e for e in half if key(e) < kth]:
                            lst = sorted(lst + [e], key=key)[:k]
                lists.append(lst)
            merged = [None] * k
            for mine, other in (lists, lists[::-1]):
                for j, e in enumerate(mine):
                    place = j + sum(key(o) < key(e) for o in other)
                    if place < k:
                        merged[place] = e
            out_s[q, t] = [e[0] for e in merged]
            out_i[q, t] = [e[1] for e in merged]
    return out_s, out_i


@pytest.mark.parametrize("k", [1, 5, 16, 32])
def test_topk_mode_model_matches_tile_topk_plain(k):
    """The TOPK mode's selection (two half-chunk lists a query, merged at
    each tile's end) gives tile_topk_plain's ids exactly on integer-valued
    scores with many ties, an all-invalid tile and a tile invalid but for
    one row."""
    g = np.random.default_rng(k)
    b, n, tile_n = 3, 4 * 512, 512
    s = g.integers(-4, 5, size=(b, n)).astype(np.float32)
    s[:, 512:1024] = -np.inf  # tile 1: no valid row
    s[:, 1024:1536] = -np.inf
    s[:, 1100] = 2.0  # tile 2: one valid row
    got_s, got_i = topk_mode_model(s, tile_n, k)
    want_s, want_i = scan.stable_topk(torch.from_numpy(s).view(b, n // tile_n, tile_n), k)
    want_i = want_i + torch.arange(n // tile_n)[None, :, None] * tile_n
    assert np.array_equal(got_i, want_i.numpy())
    assert np.array_equal(got_s, want_s.numpy())


def tensor_core_entry(dtype, k, tile_n=2048):
    """The symbol of K1 / K2's entry for rows of ``dtype``, lists of ``k``
    and tiles of ``tile_n`` rows: the tensor-core body's TOPK mode to k 32
    (any tile), its wide mode to k 256 (tiles up to 32,768 rows), else its
    scores into the radix select."""
    mode = "exact" if k <= 32 else "wide" if k <= 256 and tile_n <= 32768 else "select"
    return f"scan_topk_{mode}_" + {"f32": "tf32", "bf16": "bf16", "int8": "s8"}[dtype]


#: the wide mode's empty slot: (-inf, WIDE_PLACE), after every row
WIDE_PLACE = 0xFFFF


def _precedes(s1, r1, s2, r2):
    return (s1 > s2) | ((s1 == s2) & (r1 < r2))


def _cx_steps(s, r, size, d):
    """The wide mode's compare-exchange steps d, d / 2, ..., 1 over runs of
    ``size`` (csrc/scan_mma.cuh cx_step): element e's partner is e ^ d; the
    lower element of a pair takes the better one in a run sorted descending
    ((e & size) == 0), the worse one in an ascending run."""
    e = np.arange(len(s))
    while d >= 1:
        p = e ^ d
        better = ((e & d) == 0) == ((e & size) == 0)
        take = _precedes(s[p], r[p], s, r) == better
        s, r = np.where(take, s[p], s), np.where(take, r[p], r)
        d //= 2
    return s, r


def _bitonic_sort(s, r):
    size = 2
    while size <= len(s):
        s, r = _cx_steps(s, r, size, size // 2)
        size *= 2
    return s, r


def _merge_batch(ls, lr, bs, br):
    """merge_batch: the batch sorted; list entry i takes the better of
    itself and batch entry len(ls) - 1 - i (empty slots past the batch);
    then a bitonic merge of the list."""
    kp = len(ls)
    bs, br = _bitonic_sort(bs, br)
    ps = np.full(kp, -np.inf, np.float32)
    pr = np.full(kp, WIDE_PLACE)
    ps[:len(bs)], pr[:len(br)] = bs, br
    take = _precedes(ps[::-1], pr[::-1], ls, lr)
    ls, lr = np.where(take, ps[::-1], ls), np.where(take, pr[::-1], lr)
    return _cx_steps(ls, lr, kp, kp // 2)


def wide_mode_model(s, tile_n, k, batches=None):
    """A NumPy model of the wide mode's selection over a [B, N] score
    matrix, network for network: per tile and query one list of 128 (k <=
    128) or 256 entries, empty slots (-inf, 0xFFFF); each 128-row chunk's
    rows that precede the k-th entry (none: the chunk is skipped), packed in
    row order into a batch of 32 or 64 (empty slots past them) or, past 64,
    all 128 rows; the batch sorted and merged into the list
    (_merge_batch). Order: (score descending, row ascending). Returns ([B,
    T, k] scores, int32 rows); ``batches`` counts the batch sizes."""
    b, n = s.shape
    n_tiles = n // tile_n
    kp = 128 if k <= 128 else 256
    out_s = np.empty((b, n_tiles, k), np.float32)
    out_i = np.empty((b, n_tiles, k), np.int32)
    for q in range(b):
        for t in range(n_tiles):
            ls = np.full(kp, -np.inf, np.float32)
            lr = np.full(kp, WIDE_PLACE)
            for c in range(tile_n // 128):
                cs = s[q, t * tile_n + c * 128:t * tile_n + (c + 1) * 128]
                cr = np.arange(c * 128, (c + 1) * 128)
                cand = _precedes(cs, cr, ls[k - 1], lr[k - 1])
                m = int(cand.sum())
                if m == 0:
                    continue
                if m > 64:
                    bs, br = cs, cr
                else:
                    size = 32 if m <= 32 else 64
                    bs = np.full(size, -np.inf, np.float32)
                    br = np.full(size, WIDE_PLACE)
                    bs[:m], br[:m] = cs[cand], cr[cand]
                if batches is not None:
                    batches[len(bs)] = batches.get(len(bs), 0) + 1
                ls, lr = _merge_batch(ls, lr, bs, br)
            out_s[q, t] = ls[:k]
            out_i[q, t] = lr[:k] + t * tile_n
    return out_s, out_i


@pytest.mark.parametrize("k, tile_n", [
    (33, 512), (64, 512), (100, 512), (128, 512), (256, 512), (33, 2048), (100, 2048),
    (128, 2048), (256, 2048), (128, 128), (256, 256),
])
def test_wide_mode_model_matches_tile_topk_plain(k, tile_n):
    """The wide mode's selection (a list a query, a batch a chunk merged by
    bitonic networks) gives tile_topk_plain's ids and scores exactly on
    integer-valued scores with many ties, an all-invalid tile, a tile
    invalid but for one row, a tile whose rows rise (every chunk's rows
    all enter) and one whose rows fall, and k up to tile_n; over 2,048-row
    tiles batches of 32, 64 and 128 all occur."""
    g = np.random.default_rng([k, tile_n])
    b, n = 3, 5 * tile_n
    s = g.integers(-4, 5, size=(b, n)).astype(np.float32)
    s[:, tile_n:3 * tile_n] = -np.inf  # tile 1: no valid row
    s[:, 2 * tile_n + 100] = 2.0  # tile 2: one valid row
    s[0, 3 * tile_n:4 * tile_n] = np.arange(tile_n) // 3  # rising, in ties of three
    s[1, 3 * tile_n:4 * tile_n] = -np.arange(tile_n) // 5  # falling, in ties of five
    s[2, 3 * tile_n:4 * tile_n] = g.normal(size=tile_n)
    batches = {}
    got_s, got_i = wide_mode_model(s, tile_n, k, batches)
    want_s, want_i = scan.stable_topk(torch.from_numpy(s).view(b, n // tile_n, tile_n), k)
    want_i = want_i + torch.arange(n // tile_n)[None, :, None] * tile_n
    assert np.array_equal(got_i, want_i.numpy())
    assert np.array_equal(got_s, want_s.numpy())
    if tile_n == 2048:
        assert set(batches) == {32, 64, 128}


# csrc/select.cu's radix select, step for step: the order-preserving keys,
# 8-bit digit passes that stop once a whole bin is taken, the survivors
# (ties at the threshold to the lowest rows), and the bitonic network over
# key << 32 | ~offset with the entries past n missing.
SELECT_THREADS = 1024


def select_keys(s):
    """key_of: larger score, larger uint32 key; -0 as +0, NaN as one NaN."""
    s = np.where(s == 0, np.float32(0), s).astype(np.float32)
    u = s.view(np.uint32).copy()
    u[np.isnan(s)] = 0x7FC00000
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def select_key_scores(keys):
    """score_of_key: the inverse of select_keys."""
    keys = keys.astype(np.uint32)
    u = np.where(keys & 0x80000000, keys & 0x7FFFFFFF, ~keys).astype(np.uint32)
    return u.view(np.float32)


def select_bitonic(v, n):
    """The kernel's bitonic network: larger values first, the entries past
    n of the power-of-two network missing (a comparison that reaches one
    is skipped); the flip, then the half-cleaners, for each size."""
    v = v.copy()
    full = 1 << max(0, n - 1).bit_length()
    p = np.arange(full // 2)
    size = 2
    while size <= full:
        stride = size // 2
        while stride:
            if stride == size // 2:
                blk, w = p // stride, p % stride
                i, l = blk * size + w, blk * size + size - 1 - w
            else:
                i = (p // stride) * 2 * stride + p % stride
                l = i + stride
            ok = l < n
            i, l = i[ok], l[ok]
            a, c = v[i], v[l]
            swap = a < c
            v[i[swap]], v[l[swap]] = c[swap], a[swap]
            stride //= 2
        size *= 2
    return v


def select_one(scores, k):
    """One block: a tile's scores -> its top k (scores, offsets in the
    tile) and the digit passes it took."""
    keys = select_keys(scores)
    t = len(keys)
    # warp w holds rows [w S, (w + 1) S), lane l rows w S + l + 32 j: the
    # (warp, j, lane) order the ranks are taken in is row order
    seg = -(-t // SELECT_THREADS) * 32
    order = np.array([w * seg + j * 32 + lane for w in range(32) for j in range(seg // 32)
                      for lane in range(32)])
    assert np.array_equal(order[order < t], np.arange(t))
    prefix, mask, need, passes = 0, 0, k, 0
    for shift in (24, 16, 8, 0):
        passes += 1
        match = (keys & mask) == prefix
        hist = np.bincount((keys[match] >> shift) & 0xFF, minlength=256)
        above, done = 0, False
        for b in range(255, -1, -1):
            if above < need <= above + hist[b]:
                prefix |= b << shift
                mask |= 0xFF << shift
                done = above + hist[b] == need
                need -= above
                break
            above += hist[b]
        if done:
            break
    masked = keys & np.uint32(mask)
    eq = masked == prefix
    take = (masked > prefix) | (eq & (np.cumsum(eq) - 1 < need))
    off = np.flatnonzero(take)
    assert len(off) == k
    v = (keys[off].astype(np.uint64) << np.uint64(32)) | (~off.astype(np.uint32)).astype(np.uint64)
    v = select_bitonic(v, k)
    return (select_key_scores((v >> np.uint64(32)).astype(np.uint32)),
            (~(v & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(np.int64), passes)


def select_model(s, tile_n, k):
    """[B, N] scores -> ([B, T, k] scores, int64 rows, passes a list)."""
    b, n = s.shape
    out_s = np.zeros((b, n // tile_n, k), np.float32)
    out_i = np.zeros((b, n // tile_n, k), np.int64)
    passes = []
    for q in range(b):
        for t in range(n // tile_n):
            sc, off, p = select_one(s[q, t * tile_n:(t + 1) * tile_n], k)
            out_s[q, t], out_i[q, t] = sc, off + t * tile_n
            passes.append(p)
    return out_s, out_i, passes


def test_select_keys_keep_the_order_of_scores(rng):
    """select_keys orders every float as a descending sort does: -inf
    lowest, -0 and +0 one key, +inf below NaN; score_of_key inverts it
    (but for -0, which comes back +0)."""
    x = np.concatenate([
        rng.normal(size=2000).astype(np.float32) * 10.0 ** rng.integers(-30, 30, 2000),
        np.array([-np.inf, np.inf, 0.0, -0.0, 1e-45, -1e-45, np.finfo(np.float32).max,
                  -np.finfo(np.float32).max], np.float32)]).astype(np.float32)
    keys = select_keys(x)
    order = np.argsort(x, kind="stable")
    assert np.all(np.diff(keys[order].astype(np.int64)) >= 0)
    assert np.array_equal(keys[x == 0], np.full((x == 0).sum(), keys[x == 0][0]))
    assert select_keys(np.array([np.nan], np.float32))[0] > select_keys(
        np.array([np.inf], np.float32))[0]
    back = select_key_scores(keys)
    assert np.array_equal(back, np.where(x == 0, np.float32(0), x))


def tie_heavy_rows(rng, n, invalid_frac, dead_tile=None, tile_n=None):
    """int8-valued f32 rows of 4 dimensions from {-1, 0, 1} (dot products
    with a query of ones take 9 values: ties everywhere), some invalid."""
    v = rng.integers(-1, 2, size=(n, 4)).astype(np.float32)
    valid = rng.random(n) >= invalid_frac
    if dead_tile is not None:
        valid[dead_tile * tile_n:(dead_tile + 1) * tile_n] = False
    return torch.from_numpy(v), torch.from_numpy(valid)


@pytest.mark.parametrize("k, tile_n", [
    (1, 128), (7, 128), (127, 128), (128, 128), (33, 1152), (300, 1152), (1151, 1152),
    (1152, 1152), (2049, 4096), (4095, 4096), (4096, 4096), (257, 512), (300, 2048),
    (512, 2048), (1024, 4096), (2048, 2048), (300, 16384), (1024, 32768), (2048, 32768),
])
def test_select_model_matches_tile_topk_plain(k, tile_n, rng):
    """The radix select (select_model, csrc/select.cu's steps) against
    tile_topk_plain on tie-heavy scores (9 values a query, every tie broken
    toward the lowest row), 10% invalid rows, an all-invalid tile, k_tile
    = tile_n and tile_n - 1, tiles not a multiple of 1,024 rows (a warp's
    last rows past the tile): scores and rows exactly equal. Manhattan's
    scores (1 / (1 + L1) in (0, 1], a handful of values a query: K4 past k
    32 selects them) and euclidean's are positive, the dot products of
    both signs."""
    n, b = 3 * tile_n, 3
    v, valid = tie_heavy_rows(rng, n, 0.1, dead_tile=1, tile_n=tile_n)
    q = torch.ones((b, 4))
    q[2] = torch.tensor([1.0, -2.0, 0.5, 0.0])
    sq = (v * v).sum(-1)
    for metric in (SimilarityMetric.DOT_PRODUCT, SimilarityMetric.EUCLIDEAN,
                   SimilarityMetric.MANHATTAN):
        want_s, want_i = scan.tile_topk_plain(v, None, sq, valid, q, metric=metric, k_tile=k,
                                              tile_n=tile_n)
        s = scan.tile_scores(v, None, sq, valid, q, metric).numpy()
        got_s, got_i, passes = select_model(s, tile_n, k)
        assert np.array_equal(got_i, want_i.numpy())
        assert np.array_equal(got_s, want_s.numpy())
        assert max(passes) == 4 if k < tile_n else min(passes) >= 1


def test_select_model_orders_signed_zeros_and_random_scores(rng):
    """Random scores (where a pass stops early once a bin resolves the
    rank) and scores of only -0, +0 and -inf: the model's lists equal
    stable_topk's (ties, -0 with +0, to the lowest row)."""
    tile_n, k = 2048, 700
    s = rng.normal(size=(2, 2 * tile_n)).astype(np.float32)
    z = rng.choice(np.array([0.0, -0.0, -np.inf], np.float32), size=(2, 2 * tile_n))
    for scores in (s, z):
        got_s, got_i, passes = select_model(scores, tile_n, k)
        want_s, want_i = scan.stable_topk(torch.from_numpy(scores).view(2, 2, tile_n), k)
        want_i = want_i + torch.arange(2)[None, :, None] * tile_n
        assert np.array_equal(got_i, want_i.numpy())
        assert np.array_equal(got_s, np.where(want_s.numpy() == 0, np.float32(0), want_s.numpy()))
    assert min(select_model(s, tile_n, 1)[2]) <= 3


@pytest.mark.parametrize("k, tile_n, want", [
    (256, 2048, 2048), (257, 2048, 32768), (300, 2048, 32768), (512, 2048, 32768),
    (1000, 2048, 32768), (1024, 2048, 32768), (2048, 2048, 32768), (2049, 2048, 32768),
    (512, 4096, 32768), (1024, 4096, 32768), (300, 65536, 65536),
])
def test_exact_tile_grows_with_k(k, tile_n, want, rng):
    """exact_tile at 2^20 rows: tile_n up to k 256; past it the largest
    multiple of tile_n dividing the rows, at most 32,768 (a tile past that
    stays as the caller gave it); manhattan (K4) grows the same way past
    k 32, and keeps the caller's tile up to it. At test size the grown
    tile gives _exact the same merged ids and scores as the caller's
    tile."""
    assert scan.exact_tile(1 << 20, tile_n, k) == want
    M = SimilarityMetric.MANHATTAN
    assert scan.exact_tile(1 << 20, tile_n, k, M) == (
        tile_n if tile_n > scan.SELECT_MAX_TILE else scan.SELECT_MAX_TILE)
    assert scan.exact_tile(1 << 20, tile_n, 32, M) == tile_n
    assert scan.exact_tile(1 << 20, 2048, 33, M) == scan.SELECT_MAX_TILE
    assert scan.exact_tile(3 * tile_n, tile_n, k) == (
        tile_n if k <= 256 or tile_n > scan.WIDE_MAX_TILE else 3 * tile_n)
    if k <= 256 or k > 2048 or tile_n > 4096:
        return
    n, d, b = 3 * 8192, 16, 4
    values, valid = corpus(rng, n, d, invalid_frac=0.1)
    values[::7] = values[3]  # ties across tiles: the lowest row first
    q = rng.normal(size=(b, d)).astype(np.float32)
    _, (tv, tsq, tvalid) = both(values, valid)
    tq = torch.from_numpy(q)
    grown = scan.exact_tile(n, tile_n, k)
    assert grown > tile_n
    for metric in METRICS:
        m = SimilarityMetric[metric]
        got = scan.pallas_search_topk(tv, tsq, tvalid, tq, metric=m, k=k, tile_n=tile_n)
        want_s, want_i = scan.merge_topk(*(x.reshape(b, -1) for x in scan.tile_topk_plain(
            tv, None, tsq, tvalid, tq, metric=m, k_tile=min(k, tile_n), tile_n=tile_n)), k)
        assert torch.equal(got[1], want_i)
        assert torch.equal(got[0], want_s)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("k", [1, 16, 32, 33, 128, 256, 257, 300, 512, 1024, 2048, 2049])
def test_exact_route(dtype, k):
    """exact_route: up to k 32 the tensor-core body's TOPK mode by the rows'
    dtype (f32: 3xTF32, bf16, int8: K2), up to k 256 its wide mode (on
    tiles of at most 32,768 rows), beyond it (and past 32,768-row tiles) its
    scores into the radix select (csrc/select.cu); no K1 / K2 case reaches
    the CUDA-core body. Manhattan
    (K4): up to k 32 the FADD stream's lists over f32 and bf16 rows (tiles
    of a multiple of 256 rows), beyond it (and for tiles of 384 rows) its
    scores into the radix select (scan_topk_l1_select / _bf16); over int8
    rows the route and the wrapper refuse it."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    want = tensor_core_entry(dtype, k)
    select = {"f32": scan.SCAN_TOPK_SELECT_TF32, "bf16": scan.SCAN_TOPK_SELECT_BF16,
              "int8": scan.SCAN_TOPK_SELECT_S8}[dtype]
    for metric in METRICS:
        assert scan.exact_route(dt, k, SimilarityMetric[metric]).symbol == want
        for tile_n in (2048, 32768, 65536):
            listed = k > 32 and tile_n > scan.WIDE_MAX_TILE
            got = scan.exact_route(dt, k, SimilarityMetric[metric], tile_n)
            assert got.symbol == (select.symbol if listed else want)
            assert (got is select) == (k > 256 or listed)
            assert got.library != "scan"
    MANHATTAN = SimilarityMetric.MANHATTAN
    if dtype != "int8":
        tail = "_bf16" if dtype == "bf16" else ""
        want_l1 = ("scan_topk_l1_fadd" if k <= 32 else "scan_topk_l1_select") + tail
        assert scan.exact_route(dt, k, MANHATTAN).symbol == want_l1
        for tile_n in (256, 2048, 65536):
            assert scan.exact_route(dt, k, MANHATTAN, tile_n).symbol == want_l1
        assert scan.exact_route(dt, k, MANHATTAN, 384).symbol == "scan_topk_l1_select" + tail
        assert scan.exact_route(dt, k, MANHATTAN).library == "l1"
    if dtype == "int8":
        with pytest.raises(ValueError, match="manhattan"):
            scan.exact_route(dt, k, MANHATTAN)
        rows, scales = quantize_rows_int8(torch.ones((512, 8)))
        with pytest.raises(ValueError, match="manhattan"):
            scan.tile_topk_cuda(rows, scales, torch.ones(512), torch.ones(512, dtype=torch.bool),
                                torch.ones((2, 8)), metric=MANHATTAN, k_tile=min(k, 256),
                                tile_n=256)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("k, tile_n", [
    (16, 512), (32, 512), (33, 512), (128, 512), (256, 512), (257, 512), (300, 512),
    (512, 512), (1024, 2048), (2048, 2048), (2049, 4096), (300, 65536),
])
def test_exact_wrapper_routes_rows_by_dtype_and_k(dtype, k, tile_n, monkeypatch):
    """tile_topk_cuda launches the kernel exact_route names, once, with its
    own operands: the tf32 / bf16 / int8 query operand (and the int8 term
    scales) on every route (the tensor-core body's two list modes, and past
    k 256 or tiles of 32,768 rows its scores into the radix select, which
    also takes a [B, group rows] f32 scratch and the group's rows). A fake
    card lets the host side run here."""
    n, b = 2 * tile_n, 5
    d = 100 if tile_n <= 4096 else 8
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    rows = torch.zeros((n, d), dtype=dt)
    scales = torch.ones(n) if dtype == "int8" else None
    launched = []
    kernels = (scan.SCAN_TOPK_EXACT_TF32, scan.SCAN_TOPK_EXACT_BF16, scan.SCAN_TOPK_EXACT_S8,
               scan.SCAN_TOPK_WIDE_TF32, scan.SCAN_TOPK_WIDE_BF16, scan.SCAN_TOPK_WIDE_S8,
               scan.SCAN_TOPK_SELECT_TF32, scan.SCAN_TOPK_SELECT_BF16, scan.SCAN_TOPK_SELECT_S8)
    for kern in kernels:
        monkeypatch.setattr(kern, "launch",
                            lambda *a, kern=kern: launched.append((kern.symbol, a)))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    ops = []
    for name in ("query_operand", "query_operand_tf32", "query_operand_int8"):
        real = getattr(scan_mma, name)
        monkeypatch.setattr(scan_mma, name,
                            lambda q, real=real, name=name: ops.append(name) or real(q))
    s, i = scan.tile_topk_cuda(rows, scales, torch.zeros(n), torch.ones(n, dtype=torch.bool),
                               torch.zeros((b, d)), metric=SimilarityMetric.EUCLIDEAN,
                               k_tile=k, tile_n=tile_n)
    assert s.shape == i.shape == (b, n // tile_n, k)
    want = scan.exact_route(dt, k, SimilarityMetric.EUCLIDEAN, tile_n)
    select = tile_n > scan.WIDE_MAX_TILE and k > 32 or k > 256
    assert want.symbol == tensor_core_entry(dtype, k, tile_n)
    assert select == (want.library == "select")
    assert [sym for sym, _ in launched] == [want.symbol]
    assert ops == [{"f32": "query_operand_tf32", "bf16": "query_operand",
                    "int8": "query_operand_int8"}[dtype]]
    args = launched[0][1]
    if not select:
        tail = args[9:15] if dtype == "int8" else args[7:13]
        assert tail == (n, d, b, k, tile_n, 1)
    else:
        group = scan.select_group_rows(n, b, tile_n)
        assert group == n  # 256 MiB of scratch holds both tiles at B 5
        at = 8 if dtype == "int8" else 6
        assert args[at] == group
        assert args[at + 3:at + 9] == (n, d, b, k, tile_n, 1)
        assert len(args) == at + 10


@pytest.mark.parametrize("b, tile_n, want_tiles", [
    (256, 32768, 8), (256, 65536, 4), (256, 4096, 64), (64, 32768, 32), (1024, 65536, 1),
])
def test_select_group_rows_bounds_the_scratch(b, tile_n, want_tiles):
    """The radix select's scratch holds a group of whole tiles' [B, rows]
    f32 scores within SELECT_SCRATCH_BYTES (256 MiB), at least one tile,
    at most all the rows."""
    n = 1 << 20
    group = scan.select_group_rows(n, b, tile_n)
    assert group == want_tiles * tile_n
    assert group % tile_n == 0 and n % group == 0
    assert 4 * b * group <= max(scan.SELECT_SCRATCH_BYTES, 4 * b * tile_n)
    assert scan.select_group_rows(3 * tile_n, b, tile_n) == min(3, want_tiles) * tile_n


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 16, 32, 33, 300])
def test_l1_wrapper_routes_rows_by_dtype_and_k(dtype, k, monkeypatch):
    """Manhattan: tile_topk_cuda launches the kernel exact_route names,
    once, with K4's query image (l1_query_operand), the rows and the
    validity: up to k 32 the FADD stream's entry for the rows' dtype and
    the outputs; beyond it the select entry, which also takes a [B, group
    rows] f32 scratch and the group's rows (select_group_rows). A fake
    card lets the host side run here."""
    n, d, b, tile_n = 1024, 100, 5, 512
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    rows = torch.zeros((n, d), dtype=dt)
    launched = []
    for kern in (scan.SCAN_TOPK_L1_SELECT, scan.SCAN_TOPK_L1_SELECT_BF16,
                 scan.SCAN_TOPK_L1_FADD, scan.SCAN_TOPK_L1_FADD_BF16):
        monkeypatch.setattr(kern, "launch",
                            lambda *a, kern=kern: launched.append((kern.symbol, a)))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    images = []
    real = scan.l1_query_operand
    monkeypatch.setattr(scan, "l1_query_operand",
                        lambda q, dtype: images.append(real(q, dtype)) or images[-1])
    s, i = scan.tile_topk_cuda(rows, None, None, torch.ones(n, dtype=torch.bool),
                               torch.zeros((b, d)), metric=SimilarityMetric.MANHATTAN,
                               k_tile=k, tile_n=tile_n)
    assert s.shape == i.shape == (b, n // tile_n, k)
    tail = "_bf16" if dtype == "bf16" else ""
    want = ("scan_topk_l1_fadd" if k <= 32 else "scan_topk_l1_select") + tail
    assert [sym for sym, _ in launched] == [want]
    args = launched[0][1]
    assert len(images) == 1
    assert images[0].shape == (1, 2 if dtype == "bf16" else 4, 64, 64 if dtype == "bf16" else 32)
    assert args[0] == images[0].data_ptr() and args[1] == rows.data_ptr()
    if k <= 32:
        assert args[5:10] == (n, d, b, k, tile_n)
        assert len(args) == 11
    else:
        group = scan.select_group_rows(n, b, tile_n)
        assert group == n  # 256 MiB of scratch holds both tiles at B 5
        assert args[4] == group and args[7:12] == (n, d, b, k, tile_n)
        assert len(args) == 13


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b, d", [(5, 100), (70, 384), (64, 32), (1, 768)])
def test_l1_query_operand_layout(dtype, b, d, rng):
    """K4's query image: [ceil(B / 64), slices, 64, S] f32 with S = 32
    dimensions a slice over f32 rows and 64 over bf16 rows (128 bytes of a
    row), entry (block, slice, i, e) query 64 block + i's dimension S slice
    + e, zero past B and D."""
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    ds = 32 if dtype == "f32" else 64
    img = scan.l1_query_operand(q, dt)
    blocks, slices = -(-b // 64), -(-d // ds)
    assert img.shape == (blocks, slices, 64, ds) and img.dtype == torch.float32
    assert img.is_contiguous()
    full = torch.zeros((blocks * 64, slices * ds))
    full[:b, :d] = q
    for blk in range(blocks):
        for sl in range(slices):
            assert torch.equal(img[blk, sl], full[64 * blk:64 * blk + 64, ds * sl:ds * sl + ds])


def l1_selection_model(s, tile_n, k):
    """K4's FADD-stream selection (csrc/l1.cu select_chunk) in NumPy, on a
    [B, N] score matrix: per query and tile, 256-row chunks, lane l holding
    rows l + 32 j (slot j < 8); the tile's first chunk seeds a 32-entry
    list with each lane's best row (the lowest row among equal scores)
    sorted by (score descending, row ascending); then slot by slot, lane by
    lane, each row that precedes the list's k-th entry (the seeded rows
    skipped) is inserted and the last entry dropped. Returns ([B, T, k]
    scores, int32 rows)."""
    b, n = s.shape
    n_tiles = n // tile_n
    out_s = np.empty((b, n_tiles, k), np.float32)
    out_i = np.empty((b, n_tiles, k), np.int32)
    lanes = np.arange(32)
    for q in range(b):
        for t in range(n_tiles):
            ls, lr = [], []
            for c in range(tile_n // 256):
                base = t * tile_n + c * 256
                sc = s[q, base:base + 256].reshape(8, 32)  # [slot j, lane]
                rows = base + np.arange(256).reshape(8, 32)
                skip = np.full(32, -1)
                if c == 0:
                    skip = np.argmax(sc, axis=0)  # the first of equal maxima: the lowest row
                    seeds = sorted(zip(sc[skip, lanes], rows[skip, lanes]),
                                   key=lambda e: (-e[0], e[1]))
                    ls, lr = [float(e[0]) for e in seeds], [int(e[1]) for e in seeds]
                for j in range(8):
                    kth = (ls[k - 1], lr[k - 1])  # read once a slot, as the ballot is
                    for lane in range(32):
                        x, r = float(sc[j, lane]), int(rows[j, lane])
                        if skip[lane] == j or not _precedes(x, r, *kth):
                            continue
                        p = sum(_precedes(ls[e], lr[e], x, r) for e in range(32))
                        ls.insert(p, x)
                        lr.insert(p, r)
                        del ls[32:], lr[32:]
            out_s[q, t] = ls[:k]
            out_i[q, t] = lr[:k]
    return out_s, out_i


@pytest.mark.parametrize("k, tile_n", [(1, 256), (16, 256), (32, 256), (1, 2048), (10, 2048),
                                       (16, 2048), (32, 2048), (32, 512)])
def test_l1_selection_model_matches_tile_topk_plain(k, tile_n):
    """K4's FADD-stream selection gives tile_topk_plain's ids and scores
    exactly on integer-valued scores with many ties, an all-invalid tile, a
    tile invalid but for one row, a tile whose rows rise (every chunk's rows
    beat the list) and one whose rows fall, and random scores."""
    g = np.random.default_rng([k, tile_n, 4])
    b, n = 3, 5 * tile_n
    s = g.integers(-4, 5, size=(b, n)).astype(np.float32)
    s[:, tile_n:3 * tile_n] = -np.inf  # tile 1: no valid row
    s[:, 2 * tile_n + 100] = 2.0  # tile 2: one valid row
    s[0, 3 * tile_n:4 * tile_n] = np.arange(tile_n) // 3  # rising, in ties of three
    s[1, 3 * tile_n:4 * tile_n] = -np.arange(tile_n) // 5  # falling, in ties of five
    s[2, 3 * tile_n:4 * tile_n] = g.normal(size=tile_n)
    got_s, got_i = l1_selection_model(s, tile_n, k)
    want_s, want_i = scan.stable_topk(torch.from_numpy(s).view(b, n // tile_n, tile_n), k)
    want_i = want_i + torch.arange(n // tile_n)[None, :, None] * tile_n
    assert np.array_equal(got_i, want_i.numpy())
    assert np.array_equal(got_s, want_s.numpy())


# ---------------------------------------------------------- on the card
#
# K1-K4 against their plain versions at chip_smoke.py phase 2's small
# shapes, under its tolerance: the kernel's top k against the plain top
# k + 1, scores within rtol/atol 1e-5 (f32 sums taken in another order),
# ids equal except among scores within 1e-5 of each other.

CARD_SHAPES = [(65536, 384, 64), (8192, 100, 5)]
CARD_IDS = ["65536x384-B64", "8192x100-B5"]


def card_inputs(n, d, b, seed=0):
    """Rows of N(0, 1) times a per-row scale in [0.5, 2] (f32, bf16 and
    int8 + scales), 5% invalid, and f32 queries, all on the card."""
    if not torch.cuda.is_available():
        pytest.skip("K1-K4 are CUDA C++ and run only on an NVIDIA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng([seed, n, d, b])
    v = rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, (n, 1))
    v = torch.from_numpy(v.astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    v8, sc = quantize_rows_int8(v)
    rows = {"f32": (v, None), "bf16": (v.to(torch.bfloat16), None), "int8": (v8, sc)}
    return rows, (v * v).sum(-1), valid, q


def plain_topk(tiles, b, k):
    s, i = tiles
    return scan.merge_topk(s.reshape(b, -1), i.reshape(b, -1), k)


def assert_topk_matches(got, want):
    ks, ki = (x.cpu().numpy() for x in got)
    ps, pi = (x.cpu().numpy() for x in want)
    k = ks.shape[1]
    np.testing.assert_allclose(ks, ps[:, :k], rtol=1e-5, atol=1e-5)
    for row in range(ks.shape[0]):
        for p in np.flatnonzero(pi[row, :k] != ki[row]):
            near = np.abs(ps[row] - ps[row, p]) <= 1e-5 * max(1.0, abs(ps[row, p]))
            near[p] = False
            assert near.any(), (row, p)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=CARD_IDS)
@pytest.mark.parametrize("dtype, k, tile_n", [
    ("f32", 16, 2048), ("f32", 100, 2048), ("f32", 300, 2048), ("bf16", 16, 4096),
], ids=["f32-k16", "f32-k100", "f32-k300", "bf16-k16"])
def test_exact_kernel_matches_plain_on_the_card(dtype, k, tile_n, shape):
    """K1 on the route exact_route names: the tensor-core body's TOPK mode
    (k <= 32; scan_topk_exact_tf32 over f32 rows, _bf16 over bf16 rows),
    its wide mode (k 33-256: scan_topk_wide_tf32) and its scores into the
    radix select (k 300: scan_topk_select_tf32, on the tile exact_tile
    grows); the plain version at the caller's tile."""
    rows, sq, valid, q = card_inputs(*shape)
    v, _ = rows[dtype]
    for metric in METRICS:
        m = SimilarityMetric[metric]
        got = scan.pallas_search_topk(v, sq, valid, q, metric=m, k=k, tile_n=tile_n)
        want = plain_topk(scan.tile_topk_plain(
            v, None, sq, valid, q, metric=m, k_tile=min(k + 1, tile_n), tile_n=tile_n),
            q.shape[0], k + 1)
        assert_topk_matches(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=CARD_IDS)
def test_exact_int8_kernel_matches_plain_on_the_card(shape):
    """K2 (scan_topk_exact_s8 at k 16): int8 rows times their scales."""
    rows, sq, valid, q = card_inputs(*shape)
    v8, sc = rows["int8"]
    for metric in METRICS:
        m = SimilarityMetric[metric]
        got = scan.pallas_search_topk_int8(v8, sc, sq, valid, q, metric=m, k=16, tile_n=2048)
        want = plain_topk(scan.tile_topk_plain(
            v8, sc, sq, valid, q, metric=m, k_tile=17, tile_n=2048), q.shape[0], 17)
        assert_topk_matches(got, want)


#: the TOPK mode's card shapes: (rows, D, B, tile): 200-byte bf16 and
#: 100-byte int8 rows (the plain-load staging), the main path's widths at
#: B 256, D 768 over two query blocks, and 2^19 rows in 2,048-row tiles
#: (1,024 (tile, query block) pairs: a block walks several tiles)
TOPK_SHAPES = [(8192, 100, 5, 2048), (65536, 384, 256, 4096), (16384, 768, 70, 2048),
               (1 << 19, 384, 256, 2048)]
TOPK_IDS = ["8192x100-B5-t2048", "65536x384-B256-t4096", "16384x768-B70-t2048",
            "524288x384-B256-t2048"]
#: the radix select's lists of k 257-2,048 on those shapes (k = tile_n at
#: 2,048 over 2,048-row tiles) and over tiles of 16,384 and 32,768 rows (the
#: wrapper's grown tiles; 200-byte rows on the plain-load staging)
DEEP_KS = [257, 300, 512, 1024, 2048]
DEEP_SHAPES = [(65536, 384, 64, 16384), (131072, 384, 70, 32768), (65536, 100, 5, 32768)]
DEEP_IDS = ["65536x384-B64-t16384", "131072x384-B70-t32768", "65536x100-B5-t32768"]
TOPK_CASES = [
    pytest.param(shape, k, id=f"k{k}-{sid}")
    for shapes, ids, ks in ((TOPK_SHAPES, TOPK_IDS, [1, 10, 16, 32, 33, 64, 100, 128, 256]),
                            (TOPK_SHAPES + DEEP_SHAPES, TOPK_IDS + DEEP_IDS, DEEP_KS))
    for k in ks for shape, sid in zip(shapes, ids)
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, k", TOPK_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_exact_topk_mode_matches_plain_on_the_card(dtype, k, shape):
    """K1 and K2 on the route exact_route names (k <= 32: the tensor-core
    body's TOPK mode, scan_topk_exact_tf32 / _bf16 / _s8; k 33-256: its wide
    mode, scan_topk_wide_tf32 / _bf16 / _s8; k 257-2,048: its scores into
    the radix select, scan_topk_select_tf32 / _bf16 / _s8), one launch a
    metric: every tile's
    list held against tile_topk_plain's under the 1e-5 rule, with 5%
    invalid rows, rows 7, 300 and 900 one row (ties to the lowest), query 0
    near them, and tile 1 without a valid row.

    One case the rule cannot decide: dot products of these rows (|x| up to
    2 sqrt(D)) near 0, which lists of half a tile or more reach. There the
    plain f32 product itself lies up to 1.2e-5 (D 100), 4.8e-5 (D 384) and
    1.3e-4 (D 768) from float64 on an H100 (PERF.md), so no two f32
    products meet 1e-5 against each other. Those dot lists are held to
    float64 instead (assert_dots_match_f64); cosine and euclidean keep the
    rule there."""
    n, d, b, tile_n = shape
    rows, sq, valid, q = card_inputs(n, d, b)
    for name, (v, _) in rows.items():
        if name != "int8":
            v[[300, 900]] = v[7].clone()
    v8, sc = rows["int8"]
    v8[[300, 900]] = v8[7].clone()
    sc[[300, 900]] = sc[7].clone()
    sq[[300, 900]] = sq[7].clone()
    valid[[7, 300, 900]] = True
    valid[tile_n:2 * tile_n] = False
    q[0] = rows["f32"][0][7] + 0.5 * q[0]
    v, scales = rows[dtype]
    kernel = scan.exact_route(v.dtype, k, SimilarityMetric.COSINE, tile_n)
    assert kernel.symbol == tensor_core_entry(dtype, k)
    for metric in METRICS:
        m = SimilarityMetric[metric]
        before = kernel.launches
        s_, i_ = scan.tile_topk_cuda(v, scales, sq, valid, q, metric=m, k_tile=k,
                                     tile_n=tile_n)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        kw = min(k + 1, tile_n)
        ws, wi = scan.tile_topk_plain(v, scales, sq, valid, q, metric=m, k_tile=kw,
                                      tile_n=tile_n)
        if metric == "DOT_PRODUCT" and 2 * k >= tile_n:
            assert_dots_match_f64((s_, i_), (ws[..., :k], wi[..., :k]), v, scales, valid, q)
            continue
        assert_topk_matches((s_.reshape(-1, k), i_.reshape(-1, k)),
                            (ws.reshape(-1, kw), wi.reshape(-1, kw)))


def assert_dots_match_f64(got, want, v, scales, valid, q):
    """[B, T, k] dot-product lists against float64, beside the plain f32
    product's lists: the kernel's listed scores no farther from their rows'
    float64 dots than the plain version's, in rms and in the largest error
    among dots within 1 of 0 (the largest error overall is an ulp or two of
    the largest scores for both); each listed row's float64 dot within e
    (the plain version's largest error) of its tile's float64 k-th best;
    -inf slots (invalid rows) name the plain version's rows."""
    b, n_tiles, k = got[0].shape
    v64 = v.double() if scales is None else v.double() * scales.double()[:, None]
    exact = q.double() @ v64.T
    exact = torch.where(valid[None, :], exact, -torch.inf)
    rms, near0, top = [], [], []
    for s_, i_ in (got, want):
        dots = exact.gather(1, i_.reshape(b, -1).long())
        fin = torch.isfinite(dots)
        assert torch.equal(fin, torch.isfinite(s_.reshape(b, -1)))
        err = (s_.reshape(b, -1).double() - dots)[fin].abs()
        rms.append(err.square().mean().sqrt().item())
        near0.append(err[dots[fin].abs() < 1.0].max().item())
        top.append(err.max().item())
    assert rms[0] <= rms[1] and near0[0] <= near0[1], (rms, near0)
    kth = exact.view(b, n_tiles, -1).topk(k, dim=-1).values[..., -1:]
    mine = exact.gather(1, got[1].reshape(b, -1).long()).view(b, n_tiles, k)
    fin = torch.isfinite(kth).expand_as(mine)
    assert bool((mine[fin] >= kth.expand_as(mine)[fin] - top[1]).all())
    inf = ~torch.isfinite(got[0])
    assert torch.equal(got[1][inf], want[1][inf])


#: the radix select's card shapes (rows, D, B, tile) and lists: k past
#: 2,048 to k = tile_n over 32,768-row tiles at D 100, 384 and 768, and
#: 65,536-row tiles (past the wide mode's) at k 33, 300 and 4,096 (the sort
#: in registers) and 40,000 and 65,536 (the sort in the output)
SELECT_CASES = [
    pytest.param(shape, k, id=f"k{k}-{sid}")
    for shape, sid, ks in (
        ((131072, 384, 64, 32768), "131072x384-B64-t32768", [2049, 4096, 8192, 32768]),
        ((65536, 100, 5, 32768), "65536x100-B5-t32768", [2049, 4096, 32768]),
        ((65536, 768, 70, 32768), "65536x768-B70-t32768", [2049, 4096]),
        ((131072, 384, 70, 65536), "131072x384-B70-t65536", [33, 300, 4096, 40000, 65536]))
    for k in ks
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, k", SELECT_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_select_entries_match_plain_on_the_card(dtype, k, shape):
    """K1 and K2 on the radix select (csrc/select.cu scan_topk_select_tf32 /
    _bf16 / _s8: the tensor-core body's scores into a select a (query,
    tile)), one launch a metric: every tile's list held against
    tile_topk_plain's under the 1e-5 rule, with 10% invalid rows, every
    ninth row a copy of row 4 (ties to the lowest row), query 0 near it,
    and tile 1 without a valid row. Dot-product lists of half a tile or
    more reach dots near 0 and are held to float64 (assert_dots_match_f64),
    as those of k 257-2,048 are."""
    n, d, b, tile_n = shape
    rows, sq, valid, q = card_inputs(n, d, b, seed=16)
    for name, (v, _) in rows.items():
        if name != "int8":
            v[13::9] = v[4].clone()
    v8, sc = rows["int8"]
    v8[13::9] = v8[4].clone()
    sc[13::9] = sc[4].clone()
    sq[13::9] = sq[4].clone()
    valid[::10] = False
    valid[4] = True
    valid[tile_n:2 * tile_n] = False
    q[0] = rows["f32"][0][4] + 0.5 * q[0]
    v, scales = rows[dtype]
    kernel = scan.exact_route(v.dtype, k, SimilarityMetric.COSINE, tile_n)
    assert kernel.symbol == tensor_core_entry(dtype, k, tile_n)
    assert kernel.library == "select"
    for metric in METRICS:
        m = SimilarityMetric[metric]
        before = kernel.launches
        s_, i_ = scan.tile_topk_cuda(v, scales, sq, valid, q, metric=m, k_tile=k,
                                     tile_n=tile_n)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        kw = min(k + 1, tile_n)
        ws, wi = scan.tile_topk_plain(v, scales, sq, valid, q, metric=m, k_tile=kw,
                                      tile_n=tile_n)
        if metric == "DOT_PRODUCT" and 2 * k >= tile_n:
            assert_dots_match_f64((s_, i_), (ws[..., :k], wi[..., :k]), v, scales, valid, q)
            continue
        assert_topk_matches((s_.reshape(-1, k), i_.reshape(-1, k)),
                            (ws.reshape(-1, kw), wi.reshape(-1, kw)))
        inf = ~torch.isfinite(s_)
        assert torch.equal(i_[inf], wi[..., :k][inf])


@pytest.mark.cuda
def test_l1_reciprocal_matches_the_exact_division_on_the_card():
    """K4's FADD stream scores 1 / (1 + sum) by the exact reciprocal's
    branch-free fast path (csrc/l1.cu rcp_fast): bit for bit __frcp_rn's
    (IEEE division, round to nearest) over every f32 of [1, 2^126)."""
    if not torch.cuda.is_available():
        pytest.skip("K4's reciprocal is CUDA C++ and runs only on an NVIDIA card")
    from vectorlite_tpu_torch.kernels import _build

    fn = _build.load("l1").l1_rcp_check
    fn.argtypes = [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for exponent in range(126):
        assert fn((127 + exponent) << 23, 1 << 23, bad.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    assert int(bad.item()) == 0


def assert_lane_lists_match(got, want, winners, raw_dots=False, exact=None):
    """K3's [B, T, W*128] lists against the plain version's lists of W + 1
    (W where a lane group has only W rows): the same -inf pattern, finite
    scores within rtol/atol 1e-5, ids equal except among scores within 1e-5
    of each other; an empty (-inf) slot names exactly the plain version's
    row (the lowest rows of its lane group not listed). ``raw_dots`` (the
    dot metric): raw dots of every magnitude, so chip_smoke.py's rule for
    them (K6, K8 none): within 1e-5 x max(1, max |score|), f32 sums of the
    same products taken in another order; lists of a few rows (384-row
    tiles) hold dots near 0, where two f32 orders differ by more than
    1e-5. ``exact`` ([B, N] float64 dots of the queries and rows, -inf
    where invalid: f32 rows under the dot metric) also holds each listed
    score to its row's float64 dot, within rtol/atol 1e-5 plus the plain
    version's own largest distance from float64 in the same lists, as K7's
    f32 dot lists are held (tests/test_torch_merge.py card_lanes): there
    the plain f32 product lies up to 1.39e-4 (D 768) from float64."""
    ks, ki = (x.cpu().numpy() for x in got)
    ps, pi = (x.cpu().numpy() for x in want)
    b, t = ks.shape[:2]
    if exact is not None:
        ex = exact.cpu().numpy()
        q_of = np.repeat(np.arange(b), t * 128)[:, None]
    ks, ki = (x.reshape(b, t, winners, 128).transpose(0, 1, 3, 2).reshape(-1, winners)
              for x in (ks, ki))
    wp = ps.shape[2] // 128
    ps, pi = (x.reshape(b, t, wp, 128).transpose(0, 1, 3, 2).reshape(-1, wp) for x in (ps, pi))
    empty = np.isneginf(ps[:, :winners])
    assert np.array_equal(np.isneginf(ks), empty)
    fin = ps[:, :winners][~empty]
    if exact is not None:
        dk, dp = ex[q_of, ki][~empty], ex[q_of, pi[:, :winners]][~empty]
        slack = float(np.abs(fin.astype(np.float64) - dp).max(initial=0.0))
        err = np.abs(ks[~empty].astype(np.float64) - dk)
        assert bool((err <= 1e-5 + 1e-5 * np.abs(dk) + slack).all()), (
            float(err.max(initial=0.0)), slack)
    if raw_dots:
        tol = 1e-5 * max(1.0, float(np.abs(fin).max(initial=0.0)))
        assert float(np.abs(ks[~empty] - fin).max(initial=0.0)) <= tol
    else:
        np.testing.assert_allclose(ks[~empty], fin, rtol=1e-5, atol=1e-5)
    assert np.array_equal(ki[empty], pi[:, :winners][empty])
    for m in np.flatnonzero((ki != pi[:, :winners]).any(axis=1)):
        for p in np.flatnonzero(ki[m] != pi[m, :winners]):
            near = np.abs(ps[m] - ps[m, p]) <= (
                tol if raw_dots else 1e-5 * max(1.0, abs(ps[m, p])))
            near[p] = False
            assert near.any(), (m, p)


#: K3's card shapes: (rows, D, B, tile): the phase-2 shapes, D 768, and
#: 384-row tiles over 2 query blocks (512 (tile, query block) pairs: a
#: tensor-core block walks several tiles)
BLOCK_SHAPES = [(65536, 384, 64, 4096), (8192, 100, 5, 4096), (16384, 768, 70, 4096),
                (98304, 384, 70, 384), (8192, 99, 3, 4096)]
BLOCK_IDS = ["65536x384-B64", "8192x100-B5", "16384x768-B70", "98304x384-B70-t384",
             "8192x99-B3"]


@pytest.mark.cuda
@pytest.mark.parametrize("winners", [1, 2, 3])
@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=BLOCK_IDS)
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_block_kernel_matches_plain_on_the_card(dtype, shape, winners):
    """K3 on every route of the tensor-core body (f32: scan_block_topw_tf32,
    3xTF32; bf16: scan_block_topw_bf16; int8: scan_block_topw_s8, W 1-3
    where ``block_route`` sends them there): each lane group's lists held
    against the plain version's, with 5% invalid rows, a lane group with
    one live row and a tile with none; then the top 16 of the pool. D 100
    and 99 take the plain-load staging (rows TMA refuses; f32 rows load
    their words from device memory only at D 99) while blocks walk runs of
    tiles."""
    check_block_kernel(dtype, shape, winners)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BLOCK_SHAPES[:3], ids=BLOCK_IDS[:3])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_block_kernel_cuda_core_forms_on_the_card(dtype, shape):
    """f32, bf16 and int8 rows at W 4, past the tensor-core body's lists,
    run the CUDA-core scan_block_topw's three forms: held as above."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    assert scan.block_route(dt, 4) is scan.SCAN_BLOCK_TOPW
    check_block_kernel(dtype, shape, 4)


def check_block_kernel(dtype, shape, winners):
    """K3 on the kernel ``block_route`` names for ``dtype`` and
    ``winners``: launched once a metric, its lists and its pool's top 16
    held against the plain version's; f32 dot lists also to float64."""
    n, d, b, tile_n = shape
    rows, sq, valid, q = card_inputs(n, d, b)
    valid[3::128] = False
    valid[3 + 128 * 5] = True  # lane group 3 of tile 0: one live row
    valid[tile_n:2 * tile_n] = False  # tile 1: no live row
    v, sc = rows[dtype]
    kernel = scan.block_route(v.dtype, winners)
    for metric in METRICS:
        m = SimilarityMetric[metric]
        before = kernel.launches
        got = scan.block_topw_cuda(v, sc, sq, valid, q, metric=m, tile_n=tile_n,
                                   winners=winners)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = scan.block_topw_plain(v, sc, sq, valid, q, metric=m, tile_n=tile_n,
                                     winners=min(winners + 1, tile_n // 128))
        exact = None
        if dtype == "f32" and metric == "DOT_PRODUCT":
            exact = torch.where(valid[None, :], q.double() @ v.double().T, float("-inf"))
        assert_lane_lists_match(got, want, winners, raw_dots=metric == "DOT_PRODUCT",
                                exact=exact)
        kw = dict(metric=m, tile_n=tile_n, winners=winners)
        if sc is None:
            top = scan.pallas_search_block_topk(v, sq, valid, q, k=16, **kw)
        else:
            top = scan.pallas_search_block_topk_int8(v, sc, sq, valid, q, k=16, **kw)
        want = plain_topk(scan.block_topw_plain(v, sc, sq, valid, q, **kw), q.shape[0], 17)
        assert_topk_matches(top, want)


#: K4's card shapes: (rows, D, B, tile): the phase-2 shapes, 396-byte f32
#: rows (TMA refuses them: the plain-load staging), D 768 (the queries ride
#: the stages) over two query blocks in 4,096-row tiles, 256-row tiles
#: (one chunk a tile), 384-row tiles (not a multiple of the FADD stream's
#: 256-row chunk: its scores into the radix select at every k, the last
#: chunk of a group ragged), and 2^19 rows at the main path's B and tile
L1_SHAPES = [(65536, 384, 64, 2048), (8192, 100, 5, 2048), (8192, 99, 3, 2048),
             (16384, 768, 70, 4096), (16384, 384, 64, 256), (12288, 384, 64, 384),
             (1 << 19, 384, 256, 2048)]
L1_IDS = ["65536x384-B64", "8192x100-B5", "8192x99-B3", "16384x768-B70-t4096",
          "16384x384-B64-t256", "12288x384-B64-t384", "524288x384-B256"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", L1_SHAPES, ids=L1_IDS)
@pytest.mark.parametrize("dtype, k", [
    ("f32", 1), ("f32", 16), ("f32", 32), ("f32", 33), ("f32", 64), ("f32", 100), ("f32", 300),
    ("f32", 1024), ("bf16", 1), ("bf16", 16), ("bf16", 32), ("bf16", 33), ("bf16", 256),
    ("bf16", 300), ("bf16", 1024),
], ids=["f32-k1", "f32-k16", "f32-k32", "f32-k33", "f32-k64", "f32-k100", "f32-k300",
        "f32-k1024", "bf16-k1", "bf16-k16", "bf16-k32", "bf16-k33", "bf16-k256", "bf16-k300",
        "bf16-k1024"])
def test_l1_kernel_matches_plain_on_the_card(dtype, k, shape):
    """K4, Manhattan 1 / (1 + sum |q - v|), on the route exact_route names
    (k <= 32 over tiles of a multiple of 256 rows: the FADD stream's lists,
    scan_topk_l1_fadd / _bf16; else its scores into the radix select,
    scan_topk_l1_select / _bf16), launched once at the caller's tile:
    every tile's list held against
    tile_topk_plain's under the 1e-5 rule, with 5% invalid rows, rows 7, 300
    and 900 one row (ties to the lowest), query 0 near them and tile 1
    without a valid row; then the merged top k."""
    n, d, b, tile_n = shape
    rows, sq, valid, q = card_inputs(n, d, b)
    v, _ = rows[dtype]
    v[[300, 900]] = v[7].clone()
    valid[[7, 300, 900]] = True
    valid[tile_n:2 * tile_n] = False
    q[0] = rows["f32"][0][7] + 0.5 * q[0]
    M = SimilarityMetric.MANHATTAN
    kernel = scan.exact_route(v.dtype, k, M, tile_n)
    fadd = k <= 32 and tile_n % 256 == 0
    assert kernel.symbol == "scan_topk_l1_" + ("fadd" if fadd else "select") + (
        "_bf16" if dtype == "bf16" else "")
    k_tile = min(k, tile_n)
    before = kernel.launches
    s_, i_ = scan.tile_topk_cuda(v, None, None, valid, q, metric=M, k_tile=k_tile, tile_n=tile_n)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ws, wi = scan.tile_topk_plain(v, None, None, valid, q, metric=M,
                                  k_tile=min(k_tile + 1, tile_n), tile_n=tile_n)
    assert_topk_matches((s_.reshape(-1, k_tile), i_.reshape(-1, k_tile)),
                        (ws.reshape(-1, ws.shape[-1]), wi.reshape(-1, wi.shape[-1])))
    got = scan.pallas_search_topk_l1(v, valid, q, k=k, tile_n=tile_n)
    want = plain_topk(scan.tile_topk_plain(
        v, None, sq, valid, q, metric=M, k_tile=min(k + 1, tile_n), tile_n=tile_n),
        q.shape[0], k + 1)
    assert_topk_matches(got, want)
