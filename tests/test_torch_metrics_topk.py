"""The port's batched scoring, int8 quantization and full-score top-k
against the JAX functions on the same seeded inputs: ids equal, scores
within 1e-5 (f32 sums in another order), int8 codes and scales identical."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vectorlite_tpu.core import metrics as jm
from vectorlite_tpu.kernels import topk as jtopk
from vectorlite_tpu_torch.core import metrics as tm
from vectorlite_tpu_torch.kernels import topk as ttopk

METRICS = ["COSINE", "EUCLIDEAN", "MANHATTAN", "DOT_PRODUCT"]


def inputs(rng, n=600, d=48, b=6):
    values = rng.normal(size=(n, d)).astype(np.float32)
    values[5] = 0.0  # a zero row: cosine 0 by the reference's rule
    queries = rng.normal(size=(b, d)).astype(np.float32)
    sq = np.einsum("nd,nd->n", values, values).astype(np.float32)
    valid = rng.random(n) > 0.1
    return values, sq, valid, queries


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batched_scores(metric, dtype, rng):
    values, sq, _, queries = inputs(rng)
    jv = jnp.asarray(values)
    tv = torch.from_numpy(values)
    if dtype == "bf16":
        jv = jv.astype(jnp.bfloat16)
        tv = tv.to(torch.bfloat16)
    j = jm.batched_scores(jv, jnp.asarray(sq), jnp.asarray(queries), jm.SimilarityMetric[metric])
    t = tm.batched_scores(tv, torch.from_numpy(sq), torch.from_numpy(queries), tm.SimilarityMetric[metric])
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_quantize_rows_int8_identical(rng):
    values, _, _, _ = inputs(rng)
    values[7] = np.float32(127.0) * np.linspace(-1, 1, values.shape[1])  # .5 ties
    jq, js = jm.quantize_rows_int8(jnp.asarray(values))
    tq, ts = tm.quantize_rows_int8(torch.from_numpy(values))
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("metric", METRICS)
def test_batched_scores_int8(metric, rng):
    values, sq, _, queries = inputs(rng)
    jq, js = jm.quantize_rows_int8(jnp.asarray(values))
    tq, ts = tm.quantize_rows_int8(torch.from_numpy(values))
    j = jm.batched_scores_int8(jq, js, jnp.asarray(sq), jnp.asarray(queries), jm.SimilarityMetric[metric])
    t = tm.batched_scores_int8(tq, ts, torch.from_numpy(sq), torch.from_numpy(queries), tm.SimilarityMetric[metric])
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_search_topk(metric, rng):
    values, sq, valid, queries = inputs(rng)
    values[100] = values[200] = values[300]  # ties: lowest row first
    sq = np.einsum("nd,nd->n", values, values).astype(np.float32)
    queries[0] = values[300]
    j = jtopk.search_topk(
        jnp.asarray(values), jnp.asarray(sq), jnp.asarray(valid),
        jnp.asarray(queries), metric=jm.SimilarityMetric[metric], k=12,
    )
    t = ttopk.search_topk(
        torch.from_numpy(values), torch.from_numpy(sq), torch.from_numpy(valid),
        torch.from_numpy(queries), metric=tm.SimilarityMetric[metric], k=12,
    )
    assert np.array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_search_topk_int8(metric, rng):
    values, sq, valid, queries = inputs(rng)
    jq, js = jm.quantize_rows_int8(jnp.asarray(values))
    tq, ts = tm.quantize_rows_int8(torch.from_numpy(values))
    j = jtopk.search_topk_int8(
        jq, js, jnp.asarray(sq), jnp.asarray(valid), jnp.asarray(queries),
        metric=jm.SimilarityMetric[metric], k=12,
    )
    t = ttopk.search_topk_int8(
        tq, ts, torch.from_numpy(sq), torch.from_numpy(valid),
        torch.from_numpy(queries), metric=tm.SimilarityMetric[metric], k=12,
    )
    assert np.array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-5, atol=1e-5)


def test_row_sqnorms_and_next_pow2(rng):
    values, _, _, _ = inputs(rng)
    np.testing.assert_allclose(
        ttopk.row_sqnorms(torch.from_numpy(values)).numpy(),
        np.asarray(jtopk.row_sqnorms(jnp.asarray(values))),
        rtol=1e-6,
    )
    for n in (0, 1, 2, 3, 255, 256, 257, 1 << 20):
        assert ttopk.next_pow2(n) == jtopk.next_pow2(n)


def test_update_rows_in_place(rng):
    buf = torch.zeros((8, 3))
    ptr = buf.data_ptr()
    ttopk.update_rows(buf, torch.ones((2, 3), dtype=torch.float64), 5)
    assert buf.data_ptr() == ptr
    assert buf[5:7].eq(1).all() and buf[:5].eq(0).all() and buf[7].eq(0).all()


def test_scalar_metrics_match(rng):
    a, b = rng.normal(size=(2, 16))
    for name in ("cosine_similarity", "euclidean_similarity",
                 "manhattan_similarity", "dot_product"):
        assert getattr(tm, name)(a, b) == getattr(jm, name)(a, b)
    for m in METRICS:
        assert tm.SimilarityMetric[m].calculate(a, b) == jm.SimilarityMetric[m].calculate(a, b)
        name = jm.SimilarityMetric[m].value
        assert tm.SimilarityMetric.parse(name.upper()).value == name
