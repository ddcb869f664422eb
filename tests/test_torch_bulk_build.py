"""The port's bulk HNSW build (vectorlite_tpu_torch/index/bulk_build.py)
against the JAX package's CPU path, on the CPU.

``_chunk_candidates`` (here ``scan.pallas_search_topk`` at k = 256, its
plain twin on the CPU; K1's wide mode on the card) returns the JAX CPU
path's rows beyond 1e-5 near-ties (two rows whose f64 distances lie within
1e-5) and its distances within 1e-5,
including the validity horizon, self-removal and the NEAR_K + strided
MID_K sample. At one build thread the bulk graph equals the JAX
package's (euclidean: all but near-tied links). The "auto" policy engages past VECTORLITE_BULK_AUTO_ROWS on a
CUDA device and not on the CPU (tests/test_bulk_build.py:210-246, with
the device faked). The card test holds the scan on K1's wide mode against
its plain twin at 65,536 x 384 with 1,024 queries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorlite_tpu as jv
import vectorlite_tpu_torch as tv
from vectorlite_tpu.index import bulk_build as jbb
from vectorlite_tpu_torch.index import bulk_build as tbb

METRICS = ["COSINE", "EUCLIDEAN", "DOT_PRODUCT"]


@pytest.fixture(autouse=True)
def _one_build_thread(monkeypatch):
    monkeypatch.setenv("VECTORLITE_BUILD_THREADS", "1")
    monkeypatch.delenv("VECTORLITE_NO_NATIVE", raising=False)


def make_embeddings(n, d, n_clusters=64, spread=0.35, seed=0):
    """tests/test_bulk_build.py's geometry: unit rows around unit centers."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, n)
    data = centers[assign] + spread * rng.normal(size=(n, d)) / np.sqrt(d)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    return data


def true_dist(values, q, rows, metric):
    """The internal HNSW distance of each (query, row) in f64: cosine 1 -
    cos, euclidean L2, dot 1000 - clamp(dot)."""
    v = values.astype(np.float64)[np.maximum(rows, 0)]
    q = q.astype(np.float64)[:, None, :]
    dot = (v * q).sum(-1)
    if metric == "COSINE":
        return 1.0 - dot / (np.linalg.norm(v, axis=-1) * np.linalg.norm(q, axis=-1))
    if metric == "EUCLIDEAN":
        return np.linalg.norm(v - q, axis=-1)
    return 1000.0 - np.clip(dot, -1000.0, 1000.0)


def rows_match(got_rows, got_d, want_rows, want_d, values, q, metric, tol=1e-5):
    """Distances within ``tol`` plus one f32 ulp of the distance (dot
    product's 1000 - dot carries ulp(1000) = 6.1e-5); rows equal per slot
    except where the two rows' f64 distances lie within ``tol`` of each
    other (a near tie, at the slot or at an unsampled rank beside it)."""
    finite = np.isfinite(want_d)
    assert (np.isfinite(got_d) == finite).all()
    slack = tol + np.spacing(np.abs(want_d[finite]).astype(np.float32))
    assert (np.abs(got_d[finite] - want_d[finite]) <= slack).all()
    assert ((got_rows < 0) == (want_rows < 0)).all()
    bad = got_rows != want_rows
    if bad.any():
        gap = np.abs(true_dist(values, q, got_rows, metric)
                     - true_dist(values, q, want_rows, metric))
        assert (gap[bad] <= 2 * tol).all(), np.argwhere(bad & (gap > 2 * tol))[:5]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("batch_end", [300, 1024, 2048])
def test_chunk_candidates_match_jax(metric, batch_end):
    cap, d, b = 2048, 32, 64
    rng = np.random.default_rng(batch_end)
    values = np.zeros((cap, d), np.float32)
    values[:batch_end] = make_embeddings(batch_end, d, seed=batch_end) * (
        3.0 if metric == "DOT_PRODUCT" else 1.0)
    values[batch_end:] = rng.standard_normal((cap - batch_end, d))  # past the horizon
    nodes = rng.integers(0, batch_end, b).astype(np.int32)
    nodes[-4:] = -1  # padded query rows
    q = values[np.maximum(nodes, 0)] + 0.01 * rng.standard_normal((b, d)).astype(np.float32)
    sq = (values * values).sum(1)
    want_rows, want_d = jbb._chunk_candidates(
        jnp.asarray(values), jnp.asarray(sq), batch_end, jnp.asarray(q), jnp.asarray(nodes),
        metric=jv.SimilarityMetric[metric], k=jbb.SCAN_K, use_pallas=False)
    got_rows, got_d = tbb._chunk_candidates(
        torch.from_numpy(values), torch.from_numpy(sq), batch_end, torch.from_numpy(q),
        torch.from_numpy(nodes), metric=tv.SimilarityMetric[metric], k=tbb.SCAN_K)
    assert got_rows.shape == (b, tbb.CAND_K) and got_rows.dtype == torch.int32
    got_rows, got_d = got_rows.numpy(), got_d.numpy()
    want_rows, want_d = np.asarray(want_rows), np.asarray(want_d)
    assert (got_rows < batch_end).all()
    for i, node in enumerate(nodes):
        assert node < 0 or node not in got_rows[i]
    rows_match(got_rows, got_d, want_rows, want_d, values, q, metric)


def test_scan_takes_k1_wide_tiles():
    from vectorlite_tpu_torch.kernels import scan

    assert tbb._scan_tile(1 << 20) == scan.WIDE_MAX_TILE == 1 << 15
    assert tbb._scan_tile(4096) == 4096
    # the route the card takes for the bulk scan: K1's wide mode over f32 rows
    kernel = scan.exact_route(torch.float32, tbb.SCAN_K, tv.SimilarityMetric.COSINE,
                              tbb._scan_tile(1 << 20))
    assert kernel.symbol == "scan_topk_wide_tf32"


@pytest.mark.parametrize("metric", METRICS)
def test_bulk_graph_matches_jax(metric, monkeypatch):
    monkeypatch.setenv("VECTORLITE_BULK_BUILD", "always")
    n, d = 5000, 24  # two insertion batches, a partial query chunk
    data = make_embeddings(n, d, seed=3)
    j = jv.HNSWIndex(d, jv.SimilarityMetric[metric], seed=3, store_f64=False)
    t = tv.HNSWIndex(d, tv.SimilarityMetric[metric], seed=3, store_f64=False, device="cpu")
    for index in (j, t):
        index.add_batch_arrays(list(range(n)), data)
        assert index._bulk_built and index._num_nodes == n
    want, got = j.graph_arrays(), t.graph_arrays()
    assert got[2] == want[2] and (got[3] == want[3]).all()
    if metric == "EUCLIDEAN":
        # 1 / score - 1 stretches the 1e-5 score rule, so a near-tied
        # candidate may swap and re-route a few links
        assert (got[1] == want[1]).mean() > 0.999
    else:
        assert (got[1] == want[1]).all()
    assert set(t._bulk_split) == {"scan", "link", "upper", "refine"}
    rng = np.random.default_rng(9)
    recalls = []
    flat = tv.FlatIndex(d, device="cpu")
    flat.add_batch_arrays(list(range(n)), data)
    m = tv.SimilarityMetric[metric]
    for qi in rng.integers(0, n, 24):
        q = data[qi] + 0.01 * rng.normal(size=d)
        truth = {r.id for r in flat.search(q, 10, m)}
        recalls.append(len(truth & {r.id for r in t.search(q, 10, m)}) / 10)
    assert np.mean(recalls) >= 0.9, recalls


class TestAutoPolicy:
    """The auto policy of _link_batch with the index's device faked."""

    def _spy(self, monkeypatch):
        calls = []
        real = tbb.bulk_build

        def spy(index, start, count):
            calls.append((start, count))
            index._device = torch.device("cpu")  # the scan runs here
            return real(index, start, count)

        monkeypatch.setattr(tbb, "bulk_build", spy)
        return calls

    def _index(self, device_type):
        idx = tv.HNSWIndex(32, tv.SimilarityMetric.COSINE, store_f64=False, device="cpu")
        idx._device = torch.device(device_type)
        return idx

    def _fill(self, idx):
        data = make_embeddings(3000, 32, seed=3)
        idx.add_batch_arrays(list(range(len(data))), data)
        return data

    def test_engages_past_threshold_on_cuda(self, monkeypatch):
        monkeypatch.delenv("VECTORLITE_BULK_BUILD", raising=False)
        monkeypatch.setenv("VECTORLITE_BULK_AUTO_ROWS", "2048")
        calls = self._spy(monkeypatch)
        idx = self._index("cuda")
        data = self._fill(idx)
        assert calls == [(0, 3000)]
        assert idx.search(data[5], 1, tv.SimilarityMetric.COSINE)[0].id == 5

    def test_stays_classic_below_threshold(self, monkeypatch):
        monkeypatch.delenv("VECTORLITE_BULK_BUILD", raising=False)
        calls = self._spy(monkeypatch)  # default threshold: 400K
        self._fill(self._index("cuda"))
        assert not calls

    def test_stays_classic_on_the_cpu(self, monkeypatch):
        monkeypatch.delenv("VECTORLITE_BULK_BUILD", raising=False)
        monkeypatch.setenv("VECTORLITE_BULK_AUTO_ROWS", "2048")
        calls = self._spy(monkeypatch)
        self._fill(self._index("cpu"))
        assert not calls

    def test_never_overrides_auto_and_manhattan_stays_classic(self, monkeypatch):
        monkeypatch.setenv("VECTORLITE_BULK_BUILD", "never")
        monkeypatch.setenv("VECTORLITE_BULK_AUTO_ROWS", "1024")
        calls = self._spy(monkeypatch)
        self._fill(self._index("cuda"))
        monkeypatch.setenv("VECTORLITE_BULK_BUILD", "always")
        idx = tv.HNSWIndex(32, tv.SimilarityMetric.MANHATTAN, device="cpu")
        self._fill(idx)
        assert not calls


@pytest.mark.cuda
def test_chunk_candidates_on_k1_wide_match_the_plain_twin():
    """65,536 x 384 rows, 1,024 queries, rows past batch_end alive: the
    scan on the card (K1's wide mode) against the same scan on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("K1's wide mode is CUDA C++ and runs only on an NVIDIA card")
    from vectorlite_tpu_torch.kernels import _build, scan

    cap, d, b, batch_end = 1 << 16, 384, 1024, 50_000
    values = make_embeddings(cap, d, n_clusters=256, seed=1).astype(np.float32)
    nodes = np.arange(batch_end - b, batch_end, dtype=np.int32)
    q = values[nodes]
    sq = (values * values).sum(1)
    for metric in METRICS:
        args = [torch.from_numpy(values), torch.from_numpy(sq), batch_end,
                torch.from_numpy(q), torch.from_numpy(nodes)]
        want_rows, want_d = tbb._chunk_candidates(*args, metric=tv.SimilarityMetric[metric],
                                                  k=tbb.SCAN_K)
        _build.reset_launch_counts()
        got_rows, got_d = tbb._chunk_candidates(
            *[a.cuda() if isinstance(a, torch.Tensor) else a for a in args],
            metric=tv.SimilarityMetric[metric], k=tbb.SCAN_K)
        assert scan.SCAN_TOPK_WIDE_TF32.launches == 1
        rows_match(got_rows.cpu().numpy(), got_d.cpu().numpy(), want_rows.numpy(),
                   want_d.numpy(), values, q, metric)
        assert (got_rows.cpu().numpy() < batch_end).all()
