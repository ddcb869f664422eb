"""The port's IVF rung (kernels/ivf.py, kernels/amk.py and the IVF rung of
FlatIndex) against the JAX package on the same seeded inputs.

The JAX side runs as tests/test_ivf.py runs it on the CPU: the XLA probe
formulation and the Pallas probe kernel K6 in interpret mode. The port
runs the plain version of K6, which its wrapper takes for CPU tensors.
The k-means trainers draw different random numbers, so the index-level
tests carry the JAX index's centroids across (``centroids_from_reference``).

The JAX FlatIndex never serves a search from its IVF layout on the CPU
(its ``_use_pallas`` is false off a TPU, so ``approx`` resolves false):
the index-level parity test calls the JAX index's ``_ivf_topk`` directly,
while the port's public search, with ``_PALLAS_MIN_CAPACITY`` lowered,
goes through its own ``_ivf_topk``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorlite_tpu.core.metrics import SimilarityMetric as JM
from vectorlite_tpu.index.flat import FlatIndex as JFlat
from vectorlite_tpu.kernels import amk as jamk
from vectorlite_tpu.kernels import ivf as jivf
from vectorlite_tpu_torch import VectorLiteClient
from vectorlite_tpu_torch.core.metrics import SimilarityMetric as TM
from vectorlite_tpu_torch.core.types import Vector
from vectorlite_tpu_torch.embed.mock import MockEmbeddingFunction
from vectorlite_tpu_torch.index import flat as tflat
from vectorlite_tpu_torch.index.flat import FlatIndex
from vectorlite_tpu_torch.kernels import amk as tamk
from vectorlite_tpu_torch.kernels import ivf as tivf
from vectorlite_tpu_torch.kernels.topk import next_pow2

D = 64
METRICS = ["COSINE", "EUCLIDEAN", "DOT_PRODUCT"]


@pytest.fixture(autouse=True)
def ivf_env(monkeypatch):
    """tests/test_ivf.py's gates, so the rung engages at test scale on the
    CPU and searches stay off the host f64 scan; and the kernel threshold
    lowered, so the port's default call reaches the IVF dispatch."""
    monkeypatch.setenv("VECTORLITE_IVF_FORCE", "1")
    monkeypatch.setenv("VECTORLITE_IVF_MIN_ROWS", "2000")
    monkeypatch.setenv("VECTORLITE_IVF_TRAIN_SAMPLE", "3000")
    monkeypatch.setenv("VECTORLITE_IVF_ITERS", "4")
    monkeypatch.setenv("VECTORLITE_IVF_PART_ROWS", "64")
    monkeypatch.setenv("VECTORLITE_IVF_NPROBE", "8")
    monkeypatch.setenv("VECTORLITE_IVF_TAIL_MAX", "512")
    monkeypatch.setenv("VECTORLITE_HOST_SCAN_ROWS", "0")
    monkeypatch.setattr(tflat, "_PALLAS_MIN_CAPACITY", 1024)


def corpus(n, d=D, seed=0, clusters=40):
    """tests/test_ivf.py's clustered corpus."""
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.normal(size=(clusters, d))
    rows = centers[rng.integers(0, clusters, n)] + rng.normal(size=(n, d))
    return rows.astype(np.float64)


def exact_topk(rows, q, k, metric):
    if metric is TM.DOT_PRODUCT:
        s = rows @ q
    elif metric is TM.COSINE:
        denom = np.linalg.norm(rows, axis=1) * np.linalg.norm(q)
        with np.errstate(invalid="ignore", divide="ignore"):
            s = np.where(denom > 0, (rows @ q) / np.maximum(denom, 1e-300), 0)
    else:
        s = 1.0 / (1.0 + np.linalg.norm(rows - q, axis=1))
    order = np.argsort(-s, kind="stable")[:k]
    return order, s[order]


def t(x):
    """A CPU tensor holding its own copy of a numpy (or JAX) array."""
    return torch.from_numpy(np.array(x))


def bf16_pair(rows32):
    """The same bf16 rounding in both packages (RNE): the JAX array and
    the port's tensor, whose bits are checked equal."""
    j = jnp.asarray(rows32, dtype=jnp.bfloat16)
    p = torch.from_numpy(rows32).to(torch.bfloat16)
    assert np.array_equal(np.asarray(j).astype(np.float32), p.float().numpy())
    return j, p


def assert_same_topk(js, ji, ts, ti, metric="COSINE", q=None, vals=None):
    """Ids equal except among scores within 1e-5 of each other; the same
    -inf pattern; scores within 2e-6 of the scale their f32 rounding is
    relative to: the score itself for cosine, ``|q| max|v|`` for dot
    product (a small dot of large vectors keeps the vectors' rounding),
    and for euclidean ``1 / (1 + d)``, whose d^2 comes from the expanded
    ``|q|^2 + |v|^2 - 2 q.v``, d^2 within 2e-6 (|q|^2 + max |v|^2)."""
    np.testing.assert_array_equal(ts == -np.inf, js == -np.inf)
    fin = js != -np.inf
    if metric == "COSINE":
        np.testing.assert_allclose(ts[fin], js[fin], rtol=2e-6, atol=1e-7)
    else:
        t64 = np.where(fin, ts, 1.0).astype(np.float64)
        j64 = np.where(fin, js, 1.0).astype(np.float64)
        q = np.asarray(q, np.float64)
        qsq = np.einsum("bd,bd->b", q, q)[:, None] * np.ones(ts.shape)
        vsq = float(np.einsum("nd,nd->n", np.asarray(vals, np.float64),
                              np.asarray(vals, np.float64)).max())
        if metric == "DOT_PRODUCT":
            err, tol = np.abs(t64 - j64), 2e-6 * np.sqrt(qsq * vsq)
        else:
            err = np.abs((1.0 / t64 - 1.0) ** 2 - (1.0 / j64 - 1.0) ** 2)
            tol = 2e-6 * (qsq + vsq)
        assert (err[fin] <= tol[fin]).all(), float((err - tol)[fin].max())
    for b, p in zip(*np.nonzero(ti != ji)):
        if js[b, p] == -np.inf:
            continue
        gaps = np.abs(js[b] - js[b, p])
        gaps[p] = np.inf
        assert gaps.min() <= 1e-5 * max(1.0, abs(js[b, p])), (b, p)


# ------------------------------------------------------------ layout


@pytest.mark.parametrize("top2", [False, True], ids=["top1", "top2"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_build_layout_equals_reference(top2, seed):
    """Skewed cells so that rows spill (to runner-ups with top-2) and
    extras remain; outputs equal the reference's, element for element."""
    rng = np.random.default_rng(seed)
    c = 16
    live = np.sort(rng.choice(6000, 3200, replace=False))
    weights = rng.dirichlet(np.full(c, 0.4))
    first = rng.choice(c, len(live), p=weights).astype(np.int32)
    assign = first
    if top2:
        assign = np.stack([first, (first + 1 + rng.integers(0, c - 1, len(live))) % c],
                          axis=1).astype(np.int32)
    want = jivf.build_layout(assign, live, c)
    got = tivf.build_layout(assign, live, c)
    assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype
    assert np.array_equal(got[1], want[1])
    assert len(got[1]) > 0  # the skew leaves extras
    placed = np.concatenate([got[0][got[0] >= 0], got[1]])
    assert sorted(placed.tolist()) == live.tolist()


def test_pad_factor_and_lane_are_the_reference_constants():
    assert tivf.PAD_FACTOR == jivf.PAD_FACTOR and tivf.NPROBE == jivf.NPROBE
    live = np.arange(1000)
    assign = np.zeros(1000, np.int32)
    for pad, lane in ((1.0, 128), (2.5, 64)):
        want = jivf.build_layout(assign, live, 8, pad_factor=pad, lane=lane)
        got = tivf.build_layout(assign, live, 8, pad_factor=pad, lane=lane)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


# ------------------------------------------------- training, assignment


@pytest.mark.parametrize("top2", [False, True], ids=["top1", "top2"])
def test_assign_rows_with_carried_centroids(top2):
    """Cells equal the JAX assignment's, except rows whose two candidate
    distances are within 1e-6 relative (f32 sums taken in another
    order)."""
    vals = corpus(5000)
    live = np.arange(0, 5000, 2)
    cents = jivf.train_centroids(vals[:3000].astype(np.float32), 32, iters=4, chunk=1000)
    want = jivf.assign_rows(vals, live, cents, top2=top2, chunk=700)
    got = tivf.assign_rows(
        vals, live, tivf.centroids_from_reference(np.asarray(cents), device="cpu"),
        top2=top2, chunk=700,
    )
    assert got.shape == want.shape and got.dtype == np.int32
    c64 = np.asarray(cents, dtype=np.float64)
    bad = np.argwhere(got != want)
    for i, *j in bad:
        x = vals[live[i]]
        col = j[0] if j else None
        g = got[i, col] if top2 else got[i]
        w = want[i, col] if top2 else want[i]
        d_g = np.sum((x - c64[g]) ** 2)
        d_w = np.sum((x - c64[w]) ** 2)
        assert abs(d_g - d_w) <= 1e-6 * max(d_g, d_w), (i, g, w)
    assert len(bad) <= 1e-3 * got.size


def test_train_centroids_quality_and_no_dead_centroid():
    """The generators differ: the port's trainer is held to the JAX
    trainer's inertia within 10% on the same sample, with every centroid
    owning rows."""
    sample = corpus(4000, clusters=24).astype(np.float32)
    c = 32
    j_c = np.asarray(jivf.train_centroids(sample, c, iters=8, chunk=1000))
    t_c = tivf.train_centroids(sample, c, iters=8, chunk=1000, device="cpu")
    assert t_c.shape == (c, D) and t_c.dtype == torch.float32

    def inertia(cents):
        d2 = ((sample[:, None, :].astype(np.float64) - cents[None]) ** 2).sum(-1)
        a = d2.argmin(1)
        return float(d2[np.arange(len(sample)), a].sum()), np.bincount(a, minlength=c)

    j_in, _ = inertia(j_c)
    t_in, counts = inertia(t_c.numpy().astype(np.float64))
    assert t_in <= 1.10 * j_in, (t_in, j_in)
    assert (counts > 0).all()


def test_train_centroids_refuses_a_small_sample():
    with pytest.raises(ValueError, match="sample >= C"):
        tivf.train_centroids(np.zeros((10, 4), np.float32), 16)


def test_train_centroids_defaults_to_the_card(monkeypatch):
    """Without ``device`` the trainer resolves the card as every entry of
    the port does: with none it raises the port's error naming
    device='cpu', and never trains on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sample = corpus(256, clusters=4).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        tivf.train_centroids(sample, 8, iters=1, chunk=128)
    out = tivf.train_centroids(sample, 8, iters=1, chunk=128, device="cpu")
    assert out.device.type == "cpu" and out.shape == (8, D)


def test_centroids_from_reference():
    cents = np.arange(12, dtype=np.float64).reshape(3, 4)
    out = tivf.centroids_from_reference(cents, device="cpu")
    assert out.dtype == torch.float32 and out.is_contiguous()
    assert np.array_equal(out.numpy(), cents.astype(np.float32))
    with pytest.raises(ValueError, match=r"\[C, D\]"):
        tivf.centroids_from_reference(cents.reshape(-1), device="cpu")


# ----------------------------------------------------------------- K6


def probe_inputs(dtype, d, seed=2, c=8, p=128, b=5, l_probe=3):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        rows = rng.integers(-127, 128, (c * p, d)).astype(np.int8)
        j_rows, t_rows = jnp.asarray(rows), t(rows)
    else:
        j_rows, t_rows = bf16_pair(rng.normal(size=(c * p, d)).astype(np.float32))
    ids = rng.integers(0, c, (b, l_probe)).astype(np.int32)
    ids[0, :] = ids[0, 0]  # a query that probes one cell repeatedly
    q = rng.normal(size=(b, d)).astype(np.float32)
    return j_rows, t_rows, ids, q, p


@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_gather_score_plain_matches_reference(dtype, d):
    """gather_score_plain against the reference's Pallas kernel in
    interpret mode and its XLA formulation: atol 1e-5 (f32 sums of the
    same products taken in another order)."""
    j_rows, t_rows, ids, q, p = probe_inputs(dtype, d)
    got = tivf.gather_score_plain(t_rows, t(ids), t(q), p_width=p).numpy()
    want_x = np.asarray(jivf.gather_score_xla(j_rows, jnp.asarray(ids), jnp.asarray(q), p_width=p))
    want_p = np.asarray(jivf.gather_score_pallas(
        j_rows, jnp.asarray(ids), jnp.asarray(q), p_width=p, interpret=True))
    assert got.shape == (ids.shape[0], ids.shape[1], p) and got.dtype == np.float32
    scale = max(1.0, float(np.abs(want_x).max()))
    np.testing.assert_allclose(got, want_x, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, want_p, rtol=0, atol=1e-5 * scale)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        tivf.gather_score_pallas(t_rows, t(ids), t(q), p_width=p).numpy(), got)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_gather_score_plain_matches_reference_on_shared_cells(dtype):
    """Every query probes the same cells in its own order, one of them
    twice (the pairs K6 scores in one pass over each cell): the plain
    probe against the reference's Pallas kernel in interpret mode."""
    j_rows, t_rows, ids, q, p = probe_inputs(dtype, 64, b=6, l_probe=4)
    rng = np.random.default_rng(9)
    cells = np.array([3, 5, 0, 3], dtype=np.int32)
    ids = np.stack([rng.permutation(cells) for _ in range(len(ids))]).astype(np.int32)
    got = tivf.gather_score_plain(t_rows, t(ids), t(q), p_width=p).numpy()
    want = np.asarray(jivf.gather_score_pallas(
        j_rows, jnp.asarray(ids), jnp.asarray(q), p_width=p, interpret=True))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def meta_probe(**change):
    c, p, d, b, l_probe = 8, 128, 64, 4, 3
    inp = dict(
        part_rows=torch.zeros((c * p, d), dtype=torch.bfloat16, device="meta"),
        part_ids=torch.zeros((b, l_probe), dtype=torch.int32, device="meta"),
        queries=torch.zeros((b, d), device="meta"),
    )
    inp.update(change)
    return inp, p


def test_cuda_side_tensors_never_reach_the_plain_probe(monkeypatch):
    """Off the CPU the wrapper launches K6 or raises: there is no plain
    fallback for a device tensor."""
    calls = []
    monkeypatch.setattr(tivf, "gather_score_plain", lambda *a, **k: calls.append(1))
    inp, p = meta_probe()
    with pytest.raises(ValueError, match="no kernel"):
        tivf.gather_score_pallas(**inp, p_width=p)
    assert calls == []


@pytest.mark.parametrize(
    "change, p_width, match",
    [
        (dict(part_rows=torch.zeros((1024, 64), device="meta")), 128, "bf16 or int8"),
        (dict(part_rows=torch.zeros((64, 1024), dtype=torch.bfloat16, device="meta").T),
         128, "contiguous"),
        ({}, 100, "multiple of p_width"),
        (dict(part_ids=torch.zeros((4, 3), dtype=torch.int64, device="meta")), 128, "int32"),
        (dict(queries=torch.zeros((4, 63), device="meta")), 128, "queries"),
        (dict(part_ids=torch.zeros((70000, 1), dtype=torch.int32, device="meta"),
              queries=torch.zeros((70000, 64), device="meta")), 128, "65,535"),
    ],
    ids=["rows-dtype", "rows-layout", "p-width", "ids-dtype", "queries-shape", "batch"],
)
def test_cuda_wrapper_checks_its_operands(change, p_width, match, monkeypatch):
    """The CUDA wrapper checks type, shape and layout before it launches;
    a fake CUDA device lets the checks run here."""
    inp, _ = meta_probe(**change)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    before = tivf.GATHER_SCORE.launches
    with pytest.raises(ValueError, match=match):
        tivf.gather_score_cuda(**inp, p_width=p_width)
    assert tivf.GATHER_SCORE.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_search_wrapper_launches_layouts_past_2_31_elements(dtype, monkeypatch):
    """A 2M-row layout at D = 1536 (C 4,096 x P 640: C * P * D > 2^31)
    passes the wrapper's checks and reaches the launch; the kernel indexes
    in 64 bits. The search's wrapper reads nothing back from the device
    (meta ids would fail any read), so it queues K6 without a host sync."""
    c, p, d, b, l_probe = 4096, 640, 1536, 64, 16
    assert c * p * d > 1 << 31
    inp, _ = meta_probe(
        part_rows=torch.zeros((c * p, d), dtype=dtype, device="meta"),
        part_ids=torch.zeros((b, l_probe), dtype=torch.int32, device="meta"),
        queries=torch.zeros((b, d), device="meta"),
    )
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    launched = []

    def launch(rows, ids, q_op, *, p_width):
        launched.append((tuple(rows.shape), tuple(q_op.shape), q_op.dtype, p_width))
        return "launched"

    monkeypatch.setattr(tivf, "launch_gather_score", launch)
    assert tivf.gather_score_pallas(**inp, p_width=p) == "launched"
    assert launched == [((c * p, d), (b, d), torch.float32, p)]


def test_cuda_wrapper_checks_the_partition_ids(monkeypatch):
    """Out-of-range cell ids are refused before a launch (the kernel
    would read outside the layout)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    rows = torch.zeros((8 * 128, 64), dtype=torch.bfloat16)
    q = torch.zeros((2, 64))
    for bad in (8, -1):
        ids = torch.tensor([[0, 1], [2, bad]], dtype=torch.int32)
        with pytest.raises(ValueError, match=r"\[0, 8\)"):
            tivf.gather_score_cuda(rows, ids, q, p_width=128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_gather_score_kernel_matches_plain_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("K6 is CUDA C++ and runs only on an NVIDIA card")
    _, t_rows, ids, q, p = probe_inputs(dtype, 384, c=16, p=640, b=64, l_probe=16)
    dev = torch.device("cuda")
    args = (t_rows.to(dev), t(ids).to(dev), t(q).to(dev))
    got = tivf.gather_score_cuda(*args, p_width=p)
    want = tivf.gather_score_plain(*args, p_width=p)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale


# -------------------------------------------------------- exact re-score


@pytest.mark.parametrize("mode", ["live_hi", "valid", "int8"])
@pytest.mark.parametrize("metric", METRICS)
def test_exact_rescore_device_matches_reference(metric, mode):
    """Duplicates in the pool (slot 0 among them), a live watermark
    against a validity gather, and int8 rows with their scales."""
    rng = np.random.default_rng(3)
    cap, d, b = 512, 32, 6
    vals = rng.normal(size=(cap, d)).astype(np.float32)
    vals[300:] = 0.0  # past the watermark
    pool = rng.integers(0, 320, (b, 40)).astype(np.int32)
    pool[:, :5] = 0  # clamped pads
    pool[:, 5:8] = pool[:, 8:11]  # duplicates
    pool[1, :] = 7  # one slot only
    q = rng.normal(size=(b, d)).astype(np.float32)
    q[2] = vals[0] + 0.5 * rng.normal(size=d)  # slot 0 is a near neighbour
    valid = np.ones(cap, bool)
    valid[rng.choice(300, 40, replace=False)] = False
    valid[300:] = False
    scales = None
    j_vals, t_vals = jnp.asarray(vals), t(vals)
    if mode == "int8":
        codes, scales = tflat._quantize_rows_int8_np(vals)
        j_vals, t_vals = jnp.asarray(codes), t(codes)
    use_valid = mode != "live_hi"
    js, ji = jamk._exact_rescore_device(
        jnp.asarray(pool), j_vals, jnp.asarray(valid) if use_valid else None,
        jnp.asarray(q), JM[metric], 16, jnp.int32(300),
        row_scales=None if scales is None else jnp.asarray(scales),
    )
    ts, ti = tamk._exact_rescore_device(
        t(pool), t_vals, t(valid) if use_valid else None, t(q), TM[metric], 16,
        300, row_scales=None if scales is None else t(scales),
    )
    js, ji, ts, ti = np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy()
    assert_same_topk(js, ji, ts, ti, metric, q, vals)
    for row_i, row_s in zip(ti, ts):
        live = row_i[row_s != -np.inf]
        assert len(set(live.tolist())) == len(live)  # never a slot twice
        if use_valid:
            assert valid[live].all()
        assert (live < 300).all()
    assert (ts[1, 1:] == -np.inf).all()  # a pool of one slot yields one hit


def test_matmul_operand_rule():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    v = rng.normal(size=(20, 16)).astype(np.float32)
    j_v, t_v = bf16_pair(v)
    np.testing.assert_allclose(
        tamk._matmul(t(q), t_v).numpy(), np.asarray(jamk._matmul(jnp.asarray(q), j_v)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tamk._matmul(t(q), t(v)).numpy(),
        np.asarray(jamk._matmul(jnp.asarray(q), jnp.asarray(v))), rtol=1e-5, atol=1e-5)
    sq = np.einsum("nd,nd->n", v, v)
    dot = (q @ v.T).astype(np.float32)
    for m in METRICS:
        np.testing.assert_allclose(
            tamk._rank_scores(t(dot), TM[m], t(sq)).numpy(),
            np.asarray(jamk._rank_scores(jnp.asarray(dot), JM[m], jnp.asarray(sq))),
            rtol=1e-6)


# ------------------------------------------------------------ search


def search_inputs(layout, tombstones, metric_seed=0):
    """One carried layout mirrored from FlatIndex._ivf_build: 1,900 rows in
    16 cells (pad factor 1.0, so full cells spill and extras remain), a
    tail of 100 rows whose 256-row bucket overhangs the 2,048-row buffer
    (the clamped start), and, with ``tombstones``, deletes in the cells,
    the extras and the tail. Returns (JAX args, port args, statics)."""
    rng = np.random.default_rng(7)
    cap, n_build, size, c = 2048, 1900, 2000, 16
    vals = np.zeros((cap, D))
    vals[:size] = corpus(size, seed=11, clusters=8)
    valid = np.zeros(cap, bool)
    valid[:size] = True
    if tombstones:
        valid[rng.choice(size, 120, replace=False)] = False
        valid[[0, 1950]] = True
    live = np.flatnonzero(valid[:n_build])
    cents = jivf.train_centroids(vals[:n_build].astype(np.float32), c, iters=4, chunk=500)
    assign2 = jivf.assign_rows(vals, live, cents, top2=True)
    part_slots, extra_slots = jivf.build_layout(assign2, live, c, pad_factor=1.0)
    p_width = part_slots.shape[1]
    ps = part_slots.reshape(-1)
    assert len(extra_slots) > 0 and (ps < 0).any()
    rows32 = vals[np.maximum(ps, 0)].astype(np.float32)
    rows32[ps < 0] = 0.0
    e = len(extra_slots)
    e_pad = max(128, next_pow2(e))
    ex32 = np.zeros((e_pad, D), np.float32)
    ex32[:e] = vals[extra_slots]
    ex_slots = np.zeros(e_pad, np.int32)
    ex_slots[:e] = extra_slots
    ex_valid = np.zeros(e_pad, bool)
    ex_valid[:e] = valid[extra_slots]
    vals32 = vals.astype(np.float32)
    quant = tflat._quantize_rows_int8_np
    if layout == "int8":
        # the int8 rung: int8 layout, int8 storage dequantized by its scales
        p8, p_sc = quant(rows32)
        e8, e_sc = quant(ex32)
        v8, v_sc = quant(vals32)
        j_rows, t_rows = jnp.asarray(p8), t(p8)
        j_ex, t_ex = jnp.asarray(e8), t(e8)
        j_vals, t_vals = jnp.asarray(v8), t(v8)
        scales = (p_sc, e_sc, v_sc)
    else:
        j_rows, t_rows = bf16_pair(rows32)
        j_ex, t_ex = bf16_pair(ex32)
        j_vals, t_vals = jnp.asarray(vals32), t(vals32)
        scales = (None, None, None)
    tables = dict(
        part_slots=ps.astype(np.int32),
        part_sqnorms=np.einsum("nd,nd->n", rows32, rows32),
        part_valid=(ps >= 0) & valid[np.maximum(ps, 0)],
        centroids=np.asarray(cents),
        cent_sqnorms=np.asarray(jnp.sum(cents * cents, axis=1)),
        extra_slots=ex_slots,
        extra_sqnorms=np.einsum("nd,nd->n", ex32, ex32),
        extra_valid=ex_valid,
        valid=valid,
    )
    q = np.concatenate([
        vals[[0, 1950, int(extra_slots[0]), 5]] + 0.01 * rng.normal(size=(4, D)),
        corpus(4, seed=12, clusters=8),
    ]).astype(np.float32)
    order = ["part_slots", "part_sqnorms", "part_valid", "centroids", "cent_sqnorms"]
    ex_order = ["extra_slots", "extra_sqnorms", "extra_valid"]
    j_args = (
        [j_rows] + [jnp.asarray(tables[k]) for k in order] + [j_ex]
        + [jnp.asarray(tables[k]) for k in ex_order]
        + [j_vals, jnp.asarray(valid), jnp.asarray(q), jnp.int32(n_build), jnp.int32(size)]
        + [None if s is None else jnp.asarray(s) for s in scales]
    )
    t_args = (
        [t_rows] + [t(tables[k]) for k in order] + [t_ex]
        + [t(tables[k]) for k in ex_order]
        + [t_vals, t(valid), t(q), n_build, size]
        + [None if s is None else t(s) for s in scales]
    )
    statics = dict(k=16, k_sel=128, nprobe=4, p_width=p_width, tail_pad=256,
                   tombstones=tombstones)
    return j_args, t_args, statics, vals


@pytest.mark.parametrize("tombstones", [True, False], ids=["tombstones", "live-prefix"])
@pytest.mark.parametrize("layout", ["bf16", "int8"])
@pytest.mark.parametrize("metric", METRICS)
def test_ivf_search_matches_reference(metric, layout, tombstones):
    """ivf_search_topk_rescored against the reference's with its Pallas
    probe in interpret mode: slots equal beyond 1e-5 near-ties, scores
    within 2e-6 relative. Query 0 sits on slot 0, which the clamped -1
    pads also name, so the re-score's dedupe decides whether it comes
    back once."""
    j_args, t_args, st, vals = search_inputs(layout, tombstones)
    js, ji = jivf.ivf_search_topk_rescored(
        *j_args, metric=JM[metric], use_pallas=True, interpret=True, **st)
    ts, ti = tivf.ivf_search_topk_rescored(*t_args, metric=TM[metric], **st)
    js, ji, ts, ti = np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy()
    assert_same_topk(js, ji, ts, ti, metric, t_args[12].numpy(), vals)
    for row in ti:
        assert (row == 0).sum() <= 1
    assert ti[0, 0] == 0 and ti[1, 0] == 1950  # slot 0 and a tail row
    valid = t_args[11].numpy()
    assert valid[ti[ts != -np.inf]].all()


def test_ivf_search_probes_through_the_wrapper(monkeypatch):
    """The search's probe goes through gather_score_pallas (the name the
    kernel routing lives under), with int32 cell ids."""
    seen = []
    real = tivf.gather_score_pallas

    def spy(rows, ids, q, *, p_width):
        seen.append((ids.dtype, tuple(ids.shape), p_width))
        return real(rows, ids, q, p_width=p_width)

    monkeypatch.setattr(tivf, "gather_score_pallas", spy)
    _, t_args, st, _ = search_inputs("bf16", True)
    tivf.ivf_search_topk_rescored(*t_args, metric=TM.COSINE, **st)
    assert seen == [(torch.int32, (8, 4), st["p_width"])]


# ---------------------------------------------------------- FlatIndex


def carry_centroids(monkeypatch, j):
    """Patch the port's trainer to hand over the JAX index's centroids."""
    carried = []

    def trainer(sample32, c, **kw):
        carried.append(c)
        return tivf.centroids_from_reference(np.asarray(j._ivf_centroids), device="cpu")

    monkeypatch.setattr(tivf, "train_centroids", trainer)
    return carried


def ivf_pair(monkeypatch, rows, **kw):
    """A JAX FlatIndex with its IVF layout built, and the port's with the
    JAX centroids carried across, both synced."""
    ids = np.arange(len(rows), dtype=np.uint64)
    j = JFlat(D, **kw)
    j.add_batch_arrays(ids, rows)
    j.search_batch(rows[:1], k=1, metric=JM.COSINE)  # builds the layout
    assert j._ivf_active
    carried = carry_centroids(monkeypatch, j)
    port = FlatIndex(D, device="cpu", **kw)
    port.add_batch_arrays(ids, rows)
    port._sync_device()
    return j, port, carried


def spy_on(monkeypatch, calls, module, name):
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)


def ivf_served(monkeypatch, idx):
    """One entry per call of ``idx._ivf_topk``: True when IVF served the
    batch, False when it fell through to the brute engines."""
    served = []
    real = idx._ivf_topk

    def spy(*args, **kw):
        out = real(*args, **kw)
        served.append(out is not None)
        return out

    monkeypatch.setattr(idx, "_ivf_topk", spy)
    return served


def search_each(idx, q, k, metric, per_call=1):
    """search_batch in batches of ``per_call`` queries: at test scale
    (4,096 rows, P = 128, nprobe 8-16) IVF serves one or two queries a
    batch (B * nprobe * P <= live / 2)."""
    out = []
    for lo in range(0, len(q), per_call):
        out += idx.search_batch(np.asarray(q[lo : lo + per_call]), k=k, metric=metric)
    return out


@pytest.mark.parametrize("dtype", ["auto", "int8"], ids=["bf16-layout", "int8-rung"])
@pytest.mark.parametrize("metric", METRICS)
def test_index_ivf_parity(metric, dtype, monkeypatch):
    """Same layout as the JAX index (carried centroids), the same
    ``_ivf_topk`` results with a tail and tombstones, and the port's
    public search served by its ``_ivf_topk``."""
    rows = corpus(6000)
    for vid in (5, 70, 4000):
        rows[vid] = rows[vid + 1]  # exact duplicates: tied scores
    j, port, carried = ivf_pair(monkeypatch, rows, device_dtype=dtype)
    assert carried == [128]
    assert port._ivf_active and port._ivf_p == j._ivf_p
    np.testing.assert_array_equal(port._ivf_slots_np, j._ivf_slots_np)
    np.testing.assert_array_equal(port._ivf_extra_slots_np, j._ivf_extra_slots_np)
    assert len(port._ivf_extra_slots_np) > 0
    assert port._ivf_nprobe_floor == j._ivf_nprobe_floor
    assert (port._ivf_rows.dtype == torch.int8) == (dtype == "int8")
    assert (port._ivf_rows.dtype == torch.int8) == (np.asarray(j._ivf_rows).dtype == np.int8)
    # a tail and tombstones (in the cells, the extras and the tail), both
    more = corpus(64, seed=21)
    extra_id = int(j._ivf_extra_slots_np[0])
    deleted = [3, 77, 6000 + 1, extra_id]
    for index in (j, port):
        index.add_batch_arrays(np.arange(6000, 6064, dtype=np.uint64), more)
        for vid in deleted:
            index.delete(vid)
    j.search_batch(rows[:1], k=1, metric=JM.COSINE)  # the JAX sync
    port._sync_device()
    assert port._ivf_hi == j._ivf_hi == 6000
    rng = np.random.default_rng(5)
    q = np.concatenate([rows[rng.integers(0, 6000, 10)], rows[[4, extra_id]], more[:4]])
    q = q + 0.3 * rng.normal(size=q.shape)
    q32 = q.astype(np.float32)
    k_pad = 32 if dtype == "int8" else 16  # _selection_k of k = 10
    served = ivf_served(monkeypatch, port)
    calls = []
    for name in ("pallas_search_topk", "pallas_search_topk_int8",
                 "pallas_search_block_topk_rescored", "pallas_search_block_topk_int8"):
        spy_on(monkeypatch, calls, tflat.scan, name)
    all_rows = np.concatenate([rows, more])
    for lo in range(len(q)):
        js, ji = j._ivf_topk(jnp.asarray(q32[lo : lo + 1]), k_pad, JM[metric])
        ts, ti = port._ivf_topk(torch.from_numpy(q32[lo : lo + 1]), k_pad, TM[metric])
        assert_same_topk(np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy(),
                         metric, q32[lo : lo + 1], all_rows)
        # the public search goes through _ivf_topk and returns its winners
        ids, _ = port.search_batch_arrays(q[lo : lo + 1], 10, TM[metric])
        assert calls == []
        # ... as the JAX index's own post-fetch step (the f64 re-score on
        # the int8 rung) turns the JAX _ivf_topk's winners into ids
        _, f_slots = j._finalize_device(
            q[lo : lo + 1], np.asarray(js), np.asarray(ji), 10, JM[metric])
        np.testing.assert_array_equal(ids, j._ids[f_slots].astype(np.int64))
        assert not set(deleted) & set(ids.ravel().tolist())
    assert served == [True] * 32


def test_index_search_scores_are_exact(monkeypatch):
    """On the f32 rung the IVF path returns the exact f32 re-scored values;
    on the int8 rung the host f64 re-score gives the formula's value."""
    rows = corpus(4096)
    q = rows[:8] + 0.01
    for dtype, tol in (("auto", 2e-6), ("int8", 1e-9)):
        port = FlatIndex(D, device="cpu", device_dtype=dtype)
        port.add_batch_arrays(np.arange(4096, dtype=np.uint64), rows)
        served = ivf_served(monkeypatch, port)
        res = search_each(port, q, 10, TM.COSINE)
        assert port._ivf_active and served == [True] * 8
        for i in range(len(q)):
            for r in res[i]:
                s = exact_topk(rows[r.id : r.id + 1], q[i], 1, TM.COSINE)[1][0]
                assert abs(r.score - s) < tol


def test_ivf_off_the_card_needs_the_force_switch(monkeypatch):
    monkeypatch.delenv("VECTORLITE_IVF_FORCE")
    rows = corpus(3000)
    port = FlatIndex(D, device="cpu")
    port.add_batch_arrays(np.arange(3000, dtype=np.uint64), rows)
    port.search_batch(rows[:1], k=1, metric=TM.COSINE)
    assert not port._ivf_active and port._ivf_rows is None


def test_pq_profile_never_builds_ivf(monkeypatch):
    monkeypatch.setenv("VECTORLITE_PQ_MIN_ROWS", "1024")
    rows = corpus(3000)
    port = FlatIndex(D, device="cpu", device_dtype="pq")
    port.add_batch_arrays(np.arange(3000, dtype=np.uint64), rows)
    port.search_batch(rows[:8], k=1, metric=TM.COSINE)
    assert port._pq_active and not port._ivf_active


def test_where_filter_bypasses_ivf(monkeypatch):
    rows = corpus(3000)
    port = FlatIndex(D, device="cpu")
    port.add_batch_arrays(np.arange(3000, dtype=np.uint64), rows,
                          metadatas=[{"g": i % 2} for i in range(3000)])
    port.search_batch(rows[:1], k=1, metric=TM.COSINE)
    assert port._ivf_active
    served = ivf_served(monkeypatch, port)
    res = port.search_batch(rows[:1], k=5, metric=TM.COSINE, where={"g": 1})
    assert served == [] and all(r.id % 2 == 1 for row in res for r in row)


def test_client_default_profile_serves_through_ivf(monkeypatch):
    """A default-profile collection past the (lowered) gate serves its
    searches through _ivf_topk."""
    client = VectorLiteClient(MockEmbeddingFunction(D), device="cpu")
    client.create_collection("c", "flat")
    rows = corpus(4096)
    client.add_vectors_to_collection("c", rows)
    with client.get_collection("c").index_read() as index:
        served = ivf_served(monkeypatch, index)
    hits = client.search_vectors_in_collection("c", rows[[3]] + 0.001, 2)
    assert [h[0].id for h in hits] == [3]
    assert served == [True]
    with client.get_collection("c").index_read() as index:
        assert index._ivf_active and index._ivf_rows.dtype == torch.bfloat16


# ------------------------------- behavioural cases of tests/test_ivf.py


def probe_all(idx, q, metric, k):
    """The index's IVF step with nprobe = C (every cell), past the batch
    gate of _ivf_topk, which a full probe never passes."""
    ex_rows, ex_slots, ex_sq, ex_valid, ex_scales = idx._ivf_extra
    c = int(idx._ivf_cent_sq.shape[0])
    s, slots = tivf.ivf_search_topk_rescored(
        idx._ivf_rows, idx._ivf_slots, idx._ivf_sq, idx._ivf_valid,
        idx._ivf_centroids, idx._ivf_cent_sq, ex_rows, ex_slots, ex_sq, ex_valid,
        idx._dev_values, idx._dev_valid, torch.from_numpy(q.astype(np.float32)),
        idx._ivf_hi, idx._size, part_scales=idx._ivf_scales, extra_scales=ex_scales,
        metric=metric, k=k, k_sel=128, nprobe=c, p_width=idx._ivf_p, tail_pad=0,
        tombstones=False,
    )
    return s.numpy(), slots.numpy()


@pytest.mark.parametrize("metric", [TM.COSINE, TM.EUCLIDEAN, TM.DOT_PRODUCT])
def test_full_probe_matches_exact(metric, monkeypatch):
    """nprobe == C probes everything: ids must match the f64 scan, through
    the public search (which falls through to the brute engine, as a full
    probe reads more than half the corpus) and through the IVF step."""
    vals = corpus(3000)
    idx = FlatIndex(D, device="cpu")
    idx.add_batch_arrays(np.arange(3000, dtype=np.uint64), vals)
    q = corpus(6, seed=9)
    monkeypatch.setenv("VECTORLITE_IVF_NPROBE", "1000000")
    served = ivf_served(monkeypatch, idx)
    res = idx.search_batch(q, k=10, metric=metric)
    assert idx._ivf_active and served == [False]
    s, slots = probe_all(idx, q, metric, 10)
    for i in range(len(q)):
        truth_ids, truth_scores = exact_topk(vals, q[i], 10, metric)
        assert [r.id for r in res[i]] == truth_ids.tolist()
        np.testing.assert_allclose([r.score for r in res[i]], truth_scores, rtol=2e-6)
        assert slots[i].tolist() == truth_ids.tolist()
        np.testing.assert_allclose(s[i], truth_scores, rtol=2e-6)


def test_index_recall_and_exact_scores(monkeypatch):
    vals = corpus(4096)
    idx = FlatIndex(D, device="cpu")
    idx.add_batch_arrays(np.arange(4096, dtype=np.uint64), vals)
    q = vals[:8] + 0.01  # near-duplicate queries
    served = ivf_served(monkeypatch, idx)
    res = search_each(idx, q, 10, TM.COSINE)
    assert idx._ivf_active and served == [True] * 8
    hits = 0
    for i in range(len(q)):
        truth_ids, _ = exact_topk(vals, q[i], 10, TM.COSINE)
        hits += len({r.id for r in res[i]} & set(truth_ids.tolist()))
        for r in res[i]:
            s = exact_topk(vals[r.id : r.id + 1], q[i], 1, TM.COSINE)[1][0]
            assert abs(r.score - s) < 2e-6
    assert hits / (10 * len(q)) >= 0.95


def test_tail_inserts_are_found_immediately(monkeypatch):
    vals = corpus(3000)
    idx = FlatIndex(D, device="cpu")
    idx.add_batch_arrays(np.arange(3000, dtype=np.uint64), vals)
    idx.search_batch(vals[:1], k=1, metric=TM.COSINE)  # build layout
    assert idx._ivf_active
    hi = idx._ivf_hi
    new = 7.0 * np.ones(D)
    idx.add(Vector(id=99999, values=new.tolist(), text=""))
    served = ivf_served(monkeypatch, idx)
    res = idx.search_batch(new[None, :], k=1, metric=TM.COSINE)
    assert idx._ivf_hi == hi  # layout untouched: the row rode the tail
    assert res[0][0].id == 99999 and served == [True]


def test_tail_overflow_triggers_rebuild():
    vals = corpus(2500)
    idx = FlatIndex(D, device="cpu")
    idx.add_batch_arrays(np.arange(2500, dtype=np.uint64), vals)
    idx.search_batch(vals[:1], k=1, metric=TM.COSINE)
    first_hi = idx._ivf_hi
    idx.add_batch_arrays(np.arange(10000, 10600, dtype=np.uint64), corpus(600, seed=5))
    idx.search_batch(vals[:1], k=1, metric=TM.COSINE)
    assert idx._ivf_hi > first_hi  # tail outgrew its budget: rebuilt


def test_capacity_growth_rebuilds_through_the_dirty_range():
    vals = corpus(4096)
    idx = FlatIndex(D, device="cpu")
    idx.add_batch_arrays(np.arange(4096, dtype=np.uint64), vals)
    idx.search_batch(vals[:1], k=1, metric=TM.COSINE)
    cents, rows = idx._ivf_centroids, idx._ivf_rows
    idx.add_batch_arrays(np.arange(5000, 5010, dtype=np.uint64), corpus(10, seed=8))
    res = idx.search_batch(vals[:1], k=1, metric=TM.COSINE)
    assert idx._capacity == 8192 and idx._ivf_rows is not rows
    assert idx._ivf_hi == 4106 and idx._ivf_centroids is cents  # same C
    assert res[0][0].id == 0


def test_deletes_and_compaction(monkeypatch):
    vals = corpus(3000)
    idx = FlatIndex(D, device="cpu")
    idx.add_batch_arrays(np.arange(3000, dtype=np.uint64), vals)
    q = vals[42][None, :]
    res = idx.search_batch(q, k=1, metric=TM.COSINE)
    assert res[0][0].id == 42
    served = ivf_served(monkeypatch, idx)
    idx.delete(42)
    res = idx.search_batch(q, k=5, metric=TM.COSINE)
    assert all(r.id != 42 for r in res[0])
    idx.compact()
    assert not idx._ivf_active  # compaction renumbered the slots
    res = idx.search_batch(q, k=5, metric=TM.COSINE)
    assert idx._ivf_active and served == [True, True]
    assert all(r.id != 42 for r in res[0])
    assert len(res[0]) == 5


def test_ivf_disabled_below_gate(monkeypatch):
    monkeypatch.setenv("VECTORLITE_IVF_MIN_ROWS", "1000000")
    vals = corpus(2500)
    idx = FlatIndex(D, device="cpu")
    idx.add_batch_arrays(np.arange(2500, dtype=np.uint64), vals)
    idx.search_batch(vals[:1], k=1, metric=TM.COSINE)
    assert not idx._ivf_active


def test_ivf_switch_off_drops_the_layout(monkeypatch):
    vals = corpus(2500)
    idx = FlatIndex(D, device="cpu")
    idx.add_batch_arrays(np.arange(2500, dtype=np.uint64), vals)
    idx.search_batch(vals[:1], k=1, metric=TM.COSINE)
    assert idx._ivf_active
    monkeypatch.setenv("VECTORLITE_IVF", "0")
    idx.search_batch(vals[:1], k=1, metric=TM.COSINE)
    assert not idx._ivf_active and idx._ivf_rows is None
    assert idx._ivf_centroids is not None  # survives the drop


def test_ivf_skips_oversized_batches(monkeypatch):
    """A batch big enough that probes exceed half the corpus falls through
    to the brute engine (and still answers correctly)."""
    vals = corpus(2100)
    idx = FlatIndex(D, device="cpu")
    idx.add_batch_arrays(np.arange(2100, dtype=np.uint64), vals)
    q = np.asarray(corpus(64, seed=3))
    served = ivf_served(monkeypatch, idx)
    res = idx.search_batch(q, k=5, metric=TM.COSINE, approx=True)
    assert idx._ivf_active and served == [False]
    for i in (0, 63):
        truth_ids, _ = exact_topk(vals, q[i], 5, TM.COSINE)
        assert [r.id for r in res[i]] == truth_ids.tolist()


def test_manhattan_bypasses_ivf(monkeypatch):
    vals = corpus(2500)
    idx = FlatIndex(D, device="cpu")
    idx.add_batch_arrays(np.arange(2500, dtype=np.uint64), vals)
    served = ivf_served(monkeypatch, idx)
    res = idx.search_batch(vals[7][None, :], k=3, metric=TM.MANHATTAN)
    assert res[0][0].id == 7 and served == [] and idx._ivf_active


def test_guard_refuses_iid_highdim():
    """iid gaussian in high-D has no cell locality: the guard keeps IVF
    off and the brute engine serves exact results."""
    rng = np.random.default_rng(5)
    d = 128
    vals = rng.standard_normal((4000, d))
    idx = FlatIndex(d, device="cpu")
    idx.add_batch_arrays(np.arange(4000, dtype=np.uint64), vals)
    q = vals[3][None, :]
    res = idx.search_batch(q, k=5, metric=TM.COSINE, approx=False)
    assert not idx._ivf_active
    assert idx._ivf_refused_at == 4000
    truth_ids, _ = exact_topk(vals, q[0], 5, TM.COSINE)
    assert [r.id for r in res[0]] == truth_ids.tolist()


def test_guard_refusal_cache_skips_rebuild_until_doubling(monkeypatch):
    rng = np.random.default_rng(6)
    d = 128
    vals = rng.standard_normal((4000, d))
    idx = FlatIndex(d, device="cpu")
    idx.add_batch_arrays(np.arange(4000, dtype=np.uint64), vals)
    idx.search_batch(vals[:1], k=1, metric=TM.COSINE)
    assert idx._ivf_refused_at == 4000
    calls = []
    monkeypatch.setattr(idx, "_ivf_build", lambda: calls.append(1))
    idx.add_batch_arrays(np.arange(4000, 4100, dtype=np.uint64),
                         rng.standard_normal((100, d)))
    idx.search_batch(vals[:1], k=1, metric=TM.COSINE)
    assert not calls
    idx.add_batch_arrays(np.arange(4100, 8200, dtype=np.uint64),
                         rng.standard_normal((4100, d)))
    idx.search_batch(vals[:1], k=1, metric=TM.COSINE)
    assert calls


def test_guard_passes_clustered_and_disabled_env(monkeypatch):
    vals = corpus(4096)
    idx = FlatIndex(D, device="cpu")
    idx.add_batch_arrays(np.arange(4096, dtype=np.uint64), vals)
    idx.search_batch(vals[:1], k=1, metric=TM.COSINE)
    assert idx._ivf_active and idx._ivf_refused_at == 0

    monkeypatch.setenv("VECTORLITE_IVF_GUARD", "0")
    rng = np.random.default_rng(7)
    iid = rng.standard_normal((4000, 128))
    idx2 = FlatIndex(128, device="cpu")
    idx2.add_batch_arrays(np.arange(4000, dtype=np.uint64), iid)
    idx2.search_batch(iid[:1], k=1, metric=TM.COSINE)
    assert idx2._ivf_active


def test_guard_nprobe_floor_raises_serving_width(monkeypatch):
    """When only a wider probe window clears the recall bar, the guard
    raises the serving nprobe floor rather than refuse; the port reaches
    the JAX index's floor on the same layout, and serves at it."""
    monkeypatch.setenv("VECTORLITE_IVF_NPROBE", "1")
    vals = corpus(4096, clusters=64)
    j, port, _ = ivf_pair(monkeypatch, vals)
    assert port._ivf_nprobe_floor == j._ivf_nprobe_floor > 1
    q = vals[:8] + 0.01
    seen = []
    real = tivf.ivf_search_topk_rescored
    monkeypatch.setattr(
        tivf, "ivf_search_topk_rescored",
        lambda *a, **kw: seen.append(kw["nprobe"]) or real(*a, **kw),
    )
    res = search_each(port, q, 10, TM.COSINE, per_call=2)
    assert seen == [port._ivf_nprobe_floor] * 4
    hits = 0
    for i in range(len(q)):
        truth_ids, _ = exact_topk(vals, q[i], 10, TM.COSINE)
        hits += len({r.id for r in res[i]} & set(truth_ids.tolist()))
    assert hits / (10 * len(q)) >= 0.9


def test_risky_estimate_scales_with_competitor_window():
    """The displacement estimate scales with the competing population: a
    near-duplicate corpus risky against the whole corpus is not risky
    against a probe-sized window; both packages agree."""
    from vectorlite_tpu.index.flat import _bf16_selection_risky as j_risky

    rng = np.random.default_rng(11)
    protos = 10.0 * rng.normal(size=(32, D))
    rows = (np.repeat(protos, 128, axis=0) + 0.3 * rng.normal(size=(4096, D))).astype(np.float32)
    valid = np.ones(4096, dtype=bool)
    for comp in (None, 256, 100_000):
        assert tflat._bf16_selection_risky(rows, valid, 4096, competitor_rows=comp) == (
            j_risky(rows, valid, 4096, competitor_rows=comp))
    assert tflat._bf16_selection_risky(rows, valid, 4096)
    assert not tflat._bf16_selection_risky(rows, valid, 4096, competitor_rows=256)


def test_risky_corpus_still_activates_ivf(monkeypatch):
    """A whole-corpus _precision_risky verdict does not veto the IVF build
    and is not applied to IVF searches: the window-scaled re-check
    decides."""
    vals = corpus(4096)
    idx = FlatIndex(D, device="cpu")
    idx.add_batch_arrays(np.arange(4096, dtype=np.uint64), vals)
    idx.search_batch(vals[:1], k=1, metric=TM.COSINE)
    assert idx._ivf_active
    idx._ivf_drop()
    idx._precision_risky = True
    served = ivf_served(monkeypatch, idx)
    res = idx.search_batch(vals[:1], k=10, metric=TM.COSINE)
    assert idx._ivf_active and idx._ivf_refused_at == 0 and served == [True]
    truth_ids, _ = exact_topk(vals, vals[0], 10, TM.COSINE)
    assert {r.id for r in res[0]} == set(truth_ids.tolist())


def test_layout_goes_int8_when_bf16_layout_busts_hbm_budget(monkeypatch):
    """Storage + a bf16 layout over the memory budget: the build falls
    back to an int8 layout (+ per-row scales); results stay exact."""
    monkeypatch.setenv("VECTORLITE_AUTO_BF16_GB", "0.000001")
    vals = corpus(4096)
    idx = FlatIndex(D, device="cpu", device_dtype=torch.float32)
    idx.add_batch_arrays(np.arange(4096, dtype=np.uint64), vals)
    res = idx.search_batch(vals[:1], k=10, metric=TM.COSINE)
    assert idx._ivf_active and not idx._quantized
    assert idx._ivf_rows.dtype == torch.int8
    assert idx._ivf_scales is not None
    truth_ids, _ = exact_topk(vals, vals[0], 10, TM.COSINE)
    assert {r.id for r in res[0]} == set(truth_ids.tolist())


def test_int8_rung_builds_int8_layout_and_recalls(monkeypatch):
    vals = corpus(4096)
    idx = FlatIndex(D, device="cpu", device_dtype="int8")
    idx.add_batch_arrays(np.arange(4096, dtype=np.uint64), vals)
    q = vals[:8] + 0.01
    served = ivf_served(monkeypatch, idx)
    res = search_each(idx, q, 10, TM.COSINE)
    assert idx._ivf_active and served == [True] * 8
    assert idx._ivf_rows.dtype == torch.int8
    assert idx._ivf_scales is not None
    hits = 0
    for i in range(len(q)):
        truth_ids, _ = exact_topk(vals, q[i], 10, TM.COSINE)
        hits += len({r.id for r in res[i]} & set(truth_ids.tolist()))
        for r in res[i]:
            s = exact_topk(vals[r.id : r.id + 1], q[i], 1, TM.COSINE)[1][0]
            assert abs(r.score - s) < 1e-9
    assert hits / (10 * len(q)) >= 0.95


def test_int8_layout_tail_and_deletes(monkeypatch):
    vals = corpus(4096)
    idx = FlatIndex(D, device="cpu", device_dtype="int8")
    idx.add_batch_arrays(np.arange(4096, dtype=np.uint64), vals)
    idx.search_batch(vals[:1], k=3, metric=TM.COSINE)  # trigger the build
    assert idx._ivf_active and idx._ivf_rows.dtype == torch.int8
    probe = corpus(1, seed=33)[0] * 0.5
    idx.add(Vector(id=9000, values=probe.tolist(), text="tail row"))
    served = ivf_served(monkeypatch, idx)
    res = idx.search_batch(probe[None, :], k=3, metric=TM.COSINE)
    assert res[0][0].id == 9000  # tail row found immediately
    idx.delete(9000)
    res = idx.search_batch(probe[None, :], k=3, metric=TM.COSINE)
    assert all(r.id != 9000 for r in res[0]) and served == [True, True]
