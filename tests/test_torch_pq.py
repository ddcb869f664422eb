"""The port's PQ rung (kernels/pq.py, the `pq` FlatIndex profile and the
native f64 re-score) against the JAX package on the same seeded inputs.

The JAX side runs as tests/test_pq.py runs it on the CPU: the XLA
formulation, and the Pallas rank kernel K5 in interpret mode. The port
runs the plain version of K5, which its wrapper takes for CPU tensors.
The trainers draw different random numbers, so the FlatIndex tests carry
the JAX index's trained codebooks across (``codebooks_from_reference``).
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorlite_tpu.core.metrics import SimilarityMetric as JM
from vectorlite_tpu.index.flat import FlatIndex as JFlat
from vectorlite_tpu.kernels import pq as jpq
from vectorlite_tpu_torch import VectorLiteClient, VectorLiteConfig
from vectorlite_tpu_torch.core.metrics import SimilarityMetric as TM
from vectorlite_tpu_torch.embed.mock import MockEmbeddingFunction
from vectorlite_tpu_torch.index import flat as tflat
from vectorlite_tpu_torch.index.flat import FlatIndex
from vectorlite_tpu_torch.kernels import pq as tpq
from vectorlite_tpu_torch.native import RESCORE

D = 64
METRICS = ["COSINE", "EUCLIDEAN", "DOT_PRODUCT", "MANHATTAN"]
#: (M, kc, packed): the 4-bit layout packed and unpacked, and the 8-bit
LAYOUTS = [(32, 16, True), (32, 16, False), (16, 256, False)]
LAYOUT_IDS = ["4bit-packed", "4bit-unpacked", "kc256"]


@pytest.fixture(autouse=True)
def pq_env(monkeypatch):
    """Small gates so the rung engages at test scale, and the device path
    (the host f64 scan would otherwise serve small batches)."""
    monkeypatch.setenv("VECTORLITE_PQ_MIN_ROWS", "1024")
    monkeypatch.setenv("VECTORLITE_PQ_TRAIN_SAMPLE", "2048")
    monkeypatch.setenv("VECTORLITE_HOST_SCAN_ROWS", "0")


def corpus(n, d=D, seed=0):
    """Unit-norm clustered rows (embedding-like), as tests/test_pq.py."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, d))
    rows = centers[rng.integers(0, 32, n)] + 0.6 * rng.normal(size=(n, d))
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def t(x):
    """A CPU tensor holding its own copy of a numpy (or JAX) array."""
    return torch.from_numpy(np.array(x))


def trained(n, m, kc, *, seed=0, iters=4):
    """JAX codebooks and codes of a seeded corpus; the port's copy of the
    codebooks."""
    rows = corpus(n, seed=seed).astype(np.float32)
    cb = jpq.train_codebooks(rows[: min(n, 2048)], m, kc=kc, iters=iters)
    codes = np.asarray(jpq.encode_rows(cb, jnp.asarray(rows)))
    return rows, cb, codes, tpq.codebooks_from_reference(np.asarray(cb), device="cpu")


# ------------------------------------------------------- copied helpers


@pytest.mark.parametrize("dim", [64, 99, 384])
def test_rotation_matrix_is_bit_equal(dim):
    assert np.array_equal(tpq.rotation_matrix(dim), jpq.rotation_matrix(dim))


@pytest.mark.parametrize("dim, m", [(384, 96), (384, 100), (64, 48), (10, 4), (7, 3), (99, 49)])
def test_pq_subspaces(dim, m):
    assert tpq.pq_subspaces(dim, m) == jpq.pq_subspaces(dim, m)


@pytest.mark.parametrize("m", [2, 32, 192])
def test_pack_nibbles_byte_order_and_round_trip(m):
    rng = np.random.default_rng(m)
    codes = rng.integers(0, 16, (257, m), dtype=np.uint8)
    packed = tpq.pack_nibbles(t(codes)).numpy()
    assert np.array_equal(packed, np.asarray(jpq.pack_nibbles(codes)))
    # byte j: code 2j high nibble, 2j+1 low nibble
    assert np.array_equal(packed, (codes[:, 0::2] << 4) | codes[:, 1::2])
    assert np.array_equal(tpq.unpack_nibbles(t(packed)).numpy(), codes)
    assert np.array_equal(
        tpq.unpack_nibbles(t(packed)).numpy(),
        np.asarray(jpq._unpack_nibbles(jnp.asarray(packed))),
    )


@pytest.mark.parametrize("m, kc", [(32, 16), (16, 256)], ids=["4bit", "8bit"])
def test_encode_rows_with_carried_codebooks(m, kc):
    """Codes equal the JAX encoder's, except where a row's two nearest
    centroids lie within f32 rounding of each other: each such row is
    counted and checked."""
    rows, cb, j_codes, tcb = trained(3000, m, kc)
    got = tpq.encode_rows(tcb, t(rows)).numpy()
    diff = np.argwhere(got != j_codes)
    cbn = np.asarray(cb, dtype=np.float64)
    dsub = D // m
    for n, j in diff:
        x = rows[n, j * dsub : (j + 1) * dsub].astype(np.float64)
        d_port = np.sum((x - cbn[j, got[n, j]]) ** 2)
        d_jax = np.sum((x - cbn[j, j_codes[n, j]]) ** 2)
        # f32 rounding of |x|^2 - 2x.c + |c|^2 at these magnitudes
        assert abs(d_port - d_jax) <= 1e-6 * (1.0 + np.sum(x * x))
    assert len(diff) <= 1e-4 * got.size


@pytest.mark.parametrize("kc", [16, 256])
def test_trainer_quality_and_every_centroid_used(kc):
    """The generators differ, so the port's trainer is held to the JAX
    trainer's mean quantization error within 10%, and must leave no dead
    centroid."""
    m = 32 if kc == 16 else 16
    rows = corpus(4096, seed=3).astype(np.float32)
    sample = rows[:2048]
    j_cb = np.asarray(jpq.train_codebooks(sample, m, kc=kc, iters=8))
    t_cb = tpq.train_codebooks(sample, m, kc=kc, iters=8)
    assert t_cb.shape == (m, kc, D // m) and t_cb.dtype == torch.float32

    def mean_error(cb):
        codes = tpq.encode_rows(cb, t(rows)).numpy()
        cbn = cb.numpy()
        recon = np.concatenate([cbn[j][codes[:, j]] for j in range(m)], axis=1)
        return float(np.mean(np.sum((recon - rows) ** 2, axis=1)))

    j_err = mean_error(torch.tensor(j_cb))
    t_err = mean_error(t_cb)
    assert t_err <= 1.10 * j_err, (t_err, j_err)
    used = tpq.encode_rows(t_cb, t(sample)).numpy()
    for j in range(m):
        assert len(np.unique(used[:, j])) == kc, j


@pytest.mark.parametrize("metric", METRICS)
def test_adc_lut_parity(metric):
    _, cb, _, tcb = trained(1024, 32, 16)
    q = corpus(5, seed=7).astype(np.float32)
    want = np.asarray(jpq._adc_lut(jnp.asarray(q), cb, JM[metric]))
    got = tpq._adc_lut(t(q), tcb, TM[metric]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- K5


def rank_inputs(layout, metric, n=256, b=4):
    m, kc, packed = layout
    rows, cb, codes, _ = trained(n, m, kc)
    if packed:
        codes = np.asarray(jpq.pack_nibbles(codes))
    q = jnp.asarray(corpus(b, seed=5).astype(np.float32))
    lut = jpq._adc_lut(q, cb, JM[metric])
    lut3 = (-lut if metric == "MANHATTAN" else lut).astype(jnp.bfloat16)
    sq = np.einsum("nd,nd->n", rows, rows).astype(np.float32)
    valid = np.ones(n, bool)
    valid[7] = valid[130] = False
    # the same bf16 LUT for both packages (bf16 -> f32 -> bf16 is exact)
    t_lut = t(np.asarray(lut3).astype(np.float32)).to(torch.bfloat16)
    return codes, lut3, sq, valid, t_lut


def port_rank(codes, sq, valid, t_lut, metric, packed):
    return tpq.pq_rank(
        t_lut, t(codes), t(sq), t(valid), metric=TM[metric], packed=packed
    ).numpy()


def assert_rank_close(got, want):
    """rtol/atol 2e-5 (f32 sums of bf16 values taken in another order,
    the reference's own tolerance) and the same -inf pattern."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == -np.inf, want == -np.inf)
    fin = want != -np.inf
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_rank_matches_xla_formulation(layout, metric):
    """pq_rank_plain against the XLA one-hot formulation of
    pq_search_topk's select_chunk body (tests/test_pq.py:212-227)."""
    codes, lut3, sq, valid, t_lut = rank_inputs(layout, metric)
    _, kc, packed = layout
    n, b = codes.shape[0], lut3.shape[0]
    u = jpq._unpack_nibbles(jnp.asarray(codes)) if packed else jnp.asarray(codes)
    oh = (u[:, :, None] == jnp.arange(kc, dtype=jnp.uint8)).astype(jnp.bfloat16)
    adc = jax.lax.dot_general(
        lut3.reshape(b, -1), oh.reshape(n, -1),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    want = jpq._rank_surrogate(adc, JM[metric], jnp.asarray(sq)[None, :])
    want = np.asarray(jnp.where(jnp.asarray(valid)[None, :], want, jpq.NEG_INF))
    assert_rank_close(port_rank(codes, sq, valid, t_lut, metric, packed), want)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("layout", LAYOUTS[:2], ids=LAYOUT_IDS[:2])
def test_rank_matches_pallas_kernel(layout, metric):
    """pq_rank_plain against K5 itself, the Pallas kernel in interpret
    mode (the reference keeps kc = 256 off its kernel)."""
    codes, lut3, sq, valid, t_lut = rank_inputs(layout, metric)
    _, kc, packed = layout
    ms = codes.shape[1]
    ms_pad = -(-ms // 128) * 128
    want = jpq._pallas_chunk_rank(
        jpq._lut_flat_pallas(lut3, packed=packed),
        jnp.pad(jnp.asarray(codes), ((0, 0), (0, ms_pad - ms))),
        jnp.asarray(sq), jnp.asarray(valid),
        metric=JM[metric], kc=kc, packed=packed, tile_n=128, interpret=True,
    )
    assert_rank_close(port_rank(codes, sq, valid, t_lut, metric, packed), np.asarray(want))


def test_select_topk_keeps_lowest_columns_among_ties():
    rng = np.random.default_rng(4)
    rank = rng.integers(0, 6, (7, 300)).astype(np.float32)
    rank[:, ::11] = -np.inf
    rank[3] = 2.0  # a row of nothing but ties
    for k in (1, 10, 100, 300):
        s, cols = tpq.select_topk(t(rank), k)
        want = np.argsort(-rank, axis=1, kind="stable")[:, :k]
        assert np.array_equal(np.sort(want, axis=1), cols.numpy())
        assert np.array_equal(np.take_along_axis(rank, cols.numpy(), 1), s.numpy())


# ------------------------------------------------------ pq_search_topk


def search_pair(codes, cb, tcb, sq, valid, q, metric, k, chunk, packed):
    js, ji = jpq.pq_search_topk(
        jnp.asarray(codes), cb, jnp.asarray(sq), jnp.asarray(valid),
        jnp.asarray(q), metric=JM[metric], k=k, chunk=chunk, packed=packed,
    )
    ts, ti = tpq.pq_search_topk(
        t(codes), tcb, t(sq), t(valid), t(q), metric=TM[metric], k=k,
        chunk=chunk, packed=packed,
    )
    return np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy()


def assert_same_topk(js, ji, ts, ti):
    """Ids equal except among scores within 1e-5 of each other; scores
    within rtol 1e-5."""
    np.testing.assert_array_equal(ts == -np.inf, js == -np.inf)
    fin = js != -np.inf
    np.testing.assert_allclose(ts[fin], js[fin], rtol=1e-5, atol=1e-7)
    for b, p in zip(*np.nonzero(ti != ji)):
        gaps = np.abs(js[b] - js[b, p])
        gaps[p] = np.inf
        assert gaps.min() <= 1e-5 * max(1.0, abs(js[b, p])), (b, p)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_search_topk_matches_jax(layout, metric):
    m, kc, packed = layout
    rows, cb, codes, tcb = trained(1000, m, kc)
    if packed:
        codes = np.asarray(jpq.pack_nibbles(codes))
    sq = np.einsum("nd,nd->n", rows, rows).astype(np.float32)
    valid = np.ones(1000, bool)
    valid[::13] = False
    q = corpus(6, seed=9).astype(np.float32)
    assert_same_topk(*search_pair(codes, cb, tcb, sq, valid, q, metric, 10, 256, packed))


@pytest.mark.parametrize("chunk", [1000, 256, 192, 64, 4])
def test_chunking_is_invisible(chunk):
    """Same winners whatever the chunk, a non-dividing chunk (padding)
    and chunk < k (the clamp) included, in both packages."""
    rows, cb, codes, tcb = trained(1000, 32, 16)
    codes = np.asarray(jpq.pack_nibbles(codes))
    sq = np.einsum("nd,nd->n", rows, rows).astype(np.float32)
    valid = np.ones(1000, bool)
    q = corpus(3, seed=9).astype(np.float32)
    js, ji, ts, ti = search_pair(codes, cb, tcb, sq, valid, q, "EUCLIDEAN", 10, chunk, True)
    assert_same_topk(js, ji, ts, ti)
    ref_s, ref_i = tpq.pq_search_topk(
        t(codes), tcb, t(sq), t(valid), t(q), metric=TM.EUCLIDEAN, k=10,
        chunk=1000, packed=True,
    )
    np.testing.assert_array_equal(ti, ref_i.numpy())
    np.testing.assert_allclose(ts, ref_s.numpy(), rtol=1e-6)


def test_validity_mask_and_padding():
    rows, cb, codes, tcb = trained(300, 32, 16)
    sq = np.einsum("nd,nd->n", rows, rows).astype(np.float32)
    valid = np.ones(300, bool)
    valid[::2] = False  # half tombstoned
    js, ji, ts, ti = search_pair(codes, cb, tcb, sq, valid, rows[:2], "COSINE", 20, 128, False)
    assert (ti % 2 == 1).all() and np.isfinite(ts).all()
    assert_same_topk(js, ji, ts, ti)
    # capacity below k: padded with -inf
    js, ji, ts, ti = search_pair(
        codes[:8], cb, tcb, sq[:8], valid[:8], rows[:2], "COSINE", 12, 128, False
    )
    assert ts.shape == (2, 12) and (ts[:, 4:] == -np.inf).all()
    assert_same_topk(js, ji, ts, ti)


@pytest.mark.parametrize("metric", METRICS)
def test_duplicate_rows_break_ties_to_the_lowest_row(metric):
    """A corpus of repeated rows gives many equal ranks and scores: both
    packages keep the lowest rows, in the same order."""
    rows, cb, codes, tcb = trained(128, 32, 16)
    codes = np.tile(codes, (8, 1))  # row r == rows r + 128, r + 256, ...
    rows = np.tile(rows, (8, 1))
    sq = np.einsum("nd,nd->n", rows, rows).astype(np.float32)
    valid = np.ones(len(rows), bool)
    q = corpus(4, seed=2).astype(np.float32)
    js, ji, ts, ti = search_pair(codes, cb, tcb, sq, valid, q, metric, 16, 256, False)
    np.testing.assert_array_equal(ti, ji)
    for b in range(len(q)):
        for lo in range(0, 16):
            same = ts[b] == ts[b, lo]
            assert list(ti[b][same]) == sorted(ti[b][same])


# ---------------------------------------------------- routing, CUDA


def meta_inputs():
    n, m, kc = 256, 32, 16
    return dict(
        lut_sel=torch.zeros((2, m, kc), dtype=torch.bfloat16, device="meta"),
        codes=torch.zeros((n, m // 2), dtype=torch.uint8, device="meta"),
        sqnorms=torch.zeros(n, device="meta"),
        valid=torch.ones(n, dtype=torch.bool, device="meta"),
    )


def test_cuda_side_tensors_never_reach_the_plain_rank(monkeypatch):
    """Off the CPU the wrapper launches K5 or raises: there is no plain
    fallback for a device tensor, whatever the environment says."""
    calls = []
    monkeypatch.setattr(tpq, "pq_rank_plain", lambda *a, **k: calls.append(1))
    monkeypatch.setenv("VECTORLITE_PQ_PALLAS", "0")
    with pytest.raises(ValueError, match="no kernel"):
        tpq.pq_rank(**meta_inputs(), metric=TM.COSINE, packed=True)
    cb = torch.zeros((32, 16, 2), device="meta")
    inp = meta_inputs()
    with pytest.raises(ValueError, match="no kernel"):
        tpq.pq_search_topk(
            inp["codes"], cb, inp["sqnorms"], inp["valid"],
            torch.zeros((2, D), device="meta"), metric=TM.COSINE, k=10,
            chunk=128, packed=True,
        )
    assert calls == []


@pytest.mark.parametrize(
    "change, match",
    [
        (dict(lut_sel=torch.zeros((2, 32, 16), dtype=torch.float32, device="meta")), "bf16"),
        (dict(codes=torch.zeros((256, 15), dtype=torch.uint8, device="meta")), "packed"),
        (dict(codes=torch.zeros((256, 16), dtype=torch.int8, device="meta")), "uint8"),
        (dict(sqnorms=torch.zeros(255, device="meta")), "sqnorms"),
        (dict(valid=torch.ones(256, dtype=torch.uint8, device="meta")), "valid"),
    ],
    ids=["lut-dtype", "packed-width", "codes-dtype", "sq-shape", "valid-dtype"],
)
def test_cuda_wrapper_checks_its_operands(change, match, monkeypatch):
    """The CUDA wrapper checks type, shape and layout before it launches;
    a fake CUDA device lets the checks run here."""
    inp = {**meta_inputs(), **change}
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError, match=match):
        tpq.pq_rank_cuda(**inp, metric=TM.COSINE, packed=True)
    assert tpq.PQ_RANK.launches == 0 and tpq.PQ_RANK_MMA.launches == 0


@pytest.mark.parametrize(
    "change, match",
    [
        (dict(codes=torch.zeros((256, 32), dtype=torch.uint8, device="meta"),
              lut_sel=torch.zeros((2, 31, 16), dtype=torch.bfloat16, device="meta")),
         "unpacked"),
        (dict(lut_sel=torch.zeros((2, 32, 16), dtype=torch.bfloat16, device="meta")[:, ::2]
              .repeat_interleave(2, dim=1).transpose(0, 1)), "contiguous"),
        (dict(lut_sel=torch.zeros((2, 32, 32), dtype=torch.bfloat16, device="meta")),
         "packed codes need kc = 16"),
    ],
    ids=["unpacked-width", "lut-layout", "packed-kc"],
)
def test_tensor_core_entry_checks_its_operands(change, match, monkeypatch):
    """kc = 16 goes to the tensor-core entry; its operands are checked as
    the look-up entry's are, before any launch."""
    inp = {**meta_inputs(), **change}
    packed = "codes" not in change
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError, match=match):
        tpq.pq_rank_cuda(**inp, metric=TM.COSINE, packed=packed)
    assert tpq.PQ_RANK_MMA.launches == 0 and tpq.PQ_RANK.launches == 0


@pytest.mark.parametrize(
    "m, kc, packed, entry",
    [(32, 16, True, "pq_rank_mma"), (33, 16, False, "pq_rank_mma"),
     (16, 256, False, "pq_rank"), (2620, 16, True, None)],
    ids=["4bit-packed", "4bit-unpacked", "kc256", "4bit-wide"],
)
@pytest.mark.parametrize("b", [5, 256, 300])
def test_cuda_wrapper_sends_kc16_to_the_tensor_cores(m, kc, packed, entry, b, monkeypatch):
    """pq_rank_cuda sends kc = 16, packed or unpacked, to the tensor-core
    entry with its query tile, and any other kc to the
    look-up entry; nothing reaches the plain rank. A fake CUDA device lets
    the host side run here."""
    n = 200
    lut = torch.zeros((b, m, kc), dtype=torch.bfloat16)
    codes = torch.zeros((n, m // 2 if packed else m), dtype=torch.uint8)
    launched = []
    for kern in (tpq.PQ_RANK_MMA, tpq.PQ_RANK):
        monkeypatch.setattr(kern, "launch", lambda *a, kern=kern: launched.append((kern.symbol, a)))
    monkeypatch.setattr(tpq, "pq_rank_plain", lambda *a, **k: launched.append("plain"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    if entry is None:  # a tile's codes too wide for the tensor-core entry's shared memory
        entry = "pq_rank_mma" if tpq.mma_fits(b, codes.shape[1]) else "pq_rank"
        assert entry == ("pq_rank_mma" if b == 5 else "pq_rank")
    out = tpq.pq_rank_cuda(lut, codes, torch.zeros(n), torch.ones(n, dtype=torch.bool),
                           metric=TM.EUCLIDEAN, packed=packed)
    assert out.shape == (b, n) and out.dtype == torch.float32
    assert [sym for sym, _ in launched] == [entry]
    args = launched[0][1]
    if entry == "pq_rank_mma":
        nt = {5: 8, 256: 256, 300: 256}[b]
        assert args[5:] == (n, b, m, codes.shape[1], int(packed), 1, nt, 0)
    else:
        assert args[5:] == (n, b, m, kc, codes.shape[1], int(packed), 1, 0)


@pytest.mark.parametrize("b, nt", [(1, 8), (5, 8), (8, 8), (9, 16), (64, 64), (65, 128),
                                   (256, 256), (300, 256)])
def test_mma_query_tile(b, nt):
    assert tpq.mma_query_tile(b) == nt


@pytest.mark.parametrize("m, packed", [(32, True), (33, False)], ids=["packed", "unpacked"])
@pytest.mark.parametrize("b", [5, 256, 300])
@pytest.mark.parametrize("metric", METRICS)
def test_mma_lut_operand_contracts_to_the_plain_rank(b, m, packed, metric):
    """The tensor-core entry's LUT operand, read as the kernel addresses it
    (a subspace's slice of a query tile is nt x 32 bytes; in it 8 queries x
    8 codes a core matrix, the two code halves 128 bytes apart, groups of 8
    queries 256 bytes apart) and contracted with the codes' one-hot in
    plain torch, gives pq_rank_plain's rank; the padded queries are zero."""
    rng = np.random.default_rng(b + m)
    n = 300
    lut = torch.from_numpy(rng.normal(size=(b, m, 16)).astype(np.float32)).to(torch.bfloat16)
    codes = torch.from_numpy(rng.integers(0, 16, (n, m)).astype(np.uint8))
    stored = tpq.pack_nibbles(codes) if packed else codes
    sq = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) > 0.1)
    nt = tpq.mma_query_tile(b)
    op = tpq.mma_lut_operand(lut, nt)
    qt = -(-b // nt)
    assert op.dtype == torch.bfloat16 and op.is_contiguous() and op.numel() == qt * nt * m * 16
    flat = op.reshape(-1).to(torch.float32)
    bq = torch.arange(qt * nt)
    tile, q = bq // nt, bq % nt
    mm = torch.arange(m)
    k = torch.arange(16)
    index = (
        (((tile[:, None, None] * m + mm[None, :, None]) * (nt // 8) + (q // 8)[:, None, None]) * 2
         + (k // 8)[None, None, :]) * 64
        + ((q % 8) * 8)[:, None, None] + (k % 8)[None, None, :]
    )
    read = flat[index]  # [tiles * nt, M, 16] as the kernel reads it
    assert torch.equal(read[:b], lut.to(torch.float32))
    assert not read[b:].any()
    onehot = (codes.to(torch.int64)[:, :, None] == k).to(torch.float32)  # [N, M, 16]
    adc = torch.einsum("bmk,nmk->bn", read[:b], onehot)
    want = tpq.pq_rank_plain(lut, stored, sq, valid, metric=TM[metric], packed=packed)
    got = torch.where(valid[None, :], tpq._rank_surrogate(adc, TM[metric], sq[None, :]),
                      tpq.NEG_INF)
    assert_rank_close(got.numpy(), want.numpy())


# ----------------------------------------------------------- FlatIndex


def pq_pair(monkeypatch, rows, *, n_dim=D, ids=None, metas=None):
    """A JAX pq FlatIndex, activated, and the port's with the JAX
    codebooks carried across through a patched trainer."""
    ids = list(range(len(rows))) if ids is None else ids
    j = JFlat(n_dim, device_dtype="pq")
    j.add_batch_arrays(ids, rows, metadatas=metas)
    j.search_batch_arrays(rows[:8], 1, JM.COSINE)  # trains and encodes
    assert j._pq_active
    carried = []

    def trainer(sample, m, **kw):
        carried.append((m, kw["kc"]))
        return tpq.codebooks_from_reference(np.asarray(j._dev_codebooks), device="cpu")

    monkeypatch.setattr(tpq, "train_codebooks", trainer)
    port = FlatIndex(n_dim, device_dtype="pq", device="cpu")
    port.add_batch_arrays(ids, rows, metadatas=metas)
    return j, port, carried


def search(index, q, metric, k=10, **kw):
    m = (JM if isinstance(index, JFlat) else TM)[metric]
    return index.search_batch_arrays(q, k, m, **kw)


def assert_index_parity(j, port, q, metric, **kw):
    """Ids equal; exact f64 scores within 1e-12."""
    j_ids, j_s = search(j, q, metric, **kw)
    ids, s = search(port, q, metric, **kw)
    assert port._pq_active
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_allclose(s, j_s, rtol=0, atol=1e-12)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("rotate", ["1", "0"], ids=["rotated", "unrotated"])
def test_flat_index_pq_parity(metric, rotate, monkeypatch):
    monkeypatch.setenv("VECTORLITE_PQ_ROTATE", rotate)
    rows = corpus(2048)
    j, port, carried = pq_pair(monkeypatch, rows)
    rng = np.random.default_rng(11)
    q = rows[rng.integers(0, 2048, 16)] + 0.02 * rng.normal(size=(16, D))
    assert_index_parity(j, port, q, metric)
    assert carried == [(32, 16)]
    assert port._pq_packed and (port._pq_rot is not None) == (rotate == "1")
    np.testing.assert_array_equal(port._dev_codes.numpy(), np.asarray(j._dev_codes))
    assert port._dev_values is None  # the f32 cache is freed


def test_below_gate_serves_f32(monkeypatch):
    monkeypatch.setenv("VECTORLITE_PQ_MIN_ROWS", "4096")
    rows = corpus(1024)
    port = FlatIndex(D, device_dtype="pq", device="cpu")
    port.add_batch_arrays(list(range(1024)), rows)
    j = JFlat(D, device_dtype="pq")
    j.add_batch_arrays(list(range(1024)), rows)
    q = rows[:8]
    j_ids, j_s = search(j, q, "COSINE")
    ids, s = search(port, q, "COSINE")
    assert not port._pq_active and port._dev_codes is None
    assert port._dev_values is not None and port._dev_values.dtype == torch.float32
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_allclose(s, j_s, rtol=1e-5, atol=1e-5)


def test_appends_after_activation(monkeypatch):
    rows = corpus(2048)
    j, port, _ = pq_pair(monkeypatch, rows)
    search(port, rows[:4], "COSINE")
    assert port._pq_active
    fresh = corpus(8, seed=42)
    for index in (j, port):
        index.add_batch_arrays(list(range(5000, 5008)), fresh)
    assert_index_parity(j, port, fresh, "COSINE", k=3)
    ids, s = search(port, fresh, "COSINE", k=1)
    assert list(ids[:, 0]) == list(range(5000, 5008))
    np.testing.assert_allclose(s[:, 0], 1.0, atol=1e-12)


def test_delete_and_where_filter(monkeypatch):
    rows = corpus(2048)
    metas = [{"par": i % 2} for i in range(2048)]
    j, port, _ = pq_pair(monkeypatch, rows, metas=metas)
    for index in (j, port):
        index.delete(7)
    q = rows[[7, 8, 9, 10]]
    assert_index_parity(j, port, q, "COSINE")
    assert 7 not in search(port, q, "COSINE")[0]
    where = {"par": {"$eq": 0}}
    assert_index_parity(j, port, q, "COSINE", where=where)
    ids, _ = search(port, q, "COSINE", where=where)
    assert (ids % 2 == 0).all() and ids[1, 0] == 8


@pytest.mark.parametrize("metric", ["COSINE", "EUCLIDEAN"])
def test_approx_false_takes_the_pq_rung(metric, monkeypatch):
    rows = corpus(2048)
    j, port, _ = pq_pair(monkeypatch, rows)
    assert_index_parity(j, port, rows[100:108], metric, approx=False)


def test_capacity_growth_retrains(monkeypatch):
    rows = corpus(2048)
    j, port, carried = pq_pair(monkeypatch, rows)
    search(port, rows[:4], "COSINE")
    before = port._dev_codebooks
    more = corpus(3000, seed=5)
    for index in (j, port):
        index.add_batch_arrays(list(range(10_000, 13_000)), more)
    j.search_batch_arrays(rows[:4], 1, JM.COSINE)  # JAX retrains too
    assert_index_parity(j, port, more[:8], "COSINE")
    assert port._dev_codebooks is not before and len(carried) == 2
    assert port._capacity == 8192


def test_compaction_keeps_codebooks_and_drops_codes(monkeypatch):
    rows = corpus(4096)
    j, port, carried = pq_pair(monkeypatch, rows)
    search(port, rows[:4], "COSINE")
    books, codes = port._dev_codebooks, port._dev_codes
    for index in (j, port):
        for vid in range(0, 2200):
            index.delete(vid)  # past half: compaction
    assert port._dev_codes is None and port._dev_codebooks is books
    assert_index_parity(j, port, rows[2200:2208], "EUCLIDEAN")
    assert port._dev_codebooks is books and port._dev_codes is not codes
    assert len(carried) == 1


def test_pool_floor_frozen_at_build(monkeypatch):
    rows = corpus(2048)
    _, port, _ = pq_pair(monkeypatch, rows)
    search(port, rows[:4], "COSINE")
    assert port._pq_bits_active == 4
    floor = port._selection_k(1)
    monkeypatch.setenv("VECTORLITE_PQ_BITS", "8")
    assert port._selection_k(1) == floor == 256


def test_eight_bit_profile_parity(monkeypatch):
    monkeypatch.setenv("VECTORLITE_PQ_BITS", "8")
    rows = corpus(2048)
    j, port, carried = pq_pair(monkeypatch, rows)
    assert_index_parity(j, port, rows[:8] + 0.01, "DOT_PRODUCT")
    assert carried == [(16, 256)] and not port._pq_packed
    assert port._selection_k(16) == 128


def test_pool_floor_grows_with_high_water_rows():
    port = FlatIndex(D, device_dtype="pq", device="cpu")
    port._capacity = 1 << 26
    for size, floor in ((1 << 20, 256), ((2 << 20) + 1, 512), ((16 << 20) + 1, 1024)):
        port._size = size
        assert port._selection_k(16) == floor


def spy_on(monkeypatch, calls, module, name):
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("metric", METRICS)
def test_active_rung_routes_through_pq_search_only(metric, monkeypatch):
    rows = corpus(2048)
    _, port, _ = pq_pair(monkeypatch, rows)
    search(port, rows[:4], "COSINE")
    calls = []
    for name in ("pallas_search_topk", "pallas_search_topk_l1",
                 "pallas_search_topk_int8", "pallas_search_block_topk_int8",
                 "pallas_search_block_topk_rescored"):
        spy_on(monkeypatch, calls, tflat.scan, name)
    spy_on(monkeypatch, calls, tflat, "search_topk")
    spy_on(monkeypatch, calls, tflat, "search_topk_int8")
    spy_on(monkeypatch, calls, tflat.pq, "pq_search_topk")
    search(port, rows[:16], metric)
    search(port, rows[:16], metric, approx=False)
    assert calls == ["pq_search_topk", "pq_search_topk"]


def test_manhattan_under_rotation_selects_by_the_euclidean_proxy(monkeypatch):
    rows = corpus(2048)
    _, port, _ = pq_pair(monkeypatch, rows)
    seen = []
    real = tpq.pq_search_topk

    def spy(*args, **kw):
        seen.append(kw["metric"])
        return real(*args, **kw)

    monkeypatch.setattr(tflat.pq, "pq_search_topk", spy)
    ids, s = search(port, rows[:4], "MANHATTAN")
    assert seen == [TM.EUCLIDEAN]
    want = 1.0 / (1.0 + np.abs(rows[ids[0, 0]] - rows[0]).sum())
    assert s[0, 0] == pytest.approx(want, abs=1e-12)


# ------------------------------------------------------ native re-score


@pytest.mark.parametrize("metric", METRICS)
def test_native_rescore_matches_numpy_and_jax(metric, monkeypatch):
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(300, 48)) * 3.0
    port = FlatIndex(48, device="cpu")
    port.add_batch_arrays(list(range(300)), rows)
    j = JFlat(48)
    j.add_batch_arrays(list(range(300)), rows)
    q64 = rng.normal(size=(16, 48))
    slots = rng.integers(0, 300, size=(16, 24))
    calls = RESCORE.calls
    got = RESCORE(port._values64, port._host_norms(), q64, slots, TM[metric])
    assert got is not None and RESCORE.calls == calls + 1
    np.testing.assert_allclose(
        got, port._exact_scores_numpy(q64, slots, TM[metric]), rtol=1e-12, atol=1e-12
    )
    scores = np.zeros((16, 24))
    scores[3, -2:] = -np.inf
    want = j._exact_rescore(q64, scores.copy(), slots.copy(), JM[metric])
    out = port._exact_rescore(q64, scores.copy(), slots.copy(), TM[metric])
    np.testing.assert_allclose(out[0], want[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(out[1], want[1])
    monkeypatch.setenv("VECTORLITE_NO_NATIVE", "1")
    assert RESCORE(port._values64, port._host_norms(), q64, slots, TM[metric]) is None
    out_np = port._exact_rescore(q64, scores.copy(), slots.copy(), TM[metric])
    np.testing.assert_allclose(out_np[0], want[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(out_np[1], want[1])


def test_native_rescore_refuses_out_of_range_slots():
    port = FlatIndex(8, device="cpu")
    port.add_batch_arrays([1, 2], np.ones((2, 8)))
    with pytest.raises(ValueError, match="slots"):
        RESCORE(port._values64, None, np.ones((1, 8)),
                np.array([[port._capacity]]), TM.DOT_PRODUCT)


# --------------------------------------------------------------- client


def test_config_has_the_pq_profile():
    cfg = VectorLiteConfig.profile("pq")
    assert cfg.device_dtype == "pq" and (cfg.hnsw_m, cfg.hnsw_m0) == (16, 32)


def test_client_pq_profile_runs_through_to_pq_search(monkeypatch):
    client = VectorLiteClient(
        MockEmbeddingFunction(D), config=VectorLiteConfig.profile("pq"),
        device="cpu",
    )
    client.create_collection("c", "flat")
    rows = corpus(2048)
    client.add_vectors_to_collection("c", rows)
    calls = []
    spy_on(monkeypatch, calls, tflat.pq, "pq_search_topk")
    hits = client.search_vectors_in_collection("c", rows[[3, 4]], 2)
    assert [h[0].id for h in hits] == [3, 4]
    assert calls == ["pq_search_topk"]
    with client.get_collection("c").index_read() as index:
        assert index._pq and index._pq_active


# ---------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("n, d, b, m, kc, packed, entry", [
    (65536, 384, 64, 192, 16, True, "PQ_RANK_MMA"),
    (65536, 384, 64, 192, 16, False, "PQ_RANK_MMA"),
    (8192, 99, 5, 33, 16, False, "PQ_RANK_MMA"),
    (65536, 384, 64, 96, 256, False, "PQ_RANK"),
    (8192, 99, 5, 33, 256, False, "PQ_RANK"),
], ids=["4bit-packed", "4bit-unpacked", "4bit-odd", "kc256", "kc256-odd"])
def test_rank_kernels_match_plain_on_the_card(n, d, b, m, kc, packed, entry):
    """K5 through pq_rank: kc = 16 (packed or unpacked 4-bit codes) on the
    tensor-core entry, kc = 256 on the look-up entry, at chip_smoke.py
    phase 2's small shapes, every metric, against pq_rank_plain: the same
    -inf pattern and ranks within rtol/atol 2e-5 (f32 sums of the same
    exact bf16 values taken in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("K5 is CUDA C++ and runs only on an NVIDIA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng([n, m, kc])
    kern = getattr(tpq, entry)
    for metric in TM:
        codes = torch.from_numpy(rng.integers(
            0, 256 if packed else kc, (n, m // 2 if packed else m), dtype=np.uint8)).to(dev)
        cb = torch.from_numpy(rng.normal(size=(m, kc, d // m)).astype(np.float32)).to(dev)
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
        lut = tpq.selection_lut(tpq._adc_lut(q, cb, metric), metric)
        sq = torch.from_numpy((rng.uniform(0.5, 2.0, n) * d).astype(np.float32)).to(dev)
        valid = torch.from_numpy(rng.random(n) > 0.05).to(dev)
        before = kern.launches
        got = tpq.pq_rank(lut, codes, sq, valid, metric=metric, packed=packed)
        assert kern.launches == before + 1
        want = tpq.pq_rank_plain(lut, codes, sq, valid, metric=metric, packed=packed)
        fin = want != float("-inf")
        assert torch.equal(got == float("-inf"), ~fin)
        torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=2e-5)
