"""The port's tournament-merge engine (K7's plain twin on the CPU) against
the JAX Pallas kernel in interpret mode, on the same seeded numpy inputs.

Scores agree within rtol/atol 1e-5 (f32 sums taken in another order); row
ids agree exactly, forced ties inside and across lane groups and lane
groups with fewer than W live rows included."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vectorlite_tpu.core.metrics import SimilarityMetric as JMetric
from vectorlite_tpu.kernels import pallas_merge as jmerge
from vectorlite_tpu_torch.core.metrics import SimilarityMetric, quantize_rows_int8
from vectorlite_tpu_torch.kernels import decompose, merge, scan, scan_mma
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
    """K7's merge pass (lanes.cu) and K3 over f32 rows (scan.cu) share
    scan_kernel.cuh: an edited header must key both libraries anew, and
    leave host code's."""
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


# ----------------------------------------- the tensor-core body's operands


def query_cases():
    """f32 queries: N(0, 1) draws; magnitudes 1e-30 to 1e30 with random
    mantissas and signs; zeros, signs and values one ulp apart."""
    rng = np.random.default_rng(11)
    mags = 10.0 ** rng.uniform(-30, 30, (6, 40))
    signed = (mags * rng.choice([-1.0, 1.0], mags.shape)).astype(np.float32)
    one = np.float32(1.0)
    edge = np.array([[0.0, -0.0, 1.0, -1.0, np.nextafter(one, np.float32(2)),
                      -np.nextafter(one, np.float32(0)), 3.0e-30, -7.5e29,
                      np.float32(1 / 3), -np.float32(2 / 3)]], np.float32)
    return {"normal": rng.normal(size=(7, 50)).astype(np.float32),
            "magnitudes": signed, "zeros-signs": edge}


@pytest.mark.parametrize("case", ["normal", "magnitudes", "zeros-signs"])
def test_query_split_reconstructs_f32_queries_exactly(case):
    """h + m + l, added in f32 in that order, is the f32 query: equal as a
    value (-0 comes back +0) and of the same sign where nonzero."""
    q = torch.from_numpy(query_cases()[case])
    terms = scan_mma.split_query_terms(q)
    assert terms.dtype == torch.bfloat16 and terms.shape == (3, *q.shape)
    back = (terms[0].float() + terms[1].float()) + terms[2].float()
    assert torch.equal(back, q)
    nz = q != 0
    assert torch.equal(torch.sign(back[nz]), torch.sign(q[nz]))
    # each term holds what the ones before it could not
    assert torch.all(terms[1].float().abs() <= terms[0].float().abs())
    assert torch.all(terms[2].float().abs() <= terms[1].float().abs())


@pytest.mark.parametrize("d, b", [(64, 8), (100, 5), (384, 70)])
def test_term_contraction_matches_tile_scores(d, b, rng):
    """Three bf16 passes (term x bf16 row, each product exact in f32)
    summed in f32 give the plain version's f32 dots within the raw-dot
    tolerance of chip_smoke.py (1e-5 x max(1, max |dot|): f32 sums taken in
    another order); the query rounded to bf16 alone (one pass, the library
    yardstick's function) does not."""
    n = 512
    rows = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    terms = scan_mma.split_query_terms(q).float()
    v = rows.float()
    dots = terms[2] @ v.T + terms[1] @ v.T + terms[0] @ v.T
    want = scan.tile_scores(rows, None, torch.zeros(n), torch.ones(n, dtype=torch.bool),
                            q, SimilarityMetric.DOT_PRODUCT)
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((dots - want).abs().max()) <= tol
    assert float((terms[0] @ v.T - want).abs().max()) > tol


@pytest.mark.parametrize("d", [64, 100, 384])
@pytest.mark.parametrize("b", [5, 64, 70])
def test_query_operand_is_the_swizzled_terms(b, d, rng):
    """The operand read as the kernel addresses it (block j's slice s term
    t at ((j S + s) 3 + t) x 4096 elements; in it query r's 16-byte chunk
    c at chunk c ^ (r mod 8) of its 128-byte row) gives back each term;
    every slot past B and D is zero."""
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    op = scan_mma.query_operand(q)
    nb, ns = -(-b // 64), -(-d // 64)
    assert op.dtype == torch.bfloat16 and op.is_contiguous()
    assert op.shape == (nb, ns, 3, 64, 64)
    flat = op.reshape(-1)
    terms = scan_mma.split_query_terms(q)
    r = torch.arange(b)[:, None]
    col = torch.arange(d)[None, :]
    rr, kc = r % 64, col % 64
    for t in range(3):
        off = ((((r // 64) * ns + col // 64) * 3 + t) * 64 + rr) * 64 + \
            ((kc // 8) ^ (rr % 8)) * 8 + kc % 8
        assert torch.equal(flat[off], terms[t])
    assert int(torch.count_nonzero(op)) == int(torch.count_nonzero(terms))


@pytest.mark.parametrize("tile_n, winners, want", [
    (128, 3, 128), (16384, 3, 16384), (128 << 10, 3, 128 << 10), (128 * 1025, 3, 128 * 205),
    (128 << 11, 3, 128 << 10), (128 << 16, 2, 128 << 16), (128 * 65537, 2, 128),
    (3 * (128 << 16), 2, 128 << 16), (128 << 20, 1, 128 << 20),
])
def test_list_tile_keeps_chunk_indices_in_their_bits(tile_n, winners, want):
    """A list-mode launch walks tiles whose chunk indices fit 32 // W bits
    (2^10 chunks at W 3, 2^16 at W 2), dividing the caller's tile (K7's
    result does not depend on the tile)."""
    assert scan_mma.list_tile(tile_n, winners) == want
    assert tile_n % want == 0 and want % 128 == 0
    assert want <= scan_mma.max_tile_rows(winners)


def fake_card(monkeypatch, launched, *kernels):
    """CPU tensors pass for CUDA ones and each kernel's launch records its
    arguments, so that the wrappers' host side runs here."""
    for kern in kernels:
        monkeypatch.setattr(kern, "launch",
                            lambda *a, kern=kern: launched.append((kern.symbol, a)))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tile_n", [512, 1024])
def test_merge_wrapper_routes_rows_by_dtype(dtype, tile_n, monkeypatch):
    """merge_topw_cuda hands both row dtypes to the tensor-core body, once:
    bf16 rows with the three bf16 query terms (query_operand, dtype 1), f32
    rows with the two tf32 terms (query_operand_tf32, dtype 0: 3xTF32),
    each on a tile its lists can name; nothing reaches the plain version."""
    n, d, b, w = 2048, 100, 5, 3
    rows = torch.zeros((n, d), dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    launched = []
    fake_card(monkeypatch, launched, merge.SCAN_MERGE_TOPW)
    monkeypatch.setattr(merge, "merge_topw_plain", lambda *a, **k: launched.append("plain"))
    ops = []
    for name in ("query_operand", "query_operand_tf32"):
        real = getattr(scan_mma, name)
        monkeypatch.setattr(scan_mma, name,
                            lambda q, real=real, name=name: ops.append((name, real(q))) or ops[-1][1])
    s, i = merge.merge_topw_cuda(rows, torch.zeros(n), torch.ones(n, dtype=torch.bool),
                                 torch.zeros((b, d)), metric=SimilarityMetric.EUCLIDEAN,
                                 winners=w, tile_n=tile_n)
    assert s.shape == i.shape == (w, b, merge.LANES)
    assert [sym for sym, _ in launched] == ["scan_merge_topw"]
    args = launched[0][1]
    want = "query_operand" if dtype == "bf16" else "query_operand_tf32"
    assert [name for name, _ in ops] == [want]
    assert args[0] == ops[0][1].data_ptr() and args[2] == rows.data_ptr()
    assert args[3] == int(dtype == "bf16")
    assert args[10:16] == (n, d, b, scan_mma.list_tile(tile_n, w), w, 1)
    assert len(args) == 17


def tf32_topw(values, sqnorms, valid, queries, metric, winners):
    """K7 over f32 rows on 3xTF32 (csrc/scan_mma.cuh TOPW), emulated: the
    queries and the rows split into their tf32 hi and lo terms as the
    wrapper and the kernel split them, hi.hi + hi.lo + lo.hi summed in
    float64, the kernel's epilogue (cosine by the norms' reciprocals,
    euclidean clamped, -inf where invalid), then each lane group's top W by
    (score descending, row ascending), (-inf, row 0) where it runs short:
    merge_topw_plain's [W, B, 128] form."""
    qh, ql = (t.double() for t in scan_mma.split_query_tf32(queries))
    xh, xl = (t.double() for t in scan_mma.split_query_tf32(values))
    dot = qh @ xh.T + qh @ xl.T + ql @ xh.T
    qsq = (queries.double() ** 2).sum(-1, keepdim=True)
    sq = sqnorms.double()[None, :]
    if metric is SimilarityMetric.COSINE:
        inv = lambda x: torch.where(x > 0, 1.0 / torch.sqrt(x), torch.zeros_like(x))  # noqa: E731
        s = dot * inv(qsq) * inv(sq)
    elif metric is SimilarityMetric.EUCLIDEAN:
        s = 1.0 / (1.0 + torch.sqrt(torch.clamp(qsq + sq - 2.0 * dot, min=0.0)))
    else:
        s = dot
    s = torch.where(valid[None, :], s.float(), float("-inf"))
    b, n = s.shape
    s, j = stable_topk(s.view(b, n // merge.LANES, merge.LANES).transpose(1, 2), winners)
    lane = torch.arange(merge.LANES)[None, :, None]
    rows = torch.where(s == float("-inf"), 0, lane + merge.LANES * j)
    return s.permute(2, 0, 1), rows.permute(2, 0, 1).to(torch.int32)


@pytest.mark.parametrize("shape", ["tied-2048x64-B8", "random-4096x384-B8"])
@pytest.mark.parametrize("winners", [1, 2, 3])
@pytest.mark.parametrize("metric", METRICS)
def test_tf32_topw_emulation_matches_merge_topw_plain(metric, winners, shape, rng):
    """K7's 3xTF32 form (tf32_topw: the query split and the row split,
    summed in float64) gives merge_topw_plain's lane-group top W under the
    1e-5 rule (card_lanes: the plain lists of W + 1, the same -inf
    pattern, scores within rtol/atol 1e-5, ids equal beyond 1e-5
    near-ties), on the tied inputs (rows copied inside and across lane
    groups, 10% invalid, a lane group with one live row) and on N(0, 1)
    rows of 384 dimensions scaled into [0.5, 2] with 5% invalid."""
    if shape.startswith("tied"):
        _, _, (v, sq, valid, q) = inputs(rng)
    else:
        n, d, b = 4096, 384, 8
        v = torch.from_numpy((rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, (n, 1)))
                             .astype(np.float32))
        valid = torch.from_numpy(rng.random(n) > 0.05)
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
        sq = (v * v).sum(-1)
    m = SimilarityMetric[metric]
    got = tf32_topw(v, sq, valid, q, m, winners)
    card_lanes(got, merge.merge_topw_plain(v, sq, valid, q, metric=m, winners=winners + 1),
               winners)


@pytest.mark.parametrize("change, error", [
    (dict(rows=torch.int8), TypeError), (dict(metric="MANHATTAN"), NotImplementedError),
    (dict(winners=4), ValueError), (dict(winners=0), ValueError),
    (dict(tile_n=1000), ValueError), (dict(tile_n=4096), ValueError),
], ids=["int8", "manhattan", "w4", "w0", "tile-not-x128", "tile-above-n"])
def test_merge_wrapper_refuses_before_any_launch(change, error, monkeypatch):
    """What K7 refused before the tensor-core body it refuses still, on
    either route, and nothing launches."""
    n, d = 2048, 64
    rows = torch.zeros((n, d), dtype=change.get("rows", torch.bfloat16))
    launched = []
    fake_card(monkeypatch, launched, merge.SCAN_MERGE_TOPW)
    with pytest.raises(error):
        merge.merge_topw_cuda(
            rows, torch.zeros(n), torch.ones(n, dtype=torch.bool), torch.zeros((2, d)),
            metric=SimilarityMetric[change.get("metric", "COSINE")],
            winners=change.get("winners", 2), tile_n=change.get("tile_n", 512))
    assert launched == []


@pytest.mark.parametrize("mode", decompose.MODES)
def test_fold_probe_wrapper_launches_the_tensor_core_body(mode, monkeypatch):
    """fold_probe_cuda hands bf16 rows and the split query operand to K8;
    a list mode's tile above 2^10 chunks at W 3 is refused before any
    launch."""
    n, d, b = 4096, 100, 5
    launched = []
    fake_card(monkeypatch, launched, decompose.SCAN_FOLD_PROBE)
    rows = torch.zeros((n, d), dtype=torch.bfloat16)
    s, i = decompose.fold_probe_cuda(rows, torch.zeros((b, d)), mode=mode, tile_n=1024,
                                     winners=3)
    assert s.shape == i.shape == (n // 1024, b, 128 if mode == "none" else 384)
    assert [sym for sym, _ in launched] == ["scan_fold_probe"]
    args = launched[0][1]
    assert isinstance(args[0], int)
    assert args[4:10] == (n, d, b, 1024, 3, decompose.MODES.index(mode))
    big = torch.zeros((128 << 11, 8), dtype=torch.bfloat16, device="meta")
    if mode != "none":
        with pytest.raises(ValueError, match="10-bit"):
            decompose.fold_probe_cuda(big, torch.zeros((b, 8), device="meta"), mode=mode,
                                      tile_n=128 << 11, winners=3)
    assert len(launched) == 1


# ---------------------------------------------------------- on the card


def card_lanes(got, want, winners, exact=None):
    """chip_smoke.py's rule for lane lists: the kernel's lists of W against
    the plain lists of W + 1, the same -inf pattern, finite scores within
    rtol/atol 1e-5, ids equal except among scores within 1e-5. With
    ``exact`` ([B, N] float64 dot products of the queries and rows, -inf
    where invalid: f32 rows under the dot metric) the scores are held to
    float64 instead of to the plain f32 product: a lane group with few live
    rows lists dots near 0, where two f32 orders of the same sum differ by
    more than 1e-5 at D 768 (3.09e-5 at a dot of 1.67 between 3xTF32 and
    the plain product, PERF.md), and the plain product itself lies up to
    1.3e-4 from float64 there. Each kernel score must lie within rtol/atol
    1e-5 of its row's float64 dot plus the plain version's own largest
    distance from float64 in the same lists."""
    ks, ki = (x.cpu() for x in got)
    ps, pi = (x.cpu() for x in want)
    assert torch.equal(ks == float("-inf"), ps[:winners] == float("-inf"))
    fin = ks != float("-inf")
    if exact is None:
        torch.testing.assert_close(ks[fin], ps[:winners][fin], rtol=1e-5, atol=1e-5)
    else:
        exact = exact.cpu()
        b = ks.shape[1]

        def f64_of(i_):  # [W, B, 128] rows -> their float64 dots
            return exact.gather(1, i_.permute(1, 0, 2).reshape(b, -1).long()).view(
                b, winners, -1).permute(1, 0, 2)
        dk, dp = f64_of(ki), f64_of(pi[:winners])
        slack = (ps[:winners].double() - dp)[fin].abs().max().item()
        err = (ks.double() - dk)[fin].abs()
        assert bool((err <= 1e-5 + 1e-5 * dk[fin].abs() + slack).all()), (
            err.max().item(), slack)
    for w, bq, lane in torch.nonzero(ki != pi[:winners]).tolist():
        col = ps[:, bq, lane]
        near = (col - col[w]).abs() <= 1e-5 * max(1.0, abs(float(col[w])))
        near[w] = False
        assert bool(near.any()), (w, bq, lane)


CARD_SHAPES = {"8192x100-B5": (8192, 100, 5, 2048), "8192x768-B70": (8192, 768, 70, 2048)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["2048x64-B8", *CARD_SHAPES])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_merge_kernel_matches_plain_on_the_card(dtype, shape, rng):
    """K7 on the tensor-core body over both row dtypes (bf16 rows: three
    bf16 query terms; f32 rows: 3xTF32), with TMA at D 64, the plain-load
    staging at D 100 (whose 200-byte bf16 rows TMA refuses; f32 rows load
    their A words from device memory only where D is not a multiple of 4),
    and at D 768 (bf16: the query terms too wide to stay in shared memory
    ride each stage) over two query blocks, W 1-3, three metrics. The tied
    inputs' ids agree exactly over bf16 rows; f32 rows, and the other
    shapes (random rows, 5% invalid, one lane group with one live row),
    hold the 1e-5 rule: scores within rtol/atol 1e-5, ids equal beyond
    1e-5 near-ties."""
    if not torch.cuda.is_available():
        pytest.skip("K7 is CUDA C++ and runs only on an NVIDIA card")
    dev = torch.device("cuda")
    if shape == "2048x64-B8":
        _, _, tops = inputs(rng, dtype)
        args, tile_n = [t.to(dev) for t in tops], TILE
    else:
        n, d, b, tile_n = CARD_SHAPES[shape]
        v = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
        valid = torch.from_numpy(rng.random(n) > 0.05)
        valid[3::128] = False
        valid[3 + 128 * 5] = True
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
        rows = v.to(torch.bfloat16) if dtype == "bf16" else v
        args = [t.to(dev) for t in (rows, (v * v).sum(-1), valid, q)]
    for metric in METRICS:
        for winners in (1, 2, 3):
            kw = dict(metric=SimilarityMetric[metric])
            got = merge.merge_topw_cuda(*args, tile_n=tile_n, winners=winners, **kw)
            if shape == "2048x64-B8" and dtype == "bf16":
                want = merge.merge_topw_plain(*args, winners=winners, **kw)
                assert torch.equal(got[1], want[1])
                torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
            else:
                exact = None
                if dtype == "f32" and metric == "DOT_PRODUCT":
                    v, _, valid, q = args
                    exact = torch.where(valid[None, :], q.double() @ v.double().T,
                                        float("-inf"))
                card_lanes(got, merge.merge_topw_plain(*args, winners=winners + 1, **kw),
                           winners, exact)
