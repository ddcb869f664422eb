"""The port's scan-decomposition probe (K8's plain twin on the CPU) against
the kernel of bench/decompose.py in interpret mode.

That script runs a 1M-row benchmark when imported, so its ``mk_kernel``
is lifted out of the source with ``ast`` and executed at a small shape,
with a ``pallas_call`` that interprets and hands back the ids beside the
scores (the script's ``run`` keeps only the scores). Scores agree within
rtol/atol 1e-5 (f32 sums taken in another order), ids exactly."""

import ast
import functools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vectorlite_tpu_torch.core.metrics import SimilarityMetric
from vectorlite_tpu_torch.kernels import decompose, scan

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "bench" / "decompose.py"
N, B, D, W = 4096, 8, 64, 2


@functools.lru_cache(maxsize=None)
def reference_kernel():
    """``mk_kernel`` of bench/decompose.py, bound to N, B, D here."""
    tree = ast.parse(SOURCE.read_text())
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == "mk_kernel")
    module = ast.Module(body=[fn], type_ignores=[])

    def pallas_call(kernel, **kw):
        call = pl.pallas_call(kernel, interpret=True, **kw)
        return lambda *args: [tuple(call(*args))]  # run()'s [0]: both outputs

    shim = types.SimpleNamespace(
        pallas_call=pallas_call, ds=pl.ds, program_id=pl.program_id,
        BlockSpec=pl.BlockSpec, CostEstimate=pl.CostEstimate,
    )
    namespace = {"jax": jax, "jnp": jnp, "pl": shim, "pltpu": pltpu,
                 "N": N, "B": B, "D": D}
    exec(compile(module, str(SOURCE), "exec"), namespace)
    return namespace["mk_kernel"]


def inputs(rng):
    """f32 queries and bf16 rows, with equal rows inside lane groups (rows
    5 and 5 + 3*128 of every tile) and across them (rows 9 and 10)."""
    values = rng.normal(size=(N, D)).astype(np.float32)
    for lo in range(0, N, 1024):
        values[lo + 5 + 3 * 128] = values[lo + 5]
        values[lo + 10] = values[lo + 9]
    q = rng.normal(size=(B, D)).astype(np.float32)
    jv = jnp.asarray(values).astype(jnp.bfloat16)
    tv = torch.from_numpy(values).to(torch.bfloat16)
    return (jnp.asarray(q), jv), (torch.from_numpy(q), tv)


@pytest.mark.parametrize("tile_n", [1024, 2048])
@pytest.mark.parametrize("mode", decompose.MODES)
def test_fold_probe_matches_reference(mode, tile_n, rng):
    (jq, jv), (tq, tv) = inputs(rng)
    js, ji = (np.asarray(x) for x in reference_kernel()(mode, tile_n, W)(jq, jv))
    ts, ti = decompose.fold_probe(tv, tq, mode=mode, tile_n=tile_n, winners=W)
    n_out = 128 if mode == "none" else 128 * W
    assert ts.shape == ti.shape == (N // tile_n, B, n_out)
    assert np.array_equal(ji, ti.numpy())
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5)
    if mode == "maxonly":  # the tie in lane group 5 masks both rows
        assert np.all(ts[:, :, 5].numpy() > ts[:, :, 128 + 5].numpy())
    if mode == "full":  # and takes them one after the other here
        tied = (ts[:, :, 5] == ts[:, :, 128 + 5]).numpy()
        assert tied.any() or tile_n != 1024
        assert np.all(ti[:, :, 128 + 5].numpy()[tied] - ti[:, :, 5].numpy()[tied] == 3 * 128)


@pytest.mark.parametrize("tile_n", [1024, 4096])
def test_full_is_block_topw_without_metric_or_validity(tile_n, rng):
    """``full`` is K3's selection (dot, every row valid), tile-major."""
    _, (tq, tv) = inputs(rng)
    s, i = decompose.fold_probe_plain(tv, tq, mode="full", tile_n=tile_n, winners=W)
    ks, ki = scan.block_topw_plain(
        tv, None, torch.zeros(N), torch.ones(N, dtype=torch.bool), tq,
        metric=SimilarityMetric.DOT_PRODUCT, tile_n=tile_n, winners=W,
    )
    assert torch.equal(i, ki.transpose(0, 1))
    assert torch.equal(s, ks.transpose(0, 1))


def test_more_winners_than_group_rows_follows_the_reference(rng):
    """W above the rows of a lane group: the reference's further rounds
    see only -inf, take column l again (id tile base + l), and score -inf."""
    (jq, jv), (tq, tv) = inputs(rng)
    for mode in ("maxonly", "full"):
        js, ji = (np.asarray(x) for x in reference_kernel()(mode, 128, 2)(jq, jv))
        ts, ti = decompose.fold_probe(tv, tq, mode=mode, tile_n=128, winners=2)
        assert np.array_equal(ji, ti.numpy())
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5)
        assert np.all(ts[:, :, 128:].numpy() == -np.inf)


def test_library_yardstick_is_the_row_max(rng):
    _, (tq, tv) = inputs(rng)
    s, _ = decompose.fold_probe_plain(tv, tq, mode="maxonly", tile_n=1024, winners=1)
    want = s.amax(dim=(0, 2))
    got = decompose.dot_rowmax_library(tv, tq).to(torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


def test_fold_probe_refusals(rng, monkeypatch):
    _, (tq, tv) = inputs(rng)
    with pytest.raises(ValueError, match="mode"):
        decompose.fold_probe(tv, tq, mode="argmax", tile_n=1024)
    for tile_n in (1000, 3072, 8192):
        with pytest.raises(ValueError):
            decompose.fold_probe(tv, tq, mode="full", tile_n=tile_n)
    meta = torch.zeros((N, D), dtype=torch.bfloat16, device="meta")
    meta_q = torch.zeros((B, D), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        decompose.fold_probe(meta, meta_q, mode="none", tile_n=1024)
    with pytest.raises(ValueError, match="winners"):
        decompose.fold_probe_cuda(meta, meta_q, mode="full", tile_n=1024, winners=4)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(TypeError):  # K8 reads bf16 rows only
        decompose.fold_probe_cuda(meta.to(torch.float32), meta_q, mode="full",
                                  tile_n=1024)


def lanes_close(got, want, winners, distinct):
    """chip_smoke.py's rule for K8's lists: the kernel's W against the plain
    W + 1, the same -inf pattern, scores within rtol/atol 1e-5, ids equal
    except among scores within 1e-5; maxonly (distinct) excuses a list
    holding two scores within 1e-5 (one side may keep them as one)."""
    t, b = got[0].shape[:2]
    ks, ki = (x.cpu().reshape(t, b, winners, 128) for x in got)
    ps, pi = (x.cpu().reshape(t, b, winners + 1, 128) for x in want)
    assert torch.equal(ks == float("-inf"), ps[:, :, :winners] == float("-inf"))
    pw = ps[:, :, :winners]
    fin = ks != float("-inf")
    off = ((ks - pw).abs() > 1e-5 + 1e-5 * pw.abs()) & fin
    for tile, bq, w, lane in torch.nonzero(off).tolist():
        assert distinct, (tile, bq, w, lane)
        near = [(col[1:] - col[:-1]).abs().le(1e-5 * col[1:].abs().clamp(min=1.0)).any()
                for col in (ks[tile, bq, :, lane], ps[tile, bq, :, lane])]
        assert any(bool(x) for x in near), (tile, bq, w, lane)
    for tile, bq, w, lane in torch.nonzero(ki != pi[:, :, :winners]).tolist():
        col = ps[tile, bq, :, lane]
        near = (col - col[w]).abs() <= 1e-5 * max(1.0, abs(float(col[w])))
        near[w] = False
        assert bool(near.any()), (tile, bq, w, lane)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["4096x64-B8", "16384x100-B5", "16384x768-B70"])
def test_fold_probe_kernel_matches_plain_on_the_card(shape, rng):
    """K8 on the tensor-core body, every mode, W 1-3. At the tied inputs
    (TMA staging, D 64; tiles 1024 and 2048) ids exactly and scores within
    rtol/atol 1e-5. At chip_smoke.py phase 2h's other shapes (tiles 8192
    and 16384): random rows of 200 bytes (which TMA refuses: the plain-load
    staging; B 5) and of D 768 (the query terms ride each stage; two query
    blocks), lists beyond 1e-5 near-ties and `none`'s raw dots within 1e-5
    x max(1, max |dot|). Lists of raw dots hold rtol 1e-5 only where they
    keep large dots, as with the 64 rows a lane group or more of those
    tiles: a dot near 0 of 768 terms is off float64 by ~1e-4 in any f32
    order, the plain version's included."""
    if not torch.cuda.is_available():
        pytest.skip("K8 is CUDA C++ and runs only on an NVIDIA card")
    dev = torch.device("cuda")
    if shape == "4096x64-B8":
        _, (tq, tv) = inputs(rng)
        tiles = (1024, 2048)
    else:
        n, d, b = (16384, 100, 5) if shape == "16384x100-B5" else (16384, 768, 70)
        tv = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(torch.bfloat16)
        tq = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
        tiles = (8192, 16384)
    tq, tv = tq.to(dev), tv.to(dev)
    for mode in decompose.MODES:
        for tile_n in tiles:
            for winners in ((W,) if mode == "none" else (1, 2, 3)):
                kw = dict(mode=mode, tile_n=tile_n)
                got = decompose.fold_probe_cuda(tv, tq, winners=winners, **kw)
                if shape == "4096x64-B8":
                    want = decompose.fold_probe_plain(tv, tq, winners=winners, **kw)
                    assert torch.equal(got[1], want[1])
                    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
                elif mode == "none":
                    want = decompose.fold_probe_plain(tv, tq, winners=winners, **kw)
                    assert not got[1].any()
                    scale = max(1.0, float(want[0].abs().max()))
                    assert float((got[0] - want[0]).abs().max()) <= 1e-5 * scale
                else:
                    want = decompose.fold_probe_plain(tv, tq, winners=winners + 1, **kw)
                    lanes_close(got, want, winners, distinct=mode == "maxonly")
