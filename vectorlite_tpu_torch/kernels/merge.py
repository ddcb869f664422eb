"""Tournament-merge selection: a running, exact, per-lane-group top-W over
the whole corpus (kernel K7) and its plain twin.

Port of ``vectorlite_tpu/kernels/pallas_merge.py``. Row r belongs to lane
group ``r mod 128``; for every (query, lane group) the selection keeps
the W best rows of the whole corpus, ordered by (score descending, row
ascending), as ``[W, B, 128]`` scores and int32 rows. A slot short of W
live rows holds (-inf, row 0), the reference's initialisation. The
``[B, W*128]`` pool then goes through a stable top-k (position ``w*128 +
l``, lowest position first among ties, as ``jax.lax.top_k``), and the
``_rescored`` form re-scores it exactly in f32 (kernels/amk.py).

* ``merge_topw_plain`` scores ``[B, N]`` with ``scan.tile_scores`` and
  takes each lane group's top W with a stable sort (CPU tensors).
* ``merge_topw_cuda`` launches K7 (``csrc/lanes.cu`` ``scan_merge_topw``),
  a block per (64 queries, tile) that keeps the tile's per-lane-group top W,
  then a reduce pass that merges the tiles' partials in row order. The TPU
  kernel carries its state across a sequential grid; blocks here run in no
  order, hence the partials. Both row dtypes run on the tensor-core body
  (``csrc/scan_mma.cuh``: wgmma over TMA-staged row tiles, the lists in
  registers): bf16 rows (the merge engine's scan copy) with the f32
  queries split into three bf16 terms (``scan_mma.query_operand``), f32
  rows on 3xTF32, the queries split into two tf32 terms
  (``scan_mma.query_operand_tf32``) and each row word into its hi and lo
  terms in registers. Over f32 rows K7 is held to the rule K1 over f32
  rows is held to on the same contraction: scores within rtol/atol 1e-5
  of the plain version's, ids equal beyond 1e-5 near-ties; its dot
  lists, which reach dots near 0 in lane groups with few live rows, are
  held to float64 instead (``chip_smoke.py`` ``compare_lanes``).

``tile_n`` sets only how the rows are split among blocks: a lane group is
``row mod 128`` whatever the tile, so the result does not depend on it.

One difference from the reference, on purpose: its insertion network
(pallas_merge.py:115-121) passes a displaced entry down only when it
strictly beats the next rung, so when two rungs hold equal scores and a
better row arrives, the lower of the two tied rows is the one dropped.
The port keeps the lowest rows among equal scores, which is the order
every other selection in the package keeps (the two agree on the scores
always, and on the rows whenever no such displacement happens).

Int8 rows are refused: the reference's wrapper puts the squared norms in
the per-row scale slot (pallas_merge.py:210), the fault ROADMAP.md §4
records for K3, and takes no scales.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.metrics import SimilarityMetric
from . import _build, scan_mma
from .amk import _exact_rescore_device
from .scan import (
    _METRIC_CODE,
    _check_tiling,
    _cuda_operands,
    _stream,
    _tiles,
    merge_topk,
    tile_scores,
)
from .topk import stable_topk

NEG_INF = float("-inf")

LANES = 128
DEFAULT_TILE_N = 16384

#: K7 keeps W (score, row) pairs a list, in registers beside the
#: accumulators (32 lists a thread)
MAX_WINNERS = 3

_P = ctypes.c_void_p
_I = ctypes.c_int

SCAN_MERGE_TOPW = _build.Kernel(
    "lanes", "scan_merge_topw",
    [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)


def _check_rows(values, metric) -> None:
    if values.dtype == torch.int8:
        raise TypeError(
            "the merge engine takes f32 or bf16 rows: the reference passes "
            "the squared norms as int8 scales"
        )
    if metric is SimilarityMetric.MANHATTAN:
        raise NotImplementedError("manhattan uses the tiled XLA path")


def merge_topw_plain(values, sqnorms, valid, queries, *, metric, winners):
    """Plain version of K7: ([W, B, 128] scores, [W, B, 128] int32 rows),
    each lane group's top ``winners`` over the whole corpus."""
    n = values.shape[0]
    b = queries.shape[0]
    s = tile_scores(values, None, sqnorms, valid, queries, metric)
    s = s.view(b, n // LANES, LANES).transpose(1, 2)  # [B, l, j]
    if s.shape[2] < winners:
        s = torch.nn.functional.pad(s, (0, winners - s.shape[2]), value=NEG_INF)
    s, j = stable_topk(s, winners)  # [B, 128, W]
    lane = torch.arange(LANES, device=s.device)[None, :, None]
    rows = torch.where(s == NEG_INF, 0, lane + LANES * j)
    return (s.permute(2, 0, 1).contiguous(),
            rows.permute(2, 0, 1).to(torch.int32).contiguous())


def merge_topw_cuda(values, sqnorms, valid, queries, *, metric, winners,
                    tile_n=DEFAULT_TILE_N):
    """K7 over f32 or bf16 rows: same outputs as ``merge_topw_plain``."""
    _check_rows(values, metric)
    if not 1 <= winners <= MAX_WINNERS:
        raise ValueError(f"winners must be in [1, {MAX_WINNERS}]")
    _check_tiling(values.shape[0], tile_n)
    _, qsq = _cuda_operands(
        values, None, sqnorms, valid, queries, (torch.float32, torch.bfloat16)
    )
    n, d = values.shape
    b = queries.shape[0]
    bf16 = values.dtype == torch.bfloat16
    # the tensor-core body: split queries, tiles its lists can name
    q_op = scan_mma.query_operand(queries) if bf16 else scan_mma.query_operand_tf32(queries)
    tile_n = scan_mma.list_tile(tile_n, winners)
    dev = values.device
    part = (n // tile_n, b, winners * LANES)
    part_s = torch.empty(part, dtype=torch.float32, device=dev)
    part_i = torch.empty(part, dtype=torch.int32, device=dev)
    out_s = torch.empty((winners, b, LANES), dtype=torch.float32, device=dev)
    out_i = torch.empty((winners, b, LANES), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        SCAN_MERGE_TOPW.launch(
            q_op.data_ptr(), qsq.data_ptr(), values.data_ptr(),
            int(bf16), sqnorms.data_ptr(), valid.data_ptr(),
            part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(),
            n, d, b, tile_n, winners, _METRIC_CODE[metric], _stream(dev),
        )
    return out_s, out_i


def pallas_search_merge_topk(
    values, sqnorms, valid, queries, *, metric, k, tile_n=DEFAULT_TILE_N,
    winners=2,
):
    """Candidate selection by the tournament merge (K7): returns (scores
    [B, k], rows [B, k]) ranked on the scan dtype's scores; pair it with
    an exact re-score for serving (the ``_rescored`` form)."""
    _check_rows(values, metric)
    _check_tiling(values.shape[0], tile_n)
    b = queries.shape[0]
    s, i = _tiles(
        merge_topw_plain,
        functools.partial(merge_topw_cuda, tile_n=tile_n),
        values=values, sqnorms=sqnorms, valid=valid, queries=queries,
        metric=metric, winners=winners,
    )
    # [W, B, 128] -> [B, W*128], position w*128 + l: lane-interleaved, not
    # row-monotonic; the re-score sorts the pool by row
    s = s.transpose(0, 1).reshape(b, winners * LANES)
    i = i.transpose(0, 1).reshape(b, winners * LANES)
    return merge_topk(s, i, k)


def pallas_search_merge_topk_rescored(
    values_scan,  # [N, D] f32 / bf16 scan copy
    values_exact,  # [N, D] rows the pool is re-scored from
    sqnorms,  # [N] f32 exact squared norms
    valid,  # [N] bool
    queries,  # [B, D] f32
    *,
    metric,
    k,
    k_sel=128,
    tile_n=DEFAULT_TILE_N,
    winners=2,
    tombstones=True,
    live_hi=None,
):
    """Tournament-merge selection + exact f32 re-score. With
    ``tombstones`` False the live rows are the prefix below ``live_hi``
    (the count of valid rows when None); otherwise ``valid`` decides."""
    _, i_sel = pallas_search_merge_topk(
        values_scan, sqnorms, valid, queries, metric=metric,
        k=min(k_sel, winners * LANES), tile_n=tile_n, winners=winners,
    )
    if not tombstones:
        if live_hi is None:
            live_hi = torch.sum(valid.to(torch.int32))
        return _exact_rescore_device(
            i_sel, values_exact, None, queries, metric, k, live_hi
        )
    return _exact_rescore_device(i_sel, values_exact, valid, queries, metric, k, 0)
