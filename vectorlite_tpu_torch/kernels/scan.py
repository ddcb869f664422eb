"""Fused tiled scan + selection: the Hopper kernels and their plain twins.

Port of ``vectorlite_tpu/kernels/pallas_scan.py`` and
``vectorlite_tpu/kernels/pallas_l1.py``. The public wrappers keep the
reference's names and contracts so the two packages read side by side:

* ``pallas_search_topk`` / ``pallas_search_topk_int8`` — exact top-k
  without a ``[B, N]`` intermediate: kernel K1 / K2 keeps each tile's
  top-k, a stable sort merges the tiles. Up to k = 32 they run on the
  tensor-core body's per-query top-k mode (``csrc/exact.cu``: f32 rows
  ``scan_topk_exact_tf32``, three tf32 passes of the split queries and
  rows; bf16 rows ``scan_topk_exact_bf16``; int8 rows
  ``scan_topk_exact_s8``), up to k = 256 on its wide mode (``csrc/wide.cu``
  ``scan_topk_wide_tf32`` / ``_bf16`` / ``_s8``: lists in shared memory,
  merged a chunk at a time by bitonic networks), beyond it, and at any k
  past 32 over tiles of more than 32,768 rows, on its scores into a radix
  select
  (``csrc/select.cu`` ``scan_topk_select_tf32`` / ``_bf16`` / ``_s8``: the
  tensor-core body writes a group of tiles' scores to a scratch buffer,
  then a block a (query, tile) selects and sorts its list): the route is
  decided before any launch (``exact_route``). Past k = 256 the tiles grow
  to 32,768 rows where the rows allow (``exact_tile``).
* ``pallas_search_block_topk`` / ``pallas_search_block_topk_int8`` —
  lane-group top-W candidate selection: kernel K3 keeps, per tile and per
  lane group l (the rows ``l mod 128`` of the tile), the W best rows; a
  stable sort takes the top k of those. K3 has four routes, chosen by the
  rows' dtype and W before any launch (``block_route``): int8 rows
  (the default scan copy) on the tensor-core body's int8 form
  (``csrc/lanes.cu`` ``scan_block_topw_s8``: the f32 queries split into
  three int8 terms, exact s32 sums), bf16 rows on its bf16 form
  (``scan_block_topw_bf16``), f32 rows (the ``high-accuracy`` profile's
  speed path) on its 3xTF32 form (``scan_block_topw_tf32``: two tf32
  query terms, the rows split in registers), and W beyond what the body's
  registers hold on the CUDA-core body (``csrc/scan.cu``
  ``scan_block_topw``).
* ``pallas_search_block_topk_rescored`` — K3 selection over a scan copy,
  then an exact f32 re-score of the pool from the f32 rows, in torch.
* ``pallas_search_topk_l1`` — exact Manhattan top-k: kernel K4, each
  tile's top k of ``1 / (1 + sum |q - v|)``, on an FADD stream fed by TMA
  (``csrc/l1.cu``). Up to k = 32 (tiles of a multiple of 256 rows) the
  stream keeps each query's list in registers (``scan_topk_l1_fadd`` over
  f32 rows, ``scan_topk_l1_fadd_bf16`` over bf16 rows); beyond it the
  stream writes a group of tiles' scores to a scratch buffer and the radix
  select of ``csrc/select.cuh`` takes each tile's top k
  (``scan_topk_l1_select`` / ``_bf16``), on the tiles ``exact_tile``
  grows; the route is ``exact_route``'s.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain-torch version beside it (``tile_topk_plain``,
``block_topw_plain``), which computes the same per-tile selection with
the same (score descending, row ascending) order, so ids compare exactly
between the two. The merges after the kernels are torch: ``torch.topk``
makes no tie promise on CUDA, so they are stable sorts followed by a
slice.

Int8 scan copies carry per-row scales: the reference's
``pallas_search_block_topk`` passes the squared norms in the scale slot
(pallas_scan.py:317), which its int8 path multiplies into the dot. Here
an int8 row tensor only enters K3 together with its real scales.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.metrics import (
    SimilarityMetric,
    disable_tf32,
    l1_scores,
    metric_from_dot,
)
from . import _build, scan_mma
from .topk import stable_topk

NEG_INF = float("-inf")

DEFAULT_TILE_N = 2048
BLOCK = 128  # lane groups per tile in the block selection

#: K3 gives a lane group's rows to the 32 lanes of a warp.
BLOCK_TILE_MAX = BLOCK * 32

_METRIC_CODE = {
    SimilarityMetric.COSINE: 0,
    SimilarityMetric.EUCLIDEAN: 1,
    SimilarityMetric.DOT_PRODUCT: 2,
}

_P = ctypes.c_void_p
_I = ctypes.c_int


SCAN_BLOCK_TOPW = _build.Kernel(
    "scan", "scan_block_topw",
    [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
SCAN_BLOCK_TOPW_S8 = _build.Kernel(
    "lanes", "scan_block_topw_s8",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
SCAN_BLOCK_TOPW_BF16 = _build.Kernel(
    "lanes", "scan_block_topw_bf16",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
SCAN_BLOCK_TOPW_TF32 = _build.Kernel(
    "lanes", "scan_block_topw_tf32",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_L1_FADD = _build.Kernel(
    "l1", "scan_topk_l1_fadd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_L1_FADD_BF16 = _build.Kernel(
    "l1", "scan_topk_l1_fadd_bf16",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_L1_SELECT = _build.Kernel(
    "l1", "scan_topk_l1_select",
    [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_L1_SELECT_BF16 = _build.Kernel(
    "l1", "scan_topk_l1_select_bf16",
    [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_EXACT_TF32 = _build.Kernel(
    "exact", "scan_topk_exact_tf32",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_EXACT_BF16 = _build.Kernel(
    "exact", "scan_topk_exact_bf16",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_EXACT_S8 = _build.Kernel(
    "exact", "scan_topk_exact_s8",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_WIDE_TF32 = _build.Kernel(
    "wide", "scan_topk_wide_tf32",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_WIDE_BF16 = _build.Kernel(
    "wide", "scan_topk_wide_bf16",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_WIDE_S8 = _build.Kernel(
    "wide", "scan_topk_wide_s8",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_SELECT_TF32 = _build.Kernel(
    "select", "scan_topk_select_tf32",
    [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_SELECT_BF16 = _build.Kernel(
    "select", "scan_topk_select_bf16",
    [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
SCAN_TOPK_SELECT_S8 = _build.Kernel(
    "select", "scan_topk_select_s8",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)


# ------------------------------------------------------------ plain versions


def tile_scores(
    values: torch.Tensor,  # [N, D] f32 / bf16 / int8
    scales,  # [N] f32 for int8 rows, else None
    sqnorms,  # [N] f32 (unused for manhattan)
    valid: torch.Tensor,  # [N] bool
    queries: torch.Tensor,  # [B, D]
    metric: SimilarityMetric,
) -> torch.Tensor:
    """[B, N] scores as the kernels compute them: f32 queries against
    rows cast to f32, int8 dots times the row scale, manhattan as
    1 / (1 + sum |q - v|), -inf where invalid."""
    q = queries.to(torch.float32)
    if metric is SimilarityMetric.MANHATTAN:
        if scales is not None:
            raise ValueError("manhattan has no kernel over int8 rows")
        s = l1_scores(
            q, lambda lo, hi: values[lo:hi].to(torch.float32), values.shape[0]
        )
        return torch.where(valid[None, :], s, NEG_INF)
    disable_tf32()
    dot = q @ values.to(torch.float32).T
    if scales is not None:
        dot = dot * scales[None, :]
    qsq = torch.sum(q * q, dim=-1, keepdim=True)
    s = metric_from_dot(dot, qsq, sqnorms[None, :], metric)
    return torch.where(valid[None, :], s, NEG_INF)


def tile_topk_plain(
    values, scales, sqnorms, valid, queries, *, metric, k_tile, tile_n
):
    """Plain version of K1/K2: each tile's top ``k_tile`` as
    ([B, n_tiles, k_tile] scores, [B, n_tiles, k_tile] int32 rows)."""
    n = values.shape[0]
    b = queries.shape[0]
    n_tiles = n // tile_n
    s = tile_scores(values, scales, sqnorms, valid, queries, metric)
    s, pos = stable_topk(s.view(b, n_tiles, tile_n), k_tile)
    base = torch.arange(n_tiles, device=s.device)[None, :, None] * tile_n
    return s, (pos + base).to(torch.int32)


def block_topw_plain(
    values, scales, sqnorms, valid, queries, *, metric, tile_n, winners
):
    """Plain version of K3: per tile and lane group l, the ``winners``
    best of rows ``tile_base + l + 128 j`` as ([B, n_tiles, W*128] scores,
    int32 rows), position ``w*128 + l``."""
    s = tile_scores(values, scales, sqnorms, valid, queries, metric)
    return block_topw_of_scores(s, tile_n=tile_n, winners=winners)


def block_topw_of_scores(s, *, tile_n, winners):
    """K3's selection of a [B, N] score matrix: per tile and lane group l,
    the ``winners`` best of rows ``tile_base + l + 128 j`` by (score
    descending, row ascending), as ([B, n_tiles, W*128] scores, int32
    rows), position ``w*128 + l``."""
    b, n = s.shape
    n_tiles = n // tile_n
    g = tile_n // BLOCK
    s = s.view(b, n_tiles, g, BLOCK).transpose(2, 3)  # [B, T, l, j]
    s, j = stable_topk(s, winners)  # [B, T, 128, W]
    lane = torch.arange(BLOCK, device=s.device)[None, None, :, None]
    base = torch.arange(n_tiles, device=s.device)[None, :, None, None] * tile_n
    rows = base + lane + BLOCK * j
    s = s.permute(0, 1, 3, 2).reshape(b, n_tiles, winners * BLOCK)
    rows = rows.permute(0, 1, 3, 2).reshape(b, n_tiles, winners * BLOCK)
    return s, rows.to(torch.int32)


# ------------------------------------------------------------- CUDA launches


def _cuda_operands(values, scales, sqnorms, valid, queries, row_dtypes):
    """Check what the kernels take; returns (transposed f32 queries, f32
    query squared norms)."""
    dev = values.device
    if not values.is_cuda:
        raise ValueError(f"no kernel for tensors on {dev}")
    if values.dim() != 2 or not values.is_contiguous():
        raise ValueError("rows must be a contiguous [N, D] tensor")
    if values.dtype not in row_dtypes:
        raise TypeError(f"rows of dtype {values.dtype} are not supported")
    n, d = values.shape
    if n >= 1 << 31:
        raise ValueError("the kernels index rows with 32-bit integers")
    for name, t, dtype in (
        ("sqnorms", sqnorms, torch.float32),
        ("valid", valid, torch.bool),
        ("scales", scales, torch.float32),
    ):
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or t.shape != (n,):
            raise ValueError(f"{name} must be a [{n}] {dtype} tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.device != dev or queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"queries must be a [B, {d}] tensor on {dev}")
    q = queries.to(torch.float32)
    return q.T.contiguous(), torch.sum(q * q, dim=-1).contiguous()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


#: the longest per-tile list the tensor-core body's TOPK mode keeps (one
#: entry a lane of a warp)
MMA_MAX_K = 32
#: the longest per-tile list its wide mode keeps (256 entries a query in
#: shared memory), and the widest tile it takes (a list names its rows by
#: 16-bit offsets in the tile)
WIDE_MAX_K = 256
WIDE_MAX_TILE = 1 << 15
#: past WIDE_MAX_K (or WIDE_MAX_TILE) the radix select: the tile
#: exact_tile grows K1/K2's tile to (a tile's keys fill shared memory: past
#: it every digit pass reads them again from the scratch), and the bytes of
#: the scratch its scores go through (a group of whole tiles, at least one)
SELECT_MAX_TILE = 1 << 15
SELECT_SCRATCH_BYTES = 256 << 20


#: the longest per-tile list K4's FADD stream keeps (one entry a lane), and
#: the rows of its chunks, which its tiles must be a multiple of; past
#: either the stream's scores go into the radix select
L1_MAX_K = 32
L1_CHUNK = 256
_L1_FADD = {torch.float32: SCAN_TOPK_L1_FADD, torch.bfloat16: SCAN_TOPK_L1_FADD_BF16}
_L1_SELECT = {torch.float32: SCAN_TOPK_L1_SELECT, torch.bfloat16: SCAN_TOPK_L1_SELECT_BF16}


def l1_query_operand(queries, dtype):
    """K4's query image for rows of ``dtype``: [ceil(B / 64), slices, 64,
    S] f32, each block of 64 queries slice by slice (S = 32 dimensions a
    slice over f32 rows, 64 over bf16 rows: 128 bytes of a row), zero past
    B and D, contiguous."""
    ds = 32 if dtype == torch.float32 else 64
    b, d = queries.shape
    slices = -(-d // ds)
    blocks = -(-b // 64)
    img = torch.zeros((blocks * 64, slices * ds), dtype=torch.float32, device=queries.device)
    img[:b, :d] = queries
    return img.view(blocks, 64, slices, ds).transpose(1, 2).contiguous()


def exact_route(dtype, k, metric=SimilarityMetric.COSINE, tile_n=DEFAULT_TILE_N):
    """The per-tile top-k kernel for rows of ``dtype``, lists of ``k``,
    ``metric`` and tiles of ``tile_n`` rows: manhattan K4 (f32/bf16 rows),
    up to ``L1_MAX_K`` (tiles of a multiple of ``L1_CHUNK`` rows) on the
    FADD stream's lists, else on its scores into the radix select; up to
    ``MMA_MAX_K`` the tensor-core body's TOPK mode (f32 rows: 3xTF32, bf16
    rows, int8 rows: K2); up to ``WIDE_MAX_K`` (and tiles up to
    ``WIDE_MAX_TILE``) its wide mode; beyond them (any tile) its scores
    into the radix select."""
    if metric is SimilarityMetric.MANHATTAN:
        if dtype not in _L1_SELECT:
            raise ValueError(f"manhattan has no kernel over {dtype} rows")
        if k <= L1_MAX_K and tile_n % L1_CHUNK == 0:
            return _L1_FADD[dtype]
        return _L1_SELECT[dtype]
    if k <= MMA_MAX_K:
        return {torch.float32: SCAN_TOPK_EXACT_TF32, torch.bfloat16: SCAN_TOPK_EXACT_BF16,
                torch.int8: SCAN_TOPK_EXACT_S8}[dtype]
    if k <= WIDE_MAX_K and tile_n <= WIDE_MAX_TILE:
        return {torch.float32: SCAN_TOPK_WIDE_TF32, torch.bfloat16: SCAN_TOPK_WIDE_BF16,
                torch.int8: SCAN_TOPK_WIDE_S8}[dtype]
    return {torch.float32: SCAN_TOPK_SELECT_TF32, torch.bfloat16: SCAN_TOPK_SELECT_BF16,
            torch.int8: SCAN_TOPK_SELECT_S8}[dtype]


def exact_tile(n, tile_n, k, metric=SimilarityMetric.COSINE):
    """The tile K1 / K2 / K4 scan ``n`` rows at for lists of ``k``: the
    caller's ``tile_n`` up to k ``WIDE_MAX_K`` (manhattan, K4:
    ``L1_MAX_K``); past it, on the radix select, the largest multiple of
    ``tile_n`` that divides ``n`` and holds at most ``SELECT_MAX_TILE``
    rows (the select's time is linear in a tile's rows, and fewer tiles
    give fewer lists to sort and merge). Per-tile lists are ordered by
    (score descending, row ascending) and the merge is stable, so the
    merged top k is the same at any tile."""
    k_max = L1_MAX_K if metric is SimilarityMetric.MANHATTAN else WIDE_MAX_K
    if k <= k_max or tile_n > SELECT_MAX_TILE:
        return tile_n
    return max(tile_n * m for m in range(1, SELECT_MAX_TILE // tile_n + 1)
               if n % (tile_n * m) == 0)


def select_group_rows(n, b, tile_n):
    """Rows of a group of the radix select's tiles: as many whole tiles
    as ``SELECT_SCRATCH_BYTES`` of [b, rows] f32 scores hold, at least
    one, at most all ``n`` rows."""
    tiles = max(1, SELECT_SCRATCH_BYTES // (4 * b * tile_n))
    return min(n, tiles * tile_n)


def tile_topk_cuda(
    values, scales, sqnorms, valid, queries, *, metric, k_tile, tile_n
):
    """K1 (f32/bf16 rows), K2 (int8 rows + scales) or, for manhattan, K4
    (f32/bf16 rows) on the kernel ``exact_route`` names: same outputs as
    ``tile_topk_plain``. The radix select's routes (K1 / K2 past k 256,
    K4 past k 32) also take a [B, group rows] f32 scratch
    (``select_group_rows``)."""
    int8 = values.dtype == torch.int8
    l1 = metric is SimilarityMetric.MANHATTAN
    if int8 and scales is None:
        raise ValueError("int8 rows need their per-row scales")
    if not int8 and scales is not None:
        raise ValueError("per-row scales apply to int8 rows only")
    if int8 and l1:
        raise ValueError("manhattan has no kernel over int8 rows")
    if not 1 <= k_tile <= tile_n:
        raise ValueError(f"k_tile {k_tile} outside [1, {tile_n}]")
    _, qsq = _cuda_operands(
        values, scales, None if l1 else sqnorms, valid, queries,
        (torch.int8,) if int8 else (torch.float32, torch.bfloat16),
    )
    n, d = values.shape
    b = queries.shape[0]
    dev = values.device
    out_s = torch.empty((b, n // tile_n, k_tile), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, n // tile_n, k_tile), dtype=torch.int32, device=dev)
    kernel = exact_route(values.dtype, k_tile, metric, tile_n)
    metric_code = _METRIC_CODE.get(metric)
    if kernel in (SCAN_TOPK_L1_FADD, SCAN_TOPK_L1_FADD_BF16):
        q_op = l1_query_operand(queries.to(torch.float32), values.dtype)
        with torch.cuda.device(dev):
            kernel.launch(
                q_op.data_ptr(), values.data_ptr(), valid.data_ptr(),
                out_s.data_ptr(), out_i.data_ptr(),
                n, d, b, k_tile, tile_n, _stream(dev),
            )
        return out_s, out_i
    if kernel in (SCAN_TOPK_L1_SELECT, SCAN_TOPK_L1_SELECT_BF16):
        q_op = l1_query_operand(queries.to(torch.float32), values.dtype)
        group = select_group_rows(n, b, tile_n)
        scratch = torch.empty((b, group), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            kernel.launch(
                q_op.data_ptr(), values.data_ptr(), valid.data_ptr(),
                scratch.data_ptr(), group, out_s.data_ptr(), out_i.data_ptr(),
                n, d, b, k_tile, tile_n, _stream(dev),
            )
        return out_s, out_i
    if kernel.library == "select":
        group = select_group_rows(n, b, tile_n)
        scratch = torch.empty((b, group), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            if kernel is SCAN_TOPK_SELECT_S8:
                q_op, q_scale = scan_mma.query_operand_int8(queries)
                kernel.launch(
                    q_op.data_ptr(), q_scale.data_ptr(), qsq.data_ptr(), values.data_ptr(),
                    scales.data_ptr(), sqnorms.data_ptr(), valid.data_ptr(),
                    scratch.data_ptr(), group, out_s.data_ptr(), out_i.data_ptr(),
                    n, d, b, k_tile, tile_n, metric_code, _stream(dev),
                )
            else:
                q_op = (scan_mma.query_operand_tf32(queries) if values.dtype == torch.float32
                        else scan_mma.query_operand(queries))
                kernel.launch(
                    q_op.data_ptr(), qsq.data_ptr(), values.data_ptr(), sqnorms.data_ptr(),
                    valid.data_ptr(), scratch.data_ptr(), group,
                    out_s.data_ptr(), out_i.data_ptr(),
                    n, d, b, k_tile, tile_n, metric_code, _stream(dev),
                )
        return out_s, out_i
    if kernel in (SCAN_TOPK_EXACT_S8, SCAN_TOPK_WIDE_S8):
        q_op, q_scale = scan_mma.query_operand_int8(queries)
        with torch.cuda.device(dev):
            kernel.launch(
                q_op.data_ptr(), q_scale.data_ptr(), qsq.data_ptr(), values.data_ptr(),
                scales.data_ptr(), sqnorms.data_ptr(), valid.data_ptr(),
                out_s.data_ptr(), out_i.data_ptr(),
                n, d, b, k_tile, tile_n, metric_code, _stream(dev),
            )
        return out_s, out_i
    # the TOPK and wide modes over f32 (3xTF32) or bf16 rows
    if values.dtype == torch.float32:
        q_op = scan_mma.query_operand_tf32(queries)
    else:
        q_op = scan_mma.query_operand(queries)
    with torch.cuda.device(dev):
        kernel.launch(
            q_op.data_ptr(), qsq.data_ptr(), values.data_ptr(), sqnorms.data_ptr(),
            valid.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            n, d, b, k_tile, tile_n, metric_code, _stream(dev),
        )
    return out_s, out_i


#: the most lists a thread of the tensor-core body keeps for K3, by row
#: dtype (W scores and a word of ids each, 32 lists, beside the
#: accumulators: three s32 sets over int8 rows, two f32 sets over bf16
#: rows, two f32 sets and the slice sums over f32 rows)
MMA_MAX_WINNERS = {torch.int8: 3, torch.bfloat16: 3, torch.float32: 3}

_BLOCK_MMA = {torch.int8: SCAN_BLOCK_TOPW_S8, torch.bfloat16: SCAN_BLOCK_TOPW_BF16,
              torch.float32: SCAN_BLOCK_TOPW_TF32}


def block_route(dtype, winners):
    """The K3 kernel for rows of ``dtype`` and ``winners`` lists: the
    tensor-core body's int8, bf16 or 3xTF32 form up to
    ``MMA_MAX_WINNERS``, else (larger W) the CUDA-core body."""
    if winners <= MMA_MAX_WINNERS.get(dtype, 0):
        return _BLOCK_MMA[dtype]
    return SCAN_BLOCK_TOPW


def block_topw_cuda(
    values, scales, sqnorms, valid, queries, *, metric, tile_n, winners
):
    """K3 over f32, bf16 or int8 (+ scales) rows: same outputs as
    ``block_topw_plain``, on the kernel ``block_route`` names."""
    int8 = values.dtype == torch.int8
    if int8 and scales is None:
        raise ValueError("int8 rows need their per-row scales")
    if not int8 and scales is not None:
        raise ValueError("per-row scales apply to int8 rows only")
    if tile_n > BLOCK_TILE_MAX:
        raise ValueError(f"block tiles hold at most {BLOCK_TILE_MAX} rows")
    if not 1 <= winners <= tile_n // BLOCK:
        raise ValueError(f"winners must be in [1, {tile_n // BLOCK}]")
    if metric not in _METRIC_CODE:
        raise ValueError(f"no block selection for {metric.name}")
    q_t, qsq = _cuda_operands(
        values, scales, sqnorms, valid, queries,
        (torch.float32, torch.bfloat16, torch.int8),
    )
    n, d = values.shape
    b = queries.shape[0]
    dev = values.device
    shape = (b, n // tile_n, winners * BLOCK)
    out_s = torch.empty(shape, dtype=torch.float32, device=dev)
    out_i = torch.empty(shape, dtype=torch.int32, device=dev)
    kernel = block_route(values.dtype, winners)
    metric_code = _METRIC_CODE[metric]
    if kernel is SCAN_BLOCK_TOPW_S8:
        q_op, q_scale = scan_mma.query_operand_int8(queries)
        with torch.cuda.device(dev):
            kernel.launch(
                q_op.data_ptr(), q_scale.data_ptr(), qsq.data_ptr(), values.data_ptr(),
                scales.data_ptr(), sqnorms.data_ptr(), valid.data_ptr(),
                out_s.data_ptr(), out_i.data_ptr(),
                n, d, b, tile_n, winners, metric_code, _stream(dev),
            )
        return out_s, out_i
    if kernel in (SCAN_BLOCK_TOPW_BF16, SCAN_BLOCK_TOPW_TF32):
        q_op = (scan_mma.query_operand(queries) if kernel is SCAN_BLOCK_TOPW_BF16
                else scan_mma.query_operand_tf32(queries))
        with torch.cuda.device(dev):
            kernel.launch(
                q_op.data_ptr(), qsq.data_ptr(), values.data_ptr(), sqnorms.data_ptr(),
                valid.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                n, d, b, tile_n, winners, metric_code, _stream(dev),
            )
        return out_s, out_i
    dtype_code = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[values.dtype]
    with torch.cuda.device(dev):
        SCAN_BLOCK_TOPW.launch(
            q_t.data_ptr(), qsq.data_ptr(), values.data_ptr(), dtype_code,
            scales.data_ptr() if int8 else None,
            sqnorms.data_ptr(), valid.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(),
            n, d, b, tile_n, winners, metric_code, _stream(dev),
        )
    return out_s, out_i


# ------------------------------------------------------------------ wrappers


def _tiles(plain_fn, cuda_fn, **kw):
    """The plain version on CPU tensors; otherwise the kernel, which
    raises on anything but a CUDA tensor."""
    if kw["values"].device.type == "cpu":
        return plain_fn(**kw)
    return cuda_fn(**kw)


def _check_tiling(n: int, tile_n: int) -> None:
    if tile_n % BLOCK or n % tile_n:
        raise ValueError(
            f"rows ({n}) must be a multiple of tile_n ({tile_n}), "
            f"itself a multiple of {BLOCK}"
        )


def merge_topk(s: torch.Tensor, i: torch.Tensor, k: int):
    """Top k of flattened per-tile candidates [B, M]; equal scores keep
    their position (tile-major, so lower rows first for K1/K2)."""
    s, pos = stable_topk(s, k)
    return s, torch.gather(i, 1, pos)


def _exact(values, scales, sqnorms, valid, queries, metric, k, tile_n):
    n = values.shape[0]
    b = queries.shape[0]
    _check_tiling(n, tile_n)
    tile_n = exact_tile(n, tile_n, k, metric)
    s, i = _tiles(
        tile_topk_plain, tile_topk_cuda,
        values=values, scales=scales, sqnorms=sqnorms, valid=valid,
        queries=queries, metric=metric, k_tile=min(k, tile_n), tile_n=tile_n,
    )
    return merge_topk(s.reshape(b, -1), i.reshape(b, -1), k)


def _block(values, scales, sqnorms, valid, queries, metric, k, tile_n,
           winners):
    n = values.shape[0]
    b = queries.shape[0]
    _check_tiling(n, tile_n)
    s, i = _tiles(
        block_topw_plain, block_topw_cuda,
        values=values, scales=scales, sqnorms=sqnorms, valid=valid,
        queries=queries, metric=metric, tile_n=tile_n, winners=winners,
    )
    # candidate order interleaves lane groups (not row-monotonic), as in
    # the reference; every serving path re-sorts by row when it re-scores
    return merge_topk(s.reshape(b, -1), i.reshape(b, -1), k)


def pallas_search_topk(
    values, sqnorms, valid, queries, *, metric, k, tile_n=DEFAULT_TILE_N
):
    """Exact top-k over f32/bf16 rows without a [B, N] intermediate (K1).

    Returns (scores [B, k] f32, row indices [B, k] int32)."""
    if metric is SimilarityMetric.MANHATTAN:
        raise ValueError("manhattan goes through pallas_search_topk_l1")
    return _exact(values, None, sqnorms, valid, queries, metric, k, tile_n)


def pallas_search_topk_l1(values, valid, queries, *, k, tile_n=DEFAULT_TILE_N):
    """Exact Manhattan top-k over f32/bf16 rows without a [B, N]
    intermediate (K4); scores are 1 / (1 + L1) in f32.

    Returns (scores [B, k] f32, row indices [B, k] int32)."""
    return _exact(
        values, None, None, valid, queries, SimilarityMetric.MANHATTAN, k,
        tile_n,
    )


def pallas_search_topk_int8(
    values_q, scales, sqnorms, valid, queries, *, metric, k,
    tile_n=DEFAULT_TILE_N,
):
    """Exact top-k over int8 rows scored as ``(q . v) * scale`` with exact
    norms (K2); callers re-score the winners in f64 on the host."""
    return _exact(values_q, scales, sqnorms, valid, queries, metric, k, tile_n)


def pallas_search_block_topk(
    values, sqnorms, valid, queries, *, metric, k, tile_n=DEFAULT_TILE_N,
    winners=1,
):
    """Lane-group top-W candidate selection over f32/bf16 rows (K3).
    Int8 rows go through ``pallas_search_block_topk_int8`` with their
    scales."""
    if values.dtype == torch.int8:
        raise TypeError(
            "int8 rows need their scales: use pallas_search_block_topk_int8"
        )
    return _block(values, None, sqnorms, valid, queries, metric, k, tile_n,
                  winners)


def pallas_search_block_topk_int8(
    values_q, scales, sqnorms, valid, queries, *, metric, k,
    tile_n=DEFAULT_TILE_N, winners=1,
):
    """K3 over int8 rows with their real per-row scales."""
    return _block(values_q, scales, sqnorms, valid, queries, metric, k,
                  tile_n, winners)


def rescore_topk(values_exact, sqnorms, queries, s_sel, i_sel, *, metric, k):
    """Exact f32 scores of the candidate pool ``i_sel`` from the f32
    rows, then its top k with ties to the LOWEST row: candidates are
    sorted by row before the stable score sort (pallas_scan.py:438-468)."""
    disable_tf32()
    q = queries.to(torch.float32)
    idx = i_sel.to(torch.int64)
    rows = values_exact[idx].to(torch.float32)  # [B, k_sel, D]
    dot = torch.bmm(rows, q[:, :, None])[..., 0]
    qsq = torch.sum(q * q, dim=-1, keepdim=True)
    exact = metric_from_dot(dot, qsq, sqnorms[idx], metric)
    exact = torch.where(s_sel == NEG_INF, NEG_INF, exact)
    order = torch.argsort(i_sel, dim=1, stable=True)
    i_sel = torch.gather(i_sel, 1, order)
    exact = torch.gather(exact, 1, order)
    return merge_topk(exact, i_sel, k)


def pallas_search_block_topk_rescored(
    values_scan,  # [N, D] scan copy: f32, bf16, or int8 with scan_scales
    values_exact,  # [N, D] rows the pool is re-scored from
    sqnorms,  # [N] f32 exact squared norms
    valid,  # [N] bool
    queries,  # [B, D] f32
    *,
    metric,
    k,
    k_sel,
    tile_n=DEFAULT_TILE_N,
    winners=2,
    scan_scales=None,  # [N] f32, required with an int8 scan copy
):
    """Speed-mode scan: K3 selects ``k_sel`` candidates over the scan
    copy, then the pool is re-scored exactly in f32. Returned scores are
    the exact-f32 values the exhaustive kernel computes."""
    if values_scan.dtype == torch.int8:
        if scan_scales is None:
            raise ValueError("an int8 scan copy needs its per-row scales")
        s_sel, i_sel = pallas_search_block_topk_int8(
            values_scan, scan_scales, sqnorms, valid, queries,
            metric=metric, k=k_sel, tile_n=tile_n, winners=winners,
        )
    else:
        s_sel, i_sel = pallas_search_block_topk(
            values_scan, sqnorms, valid, queries,
            metric=metric, k=k_sel, tile_n=tile_n, winners=winners,
        )
    return rescore_topk(
        values_exact, sqnorms, queries, s_sel, i_sel, metric=metric, k=k
    )
