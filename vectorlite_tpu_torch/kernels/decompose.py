"""The scan-decomposition probe: kernel K8 and its plain twin.

Port of the kernel of ``bench/decompose.py`` (``mk_kernel``, :66). Each
tile of ``tile_n`` rows is contracted with the queries (``q . v``, no
metric, no validity) and one of three selections follows, so that the
time of the contraction and of the selection can be read apart:

* ``none``: the tile's first 128 columns, ids 0 (the contraction alone);
* ``maxonly``: W rounds of the lane-group max (lane group = column mod
  128), each masking every score that reaches the round's max, ties
  included: the W largest distinct scores of each lane group, ids 0;
* ``full``: W rounds of the lane-group max and the lowest column that
  attains it (id = tile base + column), masking only that column: K3's
  selection without metric or validity.

Outputs are ``([N/tile, B, n_out] f32, [N/tile, B, n_out] int32)``,
``n_out`` 128 for ``none`` and ``128*W`` otherwise, at position ``w*128 +
l``. ``fold_probe_cuda`` launches K8 (``csrc/lanes.cu`` ``scan_fold_probe``)
on the tensor-core body (``csrc/scan_mma.cuh``: the f32 queries split into
three bf16 terms by ``scan_mma.query_operand``, wgmma over TMA-staged row
tiles, each thread's lists in registers), so it decomposes that body:
``none`` times its contraction, ``full`` minus ``none`` its lane-group
selection on the accumulators. That is not the f32 FMA contraction K1-K3
run (``csrc/scan_kernel.cuh``); PERF.md keeps that body's split.
``fold_probe_plain`` serves CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.metrics import SimilarityMetric
from . import _build, scan_mma
from .merge import LANES, MAX_WINNERS
from .scan import _check_tiling, _cuda_operands, _stream, _tiles, tile_scores

NEG_INF = float("-inf")

MODES = ("none", "maxonly", "full")

_P = ctypes.c_void_p
_I = ctypes.c_int

SCAN_FOLD_PROBE = _build.Kernel(
    "lanes", "scan_fold_probe",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)


def _n_out(mode: str, winners: int) -> int:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    return LANES if mode == "none" else LANES * winners


def fold_probe_plain(values, queries, *, mode, tile_n, winners=2):
    """Plain version of K8, one tile at a time."""
    n = values.shape[0]
    b = queries.shape[0]
    n_out = _n_out(mode, winners)
    dev = values.device
    zeros = torch.zeros(tile_n, dtype=torch.float32, device=dev)
    ones = torch.ones(tile_n, dtype=torch.bool, device=dev)
    col = torch.arange(tile_n, device=dev).view(tile_n // LANES, LANES)
    out_s, out_i = [], []
    for lo in range(0, n, tile_n):
        dot = tile_scores(values[lo:lo + tile_n], None, zeros, ones, queries,
                          SimilarityMetric.DOT_PRODUCT)  # [B, tile]
        if mode == "none":
            out_s.append(dot[:, :LANES])
            out_i.append(torch.zeros((b, LANES), dtype=torch.int32, device=dev))
            continue
        s = dot.view(b, tile_n // LANES, LANES)  # column m*128 + l
        ws, wi = [], []
        for _ in range(winners):
            m = s.amax(dim=1, keepdim=True)  # [B, 1, 128]
            if mode == "maxonly":
                ws.append(m[:, 0])
                wi.append(torch.zeros((b, LANES), dtype=torch.int32, device=dev))
                s = torch.where(s >= m, NEG_INF, s)
                continue
            cand = torch.where(s >= m, col, tile_n).amin(dim=1, keepdim=True)
            ws.append(m[:, 0])
            wi.append((cand[:, 0] + lo).to(torch.int32))
            s = torch.where(col == cand, NEG_INF, s)
        out_s.append(torch.cat(ws, dim=1))
        out_i.append(torch.cat(wi, dim=1))
    shape = (n // tile_n, b, n_out)
    return (torch.stack(out_s).reshape(shape),
            torch.stack(out_i).reshape(shape))


def fold_probe_cuda(values, queries, *, mode, tile_n, winners=2):
    """K8 over bf16 rows: same outputs as ``fold_probe_plain``."""
    n_out = _n_out(mode, winners)
    _check_tiling(values.shape[0], tile_n)
    if mode != "none" and not 1 <= winners <= MAX_WINNERS:
        raise ValueError(f"winners must be in [1, {MAX_WINNERS}]")
    if mode != "none" and tile_n > scan_mma.max_tile_rows(winners):
        raise ValueError(f"tile_n above {scan_mma.max_tile_rows(winners)} at W "
                         f"{winners}: a list names its rows by {32 // winners}-bit "
                         "chunk indices")
    _cuda_operands(values, None, None, None, queries, (torch.bfloat16,))
    q_op = scan_mma.query_operand(queries)
    n, d = values.shape
    b = queries.shape[0]
    dev = values.device
    shape = (n // tile_n, b, n_out)
    out_s = torch.empty(shape, dtype=torch.float32, device=dev)
    out_i = torch.empty(shape, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        SCAN_FOLD_PROBE.launch(
            q_op.data_ptr(), values.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            n, d, b, tile_n, winners, MODES.index(mode), _stream(dev),
        )
    return out_s, out_i


def fold_probe(values, queries, *, mode, tile_n, winners=2):
    """K8 for CUDA tensors, its plain version for CPU tensors."""
    _n_out(mode, winners)
    _check_tiling(values.shape[0], tile_n)
    return _tiles(fold_probe_plain, fold_probe_cuda, values=values,
                  queries=queries, mode=mode, tile_n=tile_n, winners=winners)


def dot_rowmax_library(values, queries):
    """The library yardstick of bench/decompose.py:51-58: one bf16
    product over all rows, then each query's max. Only timed beside K8."""
    q = queries.to(torch.bfloat16)
    return torch.mm(q, values.to(torch.bfloat16).T).amax(dim=1)
