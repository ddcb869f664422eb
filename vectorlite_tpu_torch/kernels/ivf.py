"""IVF partitioned scan: the scale rung of the Flat index, with the Hopper
partition-probe kernel K6 and its plain twin.

Port of ``vectorlite_tpu/kernels/ivf.py``. A k-means coarse quantizer
splits the corpus into C cells; rows are stored cell-contiguous in one
``[C * P, D]`` matrix (bf16, or int8 with per-row scales), each cell
padded to a fixed width P (a multiple of 128) with -1 slots; rows of
cells fatter than P spill to their runner-up cell, then to a small dense
"extras" matrix that every query scans. A query reads only its ``nprobe``
nearest cells instead of the whole corpus.

* **Training** (``train_centroids``): Lloyd's k-means on the index's
  device, chunked by ``chunk`` rows as the reference's is, with the
  reference's init (``np.random.default_rng(seed).choice``) and dead
  centroids reseeded from an explicit ``torch.Generator``; its random
  draws are not JAX's, so the tests carry the JAX index's centroids
  across with ``centroids_from_reference``.
* **Assignment** (``assign_rows``): nearest cell, or the two nearest
  (ties to the lowest cell), chunked through the device.
* **Layout** (``build_layout``): a numpy copy of the reference's, line for
  line.
* **Search** (``ivf_search_topk_rescored``): an f32 coarse scan and the top
  ``nprobe`` cells; the probed blocks' dots (K6, ``csrc/ivf.cu``
  ``gather_score``, for CUDA tensors; ``gather_score_plain`` for CPU
  tensors); the top ``k_sel`` of the probed rows by the metric's
  surrogate; brute scores over the extras and over the tail of rows
  appended since the build; an exact f32 re-score of the merged pool
  (kernels/amk.py). Every top-k keeps the lowest index among ties, as
  ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import resolve_device
from ..core.metrics import SimilarityMetric, disable_tf32
from . import _build
from .amk import _exact_rescore_device, _matmul, _rank_scores
from .topk import stable_topk

NEG_INF = float("-inf")

#: pad factor: partition width P = ceil(pad * N_live / C), rounded up to a
#: lane multiple; ~20% block padding while only the fattest cells spill
PAD_FACTOR = 1.25

#: default probe width
NPROBE = 16

_P = ctypes.c_void_p
_I = ctypes.c_int

GATHER_SCORE = _build.Kernel(
    "ivf", "gather_score", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
)


# --------------------------------------------------------------- training


def _chunk_assign(rows, centroids, csq):
    """argmin_c |x - c|^2 for one chunk (|x|^2 is constant per row and
    drops out); the first cell among equal distances."""
    disable_tf32()
    dot = rows.to(torch.float32) @ centroids.T
    return torch.argmin(csq[None, :] - 2.0 * dot, dim=1)


def _kmeans(sample, init, gen, *, iters: int, chunk: int):
    """Lloyd's iterations over a sample padded to a chunk multiple: the
    assignment temp is [chunk, C], and the centroid update is a one-hot
    product per chunk. Dead centroids reseed from random sample rows."""
    s, d = sample.shape
    c = init.shape[0]
    iota = torch.arange(c, device=sample.device)
    cents = init
    for _ in range(iters):
        csq = torch.sum(cents * cents, dim=1)
        sums = torch.zeros((c, d), dtype=torch.float32, device=sample.device)
        counts = torch.zeros(c, dtype=torch.float32, device=sample.device)
        for lo in range(0, s, chunk):
            x = sample[lo : lo + chunk]
            onehot = (_chunk_assign(x, cents, csq)[:, None] == iota[None, :]).to(
                torch.float32
            )
            sums += onehot.T @ x
            counts += torch.sum(onehot, dim=0)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        reseed = sample[torch.randint(0, s, (c,), generator=gen, device=sample.device)]
        cents = torch.where((counts > 0)[:, None], new, reseed)
    return cents


def train_centroids(
    sample32: np.ndarray,  # [S, D] f32 live-row sample
    c: int,
    *,
    iters: int = 8,
    chunk: int = 8192,
    seed: int = 0,
    device=None,
) -> torch.Tensor:
    """Full-dimension k-means codebook [C, D] f32 on ``device``: the
    current CUDA device when None, which raises where there is none (pass
    ``device="cpu"`` for the CPU). The sample is padded with its own
    leading rows to a chunk multiple."""
    s, _d = sample32.shape
    if s < c:
        raise ValueError(f"IVF needs sample >= C rows ({s} < {c})")
    rng = np.random.default_rng(seed)
    init = sample32[rng.choice(s, c, replace=False)]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        sample32 = np.concatenate([sample32, sample32[:pad]], axis=0)
    disable_tf32()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _kmeans(
        torch.from_numpy(np.ascontiguousarray(sample32, dtype=np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(init, dtype=np.float32)).to(dev),
        gen, iters=iters, chunk=chunk,
    )


def centroids_from_reference(centroids: np.ndarray, *, device) -> torch.Tensor:
    """The JAX index's trained ``[C, D]`` centroids (as numpy) as the
    port's f32 tensor on ``device``: the learned state carried across, so
    both packages partition with the same cells."""
    cents = np.asarray(centroids)
    if cents.ndim != 2:
        raise ValueError(f"centroids must be [C, D], got {cents.shape}")
    return torch.from_numpy(np.array(cents, dtype=np.float32, order="C")).to(device)


def assign_rows(
    values64: np.ndarray,  # [N, D] host truth (any float dtype)
    live: np.ndarray,  # [L] live slot numbers
    centroids: torch.Tensor,  # [C, D] f32
    rot: torch.Tensor | None = None,
    *,
    chunk: int = 65536,
    top2: bool = False,
) -> np.ndarray:
    """Nearest cell per live slot ``[L]``, or with ``top2`` the two nearest
    ``[L, 2]`` (ties to the lowest cell), chunked through the centroids'
    device; each chunk casts its own rows to f32."""
    disable_tf32()
    dev = centroids.device
    csq = torch.sum(centroids * centroids, dim=1)
    if top2:
        chunk = min(chunk, 16384)  # [chunk, C] sort temp stays modest
        out = np.empty((len(live), 2), dtype=np.int32)
    else:
        out = np.empty(len(live), dtype=np.int32)
    for lo in range(0, len(live), chunk):
        sel = live[lo : lo + chunk]
        rows = torch.from_numpy(values64[sel].astype(np.float32)).to(dev)
        if rot is not None:
            rows = rows @ rot
        if top2:
            _, top = stable_topk(2.0 * (rows @ centroids.T) - csq[None, :], 2)
        else:
            top = _chunk_assign(rows, centroids, csq)
        out[lo : lo + chunk] = top.cpu().numpy()
    return out


# ----------------------------------------------------------- layout build


def build_layout(
    assign: np.ndarray,  # [L] or [L, 2] partition ids per live slot
    live: np.ndarray,  # [L] live slot numbers
    c: int,
    *,
    pad_factor: float = PAD_FACTOR,
    lane: int = 128,
) -> tuple[np.ndarray, np.ndarray]:
    """Partition-contiguous slot layout: ``(part_slots [C, P] int64,
    extra_slots [E] int64)``. ``part_slots[p]`` lists the slots stored in
    cell ``p`` (-1 pads); with a runner-up column in ``assign``, rows of
    cells fatter than P spill to their second cell's free slots before
    falling to the extras."""
    n_live = len(live)
    second = None
    if assign.ndim == 2:
        assign, second = assign[:, 0], assign[:, 1]
    p_width = int(np.ceil(pad_factor * max(n_live, 1) / c))
    p_width = max(lane, ((p_width + lane - 1) // lane) * lane)
    order = np.argsort(assign, kind="stable")
    sorted_parts = assign[order]
    sorted_slots = live[order]
    counts = np.bincount(sorted_parts, minlength=c)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    part_slots = np.full((c, p_width), -1, dtype=np.int64)
    fill = np.minimum(counts, p_width)
    spill_rows = []  # positions into `order` of first-pass overflow
    for p in range(c):
        s, n = starts[p], counts[p]
        take = min(n, p_width)
        part_slots[p, :take] = sorted_slots[s : s + take]
        if n > take:
            spill_rows.append(np.arange(s + take, s + n))
    extras = []
    if spill_rows:
        spill = np.concatenate(spill_rows)
        if second is None:
            extras.append(sorted_slots[spill])
        else:
            # place overflow into the runner-up cell's remaining capacity
            # (grouped per cell); what still doesn't fit goes to extras
            s2 = second[order][spill]
            for p in np.unique(s2):
                rows_p = spill[s2 == p]
                room = p_width - fill[p]
                take = min(room, len(rows_p))
                if take > 0:
                    part_slots[p, fill[p] : fill[p] + take] = (
                        sorted_slots[rows_p[:take]]
                    )
                    fill[p] += take
                if take < len(rows_p):
                    extras.append(sorted_slots[rows_p[take:]])
    extra_slots = (
        np.concatenate(extras) if extras else np.empty(0, dtype=np.int64)
    )
    return part_slots, extra_slots


# -------------------------------------------------------------------- K6


def _query_operand(part_rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """The f32 query the probe contracts: the query rounded to bf16 for
    bf16 blocks (each product then exact in f32), the f32 query itself
    for int8 blocks (rounding it to int8 would truncate)."""
    if part_rows.dtype == torch.int8:
        return queries.to(torch.float32)
    return queries.to(part_rows.dtype).to(torch.float32)


def gather_score_plain(part_rows, part_ids, queries, *, p_width):
    """Plain version of K6: gathers the probed blocks ``[B, L, P, D]`` and
    contracts them with the query in one f32 einsum."""
    disable_tf32()
    c = part_rows.shape[0] // p_width
    d = part_rows.shape[1]
    blocks = part_rows.reshape(c, p_width, d)[part_ids.to(torch.int64)]
    return torch.einsum(
        "blpd,bd->blp", blocks.to(torch.float32), _query_operand(part_rows, queries)
    )


def launch_gather_score(part_rows, part_ids, q_op, *, p_width):
    """Launch K6 on operands ``gather_score_cuda`` has checked: ``q_op`` is
    the contiguous f32 query operand (``_query_operand``)."""
    b, l_probe = part_ids.shape
    dev = part_rows.device
    out = torch.empty((b, l_probe, p_width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        GATHER_SCORE.launch(
            part_rows.data_ptr(), part_ids.data_ptr(), q_op.data_ptr(),
            out.data_ptr(), int(part_rows.dtype == torch.int8), b, l_probe,
            p_width, part_rows.shape[1], torch.cuda.current_stream(dev).cuda_stream,
        )
    return out


def gather_score_cuda(part_rows, part_ids, queries, *, p_width, check_ids=True):
    """K6 on the card: same output as ``gather_score_plain``. Type, shape
    and layout are checked on the host; ``check_ids`` also checks that
    every cell id lies in [0, C), which costs a device reduction and a
    host sync. The kernel indexes in 64 bits, so C * P * D is not bounded
    by 2^31."""
    dev = part_rows.device
    if not part_rows.is_cuda:
        raise ValueError(f"no kernel for tensors on {dev}")
    if (
        part_rows.dtype not in (torch.bfloat16, torch.int8)
        or part_rows.dim() != 2
        or not part_rows.is_contiguous()
    ):
        raise ValueError("part_rows must be a contiguous [C * P, D] bf16 or int8 tensor")
    rows_n, d = part_rows.shape
    if p_width <= 0 or rows_n % p_width:
        raise ValueError(f"part_rows ({rows_n}) is not a multiple of p_width ({p_width})")
    if (
        part_ids.device != dev
        or part_ids.dtype != torch.int32
        or part_ids.dim() != 2
        or not part_ids.is_contiguous()
    ):
        raise ValueError(f"part_ids must be a contiguous [B, L] int32 tensor on {dev}")
    b = part_ids.shape[0]
    if b > 65535:
        raise ValueError("at most 65,535 queries a launch")
    if queries.device != dev or queries.shape != (b, d):
        raise ValueError(f"queries must be a [{b}, {d}] tensor on {dev}")
    c = rows_n // p_width
    if check_ids and part_ids.numel():
        lo, hi = torch.aminmax(part_ids)
        if int(lo) < 0 or int(hi) >= c:
            raise ValueError(f"partition ids must lie in [0, {c})")
    q_op = _query_operand(part_rows, queries).contiguous()
    return launch_gather_score(part_rows, part_ids, q_op, p_width=p_width)


def gather_score_pallas(part_rows, part_ids, queries, *, p_width):
    """Raw dot scores [B, L, P] of every query against its probed cells:
    the plain version on CPU tensors; otherwise K6, which raises on
    anything but a CUDA tensor. Keeps the reference's name.

    The ids must lie in [0, C). The search takes them from a top-k over
    the C cells, so on the card this skips ``gather_score_cuda``'s id
    check and its host sync in the middle of the serving step."""
    if part_rows.device.type == "cpu":
        return gather_score_plain(part_rows, part_ids, queries, p_width=p_width)
    return gather_score_cuda(part_rows, part_ids, queries, p_width=p_width, check_ids=False)


# ---------------------------------------------------------------- search


def _rank_scores_rows(dot, metric: SimilarityMetric, sqnorms):
    """_rank_scores where sqnorms is already [B, W]-shaped (gathered per
    query) rather than a shared [N] column."""
    if metric is SimilarityMetric.DOT_PRODUCT:
        return dot
    if metric is SimilarityMetric.COSINE:
        return dot * torch.rsqrt(torch.clamp(sqnorms, min=1e-30))
    if metric is SimilarityMetric.EUCLIDEAN:
        return dot - 0.5 * sqnorms
    raise NotImplementedError("manhattan scans exactly (K4)")


def ivf_search_topk_rescored(
    part_rows: torch.Tensor,  # [C * P, D] bf16 / int8 cell-contiguous rows
    part_slots: torch.Tensor,  # [C * P] int32 original slot (-1 pad)
    part_sqnorms: torch.Tensor,  # [C * P] f32 exact |v|^2 (0 on pads)
    part_valid: torch.Tensor,  # [C * P] bool live & not tombstoned
    centroids: torch.Tensor,  # [C, D] f32
    cent_sqnorms: torch.Tensor,  # [C] f32
    extra_rows: torch.Tensor,  # [E, D] bf16 / int8 overflow rows
    extra_slots: torch.Tensor,  # [E] int32
    extra_sqnorms: torch.Tensor,  # [E] f32
    extra_valid: torch.Tensor,  # [E] bool
    values_exact: torch.Tensor,  # [cap, D] rung buffer (f32/bf16/int8 codes)
    valid: torch.Tensor,  # [cap] bool index validity mask
    queries: torch.Tensor,  # [B, D] f32
    tail_lo: int,  # first slot past the build
    size: int,  # append watermark (tail end)
    part_scales: torch.Tensor | None = None,  # [C * P] f32 (int8 layout)
    extra_scales: torch.Tensor | None = None,  # [E] f32 (int8 layout)
    values_scales: torch.Tensor | None = None,  # [cap] f32 (int8 rung)
    *,
    metric: SimilarityMetric,
    k: int,
    k_sel: int,
    nprobe: int,
    p_width: int,
    tail_pad: int,  # pow2 bucket covering the tail slice
    tombstones: bool,
):
    """Coarse scan -> top-L probe -> partition-block scores (K6) -> extra
    and tail brute scores -> merged pool -> exact f32 re-score from the
    slot-order rows. Returns (scores [B, k], slots [B, k]).

    The tail is ``values_exact[start : start + tail_pad]`` with ``start =
    min(tail_lo, cap - tail_pad)`` (the reference's clamped dynamic slice,
    slot numbers from the clamped start), masked to ``[tail_lo, size)``
    and to ``valid``. Pool entries are clamped at 0, so a -1 pad enters
    the re-score as slot 0 and the re-score's dedupe keeps slot 0 from
    being returned twice."""
    b = queries.shape[0]
    qf = queries.to(torch.float32)

    # 1. coarse scan: rank the cells by the metric's surrogate
    crank = _rank_scores(_matmul(qf, centroids), metric, cent_sqnorms)
    _, probe_ids = stable_topk(crank, nprobe)  # [B, L] int64

    # 2. partition-block scores, and the side tables gathered as whole
    # [P] blocks
    dot = gather_score_pallas(
        part_rows, probe_ids.to(torch.int32).contiguous(), qf, p_width=p_width
    )
    c = part_rows.shape[0] // p_width
    w = nprobe * p_width
    dot = dot.reshape(b, w)

    def blocks(table):
        return table.reshape(c, p_width)[probe_ids].reshape(b, w)

    if part_scales is not None:
        dot = dot * blocks(part_scales)
    prank = torch.where(
        blocks(part_valid),
        _rank_scores_rows(dot, metric, blocks(part_sqnorms)),
        NEG_INF,
    )

    # 3. candidate pool: probed top-k_sel, plus extras, plus the tail
    k_sel_eff = min(k_sel, w)
    _, sel = stable_topk(prank, k_sel_eff)
    cand = [torch.gather(blocks(part_slots).to(torch.int64), 1, sel)]

    e = extra_rows.shape[0]
    if e:
        if extra_rows.dtype == torch.int8:
            edot = _matmul(qf, extra_rows.to(torch.float32)) * extra_scales[None, :]
        else:
            edot = _matmul(qf, extra_rows)
        erank = torch.where(
            extra_valid[None, :], _rank_scores(edot, metric, extra_sqnorms), NEG_INF
        )
        _, esel = stable_topk(erank, min(k_sel_eff, e))
        cand.append(extra_slots.to(torch.int64)[esel])

    if tail_pad:
        cap = values_exact.shape[0]
        start = min(int(tail_lo), cap - tail_pad)
        trows = values_exact[start : start + tail_pad]
        tslots = start + torch.arange(tail_pad, device=values_exact.device)
        if values_scales is not None:
            # int8 rung: dequantize so tail scores live in the layout's space
            trows = trows.to(torch.float32) * values_scales[start : start + tail_pad, None]
        tdot = _matmul(qf, trows)
        tf = trows.to(torch.float32)
        tsq = torch.sum(tf * tf, dim=1)
        tok = (tslots >= int(tail_lo)) & (tslots < int(size)) & valid[tslots]
        trank = torch.where(
            tok[None, :], _rank_scores_rows(tdot, metric, tsq[None, :]), NEG_INF
        )
        _, tsel = stable_topk(trank, min(k_sel_eff, tail_pad))
        cand.append(tslots[tsel])

    pool = torch.clamp(torch.cat(cand, dim=1), min=0)

    # 4. exact re-score from the slot-order rows; -inf entries arrive
    # slot-clamped, so the watermark ``size`` (or the validity gather)
    # kills any slot past the live region
    return _exact_rescore_device(
        pool, values_exact, valid if tombstones else None, qf, metric, k,
        int(size), row_scales=values_scales,
    )
