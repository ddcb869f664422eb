"""Corpus-sharded search over a mesh of devices.

Port of ``vectorlite_tpu/dist/sharding.py``. The corpus ``[cap, D]`` is
split by rows into ``mesh.size`` equal shards; shard ``s`` owns global
rows ``[s * rows_per_shard, (s + 1) * rows_per_shard)``. Each search runs
the single-device engine on every shard, then merges:

  per shard: the scan kernel over its rows  ->  local top-k
  tag local rows with the shard's offset, gather to the mesh's first
  device (and across processes, ``dist/multihost.py``)
  stable top-k of the shard-major candidates  ->  exact global top-k

The merge is exact because the global top-k is a subset of the per-shard
top-ks, and it breaks equal scores to the lower global row: every list is
sorted by (score descending, row ascending) and the concatenation is
shard-major, so ``kernels/topk.stable_topk`` (``torch.topk`` makes no tie
promise on CUDA) keeps the lower shard first.

A mesh is a tuple of explicit ``torch.device``s, which may repeat: on the
CPU a repeated ``cpu`` stands in for JAX's virtual devices, and on one
card ``cuda:0`` four times runs the sharded code at four shards. A shard
is a tensor of its own on its device; sharded buffers are lists of them.
With a process group (``make_mesh(..., group=)``) the devices are this
process's, and the global shard index of its s-th device is ``rank *
len(devices) + s``.

Each shard routes as the single-device index does (``index/flat.py``
``_device_topk``) at the shard's row count: at or above
``_PALLAS_MIN_CAPACITY`` rows the kernel wrappers of ``kernels/scan.py``
(K1 exact, K2 over int8 rows, K3 lane-group selection, K4 Manhattan) with
the index's tiles, below it the full-score path of ``kernels/topk.py``.
A shard whose rows are not a multiple of the tile (3 or 6 shards make
such shards) runs the kernel over its tile-aligned body and once more
over its last rows, copied into a zero-padded tile of ``TAIL_ROWS``
multiples. The PQ rank (K5) and the partition probe (K6) run per shard
through ``kernels/pq.py`` and ``kernels/ivf.py``.

No shard loop reads a device value on the host: the launches of every
shard are queued before the merge, and the copies into the first device
are ordered after the kernels that wrote them (torch's cross-device copy
waits on the source's stream).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.metrics import SimilarityMetric
from ..kernels import scan
from ..kernels.amk import _matmul, _rank_scores, rescore_rows, sorted_pool
from ..kernels.topk import search_topk, search_topk_int8, stable_topk

NEG_INF = float("-inf")

#: a ragged shard's last rows are padded to a multiple of this: a multiple
#: of K3's 128 lane groups and of K4's 256-row chunks
TAIL_ROWS = 256


@dataclass(frozen=True, eq=False)
class Mesh:
    """The shards' devices of this process (``devices``), and, across
    processes, the process group, this process's rank and their number."""

    devices: tuple
    group: object = None
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        """Shards across every process."""
        return len(self.devices) * self.world

    @property
    def first(self) -> torch.device:
        """The device the merged results land on."""
        return self.devices[0]

    def shard_ids(self) -> range:
        """Global indices of this process's shards, in device order."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)

    def distinct_devices(self) -> list:
        return list(dict.fromkeys(self.devices))


def make_mesh(devices=None, *, group=None) -> Mesh:
    """1-D corpus-sharding mesh over the given devices (repeats allowed),
    by default every visible CUDA device. ``group`` joins the processes
    of a ``torch.distributed`` group, each passing its own devices (the
    same number in each): NCCL for CUDA devices, gloo for the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass the mesh's devices "
                "(e.g. ['cpu'] * 8) to shard on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError("a mesh's devices must all be CUDA devices or all the CPU")
    if group is None:
        return Mesh(tuple(devs))
    from . import multihost

    multihost.check_backend(group, devs[0])
    import torch.distributed as tdist

    return Mesh(
        tuple(devs), group, tdist.get_rank(group), tdist.get_world_size(group)
    )


def rows_per_shard(mesh: Mesh, cap: int) -> int:
    if cap % mesh.size:
        raise ValueError(f"{cap} rows do not split into {mesh.size} shards")
    return cap // mesh.size


def shard_rows(mesh: Mesh, array, dtype=None) -> list:
    """This process's shards of a full ``[cap, ...]`` host array or
    tensor: one tensor of its own a shard, on the shard's device (a host
    array cast to ``dtype`` on the host first)."""
    rps = rows_per_shard(mesh, array.shape[0])
    out = []
    for dev, g in zip(mesh.devices, mesh.shard_ids()):
        part = array[g * rps : (g + 1) * rps]
        if isinstance(part, np.ndarray):
            part = np.ascontiguousarray(part)
            t = torch.from_numpy(part if part.flags.writeable else part.copy())
            out.append((t if dtype is None else t.to(dtype)).to(dev, copy=True))
        else:
            part = part if dtype is None else part.to(dtype)
            out.append(part.to(dev, copy=True).contiguous())
    return out


def shard_corpus(mesh: Mesh, values, sqnorms, valid):
    """Place corpus arrays row-sharded across the mesh (queries are passed
    whole; each shard takes a copy on its device)."""
    return (
        shard_rows(mesh, values),
        shard_rows(mesh, sqnorms),
        shard_rows(mesh, valid),
    )


# ------------------------------------------------------------ per shard


def _kernel_scale(rows: int) -> bool:
    """The single-device index's threshold (read at call time, so tests
    that lower it reach the kernel path at small sizes)."""
    from ..index import flat

    return flat._use_pallas(rows)


def _split(tensor, body: int, tail_pad: int):
    """(the first ``body`` rows, the rest copied into ``tail_pad`` zeroed
    rows)."""
    tail = tensor.new_zeros((tail_pad, *tensor.shape[1:]))
    tail[: tensor.shape[0] - body] = tensor[body:]
    return tensor[:body], tail


def _ragged(fn, tensors: tuple, n: int, tile: int, k: int):
    """``fn(*tensors, tile_n, k)`` over the tile-aligned body of ``n``
    rows and over the zero-padded rest; the tail's rows are offset and
    both lists merged (the body's first, so equal scores keep the lower
    row). Padded rows must be invalid in ``tensors``' mask."""
    body = n - n % tile
    if body == n:
        return fn(*tensors, tile_n=tile, k=min(k, n))
    tail_pad = -(-(n - body) // TAIL_ROWS) * TAIL_ROWS
    heads, tails = zip(*(_split(t, body, tail_pad) for t in tensors))
    parts = [fn(*heads, tile_n=tile, k=min(k, body))] if body else []
    s, i = fn(*tails, tile_n=tail_pad, k=min(k, tail_pad))
    parts.append((s, i + body))
    return _merge([(s, i.to(torch.int64)) for s, i in parts], k)


def _merge(parts, k: int):
    """Stable top k of lists concatenated in order."""
    s = torch.cat([p[0] for p in parts], dim=1)
    i = torch.cat([p[1] for p in parts], dim=1)
    s, pos = stable_topk(s, min(k, s.shape[1]))
    return s, torch.gather(i, 1, pos)


def _tiles():
    """The single-device index's tiles (f32 rows, bf16 rows, K3) and K3's
    winners a lane group."""
    from ..index import flat

    return (flat._PALLAS_TILE_F32, flat._PALLAS_TILE_BF16, flat._PALLAS_TILE_BLOCK,
            flat._BLOCK_WINNERS)


def shard_topk(values, sqnorms, valid, queries, *, metric, k, scales=None):
    """One shard's exact top-k with the single-device routing: K4 for
    Manhattan over f32/bf16 rows, K2 over int8 rows (+ ``scales``), K1
    otherwise, at kernel scale; the full-score path below it (and for
    Manhattan over int8 rows, which has no kernel)."""
    n = values.shape[0]
    k = min(k, n)
    int8 = values.dtype == torch.int8
    l1 = metric is SimilarityMetric.MANHATTAN
    if not _kernel_scale(n) or (int8 and l1):
        if int8:
            return search_topk_int8(values, scales, sqnorms, valid, queries,
                                    metric=metric, k=k)
        return search_topk(values, sqnorms, valid, queries, metric=metric, k=k)
    tile_f32, tile_bf16, _, _ = _tiles()
    if l1:
        return _ragged(
            lambda v, va, tile_n, k: scan.pallas_search_topk_l1(
                v, va, queries, k=k, tile_n=tile_n),
            (values, valid), n, tile_f32, k,
        )
    if int8:
        return _ragged(
            lambda v, sc, sq, va, tile_n, k: scan.pallas_search_topk_int8(
                v, sc, sq, va, queries, metric=metric, k=k, tile_n=tile_n),
            (values, scales, sqnorms, valid), n, tile_f32, k,
        )
    tile = tile_bf16 if values.dtype == torch.bfloat16 else tile_f32
    return _ragged(
        lambda v, sq, va, tile_n, k: scan.pallas_search_topk(
            v, sq, va, queries, metric=metric, k=k, tile_n=tile_n),
        (values, sqnorms, valid), n, tile, k,
    )


def shard_block_pool(values_scan, sqnorms, valid, queries, *, metric, k_sel):
    """One shard's speed-path candidate pool [B, <= k_sel] of rows: K3's
    lane-group selection over the (f32 or bf16) scan copy at kernel
    scale, else the exact top ``k_sel`` of the full score matrix over
    it."""
    n = values_scan.shape[0]
    k_sel = min(k_sel, n)
    if not _kernel_scale(n):
        return search_topk(values_scan, sqnorms, valid, queries, metric=metric,
                           k=k_sel)[1]
    _, _, tile, winners = _tiles()
    return _ragged(
        lambda v, sq, va, tile_n, k: scan.pallas_search_block_topk(
            v, sq, va, queries, metric=metric, k=k, tile_n=tile_n, winners=winners),
        (values_scan, sqnorms, valid), n, tile, k_sel,
    )[1]


# ---------------------------------------------------------------- merges


def _merge_local_topk(mesh: Mesh, parts, rows: int, k: int):
    """Tag each shard's winners with its global row offset, gather them
    to the first device shard-major (then across processes, rank-major),
    and keep the stable top k: (scores [B, k] f32, global rows [B, k]
    int64), columns past the candidates padded with (-inf, 0)."""
    s_all, i_all = [], []
    for g, (s, i) in zip(mesh.shard_ids(), parts):
        s_all.append(s.to(mesh.first, non_blocking=True))
        i_all.append(i.to(mesh.first, torch.int64, non_blocking=True) + g * rows)
    s, i = _merge(list(zip(s_all, i_all)), k)
    if mesh.world > 1:
        from .multihost import gather_ranks

        b = s.shape[0]
        s_r = gather_ranks(mesh, s).permute(1, 0, 2).reshape(b, -1)
        i_r = gather_ranks(mesh, i).permute(1, 0, 2).reshape(b, -1)
        s, i = _merge([(s_r, i_r)], k)
    if s.shape[1] < k:
        pad = k - s.shape[1]
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        i = torch.nn.functional.pad(i, (0, pad))
    return s, i


def _local(mesh: Mesh, queries):
    """The queries on each shard's device, one copy a distinct device."""
    q = torch.as_tensor(queries)
    copies = {d: q.to(d, torch.float32, non_blocking=True) for d in mesh.distinct_devices()}
    return [copies[d] for d in mesh.devices]


def sharded_search_topk(values, sqnorms, valid, queries, *, metric, k, mesh):
    """Exact distributed top-k: per-shard scan (K1, or K4 for Manhattan)
    and the merge. ``values`` / ``sqnorms`` / ``valid`` are this
    process's shards. Returns (scores [B, k], global rows [B, k]) on the
    mesh's first device."""
    rows = values[0].shape[0]
    parts = [
        shard_topk(v, sq, va, q, metric=metric, k=k)
        for v, sq, va, q in zip(values, sqnorms, valid, _local(mesh, queries))
    ]
    return _merge_local_topk(mesh, parts, rows, k)


def sharded_search_topk_int8(values_q, scales, sqnorms, valid, queries, *,
                             metric, k, mesh):
    """Quantized-profile distributed top-k (K2 per shard); callers
    re-score the winners exactly on the host."""
    rows = values_q[0].shape[0]
    parts = [
        shard_topk(v, sq, va, q, metric=metric, k=k, scales=sc)
        for v, sc, sq, va, q in zip(values_q, scales, sqnorms, valid,
                                    _local(mesh, queries))
    ]
    return _merge_local_topk(mesh, parts, rows, k)


def sharded_search_amk(values_scan, values_exact, sqnorms, valid, queries, *,
                       metric, k, k_sel, mesh, tombstones=True, live_hi=None):
    """Mesh speed mode: per shard the single-device speed path (K3 over
    the scan copy selects a pool of ``k_sel``, an exact f32 re-score of
    the pool from the f32 rows, kernels/amk.py), then the merge. The
    per-shard winners carry exact f32 scores, so the merge ranks them
    exactly; only each shard's selection is approximate.

    ``tombstones=False`` with ``live_hi`` (the global live watermark, an
    int) skips the per-candidate validity gather: shard ``g`` derives its
    local watermark ``clip(live_hi - g * rows_per_shard, 0,
    rows_per_shard)``."""
    if live_hi is None:
        tombstones = True
    rows = values_scan[0].shape[0]
    parts = []
    for g, vs, ve, sq, va, q in zip(
        mesh.shard_ids(), values_scan, values_exact, sqnorms, valid,
        _local(mesh, queries),
    ):
        pool = shard_block_pool(vs, sq, va, q, metric=metric, k_sel=k_sel)
        pool, dup = sorted_pool(pool)
        if tombstones:
            ok = va[pool]
        else:
            ok = pool < min(max(int(live_hi) - g * rows, 0), rows)
        cand = ve[pool].to(torch.float32)
        parts.append(rescore_rows(pool, cand, ok & ~dup, q, metric, min(k, rows)))
    return _merge_local_topk(mesh, parts, rows, k)


def sharded_search_pq(codes, codebooks, sqnorms, valid, queries, *, metric, k,
                      chunk, mesh, packed=False):
    """PQ-profile distributed top-k: the streaming ADC scan of
    kernels/pq.py (K5 per chunk) on each shard's slice of the code matrix
    against one codebook copy a device, then the merge. ADC scores do not
    depend on the shard (the LUT is the query's and the codebooks'), so
    the merge ranks the candidates as one scan would; callers re-score
    the winners exactly on the host."""
    from ..kernels.pq import pq_search_topk

    rows = codes[0].shape[0]
    books = {d: codebooks.to(d) for d in mesh.distinct_devices()}
    parts = [
        pq_search_topk(c, books[c.device], sq, va, q, metric=metric,
                       k=min(k, rows), chunk=min(chunk, rows), packed=packed)
        for c, sq, va, q in zip(codes, sqnorms, valid, _local(mesh, queries))
    ]
    return _merge_local_topk(mesh, parts, rows, k)


def update_rows_sharded(buffer: list, rows, start: int, *, mesh):
    """Write ``rows`` into the sharded ``buffer[start:start+m]`` in place:
    each shard writes the slice of the block that lands in its rows, so a
    burst that straddles a shard boundary needs no re-placement. Returns
    ``buffer``."""
    local_n = buffer[0].shape[0]
    m = rows.shape[0]
    for buf, g in zip(buffer, mesh.shard_ids()):
        lo, hi = max(start, g * local_n), min(start + m, (g + 1) * local_n)
        if lo >= hi:
            continue
        part = rows[lo - start : hi - start]
        part = torch.from_numpy(np.ascontiguousarray(part)) if isinstance(part, np.ndarray) else part
        buf[lo - g * local_n : hi - g * local_n].copy_(
            part.to(buf.device, non_blocking=True).to(buf.dtype)
        )
    return buffer


def _gather_rows(mesh: Mesh, shards: list, slots) -> torch.Tensor:
    """``full[slots]`` of a row-sharded buffer, on the mesh's first
    device: each shard gathers the slots it owns (zeros elsewhere), and
    the parts are summed (across processes too)."""
    rows = shards[0].shape[0]
    slots = slots.to(mesh.first)
    out = None
    for buf, g in zip(shards, mesh.shard_ids()):
        local = slots.to(buf.device) - g * rows
        mine = (local >= 0) & (local < rows)
        part = buf[torch.clamp(local, 0, rows - 1)].to(torch.float32)
        part = torch.where(mine.reshape(*mine.shape, *([1] * (part.dim() - mine.dim()))),
                           part, 0.0).to(mesh.first, non_blocking=True)
        out = part if out is None else out + part
    if mesh.world > 1:
        from .multihost import sum_ranks

        out = sum_ranks(mesh, out)
    return out


def sharded_search_ivf(part_rows, part_slots, part_sqnorms, part_valid,
                       centroids, cent_sqnorms, values_exact, valid, queries,
                       size: int, *, metric, k, k_sel, nprobe_per_shard,
                       p_width, mesh, tombstones=False):
    """IVF probe under the mesh: the cell-contiguous layout and its
    centroids shard by cell blocks (C divisible by the shard count), so
    each shard owns whole cells and a probe reads one local block. Per
    shard: rank the local centroids, probe the top ``nprobe_per_shard``
    local cells with K6 (kernels/ivf.py ``gather_score_pallas``), keep a
    surrogate-ranked pool of ``k_sel`` of the probed rows. The pools
    gather to the first device (their slots are global: the layout
    stores the original slot), the top ``k_sel`` of them is re-scored
    exactly in f32 from the slot-ordered, row-sharded rung rows
    ``values_exact``, and ties break to the lowest slot. The global probe
    width is shards x ``nprobe_per_shard``: the union of per-shard
    windows replaces the single-device top-L.

    Returns (scores [B, k], slots [B, k]) on the mesh's first device."""
    from ..kernels.ivf import _rank_scores_rows, gather_score_pallas

    pools_s, pools_i = [], []
    for pr, ps, psq, pok, cents, csq, q in zip(
        part_rows, part_slots, part_sqnorms, part_valid, centroids,
        cent_sqnorms, _local(mesh, queries),
    ):
        c_local = cents.shape[0]
        nb = min(nprobe_per_shard, c_local)
        crank = _rank_scores(_matmul(q, cents), metric, csq)
        _, probe = stable_topk(crank, nb)  # local cell ids
        dot = gather_score_pallas(pr, probe.to(torch.int32).contiguous(), q,
                                  p_width=p_width)
        b = q.shape[0]
        w = nb * p_width

        def blocks(table):
            return table.reshape(c_local, p_width)[probe].reshape(b, w)

        dot = dot.reshape(b, w)
        rank = torch.where(blocks(pok), _rank_scores_rows(dot, metric, blocks(psq)),
                           NEG_INF)
        s_loc, sel = stable_topk(rank, min(k_sel, w))
        slots = torch.gather(blocks(ps).to(torch.int64), 1, sel)
        pools_s.append(s_loc.to(mesh.first, non_blocking=True))
        pools_i.append(slots.to(mesh.first, non_blocking=True))
    s, pool = _merge(list(zip(pools_s, pools_i)), k_sel)
    if mesh.world > 1:
        from .multihost import gather_ranks

        b = pool.shape[0]
        s_r = gather_ranks(mesh, s).permute(1, 0, 2).reshape(b, -1)
        i_r = gather_ranks(mesh, pool).permute(1, 0, 2).reshape(b, -1)
        _, pool = _merge([(s_r, i_r)], k_sel)
    pool, dup = sorted_pool(torch.clamp(pool, min=0))
    cand = _gather_rows(mesh, values_exact, pool)
    if tombstones:
        ok = _gather_rows(mesh, valid, pool) > 0
    else:
        ok = pool < int(size)
    q = torch.as_tensor(queries).to(mesh.first, torch.float32)
    return rescore_rows(pool, cand, ok & ~dup, q, metric, k)
