"""Exact (flat) index — device-resident matrix scan with fused top-k.

Port of ``vectorlite_tpu/index/flat.py`` (single device; the reference
FlatIndex is src/index/flat.rs). The reference stores ``Vec<Vector>`` and
linearly scans + sorts per query (reference: src/index/flat.rs:98-119).
Here:

* **Host staging** — float64 numpy ``[cap, D]`` is the source of truth
  (exact storage/round-trip parity with the reference's f64 values), with
  id / validity / text / metadata side tables.
* **Device cache** — a float32 (or bf16 / int8) ``[cap, D]`` torch tensor
  on the index's device, plus squared norms and a validity mask, brought
  up to the host truth lazily with a dirty-row watermark: inserts are
  O(D) host writes and the first search after a burst copies the new
  rows into the device tensors in place.
* **Search** — at or above ``_PALLAS_MIN_CAPACITY`` the hand-written scan
  kernels (kernels/scan.py): exact top-k (K1, K2 for int8 rows) for
  ``approx=False``, filtered searches and corpora the precision guard
  flags; lane-group candidate selection (K3) over the scan copy plus an
  exact f32 re-score of the pool for the default speed path; the fused
  Manhattan scan (K4). Below it, a full score matrix and a stable top-k
  (kernels/topk.py), which also serves Manhattan over int8 rows, as in
  the reference. Small corpora with tiny batches are scanned in f64 on
  the host.
* **PQ rung** (``device_dtype="pq"``) — past ``VECTORLITE_PQ_MIN_ROWS``
  live rows, uint8 product-quantization codes + learned codebooks replace
  the f32 cache (kernels/pq.py); every query ranks with the ADC kernel K5
  over the codes, and a wide pool is re-scored in exact f64 on the host.
* **IVF rung** — past ``VECTORLITE_IVF_MIN_ROWS`` live rows (2M) on the
  f32/bf16 rungs and the int8 rung (not ``pq``), a k-means coarse
  quantizer and a cell-contiguous bf16 (int8 on the int8 rung, or when a
  bf16 layout would bust the memory budget) copy of the corpus are built
  next to the rung buffers (kernels/ivf.py), once a measured cell-recall
  guard and a window-scaled precision guard pass. Unfiltered,
  non-Manhattan ``approx`` searches then read only the ``nprobe`` nearest
  cells (K6), the overflow extras and the rows appended since the build,
  and re-score the pool exactly in f32; batches whose probes would read
  more than half the corpus fall through to the brute kernels. Serves on
  CUDA, and on the CPU only under ``VECTORLITE_IVF_FORCE``.
* **Delete** — validity-mask clear (the reference's ``retain``
  semantics: deleting an absent id succeeds, reference: src/index/flat.rs:93-96);
  ``delete_where`` clears every row a metadata clause matches at once.
* **Truth on disk** — ``VECTORLITE_HOST_TRUTH_DIR`` puts the f64 truth
  matrix in an unlinked memory-mapped file there instead of RAM.

Returned scores are exact (f64 host math — the native streaming
re-score of ``native.py``, or numpy — or f32 device re-scoring);
selection is exact on the host path and on ``approx=False``.

* **Mesh** (``mesh=``, dist/sharding.py) — the device cache is split by
  rows over the mesh's shards (capacity a multiple of the shard count),
  searches run the single-device engines per shard and merge the
  winners; host semantics (ids, tombstones, compaction, ``.vlc`` serde)
  are the single-device path's.
* **Pipelined stream** (``search_batch_stream``) — one dispatch thread,
  ``depth`` fetch workers, optional grouping of batches into one launch.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..core.metrics import SimilarityMetric, disable_tf32, quantize_rows_int8
from ..core.types import SearchResult, Vector
from ..errors import DimensionMismatch, DuplicateVectorId, VectorNotFound
from ..kernels import ivf, pq, scan
from ..kernels.topk import (
    next_pow2,
    row_sqnorms,
    search_topk,
    search_topk_int8,
    update_rows,
)
from ..native import RESCORE
from ..observability import profile_span
from ..utils import env_number
from .base import validate_batch_arrays

logger = logging.getLogger(__name__)

_MIN_CAPACITY = 256

#: rows per PQ encode step — bounds the per-step [rows, kc] assignment
#: temp and the f64 -> f32 staging copy
_PQ_ENCODE_BUCKET = 1 << 17


def _pq_scan_chunk(bits: int = 4) -> int:
    """Corpus rows per PQ selection step: the [B, chunk] f32 rank is the
    footprint that grows (256 MB at 256 x 256K). The 8-bit profile keeps
    the reference's narrower 64K chunk. VECTORLITE_PQ_CHUNK overrides
    either."""
    default = (1 << 18) if bits == 4 else (1 << 16)
    return max(1024, int(env_number("VECTORLITE_PQ_CHUNK", default)))


def _pq_bits() -> int:
    """PQ code width: 4 (default; kc = 16, dsub = 2, two codes a byte) or
    8 (kc = 256, dsub = 4). VECTORLITE_PQ_BITS overrides; read at
    wholesale build time only."""
    bits = int(env_number("VECTORLITE_PQ_BITS", 4))
    return bits if bits in (4, 8) else 4


_MAX_K_BUCKET = 1024  # openapi k bound (reference: docs/openapi.yaml:624-630)

#: At or above this capacity the fused scan kernels take over from the
#: full-score-matrix path (which needs a [B, cap] f32 intermediate). Tests
#: lower it to reach the kernel path at small sizes.
_PALLAS_MIN_CAPACITY = 1 << 17

#: Corpus rows per tile: K1 over f32 rows, K1 over bf16 rows, K3.
_PALLAS_TILE_F32 = 2048
_PALLAS_TILE_BF16 = 4096
_PALLAS_TILE_BLOCK = 4096

#: Rows kept per lane group by the K3 selection.
_BLOCK_WINNERS = 2

#: Floor of the speed path's candidate pool: an int8 or bf16 ranking
#: displaces true top-10 members by up to ~100 positions at 1M rows, and a
#: 128-wide exactly re-scored pool recovers them (the reference's default
#: serving pool, kernels/amk.py K_SEL_MIN).
_K_SEL_MIN = 128

#: "auto" dtype is a capacity ladder: f32 until the corpus would not fit
#: comfortably in the device's memory, then bf16 (2x rows), then int8 (4x
#: rows) — each reduced rung adds 2x candidate oversampling + exact f64
#: host re-scoring. On a CPU device the budget is this constant; on a
#: CUDA device it is _AUTO_BUDGET_SHARE of the card's memory, the share
#: the reference's 6 GB constant is of its 16 GB device.
#: VECTORLITE_AUTO_BF16_GB overrides both.
_AUTO_BF16_BYTES = 6 << 30
_AUTO_BUDGET_SHARE = 0.375

#: Speed mode: while the budget allows 6 bytes/element (the f32 corpus + a
#: scan copy), candidate selection scans the int8 (default) or bf16 copy
#: and the pool is re-scored exactly from the co-resident f32 rows.
_SCAN_COPY_BYTES_PER_ELEM = 6

#: Single/tiny-batch queries over small corpora skip the device entirely
#: (exact f64 host scan). Tunables: VECTORLITE_HOST_SCAN_ROWS (0
#: disables), batch cutoff fixed at 4.
_HOST_SCAN_ROWS = 32768
_HOST_SCAN_MAX_BATCH = 4

#: Host-scan prefilter: above this row count the host path selects
#: candidates on a cached f32 copy with a provably-safe error margin, then
#: re-scores only the candidate pool in exact f64 — same results as the
#: full f64 scan. VECTORLITE_HOST_PREFILTER=0 disables.
_HOST_PREFILTER_ROWS = 4096

#: f32 selection-error margins (2x a conservative worst-case bound for
#: 384-d naive f32 accumulation). A wider margin only inflates the exactly
#: re-scored candidate pool — it can never lose a true top-k hit.
_PREFILTER_EPS_DOT = 2e-4  # x qn x vn_max
_PREFILTER_EPS_COS = 4e-4  # absolute (scores in [-1, 1])
_PREFILTER_EPS_L2 = 4e-4  # x (qn + vn_max)^2, on the d^2 scale
_PREFILTER_EPS_L1 = 4e-4  # x sqrt(D) x (qn + vn_max), via L1<=sqrt(D)L2


def _topk_tie_safe(
    scores: np.ndarray, k_eff: int
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k per row without a full O(N log N) argsort: an O(N)
    argpartition bounds the k-th value, then only the (>= kth) candidate
    set — gathered in ascending-slot order — is stably sorted, so equal
    scores still break to the LOWEST slot. NaN scores rank below
    everything but keep their stored value in the output."""
    b, n = scores.shape
    k_eff = max(0, int(k_eff))
    out_s = np.empty((b, k_eff), scores.dtype)
    out_i = np.empty((b, k_eff), np.int64)
    if k_eff == 0:
        return out_s, out_i
    for b_i in range(b):
        srow = scores[b_i]
        nan_mask = np.isnan(srow)
        key = np.where(nan_mask, -np.inf, srow) if nan_mask.any() else srow
        if k_eff >= n:
            cand = np.arange(n)
        else:
            kth = np.partition(key, n - k_eff)[n - k_eff]
            cand = np.flatnonzero(key >= kth)
        order = np.argsort(-key[cand], kind="stable")[:k_eff]
        sel = cand[order]
        out_s[b_i] = srow[sel]
        out_i[b_i] = sel
    return out_s, out_i


#: bf16 has an 8-bit significand: one ulp of relative error per operand.
_BF16_EPS = 2.0 ** -8

#: auto-guard trigger: estimated rank displacement from reduced-precision
#: selection error beyond which reduced-precision candidate selection is
#: refused (32 leaves a 2x margin under the 128-wide pool)
_GUARD_DISPLACEMENT = 32.0


def _bf16_selection_risky(
    vals32: np.ndarray,
    valid: np.ndarray,
    size: int,
    competitor_rows: Optional[int] = None,
) -> bool:
    """Estimate whether reduced-precision candidate selection could
    displace true top-k members beyond the oversampled candidate pool.

    Selection ranks on rounded dot products, so score perturbations are
    ~_BF16_EPS * |q||v|. A sampled nearest-neighbor gap statistic
    estimates the expected displacement ``perturbation / per-rank gap``
    for both the raw geometry (euclidean/dot risk) and the normalized
    geometry (cosine risk); if either exceeds _GUARD_DISPLACEMENT the
    index refuses reduced-precision selection and serves the exact
    kernel instead. O(sample^2 * D) on the host, run only on wholesale
    device rebuilds (capacity growth) and IVF layout builds, never per
    query.
    """
    live = np.flatnonzero(valid[:size])
    if live.size < 256:
        return False
    rng = np.random.default_rng(0xC0FFEE)
    take = rng.choice(live.size, min(1024, live.size), replace=False)
    rows = vals32[live[take]].astype(np.float64)

    def displacement(r: np.ndarray) -> float:
        probes = r[:64]
        sq_p = np.einsum("pd,pd->p", probes, probes)
        sq_r = np.einsum("nd,nd->n", r, r)
        d2 = sq_p[:, None] + sq_r[None, :] - 2.0 * (probes @ r.T)
        np.maximum(d2, 0.0, out=d2)
        d2[np.arange(len(probes)), np.arange(len(probes))] = np.inf
        near = np.sort(d2, axis=1)[:, :16]
        # typical per-rank gap at the head of each probe's ranking
        gap = np.median(np.maximum(near[:, -1] - near[:, 0], 0.0) / 15.0)
        scale = float(
            np.median(np.sqrt(sq_p)) * np.median(np.sqrt(sq_r))
        )
        if gap <= 0.0:
            # exact duplicates dominate the sample: ties are handled by
            # slot order, not precision — not the pathological regime
            return 0.0
        return _BF16_EPS * max(scale, 1e-300) / gap

    # per-rank gaps shrink ~linearly with corpus density: the sampled
    # statistic sees a len(take)-point subsample, the serving scan sees
    # all live rows — correct the displacement estimate accordingly.
    # ``competitor_rows`` overrides the competing population for scans
    # that rank within a bounded window (the IVF probed cells)
    density = (
        competitor_rows if competitor_rows is not None else live.size
    ) / len(take)
    raw = displacement(rows)
    norms = np.linalg.norm(rows, axis=1, keepdims=True)
    normed = rows / np.maximum(norms, 1e-300)
    cosine = displacement(normed)
    return max(raw, cosine) * density > _GUARD_DISPLACEMENT


def _quantize_rows_int8_np(rows32: np.ndarray):
    """Host-side mirror of core.metrics.quantize_rows_int8 (same rounding:
    np.round and torch.round are both half-to-even), so a wholesale build
    transfers only int8 bytes."""
    max_abs = np.max(np.abs(rows32), axis=-1)
    scale = np.where(max_abs > 0.0, max_abs / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(rows32 / scale[:, None]), -127, 127)
    return q.astype(np.int8), scale


def _hbm_budget_bytes(device: torch.device) -> int:
    """The auto-profile device-memory budget, shared by the dtype ladder
    and the scan-copy decision so the two can never disagree."""
    default = _AUTO_BF16_BYTES
    if device.type == "cuda":
        default = _AUTO_BUDGET_SHARE * torch.cuda.mem_get_info(device)[1]
    return int(
        env_number("VECTORLITE_AUTO_BF16_GB", default / (1 << 30), cast=float)
        * (1 << 30)
    )


def _ivf_base_nprobe(c: int) -> int:
    """The IVF probe width before the guard's floor:
    VECTORLITE_IVF_NPROBE (kernels/ivf.NPROBE), clipped to [1, C]."""
    return int(np.clip(int(env_number("VECTORLITE_IVF_NPROBE", ivf.NPROBE)), 1, c))


def _use_pallas(capacity: int) -> bool:
    """The fused scan kernels serve corpora at or above the threshold."""
    return capacity >= _PALLAS_MIN_CAPACITY


def _rows_as_matrix(vals: list, dim: int) -> Optional[np.ndarray]:
    """Reshape per-row f64 arrays back into one [N, dim] matrix when they
    are consecutive views of a single 1-D base buffer (as a parsed .vlc
    document delivers them); None otherwise."""
    first = vals[0]
    base = first.base
    if (
        base is None
        or first.dtype != np.float64
        or base.dtype != np.float64
        or base.ndim != 1
    ):
        return None
    addr = first.__array_interface__["data"][0]
    expect = addr
    for v in vals:
        if v.base is not base or v.__array_interface__["data"][0] != expect:
            return None
        expect += dim * 8
    start = (addr - base.__array_interface__["data"][0]) // 8
    return base[start : start + len(vals) * dim].reshape(len(vals), dim)


class FlatRowsView:
    """Lazy, list-compatible snapshot of the Flat ``data`` payload: the
    small per-row tables plus a REFERENCE to the f64 truth matrix; row
    dicts materialize on access with ``values`` as a row view."""

    __slots__ = ("ids", "slots", "values", "texts", "metas")

    def __init__(self, ids, slots, values, texts, metas):
        self.ids = ids
        self.slots = slots
        self.values = values
        self.texts = texts
        self.metas = metas

    def __len__(self) -> int:
        return len(self.ids)

    def _row(self, i: int) -> dict:
        # field order matches Vector.to_json / the reference serde
        # output (reference: src/lib.rs:163-174)
        return {
            "id": int(self.ids[i]),
            "values": self.values[self.slots[i]],
            "text": self.texts[i],
            "metadata": self.metas[i],
        }

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [
                self._row(j) for j in range(*i.indices(len(self.ids)))
            ]
        return self._row(int(i))

    def __iter__(self):
        for i in range(len(self.ids)):
            yield self._row(i)


class FlatIndex:
    """O(N)-scan search over a device-resident vector matrix.

    Reference semantics (exhaustive scan + stable sort,
    src/index/flat.rs:98-119) with a serving ladder: exact f64 host scan
    for tiny batches over small corpora, full score matrix below the
    kernel threshold, the fused scan kernels above it.
    """

    def __init__(
        self,
        dim: int,
        data: Sequence[Vector] = (),
        *,
        device_dtype="auto",
        device=None,
        mesh=None,
    ):
        if dim <= 0:
            raise ValueError("FlatIndex dimension must be positive")
        self.dim = int(dim)
        # Multi-device serving (dist/sharding.py): with a mesh, the device
        # cache is split by rows over its shards, and the index's own
        # device (queries, merged results) is the mesh's first
        self._mesh = mesh
        self._device = mesh.first if mesh is not None else resolve_device(device)
        disable_tf32()
        # "int8" selects the quantized profile: symmetric per-row int8
        # corpus with exact host re-scoring of the winners. "auto"
        # (default) is the capacity ladder: f32 below the memory budget,
        # then bf16, then int8 — see _prospective_dtype.
        self._auto_dtype = device_dtype == "auto"
        if self._auto_dtype:
            device_dtype = torch.float32
        # "pq" selects the product-quantization rung (kernels/pq.py): codes
        # + learned codebooks on the device, ADC selection (K5) with a wide
        # pool, exact f64 host re-scoring of the winners. Below the
        # training gate the profile serves the plain f32 path; it engages
        # at the first sync past the gate.
        self._pq = device_dtype == "pq"
        if self._pq:
            device_dtype = torch.float32
        self._quantized = device_dtype in ("int8", torch.int8)
        self._device_dtype = torch.int8 if self._quantized else device_dtype
        if self._device_dtype not in (torch.float32, torch.bfloat16, torch.int8):
            raise ValueError(f"unsupported device dtype {device_dtype!r}")

        cap = max(_MIN_CAPACITY, next_pow2(max(1, len(data))))
        if mesh is not None:
            cap = -(-cap // mesh.size) * mesh.size  # split evenly across the mesh
        self._capacity = cap
        # truth-matrix placement is pinned for the index's lifetime (a
        # growth realloc must not switch RAM <-> disk mid-life)
        self._truth_dir = os.environ.get("VECTORLITE_HOST_TRUTH_DIR")
        self._values64 = self._alloc_values(cap)
        self._ids = np.zeros(cap, dtype=np.uint64)
        self._valid = np.zeros(cap, dtype=bool)
        self._texts: list[Optional[str]] = [None] * cap
        self._metas: list = [None] * cap
        self._size = 0  # next append slot (monotonic until compaction)
        self._count = 0  # number of live vectors
        self._id_to_slot: dict[int, int] = {}
        # lazy f64 row-norm table for the exact-rescore path and lazy f32
        # row copy for the host-scan prefilter; concurrent searches hold
        # only the collection READ lock, so their extension is serialized
        # by this lock
        self._host_norms64: Optional[np.ndarray] = None
        self._host_norms_n = 0
        self._host_f32v: Optional[np.ndarray] = None
        self._host_sq32: Optional[np.ndarray] = None
        self._host_f32_n = 0
        self._host_f32_finite = True
        self._norms_lock = threading.Lock()
        # set at wholesale device rebuilds by the precision auto-guard
        self._precision_risky = False
        # metadata-filter mask cache (core/filter.py:FilterCache).
        # _epoch is the STRUCTURAL epoch: delete/compaction bump it (full
        # mask rebuild); appends only move the _size watermark and extend
        # cached masks incrementally.
        self._epoch = 0
        from ..core.filter import FilterCache

        self._where_masks = FilterCache()

        # Device cache. The mutex makes sync + dispatch atomic; rows are
        # updated in place on the device's current stream, after any
        # kernel already queued there that reads them.
        self._dev_lock = threading.Lock()
        self._dev_values: Optional[torch.Tensor] = None
        self._dev_scan: Optional[torch.Tensor] = None  # speed-mode scan copy
        # per-row quantization scales of an int8 scan copy
        self._dev_scan_scales: Optional[torch.Tensor] = None
        self._dev_scales: Optional[torch.Tensor] = None  # int8 storage only
        self._dev_sqnorms: Optional[torch.Tensor] = None
        self._dev_valid: Optional[torch.Tensor] = None
        self._dev_codes: Optional[torch.Tensor] = None  # pq profile only
        self._dev_codebooks: Optional[torch.Tensor] = None  # pq profile only
        self._pq_rot: Optional[torch.Tensor] = None  # OPQ-lite rotation
        self._pq_packed = False  # 4-bit codes, two per stored byte
        self._pq_active = False  # pq cache built and serving
        # code width of the live cache, frozen at the wholesale build: the
        # env knob read later must not re-shape the pool floor
        self._pq_bits_active: Optional[int] = None
        # IVF partitioned-scan state (kernels/ivf.py): a cell-contiguous
        # bf16 (or int8 + scales) copy of the corpus with slot / norm /
        # validity tables, built lazily past the size gate
        self._ivf_rows: Optional[torch.Tensor] = None  # [C*P, D] bf16/int8
        self._ivf_scales: Optional[torch.Tensor] = None  # int8 layout only
        self._ivf_slots: Optional[torch.Tensor] = None  # [C*P] int32
        self._ivf_sq: Optional[torch.Tensor] = None  # [C*P] f32
        self._ivf_valid: Optional[torch.Tensor] = None  # [C*P] bool
        self._ivf_centroids: Optional[torch.Tensor] = None  # [C, D] f32
        self._ivf_cent_sq: Optional[torch.Tensor] = None  # [C] f32
        self._ivf_extra: tuple = ()  # (rows, slots, sq, valid, scales)
        self._ivf_p = 0  # partition pad width P
        self._ivf_hi = 0  # slots below this are inside the layout
        self._ivf_active = False
        self._ivf_slots_np: Optional[np.ndarray] = None
        self._ivf_extra_slots_np: Optional[np.ndarray] = None
        self._ivf_nprobe_floor = 0  # guard-raised probe width (0 = default)
        self._ivf_refused_at = 0  # live count when the guard last refused
        self._dirty_lo = 0
        self._dirty_hi = 0
        self._mask_dirty = True

        for v in data:
            self.add(v)

    @property
    def device(self) -> torch.device:
        return self._device

    def _alloc_values(self, cap: int) -> np.ndarray:
        """The f64 truth matrix: RAM by default, a disk-backed memmap when
        VECTORLITE_HOST_TRUTH_DIR is set. The memmap mode moves the
        8·N·D-byte truth onto disk: re-score gathers and persistence
        stream through the page cache, so host RAM bounds the working set,
        not the corpus. The backing file is unlinked right after mapping
        (the kernel keeps it alive until the mapping dies), so neither a
        crash nor GC can leak disk space."""
        directory = self._truth_dir
        if not directory:
            return np.zeros((cap, self.dim), dtype=np.float64)
        import tempfile

        os.makedirs(directory, exist_ok=True)
        fd, path = tempfile.mkstemp(suffix=".truth", dir=directory)
        try:
            # reserve real blocks up front: a sparse file would admit any
            # size and then SIGBUS on the first page write past free
            # space; fallocate turns a full disk into an OSError here
            try:
                os.posix_fallocate(fd, 0, cap * self.dim * 8)
            except AttributeError:  # non-POSIX: keep the sparse file
                pass
            mm = np.memmap(
                path, dtype=np.float64, mode="w+", shape=(cap, self.dim)
            )
        finally:
            os.close(fd)
            os.unlink(path)
        return mm

    # ------------------------------------------------------------------ API

    def add(self, vector: Vector) -> None:
        """O(1) append (reference add: src/index/flat.rs:82-91)."""
        if len(vector.values) != self.dim:
            raise DimensionMismatch(self.dim, len(vector.values))
        vid = int(vector.id)
        if vid in self._id_to_slot:
            raise DuplicateVectorId(vid)
        if self._size >= self._capacity:
            self._grow()
        slot = self._size
        self._values64[slot] = np.asarray(vector.values, dtype=np.float64)
        self._ids[slot] = vid
        self._valid[slot] = True
        self._texts[slot] = vector.text
        self._metas[slot] = vector.metadata
        self._id_to_slot[vid] = slot
        self._size += 1
        self._count += 1
        self._mark_dirty(slot)

    def add_batch_arrays(
        self,
        ids: Sequence[int],
        values: np.ndarray,  # [B, D]
        texts: Optional[Sequence[str]] = None,
        metadatas: Optional[Sequence] = None,
    ) -> None:
        """Array-native bulk insert: one block write into the host matrix,
        one dirty-range mark. All-or-nothing: ids are validated
        (dimension, duplicates within the batch and against the index)
        before any mutation."""
        int_ids, values = validate_batch_arrays(
            ids, values, self.dim, self._id_to_slot.keys(),
            texts=texts, metadatas=metadatas,
        )
        n = len(int_ids)
        if n == 0:
            return
        if self._size + n > self._capacity:
            self._grow(min_capacity=self._size + n)
        lo = self._size
        self._values64[lo : lo + n] = values
        self._ids[lo : lo + n] = int_ids
        self._valid[lo : lo + n] = True
        self._texts[lo : lo + n] = (
            list(texts) if texts is not None else [""] * n
        )
        self._metas[lo : lo + n] = (
            list(metadatas) if metadatas is not None else [None] * n
        )
        self._id_to_slot.update(zip(int_ids, range(lo, lo + n)))
        self._size += n
        self._count += n
        self._mark_dirty(lo)
        self._mark_dirty(lo + n - 1)

    def delete(self, id: int) -> None:
        """Mask clear; absent ids succeed (reference: src/index/flat.rs:93-96).
        When tombstones dominate, the slot array is compacted so
        add/delete churn cannot grow capacity without bound."""
        slot = self._id_to_slot.pop(int(id), None)
        if slot is None:
            return
        self._valid[slot] = False
        self._texts[slot] = None
        self._metas[slot] = None
        self._count -= 1
        self._epoch += 1
        self._mask_dirty = True
        if self._size > 1024 and self._count < self._size // 2:
            self._compact()

    def delete_where(self, where) -> int:
        """Delete every live vector whose metadata matches ``where``: one
        mask evaluation and one vectorized clear. ``{}`` is an explicit
        match-all; a malformed clause raises InvalidFilter. Returns the
        count deleted."""
        mask, count, _ = self._where_mask(where)
        if count == 0:
            return 0
        slots = np.flatnonzero(mask)
        for s in slots:
            self._id_to_slot.pop(int(self._ids[s]), None)
            self._texts[s] = None
            self._metas[s] = None
        self._valid[slots] = False
        self._count -= int(count)
        self._epoch += 1
        self._mask_dirty = True
        if self._size > 1024 and self._count < self._size // 2:
            self._compact()
        return int(count)

    def compact(self) -> int:
        """Explicit tombstone reclamation. Returns slots reclaimed."""
        dead = self._size - self._count
        if dead <= 0:
            return 0
        self._compact()
        return dead

    def _compact(self) -> None:
        """Drop tombstoned slots, preserving insertion order. A fresh
        buffer (not in-place moves) keeps FlatRowsView snapshots valid."""
        live = np.nonzero(self._valid[: self._size])[0]
        n = len(live)
        new_vals = self._alloc_values(self._capacity)
        slab = max(1, (1 << 27) // (8 * self.dim))
        for lo in range(0, n, slab):
            idx = live[lo : lo + slab]
            new_vals[lo : lo + len(idx)] = self._values64[idx]
        self._values64 = new_vals
        self._ids[:n] = self._ids[live]
        self._valid[:] = False
        self._valid[:n] = True
        self._texts = [self._texts[i] for i in live] + [None] * (
            self._capacity - n
        )
        self._metas = [self._metas[i] for i in live] + [None] * (
            self._capacity - n
        )
        self._size = n
        self._id_to_slot = {
            int(self._ids[slot]): slot for slot in range(n)
        }
        self._host_norms_n = 0  # rows moved: rebuild the norm table lazily
        self._host_f32_n = 0
        self._host_f32_finite = True
        self._drop_device()
        self._dirty_lo, self._dirty_hi = 0, n
        self._ivf_drop()  # compaction renumbers slots
        self._epoch += 1
        self._mask_dirty = True

    def search(
        self,
        query: Sequence[float],
        k: int,
        metric: SimilarityMetric,
        *,
        where: Optional[dict] = None,
    ) -> list[SearchResult]:
        return self.search_batch([query], k, metric, where=where)[0]

    def search_batch(
        self,
        queries: Sequence[Sequence[float]],
        k: int,
        metric: SimilarityMetric,
        *,
        approx: Optional[bool] = None,
        where: Optional[dict] = None,
    ) -> list[list[SearchResult]]:
        """Batched top-k. ``approx=None`` engages the speed path (K3 +
        exact re-score) at kernel scale unless the precision guard
        tripped; ``False`` forces exhaustive selection. Dimension check
        only applies when the index is non-empty, matching the reference
        quirk (reference: src/index/flat.rs:99)."""
        q64 = np.asarray(queries, dtype=np.float64)
        if q64.ndim != 2:
            raise ValueError("queries must be [B, D]")
        b = q64.shape[0]
        mask = mkey = None
        mcount = 0
        if where is not None:
            # validate (InvalidFilter) before any early return
            mask, mcount, mkey = self._where_mask(where)
            if mcount == self._count:
                mask = None  # matches every live row: keep the fast path
        if self._count == 0:
            return [[] for _ in range(b)]
        if q64.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, q64.shape[1])
        k = int(k)
        if k <= 0:
            return [[] for _ in range(b)]
        avail = mcount if mask is not None else self._count
        if avail == 0:
            return [[] for _ in range(b)]
        scores, slots = self._search_slots(
            q64, min(k, avail), metric, approx, mask, mkey
        )
        with profile_span("vectorlite.index.results"):
            return self._hit_lists(scores, slots)

    def _hit_lists(self, scores, slots) -> list[list[SearchResult]]:
        """One list of ``SearchResult``s a row of [B, k] (scores, slots):
        the row's hits before its first ``-inf``. The kept scores, slots
        and ids are each converted to Python values once, flat, and the
        objects are built by ``map``; of the objects made here only the B
        hit lists and their results outlive the call."""
        keep = np.logical_and.accumulate(scores != -np.inf, axis=1)
        live = slots[keep]
        texts, metas = self._texts, self._metas
        ids = self._ids[live].tolist()
        live = live.tolist()
        hits = list(map(
            SearchResult,
            ids,
            scores[keep].tolist(),
            [texts[q] or "" for q in live],
            map(metas.__getitem__, live),
        ))
        out, at = [], 0
        for n in keep.sum(axis=1).tolist():
            out.append(hits[at : at + n])
            at += n
        return out

    def search_batch_arrays(
        self,
        queries: np.ndarray,
        k: int,
        metric: SimilarityMetric,
        *,
        approx: Optional[bool] = None,
        where: Optional[dict] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Array fast path: returns (ids [B,k] int64, scores [B,k] f64).
        Rows with fewer than k live vectors are padded with id=-1 /
        score=-inf; k <= 0 returns [B, 0] arrays."""
        q64 = np.asarray(queries, dtype=np.float64)
        b = q64.shape[0]
        k = int(k)
        mask = mkey = None
        mcount = 0
        if where is not None:
            mask, mcount, mkey = self._where_mask(where)
            if mcount == self._count:
                mask = None
        if self._count == 0 or k <= 0:
            k_out = max(0, k)
            return (
                np.full((b, k_out), -1, np.int64),
                np.full((b, k_out), -np.inf, np.float64),
            )
        if q64.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, q64.shape[1])
        avail = mcount if mask is not None else self._count
        if avail == 0:
            return (
                np.full((b, k), -1, np.int64),
                np.full((b, k), -np.inf, np.float64),
            )
        k_eff = min(k, avail)
        scores, slots = self._search_slots(q64, k_eff, metric, approx, mask, mkey)
        return self._pack_arrays(scores, slots, k, k_eff)

    def search_batch_stream(
        self,
        batches,
        k: int,
        metric: SimilarityMetric,
        *,
        depth: int = 2,
        group: int = 1,
        approx: Optional[bool] = None,
        where: Optional[dict] = None,
    ):
        """Pipelined batched search: yields ``(ids [B, k] int64, scores
        [B, k] f64)`` for each batch of ``batches``, in order, each equal
        to ``search_batch_arrays`` of that batch.

        One dispatch thread uploads the queries and launches the search
        (holding the device lock only around the sync and the launch, as
        every search does), then queues the copy of the result into pinned
        host buffers behind the kernels and records an event; ``depth``
        fetch workers wait on the event and do the host work (the exact
        re-score, ids). So batch i's fetch and host assembly overlap batch
        i+1's kernels, and up to ``depth`` x ``group`` batches are in
        flight. ``group`` > 1 concatenates that many consecutive batches
        into one upload, one search and one fetch, then splits the rows
        back: the rows of each batch are those the batch alone gives, and
        grouping trades the first batch's latency for fewer launches."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        k = int(k)
        depth = max(1, int(depth))
        group = max(1, int(group))
        mask = mkey = None
        mcount = 0
        if where is not None:
            # one mask for the whole stream; a mutation mid-stream races
            # it as it races the unfiltered stream
            mask, mcount, mkey = self._where_mask(where)
            if mcount == self._count:
                mask = None
        pending: deque = deque()
        curgroup: list = []  # (q64, k_eff, b, holder) of the open group

        def dispatch(items):
            q64 = np.concatenate([it[0] for it in items])
            out = self._dispatch_arrays(q64, items[0][1], metric, approx, mask, mkey)
            return q64, self._start_fetch(out)

        def finish(disp_fut, items):
            q64, fetch = disp_fut.result()
            scores, slots = fetch()
            b_total = q64.shape[0]
            scores, slots = self._finalize_device(
                q64, scores[:b_total], slots[:b_total], items[0][1], metric
            )
            out, off = [], 0
            for _q64, k_eff, b, _holder in items:
                out.append(self._pack_arrays(
                    scores[off : off + b], slots[off : off + b], k, k_eff
                ))
                off += b
            return out

        def flush():
            if not curgroup:
                return
            items, holder = list(curgroup), curgroup[0][3]
            curgroup.clear()
            holder["fut"] = fetchers.submit(finish, dispatcher.submit(dispatch, items), items)

        def resolve(item):
            if item[0] == "ready":
                return item[1]
            _, holder, j = item
            if "fut" not in holder:
                flush()  # the batch belongs to the still-open group
            return holder["fut"].result()[j]

        fetchers = ThreadPoolExecutor(max_workers=depth, thread_name_prefix="vl-stream-fetch")
        dispatcher = ThreadPoolExecutor(max_workers=1, thread_name_prefix="vl-stream-dispatch")
        try:
            for queries in batches:
                q64 = np.asarray(queries, dtype=np.float64)
                b = q64.shape[0]
                avail = mcount if mask is not None else self._count
                if avail == 0 or k <= 0:
                    k_out = max(0, k)
                    item = ("ready", (np.full((b, k_out), -1, np.int64),
                                      np.full((b, k_out), -np.inf, np.float64)))
                else:
                    if q64.shape[1] != self.dim:
                        raise DimensionMismatch(self.dim, q64.shape[1])
                    k_eff = min(k, avail)
                    if self._host_scan_eligible(b):
                        if mask is None:
                            scores, slots = self._host_scan(q64, k_eff, metric)
                        else:
                            scores, slots = self._host_scan_subset(q64, k_eff, metric, mask)
                        item = ("ready", self._pack_arrays(scores, slots, k, k_eff))
                    else:
                        # a k_eff change (a mutation mid-stream) closes the
                        # open group
                        if curgroup and curgroup[0][1] != k_eff:
                            flush()
                        holder = curgroup[0][3] if curgroup else {}
                        item = ("g", holder, len(curgroup))
                        curgroup.append((q64, k_eff, b, holder))
                        if len(curgroup) >= group:
                            flush()
                pending.append(item)
                if len(pending) > depth * group:
                    yield resolve(pending.popleft())
            flush()
            while pending:
                yield resolve(pending.popleft())
        finally:
            fetchers.shutdown(wait=False)
            dispatcher.shutdown(wait=False)

    def _start_fetch(self, out):
        """Queue the copy of a device result (scores, slots) to the host;
        returns a function that waits for it and gives the numpy arrays. On
        the card the copy goes into pinned buffers behind the kernels on
        the current stream (a copy into pageable memory would block), and
        an event marks its end."""
        host, done = out, None
        if out[0].device.type == "cuda":
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out]
            with torch.cuda.device(out[0].device):
                for h, t in zip(host, out):
                    h.copy_(t, non_blocking=True)
                done = torch.cuda.Event()
                done.record()

        def fetch():
            with profile_span("vectorlite.index.fetch"):
                if done is not None:
                    done.synchronize()
                return host[0].numpy(), host[1].numpy()

        return fetch

    def _search_slots(self, q64, k_eff, metric, approx, mask, mkey):
        """(scores [B, k_eff] f64-comparable, slots [B, k_eff]) from the
        host scan or one device dispatch."""
        b = q64.shape[0]
        if self._host_scan_eligible(b):
            if mask is None:
                return self._host_scan(q64, k_eff, metric)
            return self._host_scan_subset(q64, k_eff, metric, mask)
        scores, slots = self._dispatch_arrays(q64, k_eff, metric, approx, mask, mkey)
        with profile_span("vectorlite.index.fetch"):
            scores, slots = scores.cpu().numpy()[:b], slots.cpu().numpy()[:b]
        return self._finalize_device(q64, scores, slots, k_eff, metric)

    def _dispatch_arrays(self, q64, k_eff, metric, approx, mask=None, mkey=None):
        """Pad and dispatch one device search: the (scores, slots) tensors
        on the index's device, rows past the batch padding included, without
        waiting for them."""
        with profile_span("vectorlite.index.prep"):
            q = q64.astype(np.float32)
            b = q.shape[0]
            k_pad = min(
                self._capacity, max(1, next_pow2(min(k_eff, _MAX_K_BUCKET)))
            )
            if k_eff > k_pad:  # k beyond the bucket ceiling: widen
                k_pad = min(self._capacity, next_pow2(k_eff))
            b_pad = next_pow2(b)
            if b_pad > b:
                q = np.concatenate([q, np.zeros((b_pad - b, self.dim), np.float32)])
            approx = self._resolve_approx(
                approx, k_pad, metric, filtered=mask is not None
            )
            k_sel = self._selection_k(k_pad)
            where_dev = self._where_dev(mkey, mask) if mask is not None else None
        with profile_span("vectorlite.index.launch"):
            return self._device_topk(q, k_sel, metric, approx, where_dev=where_dev)

    def _finalize_device(self, q64, scores, slots, k_eff, metric):
        """Post-fetch host work: exact re-scoring / clamping and k
        trimming."""
        with profile_span("vectorlite.index.finalize"):
            if self._needs_rescore():
                with profile_span("vectorlite.index.rescore"):
                    scores, slots = self._exact_rescore(q64, scores, slots, metric)
            elif metric is SimilarityMetric.COSINE:
                # f32 device rounding can overshoot 1.0; clamp for
                # consistency with the exact-rescore path
                scores = np.minimum(scores, 1.0)
            return scores[:, :k_eff], slots[:, :k_eff]

    def _pack_arrays(self, scores, slots, k, k_eff):
        ids = self._ids[slots].astype(np.int64)
        ids[scores == -np.inf] = -1
        if k_eff < k:
            ids = np.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
            scores = np.pad(
                scores,
                ((0, 0), (0, k - k_eff)),
                constant_values=-np.inf,
            )
        return ids, scores.astype(np.float64, copy=False)

    def __len__(self) -> int:
        return self._count

    def is_empty(self) -> bool:
        return self._count == 0

    def get_vector(
        self, id: int, *, include_values: bool = True
    ) -> Optional[Vector]:
        slot = self._id_to_slot.get(int(id))
        if slot is None:
            return None
        return Vector(
            id=int(self._ids[slot]),
            values=(
                [float(x) for x in self._values64[slot]]
                if include_values
                else []
            ),
            text=self._texts[slot] or "",
            metadata=self._metas[slot],
        )

    def update_metadata(self, id: int, metadata) -> None:
        """Replace a vector's metadata in place (``None`` clears). The
        embedding and text are untouched, so no device state changes; only
        the filter-mask cache epoch moves."""
        slot = self._id_to_slot.get(int(id))
        if slot is None:
            raise VectorNotFound(int(id))
        self._metas[slot] = metadata
        self._epoch += 1

    def list_vectors(
        self,
        offset: int = 0,
        limit: int = 100,
        where: Optional[dict] = None,
        include_values: bool = False,
    ) -> tuple[list[Vector], int]:
        """A page of stored vectors in insertion (slot) order, optionally
        restricted by a ``where`` clause: (page, total matching).
        ``include_values=False`` leaves ``values`` empty."""
        offset = max(0, int(offset))
        limit = max(0, int(limit))
        if where is not None:
            mask, total, _ = self._where_mask(where)
            slots = np.flatnonzero(mask)
        else:
            slots = np.flatnonzero(self._valid[: self._size])
            total = int(len(slots))
        page = slots[offset : offset + limit]
        out = [
            Vector(
                id=int(self._ids[s]),
                values=(
                    [float(x) for x in self._values64[s]]
                    if include_values
                    else []
                ),
                text=self._texts[s] or "",
                metadata=self._metas[s],
            )
            for s in page
        ]
        return out, total

    @property
    def dimension(self) -> int:
        return self.dim

    def metric(self) -> Optional[SimilarityMetric]:
        return None  # Flat supports all metrics (reference: src/lib.rs:332-337)

    @property
    def index_type(self) -> str:
        return "Flat"

    def max_id(self) -> Optional[int]:
        """Max live id (reference: src/index/flat.rs:76-78)."""
        if not self._id_to_slot:
            return None
        return max(self._id_to_slot)

    def _host_scan_eligible(self, b: int) -> bool:
        rows = env_number("VECTORLITE_HOST_SCAN_ROWS", _HOST_SCAN_ROWS)
        return (
            self._mesh is None
            and b <= _HOST_SCAN_MAX_BATCH
            and self._size <= rows
        )

    # -------------------------------------------------- metadata filtering

    def _where_mask(self, where) -> tuple[np.ndarray, int, Optional[str]]:
        """Compile + evaluate a metadata ``where`` clause (core/filter.py)
        into a slot mask: (mask [capacity] bool ANDed with the live-slot
        mask, match count, cache key). Raises InvalidFilter on a malformed
        clause. Masks cache per clause and invalidate on the structural
        epoch; appends re-evaluate just the new rows.

        Entry layout: [struct_epoch, evaluated_upto, mask, count, dev]."""
        from ..core.filter import canonicalize, compile_where
        from ..observability import filter_stats

        where, key = canonicalize(where)
        ent = self._where_masks.get(key)
        if ent is not None and ent[0] == self._epoch:
            if ent[1] == self._size and len(ent[2]) == self._capacity:
                filter_stats.record("hit")
                return ent[2], ent[3], key
            # append-only extension; copy-on-extend so a concurrent reader
            # of the old mask never sees a tear
            pred = compile_where(where)
            mask = np.zeros(self._capacity, dtype=bool)
            upto = min(ent[1], len(ent[2]), self._capacity)
            mask[:upto] = ent[2][:upto]
            count = self._eval_mask_range(pred, mask, upto, self._size)
            count += int(np.count_nonzero(mask[:upto]))
            self._where_masks.put(key, [self._epoch, self._size, mask, count, None])
            filter_stats.record("extend", self._size - upto)
            return mask, count, key
        pred = compile_where(where)
        mask = np.zeros(self._capacity, dtype=bool)
        count = self._eval_mask_range(pred, mask, 0, self._size)
        self._where_masks.put(key, [self._epoch, self._size, mask, count, None])
        filter_stats.record("build", self._size)
        return mask, count, key

    def _eval_mask_range(self, pred, mask, lo: int, hi: int) -> int:
        """Evaluate ``pred`` over live slots [lo, hi) into ``mask``;
        returns the number of rows set."""
        metas = self._metas
        valid = self._valid
        n = 0
        for i in range(lo, hi):
            if valid[i] and pred(metas[i]):
                mask[i] = True
                n += 1
        return n

    def _where_dev(self, key: Optional[str], mask: np.ndarray) -> torch.Tensor:
        """Device copy of a where mask (sharded like the validity mask on
        a mesh), cached in its entry so repeated filtered searches skip the
        upload."""
        ent = self._where_masks.get(key)
        if ent is not None and ent[4] is not None and ent[2] is mask:
            return ent[4]
        dev = self._place(mask)
        if ent is not None and ent[2] is mask:
            ent[4] = dev
        return dev

    # ---------------------------------------------------------- host scan

    def _host_scan_subset(self, q64, k_eff, metric, mask):
        """Exact f64 scan restricted to the masked slots (same score
        formulas and stable lowest-slot tie-break as _host_scan)."""
        slots = np.flatnonzero(mask)
        b = q64.shape[0]
        out_s = np.empty((b, k_eff), np.float64)
        out_i = np.empty((b, k_eff), np.int64)
        for b_i in range(b):
            s = self._exact_scores_row(q64[b_i], slots, metric)
            order = np.argsort(-s, kind="stable")[:k_eff]
            out_s[b_i] = s[order]
            out_i[b_i] = slots[order]
        return out_s, out_i

    def _host_scan(self, q64, k_eff, metric):
        """Exact f64 scan + top-k on the host: tombstones -inf, ties to
        the lower slot, the scalar reference formulas in f64
        (reference: src/index/flat.rs:98-119). Above
        _HOST_PREFILTER_ROWS, candidates are selected on a cached f32
        copy with a worst-case margin and only they are scored in f64."""
        k_eff = max(0, int(k_eff))
        n = self._size
        if (
            n >= _HOST_PREFILTER_ROWS
            and k_eff * 4 <= n
            and env_number("VECTORLITE_HOST_PREFILTER", 1)
        ):
            out = self._host_scan_prefiltered(q64, k_eff, metric)
            if out is not None:
                return out
        scores = self._host_scores64(q64, metric, n)
        scores = np.where(self._valid[:n][None, :], scores, -np.inf)
        return _topk_tie_safe(scores, k_eff)

    def _host_scores64(self, q64, metric, n):
        """Full [B, n] exact f64 score matrix (reference formulas)."""
        v = self._values64[:n]
        if metric is SimilarityMetric.MANHATTAN:
            scores = np.empty((q64.shape[0], v.shape[0]))
            step = 4096
            for b_i in range(q64.shape[0]):
                for lo in range(0, v.shape[0], step):
                    chunk = v[lo : lo + step]
                    scores[b_i, lo : lo + len(chunk)] = np.abs(
                        chunk - q64[b_i]
                    ).sum(1)
            return 1.0 / (1.0 + scores)
        if metric is SimilarityMetric.EUCLIDEAN:
            # direct |v - q| form: matches the reference's scalar
            # sqrt(sum((a-b)^2)) without the expanded form's cancellation
            d_sq = np.empty((q64.shape[0], v.shape[0]))
            step = 4096
            for b_i in range(q64.shape[0]):
                for lo in range(0, v.shape[0], step):
                    diff = v[lo : lo + step] - q64[b_i]
                    d_sq[b_i, lo : lo + len(diff)] = np.einsum(
                        "nd,nd->n", diff, diff
                    )
            return 1.0 / (1.0 + np.sqrt(d_sq))
        dots = q64 @ v.T
        if metric is SimilarityMetric.DOT_PRODUCT:
            return dots
        vn = self._host_norms()[:n]
        qn = np.linalg.norm(q64, axis=1, keepdims=True)
        denom = qn * vn[None, :]
        with np.errstate(invalid="ignore", divide="ignore"):
            scores = np.where(denom > 0.0, dots / np.maximum(denom, 1e-300), 0.0)
        # f64 rounding can put self-similarity at 1+1ulp; clamp
        np.minimum(scores, 1.0, out=scores)
        return scores

    def _host_f32(self):
        """Lazy f32 row copy + f32 squared norms for the prefilter. The
        certified flag trips when a row's f32 squared norm overflows or
        underflows while its f64 norm is nonzero: such corpora take the
        pure f64 scan."""
        with self._norms_lock:
            if (
                self._host_f32v is None
                or len(self._host_f32v) != self._capacity
            ):
                self._host_f32v = np.zeros(
                    (self._capacity, self.dim), dtype=np.float32
                )
                self._host_sq32 = np.zeros(self._capacity, dtype=np.float32)
                self._host_f32_n = 0
                self._host_f32_finite = True
            if self._host_f32_n < self._size:
                lo, hi = self._host_f32_n, self._size
                with np.errstate(over="ignore", invalid="ignore", under="ignore"):
                    rows = self._values64[lo:hi].astype(np.float32)
                    sq = np.einsum("nd,nd->n", rows, rows)
                self._host_f32v[lo:hi] = rows
                self._host_sq32[lo:hi] = sq
                if not np.all(np.isfinite(sq)):
                    self._host_f32_finite = False
                else:
                    sq64 = np.einsum(
                        "nd,nd->n",
                        self._values64[lo:hi],
                        self._values64[lo:hi],
                    )
                    if np.any((sq64 > 0.0) & (sq < np.finfo(np.float32).tiny)):
                        self._host_f32_finite = False
                self._host_f32_n = hi
            return self._host_f32v, self._host_sq32, self._host_f32_finite

    def _host_scan_prefiltered(self, q64, k_eff, metric):
        """f32 candidate selection + exact f64 rescore; None when the f32
        regime can't be certified. Every true top-k row is a candidate
        because the margin is 2x the worst-case f32 error; ties break to
        the lowest slot because candidates are gathered in slot order and
        the f64 sort is stable — identical to the pure f64 path."""
        n = self._size
        b = q64.shape[0]
        v32, sq32, finite = self._host_f32()
        if not finite:
            return None
        q32 = q64.astype(np.float32)
        if not np.all(np.isfinite(q32)):
            return None
        v = v32[:n]
        sq = sq32[:n]
        qn = np.linalg.norm(q64, axis=1)
        vn_max = float(np.sqrt(max(float(sq.max(initial=0.0)), 0.0)))

        if metric is SimilarityMetric.MANHATTAN:
            sel = np.empty((b, n), np.float32)
            step = 16384
            for b_i in range(b):
                for lo in range(0, n, step):
                    chunk = v[lo : lo + step]
                    sel[b_i, lo : lo + len(chunk)] = -np.abs(
                        chunk - q32[b_i]
                    ).sum(1)
            eps = _PREFILTER_EPS_L1 * np.sqrt(self.dim) * (qn + vn_max)
        else:
            dots = q32 @ v.T
            if metric is SimilarityMetric.DOT_PRODUCT:
                sel = dots
                eps = _PREFILTER_EPS_DOT * qn * vn_max
            elif metric is SimilarityMetric.COSINE:
                qn32 = qn.astype(np.float32)
                if np.any((qn > 0.0) & (qn32 == 0.0)):
                    return None  # query-norm underflow
                vn32 = np.sqrt(sq)
                q_nz = qn32[qn32 > 0.0]
                v_nz = vn32[vn32 > 0.0]
                if q_nz.size and v_nz.size:
                    if float(q_nz.min()) * float(v_nz.min()) < 1e-30:
                        return None
                denom = qn32[:, None] * vn32[None, :]
                with np.errstate(invalid="ignore", divide="ignore"):
                    sel = np.where(
                        denom > 0.0,
                        dots / np.maximum(denom, np.float32(1e-30)),
                        np.float32(0.0),
                    )
                eps = np.full(b, _PREFILTER_EPS_COS)
            else:  # euclidean: select on -d^2 (monotone in the score)
                sel = 2.0 * dots - sq[None, :]
                eps = _PREFILTER_EPS_L2 * (qn + vn_max) ** 2
        sel = np.where(self._valid[:n][None, :], sel, -np.inf)

        out_s = np.empty((b, k_eff), np.float64)
        out_i = np.empty((b, k_eff), np.int64)
        for b_i in range(b):
            srow = sel[b_i]
            srow = np.where(np.isnan(srow), -np.inf, srow)
            kth = np.partition(srow, n - k_eff)[n - k_eff]
            if kth == -np.inf:
                return None
            cand = np.flatnonzero(srow >= kth - eps[b_i])
            s64 = self._exact_scores_row(q64[b_i], cand, metric)
            order = np.argsort(-s64, kind="stable")[:k_eff]
            out_s[b_i] = s64[order]
            out_i[b_i] = cand[order]
        return out_s, out_i

    def _exact_scores_row(self, q64, slots, metric):
        """Exact f64 reference-formula scores for one query over a slot
        subset."""
        v = self._values64[slots]
        if metric is SimilarityMetric.DOT_PRODUCT:
            return v @ q64
        if metric is SimilarityMetric.COSINE:
            dot = v @ q64
            vn = self._host_norms()[slots]
            qn = np.linalg.norm(q64)
            denom = vn * qn
            with np.errstate(invalid="ignore", divide="ignore"):
                s = np.where(denom > 0.0, dot / np.maximum(denom, 1e-300), 0.0)
            np.minimum(s, 1.0, out=s)
            return s
        if metric is SimilarityMetric.EUCLIDEAN:
            return 1.0 / (1.0 + np.linalg.norm(v - q64[None, :], axis=-1))
        return 1.0 / (1.0 + np.sum(np.abs(v - q64[None, :]), axis=-1))

    # ------------------------------------------------------ device serving

    def _prospective_dtype(self) -> torch.dtype:
        """The device-cache dtype the next wholesale rebuild will use:
        "auto" degrades f32 -> bf16 -> int8 only as the memory budget
        demands. While a cache is live, its dtype is pinned."""
        if self._quantized or not self._auto_dtype:
            return self._device_dtype
        if self._mesh is not None:
            return torch.float32  # the sharded engines run f32 (or explicit int8)
        if self._dev_values is not None:
            return self._device_dtype
        budget = _hbm_budget_bytes(self._device)
        row_bytes = self._capacity * self.dim
        if not _use_pallas(self._capacity) or row_bytes * 4 <= budget:
            return torch.float32
        if row_bytes * 2 <= budget:
            return torch.bfloat16
        return torch.int8

    def _scan_copy_wanted(self) -> bool:
        """Speed mode: keep a reduced-precision scan copy next to the f32
        corpus whenever the budget allows — auto profile, kernel scale,
        f32 rung, precision guard passed. VECTORLITE_SPEED_MODE=0 opts
        out."""
        if env_number("VECTORLITE_SPEED_MODE", 1) != 1:
            return False
        if self._precision_risky:
            return False
        if (
            not self._auto_dtype
            or self._quantized
            or not _use_pallas(self._capacity)
        ):
            return False
        # a mesh splits the rows across its devices: the budget is each
        # distinct device's, summed (a card repeated in the mesh counts once)
        devices = [self._device] if self._mesh is None else self._mesh.distinct_devices()
        return (
            self._capacity * self.dim * _SCAN_COPY_BYTES_PER_ELEM
            <= sum(_hbm_budget_bytes(d) for d in devices)
        )

    def _scan_copy_dtype(self) -> torch.dtype:
        """int8 by default (a quarter of the f32 bytes);
        VECTORLITE_SCAN_DTYPE=bf16 selects bf16."""
        name = os.environ.get("VECTORLITE_SCAN_DTYPE", "int8").lower()
        return torch.bfloat16 if name in ("bf16", "bfloat16") else torch.int8

    def _resolve_approx(self, approx, k_pad, metric, filtered=False) -> bool:
        """Resolve the tri-state ``approx`` flag. Filtered searches are
        always exhaustive: a where mask leaves islands of valid rows, and
        a lane group keeps only W of them. Manhattan always scans
        exactly. ``None`` engages the speed path at kernel scale."""
        if filtered or metric is SimilarityMetric.MANHATTAN:
            return False
        if self._pq:
            # the PQ branch selects exhaustively over ADC ranks; the block
            # engine never sees the code matrix
            return False
        if self._mesh is not None:
            # per shard, the speed path (K3 + exact re-score) at the
            # single-device scale; the int8 profile stays exact
            if self._quantized:
                return False
            if approx is not None:
                return bool(approx)
            return _use_pallas(self._capacity)
        if not _use_pallas(self._capacity):
            return False
        if not self._block_selection_feasible(k_pad):
            return False
        if approx is not None:
            return bool(approx)
        return True

    def _selection_k(self, k_pad: int) -> int:
        """Candidate-list width for device selection: reduced-precision
        storage ranks on approximate scores, so it selects 2x the bucket
        for the host's exact re-score to re-sort."""
        if self._pq:
            # PQ ranking error is far larger than int8's: a wide pool floor
            # and 4x oversampling. The floor keys off the live cache's code
            # width (frozen at the wholesale build), and for 4-bit codes
            # doubles once per 8x high-water rows past 2M (8M -> 512,
            # 64M -> 1024): pool recall at a fixed width decays as N grows.
            if self._pq_code_bits() == 4:
                live, base, thresh = max(1, self._size), 256, 2 << 20
                while base < 2048 and live > thresh:
                    base, thresh = base * 2, thresh * 8
            else:
                base = 128
            floor = int(env_number("VECTORLITE_PQ_POOL_MIN", base))
            return min(self._capacity, next_pow2(max(4 * k_pad, floor)))
        if self._quantized or self._prospective_dtype() != torch.float32:
            return min(self._capacity, next_pow2(2 * k_pad))
        return k_pad

    def _block_selection_feasible(self, k_pad: int) -> bool:
        """Block selection yields capacity/128*W candidates; the top-k
        needs at least k_pad of them."""
        return k_pad * (128 // _BLOCK_WINNERS) <= self._capacity

    def _pq_code_bits(self) -> int:
        """Code width of the live PQ cache (frozen at its wholesale build),
        else the one the next build will use."""
        if self._pq_bits_active is not None:
            return self._pq_bits_active
        return _pq_bits()

    def _needs_rescore(self) -> bool:
        """Exact f64 host re-scoring of the winners whenever device scores
        ran on reduced-precision storage (int8/bf16/PQ codes)."""
        return (
            self._quantized
            or self._pq_active
            or self._device_dtype == torch.bfloat16
        )

    def _exact_rescore(self, q64, scores, slots, metric):
        """Re-score the k winners in exact float64 host math and re-sort
        each row (candidates sorted by slot first, so exact-score ties
        break to the LOWEST row). The native streaming loop (native.py)
        reads each candidate row once; the numpy version below is its
        plain twin, serving when the native code is off or did not
        build."""
        exact = RESCORE(
            self._values64,
            self._host_norms() if metric is SimilarityMetric.COSINE else None,
            q64, slots, metric,
        )
        if exact is None:
            exact = self._exact_scores_numpy(q64, slots, metric)
        exact = np.where(scores == -np.inf, -np.inf, exact)
        slot_order = np.argsort(slots, axis=1, kind="stable")
        exact = np.take_along_axis(exact, slot_order, axis=1)
        slots = np.take_along_axis(slots, slot_order, axis=1)
        order = np.argsort(-exact, axis=1, kind="stable")
        return (
            np.take_along_axis(exact, order, axis=1),
            np.take_along_axis(slots, order, axis=1),
        )

    def _exact_scores_numpy(self, q64, slots, metric):
        """[B, k] exact f64 scores of ``slots`` (numpy: a [B, k, D]
        gather, then batched products)."""
        q = q64[:, None, :]
        v = self._values64[slots]  # [B, k, D]
        if metric is SimilarityMetric.DOT_PRODUCT:
            return np.matmul(v, q64[:, :, None])[..., 0]
        if metric is SimilarityMetric.COSINE:
            dot = np.matmul(v, q64[:, :, None])[..., 0]
            vn = self._host_norms()[slots]
            qn = np.linalg.norm(q64, axis=-1, keepdims=True)
            denom = vn * qn
            with np.errstate(invalid="ignore", divide="ignore"):
                exact = np.where(
                    denom > 0.0, dot / np.maximum(denom, 1e-300), 0.0
                )
            np.minimum(exact, 1.0, out=exact)
            return exact
        if metric is SimilarityMetric.EUCLIDEAN:
            return 1.0 / (1.0 + np.linalg.norm(v - q, axis=-1))
        return 1.0 / (1.0 + np.sum(np.abs(v - q), axis=-1))

    def _host_norms(self) -> np.ndarray:
        """Float64 row L2-norm table, extended lazily to the append
        watermark."""
        with self._norms_lock:
            if (
                self._host_norms64 is None
                or len(self._host_norms64) != self._capacity
            ):
                self._host_norms64 = np.zeros(self._capacity, dtype=np.float64)
                self._host_norms_n = 0
            if self._host_norms_n < self._size:
                lo, hi = self._host_norms_n, self._size
                self._host_norms64[lo:hi] = np.linalg.norm(
                    self._values64[lo:hi], axis=1
                )
                self._host_norms_n = hi
            return self._host_norms64

    def _device_topk(self, q, k_pad, metric, approx=False, where_dev=None):
        """One device search: (scores [B, k'], slots [B, k']) tensors with
        k' >= k_pad. Sync and dispatch are atomic under the device mutex;
        the caller fetches the result outside it."""
        with self._dev_lock:
            self._sync_device()
            valid = self._dev_valid
            if where_dev is not None:
                # filtered searches are exhaustive (see _resolve_approx)
                if self._mesh is None:
                    valid = valid & where_dev
                else:
                    valid = [v & w for v, w in zip(valid, where_dev)]
                approx = False
            queries = self._upload(q)
            if (
                approx
                and self._ivf_active
                and where_dev is None
                and metric is not SimilarityMetric.MANHATTAN
            ):
                # IVF partitioned scan: reads only the probed cells and
                # the insert tail; None when one brute corpus read
                # amortizes better over this batch (see _ivf_topk). It
                # comes before the precision guard's downgrade: an active
                # layout passed the window-scaled check in _ivf_build
                res = self._ivf_topk(queries, k_pad, metric)
                if res is not None:
                    return res
            # the precision guard's verdict: f32 storage serves the exact
            # kernel on risky corpora
            if (
                approx
                and self._precision_risky
                and self._device_dtype == torch.float32
            ):
                approx = False
            if approx and not self._block_selection_feasible(k_pad):
                approx = False
            if self._pq_active:
                return self._pq_topk(queries, k_pad, metric, valid)
            if self._mesh is not None:
                return self._mesh_topk(queries, k_pad, metric, approx, valid)
            tile = (
                _PALLAS_TILE_BF16
                if self._device_dtype == torch.bfloat16
                else _PALLAS_TILE_F32
            )
            kernel_ok = _use_pallas(self._capacity)
            if self._quantized:
                # manhattan over int8 rows has a kernel in neither package
                # (K4 reads f32/bf16 rows): the full-score path serves it
                if not kernel_ok or metric is SimilarityMetric.MANHATTAN:
                    return search_topk_int8(
                        self._dev_values, self._dev_scales, self._dev_sqnorms,
                        valid, queries, metric=metric, k=k_pad,
                    )
                if approx:
                    # int8 ranking displaces true winners as far as the
                    # scan copy's does: the same 128-row pool floor
                    return scan.pallas_search_block_topk_int8(
                        self._dev_values, self._dev_scales, self._dev_sqnorms,
                        valid, queries, metric=metric,
                        k=self._pool_k(max(_K_SEL_MIN, k_pad), k_pad),
                        tile_n=_PALLAS_TILE_BLOCK, winners=_BLOCK_WINNERS,
                    )
                return scan.pallas_search_topk_int8(
                    self._dev_values, self._dev_scales, self._dev_sqnorms,
                    valid, queries, metric=metric, k=k_pad,
                    tile_n=_PALLAS_TILE_F32,
                )
            if not kernel_ok:
                return search_topk(
                    self._dev_values, self._dev_sqnorms, valid, queries,
                    metric=metric, k=k_pad,
                )
            if metric is SimilarityMetric.MANHATTAN:
                # fused L1 scan (K4): no [B, cap] intermediate
                return scan.pallas_search_topk_l1(
                    self._dev_values, valid, queries, k=k_pad,
                    tile_n=_PALLAS_TILE_F32,
                )
            if approx:
                # speed path: K3 over the scan copy (or the rows
                # themselves) selects the pool, which is re-scored
                # exactly in f32 from the co-resident rows
                rows = self._dev_scan if self._dev_scan is not None else self._dev_values
                return scan.pallas_search_block_topk_rescored(
                    rows, self._dev_values, self._dev_sqnorms, valid, queries,
                    metric=metric, k=k_pad,
                    k_sel=self._pool_k(
                        max(_K_SEL_MIN, next_pow2(2 * k_pad)), k_pad
                    ),
                    tile_n=_PALLAS_TILE_BLOCK, winners=_BLOCK_WINNERS,
                    scan_scales=(
                        self._dev_scan_scales if rows.dtype == torch.int8 else None
                    ),
                )
            return scan.pallas_search_topk(
                self._dev_values, self._dev_sqnorms, valid, queries,
                metric=metric, k=k_pad, tile_n=tile,
            )

    def _pq_topk(self, queries, k_pad, metric, valid):
        """Streaming ADC over the code matrix (K5 per chunk). The code
        quantization, the bf16 LUT and the k + 32 pool trim are the
        approximations; the wide _selection_k pool and the caller's exact
        f64 re-score absorb them."""
        sel_metric = metric
        if self._pq_rot is not None:
            queries = queries.to(torch.float32) @ self._pq_rot
            if metric is SimilarityMetric.MANHATTAN:
                # L1 is not rotation-invariant: select through the
                # rotation-invariant euclidean proxy (dot + norms); the
                # exact L1 re-score restores true scores and order
                sel_metric = SimilarityMetric.EUCLIDEAN
        if self._mesh is not None:
            from ..dist.sharding import sharded_search_pq

            rows = self._capacity // self._mesh.size
            return sharded_search_pq(
                self._dev_codes, self._dev_codebooks, self._dev_sqnorms, valid,
                queries, metric=sel_metric, k=k_pad,
                chunk=min(_pq_scan_chunk(self._pq_code_bits()), rows),
                mesh=self._mesh, packed=self._pq_packed,
            )
        return pq.pq_search_topk(
            self._dev_codes, self._dev_codebooks, self._dev_sqnorms, valid,
            queries, metric=sel_metric, k=min(k_pad, self._capacity),
            chunk=min(_pq_scan_chunk(self._pq_code_bits()), self._capacity),
            packed=self._pq_packed,
        )

    def _mesh_topk(self, queries, k_pad, metric, approx, valid):
        """The sharded engines (dist/sharding.py), each shard routed as
        the single-device index routes at the shard's rows: K2 for the
        int8 profile; for ``approx`` the speed path (K3 over the bf16
        scan copy, or the rows, and an exact f32 re-score of the pool);
        else K1, or K4 for Manhattan."""
        from ..dist import sharding

        mesh = self._mesh
        if self._quantized:
            return sharding.sharded_search_topk_int8(
                self._dev_values, self._dev_scales, self._dev_sqnorms, valid,
                queries, metric=metric, k=k_pad, mesh=mesh,
            )
        if approx and metric is not SimilarityMetric.MANHATTAN:
            rows = self._dev_scan if self._dev_scan is not None else self._dev_values
            tomb = self._count != self._size
            return sharding.sharded_search_amk(
                rows, self._dev_values, self._dev_sqnorms, valid, queries,
                metric=metric, k=k_pad,
                k_sel=min(self._capacity, max(_K_SEL_MIN, next_pow2(2 * k_pad))),
                mesh=mesh, tombstones=tomb, live_hi=None if tomb else self._size,
            )
        return sharding.sharded_search_topk(
            self._dev_values, self._dev_sqnorms, valid, queries,
            metric=metric, k=k_pad, mesh=mesh,
        )

    def _pool_k(self, k_sel: int, k_pad: int) -> int:
        """The K3 pool width, within what the lane groups can yield
        (capacity/128*W candidates)."""
        k_sel = min(self._capacity, k_sel)
        if k_sel * (128 // _BLOCK_WINNERS) > self._capacity:
            return k_pad
        return k_sel

    def _mark_dirty(self, slot: int) -> None:
        if self._dirty_hi == self._dirty_lo:
            self._dirty_lo, self._dirty_hi = slot, slot + 1
        else:
            self._dirty_lo = min(self._dirty_lo, slot)
            self._dirty_hi = max(self._dirty_hi, slot + 1)
        self._mask_dirty = True

    def _grow(self, min_capacity: Optional[int] = None) -> None:
        """Double capacity — straight to the power of 2 covering
        ``min_capacity`` when given, so a bulk insert pays one
        reallocation."""
        new_cap = self._capacity * 2
        if min_capacity is not None:
            while new_cap < min_capacity:
                new_cap *= 2
        growth = new_cap - self._capacity
        n = self._size
        new_vals = self._alloc_values(new_cap)
        new_vals[:n] = self._values64[:n]
        self._values64 = new_vals
        new_ids = np.zeros(new_cap, np.uint64)
        new_ids[:n] = self._ids[:n]
        self._ids = new_ids
        new_valid = np.zeros(new_cap, bool)
        new_valid[:n] = self._valid[:n]
        self._valid = new_valid
        self._texts.extend([None] * growth)
        self._metas.extend([None] * growth)
        if self._host_norms64 is not None:
            new_norms = np.zeros(new_cap, np.float64)
            new_norms[:n] = self._host_norms64[:n]
            self._host_norms64 = new_norms
        self._capacity = new_cap
        # capacity changed: device tensors are rebuilt wholesale, and the
        # PQ codebooks retrain on the (roughly 2x larger) corpus, so drift
        # from appends is bounded by one capacity generation
        self._drop_device()
        self._dev_codebooks = None
        self._dirty_lo, self._dirty_hi = 0, self._size
        self._mask_dirty = True

    def _drop_device(self) -> None:
        """Drop the device caches; PQ codebooks survive (a compaction keeps
        a subset of the rows, only their slots move)."""
        self._dev_values = None
        self._dev_codes = None
        self._dev_scan = None
        self._dev_scan_scales = None
        self._dev_scales = None
        self._dev_sqnorms = None
        self._dev_valid = None

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self._device)

    def _upload(self, q: np.ndarray) -> torch.Tensor:
        """The queries on the device. On the card they go through pinned
        memory without a wait: a copy from pageable memory would block
        the host until the kernels already queued have run, so a stream's
        next launch could not be queued behind them."""
        t = torch.from_numpy(q)
        if self._device.type != "cuda":
            return t.to(self._device)
        return t.pin_memory().to(self._device, non_blocking=True)

    def _place(self, array, dtype=None):
        """A full ``[cap, ...]`` host array on the device (cast to
        ``dtype`` on the host first), or split over the mesh's shards."""
        if self._mesh is not None:
            from ..dist.sharding import shard_rows

            return shard_rows(self._mesh, array, dtype)
        t = torch.from_numpy(array)
        return (t if dtype is None else t.to(dtype)).to(self._device)

    def _write(self, buf, rows, lo: int) -> None:
        """``rows`` (a host array or a device tensor) into ``buf[lo:]`` in
        place, or into the shards they land on."""
        if self._mesh is not None:
            from ..dist.sharding import update_rows_sharded

            update_rows_sharded(buf, rows, lo, mesh=self._mesh)
        else:
            if isinstance(rows, np.ndarray):
                rows = self._to_device(rows)
            update_rows(buf, rows, lo)

    def _dirty_window(self) -> tuple[int, int]:
        """The dirty rows to write. On a mesh the window is the JAX
        package's: a power-of-two burst ending at the dirty end (or at the
        capacity), so a burst straddles shard boundaries as it does
        there."""
        lo, hi = self._dirty_lo, self._dirty_hi
        if self._mesh is not None:
            burst = next_pow2(hi - lo)
            hi = min(self._capacity, lo + burst)
            lo = max(0, hi - burst)
        return lo, hi

    def _sync_device(self) -> None:
        """Bring every device cache up to the host truth: the rung tensors
        (_sync_device_core) and, past the gate, the IVF layout. The mask
        and dirty range are snapshotted first because the core sync
        consumes them."""
        mask_was_dirty = self._mask_dirty
        dirty_lo, dirty_hi = self._dirty_lo, self._dirty_hi
        self._sync_device_core()
        if self._ivf_wanted():
            self._sync_device_ivf(mask_was_dirty, dirty_lo, dirty_hi)
        elif self._ivf_rows is not None:
            self._ivf_drop()

    def _sync_device_core(self) -> None:
        """The rung tensors: a wholesale build when there are none, else
        the dirty rows in place. An active PQ rung has freed the f32
        cache, so its check comes first."""
        if self._pq and self._sync_device_pq():
            return
        if self._mesh is not None:
            self._sync_device_mesh()
            return
        if self._dev_values is None:
            self._build_device()
            return
        if self._dirty_hi > self._dirty_lo:
            lo, hi = self._dirty_lo, self._dirty_hi
            rows32 = self._to_device(self._values64[lo:hi].astype(np.float32))
            update_rows(self._dev_sqnorms, row_sqnorms(rows32), lo)
            if self._quantized:
                rows_q, row_scales = quantize_rows_int8(rows32)
                update_rows(self._dev_values, rows_q, lo)
                update_rows(self._dev_scales, row_scales, lo)
            else:
                update_rows(self._dev_values, rows32, lo)
            if self._dev_scan is not None:
                if self._dev_scan.dtype == torch.int8:
                    s_rows, s_scales = quantize_rows_int8(rows32)
                    update_rows(self._dev_scan, s_rows, lo)
                    update_rows(self._dev_scan_scales, s_scales, lo)
                else:
                    update_rows(self._dev_scan, rows32, lo)
            self._dirty_lo = self._dirty_hi = self._size
        if self._mask_dirty:
            self._dev_valid = self._to_device(self._valid)
            self._mask_dirty = False

    def _sync_device_pq(self) -> bool:
        """Maintain the PQ cache (codes + codebooks + exact squared norms).
        True when the PQ rung serves; False below the training gate, where
        the plain f32 path serves and the first sync past the gate swaps
        the cache wholesale."""
        gate = max(1024, int(env_number("VECTORLITE_PQ_MIN_ROWS", 16384)))
        if self._dev_codes is None:
            if self._size < gate:
                self._pq_active = False
                return False
            if self._dev_codebooks is None:
                self._train_pq()
            # encode every slot below capacity in fixed buckets; each casts
            # its own f64 rows to f32 (no full-capacity f32 staging copy).
            # Invalid slots encode too; the validity mask hides them.
            step = min(_PQ_ENCODE_BUCKET, self._capacity)
            m = int(self._dev_codebooks.shape[0])
            codes = torch.empty(
                (self._capacity, m // 2 if self._pq_packed else m),
                dtype=torch.uint8, device=self._device,
            )
            for lo in range(0, self._capacity, step):
                update_rows(
                    codes, self._encode_pq(self._values64[lo : lo + step]), lo
                )
            if self._mesh is not None:
                from ..dist.sharding import shard_rows

                codes = shard_rows(self._mesh, codes)
            self._dev_codes = codes
            # exact squared norms from the f64 truth, reduced straight to
            # [cap] (no [cap, D] temp)
            sq = np.einsum("nd,nd->n", self._values64, self._values64)
            self._dev_sqnorms = self._place(sq.astype(np.float32))
            self._dev_valid = self._place(self._valid)
            # free the f32 cache (the whole point is capacity)
            self._dev_values = None
            self._dev_scan = None
            self._dev_scan_scales = None
            self._dev_scales = None
            self._precision_risky = False
            self._dirty_lo = self._dirty_hi = self._size
            self._mask_dirty = False
            self._pq_active = True
            return True
        if self._dirty_hi > self._dirty_lo:
            # appended rows use the codebooks (and rotation) of the last
            # wholesale build; the next capacity doubling retrains
            lo, hi = self._dirty_window()
            rows32 = self._to_device(self._values64[lo:hi].astype(np.float32))
            self._write(self._dev_sqnorms, row_sqnorms(rows32), lo)
            self._write(self._dev_codes, self._encode_pq(self._values64[lo:hi]), lo)
            self._dirty_lo = self._dirty_hi = self._size
        if self._mask_dirty:
            self._dev_valid = self._place(self._valid)
            self._mask_dirty = False
        self._pq_active = True
        return True

    def _train_pq(self) -> None:
        """Fix the code layout and the rotation, and train the codebooks
        on a default_rng(0) sample of live rows."""
        bits = _pq_bits()
        kc = 16 if bits == 4 else 256
        m = pq.pq_subspaces(
            self.dim,
            int(
                env_number(
                    "VECTORLITE_PQ_M", max(1, self.dim // (2 if bits == 4 else 4))
                )
            ),
        )
        self._pq_packed = bits == 4 and m % 2 == 0
        self._pq_bits_active = bits
        # OPQ-lite, decided at the wholesale build only, so appends always
        # encode like the live cache
        self._pq_rot = (
            self._to_device(pq.rotation_matrix(self.dim))
            if env_number("VECTORLITE_PQ_ROTATE", 1) == 1
            else None
        )
        sample_n = min(
            self._size, int(env_number("VECTORLITE_PQ_TRAIN_SAMPLE", 32768))
        )
        live = np.nonzero(self._valid[: self._size])[0]
        if len(live) > sample_n:
            sel = np.random.default_rng(0).choice(live, sample_n, replace=False)
            sel.sort()
        else:
            sel = live
        sample = self._to_device(self._values64[sel].astype(np.float32))
        if self._pq_rot is not None:
            sample = sample @ self._pq_rot
        self._dev_codebooks = pq.train_codebooks(
            sample, m, kc=kc,
            iters=int(env_number("VECTORLITE_PQ_TRAIN_ITERS", 16)),
        )

    def _encode_pq(self, rows64: np.ndarray) -> torch.Tensor:
        """Device codes of f64 rows: cast, rotate, encode, pack."""
        rows = self._to_device(rows64.astype(np.float32))
        if self._pq_rot is not None:
            rows = rows @ self._pq_rot
        codes = pq.encode_rows(self._dev_codebooks, rows)
        return pq.pack_nibbles(codes) if self._pq_packed else codes

    def _build_device(self) -> None:
        """Wholesale build. "auto" resolves on every build (capacity
        growth drops the cache, so the profile adapts as the corpus
        grows). Casts and quantization run on the HOST so only
        final-dtype bytes are transferred."""
        self._device_dtype = self._prospective_dtype()
        if self._device_dtype == torch.int8:
            # bottom rung of the auto ladder: the full quantized machinery
            self._quantized = True
        vals32 = np.asarray(self._values64, dtype=np.float32)
        # auto-guard (VECTORLITE_SPEED_GUARD=0 disables): refuse the scan
        # copy and approximate selection on corpora where reduced-precision
        # ranking could push true top-k rows out of the pool
        self._precision_risky = (
            _use_pallas(self._capacity)
            and env_number("VECTORLITE_SPEED_GUARD", 1) == 1
            and _bf16_selection_risky(vals32, self._valid, self._size)
        )
        sq = np.einsum("nd,nd->n", vals32, vals32, dtype=np.float32)
        self._dev_sqnorms = self._to_device(sq)
        if self._quantized:
            q, scales = _quantize_rows_int8_np(vals32)
            self._dev_values = self._to_device(q)
            self._dev_scales = self._to_device(scales)
        elif self._device_dtype == torch.bfloat16:
            self._dev_values = (
                torch.from_numpy(vals32).to(torch.bfloat16).to(self._device)
            )
        else:
            self._dev_values = self._to_device(vals32)
        self._dev_scan = self._dev_scan_scales = None
        if self._device_dtype == torch.float32 and self._scan_copy_wanted():
            if self._scan_copy_dtype() == torch.int8:
                q, scales = _quantize_rows_int8_np(vals32)
                self._dev_scan = self._to_device(q)
                self._dev_scan_scales = self._to_device(scales)
            else:
                self._dev_scan = (
                    torch.from_numpy(vals32).to(torch.bfloat16).to(self._device)
                )
        self._dev_valid = self._to_device(self._valid)
        self._dirty_lo = self._dirty_hi = self._size
        self._mask_dirty = False

    def _sync_device_mesh(self) -> None:
        """Mesh placement: a wholesale build uploads each shard's rows from
        the host (no device stages the whole corpus), with the precision
        guard and the scan copy (bf16, as in the JAX package's mesh) decided
        as on one device; insert bursts write the shards they land on."""
        if self._dev_values is None:
            self._device_dtype = self._prospective_dtype()
            vals32 = np.asarray(self._values64, dtype=np.float32)
            self._precision_risky = (
                _use_pallas(self._capacity)
                and env_number("VECTORLITE_SPEED_GUARD", 1) == 1
                and _bf16_selection_risky(vals32, self._valid, self._size)
            )
            self._dev_sqnorms = self._place(
                np.einsum("nd,nd->n", vals32, vals32, dtype=np.float32)
            )
            if self._quantized:
                q, scales = _quantize_rows_int8_np(vals32)
                self._dev_values = self._place(q)
                self._dev_scales = self._place(scales)
            else:
                self._dev_values = self._place(vals32, self._device_dtype)
            self._dev_scan = self._dev_scan_scales = None
            if self._device_dtype == torch.float32 and self._scan_copy_wanted():
                self._dev_scan = self._place(vals32, torch.bfloat16)
            self._dev_valid = self._place(self._valid)
            self._dirty_lo = self._dirty_hi = self._size
            self._mask_dirty = False
            return
        if self._dirty_hi > self._dirty_lo:
            lo, hi = self._dirty_window()
            rows32 = np.asarray(self._values64[lo:hi], dtype=np.float32)
            self._write(
                self._dev_sqnorms, np.einsum("nd,nd->n", rows32, rows32, dtype=np.float32), lo
            )
            if self._quantized:
                rows_q, row_scales = _quantize_rows_int8_np(rows32)
                self._write(self._dev_values, rows_q, lo)
                self._write(self._dev_scales, row_scales, lo)
            else:
                self._write(self._dev_values, rows32, lo)
                if self._dev_scan is not None:
                    self._write(self._dev_scan, rows32, lo)
            self._dirty_lo = self._dirty_hi = self._size
        if self._mask_dirty:
            self._dev_valid = self._place(self._valid)
            self._mask_dirty = False

    # ------------------------------------------------------ IVF scale rung

    def _ivf_wanted(self) -> bool:
        """Gate for the IVF partitioned scan (kernels/ivf.py): off under
        VECTORLITE_IVF=0, otherwise engaged on corpora of at least
        VECTORLITE_IVF_MIN_ROWS live rows (default 2M). Serves the
        f32/bf16 rungs and the int8 rung on a CUDA device; the PQ rung
        keeps its ADC engine. On the CPU it serves only under
        VECTORLITE_IVF_FORCE (tests), the reference's own switch for its
        CPU backend. Not vetoed by _precision_risky: that
        flag estimates displacement against the whole corpus, and
        _ivf_build re-runs the statistic against the probed window."""
        if env_number("VECTORLITE_IVF", 1) != 1:
            return False
        if self._pq or self._mesh is not None:
            # a mesh serves the sharded brute engines (the sharded probe
            # stage is dist/sharding.py sharded_search_ivf)
            return False
        if self._device.type != "cuda" and not os.environ.get(
            "VECTORLITE_IVF_FORCE"
        ):
            return False
        min_rows = int(env_number("VECTORLITE_IVF_MIN_ROWS", 2_000_000))
        if self._count < max(min_rows, 4 * 128):
            return False
        # refusal cache: the guard found the geometry unservable within
        # the probe budget; retry once the corpus doubles
        if self._ivf_refused_at and self._count < 2 * self._ivf_refused_at:
            return False
        return True

    def _ivf_drop(self) -> None:
        """Drop the layout. The centroids survive (retrained only when the
        cell count changes), and so does the refusal cache, which keeps
        _ivf_wanted from re-running k-means on every sync of a corpus the
        guard already refused."""
        self._ivf_rows = None
        self._ivf_scales = None
        self._ivf_slots = None
        self._ivf_sq = None
        self._ivf_valid = None
        self._ivf_extra = ()
        self._ivf_active = False
        self._ivf_hi = 0
        self._ivf_slots_np = None
        self._ivf_extra_slots_np = None
        self._ivf_nprobe_floor = 0

    def _sync_device_ivf(
        self, mask_was_dirty: bool, dirty_lo: int, dirty_hi: int
    ) -> None:
        """Maintain the IVF layout next to the rung tensors.

        Slots below ``_ivf_hi`` live in the layout (or its extras); slots
        in ``[_ivf_hi, _size)`` are the tail, brute-scanned by every IVF
        query, so appends never touch the layout. It rebuilds wholesale
        when the tail outgrows its budget, when a dirty range reaches
        below the watermark (capacity growth re-marks every row), or
        after compaction renumbers slots (_compact drops it). Tombstone
        flips only refresh the validity tables."""
        if self._ivf_rows is not None:
            if dirty_hi > dirty_lo and dirty_lo < self._ivf_hi:
                self._ivf_drop()
            else:
                tail = self._size - self._ivf_hi
                tail_max = max(
                    int(env_number("VECTORLITE_IVF_TAIL_MAX", 131072)),
                    int(0.05 * self._count),
                )
                if tail > tail_max:
                    self._ivf_drop()
        if self._ivf_rows is None:
            self._ivf_build()
            return
        if mask_was_dirty:
            self._ivf_refresh_valid()

    def _ivf_guard_nprobe(
        self, live: np.ndarray, assign: np.ndarray
    ) -> Optional[int]:
        """Measured cell-recall guard. ``assign`` is the cell each live row
        is stored in (-1 = extras, which every probe scans). 64 sampled
        live rows take their exact cosine top-10 over the whole corpus;
        the guard measures what share of those neighbours' cells the
        coarse quantizer ranks inside the probe window. Returns 0 when the
        default nprobe clears ``VECTORLITE_IVF_GUARD_RECALL`` (0.985), the
        smallest of 2x and 4x that does, or None to refuse.
        ``VECTORLITE_IVF_GUARD=0`` skips the guard."""
        if env_number("VECTORLITE_IVF_GUARD", 1) != 1:
            return 0
        thr = float(env_number("VECTORLITE_IVF_GUARD_RECALL", 0.985))
        n_live = len(live)
        rng = np.random.default_rng(1)
        nq = int(np.clip(n_live // 8, 1, 64))
        qsel = rng.choice(n_live, nq, replace=False)
        qrows = self._values64[live[qsel]].astype(np.float32)
        qn = np.maximum(np.linalg.norm(qrows, axis=1, keepdims=True), 1e-30)
        q = qrows / qn
        k_t = min(10, n_live - 1)
        step = 1 << 20
        top_s = np.full((nq, 0), 0.0, np.float32)
        top_p = np.full((nq, 0), 0, np.int64)
        for lo in range(0, n_live, step):
            blk = self._values64[live[lo : lo + step]].astype(np.float32)
            bn = np.maximum(np.linalg.norm(blk, axis=1), 1e-30)
            s = (q @ blk.T) / bn[None, :]
            m = s.shape[1]
            kk = min(k_t + 1, m)  # +1 so the self-hit can be dropped
            part = np.argpartition(-s, kk - 1, axis=1)[:, :kk]
            top_s = np.concatenate(
                [top_s, np.take_along_axis(s, part, axis=1)], axis=1
            )
            top_p = np.concatenate([top_p, part + lo], axis=1)
        # drop self-hits, keep the global top-k_t positions (into live)
        top_s = np.where(top_p == qsel[:, None], -np.inf, top_s)
        keep = np.argpartition(-top_s, k_t - 1, axis=1)[:, :k_t]
        truth = np.take_along_axis(top_p, keep, axis=1)
        truth_cells = assign[truth]  # [nq, k_t]
        # query -> ranked cells by the serving surrogate (cosine)
        cents = self._ivf_centroids.cpu().numpy()
        csq = np.maximum(np.einsum("cd,cd->c", cents, cents), 1e-30)
        crank = (q @ cents.T) / np.sqrt(csq)[None, :]
        order = np.argsort(-crank, axis=1)
        c = cents.shape[0]
        base = _ivf_base_nprobe(c)
        for mult in (1, 2, 4):
            l_probe = min(base * mult, c)
            window = order[:, :l_probe]
            # cell -1: the row lives in the extras, an unconditional hit
            hits = sum(
                float(
                    (
                        np.isin(truth_cells[i], window[i])
                        | (truth_cells[i] < 0)
                    ).sum()
                )
                for i in range(nq)
            )
            if hits / (nq * k_t) >= thr:
                return l_probe if mult > 1 else 0
            if l_probe == c:
                break
        return None

    def _ivf_build(self) -> None:
        """Wholesale layout build: k-means centroids on a live-row sample
        (retrained only when the cell count changes), top-2 assignment of
        every live row, the layout, the two guards, then the cell-contiguous
        copy uploaded in bounded chunks."""
        live = np.nonzero(self._valid[: self._size])[0]
        n_live = len(live)
        part_rows = max(64, int(env_number("VECTORLITE_IVF_PART_ROWS", 512)))
        c = int(np.clip(next_pow2(max(1, n_live // part_rows)), 64, 65536))
        if (
            self._ivf_centroids is None
            or int(self._ivf_centroids.shape[0]) != c
        ):
            sample_n = min(
                n_live,
                max(int(env_number("VECTORLITE_IVF_TRAIN_SAMPLE", 262144)), 2 * c),
            )
            if sample_n < n_live:
                sel = np.random.default_rng(0).choice(live, sample_n, replace=False)
                sel.sort()
            else:
                sel = live
            self._ivf_centroids = ivf.train_centroids(
                self._values64[sel].astype(np.float32),
                c,
                iters=int(env_number("VECTORLITE_IVF_ITERS", 8)),
                device=self._device,
            )
            self._ivf_cent_sq = torch.sum(
                self._ivf_centroids * self._ivf_centroids, dim=1
            )
        # top-2 assignment: rows of over-full cells spill to their
        # runner-up cell before falling to the brute-scanned extras
        assign2 = ivf.assign_rows(
            self._values64, live, self._ivf_centroids, top2=True
        )
        part_slots, extra_slots = ivf.build_layout(
            assign2, live, c,
            pad_factor=float(env_number("VECTORLITE_IVF_PAD", ivf.PAD_FACTOR)),
        )
        p_width = part_slots.shape[1]
        cp = c * p_width
        # the guard measures the layout that will serve: each row's cell
        # from part_slots (-1 = extras)
        cells_of = np.repeat(np.arange(c, dtype=np.int32), p_width)
        ps_flat = part_slots.reshape(-1)
        in_layout = ps_flat >= 0
        slot_cell = np.full(self._size, -1, dtype=np.int32)
        slot_cell[ps_flat[in_layout]] = cells_of[in_layout]
        floor = self._ivf_guard_nprobe(live, slot_cell[live])
        if floor is None:
            # cell-recall below the bar within the probe budget (iid
            # high-D corpora): the brute engine keeps serving; retry once
            # the corpus doubles (_ivf_wanted)
            self._ivf_refused_at = self._count
            self._ivf_drop()
            logger.info(
                "IVF guard: cell-recall below target within the probe "
                "budget at %d rows; keeping the brute engine", self._count,
            )
            return
        self._ivf_nprobe_floor = floor
        if self._precision_risky:
            # the whole-corpus displacement estimate refused reduced-
            # precision selection, but IVF ranks within ~nprobe * P rows:
            # re-run the statistic with that window as the competitors.
            # Kept as the reference has it: the bf16 epsilon also for an
            # int8 layout, and the window without the extras (ROADMAP §4)
            window_rows = max(_ivf_base_nprobe(c), floor) * p_width
            if _bf16_selection_risky(
                self._values64, self._valid, self._size,
                competitor_rows=window_rows,
            ):
                self._ivf_refused_at = self._count
                self._ivf_drop()
                logger.info(
                    "IVF guard: window-scaled precision displacement still "
                    "above target at %d rows; keeping the exact engine",
                    self._count,
                )
                return
        # layout dtype: int8 (+ scales) on the int8 rung; otherwise bf16
        # unless storage + a bf16 layout would bust the memory budget,
        # where int8 takes over (not itself checked to fit, as in the
        # reference)
        layout_i8 = bool(self._quantized)
        if not layout_i8:
            storage_bytes = self._capacity * self.dim * (
                2 if self._device_dtype == torch.bfloat16 else 4
            )
            if self._dev_scan is not None:
                storage_bytes += self._dev_scan.numel() * self._dev_scan.element_size()
            layout_i8 = storage_bytes + cp * self.dim * 2 > _hbm_budget_bytes(
                self._device
            )
        rows_dev = torch.zeros(
            (cp, self.dim), dtype=torch.int8 if layout_i8 else torch.bfloat16,
            device=self._device,
        )
        scales_np = np.zeros(cp, dtype=np.float32) if layout_i8 else None
        sq_np = np.zeros(cp, dtype=np.float32)
        chunk = 262144
        for lo in range(0, cp, chunk):
            sl = ps_flat[lo : lo + chunk]
            rows32 = self._values64[np.maximum(sl, 0)].astype(np.float32)
            rows32[sl < 0] = 0.0
            sq_np[lo : lo + chunk] = np.einsum("nd,nd->n", rows32, rows32)
            if layout_i8:
                q8, qs = _quantize_rows_int8_np(rows32)
                scales_np[lo : lo + chunk] = qs
                update_rows(rows_dev, self._to_device(q8), lo)
            else:
                update_rows(
                    rows_dev,
                    torch.from_numpy(rows32).to(torch.bfloat16).to(self._device),
                    lo,
                )
        self._ivf_rows = rows_dev
        self._ivf_scales = self._to_device(scales_np) if layout_i8 else None
        self._ivf_slots = self._to_device(ps_flat.astype(np.int32))
        self._ivf_sq = self._to_device(sq_np)
        self._ivf_slots_np = ps_flat
        # overflow extras, padded to max(128, next_pow2(e)) rows
        e = len(extra_slots)
        e_pad = max(128, next_pow2(e)) if e else 0
        ex_dtype = torch.int8 if layout_i8 else torch.bfloat16
        if e_pad:
            ex32 = np.zeros((e_pad, self.dim), dtype=np.float32)
            ex32[:e] = self._values64[extra_slots].astype(np.float32)
            ex_slots = np.zeros(e_pad, dtype=np.int32)
            ex_slots[:e] = extra_slots
            ex_valid = np.zeros(e_pad, dtype=bool)
            ex_valid[:e] = self._valid[extra_slots]
            if layout_i8:
                ex8, ex_sc = _quantize_rows_int8_np(ex32)
                ex_rows = self._to_device(ex8)
                ex_scales = self._to_device(ex_sc)
            else:
                ex_rows = torch.from_numpy(ex32).to(torch.bfloat16).to(self._device)
                ex_scales = None
            self._ivf_extra = (
                ex_rows,
                self._to_device(ex_slots),
                self._to_device(np.einsum("nd,nd->n", ex32, ex32)),
                self._to_device(ex_valid),
                ex_scales,
            )
        else:
            self._ivf_extra = (
                torch.zeros((0, self.dim), dtype=ex_dtype, device=self._device),
                torch.zeros(0, dtype=torch.int32, device=self._device),
                torch.zeros(0, dtype=torch.float32, device=self._device),
                torch.zeros(0, dtype=torch.bool, device=self._device),
                torch.zeros(0, dtype=torch.float32, device=self._device)
                if layout_i8 else None,
            )
        self._ivf_extra_slots_np = extra_slots
        self._ivf_p = p_width
        self._ivf_hi = self._size
        self._ivf_valid = self._to_device(
            (ps_flat >= 0) & self._valid[np.maximum(ps_flat, 0)]
        )
        self._ivf_active = True
        self._ivf_refused_at = 0

    def _ivf_refresh_valid(self) -> None:
        """Tombstone flips: re-gather the layout's validity tables from the
        host mask (the layout itself is untouched)."""
        ps = self._ivf_slots_np
        self._ivf_valid = self._to_device(
            (ps >= 0) & self._valid[np.maximum(ps, 0)]
        )
        ex = self._ivf_extra_slots_np
        if len(ex):
            rows, slots, sq, old_valid, ex_sc = self._ivf_extra
            ex_valid = np.zeros(int(old_valid.shape[0]), dtype=bool)
            ex_valid[: len(ex)] = self._valid[ex]
            self._ivf_extra = (rows, slots, sq, self._to_device(ex_valid), ex_sc)

    def _ivf_topk(self, queries, k_pad: int, metric: SimilarityMetric):
        """Dispatch the IVF serving step, or None when the brute engines
        are the better program for this batch: probe traffic scales with
        B * nprobe * P, while one corpus read amortizes over the whole
        batch, so IVF serves only while the probes read at most half the
        live rows."""
        b = int(queries.shape[0])
        c = int(self._ivf_cent_sq.shape[0])
        # the guard-measured recall floor never exceeds C
        nprobe = max(_ivf_base_nprobe(c), self._ivf_nprobe_floor)
        if b * nprobe * self._ivf_p > max(1, self._count) // 2:
            return None
        tail_len = self._size - self._ivf_hi
        tail_pad = 0 if tail_len <= 0 else max(256, next_pow2(tail_len))
        k_sel = min(nprobe * self._ivf_p, max(_K_SEL_MIN, next_pow2(2 * k_pad)))
        ex_rows, ex_slots, ex_sq, ex_valid, ex_scales = self._ivf_extra
        return ivf.ivf_search_topk_rescored(
            self._ivf_rows, self._ivf_slots, self._ivf_sq, self._ivf_valid,
            self._ivf_centroids, self._ivf_cent_sq,
            ex_rows, ex_slots, ex_sq, ex_valid,
            self._dev_values, self._dev_valid, queries,
            self._ivf_hi, self._size,
            part_scales=self._ivf_scales,
            extra_scales=ex_scales,
            values_scales=self._dev_scales if self._quantized else None,
            metric=metric,
            k=k_pad,
            k_sel=k_sel,
            nprobe=nprobe,
            p_width=self._ivf_p,
            tail_pad=tail_pad,
            tombstones=self._count != self._size,
        )

    # ----------------------------------------------------------- persistence

    def index_to_json(self) -> dict:
        """Reference serde shape: ``{"dim": D, "data": [Vector...]}``
        (reference: src/index/flat.rs:59-65), vectors in insertion order,
        ``data`` a lazy FlatRowsView over the truth matrix."""
        live = np.nonzero(self._valid[: self._size])[0]
        return {
            "dim": self.dim,
            "data": FlatRowsView(
                ids=self._ids[live],
                slots=live,
                values=self._values64,
                texts=[self._texts[s] or "" for s in live],
                metas=[self._metas[s] for s in live],
            ),
        }

    @classmethod
    def index_from_json(cls, obj: dict, **kwargs) -> "FlatIndex":
        """Rebuild from ``index_to_json``'s dict — this package's or the
        JAX package's (same shape): ids, texts, metadata and f64 rows in
        insertion order. ``kwargs`` go to the constructor (``device=``,
        ``device_dtype=``)."""
        dim = int(obj["dim"])
        rows = obj.get("data", [])
        if rows and all(
            isinstance(r.get("values"), np.ndarray)
            and r["values"].ndim == 1
            and r["values"].shape[0] == dim
            for r in rows
        ):
            index = cls(dim, **kwargs)
            vals = [r["values"] for r in rows]
            mat = _rows_as_matrix(vals, dim)
            if mat is None:
                mat = np.stack(vals).astype(np.float64, copy=False)
            index.add_batch_arrays(
                [int(r["id"]) for r in rows],
                mat,
                texts=[r["text"] for r in rows],
                metadatas=[r.get("metadata") for r in rows],
            )
            return index
        vectors = [
            Vector(
                id=int(v["id"]),
                values=np.asarray(v["values"], dtype=np.float64),
                text=v["text"],
                metadata=v.get("metadata"),
            )
            for v in rows
        ]
        return cls(dim, vectors, **kwargs)
