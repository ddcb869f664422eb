"""Product-quantization serving rung: codebook training, encoding, and ADC
search, with the Hopper rank kernel K5 and its plain twin.

Port of ``vectorlite_tpu/kernels/pq.py``. Two code widths, as there:

* **4-bit (default)**: kc = 16 centroids over dsub = 2-dim subspaces
  (M = dim / 2), two codes nibble-packed a byte: 96 bytes a row at 384-d.
* **8-bit**: kc = 256 over dsub = 4 subspaces, one byte a code
  (``VECTORLITE_PQ_BITS=8``).

Winners are always re-scored in exact f64 on the host from the
uncompressed truth (``FlatIndex._exact_rescore``), so returned scores
match the scalar reference formulas and only the ranking is approximate.

* **Training** (``train_codebooks``): Lloyd's k-means one subspace at a
  time on the index's device, from an explicit ``torch.Generator``. It
  keeps the reference's init from distinct sample rows, f32 assignment by
  ``|x|^2 - 2 x.c + |c|^2``, one-hot centroid sums and the reseeding of
  dead centroids; its random draws are not JAX's, so the tests carry the
  JAX package's codebooks across with ``codebooks_from_reference``.
* **Encoding** (``encode_rows``): the same assignment, one subspace at a
  time.
* **Search** (``pq_search_topk``): a per-query LUT ``[B, M, kc]`` rounded
  to bf16; per corpus chunk the ``[B, chunk]`` selection rank (K5 for CUDA
  tensors: ``csrc/pq.cu`` ``pq_rank_mma``, the one-hot product on the
  tensor cores, for kc = 16, and ``pq_rank``, look-ups in a bf16 LUT
  staged in shared memory, for any other kc; ``pq_rank_plain`` for CPU
  tensors); the top k + 32 of each
  chunk, ties to the lowest row; the
  merged top k + 32; an exact-f32 ADC re-score of that pool with the f32
  LUT, the full metric formula and the validity mask.

The reference selects each chunk with XLA's ``approx_max_k``, a TPU
compiler feature; here the selection is exact (``select_topk``): a
threshold from ``torch.topk`` and a stable fill of the tied values, since
``torch.topk`` promises no tie order on CUDA.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.metrics import SimilarityMetric, disable_tf32
from . import _build
from .topk import stable_topk

NEG_INF = float("-inf")

#: codes per codebook of the 8-bit profile; one uint8 per subspace.
K_CODES = 256

#: extra surrogate-ranked candidates carried into the exact-f32 ADC
#: re-score, so bf16 LUT rounding at the pool boundary cannot evict a true
#: ADC top-k member (vectorlite_tpu/kernels/pq.py:228)
_EXACT_MARGIN = 32

#: bytes of one-hot operand the plain rank builds at a time
_PLAIN_ONEHOT_BYTES = 1 << 30

#: shared memory one block can hold (Hopper: 227 KB)
_SMEM_MAX = 232448

_METRIC_CODE = {
    SimilarityMetric.COSINE: 0,
    SimilarityMetric.EUCLIDEAN: 1,
    SimilarityMetric.DOT_PRODUCT: 2,
    SimilarityMetric.MANHATTAN: 3,
}

_P = ctypes.c_void_p
_I = ctypes.c_int

PQ_RANK = _build.Kernel(
    "pq", "pq_rank", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
)
PQ_RANK_MMA = _build.Kernel(
    "pq", "pq_rank_mma",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
)

#: codes a subspace the tensor-core entry takes: one bf16 MMA k-step
MMA_KC = 16

#: queries of the widest tile of the tensor-core entry (one wgmma's N)
_MMA_MAX_TILE = 256

#: the tensor-core entry's tile: 128 rows, their codes and the two
#: warpgroups' one-hot A tiles in shared memory beside at least two LUT
#: stages of 4 subspaces (csrc/pq.cu layout_for)
_MMA_ROWS = 128
_MMA_GROUP = 4


def rotation_matrix(dim: int, seed: int = 0) -> np.ndarray:
    """Seeded random orthonormal rotation [D, D] f32, applied before the
    subspace split (OPQ-lite): spreads an anisotropic corpus's variance
    evenly over the subspaces and preserves dot, cosine and euclidean.
    numpy from the seed, so both packages build the same matrix bit for
    bit."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    return q.astype(np.float32)


def pq_subspaces(dim: int, m_requested: int) -> int:
    """Largest divisor of ``dim`` that is <= m_requested (every subspace
    gets an equal, whole number of dims)."""
    m = max(1, min(int(m_requested), dim))
    while dim % m:
        m -= 1
    return m


def _kmeans_subspace(x, init, gen, *, iters: int):
    """Lloyd's iterations for one subspace: x [S, d], init [kc, d]. Empty
    clusters are re-seeded from random sample rows."""
    s = x.shape[0]
    kc = init.shape[0]
    xsq = torch.sum(x * x, dim=1)
    c = init
    iota = torch.arange(kc, device=x.device)
    for _ in range(iters):
        csq = torch.sum(c * c, dim=1)
        d2 = xsq[:, None] - 2.0 * (x @ c.T) + csq[None, :]
        assign = torch.argmin(d2, dim=1)
        onehot = (assign[:, None] == iota[None, :]).to(x.dtype)
        counts = torch.sum(onehot, dim=0)
        sums = onehot.T @ x
        new_c = sums / torch.clamp(counts, min=1.0)[:, None]
        reseed = x[torch.randint(0, s, (kc,), generator=gen, device=x.device)]
        c = torch.where((counts > 0)[:, None], new_c, reseed)
    return c


def train_codebooks(
    sample32,  # [S, D] f32 live-row sample (numpy or tensor)
    m: int,
    *,
    kc: int = K_CODES,
    iters: int = 10,
    seed: int = 0,
    device=None,
) -> torch.Tensor:
    """Learn per-subspace codebooks [M, kc, dsub] f32 on ``device`` (the
    sample's own device when None). Init is a distinct-row draw shared by
    every subspace; subspaces train one at a time, so the footprint is one
    [S, kc] assignment temp."""
    x_all = torch.as_tensor(sample32, dtype=torch.float32, device=device)
    disable_tf32()
    s, dim = x_all.shape
    dsub = dim // m
    gen = torch.Generator(device=x_all.device)
    gen.manual_seed(seed)
    # distinct init rows (with replacement only when S < kc, which the
    # index's minimum-size gate prevents)
    idx = torch.randperm(s, generator=gen, device=x_all.device)[:kc]
    idx = idx[torch.arange(kc, device=x_all.device) % idx.shape[0]]
    x = x_all.reshape(s, m, dsub)
    return torch.stack(
        [
            _kmeans_subspace(x[:, j].contiguous(), x[idx, j], gen, iters=iters)
            for j in range(m)
        ]
    )


def codebooks_from_reference(codebooks: np.ndarray, *, device) -> torch.Tensor:
    """The JAX package's trained ``[M, kc, dsub]`` codebooks (as numpy)
    as the port's f32 tensor on ``device``: the learned state carried
    across, so both packages encode with the same centroids."""
    cb = np.asarray(codebooks)
    if cb.ndim != 3:
        raise ValueError(f"codebooks must be [M, kc, dsub], got {cb.shape}")
    return torch.from_numpy(np.array(cb, dtype=np.float32, order="C")).to(device)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """[N, M] 4-bit codes (0..15) -> [N, M/2] bytes: byte j holds code 2j
    in the high nibble and 2j+1 in the low one. M must be even."""
    codes = codes.to(torch.uint8)
    return (codes[:, 0::2] << 4) | codes[:, 1::2]


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """[N, M/2] packed bytes -> [N, M] codes; inverse of pack_nibbles."""
    return torch.stack([packed >> 4, packed & 0xF], dim=2).reshape(
        packed.shape[0], -1
    )


def encode_rows(codebooks: torch.Tensor, rows32: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid codes: rows [N, D] f32 -> uint8 [N, M], one
    subspace at a time (one [N, kc] distance temp). Callers chunk N."""
    disable_tf32()
    n = rows32.shape[0]
    m, _kc, dsub = codebooks.shape
    x = rows32.to(torch.float32).reshape(n, m, dsub)
    out = torch.empty((n, m), dtype=torch.uint8, device=rows32.device)
    for j in range(m):
        xs = x[:, j]
        cs = codebooks[j]
        d2 = (
            torch.sum(xs * xs, dim=1)[:, None]
            - 2.0 * (xs @ cs.T)
            + torch.sum(cs * cs, dim=1)[None, :]
        )
        out[:, j] = torch.argmin(d2, dim=1).to(torch.uint8)
    return out


def _adc_lut(queries, codebooks, metric):
    """Per-query lookup tables [B, M, kc] f32: dot tables for the matmul
    metrics, |q - c| L1 tables for manhattan."""
    b = queries.shape[0]
    m, _kc, dsub = codebooks.shape
    q = queries.reshape(b, m, dsub)
    if metric is SimilarityMetric.MANHATTAN:
        return torch.sum(torch.abs(q[:, :, None, :] - codebooks[None]), dim=-1)
    disable_tf32()
    return torch.einsum("bmd,mcd->bmc", q, codebooks)


def _rank_surrogate(adc, metric, sq):
    """Monotonic selection surrogate on the ADC dot; ``sq`` is [1, N].
    Manhattan passes through: its sign is in the bf16 LUT already."""
    if metric is SimilarityMetric.COSINE:
        return adc * torch.rsqrt(torch.clamp(sq, min=1e-30))
    if metric is SimilarityMetric.EUCLIDEAN:
        return adc - 0.5 * sq
    return adc


def selection_lut(lut: torch.Tensor, metric) -> torch.Tensor:
    """The [B, M, kc] bf16 LUT that K5 ranks with: the f32 LUT rounded to
    bf16, negated first for manhattan so selection is a max either way."""
    if metric is SimilarityMetric.MANHATTAN:
        lut = -lut
    return lut.to(torch.bfloat16).contiguous()


# ------------------------------------------------------------------- K5


def pq_rank_plain(lut_sel, codes, sqnorms, valid, *, metric, packed):
    """Plain version of K5: [B, N] f32 selection rank. ``lut_sel`` is the
    [B, M, kc] bf16 LUT (negated for manhattan); each row's sum of its
    codes' LUT entries is a product with the row's one-hot in f32 (exact
    products of bf16 values by 0/1, f32 sums), built a slab of rows at a
    time."""
    disable_tf32()
    b, m, kc = lut_sel.shape
    n = codes.shape[0]
    lut = lut_sel.to(torch.float32).reshape(b, m * kc)
    iota = torch.arange(kc, device=codes.device, dtype=torch.int16)
    adc = torch.empty((b, n), dtype=torch.float32, device=codes.device)
    slab = max(1, _PLAIN_ONEHOT_BYTES // (4 * m * kc))
    for lo in range(0, n, slab):
        u = codes[lo : lo + slab]
        u = (unpack_nibbles(u) if packed else u).to(torch.int16)
        oh = (u[:, :, None] == iota).to(torch.float32).reshape(u.shape[0], m * kc)
        adc[:, lo : lo + u.shape[0]] = lut @ oh.T
    rank = _rank_surrogate(adc, metric, sqnorms[None, :])
    return torch.where(valid[None, :], rank, NEG_INF)


def mma_query_tile(b: int) -> int:
    """Queries a tile of the tensor-core entry: the least power of two from
    8 to 256 that holds ``b``, else 256 (the batch then takes several
    tiles)."""
    nt = 8
    while nt < min(b, _MMA_MAX_TILE):
        nt *= 2
    return nt


def mma_fits(b: int, ms: int) -> bool:
    """Whether a tile of the tensor-core entry fits a block's shared memory
    for a batch of ``b`` and ``ms`` code bytes a row: the tile's codes
    beside two LUT stages (the rest of the ring is sized to what fits)."""
    nt = mma_query_tile(b)
    ring = 2 * _MMA_GROUP * nt * 32
    a_tiles = -(-(ring + _MMA_ROWS * ms) // 128) * 128 + 2 * 2 * _MMA_GROUP * 64 * 16 * 2
    staging = nt * (_MMA_ROWS + 4) * 4  # the epilogue's [query][row] tile
    need = -(-max(a_tiles, staging) // 16) * 16 + 2 * 2 * 8  # + barriers
    return need <= _SMEM_MAX


def mma_lut_operand(lut_sel: torch.Tensor, nt: int) -> torch.Tensor:
    """The [B, M, 16] bf16 LUT as the tensor-core entry streams it:
    ``[ceil(B / nt), M, nt / 8, 2, 8, 8]`` (query tile, subspace, group of 8
    queries, half of the 16 codes, query, code), zero past B. One
    subspace's slice of a tile is then one contiguous run of nt x 32 bytes
    in wgmma's core-matrix order (8 queries x 8 codes, the two code halves
    128 bytes apart, the query groups 256 bytes apart)."""
    b, m, kc = lut_sel.shape
    qt = -(-b // nt)
    if qt * nt != b:
        lut_sel = torch.cat([lut_sel, lut_sel.new_zeros((qt * nt - b, m, kc))])
    return (
        lut_sel.reshape(qt, nt // 8, 8, m, 2, kc // 2)
        .permute(0, 3, 1, 4, 2, 5)
        .contiguous()
    )


def lookup_query_tile(lib=None) -> int:
    """Queries a tile of the look-up entry ``pq_rank`` (8 x its lanes a
    row), as ``csrc/pq.cu`` was built: read from the library (``lib``, by
    default the package's own), so the width is decided in the source
    alone."""
    fn = (_build.load("pq") if lib is None else lib).pq_rank_queries
    fn.restype = ctypes.c_int
    return fn()


def lookup_lut_operand(lut_sel: torch.Tensor, packed: bool, q: int) -> torch.Tensor:
    """The [B, M, kc] bf16 LUT as the look-up entry stages it, per query
    tile of ``q`` queries (``lookup_query_tile``; a multiple of 8):
    ``[ceil(B / q), m_pad, T, q]`` (query tile, subspace, table row,
    query), T = 16 for packed 4-bit codes and 256 otherwise, m_pad = M
    rounded up to a stage (8 subspaces packed, 4 unpacked), zero past B, M
    and kc: a code at or above kc reads zeros. One (subspace, code) entry
    of a tile is then 2 q contiguous bytes, and a stage's subspaces one
    contiguous run."""
    b, m, kc = lut_sel.shape
    rows = 16 if packed else 256
    group = 8 if packed else 4
    qt = -(-b // q)
    m_pad = -(-m // group) * group
    out = lut_sel.new_zeros((qt * q, m_pad, rows))
    out[:b, :m, :kc] = lut_sel
    return out.view(qt, q, m_pad, rows).permute(0, 2, 3, 1).contiguous()


def _check_rank_operands(lut_sel, codes, sqnorms, valid, packed):
    """Type, shape and layout of K5's operands; returns kc."""
    dev = codes.device
    if codes.dtype != torch.uint8 or codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous [N, ms] uint8 tensor")
    n, ms = codes.shape
    if (
        lut_sel.device != dev
        or lut_sel.dtype != torch.bfloat16
        or lut_sel.dim() != 3
        or not lut_sel.is_contiguous()
    ):
        raise ValueError(f"the LUT must be a contiguous [B, M, kc] bf16 tensor on {dev}")
    b, m, kc = lut_sel.shape
    if packed and (kc != 16 or m != 2 * ms):
        raise ValueError(f"packed codes need kc = 16 and M = 2 * {ms}")
    if not packed and (m != ms or kc > 256):
        raise ValueError(f"unpacked codes need M = {ms} and kc <= 256")
    if n >= 1 << 31:
        raise ValueError("the kernel indexes rows with 32-bit integers")
    for name, t, dtype in (("sqnorms", sqnorms, torch.float32), ("valid", valid, torch.bool)):
        if t.device != dev or t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{n}] {dtype} tensor on {dev}")
    return kc


def launch_rank_mma(lut_sel, codes, sqnorms, valid, *, metric, packed):
    """Launch the tensor-core entry ``pq_rank_mma`` (kc = 16) on operands
    ``pq_rank_cuda`` has checked."""
    n, ms = codes.shape
    b, m, _kc = lut_sel.shape
    dev = codes.device
    nt = mma_query_tile(b)
    lut_t = mma_lut_operand(lut_sel, nt)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        PQ_RANK_MMA.launch(
            lut_t.data_ptr(), codes.data_ptr(), sqnorms.data_ptr(),
            valid.data_ptr(), out.data_ptr(), n, b, m, ms, int(packed),
            _METRIC_CODE[metric], nt, torch.cuda.current_stream(dev).cuda_stream,
        )
    return out


def launch_rank_lookup(lut_sel, codes, sqnorms, valid, *, metric, packed):
    """Launch the look-up entry ``pq_rank`` (any kc) on operands
    ``pq_rank_cuda`` has checked."""
    n, ms = codes.shape
    b = lut_sel.shape[0]
    dev = codes.device
    lut_t = lookup_lut_operand(lut_sel, packed, lookup_query_tile())
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        PQ_RANK.launch(
            lut_t.data_ptr(), codes.data_ptr(), sqnorms.data_ptr(),
            valid.data_ptr(), out.data_ptr(), n, b, lut_t.shape[1], ms, int(packed),
            _METRIC_CODE[metric], torch.cuda.current_stream(dev).cuda_stream,
        )
    return out


def pq_rank_cuda(lut_sel, codes, sqnorms, valid, *, metric, packed):
    """K5 on the card: same output as ``pq_rank_plain``. kc = 16 (the
    4-bit profile, packed or unpacked) runs the tensor-core entry, unless a
    tile's codes are too wide for its shared memory (``mma_fits``: at a
    batch of 256, more than ~1,040 code bytes a row); any other kc, and
    those, the look-up entry."""
    if not codes.is_cuda:
        raise ValueError(f"no kernel for tensors on {codes.device}")
    kc = _check_rank_operands(lut_sel, codes, sqnorms, valid, packed)
    if kc == MMA_KC and mma_fits(lut_sel.shape[0], codes.shape[1]):
        return launch_rank_mma(lut_sel, codes, sqnorms, valid, metric=metric, packed=packed)
    return launch_rank_lookup(lut_sel, codes, sqnorms, valid, metric=metric, packed=packed)


def pq_rank(lut_sel, codes, sqnorms, valid, *, metric, packed):
    """[B, N] selection rank: the plain version on CPU tensors; otherwise
    K5, which raises on anything but a CUDA tensor."""
    if codes.device.type == "cpu":
        return pq_rank_plain(lut_sel, codes, sqnorms, valid, metric=metric, packed=packed)
    return pq_rank_cuda(lut_sel, codes, sqnorms, valid, metric=metric, packed=packed)


# ------------------------------------------------------------- selection


def select_topk(rank: torch.Tensor, k: int):
    """Exact top ``k`` of each row of ``rank`` [B, C], ties to the LOWEST
    column: (scores [B, k], columns [B, k] int64 in ascending column
    order). ``torch.topk`` gives the k-th value; every larger entry is
    kept, and the entries equal to it fill the rest in column order (the
    running count of ties is taken only when some row has more than it
    needs)."""
    b = rank.shape[0]
    kth = torch.topk(rank, k, dim=1, sorted=False).values.amin(dim=1, keepdim=True)
    keep = rank >= kth
    if bool(torch.any(torch.sum(keep, dim=1) != k)):
        above = rank > kth
        need = k - torch.sum(above, dim=1, keepdim=True)
        tie = rank == kth
        keep = above | (tie & (torch.cumsum(tie, dim=1, dtype=torch.int32) <= need))
    cols = torch.nonzero(keep)[:, 1].reshape(b, k)
    return torch.gather(rank, 1, cols), cols


def pq_search_topk(
    codes: torch.Tensor,  # [cap, M] uint8 (or [cap, M/2] when packed)
    codebooks: torch.Tensor,  # [M, kc, dsub] f32
    sqnorms: torch.Tensor,  # [cap] f32 exact row squared norms
    valid: torch.Tensor,  # [cap] bool
    queries: torch.Tensor,  # [B, D] f32
    *,
    metric: SimilarityMetric,
    k: int,
    chunk: int = 65536,
    packed: bool = False,
):
    """ADC top-k: (scores [B, k] f32, slots [B, k] int64).

    Per chunk, the bf16-LUT selection rank (``pq_rank``: K5 on the card)
    and its top k + 32; the merged top k + 32; then an exact-f32 ADC
    re-score of that pool, sorted by slot so equal scores keep the lowest
    slot. Returned scores are f32 ADC values; invalid slots are -inf, and
    columns beyond the capacity are padded with -inf."""
    b = queries.shape[0]
    m, kc, _dsub = codebooks.shape
    cap = codes.shape[0]
    # a chunk narrower than k would silently drop true winners
    chunk = min(max(chunk, k), cap)
    n_chunks = -(-cap // chunk)
    pad = n_chunks * chunk - cap
    if pad:
        codes = torch.cat([codes, codes.new_zeros((pad, codes.shape[1]))])
        sqnorms = torch.cat([sqnorms, sqnorms.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    queries = queries.to(torch.float32)
    lut = _adc_lut(queries, codebooks, metric)  # [B, M, kc] f32
    lut_sel = selection_lut(lut, metric)
    k_chunk = min(chunk, k + _EXACT_MARGIN)

    pool_s, pool_i = [], []
    for c in range(n_chunks):
        lo = c * chunk
        rank = pq_rank(
            lut_sel, codes[lo : lo + chunk], sqnorms[lo : lo + chunk],
            valid[lo : lo + chunk], metric=metric, packed=packed,
        )
        s, i = select_topk(rank, k_chunk)
        del rank
        pool_s.append(s)
        pool_i.append(i + lo)
    # chunk-major and ascending within a chunk: ascending slots, so the
    # stable merge keeps the lowest slot among equal surrogates
    pool_s = torch.cat(pool_s, dim=1)
    pool_i = torch.cat(pool_i, dim=1)
    p0 = min(pool_s.shape[1], k + _EXACT_MARGIN)
    if pool_s.shape[1] > p0:
        _, pos = stable_topk(pool_s, p0)
        pool_i = torch.gather(pool_i, 1, pos)

    # exact-f32 ADC stage over the slot-sorted pool
    pool_i = torch.sort(pool_i, dim=1).values
    u = codes[pool_i.reshape(-1)]
    u = (unpack_nibbles(u) if packed else u).to(torch.int64)
    u = u.reshape(b, p0, m)
    adc = torch.gather(
        lut[:, None, :, :].expand(b, p0, m, kc), 3, u[..., None]
    ).sum(dim=(2, 3))  # [B, P] f32 ADC dot (L1 distance for manhattan)
    sq_cand = sqnorms[pool_i]
    qsq = torch.sum(queries * queries, dim=1, keepdim=True)
    if metric is SimilarityMetric.DOT_PRODUCT:
        exact = adc
    elif metric is SimilarityMetric.COSINE:
        denom = torch.sqrt(qsq) * torch.sqrt(sq_cand)
        exact = torch.where(
            denom > 0.0, adc / torch.clamp(denom, min=1e-30), torch.zeros_like(adc)
        )
    elif metric is SimilarityMetric.EUCLIDEAN:
        d2 = torch.clamp(qsq - 2.0 * adc + sq_cand, min=0.0)
        exact = 1.0 / (1.0 + torch.sqrt(d2))
    else:
        exact = 1.0 / (1.0 + adc)
    exact = torch.where(valid[pool_i], exact, NEG_INF)
    s_top, pos = stable_topk(exact, min(k, p0))
    i_top = torch.gather(pool_i, 1, pos)
    if s_top.shape[1] < k:  # capacity below k after the clamp
        padw = k - s_top.shape[1]
        s_top = torch.nn.functional.pad(s_top, (0, padw), value=NEG_INF)
        i_top = torch.nn.functional.pad(i_top, (0, padw))
    return s_top, i_top

