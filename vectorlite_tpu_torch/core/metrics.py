"""Similarity metrics: scalar parity math and batched device scoring.

The reference defines four similarity metrics (higher = more similar):
cosine in [-1, 1]; euclidean and manhattan distances mapped through
``1 / (1 + d)``; and raw dot product (reference: src/lib.rs:363-572).

Two tiers live here:

* **Scalar parity functions** (`cosine_similarity`, ...) — float64 numpy,
  bit-comparable with the reference formulas, used for tests, tiny inputs,
  and the persistence layer.
* **Batched device scoring** (`batched_scores`) — a ``[B, N]`` similarity
  matrix in torch for a ``[B, D]`` query batch against an ``[N, D]``
  corpus, on whatever device the tensors live on. Cosine/dot/euclidean
  are one matmul (euclidean uses the ``|x-y|^2 = |x|^2 + |y|^2 - 2xy``
  expansion); manhattan is an elementwise reduce tiled over N chunks to
  bound memory (its fused kernel is K4, kernels/scan.py).

Float32 products run in full f32: the reference contracts at
``Precision.HIGHEST``, so TF32 is switched off before any f32 matmul here
(``disable_tf32``).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..errors import InvalidSimilarityMetric


class SimilarityMetric(enum.Enum):
    """Reference: src/lib.rs:363-378. Default is Cosine."""

    COSINE = "Cosine"
    EUCLIDEAN = "Euclidean"
    MANHATTAN = "Manhattan"
    DOT_PRODUCT = "DotProduct"

    @classmethod
    def default(cls) -> "SimilarityMetric":
        return cls.COSINE

    @classmethod
    def parse(cls, s: str) -> "SimilarityMetric":
        """Case-insensitive parse (reference: src/server.rs:157-165)."""
        table = {
            "cosine": cls.COSINE,
            "euclidean": cls.EUCLIDEAN,
            "manhattan": cls.MANHATTAN,
            "dotproduct": cls.DOT_PRODUCT,
        }
        m = table.get(s.lower())
        if m is None:
            raise InvalidSimilarityMetric(s)
        return m

    @classmethod
    def from_serde(cls, s: str) -> "SimilarityMetric":
        """Parse the serde-serialized variant name, e.g. "Cosine"."""
        for m in cls:
            if m.value == s:
                return m
        raise InvalidSimilarityMetric(s)

    def variant_name(self) -> str:
        """Rust Debug / serde name, e.g. "Cosine"."""
        return self.value

    def calculate(self, a, b) -> float:
        """Scalar similarity between two vectors (reference: src/lib.rs:380-391)."""
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        assert a.shape == b.shape, "Vectors must have the same length"
        if self is SimilarityMetric.COSINE:
            return cosine_similarity(a, b)
        if self is SimilarityMetric.EUCLIDEAN:
            return euclidean_similarity(a, b)
        if self is SimilarityMetric.MANHATTAN:
            return manhattan_similarity(a, b)
        return dot_product(a, b)


def cosine_similarity(a, b) -> float:
    """Cosine similarity; zero-norm inputs yield 0.0 (reference: src/lib.rs:425-444)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, "Vectors must have the same length"
    dot = float(np.dot(a, b))
    norm_a = float(np.sqrt(np.dot(a, a)))
    norm_b = float(np.sqrt(np.dot(b, b)))
    if norm_a == 0.0 or norm_b == 0.0:
        return 0.0
    return dot / (norm_a * norm_b)


def euclidean_similarity(a, b) -> float:
    """1 / (1 + L2-distance) in [0, 1] (reference: src/lib.rs:476-489)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, "Vectors must have the same length"
    d = float(np.sqrt(np.sum((a - b) ** 2)))
    return 1.0 / (1.0 + d)


def manhattan_similarity(a, b) -> float:
    """1 / (1 + L1-distance) in [0, 1] (reference: src/lib.rs:521-532)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, "Vectors must have the same length"
    d = float(np.sum(np.abs(a - b)))
    return 1.0 / (1.0 + d)


def dot_product(a, b) -> float:
    """Raw dot product, unbounded (reference: src/lib.rs:565-572)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, "Vectors must have the same length"
    return float(np.dot(a, b))


# ---------------------------------------------------------------------------
# Batched device scoring.
# ---------------------------------------------------------------------------

# Per-step memory budget for the tiled manhattan reduce ([B, chunk, D] f32).
_MANHATTAN_TILE_BYTES = 64 * 1024 * 1024


def disable_tf32() -> None:
    """Exact paths contract in full f32 (the reference's
    ``Precision.HIGHEST``): TF32 keeps ~3 decimal digits, enough to
    reorder near-tied neighbours. Both switches are process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _manhattan_chunk(n: int, b: int, d: int) -> int:
    chunk = max(1, _MANHATTAN_TILE_BYTES // (4 * b * d))
    # round down to a power of two so it divides power-of-two capacities
    chunk = 1 << (chunk.bit_length() - 1)
    return min(chunk, n)


def l1_scores(queries: torch.Tensor, rows_f32, n: int) -> torch.Tensor:
    """1/(1+L1) of every query against ``rows_f32(lo, hi)`` chunks."""
    b, d = queries.shape
    chunk = _manhattan_chunk(n, b, d)
    out = torch.empty((b, n), dtype=torch.float32, device=queries.device)
    for lo in range(0, n, chunk):
        v = rows_f32(lo, min(n, lo + chunk))
        out[:, lo : lo + v.shape[0]] = (
            (queries[:, None, :] - v[None, :, :]).abs().sum(-1)
        )
    return 1.0 / (1.0 + out)


def metric_from_dot(
    dot: torch.Tensor,  # [B, N] f32
    qsq: torch.Tensor,  # [B, 1] f32 query squared norms
    sqnorms: torch.Tensor,  # [N] or [B, N] f32 row squared norms
    metric: SimilarityMetric,
) -> torch.Tensor:
    """The matmul-form metrics from raw dots, with the reference's edge
    rules: cosine is 0 when the norm product is <= 0; euclidean clamps
    the expanded squared distance at 0 against f32 cancellation."""
    if metric is SimilarityMetric.DOT_PRODUCT:
        return dot
    if metric is SimilarityMetric.COSINE:
        denom = torch.sqrt(qsq) * torch.sqrt(sqnorms)
        return torch.where(
            denom > 0.0,
            dot / torch.clamp(denom, min=1e-30),
            torch.zeros((), dtype=dot.dtype, device=dot.device),
        )
    if metric is SimilarityMetric.EUCLIDEAN:
        d_sq = torch.clamp(qsq + sqnorms - 2.0 * dot, min=0.0)
        return 1.0 / (1.0 + torch.sqrt(d_sq))
    raise NotImplementedError("manhattan has no matmul form")


def batched_scores(
    values: torch.Tensor,  # [N, D]
    sqnorms: torch.Tensor,  # [N] cached squared L2 norms of `values` rows
    queries: torch.Tensor,  # [B, D]
    metric: SimilarityMetric,
) -> torch.Tensor:  # [B, N] float32 similarities
    """Similarity of every query against every corpus row.

    `sqnorms` is maintained incrementally by the index so cosine/euclidean
    need only a single [B,D]x[D,N] matmul over the corpus.
    """
    queries = queries.to(torch.float32)
    n = values.shape[0]
    if metric is SimilarityMetric.MANHATTAN:
        return l1_scores(
            queries, lambda lo, hi: values[lo:hi].to(torch.float32), n
        )
    disable_tf32()
    if values.dtype == torch.bfloat16:
        # bf16 corpus: bf16 inputs, f32 accumulation (the reference's
        # preferred_element_type=f32). Each bf16 x bf16 product is exact
        # in f32, so casting both operands up reproduces it.
        q = queries.to(torch.bfloat16).to(torch.float32)
    else:
        q = queries
    dot = q @ values.to(torch.float32).T  # [B, N]
    qsq = torch.sum(queries * queries, dim=-1, keepdim=True)
    return metric_from_dot(dot, qsq, sqnorms[None, :], metric)


# ---------------------------------------------------------------------------
# int8 quantized scoring (the "quantized" profile): corpus rows stored as
# symmetric per-row int8 (scale = max|x| / 127). Rows are cast to f32 for
# the contraction (queries stay f32), and cosine/euclidean reconstruct
# with the EXACT cached norms, so only the cross-term is approximate.
# Callers re-score the k winners exactly on the host (index/flat.py).
# ---------------------------------------------------------------------------


def quantize_rows_int8(
    rows: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, D] float -> (int8 values [N, D], f32 scales [N]).

    Rounding is half-to-even, as numpy's and the reference's."""
    rows = rows.to(torch.float32)
    max_abs = torch.amax(torch.abs(rows), dim=-1)
    scale = torch.where(
        max_abs > 0.0, max_abs / 127.0, torch.ones_like(max_abs)
    )
    q = torch.clamp(torch.round(rows / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def batched_scores_int8(
    values_q: torch.Tensor,  # [N, D] int8
    scales: torch.Tensor,  # [N] f32 per-row scale
    sqnorms: torch.Tensor,  # [N] f32 EXACT squared norms (pre-quantization)
    queries: torch.Tensor,  # [B, D] f32
    metric: SimilarityMetric,
) -> torch.Tensor:  # [B, N] f32 approximate similarities
    queries = queries.to(torch.float32)
    n = values_q.shape[0]
    if metric is SimilarityMetric.MANHATTAN:
        return l1_scores(
            queries,
            lambda lo, hi: values_q[lo:hi].to(torch.float32)
            * scales[lo:hi, None],
            n,
        )
    disable_tf32()
    dot = (queries @ values_q.to(torch.float32).T) * scales[None, :]
    qsq = torch.sum(queries * queries, dim=-1, keepdim=True)
    return metric_from_dot(dot, qsq, sqnorms[None, :], metric)
