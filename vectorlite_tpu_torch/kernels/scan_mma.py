"""Host side of the tensor-core scan body (``csrc/scan_mma.cuh``): the
split of f32 queries into bf16, int8 or tf32 terms and the query operand in
the order the kernel's wgmma reads it. Plain torch, on the queries' device.

Against bf16 rows: an f32 value has 24 significant bits and a bf16 value
8, so three bf16 terms ``h = bf16(q)``, ``m = bf16(q - h)``, ``l = bf16(q -
h - m)`` hold every bit of a normal f32 value: ``h + m + l == q`` exactly
(as values: a -0 query comes back +0, which no dot product tells apart).
Each term times a bf16 row element is exact in f32, so three bf16 passes
summed in f32 give the f32 dot of the plain version up to the order of the
additions.

Against int8 rows: three int8 terms with scales per query, ``q ~ s1 t1 +
s2 t2 + s3 t3`` with s1 = max|q| / 127 (as an f32 value), ``s2 = s1 /
254``, ``s3 = s2 / 254``, each term rounded to nearest in [-127, 127]: a
term's rounding error is at most half its scale, which the next term's
full range covers, and what is left is at most ``s3 / 2 = s1 / 129,032``
(about max|q| 2^-24) an element, the precision of the f32 query itself.
Each term's dot with an int8 row is an exact integer (s32 on the tensor
cores), so the three passes lose only that residual and the f32 roundings
of the epilogue (the kernel's header states the tolerance that follows).
Scales stepping by 128 (powers of two, the terms at most 64 past the
first) leave s1 2^-15, ~1.4e-5 (rms) on the dots of N(0, 1) queries and
rows at D = 384: more than the plain f32 product's own error and than the
1e-5 rule allows a score near 0.

Against f32 rows (3xTF32): two tf32 terms ``hi = rna(q)``, ``lo = rna(q -
hi)`` (``round_tf32``: round to nearest, ties away from zero, to 10
mantissa bits, the low 13 bits zero), so ``|q - hi| <= 2^-11 |q|`` and
``|q - hi - lo| <= 2^-22 |q|``; the kernel splits the rows the same way and
sums hi.hi, hi.lo and lo.hi (the header states the bound that follows).
"""

from __future__ import annotations

import torch

#: queries a block of the body (the wgmma's N) and bytes of a query row a
#: slice holds (one 128-byte row of the 128-byte swizzle: 64 bf16, 128
#: int8 or 32 f32 columns)
QUERIES = 64
SLICE_BYTES = 128
TERMS = 3

#: the ratio of one int8 term's scale to the next (csrc/scan_mma.cuh)
INT8_STEP = 254


def split_query_terms(queries: torch.Tensor) -> torch.Tensor:
    """[3, B, D] bf16 terms (h, m, l) of f32 queries [B, D]: h + m + l
    equals the queries exactly in f32, in that order of addition."""
    q = queries.to(torch.float32)
    h = q.to(torch.bfloat16)
    r = q - h.to(torch.float32)
    m = r.to(torch.bfloat16)
    low = (r - m.to(torch.float32)).to(torch.bfloat16)
    return torch.stack((h, m, low))


def split_query_int8(queries: torch.Tensor):
    """([3, B, D] int8 terms t1, t2, t3, [B] f32 scales s1) of f32 queries
    [B, D]: ``|q - s1 (t1 + t2 / 254 + t3 / 254^2)|`` is at most ``s1 /
    (2 254^2)`` an element, s1 = max|q| / 127 of the query rounded to f32
    (1 for a zero query; a query below the f32 normal range times 127
    loses bits in s1). Worked in float64 on the f32 scale."""
    q = queries.to(torch.float32).to(torch.float64)
    amax = q.abs().amax(dim=1)
    s1 = (amax / 127.0).to(torch.float32).to(torch.float64)
    s1 = torch.where(s1 > 0, s1, torch.ones_like(s1))
    terms = []
    r = q
    for t in range(TERMS):
        s = s1[:, None] / float(INT8_STEP) ** t
        term = torch.clamp(torch.round(r / s), -127, 127)
        r = r - term * s
        terms.append(term)
    return torch.stack(terms).to(torch.int8), s1.to(torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to tf32 (nearest, ties away from zero: what
    cvt.rna.tf32.f32 gives), as f32 values with the low 13 bits zero: the
    kernel's integer form of the rounding, bit for bit."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_query_tf32(queries: torch.Tensor) -> torch.Tensor:
    """[2, B, D] f32 tf32 terms (hi, lo) of f32 queries [B, D]: hi =
    round_tf32(q), lo = round_tf32(q - hi); q - hi is exact in f32, and
    ``|q - hi - lo| <= 2^-22 |q|``."""
    q = queries.to(torch.float32)
    hi = round_tf32(q)
    return torch.stack((hi, round_tf32(q - hi)))


def _swizzled(terms: torch.Tensor) -> torch.Tensor:
    """[T, B, D] terms as [ceil(B/64), S, T, 64, 128 bytes / itemsize]: block
    j's slice s term t is the [64 queries, 128 bytes] tile of term t, zero
    past B and D, each query's 128-byte row with its 16-byte chunk c stored
    at chunk c ^ (query mod 8)."""
    n_terms, b, d = terms.shape
    cols = SLICE_BYTES // terms.element_size()
    per = 16 // terms.element_size()  # elements a 16-byte chunk
    nb = -(-b // QUERIES)
    ns = -(-d // cols)
    x = terms.new_zeros((n_terms, nb * QUERIES, ns * cols))
    x[:, :b, :d] = terms
    # term, block, query, slice, chunk, element -> block, slice, term, query, chunk, element
    x = x.view(n_terms, nb, QUERIES, ns, 8, per).permute(1, 3, 0, 2, 4, 5)
    r = torch.arange(QUERIES, device=terms.device)
    src = torch.arange(8, device=terms.device)[None, :] ^ (r[:, None] % 8)  # [64, 8]
    idx = src[:, :, None].expand(QUERIES, 8, per).expand(nb, ns, n_terms, QUERIES, 8, per)
    return torch.gather(x, 4, idx).reshape(nb, ns, n_terms, QUERIES, cols).contiguous()


def query_operand(queries: torch.Tensor) -> torch.Tensor:
    """The body's query operand against bf16 rows: [ceil(B/64),
    ceil(D/64), 3, 64, 64] bf16, contiguous. Block j's slice s term t is the
    [64 queries, 64 columns] tile of term t, zero past B and D, each
    query's 128-byte row with its 16-byte chunk c stored at chunk c ^
    (query mod 8): the order a TMA copy with the 128-byte swizzle gives,
    which the wgmma's descriptor reads. A block's terms are one contiguous
    run (one bulk copy), a slice's three terms too (the streamed form)."""
    return _swizzled(split_query_terms(queries))


def query_operand_int8(queries: torch.Tensor):
    """The body's query operand against int8 rows: ([ceil(B/64),
    ceil(D/128), 3, 64, 128] int8 in ``query_operand``'s swizzled order, the
    [B] f32 term scales s1)."""
    terms, scales = split_query_int8(queries)
    return _swizzled(terms), scales


def query_operand_tf32(queries: torch.Tensor) -> torch.Tensor:
    """The body's query operand against f32 rows: [ceil(B/64), ceil(D/32),
    2, 64, 32] f32 in ``query_operand``'s swizzled order, the terms of
    ``split_query_tf32``."""
    return _swizzled(split_query_tf32(queries))


def max_tile_rows(winners: int) -> int:
    """Rows a tile of a list mode may hold: a list names its W rows by
    chunk indices packed in one 32-bit word, 32 // W bits each (no limit
    at W 1 below the 2^31 rows the kernels index)."""
    return 128 << (32 // winners) if winners > 1 else 1 << 31


def list_tile(tile_n: int, winners: int) -> int:
    """The tile a list-mode launch walks: ``tile_n`` itself up to
    ``max_tile_rows``, else its largest divisor in 128-row chunks below
    that (for K7 the tile only splits the rows among blocks)."""
    chunks = tile_n // 128
    parts = -(-chunks // (max_tile_rows(winners) // 128))
    while chunks % parts:
        parts += 1
    return tile_n // parts
