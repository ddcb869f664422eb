"""Host side of the tensor-core scan body (``csrc/scan_mma.cuh``): the
split of f32 queries into bf16 terms and the query operand in the order
the kernel's wgmma reads it. Plain torch, on the queries' device.

An f32 value has 24 significant bits and a bf16 value 8, so three bf16
terms ``h = bf16(q)``, ``m = bf16(q - h)``, ``l = bf16(q - h - m)`` hold
every bit of a normal f32 value: ``h + m + l == q`` exactly (as values: a
-0 query comes back +0, which no dot product tells apart). Each term times
a bf16 row element is exact in f32, so three bf16 passes summed in f32
give the f32 dot of the plain version up to the order of the additions.
"""

from __future__ import annotations

import torch

#: queries a block of the body (the wgmma's N) and columns a slice (one
#: 128-byte row of the 128-byte swizzle)
QUERIES = 64
SLICE = 64
TERMS = 3
def split_query_terms(queries: torch.Tensor) -> torch.Tensor:
    """[3, B, D] bf16 terms (h, m, l) of f32 queries [B, D]: h + m + l
    equals the queries exactly in f32, in that order of addition."""
    q = queries.to(torch.float32)
    h = q.to(torch.bfloat16)
    r = q - h.to(torch.float32)
    m = r.to(torch.bfloat16)
    low = (r - m.to(torch.float32)).to(torch.bfloat16)
    return torch.stack((h, m, low))


def query_operand(queries: torch.Tensor) -> torch.Tensor:
    """The body's query operand: [ceil(B/64), ceil(D/64), 3, 64, 64] bf16,
    contiguous. Block j's slice s term t is the [64 queries, 64 columns]
    tile of term t, zero past B and D, each query's 128-byte row with its
    16-byte chunk c stored at chunk c ^ (query mod 8): the order a TMA copy
    with the 128-byte swizzle gives, which the wgmma's descriptor reads. A
    block's terms are one contiguous run (one bulk copy), a slice's three
    terms too (the streamed form)."""
    terms = split_query_terms(queries)
    _, b, d = terms.shape
    nb = -(-b // QUERIES)
    ns = -(-d // SLICE)
    x = torch.zeros((TERMS, nb * QUERIES, ns * SLICE), dtype=torch.bfloat16,
                    device=queries.device)
    x[:, :b, :d] = terms
    # term, block, query, slice, chunk, element -> block, slice, term, query, chunk, element
    x = x.view(TERMS, nb, QUERIES, ns, 8, 8).permute(1, 3, 0, 2, 4, 5)
    r = torch.arange(QUERIES, device=queries.device)
    src = torch.arange(8, device=queries.device)[None, :] ^ (r[:, None] % 8)  # [64, 8]
    idx = src[:, :, None].expand(QUERIES, 8, 8).expand(nb, ns, TERMS, QUERIES, 8, 8)
    return torch.gather(x, 4, idx).reshape(nb, ns, TERMS, QUERIES, SLICE).contiguous()


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
