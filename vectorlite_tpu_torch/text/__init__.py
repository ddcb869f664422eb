"""Sparse text retrieval (BM25) + hybrid fusion — extension over the
reference, which serves dense embedding search only."""

from .bm25 import BM25Index, tokenize

__all__ = ["BM25Index", "tokenize"]
