"""Incremental BM25 inverted index over collection texts.

Extension: the reference engine (mmailhos/vectorlite) serves dense
embedding search only; production retrieval stacks almost always pair
it with lexical scoring + fusion (hybrid search). This is the host-side
sparse leg — dense scoring stays on the device; the two legs are fused by
reciprocal-rank fusion in ``Collection.search_hybrid``.

Design for a single-core host serving path:

* **Dense docnums.** Every (re)indexed document gets a fresh dense
  docnum; external u64 ids map through a registry. Docnums are never
  reused, so liveness is one growable bool array and per-posting
  liveness checks vectorize (``alive[docnums]``).
* **Columnar postings.** Per term: parallel docnum/tf arrays (python
  append buffers consolidated into numpy lazily, cached until the term
  grows). Scoring a query is a handful of ``np.bincount`` calls over
  the dense docnum space — no per-posting Python loop.
* **Updates.** Re-adding an id kills the old docnum (its postings die
  via the liveness mask) and indexes a new one; deletes just flip the
  bit. Tombstoned postings are skipped at scoring time. Reclaiming
  them needs the original texts, which this structure does not keep —
  ``Collection`` watches ``waste()`` after mutations and drops the
  whole sidecar past a threshold; the next hybrid search lazily
  rebuilds it from the dense index's live texts.

Okapi BM25 with the Lucene non-negative idf:
``idf = ln(1 + (N - df + 0.5)/(df + 0.5))``, k1=1.2, b=0.75; df and
the average document length count live documents only.
"""

from __future__ import annotations

import re
import unicodedata
from collections import Counter
from typing import Callable, Optional

import numpy as np

__all__ = ["BM25Index", "tokenize"]

# unicode word-character runs, underscore excluded — covers Cyrillic,
# Greek, CJK, etc., not just ASCII [a-z0-9]
_TOKEN_RE = re.compile(r"[^\W_]+")
_ASCII_RE = re.compile(r"[a-z0-9]+")
_HAS_NONASCII = re.compile(r"[^\x00-\x7f]")

K1 = 1.2
B = 0.75


def tokenize(text: str) -> list:
    """Word-run tokenizer over any script: casefolded ('Straße' matches
    'strasse'), accent-folded via NFKD-minus-combining-marks ('café'
    matches 'cafe'), tokens are unicode word-character runs (underscore
    excluded). Limitation: scripts written without spaces (CJK) come
    out as whole-run tokens, not words — BM25 still matches exact runs
    but not sub-phrases. Pure-ASCII text (the overwhelmingly common
    case) skips the normalization pass entirely."""
    folded = text.casefold()
    if not _HAS_NONASCII.search(folded):
        return _ASCII_RE.findall(folded)
    decomposed = unicodedata.normalize("NFKD", folded)
    stripped = "".join(
        c for c in decomposed if not unicodedata.combining(c)
    )
    return _TOKEN_RE.findall(stripped)


class _Postings:
    """Columnar postings for one term: append buffer + consolidated
    numpy cache."""

    __slots__ = ("d_buf", "tf_buf", "d_np", "tf_np")

    def __init__(self):
        self.d_buf: list = []
        self.tf_buf: list = []
        self.d_np = None
        self.tf_np = None

    def append(self, docnum: int, tf: int) -> None:
        self.d_buf.append(docnum)
        self.tf_buf.append(tf)
        self.d_np = None  # invalidate the consolidated cache

    def arrays(self):
        if self.d_np is None:
            self.d_np = np.asarray(self.d_buf, dtype=np.int64)
            self.tf_np = np.asarray(self.tf_buf, dtype=np.float64)
        return self.d_np, self.tf_np


class BM25Index:
    """Not thread-safe by itself: callers serialize mutations under the
    collection write lock and searches under the read lock (the same
    discipline every other index structure here follows)."""

    def __init__(self):
        self._post: dict = {}  # term -> _Postings
        self._registry: dict = {}  # external id -> live docnum
        self._doc_id: list = []  # docnum -> external id
        self._doc_terms: list = []  # docnum -> token count (BM25 dl)
        self._alive_buf: list = []  # docnum -> bool (np view below)
        self._alive_np = None
        self._dl_np = None  # consolidated _doc_terms (invalidated on add)
        self._n_live = 0
        self._sum_dl_live = 0.0

    # ----------------------------------------------------------- mutation

    def add(self, id: int, text: str) -> None:
        """Index (or re-index) ``id``. Empty/untokenizable texts still
        register the document so df/N statistics stay consistent with
        the collection."""
        id = int(id)
        old = self._registry.get(id)
        if old is not None:
            self._kill(old)
        tokens = tokenize(text or "")
        docnum = len(self._doc_id)
        self._registry[id] = docnum
        self._doc_id.append(id)
        self._doc_terms.append(len(tokens))
        self._alive_buf.append(True)
        self._alive_np = None
        self._dl_np = None
        self._n_live += 1
        self._sum_dl_live += len(tokens)
        for term, tf in Counter(tokens).items():
            post = self._post.get(term)
            if post is None:
                post = self._post[term] = _Postings()
            post.append(docnum, tf)

    def remove(self, id: int) -> None:
        docnum = self._registry.pop(int(id), None)
        if docnum is not None:
            self._kill(docnum)

    def _kill(self, docnum: int) -> None:
        if self._alive_buf[docnum]:
            self._alive_buf[docnum] = False
            self._alive_np = None
            self._n_live -= 1
            self._sum_dl_live -= self._doc_terms[docnum]

    def clear(self) -> None:
        self.__init__()

    # ------------------------------------------------------------- stats

    def __len__(self) -> int:
        return self._n_live

    def total_docnums(self) -> int:
        """Live + tombstoned docnums — the size per-query arrays scale
        with (Collection's rebuild policy keys off this and waste())."""
        return len(self._doc_id)

    def waste(self) -> float:
        """Fraction of docnums that are tombstones (0 when empty).
        Reclaiming them needs the original texts, which this structure
        does not keep — Collection drops the whole sidecar past a
        waste threshold and lazily rebuilds it from the dense index."""
        total = len(self._doc_id)
        return (total - self._n_live) / total if total else 0.0

    # ------------------------------------------------------------- search

    def _alive(self) -> np.ndarray:
        if self._alive_np is None:
            self._alive_np = np.asarray(self._alive_buf, dtype=bool)
        return self._alive_np

    def search(
        self,
        query: str,
        k: int,
        filter_fn: Optional[Callable[[int], bool]] = None,
    ) -> list:
        """Top-k ``(id, bm25_score)`` for live documents with a
        positive score, best first; ties broken by ascending id (the
        stable-order convention the dense indexes follow).
        ``filter_fn(id)`` drops documents post-scoring (metadata
        ``where`` support)."""
        k = int(k)
        if k <= 0 or self._n_live == 0:
            return []
        q_terms = set(tokenize(query or ""))
        if not q_terms:
            return []
        alive = self._alive()
        n_docnums = len(self._doc_id)
        n = self._n_live
        avgdl = max(self._sum_dl_live / n, 1e-9)
        if self._dl_np is None:
            self._dl_np = np.asarray(self._doc_terms, dtype=np.float64)
        dl = self._dl_np
        scores = np.zeros(n_docnums, dtype=np.float64)
        matched = False
        for term in q_terms:
            post = self._post.get(term)
            if post is None:
                continue
            d, tf = post.arrays()
            m = alive[d]
            if not m.any():
                continue
            d = d[m]
            tf = tf[m]
            df = len(d)  # one posting per (term, docnum) by construction
            idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
            denom = tf + K1 * (1.0 - B + B * dl[d] / avgdl)
            contrib = idf * (tf * (K1 + 1.0)) / denom
            scores += np.bincount(
                d, weights=contrib, minlength=n_docnums
            )
            matched = True
        if not matched:
            return []

        # two-stage selection: argpartition a generous pool, widen to a
        # full sort only if the filter starves it
        def ranked(limit):
            if limit >= n_docnums:
                order = np.argsort(-scores, kind="stable")
            else:
                part = np.argpartition(-scores, limit)[: limit + 1]
                order = part[np.argsort(-scores[part], kind="stable")]
            return order

        out = []
        limit = min(n_docnums, max(4 * k + 64, k))
        while True:
            seen_all = limit >= n_docnums
            out.clear()
            for docnum in ranked(limit):
                s = float(scores[docnum])
                if s <= 0.0:
                    seen_all = True
                    break
                did = self._doc_id[docnum]
                if self._registry.get(did) != docnum:
                    continue  # tombstone
                if filter_fn is not None and not filter_fn(did):
                    continue
                out.append((did, s))
                if len(out) == k:
                    break
            if len(out) == k or seen_all:
                break
            limit = min(n_docnums, limit * 4)
        # argpartition ties are arbitrary: normalize to score desc, id asc
        out.sort(key=lambda t: (-t[1], t[0]))
        return out
