"""Search coalescing: concurrent single-text searches on one collection
merge into one embedder call + one batched index dispatch.

Port of ``vectorlite_tpu/store/coalesce.py``. Every HTTP or SDK search is
one text; on the card a batch of 256 queries costs little more than one
(the scan reads the corpus once for the whole batch), so coalescing turns
N concurrent single-query requests into about 1/N of the device work.

Group-commit pattern: requests enqueue and a lazily started per-collection
dispatcher thread drains whatever is queued *right now* into one batch (no
wait window: a solo request pays only a condition-variable handoff).
Requests arriving while a batch is in flight form the next batch, so batch
size follows the arrival rate.

Semantics equal per-request search: the index implements ``search(q)`` as
``search_batch([q])[0]``, and entries are grouped by (metric, k, where)
before dispatch, so every request sees the rows its own call would return.
A failed batch embed falls back to per-entry embedding so only the
offending text errors. Disable with ``VECTORLITE_COALESCE=0``.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..errors import EmbeddingError, VectorLiteError
from ..observability import coalesce_stats, profile_span

#: Largest single drain; bigger backlogs split across dispatches (the
#: main path's batch of 256).
MAX_BATCH = 256


class _Entry:
    __slots__ = (
        "text", "k", "metric", "embed_fn", "where", "where_key",
        "event", "result", "error",
    )

    def __init__(self, text, k, metric, embed_fn, where, where_key):
        self.text = text
        self.k = k
        self.metric = metric
        self.embed_fn = embed_fn
        self.where = where
        self.where_key = where_key
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.event.set()


class SearchCoalescer:
    """Per-collection request coalescer (see module docstring)."""

    def __init__(self, collection):
        self._collection = collection
        self._cv = threading.Condition()
        self._queue: list[_Entry] = []
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def submit(self, text, k, metric, embedding_function, where=None):
        # filtered requests group by the clause's canonical JSON so
        # same-filter concurrency still shares one dispatch (and one
        # index-side mask-cache entry); callers pre-screen None keys
        where_key = None
        if where is not None:
            from ..core.filter import where_cache_key

            where_key = where_cache_key(where)
        entry = _Entry(
            text, int(k), metric, embedding_function, where, where_key
        )
        with self._cv:
            if self._closed:
                raise RuntimeError("coalescer closed")
            self._queue.append(entry)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop,
                    name=f"vl-coalesce-{self._collection.name}",
                    daemon=True,
                )
                self._thread.start()
            self._cv.notify()
        entry.event.wait()
        if entry.error is not None:
            raise entry.error
        return entry.result

    def close(self) -> None:
        """Stop the dispatcher after draining; pending entries complete.

        Joins the dispatcher thread so no daemon thread is left inside a
        device call when the interpreter tears down."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=30.0)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                batch = self._queue[:MAX_BATCH]
                del self._queue[:MAX_BATCH]
            coalesce_stats.record(len(batch))
            try:
                self._process(batch)
            except BaseException as e:  # noqa: BLE001 - deliver, don't die
                for entry in batch:
                    if not entry.event.is_set():
                        entry.fail(e)

    def _process(self, batch) -> None:
        from .collection import _embed_arrays

        collection = self._collection

        # 1. Embed, grouped by embedder identity (normally one group —
        #    the client shares a single embedding function).
        embeddings: list = [None] * len(batch)
        ready: list[int] = []
        by_fn: dict = {}
        for i, entry in enumerate(batch):
            by_fn.setdefault(id(entry.embed_fn), []).append(i)
        for idxs in by_fn.values():
            fn = batch[idxs[0]].embed_fn
            try:
                with profile_span("vectorlite.embed.batch"):
                    embs = _embed_arrays(fn, [batch[i].text for i in idxs])
                if len(embs) != len(idxs):
                    raise EmbeddingError(
                        f"embedder returned {len(embs)} embeddings for "
                        f"{len(idxs)} texts"
                    )
            except BaseException:  # noqa: BLE001
                # Per-request isolation: retry one-by-one so only the
                # offending text fails, matching un-coalesced semantics.
                self._embed_singly(batch, idxs, fn, embeddings, ready)
                continue
            for j, i in enumerate(idxs):
                embeddings[i] = embs[j]
                ready.append(i)
        if not ready:
            return

        # 2. Dispatch, grouped by (metric, k, where): every entry gets
        #    exactly the rows its own search_batch(...) returns.
        groups: dict = {}
        for i in ready:
            groups.setdefault(
                (batch[i].metric, batch[i].k, batch[i].where_key), []
            ).append(i)
        with collection._lock.read():
            for (metric, k, _wkey), idxs in groups.items():
                try:
                    with profile_span("vectorlite.index.search_batch"):
                        rows = collection._index.search_batch(
                            np.stack([embeddings[i] for i in idxs]),
                            k,
                            metric,
                            where=batch[idxs[0]].where,
                        )
                except BaseException as e:  # noqa: BLE001
                    for i in idxs:
                        batch[i].fail(e)
                    continue
                for i, row in zip(idxs, rows):
                    batch[i].result = row
                    batch[i].event.set()

    @staticmethod
    def _embed_singly(batch, idxs, fn, embeddings, ready) -> None:
        from .collection import _embed_arrays

        for i in idxs:
            try:
                embs = _embed_arrays(fn, [batch[i].text])
                if len(embs) != 1:
                    raise EmbeddingError(
                        f"embedder returned {len(embs)} embeddings for 1 text"
                    )
                embeddings[i] = embs[0]
                ready.append(i)
            except VectorLiteError as e:
                batch[i].fail(e)
            except BaseException as e:  # noqa: BLE001
                batch[i].fail(EmbeddingError(str(e)))
