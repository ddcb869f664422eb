"""Write-ahead oplog: zero-loss durability between snapshots.

Extension beyond the reference, deepening SURVEY §5's checkpoint/
failure-recovery story: the reference persists only on an explicit
``POST /collections/{name}/save`` (reference: src/server.rs:300-320),
and our autosave daemon (store/autosave.py) bounds loss to one
``interval_s`` window. With a WAL attached, every acknowledged mutation
is appended to a per-collection JSONL redo log before the call returns,
so a crash between snapshots replays forward to the last acknowledged
write instead of rewinding to the last snapshot.

Design — idempotent redo, no LSN coordination with the snapshot:

* **Append = commit record.** Ops are logged inside the collection's
  write lock AFTER the index mutation succeeds: the log can never
  contain an op that failed validation, and log order == apply order.
  An op that crashed between apply and append was never acknowledged.
* **Replay is idempotent**, so the snapshot/WAL pair needs no sequence
  agreement: ``add`` of an id the snapshot already contains is skipped,
  ``del``/``meta`` of a missing id is a no-op, ``delw``/``compact``
  re-run harmlessly on post-op state. A checkpoint may therefore be
  *conservative* (keep a few already-applied entries) but must never be
  optimistic — the autosave daemon captures ``wal.seq()`` BEFORE the
  snapshot copy and truncates only entries ``<= seq`` afterwards.
* **Rotation rides the autosave.** Only saves into the recovery
  directory checkpoint the log (a manual ``/save`` to an operator path
  must NOT truncate — that snapshot is not the recovery source).
  Running a WAL without autosave works (recovery replays the full log
  over the ``create`` header) but the log grows until a snapshot
  exists; the CLI warns.
* **Torn tails are expected.** A crash mid-append leaves a partial last
  line; replay stops at the first undecodable line and logs what it
  dropped (those ops were never acknowledged — appends flush before the
  caller returns), and resume TRUNCATES it so later appends never weld
  onto garbage.
* **Registrations get a durable base.** A collection that arrives with
  data (snapshot upload, /collections/load, --filepath) is immediately
  snapshotted into the recovery dir — or, without one, its contents are
  logged as chunked ``add`` ops — so a crash right after never recovers
  an empty collection from a bare ``create`` header.
* **Deletes leave a ``drop`` tombstone** before the log and covering
  snapshot are unlinked: recovery discards everything before the last
  ``drop``, so an acknowledged delete_collection survives a crash in
  the unlink window instead of being resurrected by a stale snapshot.

Fsync policy (``VECTORLITE_WAL_FSYNC`` / constructor):

* ``batch`` (default) — write + flush to the OS per record: survives
  process crashes, not power loss.
* ``always`` — additionally ``os.fsync`` per record: survives power
  loss, costs one disk sync per mutation.
* ``off`` — Python-buffered; flushed on rotate/close only.

Port of ``vectorlite_tpu/store/wal.py`` for Flat collections: a log whose
``create`` header names an HNSW index raises HNSWNotPorted at recovery
instead of replaying.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from pathlib import Path
from urllib.parse import quote, unquote

import numpy as np

from ..errors import HNSWNotPorted, VectorNotFound

logger = logging.getLogger("vectorlite_tpu_torch.wal")

_SUFFIX = ".wal"
_POLICIES = ("batch", "always", "off")


def wal_path(directory, name: str) -> Path:
    """Filesystem-safe, collision-free log path for a collection (same
    percent-encoding scheme as autosave.snapshot_path)."""
    return Path(directory) / (quote(name, safe="") + _SUFFIX)


def _fsync_policy(explicit=None) -> str:
    policy = explicit or os.environ.get("VECTORLITE_WAL_FSYNC", "batch")
    if policy not in _POLICIES:
        logger.warning(
            "VECTORLITE_WAL_FSYNC=%r is not one of %s; using 'batch'",
            policy,
            _POLICIES,
        )
        policy = "batch"
    return policy


def fsync_file_and_dir(path) -> None:
    """Force ``path`` (and its directory entry) to stable storage —
    required before a checkpoint may truncate the log under the
    ``always`` policy: an un-fsynced snapshot + a durably truncated log
    loses acknowledged writes on power loss."""
    path = Path(path)
    with open(path, "rb") as f:
        os.fsync(f.fileno())
    dfd = os.open(path.parent, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def iter_owned_files(directory, suffix):
    """Yield ``(path, collection_name)`` for files in ``directory`` whose
    stem round-trips through the percent-encoding this subsystem owns
    (shared by WAL recovery and autosave restore/prune — one definition
    of 'ours', so the two never disagree about a file)."""
    directory = Path(directory)
    try:
        entries = sorted(directory.iterdir())
    except OSError:
        return
    for p in entries:
        if p.suffix != suffix or not p.is_file():
            continue
        name = unquote(p.stem)
        if quote(name, safe="") != p.stem:
            continue
        yield p, name


def _jsonable(value):
    """Ops must round-trip through JSON for replay; numpy scalars/arrays
    from the array-native insert paths are converted, anything else
    unserializable raises BEFORE the caller logs/acks the op."""
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    return value


def pack_values(arr) -> str:
    """f64 rows -> base64 of the little-endian buffer. Rendering vector
    values as JSON float lists dominated WAL append cost (measured 28x
    on the batched insert path — Python float repr, not I/O); the
    packed form is bit-exact, ~2.3x smaller, and C-speed both ways. The
    op envelope (ids, texts, metadata) stays readable JSON."""
    a = np.ascontiguousarray(np.asarray(arr, dtype="<f8"))
    import base64

    return base64.b64encode(a.tobytes()).decode("ascii")


def unpack_values(b64: str, n_rows: int) -> np.ndarray:
    import base64

    flat = np.frombuffer(base64.b64decode(b64), dtype="<f8")
    return flat.reshape(n_rows, -1) if n_rows else flat.reshape(0, 0)


class CollectionWAL:
    """Append-only JSONL redo log for one collection.

    Thread contract: ``append`` is called under the collection's write
    lock (one writer at a time); ``checkpoint``/``close`` may race with
    nothing but are serialized against appends by the internal mutex
    anyway (the autosave thread checkpoints while serving threads
    append).
    """

    def __init__(self, path, fsync: str | None = None):
        self._path = Path(path)
        self._fsync = _fsync_policy(fsync)
        self._mu = threading.Lock()
        self._f = None
        self._seq = 0
        self._appends = 0
        self._checkpoints = 0
        # Resume an existing log: scan for the highest intact seq so
        # appended entries keep strictly increasing, and TRUNCATE any
        # torn tail — appending onto a partial line would weld the next
        # record into one garbage line, and the replay scan would then
        # stop there and silently drop every later acknowledged write.
        if self._path.exists():
            entries, good_end = scan_log(self._path)
            for entry in entries:
                self._seq = max(self._seq, int(entry.get("s", 0)))
            size = self._path.stat().st_size
            if good_end < size:
                logger.warning(
                    "WAL %s: truncating torn tail (%d of %d bytes intact)",
                    self._path,
                    good_end,
                    size,
                )
                with open(self._path, "r+b") as f:
                    f.truncate(good_end)

    # -- plumbing ------------------------------------------------------

    def _file(self):
        if self._f is None:
            os.makedirs(self._path.parent, exist_ok=True)
            self._f = open(self._path, "a", encoding="utf-8")
        return self._f

    @property
    def fsync_policy(self) -> str:
        return self._fsync

    def seq(self) -> int:
        """Last assigned sequence number (0 = empty log)."""
        with self._mu:
            return self._seq

    def size_bytes(self) -> int:
        try:
            return self._path.stat().st_size
        except OSError:
            return 0

    # -- core ------------------------------------------------------------

    def render(self, op: dict) -> str:
        """Serialize an op WITHOUT appending. Collection hooks render
        before taking the write lock / mutating, then append the
        rendered line after the mutation succeeds — an op that cannot
        round-trip through JSON (NaN values, exotic metadata) is
        rejected before anything is half-applied. Raises
        TypeError/ValueError on unserializable input."""
        return json.dumps(
            op, separators=(",", ":"), default=_jsonable, allow_nan=False
        )

    def append(self, op: dict | None = None, *, rendered: str | None = None) -> int:
        """Durably append one op (or a line pre-built by ``render``);
        returns its seq."""
        line = self.render(op) if rendered is None else rendered
        with self._mu:
            self._seq += 1
            f = self._file()
            f.write(f'{{"s":{self._seq},{line[1:]}' "\n")
            if self._fsync != "off":
                f.flush()
                if self._fsync == "always":
                    os.fsync(f.fileno())
            self._appends += 1
            return self._seq

    def checkpoint(self, seq: int | None) -> None:
        """Drop entries with ``s <= seq`` (they are covered by a snapshot
        that has durably landed). Atomic: rewrite + rename; a crash
        mid-checkpoint leaves the previous (longer, still-correct) log.
        ``seq=None`` (no WAL at save time) is a no-op."""
        if seq is None:
            return
        with self._mu:
            if self._f is not None:
                self._f.flush()
            keep = [
                e for e in read_entries(self._path) if int(e.get("s", 0)) > seq
            ]
            tmp = self._path.with_name(
                f"{self._path.name}.{os.getpid()}.tmp"
            )
            with open(tmp, "w", encoding="utf-8") as f:
                for e in keep:
                    f.write(json.dumps(e, separators=(",", ":")) + "\n")
                f.flush()
                if self._fsync == "always":
                    os.fsync(f.fileno())
            # swap the live handle to the rotated file
            if self._f is not None:
                self._f.close()
                self._f = None
            os.replace(tmp, self._path)
            self._checkpoints += 1

    def close(self) -> None:
        with self._mu:
            if self._f is not None:
                self._f.flush()
                if self._fsync == "always":
                    try:
                        os.fsync(self._f.fileno())
                    except OSError:
                        pass
                self._f.close()
                self._f = None

    def stats(self) -> dict:
        return {
            "path": str(self._path),
            "seq": self._seq,
            "appends": self._appends,
            "checkpoints": self._checkpoints,
            "size_bytes": self.size_bytes(),
        }


def scan_log(path) -> tuple[list[dict], int]:
    """Decode a log file, tolerating a torn tail: stop at the first
    undecodable/partial/newline-less line (a crash mid-append; the op
    was never acknowledged). Corruption anywhere earlier also stops the
    scan — replaying past a hole would apply ops out of order. Returns
    ``(entries, intact_bytes)``; this is THE one definition of "intact"
    shared by resume truncation, recovery, and the fsck tool."""
    entries: list[dict] = []
    intact = 0
    try:
        with open(path, "rb") as f:
            for lineno, raw in enumerate(f, 1):
                try:
                    if not raw.endswith(b"\n"):
                        raise ValueError("no trailing newline")
                    entry = json.loads(raw)
                    if not isinstance(entry, dict) or "op" not in entry:
                        raise ValueError("not an op record")
                except ValueError:
                    logger.warning(
                        "WAL %s: undecodable line %d — stopping replay "
                        "scan here (torn tail or corruption)",
                        path,
                        lineno,
                    )
                    break
                entries.append(entry)
                intact += len(raw)
    except FileNotFoundError:
        pass
    return entries, intact


def read_entries(path) -> list[dict]:
    """The intact entries of a log file (see scan_log)."""
    return scan_log(path)[0]


# ----------------------------------------------------------------- replay


def _replay_into(collection, entries: list[dict]) -> int:
    """Apply log entries idempotently, in order. Returns ops applied
    (skipped-as-already-applied ops count too — they are successful)."""
    from ..core.types import Vector

    applied = 0
    for e in entries:
        op = e.get("op")
        if op == "create":
            applied += 1
            continue
        if op == "add":
            if "rows" in e:  # row-tuple form (hand-written / legacy)
                rows = [
                    (int(r[0]), r[1], r[2], r[3]) for r in e["rows"]
                ]
            else:  # packed form (what the hooks write)
                ids = [int(i) for i in e["ids"]]
                vals = unpack_values(e["vals"], len(ids))
                texts = e.get("texts")
                metas = e.get("metas")
                rows = [
                    (
                        ids[i],
                        vals[i],
                        texts[i] if texts is not None else "",
                        metas[i] if metas is not None else None,
                    )
                    for i in range(len(ids))
                ]
            for vid, values, text, metadata in rows:
                if collection._index.get_vector(vid) is not None:
                    continue  # idempotent: snapshot already has it
                collection._index.add(
                    Vector(
                        id=vid,
                        values=values,
                        text=text or "",
                        metadata=metadata,
                    )
                )
            if rows:
                collection._next_id.bump_to(
                    max(vid for vid, *_ in rows) + 1
                )
        elif op == "put":
            vid = int(e["id"])
            collection._index.delete(vid)  # absent ids succeed
            if collection._index.get_vector(vid) is None:
                values = (
                    unpack_values(e["vals"], 1)[0]
                    if "vals" in e
                    else e["values"]
                )
                collection._index.add(
                    Vector(
                        id=vid,
                        values=values,
                        text=e.get("text") or "",
                        metadata=e.get("metadata"),
                    )
                )
            collection._next_id.bump_to(vid + 1)
        elif op == "del":
            collection._index.delete(int(e["id"]))  # absent ids succeed
        elif op == "delw":
            collection._index.delete_where(e["where"])
        elif op == "meta":
            try:
                collection._index.update_metadata(
                    int(e["id"]), e.get("metadata")
                )
            except VectorNotFound:
                pass
        elif op == "compact":
            collection._index.compact()
        else:
            logger.warning("WAL: unknown op %r skipped", op)
            continue
        applied += 1
    # replay bypassed Collection's public methods: resync derived state
    collection._bm25 = None  # next hybrid search rebuilds from live texts
    if applied:
        collection._mutations.fetch_add(1)
    return applied


def _collection_from_header(client, entries: list[dict], name: str):
    """Build an empty collection from the log's ``create`` header (the
    collection was created after the last snapshot, or never snapshotted).
    Returns None (with a warning) when no intact header exists."""
    from ..index.flat import FlatIndex
    from .collection import Collection

    header = next((e for e in entries if e.get("op") == "create"), None)
    if header is None:
        logger.warning(
            "WAL for %r has no snapshot and no create header; skipping",
            name,
        )
        return None
    if header.get("index_type") == "HNSW":
        raise HNSWNotPorted("write-ahead logs")
    index = FlatIndex(int(header["dim"]), **client.flat_index_kwargs())
    return Collection(name, index)


# ---------------------------------------------------------------- manager


class WalManager:
    """Directory of per-collection logs, attached to a client via its
    collection-observer hook: registration opens (or resumes) the
    collection's log and establishes a durable base (create header +
    snapshot or logged contents — see below); deletion drops the log
    AND the covering snapshot so recovery cannot resurrect acknowledged
    deletes.

    ``snapshot_dir`` should be the autosave directory when one exists:
    a collection registered WITH data (snapshot upload, /collections/
    load, --filepath) is immediately snapshotted there so the fresh log
    has a base to replay over. Without a snapshot_dir the registration
    contents are logged as chunked ``add`` ops instead — correct either
    way; a crash right after a data-bearing registration must not
    recover an empty collection."""

    def __init__(self, directory, fsync: str | None = None,
                 snapshot_dir=None):
        self._dir = Path(directory)
        self._fsync = _fsync_policy(fsync)
        self._snapshot_dir = (
            Path(snapshot_dir) if snapshot_dir is not None else None
        )
        self._mu = threading.Lock()
        self._wals: dict[str, CollectionWAL] = {}
        os.makedirs(self._dir, exist_ok=True)

    @property
    def directory(self) -> Path:
        return self._dir

    # -- client observer hooks ----------------------------------------

    def collection_registered(self, collection) -> None:
        name = collection.name
        with self._mu:
            wal = self._wals.get(name)
            if wal is None:
                wal = CollectionWAL(wal_path(self._dir, name), self._fsync)
                self._wals[name] = wal
        if wal.seq() == 0:
            index = collection._index
            wal.append(
                {
                    "op": "create",
                    "index_type": index.index_type,
                    "dim": index.dimension,
                    "metric": (
                        index.metric().value if index.metric() else None
                    ),
                }
            )
            if len(index) > 0:
                self._establish_base(collection, wal)
        collection._wal = wal

    def _establish_base(self, collection, wal) -> None:
        """A data-bearing collection just joined with a FRESH log: give
        recovery something to stand on (the header alone would replay
        to an empty collection)."""
        if self._snapshot_dir is not None:
            from .autosave import snapshot_path

            try:
                collection.save_to_file(
                    snapshot_path(self._snapshot_dir, collection.name)
                )
                if wal.fsync_policy == "always":
                    fsync_file_and_dir(
                        snapshot_path(self._snapshot_dir, collection.name)
                    )
                return
            except Exception:  # noqa: BLE001 — fall back to logging
                logger.exception(
                    "Registration snapshot of %r failed; logging "
                    "contents to the WAL instead",
                    collection.name,
                )
        offset = 0
        while True:
            vectors, _total = collection._index.list_vectors(
                offset, 1024, None, True
            )
            if not vectors:
                break
            wal.append(
                {
                    "op": "add",
                    "ids": [v.id for v in vectors],
                    "vals": pack_values([v.values for v in vectors]),
                    "texts": [v.text for v in vectors],
                    "metas": [v.metadata for v in vectors],
                }
            )
            offset += len(vectors)

    def collection_deleted(self, name: str) -> None:
        with self._mu:
            wal = self._wals.pop(name, None)
        if wal is not None:
            # drop tombstone FIRST: if the unlinks below never happen
            # (crash), recovery still discards everything before it
            try:
                wal.append({"op": "drop"})
            except Exception:  # noqa: BLE001 — best effort, then unlink
                logger.exception("WAL drop record for %r failed", name)
            wal.close()
        if self._snapshot_dir is not None:
            # the acknowledged delete must not be undone by a stale
            # snapshot at the next crash-recovery; autosave would only
            # prune it at the next tick
            from .autosave import snapshot_path

            try:
                snapshot_path(self._snapshot_dir, name).unlink(
                    missing_ok=True
                )
            except OSError:
                pass
        try:
            wal_path(self._dir, name).unlink(missing_ok=True)
        except OSError:
            pass

    # -- lifecycle / introspection --------------------------------------

    def close(self) -> None:
        with self._mu:
            wals, self._wals = dict(self._wals), {}
        for wal in wals.values():
            wal.close()

    def stats(self) -> dict:
        with self._mu:
            per = {n: w.stats() for n, w in self._wals.items()}
        return {
            "directory": str(self._dir),
            "fsync": self._fsync,
            "collections": per,
        }


def recover_into(client, directory, snapshot_dir=None) -> dict:
    """Replay every log in ``directory`` into ``client`` (after any
    snapshot restore), creating collections that only exist in the WAL
    from their ``create`` headers. When ``snapshot_dir`` is given
    (the autosave directory — the recovery source), each recovered
    collection is re-snapshotted there and its log checkpointed, so a
    second crash right after recovery still replays to the same state.

    Returns ``{name: ops_applied}``. Unreadable logs are skipped with a
    log line — one corrupt file must not block the rest, mirroring
    autosave.restore_into. A log of an HNSW collection raises
    HNSWNotPorted: skipping it would drop acknowledged writes."""
    from .autosave import snapshot_path

    directory = Path(directory)
    if not directory.is_dir():
        return {}
    recovered: dict[str, int] = {}
    for p, name in iter_owned_files(directory, _SUFFIX):
        entries = read_entries(p)
        # Honor drop tombstones (an acknowledged delete_collection whose
        # file unlinks never landed): discard everything before the LAST
        # drop; what follows is a post-drop recreation (or nothing).
        last_drop = next(
            (
                i
                for i in range(len(entries) - 1, -1, -1)
                if entries[i].get("op") == "drop"
            ),
            None,
        )
        try:
            if last_drop is not None:
                entries = entries[last_drop + 1:]
                if client.has_collection(name):
                    # the restored snapshot predates the drop
                    client.delete_collection(name)
                if snapshot_dir is not None:
                    snapshot_path(snapshot_dir, name).unlink(
                        missing_ok=True
                    )
                if not entries:
                    p.unlink(missing_ok=True)
                    recovered[name] = 0
                    continue
            collection = client.get_collection(name)
            if collection is None:
                collection = _collection_from_header(client, entries, name)
                if collection is None:
                    continue
                client.add_collection(collection)
            applied = _replay_into(collection, entries)
        except HNSWNotPorted:
            raise
        except Exception:  # noqa: BLE001 — keep other collections going
            logger.exception("WAL replay for collection %r failed", name)
            continue
        recovered[name] = applied
        if last_drop is not None:
            # rewrite the log without the pre-drop prefix so a resumed
            # manager never replays the dropped lineage again
            CollectionWAL(p).checkpoint(
                int(entries[0].get("s", 1)) - 1 if entries else None
            )
        if snapshot_dir is not None and applied:
            wal = getattr(collection, "_wal", None)
            seq = wal.seq() if wal is not None else None
            snap = snapshot_path(snapshot_dir, name)
            try:
                collection.save_to_file(snap)
                if _fsync_policy() == "always":
                    fsync_file_and_dir(snap)
            except Exception:  # noqa: BLE001
                logger.exception(
                    "Post-recovery snapshot of %r failed; log kept", name
                )
            else:
                if wal is None:
                    # manager not attached yet: checkpoint the file the
                    # manager will resume (seq = everything replayed)
                    last = max(
                        (int(e.get("s", 0)) for e in entries), default=0
                    )
                    CollectionWAL(p).checkpoint(last)
                else:
                    wal.checkpoint(seq)
    if recovered:
        logger.info("WAL recovery: %s", recovered)
    return recovered
