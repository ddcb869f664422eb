"""Autosave daemon: periodic crash-resume snapshots of dirty collections.

Extension beyond the reference, filling SURVEY §5's checkpoint/failure-
recovery gap: the reference persists only on an explicit
``POST /collections/{name}/save`` (reference: src/server.rs:300-320) and
its only failure story is the Docker HEALTHCHECK — a crash loses every
mutation since the last manual save. Here a background thread walks the
client's collections every ``interval_s`` seconds and re-snapshots the
ones whose monotone mutation counter (``Collection.mutation_count()``)
moved since their last snapshot. Writes reuse the ``.vlc`` tmp+atomic-
rename path (persist/vlc.py), so a crash mid-save never corrupts the
previous snapshot, and the files are plain reference-compatible ``.vlc``
— the Rust engine can load an autosave directly.

Design notes:

* **Dirty detection is lock-free.** ``mutation_count()`` is an atomic
  read; clean collections cost one integer compare per tick, no index
  lock, no device sync.
* **Counter is snapshotted before the save.** Mutations racing with the
  serialization are re-captured on the next tick rather than lost.
* **Filenames are percent-encoded collection names.** Any collection
  name maps to a unique, filesystem-safe ``<quoted-name>.vlc``; restore
  reads the authoritative name from the file's metadata block anyway.
* **Deleted collections prune their snapshot** (restore would otherwise
  resurrect them). Only files this daemon's encoding owns are touched.

Port of ``vectorlite_tpu/store/autosave.py``. Restoring an HNSW snapshot
raises HNSWNotPorted rather than skipping it as unreadable.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from pathlib import Path
from urllib.parse import quote

logger = logging.getLogger("vectorlite_tpu_torch.autosave")

_SUFFIX = ".vlc"


def snapshot_path(directory, name: str) -> Path:
    """Filesystem-safe, collision-free snapshot path for a collection."""
    return Path(directory) / (quote(name, safe="") + _SUFFIX)


class AutosaveDaemon:
    """Background snapshot thread over a ``VectorLiteClient``.

    Lifecycle: ``start()`` → (ticks) → ``stop()``; ``stop`` runs a final
    flush by default so a clean shutdown never loses acknowledged writes.
    ``flush()`` may also be called directly (it is what a tick runs) and
    is safe concurrently with serving traffic.
    """

    def __init__(
        self,
        client,
        directory,
        interval_s: float = 30.0,
        prune: bool = True,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, got {interval_s}")
        self._client = client
        self._dir = Path(directory)
        self._interval = float(interval_s)
        self._prune = prune
        self._saved: dict[str, int] = {}  # name -> mutation count at save
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._flush_lock = threading.Lock()
        # observability counters (exposed via stats())
        self._saves = 0
        self._failures = 0
        self._pruned = 0
        self._last_flush_ts: float | None = None

    # -- lifecycle ---------------------------------------------------

    def start(self) -> "AutosaveDaemon":
        os.makedirs(self._dir, exist_ok=True)
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="vectorlite-autosave", daemon=True
        )
        self._thread.start()
        logger.info(
            "Autosave enabled: dir=%s interval=%.1fs", self._dir, self._interval
        )
        return self

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=60.0)
        if flush:
            self.flush()

    # -- core --------------------------------------------------------

    def flush(self) -> list[str]:
        """Snapshot every dirty collection now; returns the saved names.

        Serialized against concurrent flushes (tick vs shutdown vs
        explicit call) so two writers never interleave their dirty-table
        updates; individual saves are already atomic on disk.
        """
        with self._flush_lock:
            return self._flush_locked()

    def _flush_locked(self) -> list[str]:
        os.makedirs(self._dir, exist_ok=True)
        saved: list[str] = []
        names = list(self._client.list_collections())
        for name in names:
            collection = self._client.get_collection(name)
            if collection is None:  # deleted between list and get
                continue
            count = collection.mutation_count()
            path = snapshot_path(self._dir, name)
            if self._saved.get(name) == count and path.exists():
                continue
            # WAL rotation rides this snapshot: capture the log position
            # BEFORE the state copy (conservative — entries racing with
            # the save stay in the log and replay idempotently), truncate
            # only after the snapshot durably landed. Only autosave-dir
            # snapshots checkpoint: they are the recovery source; a
            # manual /save to an operator path must never truncate.
            wal = getattr(collection, "_wal", None)
            wal_seq = wal.seq() if wal is not None else None
            try:
                collection.save_to_file(path)
            except Exception:  # noqa: BLE001 — keep other collections going
                self._failures += 1
                logger.exception("Autosave of collection %r failed", name)
                continue
            if wal is not None:
                try:
                    if wal.fsync_policy == "always":
                        # the checkpoint fsyncs its truncation; the
                        # snapshot must be AT LEAST as durable first, or
                        # power loss keeps the short log but not the
                        # covering snapshot
                        from .wal import fsync_file_and_dir

                        fsync_file_and_dir(path)
                    wal.checkpoint(wal_seq)
                except Exception:  # noqa: BLE001 — log kept = still correct
                    logger.exception("WAL checkpoint for %r failed", name)
            self._saved[name] = count
            self._saves += 1
            saved.append(name)
        if self._prune:
            self._prune_stale(set(names))
        self._last_flush_ts = time.time()
        if saved:
            logger.info("Autosaved %d collection(s): %s", len(saved), saved)
        return saved

    def _prune_stale(self, live_names: set[str]) -> None:
        """Drop snapshots of collections that no longer exist, so a
        restore doesn't resurrect deleted data. Only files whose stem
        round-trips through this daemon's quote() encoding are ours to
        remove; anything else in the directory is left alone."""
        from .wal import iter_owned_files

        for stale in list(self._saved.keys() - live_names):
            del self._saved[stale]
        for p, name in iter_owned_files(self._dir, _SUFFIX):
            if name in live_names:
                continue
            try:
                p.unlink(missing_ok=True)
                self._pruned += 1
                logger.info("Pruned stale autosave %s", p.name)
            except OSError:
                pass

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — daemon must survive
                logger.exception("Autosave tick failed")

    # -- introspection ----------------------------------------------

    def stats(self) -> dict:
        return {
            "directory": str(self._dir),
            "interval_s": self._interval,
            "saves": self._saves,
            "failures": self._failures,
            "pruned": self._pruned,
            "last_flush_ts": self._last_flush_ts,
        }


def restore_into(client, directory, **index_kwargs) -> list[str]:
    """Load every ``.vlc`` snapshot in ``directory`` into ``client``
    (crash-resume at startup). Returns loaded collection names, sorted
    for determinism. Unreadable files are logged and skipped — one
    corrupt snapshot must not block the rest of the restore. Collections
    already registered (e.g. via ``--filepath``) win over snapshots.
    """
    from ..errors import HNSWNotPorted
    from ..persist.vlc import load_collection_from_file

    directory = Path(directory)
    if not directory.is_dir():
        return []
    loaded: list[str] = []
    # note: restore reads ANY .vlc here (the authoritative name is in
    # the file's metadata block); only destructive scans (prune, WAL
    # recovery) restrict themselves to files whose encoding they own
    for p in sorted(directory.iterdir()):
        if p.suffix != _SUFFIX or not p.is_file():
            continue
        try:
            collection = load_collection_from_file(p, **index_kwargs)
        except HNSWNotPorted:
            raise
        except Exception:  # noqa: BLE001
            logger.exception("Skipping unreadable autosave %s", p)
            continue
        if client.has_collection(collection.name):
            logger.info(
                "Autosave %s skipped: collection %r already registered",
                p.name,
                collection.name,
            )
            continue
        client.add_collection(collection)
        loaded.append(collection.name)
    if loaded:
        logger.info("Restored %d collection(s) from %s", len(loaded), directory)
    return loaded
