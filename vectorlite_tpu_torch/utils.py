"""Concurrency primitives: readers-writer lock and atomic counter.

The reference relies on ``RwLock`` per collection and ``AtomicU64`` id
generation (reference: src/client.rs:243-247). Python equivalents live here.
JAX index state is functional (replace-on-write), so readers never observe a
partially-updated device buffer; the lock only guards the host-side tables.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    """Writer-preferring readers-writer lock."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class AtomicCounter:
    """fetch_add counter (reference: next_id AtomicU64, src/client.rs:246)."""

    def __init__(self, start: int = 0):
        self._value = int(start)
        self._lock = threading.Lock()

    def fetch_add(self, n: int = 1) -> int:
        with self._lock:
            v = self._value
            self._value += n
            return v

    def load(self) -> int:
        with self._lock:
            return self._value

    def bump_to(self, floor: int) -> None:
        """Raise the counter to at least ``floor`` (fetch_max semantics).
        Used after inserts with caller-chosen explicit ids so later
        auto-allocated ids can never collide with them."""
        floor = int(floor)
        with self._lock:
            if self._value < floor:
                self._value = floor


def env_number(name: str, default, cast=int):
    """Parse a numeric env override, falling back on absence or garbage.

    Deliberately uncached: tests and operators flip these at runtime
    (e.g. VECTORLITE_HOST_SCAN_ROWS=0 to force the device path)."""
    import os

    raw = os.environ.get(name)
    if raw:
        try:
            return cast(raw)
        except ValueError:
            pass
    return default
