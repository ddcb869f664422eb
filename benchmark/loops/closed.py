"""Closed loop: ``clients`` threads share one system; each sends its next
batch of ``batch`` queries when its last call returns, for the window's
seconds. Client ``c`` walks the query pool from ``c * pool / clients``
on, ``batch`` rows a call, wrapping at the end, so every seed sends the
same sizes in the same order. A call is timed from when its client
issued it to when it returned.

Client 0 runs in the calling thread. In the traced run it also owns the
profiler (``stretch``), which it starts and stops between its calls: a
profiler surely records the host ranges of the thread that started it.

For the comparison each client keeps a reservoir of ``check_calls``
calls, drawn from the seed uniformly over all the calls it made in the
window (replaced answers are dropped at once, so the window holds few).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    seconds: float
    t0: float = 0.0
    t_end: float = 0.0
    #: (client, issued, returned, queries, ok) a call, in any order
    calls: list = field(default_factory=list)
    #: (pool row indices [B], answers) of the calls kept for the comparison
    samples: list = field(default_factory=list)
    errors: list = field(default_factory=list)


def _batch(pool_rows: int, start: int, batch: int) -> np.ndarray:
    return (start + np.arange(batch)) % pool_rows


def warm(call, traffic: dict, pool: np.ndarray) -> None:
    """The cell's own shapes: one call alone (the first builds the
    device cache and any filter mask), then one round from every client
    at once."""
    batch, clients = int(traffic["batch"]), int(traffic["clients"])
    call(pool[_batch(len(pool), 0, batch)])
    threads = [threading.Thread(target=call, args=(pool[_batch(len(pool), c * batch, batch)],))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def drive(call, traffic: dict, pool: np.ndarray, seconds: float, seed: int,
          stretch=None) -> Window:
    """Run the window. ``stretch.tick(window, now)``, if given, runs in
    client 0 before each of its calls and ``stretch.close()`` after its
    last (the traced run's profiler)."""
    batch, clients = int(traffic["batch"]), int(traffic["clients"])
    keep = int(traffic["check_calls"])
    rows = len(pool)
    win = Window(seconds=float(seconds))
    lock = threading.Lock()
    start = threading.Barrier(clients)

    def client(c: int) -> None:
        rng = random.Random(f"{seed}/{c}")
        pos = c * rows // clients
        calls, kept, made = [], [], 0
        start.wait()
        t_end = win.t_end
        while True:
            t_issue = time.perf_counter()
            if c == 0 and stretch is not None:
                stretch.tick(win, t_issue)
                t_issue = time.perf_counter()
            if t_issue >= t_end:
                break
            idx = _batch(rows, pos, batch)
            pos = (pos + batch) % rows
            try:
                answers, ok = call(pool[idx]), True
            except Exception as e:  # noqa: BLE001 - a failed call is counted, the loop goes on
                answers, ok = None, False
                with lock:
                    win.errors.append(repr(e))
            calls.append((c, t_issue, time.perf_counter(), batch, ok))
            if ok:
                if made < keep:
                    kept.append((idx, answers))
                else:
                    j = rng.randrange(made + 1)
                    if j < keep:
                        kept[j] = (idx, answers)
                made += 1
            # a caller drops its answers once read: held through the next
            # call they would be promoted by its collections and bring on
            # full GC passes that the program's own work does not cause
            answers = None
        if c == 0 and stretch is not None:
            stretch.close()
        with lock:
            win.calls.extend(calls)
            win.samples.extend(kept)

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
               for c in range(1, clients)]
    for t in threads:
        t.start()
    win.t0 = time.perf_counter()
    win.t_end = win.t0 + win.seconds
    client(0)
    for t in threads:
        t.join()
    return win
