"""Request metrics and tracing spans for the serving steps.

Copies of the JAX package's recorders (``vectorlite_tpu/observability.py``):
per-route latency percentiles, the search coalescer's batch counters, the
metadata-filter cache counters and their Prometheus rendering. The spans
are ``torch.profiler`` ranges, and ``capture_device_trace`` (the
``/debug/trace`` route) records the whole process with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import threading
import time

import torch

logger = logging.getLogger("vectorlite_tpu_torch.observability")


class LatencyRecorder:
    """Per-route latency ring buffer with percentile readout.

    A ring over the most recent ``_MAX_SAMPLES`` observations: percentiles
    reflect a sliding window with no eviction bias (the previous sorted
    reservoir evicted the median once full, skewing p50/p99 bimodal after
    2048 samples). ``max_ms`` is all-time, not windowed."""

    _MAX_SAMPLES = 2048

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: dict[str, list[float]] = {}
        self._next: dict[str, int] = {}
        self._counts: dict[str, int] = {}
        self._errors: dict[str, int] = {}
        self._max: dict[str, float] = {}

    def record(self, route: str, seconds: float, ok: bool = True) -> None:
        with self._lock:
            samples = self._samples.setdefault(route, [])
            if len(samples) < self._MAX_SAMPLES:
                samples.append(seconds)
            else:
                pos = self._next.get(route, 0)
                samples[pos] = seconds
                self._next[route] = (pos + 1) % self._MAX_SAMPLES
            self._counts[route] = self._counts.get(route, 0) + 1
            if seconds > self._max.get(route, 0.0):
                self._max[route] = seconds
            if not ok:
                self._errors[route] = self._errors.get(route, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for route, samples in self._samples.items():
                if not samples:
                    continue
                ordered = sorted(samples)
                n = len(ordered)
                out[route] = {
                    "count": self._counts.get(route, 0),
                    "errors": self._errors.get(route, 0),
                    "p50_ms": round(ordered[n // 2] * 1e3, 3),
                    "p99_ms": round(
                        ordered[min(n - 1, n * 99 // 100)] * 1e3, 3
                    ),
                    "max_ms": round(self._max.get(route, 0.0) * 1e3, 3),
                }
            return out


class CoalesceRecorder:
    """Counters for the search coalescer (store/coalesce.py): how many
    dispatches ran and how large the merged batches were. Exposed under
    ``coalesce`` at ``GET /stats`` so operators can see whether
    concurrent traffic is actually merging (avg_batch ~1 under serial
    load, rising with concurrency)."""

    _BUCKETS = (1, 4, 16, 64, 256)

    def __init__(self):
        self._lock = threading.Lock()
        self._batches = 0
        self._entries = 0
        self._max = 0
        self._hist = [0] * len(self._BUCKETS)

    def record(self, batch_size: int) -> None:
        with self._lock:
            self._batches += 1
            self._entries += batch_size
            if batch_size > self._max:
                self._max = batch_size
            for i, hi in enumerate(self._BUCKETS):
                if batch_size <= hi:
                    self._hist[i] += 1
                    break

    def snapshot(self) -> dict:
        with self._lock:
            if not self._batches:
                return {"batches": 0}
            return {
                "batches": self._batches,
                "requests": self._entries,
                "avg_batch": round(self._entries / self._batches, 2),
                "max_batch": self._max,
                "hist": {
                    f"<={hi}": n
                    for hi, n in zip(self._BUCKETS, self._hist)
                    if n
                },
            }


#: Process-wide coalesce counters (all collections share one recorder;
#: per-collection split hasn't earned its keep yet).
coalesce_stats = CoalesceRecorder()


class FilterRecorder:
    """Counters for metadata-filtered search (core/filter.py): cache
    hits vs incremental extensions vs full O(N) mask builds, exposed
    under ``filters`` at ``GET /stats``. A hot clause should converge to
    hits (or cheap extensions under steady ingestion); a rising
    full-build count means clauses churn faster than the cache width or
    structural mutations (delete/compact/metadata-update) dominate."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hits = 0
        self._extensions = 0
        self._builds = 0
        self._rows_walked = 0

    def record(self, kind: str, rows: int = 0) -> None:
        with self._lock:
            if kind == "hit":
                self._hits += 1
            elif kind == "extend":
                self._extensions += 1
            else:
                self._builds += 1
            self._rows_walked += rows

    def snapshot(self) -> dict:
        with self._lock:
            total = self._hits + self._extensions + self._builds
            if not total:
                return {"lookups": 0}
            return {
                "lookups": total,
                "cache_hits": self._hits,
                "incremental_extensions": self._extensions,
                "full_builds": self._builds,
                "rows_walked": self._rows_walked,
            }


#: Process-wide filter-cache counters (same sharing rationale).
filter_stats = FilterRecorder()


def _prom_escape(value: str) -> str:
    """Escape a Prometheus label value (text exposition format 0.0.4):
    backslash, double-quote, and newline."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def render_prometheus(
    latency: dict,
    coalesce: dict,
    filters: dict,
    collections: dict[str, int],
    autosave: "dict | None" = None,
    wal: "dict | None" = None,
) -> str:
    """Render the /stats counters in the Prometheus text exposition
    format (extension; the reference has logs only, SURVEY §5). Inputs
    are the snapshot() dicts so one lock acquisition feeds both /stats
    and /metrics. Latency quantiles are exported as gauges (the ring
    keeps no running sum, so a true summary type would be misleading)."""
    lines: list[str] = []

    def head(name: str, mtype: str, help_: str) -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {mtype}")

    head("vectorlite_requests_total", "counter",
         "HTTP requests served, by route")
    for route, s in sorted(latency.items()):
        lines.append(
            f'vectorlite_requests_total{{route="{_prom_escape(route)}"}} '
            f'{s["count"]}'
        )
    head("vectorlite_request_errors_total", "counter",
         "HTTP 5xx responses, by route")
    for route, s in sorted(latency.items()):
        lines.append(
            "vectorlite_request_errors_total"
            f'{{route="{_prom_escape(route)}"}} {s["errors"]}'
        )
    head("vectorlite_request_latency_seconds", "gauge",
         "Sliding-window latency quantiles, by route")
    for route, s in sorted(latency.items()):
        r = _prom_escape(route)
        for q, key in (("0.5", "p50_ms"), ("0.99", "p99_ms")):
            lines.append(
                "vectorlite_request_latency_seconds"
                f'{{route="{r}",quantile="{q}"}} {s[key] / 1e3:.6f}'
            )
    head("vectorlite_request_latency_seconds_max", "gauge",
         "All-time max request latency, by route")
    for route, s in sorted(latency.items()):
        lines.append(
            "vectorlite_request_latency_seconds_max"
            f'{{route="{_prom_escape(route)}"}} {s["max_ms"] / 1e3:.6f}'
        )

    head("vectorlite_collections", "gauge", "Registered collections")
    lines.append(f"vectorlite_collections {len(collections)}")
    head("vectorlite_collection_vectors", "gauge",
         "Live vectors per collection")
    for name, count in sorted(collections.items()):
        lines.append(
            "vectorlite_collection_vectors"
            f'{{collection="{_prom_escape(name)}"}} {count}'
        )

    head("vectorlite_coalesce_batches_total", "counter",
         "Coalesced search dispatches")
    lines.append(
        f"vectorlite_coalesce_batches_total {coalesce.get('batches', 0)}"
    )
    head("vectorlite_coalesce_requests_total", "counter",
         "Single-query searches that rode a coalesced dispatch")
    lines.append(
        f"vectorlite_coalesce_requests_total {coalesce.get('requests', 0)}"
    )

    head("vectorlite_filter_cache_lookups_total", "counter",
         "Metadata-filter mask lookups, by outcome")
    for label, key in (
        ("hit", "cache_hits"),
        ("extend", "incremental_extensions"),
        ("build", "full_builds"),
    ):
        lines.append(
            "vectorlite_filter_cache_lookups_total"
            f'{{result="{label}"}} {filters.get(key, 0)}'
        )

    if autosave is not None:
        head("vectorlite_autosave_saves_total", "counter",
             "Autosave snapshot writes")
        lines.append(
            f"vectorlite_autosave_saves_total {autosave.get('saves', 0)}"
        )
        head("vectorlite_autosave_failures_total", "counter",
             "Autosave snapshot failures")
        lines.append(
            "vectorlite_autosave_failures_total "
            f"{autosave.get('failures', 0)}"
        )
        ts = autosave.get("last_flush_ts")
        if ts:
            head("vectorlite_autosave_last_flush_timestamp_seconds",
                 "gauge", "Unix time of the last completed flush")
            lines.append(
                "vectorlite_autosave_last_flush_timestamp_seconds "
                f"{ts:.3f}"
            )

    if wal is not None:
        per = wal.get("collections", {})
        head("vectorlite_wal_appends_total", "counter",
             "WAL ops appended, by collection")
        for name, s in sorted(per.items()):
            lines.append(
                "vectorlite_wal_appends_total"
                f'{{collection="{_prom_escape(name)}"}} '
                f'{s.get("appends", 0)}'
            )
        head("vectorlite_wal_size_bytes", "gauge",
             "Current WAL file size, by collection")
        for name, s in sorted(per.items()):
            lines.append(
                "vectorlite_wal_size_bytes"
                f'{{collection="{_prom_escape(name)}"}} '
                f'{s.get("size_bytes", 0)}'
            )
        head("vectorlite_wal_checkpoints_total", "counter",
             "WAL checkpoint rotations, by collection")
        for name, s in sorted(per.items()):
            lines.append(
                "vectorlite_wal_checkpoints_total"
                f'{{collection="{_prom_escape(name)}"}} '
                f'{s.get("checkpoints", 0)}'
            )
    return "\n".join(lines) + "\n"


@contextlib.contextmanager
def profile_span(name: str):
    """A ``torch.profiler`` range around a serving step, so a profiler
    trace shows it beside the kernels it launched. Without an active
    profiler the range costs a flag check."""
    with torch.profiler.record_function(name):
        yield


_trace_lock = threading.Lock()
_trace_active = False


def capture_device_trace(seconds: float = 2.0) -> str:
    """Record the process with ``torch.profiler`` for ``seconds`` (CPU
    activity, and CUDA activity where a card is present) and write a
    Chrome trace (``trace_<ns>_<pid>.json``) into
    ``$VECTORLITE_JAX_PROFILE_DIR`` (the JAX package's variable; default
    ``<tmp>/vectorlite_trace``); returns that directory. One capture at a
    time. The device side is recorded for the whole process, so kernels
    launched by other threads (other requests) appear with their names;
    host-side ranges may show only the capturing thread's."""
    global _trace_active
    trace_dir = os.environ.get("VECTORLITE_JAX_PROFILE_DIR") or os.path.join(
        tempfile.gettempdir(), "vectorlite_trace")
    with _trace_lock:
        if _trace_active:
            raise RuntimeError("a trace capture is already running")
        _trace_active = True
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            time.sleep(seconds)
        path = os.path.join(
            trace_dir, f"trace_{time.time_ns()}_{os.getpid()}.json")
        prof.export_chrome_trace(path)
    finally:
        with _trace_lock:
            _trace_active = False
    logger.info("device trace written to %s", path)
    return trace_dir
