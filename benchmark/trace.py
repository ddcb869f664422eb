"""The traced run's reading: ``torch.profiler`` over a steady stretch of
the window, reduced to what the per-layer readers need.

The loop's client 0 starts the profiler between two of its calls once
the stretch is due and stops it once it has passed, inside a range the
harness opens (``MARK``). A profiler surely records the host ranges of
the thread that started it; it asks for every thread's, which it gets
for some (``_profiler``). Within the range the reduction takes:
- every kernel, copy and memset on the card (busy time is their union);
- the program's ranges by name, and the device time each launched;
- the device operations that took most time;
- the idle gaps, by what the host was doing in their middle (the
  shortest host event that covers it).
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

MARK = "benchmark.traced_stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    #: host clock (perf_counter) at the stretch's start and end, and when
    #: the trace had been read (the harness's own work after the stretch)
    host_start: float = 0.0
    host_end: float = 0.0
    host_done: float = 0.0
    #: program range name -> durations (s) of those inside the stretch
    spans: dict = field(default_factory=dict)
    #: program range name -> device seconds of each of those ranges: the
    #: kernels and copies whose launch (matched by correlation id) lies
    #: inside the range on its thread
    device_by_span: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _profiler():
    """CPU and CUDA activity, on every thread where the installed torch
    can: without it, the kernels of the thread the profiler did not
    follow were missing from the trace in 2 of 12 traced runs on the
    card."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        cfg = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return torch.profiler.profile(activities=activities)
    return torch.profiler.profile(activities=activities, experimental_config=cfg)


def warm_profiler(device) -> None:
    """Start and stop a throwaway profiler over one op on ``device``, in
    set-up: the first start in a process loads CUPTI, which took 7-15 s
    on the card, and would otherwise stall the window's calls."""
    with _profiler():
        torch.ones(1, device=device).add_(1)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()


class Stretch:
    """The profiler from the window's share ``start`` on, for ``seconds``
    after it was asked to start (or to the window's end), driven by the
    loop's ``tick`` and ``close``; ``result`` holds the reduced trace
    once it has stopped. ``result.host_start`` is taken before the
    profiler is built, so every call that its start can delay lies
    after it."""

    def __init__(self, start: float, seconds: float):
        self.start, self.seconds = start, seconds
        self.result = None
        self._prof = self._mark = None
        self._host_start = 0.0

    def tick(self, win, now: float) -> None:
        if self.result is not None:
            return
        if self._prof is None and now >= win.t0 + self.start * win.seconds:
            self._host_start = time.perf_counter()
            self._prof = _profiler()
            self._prof.__enter__()
            self._mark = torch.profiler.record_function(MARK)
            self._mark.__enter__()
        elif self._prof is not None and now >= self._host_start + self.seconds:
            self.close()

    def close(self) -> None:
        if self._prof is None or self.result is not None:
            return
        host_end = time.perf_counter()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = self._mark = None
        self.result = reduce_events(events)
        self.result.host_start, self.result.host_end = self._host_start, host_end
        self.result.host_done = time.perf_counter()


def _merge(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_events(events: list) -> Trace:
    """A Chrome trace's complete events (``ph`` "X", times in us) reduced
    over the ``MARK`` range."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    mark = next((e for e in complete if e.get("name") == MARK), None)
    if mark is None:
        return Trace()
    w0, w1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
    device, host, spans, op_time = [], [], {}, {}
    launches, by_corr, ranges = {}, {}, []
    for e in complete:
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            a, b = max(t0, w0), min(t1, w1)
            if b > a:
                device.append((a, b))
                op_time[e["name"]] = op_time.get(e["name"], 0.0) + (b - a) * 1e-6
            if corr is not None:
                by_corr[corr] = by_corr.get(corr, 0.0) + (t1 - t0) * 1e-6
        elif cat in HOST_CATS and e["name"] != MARK:
            host.append((t0, t1, e["name"]))
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = (e.get("tid"), t0)
            if cat == "user_annotation" and t0 >= w0 and t1 <= w1:
                spans.setdefault(e["name"], []).append((t1 - t0) * 1e-6)
                ranges.append((e.get("tid"), t0, t1, e["name"]))
    busy = _merge(device)
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < w1:
        gaps.append((at, w1))
    out = Trace(window_s=(w1 - w0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                spans=spans, device_by_span=_device_by_range(ranges, launches, by_corr))
    out.device_ops = [[n, s] for n, s in sorted(op_time.items(), key=lambda x: -x[1])[:TOP]]
    out.idle_gaps = _gaps_by_host(gaps, host)
    return out


def _device_by_range(ranges: list, launches: dict, by_corr: dict) -> dict:
    """Range name -> device seconds of each range: the device work whose
    launch lies inside the range on the range's thread (ranges of one
    name on one thread do not overlap)."""
    per = {}
    for tid, t0, t1, name in ranges:
        per.setdefault((tid, name), []).append([t0, t1, 0.0])
    for lst in per.values():
        lst.sort()
    for corr, (tid, ts) in launches.items():
        seconds = by_corr.get(corr)
        if seconds is None:
            continue
        for (rtid, _), lst in per.items():
            if rtid != tid:
                continue
            i = bisect.bisect_right(lst, [ts, float("inf"), 0.0]) - 1
            if i >= 0 and lst[i][0] <= ts <= lst[i][1]:
                lst[i][2] += seconds
    out: dict = {}
    for (_, name), lst in per.items():
        out.setdefault(name, []).extend(r[2] for r in lst)
    return out


def _gaps_by_host(gaps: list, host: list) -> list:
    """Idle seconds by the shortest host event covering each gap's middle
    (a sweep over events sorted by start)."""
    host.sort()
    by_name: dict = {}
    active: list = []  # heap of (end, duration, name)
    i = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            t0, t1, name = host[i]
            heapq.heappush(active, (t1, t1 - t0, name))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = min(active, key=lambda x: x[1])[2] if active else "(no host event)"
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    return [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:TOP]]
