"""The trace reduction on a synthetic Chrome trace: busy time is the
union of device intervals inside the marked stretch, the program's
ranges are those inside it, and each idle gap goes to the shortest host
event covering its middle."""

import pytest

from benchmark import trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_events():
    events = [
        ev("user_annotation", trace.MARK, 1000, 1000),  # stretch [1000, 2000) us
        ev("kernel", "k1", 900, 300),  # clipped to [1000, 1200)
        ev("kernel", "k1", 1100, 200),  # overlaps: union [1000, 1300)
        ev("gpu_memcpy", "Memcpy DtoH", 1500, 100),  # [1500, 1600)
        ev("gpu_user_annotation", "vectorlite.index.search_batch", 1000, 900),  # not busy
        ev("user_annotation", "vectorlite.index.search_batch", 1050, 600),
        ev("user_annotation", "vectorlite.index.search_batch", 1900, 400),  # ends outside
        ev("cpu_op", "aten::copy_", 1350, 100),  # covers gap [1300, 1500)'s middle 1400
        ev("cuda_runtime", "cudaEventSynchronize", 1610, 380),  # gap [1600, 2000) middle 1800
        {"ph": "i", "name": "instant"},
    ]
    t = trace.reduce_events(events)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx(400e-6)
    assert t.spans == {"vectorlite.index.search_batch": [pytest.approx(600e-6)]}
    assert t.device_ops == [["k1", pytest.approx(400e-6)],  # each launch's own time
                            ["Memcpy DtoH", pytest.approx(100e-6)]]
    assert dict(t.idle_gaps) == {"cudaEventSynchronize": pytest.approx(400e-6),
                                 "aten::copy_": pytest.approx(200e-6)}


def test_no_mark_reads_nothing():
    t = trace.reduce_events([ev("kernel", "k", 0, 10)])
    assert t.busy_s == 0 and t.window_s == 0


def test_device_time_goes_to_the_range_that_launched_it():
    events = [
        ev("user_annotation", trace.MARK, 0, 1000),
        ev("user_annotation", "call", 10, 100, tid=1),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 5, tid=1, corr=7),
        ev("kernel", "k", 50, 40, tid=99, corr=7),
        # launched by another thread inside the range's time: not the range's
        ev("cuda_runtime", "cudaLaunchKernel", 30, 5, tid=2, corr=8),
        ev("kernel", "k", 95, 30, tid=99, corr=8),
        ev("user_annotation", "call", 300, 100, tid=1),
        ev("cuda_runtime", "cudaMemcpyAsync", 310, 5, tid=1, corr=9),
        ev("gpu_memcpy", "Memcpy DtoH", 320, 10, tid=99, corr=9),
        ev("gpu_memset", "Memset", 330, 10, tid=99, corr=9),
    ]
    t = trace.reduce_events(events)
    assert t.device_by_span["call"] == [pytest.approx(40e-6), pytest.approx(20e-6)]
    assert t.busy_s == pytest.approx(90e-6)


def test_stretch_clock_starts_before_the_profiler(monkeypatch):
    """Every call that the profiler's start can delay lies after
    ``host_start``, so the tail leaves it out; the warm-up's throwaway
    profiler runs in set-up."""
    import time
    from types import SimpleNamespace

    import torch

    built = []
    real = trace._profiler

    def slow():
        built.append(time.perf_counter())
        time.sleep(0.05)
        return real()

    trace.warm_profiler("cpu")
    monkeypatch.setattr(trace, "_profiler", slow)
    win = SimpleNamespace(t0=time.perf_counter(), seconds=1.0)
    stretch = trace.Stretch(0.0, 0.0)
    stretch.tick(win, time.perf_counter())
    torch.ones(4).add_(1)
    stretch.tick(win, time.perf_counter())
    assert stretch.result is not None and len(built) == 1
    assert stretch.result.host_start <= built[0] <= stretch.result.host_end
