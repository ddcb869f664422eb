"""What the port's tracing ranges cost on the card: one ``profile_span``
with no profiler on and under the benchmark's profiler (CPU and CUDA
activity, every thread), and a cell's SDK call timed in turns with the
profiler off and on; for the blocks under the profiler, each program
range's count and mean length a call and the card's idle time it held.

    env PYTHONPATH=. python3 scripts/probe_span_cost.py [--workload NAME] [--calls N]

From the root of a checkout on a machine with the card (~1-2 min at 1M
rows); ``--device cpu --rows 20000`` rehearses it on the CPU. Prints one
JSON line: microseconds a range, and milliseconds a call with queries
per second for each block of calls."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import torch

from benchmark import data, spec, system, trace
from benchmark.loops import closed
from benchmark.run import card_line


def range_us(n: int, profiled: bool, raw: bool = False) -> float:
    """Mean microseconds of an empty ``profile_span`` (or, with ``raw``,
    of a bare ``record_function``)."""
    from vectorlite_tpu_torch.observability import profile_span

    span = torch.profiler.record_function if raw else profile_span

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with span("vectorlite.probe"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    if not profiled:
        return loop()
    with trace._profiler():
        return loop()


def program_ranges(prof, calls: int) -> dict:
    """From the block's Chrome trace, for each program range (host side):
    how many a call, their mean milliseconds, and the card's idle
    milliseconds a call that it held innermost, split by time (the
    benchmark's reduction charges a whole gap to the event at its
    middle). Idle is counted from the first range's start to the last
    one's end; "(no range)" is idle outside every range."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    finally:
        os.unlink(path)
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith("vectorlite."))
    if not ranges:
        return {}
    busy = trace._merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                         if e.get("cat") in trace.DEVICE_CATS])
    w0, w1 = ranges[0][0], max(r[1] for r in ranges)
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, w1)))
        at = max(at, b)
    if at < w1:
        gaps.append((at, w1))
    cuts = sorted({t for r in ranges for t in r[:2]} | {t for g in gaps for t in g})
    idle: dict = {}
    for a, b in gaps:
        for lo, hi in zip(cuts, cuts[1:]):
            if hi <= a or lo >= b:
                continue
            lo, hi = max(lo, a), min(hi, b)
            inner = [r for r in ranges if r[0] <= lo and hi <= r[1]]
            name = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "(no range)"
            idle[name] = idle.get(name, 0.0) + (hi - lo) / 1e3
    out = {}
    for name in sorted({r[2] for r in ranges} | set(idle)):
        lengths = [r[1] - r[0] for r in ranges if r[2] == name]
        out[name] = {"a_call": len(lengths) / calls,
                     "mean_ms": statistics.fmean(lengths) / 1e3 if lengths else 0.0,
                     "idle_ms_a_call": idle.get(name, 0.0) / calls}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="cohere768.batch1k.k10")
    p.add_argument("--calls", type=int, default=40)
    p.add_argument("--blocks", type=int, default=5, help="off, on, off, ... in turns")
    p.add_argument("--seed", type=int, default=2**31 + 21)
    p.add_argument("--rows", type=int, help="cut the deployment (a rehearsal on the CPU)")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    out = {"torch": torch.__version__, "card": card_line(), "profiler_flag": hasattr(torch.autograd.profiler, "_is_profiler_enabled")}
    trace.warm_profiler(device)
    out["range_us"] = {
        "off": range_us(200_000, False), "off_record_function": range_us(200_000, False, True),
        "on": range_us(20_000, True), "on_record_function": range_us(20_000, True, True)}

    cell = spec.load_cell(args.workload)
    if args.rows:
        cell.config = dict(cell.config, rows=args.rows)
    made = data.make_data(cell.config, int(cell.traffic["query_pool"]), args.seed, device)
    sut = system.SdkSystem(cell.config, cell.traffic, made.rows, made.metadata, device, {})
    batch = int(cell.traffic["batch"])
    closed.warm(sut.call, cell.traffic, made.queries)
    pos = 0

    def calls() -> list:
        nonlocal pos
        ms = []
        for _ in range(args.calls):
            rows = closed._batch(len(made.queries), pos, batch)
            pos += batch
            t0 = time.perf_counter()
            sut.call(made.queries[rows])
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    blocks = []
    for i in range(args.blocks):
        if i % 2 == 0:
            ms, ranges = calls(), None
        else:
            with trace._profiler() as prof:
                ms = calls()
            ranges = program_ranges(prof, args.calls)
        blocks.append({"profiler": i % 2 == 1, "mean_ms": statistics.fmean(ms),
                       "median_ms": statistics.median(ms),
                       "qps": batch * len(ms) / (sum(ms) / 1e3), "ranges": ranges})
    out["workload"], out["calls_a_block"], out["blocks"] = args.workload, args.calls, blocks
    sut.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
