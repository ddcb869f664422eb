"""Run one benchmark cell of the PyTorch and CUDA port and print its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the card. The cell's
deployment, traffic mix, limits and metric readers are found by name
(``spec.py``). A run makes the corpus and queries from the seed on the
card, ingests them through the SDK, warms the cell's shapes, drives the
traffic for ``--seconds``, then judges a seeded sample of the window's
answers against the float64 reference. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer ones, read from a
profiler trace of a steady stretch of the window. The last line of
standard output is one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last
key. Exit codes: 0 a result, 2 no card (or too few), 3 a forbidden
module loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent

#: top-level module names that may not be loaded when the window closes:
#: JAX, its libraries and the JAX package (compared whole, so the port's
#: own name, which begins with the JAX package's, passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "vectorlite_tpu")

#: fixed compile-cache directories inside the checkout (the port builds
#: its kernels into vectorlite_tpu_torch/csrc/build/ already)
CACHE_DIRS = {
    "TRITON_CACHE_DIR": ".bench_cache/triton",
    "TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
    "CUDA_CACHE_PATH": ".bench_cache/cuda",
}

#: the traced run's profiler: from this share of the window on, for
#: this many seconds (or to the window's end)
TRACE_FROM, TRACE_SECONDS = 0.25, 10.0


def process_age() -> float:
    """Seconds since this process started, from the kernel's record."""
    with open("/proc/self/stat", encoding="ascii") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime", encoding="ascii") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


@dataclass
class Record:
    """What the metric readers read."""

    cell: object
    window: object = None
    trace: object = None
    timings: dict = field(default_factory=dict)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def _full_gc_timer(pauses: list):
    """A ``gc.callbacks`` entry that appends each full (generation 2)
    collection's seconds to ``pauses``: a diagnostic for standard error."""
    began = [0.0]

    def callback(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                began[0] = time.perf_counter()
            else:
                pauses.append(time.perf_counter() - began[0])

    return callback


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, *,
             started: float, system_factory=None) -> dict:
    """One run of ``cell`` on ``device``; the result's dict. ``started``
    is the perf_counter reading at process start. ``system_factory``
    (tests) replaces the SDK system built from the cell."""
    import torch

    from . import compare, data, spec, system, trace as tracing

    loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
    on_card = torch.device(device).type == "cuda"
    record = Record(cell=cell)

    made = data.make_data(cell.config, int(cell.traffic["query_pool"]), seed, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    factory = system_factory or system.SdkSystem
    sut = factory(cell.config, cell.traffic, made.rows, made.metadata, device, record.timings)
    loop.warm(sut.call, cell.traffic, made.queries)
    if trace:
        tracing.warm_profiler(device)
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
    record.timings["setup_s"] = time.perf_counter() - started
    log(f"set-up {record.timings['setup_s']:.3f} s (ingest {record.timings.get('load_s', 0):.3f} s)")

    stretch = tracing.Stretch(TRACE_FROM, TRACE_SECONDS) if trace else None
    pauses = []
    gc.callbacks.append(_full_gc_timer(pauses))
    try:
        record.window = win = loop.drive(sut.call, cell.traffic, made.queries, seconds, seed,
                                         stretch)
    finally:
        gc.callbacks.pop()
    record.trace = stretch.result if stretch else None
    lat = sorted(end - issued for _, issued, end, _, _ in win.calls)
    if lat:
        pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))] * 1e3  # noqa: E731
        log(f"window: {len(lat)} calls, ms p50 {pick(0.5):.3f} p95 {pick(0.95):.3f} "
            f"p99 {pick(0.99):.3f} max {lat[-1] * 1e3:.3f}; {len(pauses)} full GC passes, "
            f"{sum(pauses) * 1e3:.1f} ms in all, longest {max(pauses, default=0) * 1e3:.1f} ms")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    sut.close()
    del sut
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    numbers = compare.judge_samples(win.samples, made.queries, made.rows, cell.config,
                                    cell.traffic, device)
    ok, checks = compare.verdict(numbers, cell.limits)
    attempted = sum(q for *_, q, _ in win.calls)
    failed = sum(q for *_, q, good in win.calls if not good)
    for e in win.errors[:5]:
        log(f"call failed: {e}")

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.load_reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": bool(ok and failed == 0 and numbers["checked"] > 0),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace and record.trace is not None:
        result["device"]["busy_s"] = record.trace.busy_s
        result["device"]["window_s"] = record.trace.window_s
        result["breakdown"] = {"device_ops": record.trace.device_ops,
                               "idle_gaps": record.trace.idle_gaps}
    result["card"] = card_line() if on_card else "cpu"
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    started = time.perf_counter() - process_age()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(_ROOT / rel)
        os.makedirs(os.environ[var], exist_ok=True)
    from . import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), started=started)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    log(f"card: {result['card']}; peaks: {cell.peaks['card']}")
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
