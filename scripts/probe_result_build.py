"""What building a batch search's ``SearchResult`` lists costs on the host:
the per-hit loop ``FlatIndex.search_batch`` once ran (one numpy scalar at
a time) against ``FlatIndex._hit_lists`` (whole-array conversions), over
a Flat index of ``--rows`` rows with one ``{"pos": i}`` dict a row or
with no metadata, as the benchmark's two deployments hold them.

    env PYTHONPATH=. python3 scripts/probe_result_build.py [--rows N] [--calls N]

Needs no card (~1-2 min at 1M rows). For each metadata kind, B 1,000 /
256 / 1 and k 10 / 100: milliseconds a build of sorted random f32 scores
and random slots, old and new in turns with the collector off (min and
median of ``--repeat``), and whether the two builds agree (ids, scores,
texts equal; each metadata the same object). Then, under the collector's
default thresholds, full (generation 2) collections in ``--calls``
builds of B 1,000 x k 10 each, old, new, new, old, the caller holding
each call's lists until the next call, as a closed-loop caller does.
Prints one JSON line."""

from __future__ import annotations

import argparse
import gc
import json
import os
import platform
import statistics
import sys
import time

import numpy as np

from vectorlite_tpu_torch.core.types import SearchResult
from vectorlite_tpu_torch.index.flat import FlatIndex

SHAPES = [(1000, 10), (1000, 100), (256, 10), (256, 100), (1, 10), (1, 100)]


def per_hit(index, scores, slots):
    """The build as it was: one numpy scalar at a time."""
    out = []
    for row_scores, row_slots in zip(scores, slots):
        hits = []
        for s, slot in zip(row_scores, row_slots):
            if s == -np.inf:
                break
            hits.append(
                SearchResult(
                    id=int(index._ids[slot]),
                    score=float(s),
                    text=index._texts[slot] or "",
                    metadata=index._metas[slot],
                )
            )
        out.append(hits)
    return out


def make_index(rows: int, metadata: bool) -> FlatIndex:
    index = FlatIndex(4, device="cpu")
    index.add_batch_arrays(
        list(range(rows)), np.zeros((rows, 4)),
        metadatas=[{"pos": i} for i in range(rows)] if metadata else None,
    )
    return index


def make_hits(rng, rows: int, b: int, k: int):
    """Sorted f32 scores and distinct slots a row, as the device path
    hands them over."""
    scores = -np.sort(-rng.random((b, k), dtype=np.float32), axis=1)
    slots = np.stack([rng.choice(rows, k, replace=False) for _ in range(b)])
    return scores, slots


def same(a, b) -> bool:
    return [len(r) for r in a] == [len(r) for r in b] and all(
        type(x.id) is type(y.id) is int and type(x.score) is type(y.score) is float
        and (x.id, x.score, x.text) == (y.id, y.score, y.text) and x.metadata is y.metadata
        for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def time_builds(index, scores, slots, repeat: int) -> dict:
    ms = {"old": [], "new": []}
    gc.disable()
    try:
        for _ in range(repeat):
            for name, build in (("old", per_hit), ("new", FlatIndex._hit_lists)):
                t0 = time.perf_counter()
                out = build(index, scores, slots)
                ms[name].append((time.perf_counter() - t0) * 1e3)
                del out
    finally:
        gc.enable()
    return {name: {"min_ms": min(v), "median_ms": statistics.median(v)} for name, v in ms.items()}


def full_passes(index, scores, slots, calls: int, build) -> int:
    """Generation-2 collections over ``calls`` builds, each call's lists
    held until the next one replaces them."""
    n = [0]

    def count(phase, info):
        if phase == "start" and info["generation"] == 2:
            n[0] += 1

    gc.collect()
    gc.callbacks.append(count)
    try:
        held = None
        for _ in range(calls):
            held = build(index, scores, slots)
        del held
    finally:
        gc.callbacks.remove(count)
    return n[0]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=1_000_000)
    p.add_argument("--calls", type=int, default=100, help="builds a full-pass count covers")
    p.add_argument("--repeat", type=int, default=7)
    p.add_argument("--seed", type=int, default=2**31 + 22)
    args = p.parse_args()
    rng = np.random.default_rng(args.seed)
    out = {"python": sys.version.split()[0], "numpy": np.__version__,
           "machine": platform.machine(), "cpus": os.cpu_count(), "rows": args.rows,
           "gc_threshold": gc.get_threshold(), "calls": args.calls}
    for metadata in (True, False):
        index = make_index(args.rows, metadata)
        kind = "pos_dicts" if metadata else "none"
        timed = {}
        for b, k in SHAPES:
            scores, slots = make_hits(rng, args.rows, b, k)
            timed[f"b{b}_k{k}"] = dict(
                time_builds(index, scores, slots, args.repeat),
                equal=same(per_hit(index, scores, slots), FlatIndex._hit_lists(index, scores, slots)))
        scores, slots = make_hits(rng, args.rows, 1000, 10)
        passes = {f"{i}_{name}": full_passes(index, scores, slots, args.calls, build)
                  for i, (name, build) in enumerate((("old", per_hit), ("new", FlatIndex._hit_lists),
                                                     ("new", FlatIndex._hit_lists), ("old", per_hit)))}
        out[kind] = {"builds": timed, "full_passes": passes}
        del index
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
