"""The readings a cell's limits are set from, in one process.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,... \\
        --control-seeds 101,102,103 --seconds 3 [--out FILE]

For each seed of ``--seeds`` it makes the cell's data, builds the
program through the SDK, warms it, drives the cell's own loop for a
short window and judges the window's sampled answers as a benchmark run
does; for each of ``--control-seeds`` it does the same with the TF32
control (``control.py``) in the program's place. One JSON line a seed
(``side`` program or control, the comparison's numbers) goes to
standard output and, with ``--out``, to that file. The limits in
``limits/<workload>.json`` lie between the program's largest and the
control's smallest reading of each number (``PERF.md`` gives them).
Needs the card.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys

import torch

from . import compare, control, data, spec, system


def readings(cell, seed: int, side: str, seconds: float, device) -> dict:
    loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
    made = data.make_data(cell.config, int(cell.traffic["query_pool"]), seed, device)
    if side == "program":
        sut = system.SdkSystem(cell.config, cell.traffic, made.rows, made.metadata, device, {})
    else:
        sut = control.Tf32System(cell.config, cell.traffic, made.rows, device)
    loop.warm(sut.call, cell.traffic, made.queries)
    win = loop.drive(sut.call, cell.traffic, made.queries, seconds, seed)
    sut.close()
    del sut
    gc.collect()
    torch.cuda.empty_cache()
    numbers = compare.judge_samples(win.samples, made.queries, made.rows, cell.config,
                                    cell.traffic, device)
    ok, _ = compare.verdict(numbers, cell.limits)
    return {"workload": cell.name, "side": side, "seed": seed, "calls": len(win.calls),
            "failed": sum(1 for *_, good in win.calls if not good),
            "within_limits": ok, **numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    plan = [("program", int(s)) for s in args.seeds.split(",") if s]
    plan += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a", encoding="utf-8") if args.out else None
    try:
        for side, seed in plan:
            line = json.dumps(readings(cell, seed, side, args.seconds, device))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
