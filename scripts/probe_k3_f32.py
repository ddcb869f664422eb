"""K3 over f32 rows on its two bodies, each timed in a process of its own,
on one CUDA card.

    env PYTHONPATH=. python3 scripts/probe_k3_f32.py [--rows N] [--seed S]

At the main path's shape (--rows, 2^20 by default, x 384 N(0, 1) rows, B
256, tiles of 4,096 rows, cosine, every row valid) it builds csrc/lanes.cu
and csrc/scan.cu into vectorlite_tpu_torch/csrc/build/ and prints ptxas's
lines for the 3xTF32 TOPW kernel (lanes_kernel<float, TOPW, W>, W 1-3:
scan_block_topw_tf32 and K7's scan_merge_topw over f32 rows share it,
their flags taken at run time). Then, each in a process of its own and in
the order CUDA-core, 3xTF32, 3xTF32, CUDA-core: the CUDA-core
scan_block_topw (csrc/scan.cu) at W 1-4 and the tensor-core
scan_block_topw_tf32 (csrc/lanes.cu) at W 1-3, through
kernels/scan.py block_topw_cuda (the CUDA-core process sets
MMA_MAX_WINNERS[float32] to 0 so that every W takes that body), each W
held once against block_topw_plain (the pool's top 128 under the 1e-5
rule of chip_smoke.py) and timed with CUDA events over 20 launches after a
warm one. Prints a line an entry and W with the bound (three tf32 passes,
chip_smoke.py's pricing), the card's name and power limit, and a JSON
object last. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ENTRIES = {"core": (1, 2, 3, 4), "tf32": (1, 2, 3)}
ORDER = ("core", "tf32", "tf32", "core")
TILE = 4096
POOL = 128
REPS = 20


def run_entry(entry: str, n: int, seed: int) -> dict:
    """One process's timings: {W: ms} for ``entry``."""
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric, disable_tf32
    from vectorlite_tpu_torch.kernels import scan

    if entry == "core":
        scan.MMA_MAX_WINNERS[torch.float32] = 0
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.standard_normal((n, cs.D), dtype=np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((cs.B, cs.D), dtype=np.float32)).to(dev)
    sq = (v * v).sum(-1)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    disable_tf32()
    out = {}
    for w in ENTRIES[entry]:
        kernel = scan.block_route(torch.float32, w)

        def fn(w=w):
            return scan.block_topw_cuda(v, None, sq, valid, q, metric=SimilarityMetric.COSINE,
                                        tile_n=TILE, winners=w)
        got = fn()
        torch.cuda.synchronize()
        want = scan.block_topw_plain(v, None, sq, valid, q, metric=SimilarityMetric.COSINE,
                                     tile_n=TILE, winners=w)
        cs.compare(f"{kernel.symbol} W {w} (top {POOL})", cs.merged(scan, got, cs.B, POOL),
                   cs.merged(scan, want, cs.B, POOL + 1))
        del got, want
        out[w] = cs.cuda_time_ms(fn, REPS)
        cs.log(f"  {kernel.symbol:22s} W {w}: {out[w]:.4f} ms")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--entry", choices=sorted(ENTRIES), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k3_f32: no CUDA device is available", file=sys.stderr)
        return 1
    if args.entry:
        print(json.dumps(run_entry(args.entry, args.rows, args.seed)), flush=True)
        return 0
    from vectorlite_tpu_torch.kernels import _build

    card = cs.card_line()
    cs.log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    _build.build_all(["scan", "lanes"])
    # ptxas names a kernel where it starts compiling it and above its
    # stack frame; its spills and registers follow within two lines
    lines = [x.strip() for x in _build.build_logs.get("lanes", "").splitlines()]
    for i, line in enumerate(lines):
        if "lanes_kernelIfLi0E" in line:
            cs.log("  lanes ptxas: " + " | ".join(lines[i:i + 3]))
    runs = {name: {w: [] for w in ws} for name, ws in ENTRIES.items()}
    for name in ORDER:
        cs.log(f"[{name}] in a process of its own")
        proc = subprocess.run(
            [sys.executable, __file__, "--entry", name, "--rows", str(args.rows),
             "--seed", str(args.seed)], capture_output=True, text=True, check=False)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise RuntimeError(f"the {name} process failed ({proc.returncode})")
        for w, ms in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            runs[name][int(w)].append(ms)
    n = args.rows
    dot_ops = 2.0 * cs.B * n * cs.D
    side = n * 4 + n * 1 + cs.B * cs.D * 4
    result = {"card": card, "rows": n, "d": cs.D, "b": cs.B, "tile_n": TILE, "ms": runs,
              "bound_ms": {}}
    for w in ENTRIES["core"]:
        nbytes = n * cs.D * 4 + side + cs.B * (n // TILE) * w * 128 * 8
        b = cs.bound(nbytes, 3 * dot_ops, "tf32")
        result["bound_ms"][w] = b["bound_ms"]
        line = " ".join(f"{name} {' / '.join(f'{x:.4f}' for x in runs[name][w])} ms"
                        for name in ENTRIES if w in runs[name])
        cs.log(f"W {w}: {line}; bound {b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]")
    print(card, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
