"""K6 (vectorlite_tpu_torch/csrc/ivf.cu gather_score) beside the form that
streams each probed cell once per batch (scripts/k6_read_once.cu), on one
CUDA card.

    python3 scripts/probe_k6_read_once.py [--seed S]

At chip_smoke.py's IVF shape (C 4,096, P 640, D 384, B 64, L 16), on bf16
and int8 cells and with the smoke's three id patterns (random; shared:
every query probes the same L cells; one: every pair probes one cell), both
kernels are held against gather_score_plain (|diff| <= 1e-5 * max(1, max
|out|)) and timed with CUDA events in the order K6, read-once, read-once,
K6. Prints a line a case, the card's name and power limit, and a JSON
object last. Exits 1 without a CUDA device. The variant builds with the
package's nvcc flags into vectorlite_tpu_torch/csrc/build/.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "scripts" / "k6_read_once.cu"


def build_read_once(_build, argtypes):
    """Compile the read-once variant (once per source and flags) and return
    its C entry."""
    flags = " ".join(_build.NVCC_FLAGS).encode()
    digest = hashlib.sha256(SOURCE.read_bytes() + flags).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libk6_read_once_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True)
        os.replace(tmp, out)
    fn = ctypes.CDLL(str(out)).gather_score_read_once
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k6_read_once: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vectorlite_tpu_torch.kernels import _build, ivf

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    read_once = build_read_once(_build, ivf.GATHER_SCORE.argtypes)

    def launch_read_once(rows, ids, q_op):
        b, l_probe = ids.shape
        out = torch.empty((b, l_probe, cs.IVF_P), dtype=torch.float32, device=dev)
        err = read_once(rows.data_ptr(), ids.data_ptr(), q_op.data_ptr(), out.data_ptr(),
                        int(rows.dtype == torch.int8), b, l_probe, cs.IVF_P, rows.shape[1],
                        torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"gather_score_read_once: CUDA error {err} at launch")
        return out

    rng = np.random.default_rng([args.seed, 6])
    cases = []
    for dtype in ("bf16", "int8"):
        for mode in cs.PROBE_IDS:
            rows, ids, q = cs.probe_operands(
                dev, rng, cs.IVF_C, cs.IVF_P, cs.D, cs.IVF_B, cs.IVF_L, dtype, mode)
            q_op = ivf._query_operand(rows, q).contiguous()
            want = ivf.gather_score_plain(rows, ids, q, p_width=cs.IVF_P)

            def k6():
                return ivf.launch_gather_score(rows, ids, q_op, p_width=cs.IVF_P)

            def ro():
                return launch_read_once(rows, ids, q_op)

            cs.compare_probe(f"gather_score {dtype}, {mode} ids", k6(), want)
            cs.compare_probe(f"read-once {dtype}, {mode} ids", ro(), want)
            ro_ms, k6_ms = cs.interleaved_ms(ro, k6, reps=50, plain_reps=50)
            case = {"dtype": dtype, "ids": mode, "distinct_cells": int(torch.unique(ids).numel()),
                    "k6_ms": k6_ms, "read_once_ms": ro_ms,
                    "bound_ms": cs.probe_bound(ids, dtype)["bound_ms"]}
            cases.append(case)
            cs.log(f"  {dtype} {mode:6s} ({case['distinct_cells']} distinct cells): K6 "
                   f"{k6_ms:.4f} ms  read-once {ro_ms:.4f} ms  bound {case['bound_ms']:.4f} ms")
            del rows, want
            torch.cuda.empty_cache()
    print(card, flush=True)
    print(json.dumps({"k6_read_once": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
