"""One phase of chip_smoke.py alone, from the checkout at TREE, on one CUDA
card: phase 3 (the SDK main path at 2^20 x 384, batches of 256), phase
3b (the device mesh, cuda:0 repeated, on phase 3's rows and queries), phase
6 (the merge-engine probe), phase 8 (HTTP on the card, over a guard-on
collection of 2^20 rows with texts and metadata built here in phase 7's
place, beside one coalesced SDK serving run of it) or phase 9 (the MiniLM
embedder and HNSW), with chip_smoke.py's own functions, checks and log
lines. Run it in turns from two checkouts (say a `git archive` of a
parent commit and of its change) to compare their host-side latencies,
which vary more between runs than device times do.

    python3 scripts/smoke_phase.py TREE [--phase 3|3b|6|8|9] [--skip-load NAME]
        [--extra-lib PATH]

--skip-load leaves one native library out of the libraries loaded before
the phase (it then loads at its first use); --extra-lib loads one more
shared library (a glob) into the process first: both test whether a
library's presence moves the phase's numbers. Exits 1 without a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import sys
from types import SimpleNamespace


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree")
    ap.add_argument("--phase", choices=("3", "3b", "6", "8", "9"), default="3")
    ap.add_argument("--skip-load", default="")
    ap.add_argument("--extra-lib", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("smoke_phase: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import vectorlite_tpu_torch as vl
    from vectorlite_tpu_torch import native
    from vectorlite_tpu_torch.kernels import _build, decompose, ivf, merge, scan

    _build.build_all(_build.sources())
    for name in _build.sources():
        if name != args.skip_load:
            _build.load(name)
    if args.extra_lib:
        lib = glob.glob(args.extra_lib)[0]
        ctypes.CDLL(lib)
        print("loaded", lib, flush=True)
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    if args.phase in ("3", "3b"):
        rng = np.random.default_rng(0)
        rows = rng.standard_normal((1 << 20, cs.D), dtype=np.float32)
        queries = rng.standard_normal((cs.B, cs.D), dtype=np.float32).astype(np.float64)
        if args.phase == "3":
            cs.main_path(vl, _build, native.RESCORE, dev, rows, queries, card, 20)
        else:
            import time

            t0 = time.perf_counter()
            print(cs.mesh_path(vl, _build, ivf, dev, rows, queries, card, 0), flush=True)
            print(f"phase 3b {time.perf_counter() - t0:.1f} s", flush=True)
    elif args.phase == "9":
        cs.text_hnsw_path(vl, _build, dev, card, 0)
    elif args.phase == "6":
        cs.headline_path(merge, decompose, scan, _build, vl.SimilarityMetric, dev,
                         SimpleNamespace(rows=1 << 20, seed=0), card)
    else:
        from vectorlite_tpu_torch.observability import coalesce_stats

        rng = np.random.default_rng(0)
        n = 1 << 20
        rows = rng.standard_normal((n, cs.D), dtype=np.float32)
        os.environ["VECTORLITE_SPEED_GUARD"] = "1"
        client, _ = cs.p7_collection(vl, dev, "main", rows, cs.p7_texts(n), cs.p7_metas(n))
        q_texts = [f"request {i}" for i in range(cs.P7_REQUESTS)]
        client.search_text_in_collection("main", q_texts[0], cs.K)  # the device build
        _, _, figures = cs.serve(client, "main", q_texts, _build, coalesce_stats,
                                 "SDK, coalesced, guard on", card)
        cs.http_path(vl, _build, dev, client, rows, card, 0, {"1": figures})
    print(f"phase {args.phase} ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
