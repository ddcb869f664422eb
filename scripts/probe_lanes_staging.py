"""What the staging of the tensor-core scan body (vectorlite_tpu_torch/csrc/
scan_mma.cuh) costs K7 and K8, on one CUDA card.

    python3 scripts/probe_lanes_staging.py [--seed S]

Builds csrc/lanes.cu again with the body's source edited, one variant at a
time, and times K8 `none` and `full` (W 2, tile 16,384) and K7 (cosine,
W 2, tile 16,384) at the headline shape (2^20 x 384 bf16 rows, B 256)
with CUDA events, the unedited body first and last. The variants are
instruments, not kernels, and most compute wrong results:

* stages 2 / 3: a ring of at most 2 / 3 stages a warpgroup (4 at D 384);
* same rows: every TMA copy reads the tile's first 128 rows (L2 hits);
* no staging: after the first ring of stages no copy and no wait (the
  contraction and the selection alone);
* copies, no waits: the copies run, the warpgroups never wait for them;
* waits, no copies: the barriers complete with no data behind them.

Prints a line a variant, the card's name and power limit, and a JSON
object last. Exits 1 without a CUDA device. The variants build with the
package's nvcc flags into vectorlite_tpu_torch/csrc/build/.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

WAIT = "if (stage_tx != 0) mbar_wait(full0 + 8 * st, (j / stages) & 1);"
REFILL = "if (wtid == 0 && j >= 1 && j - 1 + stages < steps) issue(j - 1 + stages);"
STAGES = "constexpr int MAX_STAGES = 8;"
ROW = ("static_cast<int>(tile_base + static_cast<long long>(j / slices) * CHUNK +\n"
       "                                   wg * WG_ROWS),")
COPY = "    mbar_expect_tx(bar, stage_tx);\n    if (tma)\n"
FIRST_WAIT = "if (stage_tx != 0 && j < stages) mbar_wait(full0 + 8 * st, (j / stages) & 1);"

VARIANTS = {
    "stages 2": [(STAGES, "constexpr int MAX_STAGES = 2;")],
    "stages 3": [(STAGES, "constexpr int MAX_STAGES = 3;")],
    "same rows": [(ROW, "wg * WG_ROWS,")],
    "no staging": [(WAIT, FIRST_WAIT), (REFILL, "")],
    "copies, no waits": [(WAIT, FIRST_WAIT)],
    "waits, no copies": [(COPY, "    mbar_arrive(bar);\n    if (false)\n")],
}


def build_variant(_build, name, edits):
    """lanes.cu with scan_mma.cuh edited, built once per edit and flags."""
    body = (_build.CSRC / "scan_mma.cuh").read_text()
    for old, new in edits:
        if old not in body:
            raise RuntimeError(f"variant {name!r}: the body no longer holds {old!r}")
        body = body.replace(old, new)
    digest = hashlib.sha256(
        body.encode() + (_build.CSRC / "lanes.cu").read_bytes()
        + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"liblanes_probe_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            for src in (*_build.CSRC.glob("*.cuh"), _build.CSRC / "lanes.cu"):
                shutil.copy(src, tmp)
            Path(tmp, "scan_mma.cuh").write_text(body)
            part = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(part),
                            str(Path(tmp, "lanes.cu"))], check=True, capture_output=True)
            os.replace(part, out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_lanes_staging: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric
    from vectorlite_tpu_torch.kernels import _build, decompose, merge

    card = cs.card_line()
    libs = {"body": _build.load("lanes")}
    for name, edits in VARIANTS.items():
        libs[name] = ctypes.CDLL(str(build_variant(_build, name, edits)))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng([args.seed, 8])
    n, d, b = 1 << 20, cs.D, cs.B
    v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    sq = (v * v).sum(-1)
    v = v.to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    runs = {
        "K8 none": lambda: decompose.fold_probe_cuda(v, q, mode="none", tile_n=16384),
        "K8 full": lambda: decompose.fold_probe_cuda(v, q, mode="full", tile_n=16384),
        "K7 W 2": lambda: merge.merge_topw_cuda(v, sq, valid, q, metric=SimilarityMetric.COSINE,
                                                winners=2, tile_n=16384),
    }
    out = {}
    for name in ("body", *VARIANTS, "body again"):
        _build._libs["lanes"] = libs[name.removesuffix(" again")]
        ms = {run: cs.cuda_time_ms(fn, 10) for run, fn in runs.items()}
        out[name] = ms
        cs.log(f"  {name:18s} " + "  ".join(f"{run} {t:.4f} ms" for run, t in ms.items())
               + f" [{card}]")
    _build._libs["lanes"] = libs["body"]
    print(card, flush=True)
    print(json.dumps({"card": card, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
