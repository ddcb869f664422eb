"""How many lanes should share a row in K5's look-up entry
(vectorlite_tpu_torch/csrc/pq.cu `pq_rank`), on one CUDA card.

    python3 scripts/probe_pq_lookup.py [--seed S]

The entry keeps the LUT in bf16 in shared memory as [m][table row][Q
queries]; LPR lanes share a row, each loading 8 queries' entries (Q = 8
LPR), and a thread keeps RT rows x 8 queries of sums. The rows of a
quarter-warp read entries at random codes and collide in the banks when
their codes agree mod 8 / LPR, so a larger LPR has fewer conflicts but
fewer rows a block (the stages grow with Q), and the LUT streams from L2
more often. This builds csrc/pq.cu again with LPR and RT edited, one
variant at a time (one nvcc each, all started together, the package's
nvcc flags, into vectorlite_tpu_torch/csrc/build/), holds each against
the plain rank and times it at the 8-bit path's chunk (2^16 rows, M 96, kc
256, B 256, cosine) with CUDA events, the entry as built first and last;
with the shared-memory bound (the look-ups' 2 bytes each at the SMs'
shared-memory rate). Prints a line a variant, the card's name and power
limit, and a JSON object last. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
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

LPR = "constexpr int LPR = 4;"
RT = "constexpr int RT = 16;"

#: (LPR, RT): 2,048 rows a block at LPR 1 and 2 (64 and 128 sums a
#: thread); the entry as built is LPR 4, RT 16 (1,024 rows)
VARIANTS = {"LPR 1": (1, 8), "LPR 2": (2, 16)}


def build_variant(_build, lpr: int, rt: int) -> Path:
    """pq.cu with LPR and RT replaced, built once per edit and flags."""
    body = (_build.CSRC / "pq.cu").read_text()
    for old in (LPR, RT):
        if old not in body:
            raise RuntimeError(f"pq.cu no longer holds {old!r}")
    body = body.replace(LPR, f"constexpr int LPR = {lpr};").replace(
        RT, f"constexpr int RT = {rt};")
    digest = hashlib.sha256(
        body.encode() + (_build.CSRC / "hopper.cuh").read_bytes()
        + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libpq_probe_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            shutil.copy(_build.CSRC / "hopper.cuh", tmp)
            Path(tmp, "pq.cu").write_text(body)
            part = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(part),
                            str(Path(tmp, "pq.cu"))], check=True, capture_output=True)
            os.replace(part, out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_pq_lookup: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric
    from vectorlite_tpu_torch.kernels import _build, pq

    card = cs.card_line()
    lib = _build.load("pq")
    libs = {f"LPR {pq.lookup_query_tile(lib) // 8} (built)": lib}
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = {name: pool.submit(build_variant, _build, *v) for name, v in VARIANTS.items()}
    for name, path in built.items():
        libs[name] = ctypes.CDLL(str(path.result()))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng([args.seed, 5])
    n, m, kc, b = 1 << 16, cs.D // 4, 256, cs.B
    cos = SimilarityMetric.COSINE
    lut, codes, sq, valid = cs.pq_inputs(pq, dev, rng, n, cs.D, m, kc, b, False, cos)
    want = pq.pq_rank_plain(lut, codes, sq, valid, metric=cos, packed=False)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def runner(lib):
        fn = lib.pq_rank
        fn.argtypes = pq.PQ_RANK.argtypes
        fn.restype = ctypes.c_int
        lut_t = pq.lookup_lut_operand(lut, False, pq.lookup_query_tile(lib))
        out = torch.empty((b, n), dtype=torch.float32, device=dev)

        def run():
            err = fn(lut_t.data_ptr(), codes.data_ptr(), sq.data_ptr(), valid.data_ptr(),
                     out.data_ptr(), n, b, lut_t.shape[1], m, 0, pq._METRIC_CODE[cos], stream)
            if err:
                raise RuntimeError(f"pq_rank: CUDA error {err}")
            return out
        return run

    bound = 2.0 * b * n * m / cs.SMEM_BYTES_PER_S * 1e3
    names = [*libs, next(iter(libs))]
    out = {}
    for i, name in enumerate(names):
        run = runner(libs[name])
        label = name if i < len(names) - 1 else f"{name} again"
        cs.compare_rank(f"pq_rank {label}", run(), want)
        out[label] = cs.cuda_time_ms(run, 20)
        cs.log(f"  {label:22s} {out[label]:.4f} ms (shared-memory bound {bound:.4f} ms) "
               f"[{card}]")
    print(card, flush=True)
    print(json.dumps({"card": card, "smem_bound_ms": bound, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
