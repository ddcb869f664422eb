"""K4's FADD-stream entries (vectorlite_tpu_torch/csrc/l1.cu) on one CUDA
card: held, counted, timed and taken apart.

    env PYTHONPATH=. python3 scripts/probe_l1.py [--seed S] [--check-only]

Builds csrc/l1.cu and csrc/scan.cu and prints ptxas's registers and spills
of the two entries, each launch's ring at D 99, 100, 384 and 768 (stages;
the queries resident or riding the stages), and what cuobjdump -sass finds
in each kernel: its FADDs that add an absolute value (|q - v| + acc), its
other FADDs, its shared-memory loads and all its instructions, beside the
(query, row, dimension) triples one pass of the unrolled word loop covers;
checks the scores' reciprocal (rcp_fast) bit for bit against the exact
division over every f32 of [1, 2^126).
Holds both entries' lists, tile by tile, against tile_topk_plain's under
the 1e-5 rule (scores within rtol/atol 1e-5, ids equal beyond 1e-5
near-ties) at small shapes: k 1, 10, 16 and 32, D 99 (f32 rows TMA
refuses), 100 (bf16 rows TMA refuses), 384 and 768 (the queries ride the
stages), B 3 to 256, duplicate rows, an all-invalid tile. With
--check-only it stops there. Then, at the main-path shape (2^20 x 384, B
256, tile 2,048; f32 rows at k 16, bf16 rows at k 16 and at the
memory-optimized profile's pool of 32), holds each entry once more and
times it with CUDA events beside the CUDA-core scan_topk_l1 of the same
call (old, new, new, old), the bound 2 B N D / 33.5e12 (two FADDs a
(query, row, dimension) at the card's FADD issue rate), and variants of
l1.cu built from edited copies, instruments that compute wrong results:

* no selection: the chunk's scores are neither computed nor listed (a max
  of the sums keeps the FADDs live): what the scores and lists cost;
* scores only: the scores computed, no list seeded or merged;
* no inserts: the lists seeded and every chunk's ballots against the k-th
  entry taken, no row inserted (what the insertions cost);
* no staging: the producer fills the ring once and the compute warps never
  wait on it again (the FADD stream over resident tiles, with the
  selection): what staging costs;
* stream only: neither (the FADD stream and its operand loads alone);
* exact division: the scores by __frcp_rn, whose branches to the slow
  path keep a chunk's 64 reciprocals from overlapping (the entry takes
  its fast path alone, rcp_fast, bit for bit the same over [1, 2^126));
* unroll 2 / 4: the loop over a stage's 16-byte words unrolled 2 or 4
  times (the entry: not unrolled; unrolled 2, 4 and 8 times it ran slower
  on an H100, the body outgrowing the instruction cache: PERF.md).

The SM clock under load (nvidia-smi, read while 200 launches are queued)
is printed beside each case: the bound assumes the 1.98 GHz boost clock.

Prints a line a measurement, the card's name and power limit, and a JSON
object last. Exits 1 without a CUDA device, and raises if an entry
disagrees with its plain version. The variants build (one nvcc each, all
started together) with the package's nvcc flags into
vectorlite_tpu_torch/csrc/build/.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

SELECT = "    if (live) select_chunk(c, ok);\n"
SINK = ("    if (live) {\n      float t = 0.0f;\n#pragma unroll\n"
        "      for (int i = 0; i < WQ; ++i)\n#pragma unroll\n"
        "        for (int j = 0; j < RPL; ++j) t = fmaxf(t, acc[i][j]);\n"
        "      if (t == 1.0e30f) out_s[c] = t + ok;\n    }\n")
# the scores computed, neither seeded nor merged into the lists
LISTS = "    const int r0 = static_cast<int>(row0);\n    if (c == 0) {\n"
NO_LISTS = ("    const int r0 = static_cast<int>(row0);\n    {\n      float t = -1.0f;\n"
            "#pragma unroll\n      for (int i = 0; i < WQ; ++i)\n#pragma unroll\n"
            "        for (int j = 0; j < RPL; ++j) t = fmaxf(t, acc[i][j]);\n"
            "      if (t == 1.0e30f) out_s[r0] = t;\n    }\n    if (false) {\n")
LATER = "    } else {\n      merge_lists<0, false>"
# the scores by the exact division (its branches to the slow path kept)
RCP = "rcp_fast(1.0f + acc[i][j])"
EXACT_RCP = "__frcp_rn(1.0f + acc[i][j])"
# the rows that beat the k-th entry found (ballots) but not inserted
INSERTS = "    while (any_set(m)) {\n"
WAIT = "        mbar_wait(full0 + 8 * st, (j / stages) & 1);\n"
RING_FILL = "    for (int j = 0; tma && j < steps; ++j) {\n"
STATIC_RING = [(WAIT, "        if (j < stages) mbar_wait(full0 + 8 * st, (j / stages) & 1);\n"),
               (RING_FILL, "    for (int j = 0; tma && j < min(steps, stages); ++j) {\n")]
UNROLL = "#pragma unroll 1  // the words of a stage"
VARIANTS = {
    "no selection": [(SELECT, SINK)],
    "scores only": [(LISTS, NO_LISTS), (LATER, "    } else if (false) {\n      merge_lists<0, false>")],
    "no inserts": [(INSERTS, "    while (false) {\n")],
    "no staging": STATIC_RING,
    "exact division": [(RCP, EXACT_RCP)],
    "stream only": [(SELECT, SINK), *STATIC_RING],
    **{f"unroll {u}": [(UNROLL, UNROLL.replace("1", str(u), 1))] for u in (2, 4)},
}
#: the FADD bound: 132 SMs x 128 lanes x 1.98 GHz, two FADDs a (query, row, dimension)
FADD_PER_S = 33.5e12


def build_variant(_build, name, edits):
    """csrc/l1.cu edited, built once per edit and flags."""
    body = (_build.CSRC / "l1.cu").read_text()
    for old, new in edits:
        if old not in body:
            raise RuntimeError(f"variant {name!r}: l1.cu no longer holds {old!r}")
        body = body.replace(old, new)
    digest = hashlib.sha256(
        body.encode() + (_build.CSRC / "hopper.cuh").read_bytes()
        + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libl1_probe_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            shutil.copy(_build.CSRC / "hopper.cuh", tmp)
            Path(tmp, "l1.cu").write_text(body)
            part = out.with_suffix(f".{os.getpid()}.tmp")
            done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(part),
                                   str(Path(tmp, "l1.cu"))], capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"variant {name!r} does not build:\n{done.stdout}{done.stderr}")
            os.replace(part, out)
    return out


def sass_counts(_build, lib: Path) -> dict:
    """Per scan kernel of the library (cuobjdump -sass), by row type: FADDs
    of an absolute value, other FADDs, LDS, all instructions."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:  # the scan's two kernels; the reciprocal's check is not counted
            fn = m.group(1)
            name = "f32" if "l1_kernelIfE" in fn else "bf16" if "l1_kernelItE" in fn else None
            if name is not None:
                out[name] = {"fadd_abs": 0, "fadd_other": 0, "lds": 0, "instructions": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if name is None or not m:
            continue
        op, args = m.group(2), m.group(3)
        c = out[name]
        c["instructions"] += 1
        if op.split(".")[0] == "FADD":
            c["fadd_abs" if "|" in args else "fadd_other"] += 1
        elif op.startswith("LDS"):
            c["lds"] += 1
    return out


def clock_under_load(fn, launches: int = 200) -> str:
    """nvidia-smi's SM clock, power draw and power limit read while
    ``launches`` calls of ``fn`` are queued on the card."""
    fn()
    torch.cuda.synchronize()
    for _ in range(launches):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_l1: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from probe_exact_topk import inputs
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric
    from vectorlite_tpu_torch.kernels import _build, scan

    SM = SimilarityMetric
    card = cs.card_line()
    _build.build_all(["l1", "scan"])
    for name in ("l1", "scan"):
        _build.load(name)
    for line in _build.ptxas_report("l1"):
        cs.log(f"  l1 ptxas: {line}")
    stages_fn = _build.load("l1").scan_topk_l1_fadd_stages
    stages_fn.argtypes = [ctypes.c_int, ctypes.c_int]
    stages_fn.restype = ctypes.c_int
    plans = {}
    for code, dtype in enumerate(("f32", "bf16")):
        for d in (99, 100, 384, 768):
            st = stages_fn(code, d)
            plans[f"{dtype} D{d}"] = (f"{abs(st)} stages, queries "
                                      f"{'resident' if st > 0 else 'on the stages'}")
            cs.log(f"  ring, {dtype} D{d}: {plans[f'{dtype} D{d}']}")
    sass = sass_counts(_build, _build._target("l1"))
    unroll = int(re.search(r"#pragma unroll (\d+)  // the words of a stage",
                           (_build.CSRC / "l1.cu").read_text()).group(1))
    for dtype, c in sass.items():
        dims = 4 if dtype == "f32" else 8
        triples = 8 * 8 * dims * unroll
        cs.log(f"  l1 sass, {dtype} rows: {c}; one pass of the word loop covers {triples} "
               f"(query, row, dimension) triples (8 x 8 x {dims} x unroll {unroll})")

    dev = torch.device("cuda", 0)
    rcp = _build.load("l1").l1_rcp_check
    rcp.argtypes = [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    rcp.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    for exponent in range(126):  # every f32 of [1, 2^126)
        if rcp((127 + exponent) << 23, 1 << 23, bad.data_ptr(),
               torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("l1_rcp_check did not launch")
    torch.cuda.synchronize()
    rcp_bad = int(bad.item())
    cs.log(f"  rcp_fast against __frcp_rn over every f32 of [1, 2^126): {rcp_bad} differ")
    if rcp_bad:
        raise AssertionError("rcp_fast is not the exact reciprocal")
    rng = np.random.default_rng([args.seed, 11])

    def check(label, rows, valid, q, k, tile_n):
        kernel = scan.exact_route(rows.dtype, k, SM.MANHATTAN, tile_n)
        before = kernel.launches
        got = scan.tile_topk_cuda(rows, None, None, valid, q, metric=SM.MANHATTAN, k_tile=k,
                                  tile_n=tile_n)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise AssertionError(f"{label}: {kernel.symbol} did not launch")
        want = scan.tile_topk_plain(rows, None, None, valid, q, metric=SM.MANHATTAN,
                                    k_tile=min(k + 1, tile_n), tile_n=tile_n)
        return cs.compare(f"{kernel.symbol} {label}", [x.reshape(-1, k) for x in got],
                          [x.reshape(-1, want[0].shape[-1]) for x in want])

    errs = {}
    for n, d, b, tile_n in ((8192, 99, 3, 2048), (16384, 100, 5, 2048),
                            (65536, 384, 256, 2048), (16384, 768, 70, 4096),
                            (8192, 384, 64, 256)):
        rows, _, valid, q = inputs(dev, rng, n, d, b, tile_n)
        for dtype in ("f32", "bf16"):
            v = rows[dtype][0]
            for k in (1, 10, 16, 32):
                err = check(f"{dtype} {n}x{d} B{b} t{tile_n} k{k}", v, valid, q, k, tile_n)
                errs[dtype] = max(errs.get(dtype, 0.0), err)
    cs.log(f"  small shapes: both entries agree (max |score diff| {errs}) [{card}]")
    if args.check_only:
        print(card, flush=True)
        print(json.dumps({"card": card, "plans": plans, "sass": sass, "max_abs_err": errs}),
              flush=True)
        return 0

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc each
        built = {name: pool.submit(build_variant, _build, name, edits)
                 for name, edits in VARIANTS.items()}
    body = _build.load("l1")
    libs = {name: ctypes.CDLL(str(path.result())) for name, path in built.items()}
    n, d, b = 1 << 20, cs.D, cs.B
    g = np.random.default_rng([args.seed, 12])
    v = torch.from_numpy(g.standard_normal((n, d), dtype=np.float32)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    q = torch.from_numpy(g.standard_normal((b, d), dtype=np.float32)).to(dev)
    vb = v.to(torch.bfloat16)
    bound_ms = 2.0 * b * n * d / FADD_PER_S * 1e3
    cases = {"f32 k16": (v, 16), "bf16 k16": (vb, 16), "bf16 k32": (vb, 32)}
    out = {"bound_ms": bound_ms}
    for name, (rows, k) in cases.items():
        check(f"{name} at the main-path shape", rows, valid, q, k, 2048)

        def new(rows=rows, k=k):
            return scan.tile_topk_cuda(rows, None, None, valid, q, metric=SM.MANHATTAN,
                                       k_tile=k, tile_n=2048)

        def old(rows=rows, k=k):  # the CUDA-core route
            saved = scan.L1_MAX_K
            scan.L1_MAX_K = 0
            try:
                return new(rows, k)
            finally:
                scan.L1_MAX_K = saved

        o1 = cs.cuda_time_ms(old, 5)
        n1 = cs.cuda_time_ms(new, 20)
        n2 = cs.cuda_time_ms(new, 20)
        o2 = cs.cuda_time_ms(old, 5)
        ms = {"new": [n1, n2], "cuda_core": [o1, o2]}
        for variant, lib in libs.items():
            _build._libs["l1"] = lib
            ms[variant] = cs.cuda_time_ms(new, 20)
        _build._libs["l1"] = body
        ms["clock under load (MHz, W, W)"] = clock_under_load(new)
        cs.log(f"  {name}: SM clock, power draw, power limit under load: "
               f"{ms['clock under load (MHz, W, W)']}")
        out[name] = ms
        cs.log(f"  {name}: FADD stream {n1:.4f} / {n2:.4f} ms ({bound_ms / n1:.1%} of the "
               f"bound {bound_ms:.4f}), CUDA-core {o1:.4f} / {o2:.4f} ms; "
               + ", ".join(f"{var} {t:.4f} ({bound_ms / t:.1%})" for var, t in ms.items()
                           if isinstance(t, float)) + f" [{card}]")
    print(card, flush=True)
    print(json.dumps({"card": card, "plans": plans, "sass": sass, "max_abs_err": errs,
                      "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
