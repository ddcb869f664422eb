"""K1 and K2 on the tensor-core body's per-query top-k modes
(vectorlite_tpu_torch/csrc/exact.cu, k <= 32, and csrc/wide.cu, 32 < k <=
256, both on csrc/scan_mma.cuh) on one CUDA card: held, timed and taken
apart.

    env PYTHONPATH=. python3 scripts/probe_exact_topk.py [--seed S] [--check-only]
        [--wide-only]

Builds csrc/exact.cu, csrc/wide.cu and csrc/scan.cu and prints ptxas's
registers and spills of the six entries, each TOPK launch's ring at D 100,
384 and 768 (stages; the query terms resident or streamed) and each wide
launch's shared-memory plan there at k 128 and 256 (stages of the shared
ring, bytes of the ring, the score tiles and the lists). Holds each
entry's lists, tile by tile, against tile_topk_plain's under the 1e-5 rule
(scores within rtol/atol 1e-5, ids equal beyond 1e-5 near-ties, -inf slots
naming the same rows) at small shapes: k 1, 10, 16 and 32 (TOPK) and 33,
64, 100, 128 and 256 (wide), three metrics, duplicate rows, an all-invalid
tile. With --check-only it stops there; --wide-only leaves out the TOPK
entries. Then, at the main-path shapes (2^20 x 384, B 256: f32 rows at k
16 and tile 2,048, bf16 rows at k 32 and tile 4,096, int8 rows at k 32 and
tile 2,048; the wide entries at k 100's lists: f32 rows at 128 and tile
2,048, bf16 rows at 256 and tile 4,096, int8 rows at 256 and tile 2,048),
holds each entry once more and times it with CUDA events beside the
CUDA-core entry of the same call (scan_topk_exact, scan_topk_exact_int8;
old, new, new, old), and beside variants of the body built from edited
copies of scan_mma.cuh, instruments that compute wrong results. For the
TOPK entries:

* no merge: the chunk's scores reach the score tile, no list takes them
  (what the per-query merge costs);
* no inserts: later chunks find their candidates (the k-th entries, the
  ballots) but merge none into the lists;
* no scores: neither the score tile nor the merge (the contraction, its
  epilogue's metric and the barriers);
* profile: the body with clock64 counters (a warp's cycles in the chunk
  merges and in their candidate blocks, its candidates and (group of four
  queries, chunk) pairs), printed as means a warp; its outputs are right
  but for each block's first four scores of eight queries, where the
  counters go.

For the wide entries:

* no merge: both score tiles written and the block's barriers kept, no
  list takes the rows (body - no merge: what the batched merges cost);
* no scores: nor the score tiles (the contraction on the shared ring and
  its epilogue's metric; no merge - no scores: the score tiles' round
  trip and barriers).

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
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

MERGE = "        topk_merge(static_cast<int>(run_base"
SCORES = "          sc[score_at(ql, warp * 16 + g + 8 * h)] = s;"
INSERT = "          for (int j = 0; j < most; ++j) {"
# the profile instrument: clock64 cycles a warp spends in the chunk merges
# and in their candidate blocks, the candidates and the (query, chunk)
# pairs with any, written over each block's first outputs at its end
PROFILE = [
    ("  float* const score_tile = reinterpret_cast<float*>(smem + lay.scores);\n",
     "  float* const score_tile = reinterpret_cast<float*>(smem + lay.scores);\n"
     "  long long prof_merge = 0, prof_m = 0; int prof_cand = 0, prof_qc = 0;\n"),
    ("        for (int half = 0; half < 2; ++half) {\n",
     "        const long long tm0 = clock64();\n        prof_qc += 1;\n"
     "        for (int half = 0; half < 2; ++half) {\n"),
    ("            n[u] = __popc(m);\n", "            n[u] = __popc(m);\n            prof_cand += n[u];\n"),
    ("          __syncwarp();\n        }\n      }\n      // the next group's lists",
     "          __syncwarp();\n        }\n        prof_m += clock64() - tm0;\n      }\n"
     "      // the next group's lists"),
    ("        topk_merge(static_cast<int>(run_base",
     "        const long long tp0 = clock64(); topk_merge(static_cast<int>(run_base"),
    ("                   cl == 0);\n",
     "                   cl == 0);\n        prof_merge += clock64() - tp0;\n"),
    ("      flush(tile);\n  }\n}\n",
     "      flush(tile);\n  }\n  if (MODE == TOPK && lane == 0) {\n"
     "    float* o = out_s + (static_cast<size_t>(q0 + (tid >> 5)) * n_tiles + first_tile) * k;\n"
     "    o[0] = prof_merge; o[1] = prof_m; o[2] = prof_cand; o[3] = prof_qc;\n  }\n}\n"),
]
VARIANTS = {
    "no merge": [(MERGE, "        if (false) topk_merge(static_cast<int>(run_base")],
    "no inserts": [(INSERT, "          for (int j = 0; j < 0; ++j) {")],
    "profile": PROFILE,
    "no scores": [(MERGE, "        if (false) topk_merge(static_cast<int>(run_base"),
                  (SCORES, "          ks[0] = fmaxf(ks[0], s);")],
}
WIDE_MERGE = "        wide_merge(cl * CHUNK);"
WIDE_VARIANTS = {
    "no merge": [(WIDE_MERGE, "        if (false) wide_merge(cl * CHUNK);")],
    # the score stays computed (a compare a score) without the tile's stores
    "no scores": [(WIDE_MERGE, "        if (false) wide_merge(cl * CHUNK);"),
                  (SCORES, "          { if (s == 1.0e30f) sc[0] = s; }")],
}


def build_variant(_build, name, edits, source="exact"):
    """csrc/<source>.cu with scan_mma.cuh edited, built once per edit and
    flags."""
    body = (_build.CSRC / "scan_mma.cuh").read_text()
    for old, new in edits:
        if old not in body:
            raise RuntimeError(f"variant {name!r}: the body no longer holds {old!r}")
        body = body.replace(old, new)
    digest = hashlib.sha256(
        body.encode() + (_build.CSRC / f"{source}.cu").read_bytes()
        + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"lib{source}_probe_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            for src in (*_build.CSRC.glob("*.cuh"), _build.CSRC / f"{source}.cu"):
                shutil.copy(src, tmp)
            Path(tmp, "scan_mma.cuh").write_text(body)
            part = out.with_suffix(f".{os.getpid()}.tmp")
            done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(part),
                                   str(Path(tmp, f"{source}.cu"))], capture_output=True,
                                  text=True)
            if done.returncode != 0:
                raise RuntimeError(f"variant {name!r} does not build:\n{done.stdout}{done.stderr}")
            os.replace(part, out)
    return out


def ring_plans(_build) -> dict:
    """Each TOPK launch's ring by row dtype and width: stages, and whether
    the query terms stay resident (exact.cu scan_topk_exact_stages)."""
    fn = _build.load("exact").scan_topk_exact_stages
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    plans = {}
    for code, dtype in enumerate(("f32", "bf16", "int8")):
        for d in (100, 384, 768):
            st = fn(code, d)
            plans[f"{dtype} D{d}"] = (f"{abs(st)} stages, query terms "
                                      f"{'resident' if st > 0 else 'streamed'}")
    return plans


def inputs(dev, rng, n, d, b, tile_n):
    """Rows of N(0, 1) times a scale in [0.5, 2] (f32, bf16, int8 + scales),
    5% invalid, rows 7, 300 and 900 one row (ties to the lowest), tile 1
    all invalid; f32 queries."""
    v = rng.standard_normal((n, d)) * rng.uniform(0.5, 2.0, (n, 1))
    v[[300, 900]] = v[7]
    v = torch.from_numpy(v.astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    valid[[7, 300, 900]] = True
    if n >= 2 * tile_n:
        valid[tile_n:2 * tile_n] = False
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    q[0] = v[7] + 0.5 * q[0]  # query 0 ties rows 7, 300 and 900 at its top
    from vectorlite_tpu_torch.core.metrics import quantize_rows_int8

    v8, sc = quantize_rows_int8(v)
    rows = {"f32": (v, None), "bf16": (v.to(torch.bfloat16), None), "int8": (v8, sc)}
    return rows, (v * v).sum(-1), valid, q


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--wide-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_exact_topk: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric
    from vectorlite_tpu_torch.kernels import _build, scan

    card = cs.card_line()
    sources = ["wide", "scan"] if args.wide_only else ["exact", "wide", "scan"]
    _build.build_all(sources)
    for name in sources:
        _build.load(name)
        for line in _build.ptxas_report(name):
            cs.log(f"  {name} ptxas: {line}")
    plans = {} if args.wide_only else ring_plans(_build)
    for key, plan in plans.items():
        cs.log(f"  TOPK ring, {key}: {plan}")
    wide_plans = cs.wide_plans(_build)
    for key, plan in wide_plans.items():
        cs.log(f"  wide plan, {key}: {plan}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng([args.seed, 9])
    SM = SimilarityMetric
    metrics = (SM.COSINE, SM.EUCLIDEAN, SM.DOT_PRODUCT)

    def run(rows, scales, sq, valid, q, metric, k, tile_n):
        return scan.tile_topk_cuda(rows, scales, sq, valid, q, metric=metric, k_tile=k,
                                   tile_n=tile_n)

    def check(label, rows, scales, sq, valid, q, metric, k, tile_n):
        kernel = scan.exact_route(rows.dtype, k, metric, tile_n)
        before = kernel.launches
        got = run(rows, scales, sq, valid, q, metric, k, tile_n)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise AssertionError(f"{label}: {kernel.symbol} did not launch")
        want = scan.tile_topk_plain(rows, scales, sq, valid, q, metric=metric,
                                    k_tile=min(k + 1, tile_n), tile_n=tile_n)
        # every tile's list, -inf slots naming the plain version's rows
        return cs.compare(f"{kernel.symbol} {label}", [x.reshape(-1, k) for x in got],
                          [x.reshape(-1, want[0].shape[-1]) for x in want])

    errs = {}
    ks = (33, 64, 100, 128, 256) if args.wide_only else (1, 10, 16, 32, 33, 64, 100, 128, 256)
    # D 99: every row type on the plain-load staging (TMA refuses the stride)
    for n, d, b, tile_n in ((16384, 100, 5, 2048), (8192, 99, 3, 1024),
                            (65536, 384, 256, 4096), (16384, 768, 70, 2048)):
        rows, sq, valid, q = inputs(dev, rng, n, d, b, tile_n)
        for dtype, (v, sc) in rows.items():
            for metric in metrics:
                for k in ks:
                    err = check(f"{dtype} {n}x{d} B{b} t{tile_n} k{k} {metric.name}",
                                v, sc, sq, valid, q, metric, k, tile_n)
                    mode = "wide" if k > scan.MMA_MAX_K else "topk"
                    errs[f"{dtype} {mode}"] = max(errs.get(f"{dtype} {mode}", 0.0), err)
    cs.log(f"  small shapes: every entry agrees (max |score diff| {errs}) [{card}]")
    if args.check_only:
        print(card, flush=True)
        print(json.dumps({"card": card, "plans": plans, "wide_plans": wide_plans,
                          "max_abs_err": errs}), flush=True)
        return 0

    variants = {} if args.wide_only else {
        name: ("exact", edits) for name, edits in VARIANTS.items()}
    variants.update({f"wide {name}": ("wide", edits) for name, edits in WIDE_VARIANTS.items()})
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:  # one nvcc each
        built = {name: (source, pool.submit(build_variant, _build, name, edits, source))
                 for name, (source, edits) in variants.items()}
    libs = {"exact": {"body": _build.load("exact")} if not args.wide_only else {},
            "wide": {"body": _build.load("wide")}}
    for name, (source, path) in built.items():
        libs[source][name] = ctypes.CDLL(str(path.result()))
    n, d, b = 1 << 20, cs.D, cs.B
    g = np.random.default_rng([args.seed, 10])
    v = torch.from_numpy(g.standard_normal((n, d), dtype=np.float32)).to(dev)
    sq = (v * v).sum(-1)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    q = torch.from_numpy(g.standard_normal((b, d), dtype=np.float32)).to(dev)
    from vectorlite_tpu_torch.core.metrics import quantize_rows_int8

    v8, sc = quantize_rows_int8(v)
    vb = v.to(torch.bfloat16)
    cases = {"K1 f32": ("exact", v, None, 16, 2048), "K1 bf16": ("exact", vb, None, 32, 4096),
             "K2 int8": ("exact", v8, sc, 32, 2048),
             "K1 f32 wide": ("wide", v, None, 128, 2048),
             "K1 bf16 wide": ("wide", vb, None, 256, 4096),
             "K2 int8 wide": ("wide", v8, sc, 256, 2048)}
    out = {}
    for name, (source, rows, scales, k, tile_n) in cases.items():
        if args.wide_only and source == "exact":
            continue
        check(f"{name} at the main-path shape", rows, scales, sq, valid, q, SM.COSINE, k,
              tile_n)

        def new(rows=rows, scales=scales, k=k, tile_n=tile_n):
            return run(rows, scales, sq, valid, q, SM.COSINE, k, tile_n)

        def old(rows=rows, scales=scales, k=k, tile_n=tile_n):
            # the CUDA-core route
            saved = scan.MMA_MAX_K, scan.WIDE_MAX_K
            scan.MMA_MAX_K, scan.WIDE_MAX_K = 0, 0
            try:
                return new(rows, scales, k, tile_n)
            finally:
                scan.MMA_MAX_K, scan.WIDE_MAX_K = saved

        o1 = cs.cuda_time_ms(old, 5)
        n1 = cs.cuda_time_ms(new, 20)
        n2 = cs.cuda_time_ms(new, 20)
        o2 = cs.cuda_time_ms(old, 5)
        ms = {"new": [n1, n2], "cuda_core": [o1, o2]}
        for variant, lib in libs[source].items():
            _build._libs[source] = lib
            ms[variant] = cs.cuda_time_ms(new, 20)
            if variant in VARIANTS and VARIANTS[variant][:1] == PROFILE[:1]:
                s_out = new()[0]
                torch.cuda.synchronize()
                qbs, t = s_out.shape[0] // 64, s_out.shape[1]  # csrc/scan_mma.cuh walk_tiles
                per = -(-(t * qbs) // torch.cuda.get_device_properties(0).multi_processor_count)
                prof = torch.stack([s_out[qb * 64 + w, t0, :4] for qb in range(qbs)
                                    for t0 in range(0, t, per) for w in range(8)]).double()
                ms[f"{variant}: per warp"] = {key: float(prof[:, j].mean()) for j, key in enumerate(
                    ("merge_cycles", "candidate_block_cycles", "candidates", "group_chunks"))}
                cs.log(f"    {variant} (means a warp): {ms[f'{variant}: per warp']}")
        _build._libs[source] = libs[source]["body"]
        out[name] = ms
        cs.log(f"  {name} (k {k}, tile {tile_n}): tensor-core body {n1:.4f} / {n2:.4f} ms, "
               f"CUDA-core body {o1:.4f} / {o2:.4f} ms; "
               + ", ".join(f"{var} {t:.4f}" for var, t in ms.items()
                           if isinstance(t, float)) + f" [{card}]")
    print(card, flush=True)
    print(json.dumps({"card": card, "plans": plans, "wide_plans": wide_plans,
                      "max_abs_err": errs, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
