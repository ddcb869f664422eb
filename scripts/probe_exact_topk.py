"""K1 and K2 on the tensor-core body's per-query top-k modes
(vectorlite_tpu_torch/csrc/exact.cu, k <= 32, csrc/wide.cu, 32 < k <= 256,
and csrc/deep.cu, 256 < k <= 2,048, all on csrc/scan_mma.cuh) on one CUDA
card: held, timed and taken apart.

    env PYTHONPATH=. python3 scripts/probe_exact_topk.py [--seed S] [--check-only]
        [--wide-only | --deep-only | --deep-precision]

Builds csrc/exact.cu, csrc/wide.cu and csrc/scan.cu and prints ptxas's
registers and spills of the six entries, each TOPK launch's ring at D 100,
384 and 768 (stages; the query terms resident or streamed) and each wide
launch's shared-memory plan there at k 128 and 256 (stages of the shared
ring, bytes of the ring, the score tiles and the lists). Holds each
entry's lists, tile by tile, against tile_topk_plain's under the 1e-5 rule
(scores within rtol/atol 1e-5, ids equal beyond 1e-5 near-ties, -inf slots
naming the same rows) at small shapes: k 1, 10, 16 and 32 (TOPK) and 33,
64, 100, 128 and 256 (wide), three metrics, duplicate rows, an all-invalid
tile; the deep entries at k 257, 300, 512, 1,024 and 2,048 (k up to the
tile; dot products only where k is under half the tile: longer lists
reach dots near 0, where the plain f32 product is itself further than
1e-5 from float64). With --check-only it stops there; --wide-only leaves out the TOPK
and deep entries, --deep-only the TOPK and wide ones. Then, at the
main-path shapes (2^20 x 384, B 256: f32 rows at k
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

For the deep entries (K1 over f32 rows at k 300 and 1,024, over bf16 rows
at 512, K2 at 300 and 1,024, on the tiles kernels/scan.py exact_tile
grows them to at 2^20 rows, and f32 k 300 / 1,024 on 32,768 / 16,384-row
tiles; no CUDA-core comparison), the body and three edits of it, each
timed in a process of its own (in one process beside other builds of the
same kernel the body read 3.5x fast, with no error against the plain
version, where no process with one build repeats either):

* contraction alone: no row is staged or merged (the deep passes off:
  the contraction, its epilogue and the score tiles' round trip);
* selection alone: no wgmma is issued and each score is a hash of its
  (row, query), a float in [1, 2) in random order (the ring's copies, the
  score tiles, the ballots, the staging and the merges, as a random
  corpus drives them);
* profile: the body with device counters (merges, rows merged, rows
  staged, clock64 cycles in the merges, in the deep passes and in the
  whole kernel), held against the plain version like the body.

--deep-precision does only this: the deep entries' dot-product lists of
k 2,048 at D 100, 384 and 768 (scores near 0 included) against float64,
beside the plain f32 product, for the body and for its f32 and bf16 forms
without the slice-at-a-time sums of the large term (~1 min).

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


DEEP_VARIANTS = {
    "contraction alone": [
        ("        deep_pass(tile, cl * CHUNK, false);",
         "        if (false) deep_pass(tile, cl * CHUNK, false);"),
        ("      deep_pass(tile, 0, true);", "      if (false) deep_pass(tile, 0, true);")],
    "selection alone": [
        ("for (int kk = 0; kk < 4; ++kk) acc.mma(ah[kk], al[kk], db, kk);",
         "for (int kk = 0; kk < 4; ++kk) (void)kk;"),
        ("for (int kk = 0; kk < 4; ++kk) acc.mma(da, db, kk);",
         "for (int kk = 0; kk < 4; ++kk) (void)kk;"),
        ("        if (!ok[h]) s = -CUDART_INF_F;",
         "        {\n"
         "          uint32_t x = static_cast<uint32_t>(row + 8 * h) * 0x9E3779B1u ^\n"
         "                       static_cast<uint32_t>(q0 + ql) * 0x85EBCA77u;\n"
         "          x ^= x >> 15; x *= 0x2C1B3C6Du; x ^= x >> 12;\n"
         "          s = __uint_as_float(0x3f800000u | (x >> 9));\n"
         "        }\n"
         "        if (!ok[h]) s = -CUDART_INF_F;")],
}


# the deep profile: device counters (merges, rows merged, rows staged,
# clock64 cycles a warp in the deep passes, in the whole kernel and in the
# merges), read back through deep_prof_read after one launch
DEEP_VARIANTS["profile"] = [
    ("enum Metric { COSINE = 0, EUCLIDEAN = 1, DOT = 2 };",
     "enum Metric { COSINE = 0, EUCLIDEAN = 1, DOT = 2 };\n"
     "__device__ unsigned long long deep_prof[8];"),
    ("  const int len = deep_merge(st_s, st_r, st + 2, st[0], ls, lr, st[1], k, tile_base, lane);",
     "  const int n_staged = st[0];\n  const long long tm0 = clock64();\n"
     "  const int len = deep_merge(st_s, st_r, st + 2, st[0], ls, lr, st[1], k, tile_base, lane);\n"
     "  if (lane == 0) { atomicAdd(&deep_prof[0], 1ull);"
     " atomicAdd(&deep_prof[1], static_cast<unsigned long long>(n_staged));"
     " atomicAdd(&deep_prof[5], static_cast<unsigned long long>(clock64() - tm0)); }"),
    ("  if (lane == 0) st[0] = at;",
     "  if (lane == 0) {\n"
     "    atomicAdd(&deep_prof[2], static_cast<unsigned long long>(at - n));\n"
     "    st[0] = at;\n  }"),
    ("        deep_pass(tile, cl * CHUNK, false);",
     "        { const long long t0 = clock64(); deep_pass(tile, cl * CHUNK, false);\n"
     "          if (lane == 0) atomicAdd(&deep_prof[3], static_cast<unsigned long long>("
     "clock64() - t0)); }"),
    ("      deep_pass(tile, 0, true);",
     "      { const long long t0 = clock64(); deep_pass(tile, 0, true);\n"
     "        if (lane == 0) atomicAdd(&deep_prof[3], static_cast<unsigned long long>("
     "clock64() - t0)); }"),
    ("  const int tid = threadIdx.x;\n  const int wg = tid >> 7;",
     "  const long long prof_t0 = clock64();\n  const int tid = threadIdx.x;\n"
     "  const int wg = tid >> 7;"),
    ("      flush(tile);\n  }\n}\n",
     "      flush(tile);\n  }\n  if (MODE == DEEP && (threadIdx.x & 31) == 0)\n"
     "    atomicAdd(&deep_prof[4], static_cast<unsigned long long>(clock64() - prof_t0));\n}\n"),
    ("}  // namespace scan_mma\n}  // namespace\n",
     "}  // namespace scan_mma\n}  // namespace\n"
     "extern \"C\" void deep_prof_read(unsigned long long* out, int reset) {\n"
     "  cudaMemcpyFromSymbol(out, scan_mma::deep_prof, sizeof(unsigned long long) * 8);\n"
     "  if (reset) { unsigned long long z[8] = {0}; "
     "cudaMemcpyToSymbol(scan_mma::deep_prof, z, sizeof(z)); }\n}\n"),
]


# the deep mode's f32 and bf16 forms without the slice-at-a-time sums of
# the large term (the tensor cores accumulate a chunk's k-steps): for
# --deep-precision only
NO_SLICE_SUMS = [("acc.slice_start();", ";"), ("acc.slice_end();", ";"),
                 ("acc.take_sums();", ";")]


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


def deep_cases(scan, n, v, vb, v8, sc):
    """(name, rows, scales, k, tile) of the deep entries at the main-path
    shape: the paths' lists on the tiles exact_tile grows (f32 k 300 and
    k_pad 1,024, bf16 pool 512, int8 k 300 and pool 1,024), and f32 k 300
    on 32,768-row tiles, k 1,024 on 16,384 (the tile's share)."""
    cases = [(f"K1 f32 deep k{k}", v, None, k, scan.exact_tile(n, 2048, k)) for k in (300, 1024)]
    cases += [("K1 f32 deep k300 t32768", v, None, 300, 32768),
              ("K1 f32 deep k1024 t16384", v, None, 1024, 16384),
              ("K1 bf16 deep k512", vb, None, 512, scan.exact_tile(n, 4096, 512))]
    cases += [(f"K2 int8 deep k{k}", v8, sc, k, scan.exact_tile(n, 2048, k)) for k in (300, 1024)]
    return cases


def main_inputs(dev, seed):
    """The main-path shape's rows (f32, bf16, int8 + scales), squared norms,
    validity and queries: 2^20 x 384, B 256."""
    import chip_smoke as cs
    from vectorlite_tpu_torch.core.metrics import quantize_rows_int8

    n, d, b = 1 << 20, cs.D, cs.B
    g = np.random.default_rng([seed, 10])
    v = torch.from_numpy(g.standard_normal((n, d), dtype=np.float32)).to(dev)
    q = torch.from_numpy(g.standard_normal((b, d), dtype=np.float32)).to(dev)
    v8, sc = quantize_rows_int8(v)
    return v, v.to(torch.bfloat16), v8, sc, (v * v).sum(-1), torch.ones(n, dtype=torch.bool,
                                                                           device=dev), q


def deep_timings(args) -> int:
    """``--deep-lib PATH --deep-variant NAME``: one build of csrc/deep.cu (the
    body or a variant) in a process of its own, no other build of its
    kernels loaded: each deep case timed twice (20 launches each); the body
    and the profile held against the plain version first; the profile's
    counters read over one launch. Prints a JSON object last."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric as SM
    from vectorlite_tpu_torch.kernels import _build, scan

    lib = ctypes.CDLL(args.deep_lib)
    _build._libs["deep"] = lib
    dev = torch.device("cuda", 0)
    v, vb, v8, sc, sq, valid, q = main_inputs(dev, args.seed)
    out = {}
    for name, rows, scales, k, tile_n in deep_cases(scan, v.shape[0], v, vb, v8, sc):
        def new(rows=rows, scales=scales, k=k, tile_n=tile_n):
            return scan.tile_topk_cuda(rows, scales, sq, valid, q, metric=SM.COSINE, k_tile=k,
                                       tile_n=tile_n)
        res = {}
        if args.deep_variant in ("body", "profile"):
            got = new()
            torch.cuda.synchronize()
            want = scan.tile_topk_plain(rows, scales, sq, valid, q, metric=SM.COSINE,
                                        k_tile=k + 1, tile_n=tile_n)
            res["max_abs_err"] = cs.compare(f"{args.deep_variant} {name}",
                                            [x.reshape(-1, k) for x in got],
                                            [x.reshape(-1, k + 1) for x in want])
            del got, want
        if args.deep_variant == "profile":
            fn = lib.deep_prof_read
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
            fn.restype = None
            buf = (ctypes.c_ulonglong * 8)()
            torch.cuda.synchronize()
            fn(buf, 1)
            new()
            torch.cuda.synchronize()
            fn(buf, 1)
            n_tiles, q_blocks = rows.shape[0] // tile_n, -(-q.shape[0] // 64)
            lists = n_tiles * q.shape[0]
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            per_block = -(-(n_tiles * q_blocks) // sms)  # csrc/scan_mma.cuh walk_tiles
            warps = 8 * q_blocks * -(-n_tiles // per_block)
            res["counts"] = {
                "merges a list": buf[0] / lists, "rows a merge": buf[1] / max(1, buf[0]),
                "rows staged a list": buf[2] / lists,
                "cycles a merge": buf[5] / max(1, buf[0]),
                "deep-pass cycles a warp": buf[3] / warps,
                "kernel cycles a warp": buf[4] / warps}
        res["ms"] = [cs.cuda_time_ms(new, 20), cs.cuda_time_ms(new, 20)]
        out[name] = res
    print(json.dumps(out), flush=True)
    return 0


def deep_precision(args) -> int:
    """``--deep-lib PATH --deep-precision``: one build of csrc/deep.cu in a
    process of its own, its dot-product lists of k = 2,048 (every row of
    2,048-row tiles, half of 4,096-row ones) against float64 beside the
    plain f32 product's: rms of each one's distance from the float64 dot
    of its listed rows, and the largest among dots within 1 of 0. Rows
    N(0, 1) times a scale in [0.5, 2], queries N(0, 1). Prints a JSON
    object last."""
    sys.path.insert(0, str(ROOT))
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric as SM, quantize_rows_int8
    from vectorlite_tpu_torch.kernels import _build, scan

    _build._libs["deep"] = ctypes.CDLL(args.deep_lib)
    dev = torch.device("cuda", 0)
    out = {}
    for n, d, b, tile in ((8192, 100, 5, 2048), (65536, 384, 64, 4096), (16384, 768, 70, 2048)):
        rng = np.random.default_rng([args.seed, n, d, b])
        v = rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, (n, 1))
        v = torch.from_numpy(v.astype(np.float32)).to(dev)
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        sq = (v * v).sum(-1)
        v8, sc = quantize_rows_int8(v)
        for name, rows, scales, v64 in (
                ("f32", v, None, v.double()),
                ("bf16", v.to(torch.bfloat16), None, v.to(torch.bfloat16).double()),
                ("int8", v8, sc, v8.double() * sc.double()[:, None])):
            s_k, i_k = scan.tile_topk_cuda(rows, scales, sq, valid, q, metric=SM.DOT_PRODUCT,
                                           k_tile=2048, tile_n=tile)
            exact = q.double() @ v64.T
            idx = i_k.reshape(b, -1).long()
            dots = exact.gather(1, idx)
            plain = scan.tile_scores(rows, scales, sq, valid, q, SM.DOT_PRODUCT).gather(1, idx)
            near0 = dots.abs() < 1.0
            res = {}
            for who, s in (("kernel", s_k.reshape(b, -1).double()), ("plain", plain.double())):
                err = (s - dots).abs()
                res[who] = {"rms": err.square().mean().sqrt().item(),
                            "max_near_0": err[near0].max().item()}
            out[f"{name} {n}x{d} B{b} t{tile}"] = res
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-only", action="store_true")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--wide-only", action="store_true")
    only.add_argument("--deep-only", action="store_true")
    ap.add_argument("--deep-lib", help=argparse.SUPPRESS)
    ap.add_argument("--deep-variant", help=argparse.SUPPRESS)
    ap.add_argument("--deep-precision", action="store_true",
                    help="only the deep entries' dot products near 0 against float64, with "
                         "and without the slice-at-a-time sums")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_exact_topk: no CUDA device is available", file=sys.stderr)
        return 1
    if args.deep_lib:
        return deep_precision(args) if args.deep_precision else deep_timings(args)
    if args.deep_precision:
        return precision_main(args)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric
    from vectorlite_tpu_torch.kernels import _build, scan

    card = cs.card_line()
    sources = (["wide", "scan"] if args.wide_only else ["deep"] if args.deep_only
               else ["exact", "wide", "deep", "scan"])
    _build.build_all(sources)
    for name in sources:
        _build.load(name)
        for line in _build.ptxas_report(name):
            cs.log(f"  {name} ptxas: {line}")
    plans = {} if args.wide_only or args.deep_only else ring_plans(_build)
    for key, plan in plans.items():
        cs.log(f"  TOPK ring, {key}: {plan}")
    wide_plans = {} if args.deep_only else cs.wide_plans(_build)
    for key, plan in wide_plans.items():
        cs.log(f"  wide plan, {key}: {plan}")
    deep_plans = {} if args.wide_only else cs.deep_plans(_build)
    for key, plan in deep_plans.items():
        cs.log(f"  deep plan, {key}: {plan}")
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
    deep_ks = () if args.wide_only else (257, 300, 512, 1024, 2048)
    ks = (33, 64, 100, 128, 256) if args.wide_only else () if args.deep_only else (
        1, 10, 16, 32, 33, 64, 100, 128, 256)
    # D 99: every row type on the plain-load staging (TMA refuses the stride)
    for n, d, b, tile_n in ((16384, 100, 5, 2048), (8192, 99, 3, 1024),
                            (65536, 384, 256, 4096), (16384, 768, 70, 2048)):
        rows, sq, valid, q = inputs(dev, rng, n, d, b, tile_n)
        for dtype, (v, sc) in rows.items():
            for metric in metrics:
                for k in (*ks, *(k for k in deep_ks if k <= tile_n)):
                    if metric is SM.DOT_PRODUCT and 2 * k >= tile_n:
                        # dots near 0, where the plain f32 product is itself
                        # further than 1e-5 from float64 (tests/test_torch_scan.py
                        # holds these lists to float64 instead)
                        continue
                    err = check(f"{dtype} {n}x{d} B{b} t{tile_n} k{k} {metric.name}",
                                v, sc, sq, valid, q, metric, k, tile_n)
                    mode = ("deep" if k > scan.WIDE_MAX_K else "wide" if k > scan.MMA_MAX_K
                            else "topk")
                    errs[f"{dtype} {mode}"] = max(errs.get(f"{dtype} {mode}", 0.0), err)
    cs.log(f"  small shapes: every entry agrees (max |score diff| {errs}) [{card}]")
    if args.check_only:
        print(card, flush=True)
        print(json.dumps({"card": card, "plans": plans, "wide_plans": wide_plans,
                          "deep_plans": deep_plans, "max_abs_err": errs}), flush=True)
        return 0

    variants = {} if args.wide_only or args.deep_only else {
        name: ("exact", edits) for name, edits in VARIANTS.items()}
    if not args.deep_only:
        variants.update({f"wide {name}": ("wide", edits) for name, edits in WIDE_VARIANTS.items()})
    deep_variants = {} if args.wide_only else DEEP_VARIANTS
    with concurrent.futures.ThreadPoolExecutor(max(1, len(variants) + len(deep_variants))) as pool:
        # one nvcc each
        built = {name: (source, pool.submit(build_variant, _build, name, edits, source))
                 for name, (source, edits) in variants.items()}
        deep_built = {name: pool.submit(build_variant, _build, name, edits, "deep")
                      for name, edits in deep_variants.items()}
    libs = {source: {"body": _build.load(source)} for source in ("exact", "wide")
            if source in sources}
    for name, (source, path) in built.items():
        libs[source][name] = ctypes.CDLL(str(path.result()))
    v, vb, v8, sc, sq, valid, q = main_inputs(dev, args.seed)
    cases = {"K1 f32": ("exact", v, None, 16, 2048), "K1 bf16": ("exact", vb, None, 32, 4096),
             "K2 int8": ("exact", v8, sc, 32, 2048),
             "K1 f32 wide": ("wide", v, None, 128, 2048),
             "K1 bf16 wide": ("wide", vb, None, 256, 4096),
             "K2 int8 wide": ("wide", v8, sc, 256, 2048)}
    out = {}
    for name, (source, rows, scales, k, tile_n) in cases.items():
        if source not in sources:
            continue
        check(f"{name} at the main-path shape", rows, scales, sq, valid, q, SM.COSINE, k,
              tile_n)

        def new(rows=rows, scales=scales, k=k, tile_n=tile_n):
            return run(rows, scales, sq, valid, q, SM.COSINE, k, tile_n)

        def old(rows=rows, scales=scales, k=k, tile_n=tile_n):
            # the CUDA-core route
            saved = scan.MMA_MAX_K, scan.WIDE_MAX_K, scan.DEEP_MAX_K
            scan.MMA_MAX_K, scan.WIDE_MAX_K, scan.DEEP_MAX_K = 0, 0, 0
            try:
                return new(rows, scales, k, tile_n)
            finally:
                scan.MMA_MAX_K, scan.WIDE_MAX_K, scan.DEEP_MAX_K = saved

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
    # the deep entries: each build in a process of its own (several builds of
    # one kernel loaded into one process gave readings of the body that no
    # process with one build repeats)
    deep_libs = {"body": _build._target("deep")} if "deep" in sources else {}
    deep_libs.update({name: path.result() for name, path in deep_built.items()})
    deep_ms = {}
    for label, path in deep_libs.items():
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--deep-lib", str(path),
             "--deep-variant", label, "--seed", str(args.seed)],
            capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(ROOT)})
        if done.returncode != 0:
            raise RuntimeError(f"deep {label}: exit {done.returncode}\n{done.stdout}{done.stderr}")
        for line in done.stdout.splitlines()[:-1]:
            cs.log(line)
        for name, res in json.loads(done.stdout.splitlines()[-1]).items():
            deep_ms.setdefault(name, {})[label] = res
    for name, res in deep_ms.items():
        out[name] = res
        cs.log(f"  {name}: " + "; ".join(
            f"{label} {' / '.join(f'{t:.4f}' for t in r['ms'])} ms"
            + (f" {r['counts']}" if "counts" in r else "") for label, r in res.items())
            + f" [{card}]")
    print(card, flush=True)
    print(json.dumps({"card": card, "plans": plans, "wide_plans": wide_plans,
                      "deep_plans": deep_plans, "max_abs_err": errs, "ms": out}), flush=True)
    return 0


def precision_main(args) -> int:
    """--deep-precision: the body and its form without the slice sums, each
    built and measured in a process of its own (deep_precision)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vectorlite_tpu_torch.kernels import _build

    card = cs.card_line()
    _build.build_all(["deep"])
    libs = {"body": _build._target("deep"),
            "no slice sums": build_variant(_build, "no slice sums", NO_SLICE_SUMS, "deep")}
    out = {}
    for label, path in libs.items():
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--deep-lib", str(path),
             "--deep-precision", "--seed", str(args.seed)],
            capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(ROOT)})
        if done.returncode != 0:
            raise RuntimeError(f"deep {label}: exit {done.returncode}\n{done.stdout}{done.stderr}")
        out[label] = json.loads(done.stdout.splitlines()[-1])
        for shape, res in out[label].items():
            cs.log(f"  {label}, {shape}: " + "; ".join(
                f"{who} rms {r['rms']:.3g}, largest near 0 {r['max_near_0']:.3g}"
                for who, r in res.items()) + f" [{card}]")
    print(card, flush=True)
    print(json.dumps({"card": card, "precision": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
