"""K1 and K2 on the tensor-core body's per-query top-k modes
(vectorlite_tpu_torch/csrc/exact.cu, k <= 32, and csrc/wide.cu, 32 < k <=
256, both on csrc/scan_mma.cuh) and on its scores into the radix select
(csrc/select.cu, past k 256 or tiles of 32,768 rows) on one CUDA card:
held, timed and taken apart.

    env PYTHONPATH=. python3 scripts/probe_exact_topk.py [--seed S] [--check-only]
        [--wide-only | --select-only | --precision]

Builds csrc/exact.cu and csrc/wide.cu and prints ptxas's registers and
spills of the six entries, each TOPK launch's ring at D 100, 384 and 768
(stages; the query terms resident or streamed) and each wide launch's
shared-memory plan there at k 128 and 256 (stages of the shared ring,
bytes of the ring, the score tiles and the lists). Holds each entry's
lists, tile by tile, against tile_topk_plain's under the 1e-5 rule
(scores within rtol/atol 1e-5, ids equal beyond 1e-5 near-ties, -inf
slots naming the same rows) at small shapes: k 1, 10, 16 and 32 (TOPK)
and 33, 64, 100, 128 and 256 (wide), three metrics, duplicate rows, an
all-invalid tile. With --check-only it stops there; --wide-only leaves
out the TOPK entries. Then, at the main-path shapes (2^20 x 384, B 256:
f32 rows at k 16 and tile 2,048, bf16 rows at k 32 and tile 4,096, int8
rows at k 32 and tile 2,048; the wide entries at k 100's lists: f32 rows
at 128 and tile 2,048, bf16 rows at 256 and tile 4,096, int8 rows at 256
and tile 2,048), holds each entry once more and times it with CUDA
events, twice, and beside variants of the body built from edited copies
of scan_mma.cuh, instruments that compute wrong results. For the TOPK
entries:

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

--select-only builds csrc/select.cu alone, prints ptxas's registers,
stack frames and spills of its kernels, holds the select entries at small
shapes (k 257, 300, 1,024, 2,048, 2,049, 4,096 and k = tile_n, k 33 and
300 over a 65,536-row tile; D 99, 100, 384, 768), then times them at the
paths' shapes (2^20 x 384, B 256, on the tiles exact_tile grows: K1 over
f32 rows at k 300 and k_pad 1,024, 4,096 and 8,192, over bf16 rows at
the pools of 512 and 4,096, K2 at k 300 and the pools of 1,024 and
4,096), the tile choice (k 300 over 16,384-row tiles, k 4,096 over
65,536- and 131,072-row ones) and the scratch (K1 f32 at 64 MiB and 1 GiB
of it, beside the package's 256 MiB). Four builds of select.cu, each
timed in a process of its own (in one process beside other builds of the
same kernel a build can read fast with no error against the plain
version, where no process with one build repeats it):

* entry: the package's build, held against the plain version first;
* scores alone: the select's launches edited out;
* select alone: the scores' launches edited out; the probe fills a
  scratch of its own with the first group's plain scores and launches
  the entry over it (every group then selects over those scores; the
  first group's lists are held against the plain top k of them);
* profile: clock64 cycles of each block's thread 0 in the digit passes
  (the keys' loads included), the gather of the survivors, the sort and
  the write of the list, and the passes a block took.

--precision does only this: the select entries' dot-product lists of k
2,048 at D 100, 384 and 768 (scores near 0 included) against float64,
beside the plain f32 product, for the package's build and for its f32 and
bf16 forms without the slice-at-a-time sums of the large term, each in a
process of its own (~1 min).

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


# the select entries' f32 and bf16 scores without the slice-at-a-time
# sums of the large term (the tensor cores accumulate a chunk's k-steps):
# for --precision only
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


def precision_run(args) -> int:
    """``--select-lib PATH --precision``: one build of csrc/select.cu in a
    process of its own, its dot-product lists of k = 2,048 (every row of
    2,048-row tiles, half of 4,096-row ones) against float64 beside the
    plain f32 product's: rms of each one's distance from the float64 dot
    of its listed rows, and the largest among dots within 1 of 0. Rows
    N(0, 1) times a scale in [0.5, 2], queries N(0, 1). Prints a JSON
    object last."""
    sys.path.insert(0, str(ROOT))
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric as SM, quantize_rows_int8
    from vectorlite_tpu_torch.kernels import _build, scan

    _build._libs["select"] = ctypes.CDLL(args.select_lib)
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


#: --select-only's timed cases: (name, rows, k, tile or None for the tile
#: exact_tile grows the path's caller tile to, scratch bytes or None for
#: the package's): the paths' lists past 2,048 and past 256 (k 300, k_pad
#: 1,024, the pools of 512 and 1,024), then the tile and scratch choices
SELECT_TIMED = [
    ("K1 f32 k4096", "f32", 4096, None, None),
    ("K1 f32 k8192", "f32", 8192, None, None),
    ("K1 bf16 k4096", "bf16", 4096, None, None),
    ("K2 int8 k4096", "int8", 4096, None, None),
    ("K1 f32 k300", "f32", 300, None, None),
    ("K1 f32 k1024", "f32", 1024, None, None),
    ("K1 bf16 k512", "bf16", 512, None, None),
    ("K2 int8 k300", "int8", 300, None, None),
    ("K2 int8 k1024", "int8", 1024, None, None),
    ("K1 f32 k300 t16384", "f32", 300, 16384, None),
    ("K1 f32 k4096 t65536", "f32", 4096, 65536, None),
    ("K1 f32 k4096 t131072", "f32", 4096, 131072, None),
    ("K1 bf16 k4096 t65536", "bf16", 4096, 65536, None),
    ("K2 int8 k4096 t65536", "int8", 4096, 65536, None),
    ("K1 f32 k4096 scratch 64 MiB", "f32", 4096, None, 64 << 20),
    ("K1 f32 k4096 scratch 1 GiB", "f32", 4096, None, 1 << 30),
]
# csrc/select.cu's two launches a group of tiles, taken apart by editing
# the source: the scores alone, or the select alone over whatever the
# caller's scratch holds
SCORES_LAUNCH = "    int e = scan_mma::launch<T, scan_mma::SCORES, 1>("
SELECT_LAUNCH = "    if (e == 0)\n      e = launch_select("
# the select's profile: clock64 cycles of each block's thread 0 in the
# digit passes (the keys' loads included), the gather of the survivors,
# the sort and the write of the list, and the passes a block took, read
# back through sel_prof_read after one launch (the select lives in
# select.cuh: those edits name it)
SELECT_PROFILE = [
    ("select.cuh", "namespace sel {\n",
     "namespace sel {\n__device__ unsigned long long sel_prof[8];\n"),
    ("select.cuh", "  const int tid = threadIdx.x;\n  const int lane = tid & 31;\n  const int warp = tid >> 5;\n"
     "  const uint32_t lower",
     "  const long long pf0 = clock64();\n  int pf_passes = 0;\n  long long pf4 = 0;\n"
     "  const int tid = threadIdx.x;\n  const int lane = tid & 31;\n  const int warp = tid >> 5;\n"
     "  const uint32_t lower"),
    ("select.cuh", "  for (int shift = 24; shift >= 0; shift -= 8) {\n",
     "  for (int shift = 24; shift >= 0; shift -= 8) {\n    ++pf_passes;\n"),
    ("select.cuh", "  // the survivors: every key over the prefix",
     "  const long long pf2 = clock64();\n  // the survivors: every key over the prefix"),
    ("select.cuh", "  // the k survivors by (key descending, row ascending)\n",
     "  const long long pf3 = clock64();\n  // the k survivors by (key descending, row ascending)\n"),
    ("select.cuh", "    for (int e = tid; e < k; e += THREADS) {\n      const uint64_t v = buf[e];",
     "    pf4 = clock64();\n    for (int e = tid; e < k; e += THREADS) {\n"
     "      const uint64_t v = buf[e];"),
    ("select.cuh", "        });\n  }\n}\n\n// The select over one group",
     "        });\n  }\n  if (threadIdx.x == 0) {\n    const long long pf5 = clock64();\n"
     "    atomicAdd(&sel_prof[0], 1ull);\n"
     "    atomicAdd(&sel_prof[1], static_cast<unsigned long long>(pf2 - pf0));\n"
     "    atomicAdd(&sel_prof[2], static_cast<unsigned long long>(pf3 - pf2));\n"
     "    atomicAdd(&sel_prof[3], static_cast<unsigned long long>(pf4 - pf3));\n"
     "    atomicAdd(&sel_prof[4], static_cast<unsigned long long>(pf5 - pf4));\n"
     "    atomicAdd(&sel_prof[5], static_cast<unsigned long long>(pf_passes));\n  }\n}\n\n"
     "// The select over one group"),
    ("}  // extern \"C\"\n",
     "void sel_prof_read(unsigned long long* out, int reset) {\n"
     "  cudaMemcpyFromSymbol(out, sel::sel_prof, sizeof(unsigned long long) * 8);\n"
     "  if (reset) { unsigned long long z[8] = {0}; "
     "cudaMemcpyToSymbol(sel::sel_prof, z, sizeof(z)); }\n}\n}  // extern \"C\"\n"),
]


def build_source_variant(_build, source, edits):
    """csrc/<source>.cu edited, built once per edit and flags: each edit is
    (old, new) on the source itself or (header, old, new) on one of the
    csrc/*.cuh headers it includes (the others as they are)."""
    texts = {h.name: h.read_text() for h in sorted(_build.CSRC.glob("*.cuh"))}
    texts[f"{source}.cu"] = (_build.CSRC / f"{source}.cu").read_text()
    for edit in edits:
        name, old, new = edit if len(edit) == 3 else (f"{source}.cu", *edit)
        if texts[name].count(old) != 1:
            raise RuntimeError(f"csrc/{name} no longer holds {old!r} once")
        texts[name] = texts[name].replace(old, new)
    digest = hashlib.sha256(
        b"".join(texts[name].encode() for name in sorted(texts))
        + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"lib{source}_probe_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            for name, text in texts.items():
                Path(tmp, name).write_text(text)
            part = out.with_suffix(f".{os.getpid()}.tmp")
            done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(part),
                                   str(Path(tmp, f"{source}.cu"))], capture_output=True,
                                  text=True)
            if done.returncode != 0:
                raise RuntimeError(f"{source} variant does not build:\n{done.stdout}"
                                   f"{done.stderr}")
            os.replace(part, out)
    return out


SELECT_VARIANTS = {
    "entry": [],
    "scores alone": [(SELECT_LAUNCH, "    if (false)\n      e = launch_select(")],
    "select alone": [(SCORES_LAUNCH, "    int e = 0;\n    if (false) e = scan_mma::launch<T, "
                                     "scan_mma::SCORES, 1>(")],
    "profile": SELECT_PROFILE,
}


def select_alone(rows, scales, sq, valid, q, k, tile_n, group):
    """The select alone, timed apart: the [B, group] f32 scores of the first
    group of tiles (the plain version's, made once) in a scratch of the
    probe's own, and a launch of the select entry exact_route names as
    tile_topk_cuda makes it, over that scratch (cosine; the select-alone
    build reads the same scores for every group). Returns the launch and
    the scores."""
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric as SM
    from vectorlite_tpu_torch.kernels import scan, scan_mma

    n, d = rows.shape
    b = q.shape[0]
    kernel = scan.exact_route(rows.dtype, k, SM.COSINE, tile_n)
    scratch = scan.tile_scores(rows[:group], scales if scales is None else scales[:group],
                               sq[:group], valid[:group], q, SM.COSINE).contiguous()
    qsq = (q * q).sum(-1).contiguous()
    if rows.dtype == torch.int8:
        head = (*scan_mma.query_operand_int8(q), qsq, rows, scales)
    else:
        head = (scan_mma.query_operand_tf32(q) if rows.dtype == torch.float32
                else scan_mma.query_operand(q), qsq, rows)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        out_s = torch.empty((b, n // tile_n, k), dtype=torch.float32, device=rows.device)
        out_i = torch.empty((b, n // tile_n, k), dtype=torch.int32, device=rows.device)
        kernel.launch(*(t.data_ptr() for t in head), sq.data_ptr(), valid.data_ptr(),
                      scratch.data_ptr(), group, out_s.data_ptr(), out_i.data_ptr(), n, d, b, k,
                      tile_n, scan._METRIC_CODE[SM.COSINE], stream)
        return out_s, out_i
    return run, scratch


def select_timings(args) -> int:
    """``--select-part NAME --select-lib PATH``: one build of csrc/select.cu
    (SELECT_VARIANTS) in a process of its own, no other build of it
    loaded: each SELECT_TIMED case timed twice (20 launches each); the
    entry held against the plain version first, the select alone's first
    group of lists against the plain lists of the scores it read; the
    profile's counters read over one launch. Prints a JSON object last."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric as SM
    from vectorlite_tpu_torch.kernels import _build, scan

    part = args.select_part
    _build._libs["select"] = ctypes.CDLL(args.select_lib)
    if part == "profile":
        read = _build._libs["select"].sel_prof_read
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        read.restype = None
    dev = torch.device("cuda", 0)
    v, vb, v8, sc, sq, valid, q = main_inputs(dev, args.seed)
    rows_of = {"f32": (v, None, 2048), "bf16": (vb, None, 4096), "int8": (v8, sc, 2048)}
    default_scratch = scan.SELECT_SCRATCH_BYTES
    out = {}
    for name, dtype, k, tile, scratch in SELECT_TIMED:
        rows, scales, caller = rows_of[dtype]
        tile_n = tile or scan.exact_tile(rows.shape[0], caller, k)
        scan.SELECT_SCRATCH_BYTES = scratch or default_scratch
        group = scan.select_group_rows(rows.shape[0], q.shape[0], tile_n)

        def run(rows=rows, scales=scales, k=k, tile_n=tile_n):
            return scan.tile_topk_cuda(rows, scales, sq, valid, q, metric=SM.COSINE, k_tile=k,
                                       tile_n=tile_n)
        res = {"tile": tile_n, "group_rows": group}
        if part == "profile":
            buf = (ctypes.c_ulonglong * 8)()
            run()
            torch.cuda.synchronize()
            read(buf, 1)
            run()
            torch.cuda.synchronize()
            read(buf, 1)
            blocks = max(1, buf[0])
            res["cycles a block"] = {
                "passes (keys' loads included)": buf[1] / blocks, "gather": buf[2] / blocks,
                "sort": buf[3] / blocks, "write": buf[4] / blocks, "passes a block": buf[5] / blocks}
            out[name] = res
            scan.SELECT_SCRATCH_BYTES = default_scratch
            continue
        if part == "entry":
            got = run()
            torch.cuda.synchronize()
            want = scan.tile_topk_plain(rows, scales, sq, valid, q, metric=SM.COSINE,
                                        k_tile=k + 1, tile_n=tile_n)
            res["max_abs_err"] = cs.compare(f"{name}", [x.reshape(-1, k) for x in got],
                                            [x.reshape(-1, k + 1) for x in want])
            del got, want
        if part == "select alone":
            run, scores = select_alone(rows, scales, sq, valid, q, k, tile_n, group)
            got = run()
            torch.cuda.synchronize()
            tiles_g = group // tile_n
            want = torch.topk(scores.view(q.shape[0], tiles_g, tile_n), k + 1, dim=-1)
            res["max_abs_err"] = cs.compare(
                f"{name} (select alone, first group)",
                [x[:, :tiles_g].reshape(-1, k) for x in got],
                [want.values.reshape(-1, k + 1),
                 (want.indices + torch.arange(tiles_g, device=dev)[:, None] * tile_n)
                 .reshape(-1, k + 1)])
            del got, want
        res["ms"] = [cs.cuda_time_ms(run, 20), cs.cuda_time_ms(run, 20)]
        out[name] = res
        scan.SELECT_SCRATCH_BYTES = default_scratch
    print(json.dumps(out), flush=True)
    return 0


def select_main(args) -> int:
    """--select-only: the radix select's entries held at small shapes, then
    timed whole and part by part, each build in a process of its own."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric as SM
    from vectorlite_tpu_torch.kernels import _build, scan

    card = cs.card_line()
    _build.build_all(["select"])
    _build.load("select")
    ptxas = _build.ptxas_report("select")
    for line in ptxas:
        cs.log(f"  select ptxas: {line}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng([args.seed, 16])
    errs = {}
    for n, d, b in ((16384, 100, 5), (8192, 99, 3), (65536, 384, 256), (16384, 768, 70)):
        rows, sq, valid, q = inputs(dev, rng, n, d, b, 4096)
        cases = [(257, 2048), (300, n), (1024, 4096), (2048, 2048), (2049, n), (4096, n),
                 (n, n), (2049, 4096), (4096, 4096)]
        cases += [(33, 65536), (300, 65536)] if n >= 65536 else []
        for dtype, (v, scales) in rows.items():
            for metric in (SM.COSINE, SM.EUCLIDEAN, SM.DOT_PRODUCT):
                for k, tile_n in cases:
                    if metric is SM.DOT_PRODUCT and 2 * k >= tile_n:
                        continue  # dots near 0 (the card test holds them to float64)
                    kernel = scan.exact_route(v.dtype, k, metric, tile_n)
                    if kernel.library != "select":
                        raise AssertionError(f"k {k}, tile {tile_n}: routed to {kernel.symbol}")
                    got = scan.tile_topk_cuda(v, scales, sq, valid, q, metric=metric, k_tile=k,
                                              tile_n=tile_n)
                    torch.cuda.synchronize()
                    kw = min(k + 1, tile_n)
                    want = scan.tile_topk_plain(v, scales, sq, valid, q, metric=metric,
                                                k_tile=kw, tile_n=tile_n)
                    err = cs.compare(f"{kernel.symbol} {dtype} {n}x{d} B{b} t{tile_n} k{k} "
                                     f"{metric.name}", [x.reshape(-1, k) for x in got],
                                     [x.reshape(-1, kw) for x in want])
                    errs[dtype] = max(errs.get(dtype, 0.0), err)
    cs.log(f"  small shapes: every select entry agrees (max |score diff| {errs}) [{card}]")
    if args.check_only:
        print(card, flush=True)
        print(json.dumps({"card": card, "ptxas": ptxas, "max_abs_err": errs}), flush=True)
        return 0
    libs = {"entry": _build._target("select")}
    with concurrent.futures.ThreadPoolExecutor(len(SELECT_VARIANTS) - 1) as pool:  # one nvcc each
        built = {part: pool.submit(build_source_variant, _build, "select", edits)
                 for part, edits in SELECT_VARIANTS.items() if edits}
    libs.update({part: path.result() for part, path in built.items()})
    out = {}
    for part, path in libs.items():
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--select-part", part,
             "--select-lib", str(path), "--seed", str(args.seed)],
            capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(ROOT)})
        if done.returncode != 0:
            raise RuntimeError(f"select {part}: exit {done.returncode}\n{done.stdout}"
                               f"{done.stderr}")
        for line in done.stdout.splitlines()[:-1]:
            cs.log(line)
        for name, res in json.loads(done.stdout.splitlines()[-1]).items():
            out.setdefault(name, {})[part] = res
    for name, res in out.items():
        cs.log(f"  {name} (tile {res['entry']['tile']}, groups of {res['entry']['group_rows']} "
               "rows): " + "; ".join(f"{part} {' / '.join(f'{t:.4f}' for t in r['ms'])} ms"
                                     for part, r in res.items() if "ms" in r)
               + f"; profile {res['profile']['cycles a block']} [{card}]")
    print(card, flush=True)
    print(json.dumps({"card": card, "ptxas": ptxas, "max_abs_err": errs, "ms": out}),
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-only", action="store_true")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--wide-only", action="store_true")
    only.add_argument("--select-only", action="store_true")
    only.add_argument("--precision", action="store_true",
                      help="only the select entries' dot products near 0 against float64, "
                           "with and without the slice-at-a-time sums")
    ap.add_argument("--select-part", help=argparse.SUPPRESS)
    ap.add_argument("--select-lib", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_exact_topk: no CUDA device is available", file=sys.stderr)
        return 1
    if args.select_part:
        return select_timings(args)
    if args.select_lib:
        return precision_run(args)
    if args.select_only:
        return select_main(args)
    if args.precision:
        return precision_main(args)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric
    from vectorlite_tpu_torch.kernels import _build, scan

    card = cs.card_line()
    sources = ["wide"] if args.wide_only else ["exact", "wide"]
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
    libs = {source: {"body": _build.load(source)} for source in sources}
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

        n1 = cs.cuda_time_ms(new, 20)
        n2 = cs.cuda_time_ms(new, 20)
        ms = {"new": [n1, n2]}
        for variant, lib in libs[source].items():
            _build._libs[source] = lib
            ms[variant] = cs.cuda_time_ms(new, 20)
            if variant in VARIANTS and VARIANTS[variant][:1] == PROFILE[:1]:
                s_out = new()[0]
                torch.cuda.synchronize()
                qbs, t = s_out.shape[0] // 64, s_out.shape[1]  # csrc/hopper.cuh one_wave_run
                per = -(-(t * qbs) // torch.cuda.get_device_properties(0).multi_processor_count)
                prof = torch.stack([s_out[qb * 64 + w, t0, :4] for qb in range(qbs)
                                    for t0 in range(0, t, per) for w in range(8)]).double()
                ms[f"{variant}: per warp"] = {key: float(prof[:, j].mean()) for j, key in enumerate(
                    ("merge_cycles", "candidate_block_cycles", "candidates", "group_chunks"))}
                cs.log(f"    {variant} (means a warp): {ms[f'{variant}: per warp']}")
        _build._libs[source] = libs[source]["body"]
        out[name] = ms
        cs.log(f"  {name} (k {k}, tile {tile_n}): tensor-core body {n1:.4f} / {n2:.4f} ms; "
               + ", ".join(f"{var} {t:.4f}" for var, t in ms.items()
                           if isinstance(t, float)) + f" [{card}]")
    print(card, flush=True)
    print(json.dumps({"card": card, "plans": plans, "wide_plans": wide_plans,
                      "max_abs_err": errs, "ms": out}), flush=True)
    return 0


def precision_main(args) -> int:
    """--precision: the select entries and their form without the slice
    sums, each built and measured in a process of its own
    (precision_run)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vectorlite_tpu_torch.kernels import _build

    card = cs.card_line()
    _build.build_all(["select"])
    libs = {"body": _build._target("select"),
            "no slice sums": build_variant(_build, "no slice sums", NO_SLICE_SUMS, "select")}
    out = {}
    for label, path in libs.items():
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--select-lib", str(path),
             "--precision", "--seed", str(args.seed)],
            capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(ROOT)})
        if done.returncode != 0:
            raise RuntimeError(f"select {label}: exit {done.returncode}\n{done.stdout}"
                               f"{done.stderr}")
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
