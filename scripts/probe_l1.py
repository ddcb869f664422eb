"""K4's FADD-stream entries (vectorlite_tpu_torch/csrc/l1.cu) on one CUDA
card: held, counted, timed and taken apart.

    env PYTHONPATH=. python3 scripts/probe_l1.py [--seed S] [--check-only]
    env PYTHONPATH=. python3 scripts/probe_l1.py --select-only [--parent DIR]
        [--seed S] [--check-only]

Builds csrc/l1.cu and prints ptxas's registers and spills
of its entries, each launch's ring at D 99, 100, 384 and 768 (stages;
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
times it with CUDA events, twice, beside the bound 2 B N D / 33.5e12 (two
FADDs a (query, row, dimension) at the card's FADD issue rate), and
variants of l1.cu built from edited copies, instruments that compute
wrong results:

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

--select-only takes the entries past k 32 (scan_topk_l1_select / _bf16:
the stream's scores of a group of tiles into a scratch, then the radix
select of csrc/select.cuh) apart as scripts/probe_exact_topk.py
--select-only takes K1's: it holds them tile by tile against
tile_topk_plain at small shapes (k 33, 64, 100, 300 and k = tile_n; D 99,
100, 384, 768; 256- and 384-row tiles), then times them at 2^20 x 384, B
256, over f32 and bf16 rows at k 33, 100, 300 and 1,024 and over bf16
rows at k 100's pool of 256, on the tiles exact_tile grows from the
index's 2,048, and at 65,536 x 384, B 64, k 300 (the old shape), twice
each (20 launches), in four builds of l1.cu, each in a process of its own:

* entry: the package's build, held against the plain version first;
* scores alone: the select's launches edited out (the stream, its
  reciprocals and its stores to the scratch);
* stream alone: nor the stores (a compare that never holds keeps the
  scores live);
* select alone: the scores' launches edited out; the probe fills a
  scratch of its own with the first group's plain scores and launches
  the entry over it (the first group's lists held against their plain
  top k).

With --parent DIR (the parent commit unpacked there by git archive) it
also builds that tree's csrc/scan.cu and times its CUDA-core scan_topk_l1
(the lists past k 32 this route replaced) at the same shapes on the
parent's tile (2,048 rows), held against the plain version once a shape,
in a process of its own before and after the four (parent, builds,
parent): the before and the after in one call.

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
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

SELECT = "    if (live) finish_chunk(c, ok);\n"
SINK = ("    if (live) {\n      float t = 0.0f;\n#pragma unroll\n"
        "      for (int i = 0; i < WQ; ++i)\n#pragma unroll\n"
        "        for (int j = 0; j < RPL; ++j) t = fmaxf(t, acc[i][j]);\n"
        "      if (t == 1.0e30f) out_s[c] = t + ok;\n    }\n")
# the scores computed, neither seeded nor merged into the lists
LISTS = "      const int r0 = static_cast<int>(row0);\n      if (c == 0) {\n"
NO_LISTS = ("      const int r0 = static_cast<int>(row0);\n      {\n        float t = -1.0f;\n"
            "#pragma unroll\n        for (int i = 0; i < WQ; ++i)\n#pragma unroll\n"
            "          for (int j = 0; j < RPL; ++j) t = fmaxf(t, acc[i][j]);\n"
            "        if (t == 1.0e30f) out_s[r0] = t;\n      }\n      if (false) {\n")
LATER = "      } else {\n        merge_lists<0, false>"
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
    "scores only": [(LISTS, NO_LISTS),
                    (LATER, "      } else if (false) {\n        merge_lists<0, false>")],
    "no inserts": [(INSERTS, "    while (false) {\n")],
    "no staging": STATIC_RING,
    "exact division": [(RCP, EXACT_RCP)],
    "stream only": [(SELECT, SINK), *STATIC_RING],
    **{f"unroll {u}": [(UNROLL, UNROLL.replace("1", str(u), 1))] for u in (2, 4)},
}
#: the FADD bound: 132 SMs x 128 lanes x 1.98 GHz, two FADDs a (query, row, dimension)
FADD_PER_S = 33.5e12

# --select-only: l1.cu's two launches a group of tiles, taken apart by
# editing the source
SCORES_LAUNCH = "    int e = launch_scores<T>("
SELECT_LAUNCH = "    if (e == 0)\n      e = sel::launch_select("
NO_SELECT = (SELECT_LAUNCH, "    if (false)\n      e = sel::launch_select(")
STORE = "          if (row0 + lane + 32 * j < n_rows) dst[32 * j] = acc[i][j];"
SELECT_VARIANTS = {
    "entry": [],
    "scores alone": [NO_SELECT],
    "stream alone": [NO_SELECT, (STORE, "          if (acc[i][j] == 1.0e30f) dst[32 * j] = acc[i][j];")],
    "select alone": [(SCORES_LAUNCH, "    int e = 0;\n    if (false) e = launch_scores<T>(")],
}
#: --select-only's timed cases: (name, rows, k, rows of the corpus, queries)
SELECT_TIMED = [
    *((f"{dt} k{k}", dt, k, 1 << 20, 256) for dt in ("f32", "bf16") for k in (33, 100, 300, 1024)),
    ("bf16 k256", "bf16", 256, 1 << 20, 256),
    ("f32 k300, old shape", "f32", 300, 65536, 64),
    ("bf16 k300, old shape", "bf16", 300, 65536, 64),
]
#: the index's caller tile, which exact_tile grows past k 32 (the parent
#: scanned at it)
CALLER_TILE = 2048


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
        if m:  # the scan's kernels (lists; scores); the reciprocal's check is not counted
            fn = m.group(1)
            kind = " scores" if "Lb1E" in fn else ""
            name = ("f32" + kind if "l1_kernelIf" in fn else "bf16" + kind
                    if "l1_kernelIt" in fn else None)
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


def build_parent(_build, parent: Path) -> Path:
    """The parent tree's csrc/scan.cu (with its own headers), built with
    this tree's nvcc flags into this tree's build directory."""
    csrc = parent / "vectorlite_tpu_torch" / "csrc"
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sorted((*csrc.glob("*.cuh"), csrc / "scan.cu")))
        + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libscan_parent_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        part = out.with_suffix(f".{os.getpid()}.tmp")
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(part),
                               str(csrc / "scan.cu")], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"the parent's scan.cu does not build:\n{done.stdout}{done.stderr}")
        os.replace(part, out)
    return out


def select_inputs(dev, seed):
    """--select-only's operands: 2^20 x 384 N(0, 1) f32 rows and their bf16
    copy, every row valid, 256 N(0, 1) queries (the main-path shape; the
    old shape takes the first 65,536 rows and 64 queries)."""
    import chip_smoke as cs

    n, d, b = 1 << 20, cs.D, cs.B
    g = np.random.default_rng([seed, 17])
    v = torch.from_numpy(g.standard_normal((n, d), dtype=np.float32)).to(dev)
    q = torch.from_numpy(g.standard_normal((b, d), dtype=np.float32)).to(dev)
    return {"f32": v, "bf16": v.to(torch.bfloat16)}, torch.ones(n, dtype=torch.bool,
                                                                   device=dev), q


def select_part(args) -> int:
    """``--l1-part NAME --l1-lib PATH``: one build (SELECT_VARIANTS, or the
    parent's scan.cu) in a process of its own, no other build of it
    loaded: each SELECT_TIMED case timed twice (20 launches each; the
    parent's CUDA-core lists 2 each); the entry and the parent held
    against the plain version first, the select alone's first group of
    lists against the plain lists of the scores it read. Prints a JSON
    object last."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric as SM
    from vectorlite_tpu_torch.kernels import _build, scan

    part = args.l1_part
    lib = ctypes.CDLL(args.l1_lib)
    if part != "parent":
        _build._libs["l1"] = lib
    dev = torch.device("cuda", 0)
    rows_of, valid_all, q_all = select_inputs(dev, args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, dtype, k, n, b in SELECT_TIMED:
        rows, valid, q = rows_of[dtype][:n], valid_all[:n], q_all[:b].contiguous()
        d = rows.shape[1]
        tile_n = CALLER_TILE if part == "parent" else scan.exact_tile(n, CALLER_TILE, k,
                                                                       SM.MANHATTAN)
        res = {"tile": tile_n}
        if part == "parent":
            fn = lib.scan_topk_l1
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, *[ctypes.c_void_p] * 3,
                           *[ctypes.c_int] * 5, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            q_t = q.T.contiguous()

            def run(rows=rows, valid=valid, q_t=q_t, k=k, n=n, b=b, d=d, tile_n=tile_n):
                out_s = torch.empty((b, n // tile_n, k), dtype=torch.float32, device=dev)
                out_i = torch.empty((b, n // tile_n, k), dtype=torch.int32, device=dev)
                if fn(q_t.data_ptr(), rows.data_ptr(), int(rows.dtype == torch.bfloat16),
                      valid.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), n, d, b, k, tile_n,
                      stream) != 0:
                    raise RuntimeError("the parent's scan_topk_l1 did not launch")
                return out_s, out_i
        elif part == "select alone":
            group = scan.select_group_rows(n, b, tile_n)
            scores = scan.tile_scores(rows[:group], None, None, valid[:group], q,
                                      SM.MANHATTAN).contiguous()
            kernel = scan.exact_route(rows.dtype, k, SM.MANHATTAN, tile_n)
            q_op = scan.l1_query_operand(q, rows.dtype)

            def run(rows=rows, valid=valid, q_op=q_op, scores=scores, kernel=kernel, k=k, n=n,
                    b=b, d=d, tile_n=tile_n, group=group):
                out_s = torch.empty((b, n // tile_n, k), dtype=torch.float32, device=dev)
                out_i = torch.empty((b, n // tile_n, k), dtype=torch.int32, device=dev)
                kernel.launch(q_op.data_ptr(), rows.data_ptr(), valid.data_ptr(),
                              scores.data_ptr(), group, out_s.data_ptr(), out_i.data_ptr(), n, d,
                              b, k, tile_n, stream)
                return out_s, out_i
            got = run()
            torch.cuda.synchronize()
            tiles_g = group // tile_n
            want = torch.topk(scores.view(b, tiles_g, tile_n), k + 1, dim=-1)
            res["max_abs_err"] = cs.compare(
                f"{name} (select alone, first group)",
                [x[:, :tiles_g].reshape(-1, k) for x in got],
                [want.values.reshape(-1, k + 1),
                 (want.indices + torch.arange(tiles_g, device=dev)[:, None] * tile_n)
                 .reshape(-1, k + 1)])
            del got, want
        else:
            def run(rows=rows, valid=valid, q=q, k=k, tile_n=tile_n):
                return scan.tile_topk_cuda(rows, None, None, valid, q, metric=SM.MANHATTAN,
                                           k_tile=k, tile_n=tile_n)
        if part in ("entry", "parent"):
            got = run()
            torch.cuda.synchronize()
            want = scan.tile_topk_plain(rows, None, None, valid, q, metric=SM.MANHATTAN,
                                        k_tile=k + 1, tile_n=tile_n)
            res["max_abs_err"] = cs.compare(f"{part} {name}", [x.reshape(-1, k) for x in got],
                                            [x.reshape(-1, k + 1) for x in want])
            del got, want
        reps = 2 if part == "parent" else 20
        res["ms"] = [cs.cuda_time_ms(run, reps), cs.cuda_time_ms(run, reps)]
        cs.log(f"  {part}: {name} (tile {tile_n}) {' / '.join(f'{t:.4f}' for t in res['ms'])} ms")
        out[name] = res
    print(json.dumps(out), flush=True)
    return 0


def select_main(args) -> int:
    """--select-only: the select entries held at small shapes, then timed
    whole and part by part (and the parent's CUDA-core lists beside
    them), each build in a process of its own."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from probe_exact_topk import inputs
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric as SM
    from vectorlite_tpu_torch.kernels import _build, scan

    card = cs.card_line()
    _build.build_all(["l1"])
    _build.load("l1")
    ptxas = _build.ptxas_report("l1")
    for line in ptxas:
        cs.log(f"  l1 ptxas: {line}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng([args.seed, 16])
    errs = {}
    # (rows, D, B, tile, lists): k = tile_n only where the queries and
    # tiles are few (compare's near-tie loop runs once an id mismatch)
    for n, d, b, cases in ((8192, 99, 3, ((2048, (33, 64, 100, 300, 2048)), (8192, (300, 8192)))),
                           (16384, 100, 5, ((2048, (33, 100, 2048)), (16384, (300, 16384)))),
                           (65536, 384, 256, ((256, (33, 64, 100)), (32768, (33, 100, 300)))),
                           (16384, 768, 70, ((4096, (33, 100, 300)),)),
                           (12288, 384, 64, ((384, (33, 100, 300, 384)), (12288, (100, 300))))):
        rows, _, valid, q = inputs(dev, rng, n, d, b, 2048)
        for dtype in ("f32", "bf16"):
            v = rows[dtype][0]
            for tile_n, ks in cases:
                for k in ks:
                    kernel = scan.exact_route(v.dtype, k, SM.MANHATTAN, tile_n)
                    if not kernel.symbol.startswith("scan_topk_l1_select"):
                        raise AssertionError(f"k {k}, tile {tile_n}: routed to {kernel.symbol}")
                    before = kernel.launches
                    got = scan.tile_topk_cuda(v, None, None, valid, q, metric=SM.MANHATTAN,
                                              k_tile=k, tile_n=tile_n)
                    torch.cuda.synchronize()
                    if kernel.launches != before + 1:
                        raise AssertionError(f"{kernel.symbol} did not launch")
                    kw = min(k + 1, tile_n)
                    want = scan.tile_topk_plain(v, None, None, valid, q, metric=SM.MANHATTAN,
                                                k_tile=kw, tile_n=tile_n)
                    err = cs.compare(f"{kernel.symbol} {dtype} {n}x{d} B{b} t{tile_n} k{k}",
                                     [x.reshape(-1, k) for x in got],
                                     [x.reshape(-1, kw) for x in want])
                    errs[dtype] = max(errs.get(dtype, 0.0), err)
    cs.log(f"  small shapes: both select entries agree (max |score diff| {errs}) [{card}]")
    if args.check_only:
        print(card, flush=True)
        print(json.dumps({"card": card, "ptxas": ptxas, "max_abs_err": errs}), flush=True)
        return 0
    from probe_exact_topk import build_source_variant

    with concurrent.futures.ThreadPoolExecutor(len(SELECT_VARIANTS)) as pool:  # one nvcc each
        built = {part: pool.submit(build_source_variant, _build, "l1", edits)
                 for part, edits in SELECT_VARIANTS.items() if edits}
        parent = pool.submit(build_parent, _build, Path(args.parent)) if args.parent else None
    libs = [("entry", _build._target("l1"))]
    libs += [(part, path.result()) for part, path in built.items()]
    if parent is not None:
        libs = [("parent", parent.result()), *libs, ("parent", parent.result())]
    out = {}
    for part, path in libs:
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--l1-part", part,
             "--l1-lib", str(path), "--seed", str(args.seed)],
            capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(ROOT)})
        if done.returncode != 0:
            raise RuntimeError(f"l1 {part}: exit {done.returncode}\n{done.stdout}{done.stderr}")
        for line in done.stdout.splitlines()[:-1]:
            cs.log(line)
        for name, res in json.loads(done.stdout.splitlines()[-1]).items():
            slot = out.setdefault(name, {})
            if part in slot:  # the parent's second process
                slot[part]["ms"] += res["ms"]
            else:
                slot[part] = res
    for name, res in out.items():
        cs.log(f"  {name}: " + "; ".join(
            f"{part} (tile {r['tile']}) {' / '.join(f'{t:.4f}' for t in r['ms'])} ms"
            for part, r in res.items()) + f" [{card}]")
    print(card, flush=True)
    print(json.dumps({"card": card, "ptxas": ptxas, "max_abs_err": errs, "ms": out}),
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--select-only", action="store_true")
    ap.add_argument("--parent", help="a git archive of the parent commit, unpacked")
    ap.add_argument("--l1-part", help=argparse.SUPPRESS)
    ap.add_argument("--l1-lib", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_l1: no CUDA device is available", file=sys.stderr)
        return 1
    if args.l1_part:
        return select_part(args)
    if args.select_only:
        return select_main(args)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from probe_exact_topk import inputs
    from vectorlite_tpu_torch.core.metrics import SimilarityMetric
    from vectorlite_tpu_torch.kernels import _build, scan

    SM = SimilarityMetric
    card = cs.card_line()
    _build.build_all(["l1"])
    _build.load("l1")
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
        dims = 4 if dtype.startswith("f32") else 8
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

    from probe_exact_topk import build_source_variant

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc each
        built = {name: pool.submit(build_source_variant, _build, "l1", edits)
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

        n1 = cs.cuda_time_ms(new, 20)
        n2 = cs.cuda_time_ms(new, 20)
        ms = {"new": [n1, n2]}
        for variant, lib in libs.items():
            _build._libs["l1"] = lib
            ms[variant] = cs.cuda_time_ms(new, 20)
        _build._libs["l1"] = body
        ms["clock under load (MHz, W, W)"] = clock_under_load(new)
        cs.log(f"  {name}: SM clock, power draw, power limit under load: "
               f"{ms['clock under load (MHz, W, W)']}")
        out[name] = ms
        cs.log(f"  {name}: FADD stream {n1:.4f} / {n2:.4f} ms ({bound_ms / n1:.1%} of the "
               f"bound {bound_ms:.4f}); "
               + ", ".join(f"{var} {t:.4f} ({bound_ms / t:.1%})" for var, t in ms.items()
                           if isinstance(t, float)) + f" [{card}]")
    print(card, flush=True)
    print(json.dumps({"card": card, "plans": plans, "sass": sass, "max_abs_err": errs,
                      "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
