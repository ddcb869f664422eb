"""Nothing the benchmark runs loads JAX or the JAX package: the check
compares whole top-level names, so the port's name passes though it
begins with the JAX package's; and the reference imports nothing of the
program."""

import ast
import subprocess
import sys

from benchmark import run, spec


def test_whole_top_level_names():
    f = run.forbidden_modules
    assert f(["vectorlite_tpu_torch", "vectorlite_tpu_torch.index.flat", "numpy"]) == []
    assert f(["jaxtyping", "flaxen", "vectorlite_tpu_extra"]) == []
    assert f(["vectorlite_tpu.index.flat"]) == ["vectorlite_tpu"]
    assert f(["jax", "jaxlib.xla_client", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_reference_side_imports_nothing_of_the_program():
    for name in ("reference.py", "compare.py", "control.py", "data.py", "roofline.py"):
        tree = ast.parse((spec.HERE / name).read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("vectorlite_tpu_torch", "vectorlite_tpu",
                                               "jax", "jaxlib", "flax"), (name, m)


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import json, sys\n"
        "import benchmark.run, benchmark.calibrate, benchmark.system, benchmark.trace\n"
        "import benchmark.loops.closed, vectorlite_tpu_torch\n"
        "from benchmark import spec\n"
        "for m in spec.benchmark_json()['end_to_end'] + spec.benchmark_json()['per_layer']:\n"
        "    spec.load_reader(m['name'])\n"
        "print(json.dumps(benchmark.run.forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
