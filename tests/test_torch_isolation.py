"""The port stands alone: no JAX and nothing of the JAX package, and no
silent CPU fallback for its entry points."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "vectorlite_tpu_torch"


def port_sources():
    return sorted(PACKAGE.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "probe_k6_read_once.py",
        ROOT / "scripts" / "probe_lanes_staging.py"]


def test_importing_every_module_loads_no_jax():
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PACKAGE.rglob("*.py"))
    ]
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules "
        "if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'vectorlite_tpu.')) "
        "or m == 'vectorlite_tpu')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "vectorlite_tpu"), (path, name)


def test_entry_points_need_cuda_without_device(monkeypatch):
    from vectorlite_tpu_torch import FlatIndex, MockEmbeddingFunction, VectorLiteClient

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FlatIndex(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorLiteClient(MockEmbeddingFunction(8))
    with pytest.raises(RuntimeError, match="CUDA"):
        FlatIndex(8, device="cuda")
    assert FlatIndex(8, device="cpu").device.type == "cpu"
