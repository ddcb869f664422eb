"""The port stands alone: no JAX, nothing of the JAX package and no
aiohttp (its server is on the standard library), and no silent CPU
fallback for its entry points."""

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
    """Every module of the package (api/server.py, api/_http.py, cli.py,
    remote.py and tools.py among them) and the scripts that drive it."""
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
        "if m in ('jax', 'aiohttp') or m.startswith(('jax.', 'jaxlib', "
        "'vectorlite_tpu.', 'aiohttp.')) or m == 'vectorlite_tpu')))\n"
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
            assert root not in ("jax", "jaxlib", "vectorlite_tpu", "aiohttp"), (path, name)


def test_entry_points_need_cuda_without_device(monkeypatch):
    from vectorlite_tpu_torch import (
        FlatIndex,
        HNSWIndex,
        MiniLMEmbedder,
        MockEmbeddingFunction,
        SimilarityMetric,
        VectorLiteClient,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FlatIndex(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        HNSWIndex(8, SimilarityMetric.COSINE)
    tiny = {"hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2,
            "intermediate_size": 16, "vocab_size": 1200, "max_position_embeddings": 16}
    with pytest.raises(RuntimeError, match="CUDA"):
        MiniLMEmbedder.random_init(config=tiny)
    assert HNSWIndex(8, SimilarityMetric.COSINE, device="cpu").device.type == "cpu"
    assert MiniLMEmbedder.random_init(config=tiny, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorLiteClient(MockEmbeddingFunction(8))
    with pytest.raises(RuntimeError, match="CUDA"):
        FlatIndex(8, device="cuda")
    assert FlatIndex(8, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: p.name)
def test_sources_name_no_hnsw_refusal(path):
    """HNSW is ported: no source imports, raises or names the refusal
    ``HNSWNotPorted`` that stood in for it."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert "HNSWNotPorted" not in [a.name for a in node.names], path
        elif isinstance(node, ast.Name):
            assert node.id != "HNSWNotPorted", path
        elif isinstance(node, ast.Attribute):
            assert node.attr != "HNSWNotPorted", path
    assert "HNSWNotPorted" not in path.read_text(), path


def test_server_serves_with_aiohttp_unimportable():
    """The server, CLI, remote client and tools import and serve a
    request where aiohttp cannot be imported (as on a machine that has
    only the standard library, torch and numpy)."""
    code = (
        "import json, sys, urllib.request\n"
        "sys.modules['aiohttp'] = None\n"
        "import vectorlite_tpu_torch as vl\n"
        "from vectorlite_tpu_torch import cli, remote, tools\n"
        "from vectorlite_tpu_torch.api import server\n"
        "client = vl.VectorLiteClient(vl.MockEmbeddingFunction(8), device='cpu')\n"
        "srv = server.bind(server.create_app(client)).start()\n"
        "rc = remote.RemoteClient(srv.url)\n"
        "rc.create_collection('c', 'flat')\n"
        "rc.add_texts('c', ['alpha', 'beta'])\n"
        "hit = rc.search_text('c', 'beta', k=1)[0]\n"
        "health = json.loads(urllib.request.urlopen(srv.url + '/health').read())\n"
        "srv.close()\n"
        "print(json.dumps([health, hit.id, 'aiohttp' in sys.modules and "
        "sys.modules['aiohttp'] is not None]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    health, hit, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert health == {"status": "healthy", "service": "vectorlite"}
    assert hit == 1 and loaded is False


def test_cli_needs_cuda_without_device(monkeypatch):
    """With no card reported and no --device, the CLI fails with
    resolve_device's error before it builds anything; it never serves
    from the CPU in the card's place."""
    from vectorlite_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(["--mock-embeddings", "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        cli.main(["--mock-embeddings", "--port", "0", "--device", "cuda"])
