"""The port's CLI (``python -m vectorlite_tpu_torch.cli``) on the CPU.

Counterpart of the JAX package's CLI: ``--filepath`` preloads a ``.vlc``,
``--autosave-dir`` restores and ``--wal-dir`` replays before the server
starts, SIGTERM runs the final autosave flush. Here it runs as a
subprocess with ``--device cpu`` on a free localhost port; a ``kill -9``
loses no acknowledged write. Without a card and without ``--device`` it
fails (tests/test_torch_isolation.py); with a model directory it serves
the MiniLM encoder, and the mock (with a warning) where a file is missing.
"""

from __future__ import annotations

import logging
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import vectorlite_tpu_torch as tvl
from vectorlite_tpu_torch import cli
from vectorlite_tpu_torch.remote import RemoteClient

ROOT = pathlib.Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class CliServer:
    """``python -m vectorlite_tpu_torch.cli`` as a subprocess, waited
    for until GET /health answers."""

    def __init__(self, *args, timeout=90):
        self.port = free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "vectorlite_tpu_torch.cli", "--mock-embeddings",
             "--device", "cpu", "--port", str(self.port), *args],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        deadline = time.monotonic() + timeout
        while True:
            try:
                with urllib.request.urlopen(self.url + "/health", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.proc.kill()
                raise RuntimeError(f"the CLI did not come up:\n{self.proc.communicate()[0]}")
            time.sleep(0.1)
        self.rc = RemoteClient(self.url)

    def stop(self, sig=signal.SIGTERM) -> tuple[int, str]:
        self.proc.send_signal(sig)
        try:
            out, _ = self.proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise
        return self.proc.returncode, out


def test_cli_preloads_a_vlc_and_stops_cleanly_on_sigterm(tmp_path):
    client = tvl.VectorLiteClient(tvl.MockEmbeddingFunction(), device="cpu")
    client.create_collection("pre", "flat")
    client.add_texts_to_collection("pre", ["alpha", "beta", "gamma"], [{"i": 0}, None, None])
    vlc = tmp_path / "pre.vlc"
    client.get_collection("pre").save_to_file(vlc)
    snaps = tmp_path / "snaps"
    srv = CliServer("--filepath", str(vlc), "--autosave-dir", str(snaps),
                    "--autosave-interval", "3600")
    try:
        assert srv.rc.list_collections() == ["pre"]
        assert srv.rc.get_collection_info("pre")["count"] == 3
        hit = srv.rc.search_text("pre", "beta", k=1)[0]
        assert hit.id == 1 and hit.text == "beta"
        srv.rc.add_text("pre", "delta")
    finally:
        code, out = srv.stop()
    assert code == 0, out
    assert "Successfully loaded collection 'pre'" in out
    assert "Device: cpu" in out
    # the final flush on SIGTERM snapshotted the acknowledged add
    restored = tvl.Collection.load_from_file(snaps / "pre.vlc", device="cpu")
    assert restored.get_info().count == 4


def test_cli_keeps_every_acknowledged_write_across_kill_9(tmp_path):
    """Writes over HTTP, a kill -9, a restart with the same WAL and
    autosave directories: the state and a search equal the ones before."""
    args = ("--wal-dir", str(tmp_path / "wal"), "--autosave-dir", str(tmp_path / "snaps"),
            "--autosave-interval", "3600")
    srv = CliServer(*args)
    try:
        rc = srv.rc
        rc.create_collection("live", "flat")
        texts = [f"record {i} {w}" for i, w in
                 enumerate(np.random.default_rng(3).choice(["amber", "birch", "cobalt"], 300))]
        ids = []
        for lo in range(0, 300, 100):
            ids += rc.add_texts("live", texts[lo:lo + 100],
                                [{"bucket": i % 4} for i in range(lo, lo + 100)])
        assert ids == list(range(300))
        for vid in range(0, 300, 7):
            rc.delete_vector("live", vid)
        for vid in range(1, 300, 11):
            if vid % 7:
                rc.update_metadata("live", vid, {"bucket": 9})
        assert rc.delete_where("live", {"bucket": 2}) > 0
        want_state = rc.list_vectors("live", 0, 1000, include_values=True)
        want = rc.search_texts("live", ["record 5 amber", "birch", "cobalt 17"], k=10)
    finally:
        srv.proc.kill()  # no flush, no close
        srv.proc.communicate(timeout=60)
    srv = CliServer(*args)
    try:
        got_state = srv.rc.list_vectors("live", 0, 1000, include_values=True)
        got = srv.rc.search_texts("live", ["record 5 amber", "birch", "cobalt 17"], k=10)
    finally:
        code, out = srv.stop()
    assert code == 0, out
    assert got_state[1] == want_state[1] and got_state[0] == want_state[0]
    assert [[(h.id, h.text, h.metadata) for h in row] for row in got] == [
        [(h.id, h.text, h.metadata) for h in row] for row in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose([h.score for h in a], [h.score for h in b], rtol=0, atol=1e-12)
    assert "WAL recovery applied" in out


def test_build_embedder_without_model_files_falls_back_with_warning(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="vectorlite_tpu_torch.cli"):
        emb = cli.build_embedder(str(tmp_path / "absent"), mock=False)
    assert isinstance(emb, tvl.MockEmbeddingFunction)
    # the JAX CLI's line: the EmbeddingError's text in the parentheses
    assert ("Could not load embedding model (Embedding generation failed: Tokenizer "
            "file not found:") in caplog.text
    assert "using mock embedder" in caplog.text
    assert isinstance(cli.build_embedder(None, mock=True), tvl.MockEmbeddingFunction)


TINY = {"hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
        "intermediate_size": 64, "vocab_size": 1200, "max_position_embeddings": 32}
WORDS = ("alpha", "beta", "gamma", "delta")


def model_dir(path, weights="pytorch_model.bin"):
    """A synthetic MiniLM directory whose tokenizer gives WORDS the random-
    init encoder's ids."""
    from _minilm_fixtures import hash_vocab, save_model_dir
    from vectorlite_tpu_torch.embed import minilm

    vocab = hash_vocab(minilm._HashTokenizer(TINY["vocab_size"]), WORDS)
    return save_model_dir(path, minilm._random_params(TINY, 0), TINY, vocab, weights=weights)


@pytest.mark.parametrize("name", ["tokenizer.json", "config.json", "pytorch_model.bin"])
def test_build_embedder_falls_back_where_a_model_file_is_missing(tmp_path, name, caplog):
    """The JAX CLI's behaviour: a directory lacking one file serves the
    mock with a warning naming what is missing."""
    (model_dir(tmp_path) / name).unlink()
    with caplog.at_level(logging.WARNING, logger="vectorlite_tpu_torch.cli"):
        emb = cli.build_embedder(str(tmp_path), mock=False, device="cpu")
    assert isinstance(emb, tvl.MockEmbeddingFunction)
    assert "Could not load embedding model" in caplog.text and "not found" in caplog.text


@pytest.mark.parametrize("weights", ["pytorch_model.bin", "model.safetensors"])
def test_build_embedder_loads_minilm_on_the_device(tmp_path, weights):
    from vectorlite_tpu_torch.embed.minilm import MiniLMEmbedder

    emb = cli.build_embedder(str(model_dir(tmp_path, weights)), mock=False, device="cpu")
    assert isinstance(emb, MiniLMEmbedder) and emb.device.type == "cpu"
    want = MiniLMEmbedder.random_init(0, TINY, device="cpu")
    np.testing.assert_allclose(emb.embed_batch_arrays(["alpha beta", "delta"]),
                               want.embed_batch_arrays(["alpha beta", "delta"]), atol=1e-6)


def test_build_embedder_raises_on_an_unsupported_tokenizer(tmp_path):
    """A tokenizer.json of a type the port does not implement is an
    error, never the mock nor another tokenization."""
    import json

    from vectorlite_tpu_torch.errors import EmbeddingError

    d = model_dir(tmp_path)
    spec = json.loads((d / "tokenizer.json").read_text())
    spec["pre_tokenizer"] = {"type": "Metaspace"}
    (d / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(EmbeddingError, match="Metaspace"):
        cli.build_embedder(str(d), mock=False, device="cpu")


def test_model_path_env_and_flag(tmp_path, monkeypatch):
    """--model-path defaults to $VECTORLITE_MODEL_PATH, as in the JAX CLI;
    the server starts with the MiniLM encoder of that directory."""
    model_dir(tmp_path / "m")
    monkeypatch.setenv("VECTORLITE_MODEL_PATH", str(tmp_path / "m"))
    served = {}

    def fake_start_server(client, *args, **kwargs):
        served["embedder"] = client.embedding_function

    from vectorlite_tpu_torch.api import server

    monkeypatch.setattr(server, "start_server", fake_start_server)
    assert cli.main(["--device", "cpu", "--port", "0"]) == 0
    assert type(served["embedder"]).__name__ == "MiniLMEmbedder"
    assert served["embedder"].dimension == TINY["hidden_size"]
    cli.main(["--device", "cpu", "--port", "0", "--model-path", str(tmp_path / "none")])
    assert isinstance(served["embedder"], tvl.MockEmbeddingFunction)
