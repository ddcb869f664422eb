"""The port's CLI (``python -m vectorlite_tpu_torch.cli``) on the CPU.

Counterpart of the JAX package's CLI: ``--filepath`` preloads a ``.vlc``,
``--autosave-dir`` restores and ``--wal-dir`` replays before the server
starts, SIGTERM runs the final autosave flush. Here it runs as a
subprocess with ``--device cpu`` on a free localhost port; a ``kill -9``
loses no acknowledged write. Without a card and without ``--device`` it
fails (tests/test_torch_isolation.py); with model files present it
refuses to serve the mock embedder in MiniLM's place.
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
    assert "Could not load embedding model (Tokenizer file not found:" in caplog.text
    assert "using mock embedder" in caplog.text
    assert isinstance(cli.build_embedder(None, mock=True), tvl.MockEmbeddingFunction)


@pytest.mark.parametrize("name", ["tokenizer.json", "config.json", "model.safetensors"])
def test_build_embedder_refuses_to_stand_in_for_model_files(tmp_path, name):
    """Model files present: the unported MiniLM is named in the error; the
    mock is never served in its place."""
    (tmp_path / name).write_text("{}")
    with pytest.raises(RuntimeError, match="MiniLM embedder is not ported") as e:
        cli.build_embedder(str(tmp_path), mock=False)
    assert name in str(e.value) and "--mock-embeddings" in str(e.value)


def test_model_path_env_and_flag(tmp_path, monkeypatch):
    """--model-path defaults to $VECTORLITE_MODEL_PATH, as in the JAX CLI."""
    (tmp_path / "tokenizer.json").write_text("{}")
    monkeypatch.setenv("VECTORLITE_MODEL_PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="MiniLM"):
        cli.main(["--device", "cpu", "--port", "0"])
