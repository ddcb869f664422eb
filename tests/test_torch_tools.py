"""The port's JSONL import/export, snapshot and fsck tools
(vectorlite_tpu_torch/tools.py), on the CPU.

Counterpart of tests/test_tools.py: the reference's hand-rolled dataset
loader (reference: tests/integration_test.rs:20-36) in both directions,
local (.vlc, built on ``device="cpu"`` / ``--device cpu`` here; the card
by default) and remote (the port's server over its raw-vector routes).
"""

import io
import json

import numpy as np
import pytest
import torch

from vectorlite_tpu_torch.store.collection import Collection
from vectorlite_tpu_torch.tools import export_jsonl, import_jsonl, main

DIM = 6


def _write_jsonl(path, rows):
    with path.open("w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def _dataset(n, with_ids=True, field="embedding"):
    rng = np.random.default_rng(7)
    rows = []
    for i in range(n):
        emb = rng.standard_normal(DIM)
        emb /= np.linalg.norm(emb)
        row = {"text": f"doc {i}", field: [float(x) for x in emb]}
        if with_ids:
            row["id"] = i * 10
        if i % 2 == 0:
            row["metadata"] = {"even": True}
        rows.append(row)
    return rows


class TestLocalVlc:
    def test_roundtrip_with_explicit_ids(self, tmp_path):
        src = tmp_path / "in.jsonl"
        rows = _dataset(25)
        _write_jsonl(src, rows)
        vlc = tmp_path / "out.vlc"
        n = import_jsonl(str(src), "ds", vlc=str(vlc), batch_size=8, device="cpu")
        assert n == 25

        col = Collection.load_from_file(vlc, device="cpu")
        assert col.get_info().count == 25
        v = col.get_vector(240)
        assert v.text == "doc 24" and v.metadata == {"even": True}
        # file ids preserved; next_id past the max
        assert col.next_id() == 241

        out = tmp_path / "out.jsonl"
        m = export_jsonl(str(out), "ds", vlc=str(vlc), batch_size=7, device="cpu")
        assert m == 25
        got = [json.loads(line) for line in out.read_text().splitlines()]
        assert [g["id"] for g in got] == [r["id"] for r in rows]
        assert got[3]["text"] == "doc 3"
        np.testing.assert_allclose(
            got[3]["embedding"], rows[3]["embedding"], rtol=0, atol=0
        )
        assert "metadata" not in got[3] and got[4]["metadata"] == {
            "even": True
        }

    def test_auto_ids_when_file_has_none(self, tmp_path):
        src = tmp_path / "in.jsonl"
        _write_jsonl(src, _dataset(5, with_ids=False))
        vlc = tmp_path / "out.vlc"
        import_jsonl(str(src), "ds", vlc=str(vlc), device="cpu")
        col = Collection.load_from_file(vlc, device="cpu")
        assert sorted(v.id for v in col.list_vectors(0, 100)[0]) == list(
            range(5)
        )

    def test_values_field_fallback(self, tmp_path):
        src = tmp_path / "in.jsonl"
        _write_jsonl(src, _dataset(3, field="values"))
        vlc = tmp_path / "out.vlc"
        assert import_jsonl(str(src), "ds", vlc=str(vlc), device="cpu") == 3

    def test_append(self, tmp_path):
        src1, src2 = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
        _write_jsonl(src1, _dataset(4, with_ids=False))
        _write_jsonl(
            src2,
            [{"text": "late", "embedding": [1.0] + [0.0] * (DIM - 1)}],
        )
        vlc = tmp_path / "out.vlc"
        import_jsonl(str(src1), "ds", vlc=str(vlc), device="cpu")
        import_jsonl(str(src2), "ds", vlc=str(vlc), append=True, device="cpu")
        col = Collection.load_from_file(vlc, device="cpu")
        assert col.get_info().count == 5
        assert col.get_vector(4).text == "late"

    def test_mixed_ids_rejected(self, tmp_path):
        src = tmp_path / "in.jsonl"
        rows = _dataset(3)
        del rows[2]["id"]
        _write_jsonl(src, rows)
        with pytest.raises(ValueError, match="all-or-none"):
            import_jsonl(str(src), "ds", vlc=str(tmp_path / "o.vlc"),
                         batch_size=2, device="cpu")

    def test_malformed_line_has_lineno(self, tmp_path):
        src = tmp_path / "in.jsonl"
        src.write_text('{"embedding": [1, 2]}\nnot json\n')
        with pytest.raises(ValueError, match=":2:"):
            import_jsonl(str(src), "ds", vlc=str(tmp_path / "o.vlc"), device="cpu")
        src.write_text('{"text": "no embedding"}\n')
        with pytest.raises(ValueError, match="embedding"):
            import_jsonl(str(src), "ds", vlc=str(tmp_path / "o.vlc"), device="cpu")

    def test_url_xor_vlc(self, tmp_path):
        with pytest.raises(ValueError):
            import_jsonl("x.jsonl", "ds")
        with pytest.raises(ValueError):
            export_jsonl("x.jsonl", "ds", url="http://x", vlc="y.vlc")


class TestCli:
    def test_import_export_via_main(self, tmp_path, capsys):
        src = tmp_path / "in.jsonl"
        _write_jsonl(src, _dataset(10))
        vlc = tmp_path / "c.vlc"
        assert main([
            "import", str(src), "-c", "ds", "--vlc", str(vlc),
            "--batch", "4", "--device", "cpu",
        ]) == 0
        assert "imported 10 records" in capsys.readouterr().out
        out = tmp_path / "out.jsonl"
        assert main(["export", str(out), "-c", "ds", "--vlc", str(vlc),
                     "--device", "cpu"]) == 0
        assert "exported 10 records" in capsys.readouterr().out
        assert len(out.read_text().splitlines()) == 10


class TestRemote:
    def test_remote_import_export(self, tmp_path):
        from test_torch_remote import _ServerThread
        from vectorlite_tpu_torch import VectorLiteClient
        from vectorlite_tpu_torch.embed.mock import MockEmbeddingFunction

        srv = _ServerThread(VectorLiteClient(MockEmbeddingFunction(DIM), device="cpu"))
        try:
            url = f"http://127.0.0.1:{srv.port}"
            src = tmp_path / "in.jsonl"
            rows = _dataset(12)
            _write_jsonl(src, rows)
            n = import_jsonl(str(src), "ds", url=url, batch_size=5)
            assert n == 12

            out = tmp_path / "out.jsonl"
            m = export_jsonl(str(out), "ds", url=url, batch_size=5)
            assert m == 12
            got = [json.loads(line) for line in out.read_text().splitlines()]
            assert [g["id"] for g in got] == [r["id"] for r in rows]
            np.testing.assert_allclose(
                got[0]["embedding"], rows[0]["embedding"], atol=1e-12
            )
        finally:
            srv.stop()

    def test_remote_dim_mismatch_fails_fast(self, tmp_path):
        from test_torch_remote import _ServerThread
        from vectorlite_tpu_torch import VectorLiteClient
        from vectorlite_tpu_torch.embed.mock import MockEmbeddingFunction
        from vectorlite_tpu_torch.remote import RemoteClient

        # server embedder is 16-d; the dataset is 6-d: one clear error,
        # and the auto-created collection must not be left behind
        srv = _ServerThread(VectorLiteClient(MockEmbeddingFunction(16), device="cpu"))
        try:
            url = f"http://127.0.0.1:{srv.port}"
            src = tmp_path / "in.jsonl"
            _write_jsonl(src, _dataset(3))
            with pytest.raises(ValueError, match="dimension is 16"):
                import_jsonl(str(src), "ds", url=url)
            assert not RemoteClient(url).has_collection("ds")
        finally:
            srv.stop()

    def test_default_batch_size_survives_server_limit_cap(self, tmp_path):
        """The listing route rejects (not clamps) limit > 1000; the
        remote export pager must clamp _DEFAULT_BATCH=1024 itself or the
        documented default command fails with a 400."""
        from test_torch_remote import _ServerThread
        from vectorlite_tpu_torch import VectorLiteClient
        from vectorlite_tpu_torch.embed.mock import MockEmbeddingFunction

        srv = _ServerThread(VectorLiteClient(MockEmbeddingFunction(DIM), device="cpu"))
        try:
            url = f"http://127.0.0.1:{srv.port}"
            src = tmp_path / "in.jsonl"
            _write_jsonl(src, _dataset(7))
            import_jsonl(str(src), "ds", url=url)  # default batch
            out = tmp_path / "out.jsonl"
            assert export_jsonl(str(out), "ds", url=url) == 7  # default
            assert len(out.read_text().splitlines()) == 7
        finally:
            srv.stop()

    def test_failed_export_preserves_existing_file(self, tmp_path):
        """A re-run that fails early (missing collection here) must not
        truncate the previous export: writes go to a tmp file that is
        atomically renamed only on success."""
        from test_torch_remote import _ServerThread
        from vectorlite_tpu_torch import VectorLiteClient
        from vectorlite_tpu_torch.embed.mock import MockEmbeddingFunction
        from vectorlite_tpu_torch.remote import RemoteError

        srv = _ServerThread(VectorLiteClient(MockEmbeddingFunction(DIM), device="cpu"))
        try:
            url = f"http://127.0.0.1:{srv.port}"
            out = tmp_path / "backup.jsonl"
            out.write_text("precious old backup\n")
            with pytest.raises(RemoteError):
                export_jsonl(str(out), "missing-collection", url=url)
            assert out.read_text() == "precious old backup\n"
            assert not (tmp_path / "backup.jsonl.tmp").exists()
        finally:
            srv.stop()


class TestStrictness:
    def test_mixed_ids_rejected_idless_first(self, tmp_path):
        """Ids after an id-less first record must raise, not be silently
        discarded and re-allocated (external references by id would
        point at the wrong vectors)."""
        src = tmp_path / "in.jsonl"
        rows = _dataset(3)
        del rows[0]["id"]
        _write_jsonl(src, rows)
        with pytest.raises(ValueError, match="all-or-none"):
            import_jsonl(str(src), "ds", vlc=str(tmp_path / "o.vlc"),
                         batch_size=2, device="cpu")

    def test_vlc_collection_name_checked(self, tmp_path):
        """-c/--collection against a .vlc must match the snapshot's own
        collection name (export and append), not be silently ignored."""
        src = tmp_path / "in.jsonl"
        _write_jsonl(src, _dataset(4))
        vlc = tmp_path / "snap.vlc"
        import_jsonl(str(src), "ds", vlc=str(vlc), device="cpu")
        with pytest.raises(ValueError, match="contains collection 'ds'"):
            export_jsonl(str(tmp_path / "o.jsonl"), "wrong", vlc=str(vlc), device="cpu")
        with pytest.raises(ValueError, match="contains collection 'ds'"):
            import_jsonl(str(src), "wrong", vlc=str(vlc), append=True, device="cpu")
        # matching name still works (fresh ids to avoid duplicates)
        src2 = tmp_path / "more.jsonl"
        rows2 = _dataset(4)
        for r in rows2:
            r["id"] += 1000
        _write_jsonl(src2, rows2)
        assert import_jsonl(
            str(src2), "ds", vlc=str(vlc), append=True, device="cpu"
        ) == 4

    def test_non_numeric_embedding_elements_rejected(self, tmp_path):
        """Local .vlc import must agree with the HTTP route: bools and
        strings in the embedding are errors, not silently coerced."""
        src = tmp_path / "in.jsonl"
        src.write_text('{"text": "t", "embedding": [true, false, 1]}\n')
        with pytest.raises(ValueError, match="must be numbers"):
            import_jsonl(str(src), "ds", vlc=str(tmp_path / "o.vlc"), device="cpu")
        src.write_text('{"text": "t", "embedding": [1.0, "2", 3.0]}\n')
        with pytest.raises(ValueError, match="must be numbers"):
            import_jsonl(str(src), "ds", vlc=str(tmp_path / "o.vlc"), device="cpu")


class TestSnapshotCli:
    def test_snapshot_restore_roundtrip(self, tmp_path, capsys):
        from test_torch_remote import _ServerThread
        from vectorlite_tpu_torch import VectorLiteClient
        from vectorlite_tpu_torch.embed.mock import MockEmbeddingFunction
        from vectorlite_tpu_torch.remote import RemoteClient
        from vectorlite_tpu_torch.tools import main

        srv = _ServerThread(VectorLiteClient(MockEmbeddingFunction(DIM), device="cpu"))
        try:
            url = f"http://127.0.0.1:{srv.port}"
            rc = RemoteClient(url)
            rc.create_collection("snapcli", "flat")
            rc.add_texts("snapcli", [f"t{i}" for i in range(4)])
            path = tmp_path / "snapcli.vlc"
            rv = main([
                "snapshot", str(path), "-c", "snapcli", "--url", url,
            ])
            assert rv == 0 and path.stat().st_size > 0
            assert "downloaded snapshot" in capsys.readouterr().out
            rv = main([
                "restore", str(path), "-c", "snapcli2", "--url", url,
            ])
            assert rv == 0
            assert "4 vectors" in capsys.readouterr().out
            assert rc.get_collection_info("snapcli2")["count"] == 4
        finally:
            srv.stop()


class TestFsck:
    def _setup_dirs(self, tmp_path):
        """A healthy snapshot+WAL pair plus churn state."""
        from vectorlite_tpu_torch import VectorLiteClient
        from vectorlite_tpu_torch.embed.mock import MockEmbeddingFunction
        from vectorlite_tpu_torch.store.autosave import AutosaveDaemon
        from vectorlite_tpu_torch.store.wal import WalManager

        snap, wal = tmp_path / "snaps", tmp_path / "wal"
        client = VectorLiteClient(MockEmbeddingFunction(DIM), device="cpu")
        manager = WalManager(wal, snapshot_dir=snap)
        client.set_collection_observer(manager)
        client.create_collection("a", "flat")
        client.add_texts_to_collection("a", ["one", "two"])
        AutosaveDaemon(client, snap, interval_s=9999).flush()
        client.add_text_to_collection("a", "post-snapshot tail")
        manager.close()
        return snap, wal

    def test_healthy_report(self, tmp_path):
        from vectorlite_tpu_torch.tools import fsck_dirs

        snap, wal = self._setup_dirs(tmp_path)
        report = fsck_dirs(snap, wal)
        assert report["ok"] and report["warnings"] == []
        e = report["collections"]["a"]
        assert e["snapshot"]["vector_count"] == 2
        assert e["snapshot"]["index_type"] == "Flat"
        assert e["wal"]["replayable_ops"] == 1  # the post-snapshot add
        assert e["wal"]["ops"] == {"add": 1}
        # deep mode parses the snapshot fully
        deep = fsck_dirs(snap, wal, deep=True, device="cpu")
        assert deep["collections"]["a"]["snapshot"]["parses"]

    def test_torn_tail_and_drop_warnings(self, tmp_path):
        from vectorlite_tpu_torch.store.wal import wal_path
        from vectorlite_tpu_torch.tools import fsck_dirs

        snap, wal = self._setup_dirs(tmp_path)
        p = wal_path(wal, "a")
        with p.open("a", encoding="utf-8") as f:
            f.write('{"s":99,"op":"del","i')  # torn
        report = fsck_dirs(snap, wal)
        assert report["ok"]  # torn tails are expected, not fatal
        assert report["collections"]["a"]["wal"]["torn_tail"]
        assert any("torn tail" in w for w in report["warnings"])

    def test_orphan_wal_without_header_flagged(self, tmp_path):
        from vectorlite_tpu_torch.tools import fsck_dirs

        wal = tmp_path / "wal"
        wal.mkdir()
        (wal / "ghost.wal").write_text(
            '{"s":1,"op":"del","id":3}\n'
        )
        report = fsck_dirs(None, wal)
        assert not report["ok"]
        assert any("no create header" in w for w in report["warnings"])

    def test_unreadable_snapshot_flagged(self, tmp_path):
        from vectorlite_tpu_torch.tools import fsck_dirs

        snap = tmp_path / "snaps"
        snap.mkdir()
        (snap / "bad.vlc").write_text("not a snapshot at all")
        report = fsck_dirs(snap, None)
        assert not report["ok"]
        assert any("unreadable" in w for w in report["warnings"])

    def test_cli_exit_codes(self, tmp_path, capsys):
        snap, wal = self._setup_dirs(tmp_path)
        rv = main([
            "fsck", "--autosave-dir", str(snap), "--wal-dir", str(wal),
        ])
        out = capsys.readouterr().out
        assert rv == 0 and "ok" in out and "a: snapshot" in out
        (snap / "bad.vlc").write_text("junk")
        rv = main([
            "fsck", "--autosave-dir", str(snap), "--json",
        ])
        assert rv == 1
        assert json.loads(capsys.readouterr().out)["ok"] is False


class TestDevice:
    def test_local_targets_need_the_card_without_device(self, tmp_path, monkeypatch):
        """A local .vlc import, export or deep fsck builds on the card
        unless told otherwise; with CUDA absent it fails with
        resolve_device's error and never falls back to the CPU."""
        from vectorlite_tpu_torch.tools import fsck_dirs

        src = tmp_path / "in.jsonl"
        _write_jsonl(src, _dataset(3))
        vlc = tmp_path / "o.vlc"
        import_jsonl(str(src), "ds", vlc=str(vlc), device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            import_jsonl(str(src), "ds", vlc=str(tmp_path / "p.vlc"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_jsonl(str(tmp_path / "o.jsonl"), "ds", vlc=str(vlc))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["import", str(src), "-c", "ds", "--vlc", str(tmp_path / "q.vlc")])
        report = fsck_dirs(tmp_path, None, deep=True)
        assert not report["ok"] and "no CUDA device" in report["warnings"][0]
        assert not (tmp_path / "p.vlc").exists()


def test_fetch_model_writes_the_layout(tmp_path, monkeypatch):
    """fetch_model with the network replaced by a fake urlopen: the three
    files land in the reference layout, present files are kept, a missing
    safetensors falls back to pytorch_model.bin."""
    import urllib.error
    import urllib.request

    from vectorlite_tpu_torch.tools import fetch_model

    asked = []

    def fake_urlopen(url, timeout):
        asked.append(url.rsplit("/", 1)[-1])
        if url.endswith("model.safetensors"):
            raise urllib.error.URLError("absent")
        return io.BytesIO(b"payload of " + url.encode())

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    dest = tmp_path / "m"
    dest.mkdir()
    (dest / "config.json").write_text("{}")
    out = fetch_model(repo="org/mini", dest=str(dest))
    assert out == dest
    assert asked == ["tokenizer.json", "model.safetensors", "pytorch_model.bin"]
    assert (dest / "config.json").read_text() == "{}"
    assert (dest / "tokenizer.json").read_bytes().endswith(b"org/mini/resolve/main/tokenizer.json")
    assert (dest / "pytorch_model.bin").exists()
    assert not list(dest.glob("*.part"))
