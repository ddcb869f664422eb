"""Snapshot-over-HTTP routes of the port's server: GET/POST
/collections/{name}/snapshot — the .vlc document streamed with chunked
transfer encoding, and the restore upload streamed to a temp file (the
HTTP twin of the reference's file-path save/load, reference:
src/server.rs:329-359). Counterpart of tests/test_snapshot_http.py."""

import json
import socket
import time

import numpy as np

from test_torch_server import served
from vectorlite_tpu_torch import VectorLiteClient
from vectorlite_tpu_torch.api.server import create_app
from vectorlite_tpu_torch.embed.mock import MockEmbeddingFunction
from vectorlite_tpu_torch.persist.vlc import load_collection_from_bytes


def make_client(dim=8):
    return VectorLiteClient(MockEmbeddingFunction(dim), device="cpu")


def http(fn, client=None):
    with served(create_app(client or make_client())) as tc:
        return fn(tc)


def _fill(tc):
    tc.post("/collections", json={"name": "snap", "index_type": "flat"})
    tc.post(
        "/collections/snap/texts",
        json={
            "texts": [f"doc {i}" for i in range(20)],
            "metadatas": [{"i": i} for i in range(20)],
        },
    )


class TestSnapshotDownload:
    def test_download_parses_as_vlc(self):
        def go(tc):
            _fill(tc)
            resp = tc.get("/collections/snap/snapshot")
            assert resp.status == 200
            assert resp.headers["Transfer-Encoding"] == "chunked"
            assert resp.headers["Content-Type"] == "application/json"
            assert resp.headers["Access-Control-Allow-Origin"] == "*"
            cd = resp.headers["Content-Disposition"]
            assert "snap.vlc" in cd
            raw = resp.read()
            loaded = load_collection_from_bytes(raw, device="cpu")
            assert loaded.name == "snap"
            assert loaded.get_info().count == 20
            doc = json.loads(raw.decode("utf-8"))
            assert doc["header"]["format"] == "vectorlite-collection"
            assert doc["metadata"]["vector_count"] == 20

        http(go)

    def test_download_matches_file_save(self, tmp_path):
        """The streamed bytes equal save_to_file's output modulo the
        created_at timestamps (same emitter, same payload)."""

        def go(tc):
            _fill(tc)
            resp = tc.get("/collections/snap/snapshot")
            raw = (resp.read()).decode("utf-8")
            tc.post(
                "/collections/snap/save",
                json={"file_path": str(tmp_path / "snap.vlc")},
            )
            disk = (tmp_path / "snap.vlc").read_text()

            def strip_ts(s):
                return [
                    line
                    for line in s.splitlines()
                    if '"created_at"' not in line
                ]

            assert strip_ts(raw) == strip_ts(disk)

        http(go)

    def test_download_missing_404(self):
        def go(tc):
            resp = tc.get("/collections/nope/snapshot")
            assert resp.status == 404
            assert "not found" in (resp.json())["message"]

        http(go)


class TestSnapshotRestore:
    def test_roundtrip(self):
        def go(tc):
            _fill(tc)
            raw = (tc.get("/collections/snap/snapshot")).read()
            resp = tc.post(
                "/collections/snap2/snapshot", data=raw
            )
            assert resp.status == 200
            body = resp.json()
            assert body == {"collection_name": "snap2", "vector_count": 20}
            # restored collection serves searches + vector reads
            resp = tc.post(
                "/collections/snap2/search/text",
                json={"query": "doc 3", "k": 3},
            )
            assert resp.status == 200
            results = (resp.json())["results"]
            assert results[0]["text"] == "doc 3"
            resp = tc.get("/collections/snap2/vectors/0")
            assert resp.status == 200
            assert (resp.json())["vector"]["metadata"] == {"i": 0}

        http(go)

    def test_restore_conflict_409(self):
        def go(tc):
            _fill(tc)
            raw = (tc.get("/collections/snap/snapshot")).read()
            resp = tc.post("/collections/snap/snapshot", data=raw)
            assert resp.status == 409

        http(go)

    def test_restore_garbage_rejected(self):
        def go(tc):
            resp = tc.post(
                "/collections/bad/snapshot", data=b"{not json"
            )
            assert resp.status == 500
            assert "Serialization error" in (resp.json())["message"]
            # nothing was created
            resp = tc.get("/collections/bad")
            assert resp.status == 404

        http(go)

    def test_restore_url_name_wins(self):
        """Restore-as: the URL name overrides the document's embedded
        metadata name."""

        def go(tc):
            _fill(tc)
            raw = (tc.get("/collections/snap/snapshot")).read()
            tc.post("/collections/other/snapshot", data=raw)
            resp = tc.get("/collections/other")
            assert resp.status == 200
            assert (resp.json())["info"]["name"] == "other"

        http(go)


class TestSnapshotLimits:
    def _render_vlc(self, n_docs=60):
        """A .vlc document rendered locally (no HTTP fill, so the tiny
        body caps below never apply to the setup traffic)."""
        from vectorlite_tpu_torch.persist.vlc import collection_to_json, dumps_pretty

        vc = make_client()
        vc.create_collection("big", "flat")
        vc.add_texts_to_collection(
            "big", [f"document number {i}" for i in range(n_docs)]
        )
        return dumps_pretty(
            collection_to_json(vc.get_collection("big"))
        ).encode("utf-8")

    def test_restore_streams_past_general_body_cap(self, monkeypatch):
        """The restore route streams to disk, so --max-body-mb (sized
        for JSON DTOs) does not bounce multi-MB snapshots: a body far
        over the general cap still restores."""
        raw = self._render_vlc()
        monkeypatch.setenv("VECTORLITE_MAX_BODY_MB", "0.002")  # ~2 KB
        assert len(raw) > 4096

        def go(tc):
            resp = tc.post("/collections/big/snapshot", data=raw)
            assert resp.status == 200
            assert (resp.json())["vector_count"] == 60
            # the general cap still applies to ordinary JSON routes
            resp = tc.post(
                "/collections/big/texts",
                json={"texts": ["x" * 8192]},
            )
            assert resp.status == 413

        http(go)

    def test_restore_snapshot_cap_413(self, monkeypatch):
        raw = self._render_vlc()
        monkeypatch.setenv(
            "VECTORLITE_MAX_SNAPSHOT_MB", str(1 / 1024)
        )  # 1 KiB
        assert len(raw) > 1024

        def go(tc):
            resp = tc.post("/collections/big/snapshot", data=raw)
            assert resp.status == 413
            assert "VECTORLITE_MAX_SNAPSHOT_MB" in (
                resp.json()
            )["message"]
            # nothing was created
            assert (tc.get("/collections/big")).status == 404

        http(go)


def test_client_disconnect_stops_the_renderer(monkeypatch):
    """A client that goes away mid-download stops the renderer at its
    next write (the render does not run on to the end of the document),
    and the server goes on serving."""
    from vectorlite_tpu_torch.api import server

    writes = []
    real_write = server._Utf8Writer.write

    def counted(self, s):
        writes.append(len(s))
        real_write(self, s)

    monkeypatch.setattr(server._Utf8Writer, "write", counted)
    client = VectorLiteClient(MockEmbeddingFunction(384), device="cpu")
    client.create_collection("big", "flat")
    rows = np.random.default_rng(0).standard_normal((4000, 384)).astype(np.float32)
    client.add_vectors_to_collection("big", rows)

    def go(tc):
        full = tc.get("/collections/big/snapshot").read()
        whole = len(writes)
        assert whole >= 5 and sum(writes) == len(full)
        writes.clear()
        with socket.create_connection(("127.0.0.1", tc.port)) as sock:
            sock.sendall(b"GET /collections/big/snapshot HTTP/1.1\r\nHost: x\r\n\r\n")
            assert sock.recv(65536)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, b"\x01\0\0\0\0\0\0\0")
        # the next health check waits for nothing: the server stays up
        assert tc.get("/health").status == 200
        for _ in range(200):
            stopped = len(writes)
            time.sleep(0.05)
            if len(writes) == stopped:
                break
        assert len(writes) < whole, (len(writes), whole)

    http(go, client)


# RemoteClient.download_snapshot / restore_snapshot are covered in
# tests/test_remote.py (TestRemoteSnapshot) on the shared socket-server
# fixture — urllib needs a real socket, which the in-process TestClient
# here does not provide.
