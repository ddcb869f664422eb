"""The port's RemoteClient (vectorlite_tpu_torch/remote.py) against the
port's server on a real socket, on the CPU.

Counterpart of tests/test_remote.py: the server is bound to an ephemeral
localhost port and served from a thread, the synchronous stdlib client
drives it, Flat and HNSW collections alike. The same
client also drives the JAX package's aiohttp app (the contract is one).
"""

import pytest

from vectorlite_tpu_torch import SimilarityMetric, VectorLiteClient
from vectorlite_tpu_torch.api.server import bind, create_app
from vectorlite_tpu_torch.embed.mock import MockEmbeddingFunction
from vectorlite_tpu_torch.remote import (
    RemoteClient,
    RemoteConnectionError,
    RemoteError,
)
from vectorlite_tpu_torch.store.client import IndexType


class _ServerThread:
    """The port's server on 127.0.0.1:<ephemeral>, served from a thread."""

    def __init__(self, client, api_key=None):
        self._server = bind(create_app(client, api_key=api_key)).start()
        self.port = self._server.port

    def stop(self):
        self._server.close()


@pytest.fixture(scope="module")
def server():
    srv = _ServerThread(VectorLiteClient(MockEmbeddingFunction(8), device="cpu"))
    yield srv
    srv.stop()


@pytest.fixture()
def rc(server):
    client = RemoteClient(f"http://127.0.0.1:{server.port}")
    yield client
    for name in client.list_collections():
        client.delete_collection(name)


class TestRemoteLifecycle:
    def test_health_and_stats(self, rc):
        assert rc.health()["status"] == "healthy"
        assert isinstance(rc.stats(), dict)
        metrics = rc.metrics()
        assert isinstance(metrics, str)
        assert "vectorlite_collections" in metrics

    def test_collection_crud(self, rc):
        rc.create_collection("a", "flat")
        rc.create_collection("b", IndexType.FLAT, SimilarityMetric.COSINE)
        rc.create_collection("h", IndexType.HNSW, SimilarityMetric.COSINE)
        rc.add_texts("h", ["alpha", "beta", "gamma"])
        assert [h.id for h in rc.search_text("h", "beta", k=1, ef=8)] == [1]
        rc.delete_collection("h")
        assert sorted(rc.list_collections()) == ["a", "b"]
        assert rc.has_collection("a") and not rc.has_collection("z")
        info = rc.get_collection_info("a")
        assert info["name"] == "a" and info["count"] == 0
        rc.delete_collection("b")
        assert rc.list_collections() == ["a"]

    def test_text_roundtrip_and_filters(self, rc):
        rc.create_collection("docs", "flat")
        vid = rc.add_text("docs", "alpha beta", {"lang": "en"})
        assert vid == 0
        ids = rc.add_texts(
            "docs",
            ["gamma delta", "epsilon"],
            metadatas=[{"lang": "de"}, {"lang": "en"}],
        )
        assert ids == [1, 2]
        hits = rc.search_text("docs", "alpha beta", k=3)
        assert hits[0].id == 0 and hits[0].score == pytest.approx(1.0)
        only_en = rc.search_text(
            "docs", "alpha beta", k=5, where={"lang": "en"}
        )
        assert {h.id for h in only_en} == {0, 2}
        batches = rc.search_texts(
            "docs", ["gamma delta", "epsilon"], k=1, where={"lang": "de"}
        )
        assert [h.id for row in batches for h in row] == [1, 1]
        v = rc.get_vector("docs", 0)
        assert v.text == "alpha beta" and v.metadata == {"lang": "en"}
        rc.update_metadata("docs", 0, {"lang": "fr"})
        assert rc.get_vector("docs", 0).metadata == {"lang": "fr"}
        rc.update_text("docs", 0, "omega", {"lang": "el"})
        v = rc.get_vector("docs", 0)
        assert v.text == "omega" and v.metadata == {"lang": "el"}
        assert rc.search_text("docs", "omega", k=1)[0].id == 0
        # update_text re-inserts, so id 0 now lists last (insertion order)
        page, total = rc.list_vectors("docs", limit=2)
        assert total == 3 and [v.id for v in page] == [1, 2]
        page, total = rc.list_vectors("docs", where={"lang": "en"})
        assert total == 1 and page[0].id == 2
        rc.delete_vector("docs", 0)
        assert rc.get_collection_info("docs")["count"] == 2

    def test_delete_where(self, rc):
        rc.create_collection("d", "flat")
        rc.add_texts(
            "d",
            [f"text {i}" for i in range(8)],
            metadatas=[{"bucket": i % 2} for i in range(8)],
        )
        assert rc.delete_where("d", {"bucket": 0}) == 4
        assert rc.get_collection_info("d")["count"] == 4
        _, total = rc.list_vectors("d", where={"bucket": 0})
        assert total == 0
        assert rc.delete_where("d", {}) == 4  # explicit clear-all
        assert rc.get_collection_info("d")["count"] == 0
        with pytest.raises(RemoteError) as ei:
            rc.delete_where("missing", {"a": 1})
        assert ei.value.status_code == 404

    def test_raw_vectors(self, rc):
        rc.create_collection("raw", "flat")
        ids = rc.add_vectors(
            "raw",
            [[1, 0, 0, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0, 0, 0]],
            texts=["a", "b"],
            metadatas=[{"m": 1}, None],
        )
        assert ids == [0, 1]
        # explicit ids bump the counter past their max
        assert rc.add_vectors(
            "raw", [[0, 0, 1, 0, 0, 0, 0, 0]], ids=[50]
        ) == [50]
        assert rc.add_text("raw", "later") == 51
        hits = rc.search_vector("raw", [1, 0, 0, 0, 0, 0, 0, 0], k=1)
        assert hits[0].id == 0 and hits[0].metadata == {"m": 1}
        rows = rc.search_vectors(
            "raw",
            [[0, 1, 0, 0, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0, 0, 0]],
            k=1,
        )
        assert [r[0].id for r in rows] == [1, 50]
        with pytest.raises(RemoteError) as ei:
            rc.add_vectors("raw", [[1, 0, 0, 0, 0, 0, 0, 0]], ids=[50])
        assert ei.value.status_code == 409
        with pytest.raises(RemoteError) as ei:
            rc.search_vector("raw", [1.0, 2.0], k=1)
        assert ei.value.status_code == 400
        # client-side validation: clear errors before any request is sent
        with pytest.raises(ValueError):
            rc.add_vectors("raw", [[1, 0], [0, 1]], texts=["only-one"])
        with pytest.raises(ValueError):
            rc.add_vectors("raw", [[1, 0]], ids=[5.5])

    def test_save_load_compact(self, rc, tmp_path):
        rc.create_collection("p", "flat")
        rc.add_texts("p", ["one", "two", "three"])
        path = str(tmp_path / "p.vlc")
        rc.save_collection("p", path)
        rc.delete_collection("p")
        assert rc.load_collection(path) == "p"
        assert rc.get_collection_info("p")["count"] == 3
        rc.delete_vector("p", 0)
        assert rc.compact("p") >= 0

    def test_typed_errors(self, rc):
        with pytest.raises(RemoteError) as e:
            rc.get_collection_info("missing")
        assert e.value.status_code == 404
        assert "not found" in e.value.message
        assert e.value.is_client_error()
        rc.create_collection("dup", "flat")
        with pytest.raises(RemoteError) as e:
            rc.create_collection("dup", "flat")
        assert e.value.status_code == 409
        with pytest.raises(RemoteError) as e:
            rc.create_collection("h2", "hnsw")  # no metric
        assert e.value.status_code == 400
        assert "explicit similarity metric" in e.value.message
        assert e.value.is_client_error()
        with pytest.raises(RemoteError) as e:
            rc.search_text("dup", "x", where={"f": {"$bogus": 1}})
        assert e.value.status_code == 400
        assert e.value.message.startswith("Invalid filter")

    def test_connection_error(self):
        dead = RemoteClient("http://127.0.0.1:9", timeout=2)
        with pytest.raises(RemoteConnectionError) as e:
            dead.health()
        assert e.value.status_code == 503


class TestRemoteApiKey:
    def test_client_sends_bearer(self):
        srv = _ServerThread(
            VectorLiteClient(MockEmbeddingFunction(8), device="cpu"), api_key="k123"
        )
        try:
            url = f"http://127.0.0.1:{srv.port}"
            # without the key: typed 401
            with pytest.raises(RemoteError) as ei:
                RemoteClient(url).list_collections()
            assert ei.value.status_code == 401
            # with the key: full round-trip
            rc = RemoteClient(url, api_key="k123")
            rc.create_collection("docs", "flat")
            rc.add_text("docs", "hello world")
            hits = rc.search_text("docs", "hello world", k=1)
            assert hits and hits[0].text == "hello world"
        finally:
            srv.stop()


class TestRemoteEf:
    def test_search_ef_roundtrip(self):
        """ef rides every search body; Flat accepts and ignores it."""
        srv = _ServerThread(VectorLiteClient(MockEmbeddingFunction(8), device="cpu"))
        try:
            rc = RemoteClient(f"http://127.0.0.1:{srv.port}")
            rc.create_collection("h", "flat", SimilarityMetric.COSINE)
            rc.add_texts("h", [f"t{i}" for i in range(10)])
            hits = rc.search_text("h", "t4", k=2, ef=32)
            assert hits and hits[0].text == "t4"
            rows = rc.search_texts("h", ["t1", "t2"], k=1, ef=0)
            assert [r[0].text for r in rows] == ["t1", "t2"]
            with pytest.raises(RemoteError) as ei:
                rc.search_text("h", "t4", k=2, ef=-3)
            assert ei.value.status_code == 400
        finally:
            srv.stop()


class TestRemoteMinScore:
    def test_min_score_roundtrip(self):
        srv = _ServerThread(VectorLiteClient(MockEmbeddingFunction(8), device="cpu"))
        try:
            rc = RemoteClient(f"http://127.0.0.1:{srv.port}")
            rc.create_collection("m", "flat")
            rc.add_texts("m", ["one", "two", "three"])
            assert len(rc.search_text("m", "one", k=3)) == 3
            hits = rc.search_text("m", "one", k=3, min_score=0.999)
            assert [h.text for h in hits] == ["one"]
            rows = rc.search_vectors(
                "m",
                [[1, 0, 0, 0, 0, 0, 0, 0]],
                k=3,
                min_score=2.0,
            )
            assert rows == [[]]
        finally:
            srv.stop()


class TestRemoteBulkGet:
    def test_get_vectors(self):
        srv = _ServerThread(VectorLiteClient(MockEmbeddingFunction(8), device="cpu"))
        try:
            rc = RemoteClient(f"http://127.0.0.1:{srv.port}")
            rc.create_collection("g", "flat")
            rc.add_texts(
                "g",
                [f"t{i}" for i in range(5)],
                metadatas=[{"i": i} for i in range(5)],
            )
            got = rc.get_vectors("g", [3, 1, 77])
            assert [v.id for v in got] == [3, 1]
            assert len(got[0].values) == 8  # values on by default
            got = rc.get_vectors(
                "g", [4, 3, 2], where={"i": {"$gte": 3}},
                include_values=False,
            )
            assert [v.id for v in got] == [4, 3]
            assert got[0].values == []
        finally:
            srv.stop()


class TestRemoteSnapshot:
    def test_snapshot_roundtrip(self, rc, tmp_path):
        import io

        rc.create_collection("src", "flat")
        rc.add_texts(
            "src",
            [f"t{i}" for i in range(5)],
            metadatas=[{"i": i} for i in range(5)],
        )
        path = tmp_path / "src.vlc"
        n = rc.download_snapshot("src", str(path))
        assert n == path.stat().st_size > 0
        # restore from path, under a new name
        assert rc.restore_snapshot("dst", str(path)) == 5
        assert rc.get_collection_info("dst")["count"] == 5
        got = rc.get_vectors("dst", [0, 3])
        assert [v.metadata for v in got] == [{"i": 0}, {"i": 3}]
        # conflict surfaces as a typed 409
        with pytest.raises(RemoteError) as ei:
            rc.restore_snapshot("dst", path.read_bytes())
        assert ei.value.status_code == 409
        # download into a file object; restore from a file object
        buf = io.BytesIO()
        rc.download_snapshot("dst", buf)
        assert buf.getvalue()
        buf.seek(0)
        assert rc.restore_snapshot("dst2", buf) == 5

    def test_snapshot_missing_collection(self, rc, tmp_path):
        with pytest.raises(RemoteError) as ei:
            rc.download_snapshot("ghost", str(tmp_path / "x.vlc"))
        assert ei.value.status_code == 404
        assert not (tmp_path / "x.vlc").exists()


class TestRemoteHybrid:
    def test_hybrid_route(self, rc):
        rc.create_collection("hy", "flat")
        rc.add_texts(
            "hy",
            ["quick brown fox", "lazy dog", "zebra crossing"],
            metadatas=[{"i": i} for i in range(3)],
        )
        hits = rc.search_hybrid("hy", "zebra", k=2, alpha=0.0)
        assert hits and hits[0].text == "zebra crossing"
        assert 0 < hits[0].score <= 1 / 61 + 1e-12
        hits = rc.search_hybrid(
            "hy", "fox", k=3, alpha=0.5, pool=10,
            where={"i": {"$lte": 1}},
        )
        assert all(h.text != "zebra crossing" for h in hits)
        with pytest.raises(RemoteError) as ei:
            rc.search_hybrid("hy", "x", alpha=3.0)
        assert ei.value.status_code == 400


def test_port_client_drives_the_jax_app():
    """The port's RemoteClient speaks the one contract, so it drives the
    JAX package's aiohttp app as well, typed errors included."""
    import vectorlite_tpu as jvl
    from test_torch_http_parity import _JaxServer

    srv = _JaxServer(jvl.VectorLiteClient(jvl.MockEmbeddingFunction(8)))
    try:
        rc = RemoteClient(f"http://127.0.0.1:{srv.port}")
        rc.create_collection("docs", "flat")
        assert rc.add_texts("docs", ["alpha", "beta"], [{"i": 0}, {"i": 1}]) == [0, 1]
        hits = rc.search_text("docs", "beta", k=1)
        assert hits[0].id == 1 and hits[0].metadata == {"i": 1}
        with pytest.raises(RemoteError) as e:
            rc.get_collection_info("missing")
        assert e.value.status_code == 404
    finally:
        srv.close()
