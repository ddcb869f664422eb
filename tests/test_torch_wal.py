"""The port's write-ahead log against the JAX package's: the same
mutations write the same log, a crash replays to the live state, a torn
tail keeps its intact prefix, a log written by either package replays in
the other to the same state, for Flat and HNSW collections (the cases of
tests/test_wal.py)."""

import json

import numpy as np
import pytest

import vectorlite_tpu as jv
import vectorlite_tpu_torch as tv
from vectorlite_tpu.store import autosave as jautosave
from vectorlite_tpu.store import wal as jwal
from vectorlite_tpu_torch.store.autosave import AutosaveDaemon, restore_into
from vectorlite_tpu_torch.store.wal import (
    CollectionWAL,
    WalManager,
    read_entries,
    recover_into,
    wal_path,
)

DIM = 8


@pytest.fixture(autouse=True, scope="module")
def _jax_search_pool_off():
    """The JAX package's native search pool can read a builder freed right
    after a batched search (ROADMAP §3): its batched HNSW searches here
    run on the calling thread."""
    import os

    before = os.environ.get("VECTORLITE_SEARCH_THREADS")
    os.environ["VECTORLITE_SEARCH_THREADS"] = "1"
    yield
    if before is None:
        del os.environ["VECTORLITE_SEARCH_THREADS"]
    else:
        os.environ["VECTORLITE_SEARCH_THREADS"] = before


def port_client():
    return tv.VectorLiteClient(tv.MockEmbeddingFunction(DIM), device="cpu")


def jax_client():
    return jv.VectorLiteClient(jv.MockEmbeddingFunction(DIM))


def with_wal(client, directory, manager_cls=WalManager):
    manager = manager_cls(directory)
    client.set_collection_observer(manager)
    return manager


def state(client, name):
    """The logical state: (id, text, metadata, f64 value bytes), in
    insertion order."""
    col = client.get_collection(name)
    vectors = col.list_vectors(0, 100_000, None, True)[0]
    return [(v.id, v.text, json.dumps(v.metadata, sort_keys=True),
             np.asarray(v.values, np.float64).tobytes()) for v in vectors]


def churn(client, name, rng):
    """Every logged op kind, in the order the hooks write them."""
    client.add_text_to_collection(name, "one", {"k": 1})
    client.add_texts_to_collection(name, [f"doc {i}" for i in range(6)],
                                   [{"i": i} for i in range(6)])
    client.add_vectors_to_collection(name, rng.standard_normal((3, DIM)),
                                     ["v0", "v1", "v2"], ids=[100, 101, 102])
    client.add_vectors_to_collection(name, rng.standard_normal((2, DIM)))
    client.update_metadata_in_collection(name, 0, {"k": 2, "nested": [1.5, None]})
    client.update_text_in_collection(name, 2, "doc rewritten", {"i": 20})
    client.delete_from_collection(name, 4)
    client.delete_where_in_collection(name, {"i": {"$eq": 5}})
    client.get_collection(name).compact()


def test_same_mutations_write_the_same_log(tmp_path):
    j, t = jax_client(), port_client()
    with_wal(j, tmp_path / "j", jwal.WalManager)
    with_wal(t, tmp_path / "t")
    for client, m, seed in ((j, jv, 3), (t, tv, 3)):
        client.create_collection("c", m.IndexType.FLAT)
        churn(client, "c", np.random.default_rng(seed))
    jlog = (tmp_path / "j" / "c.wal").read_text()
    assert (tmp_path / "t" / "c.wal").read_text() == jlog
    assert [e["op"] for e in read_entries(tmp_path / "t" / "c.wal")] == [
        "create", "add", "add", "add", "add", "meta", "put", "del", "delw", "compact"]
    assert state(t, "c") == state(j, "c")
    j.delete_collection("c")


def test_crash_replay_restores_the_live_state(tmp_path):
    t = port_client()
    with_wal(t, tmp_path / "wal")
    t.create_collection("c", "flat")
    t.create_collection("only-in-the-log", "flat")
    churn(t, "c", np.random.default_rng(0))
    t.add_text_to_collection("only-in-the-log", "x")
    want = {n: state(t, n) for n in ("c", "only-in-the-log")}
    # no close: the process dies with the handles open (kill -9)
    fresh = port_client()
    applied = recover_into(fresh, tmp_path / "wal")
    assert applied == {"c": 10, "only-in-the-log": 2}
    assert {n: state(fresh, n) for n in want} == want
    assert fresh.get_collection("c").next_id() == t.get_collection("c").next_id()
    # a second replay over the recovered state is a no-op
    recover_into(fresh, tmp_path / "wal")
    assert state(fresh, "c") == want["c"]
    hits = fresh.search_hybrid_in_collection("c", "rewritten", 2, alpha=0.0)
    assert hits and hits[0].id == 2  # the BM25 sidecar rebuilt after replay


def test_torn_tail_keeps_the_intact_prefix(tmp_path):
    p = tmp_path / "c.wal"
    w = CollectionWAL(p)
    w.append({"op": "del", "id": 1})
    w.close()
    with open(p, "a", encoding="utf-8") as f:
        f.write('{"s":2,"op":"del","i')  # a crash mid-append
    assert [e["s"] for e in read_entries(p)] == [1]
    w2 = CollectionWAL(p)  # resume truncates the torn line first
    assert w2.append({"op": "del", "id": 7}) == 2
    assert [(e["s"], e["id"]) for e in read_entries(p)] == [(1, 1), (2, 7)]

    t = port_client()
    manager = with_wal(t, tmp_path / "wal")
    t.create_collection("c", "flat")
    t.add_text_to_collection("c", "intact")
    manager.close()
    with open(wal_path(tmp_path / "wal", "c"), "a", encoding="utf-8") as f:
        f.write('{"s":99,"op":"add","rows":[[5,[0.1')
    fresh = port_client()
    recover_into(fresh, tmp_path / "wal")
    assert [v.id for v in fresh.get_collection("c").list_vectors(0, 10)[0]] == [0]


def test_checkpoint_and_render_match_jax(tmp_path):
    for mod, sub in ((jwal, "j"), (None, "t")):
        w = (mod.CollectionWAL if mod else CollectionWAL)(tmp_path / sub / "c.wal")
        for i in range(5):
            w.append({"op": "del", "id": i})
        w.checkpoint(3)
        w.append({"op": "meta", "id": 9, "metadata": {"a": [1, 2.5]}})
        w.checkpoint(None)
        with pytest.raises((TypeError, ValueError)):
            w.render({"op": "delw", "where": {"$in": {1, 2}}})
        with pytest.raises(ValueError):
            w.render({"op": "add", "rows": [[1, [float("nan")], "", None]]})
        w.close()
    assert (tmp_path / "t" / "c.wal").read_bytes() == (tmp_path / "j" / "c.wal").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_log_replays_in_the_other_package(writer, tmp_path):
    rng = np.random.default_rng(7)
    src = jax_client() if writer == "jax" else port_client()
    with_wal(src, tmp_path / "wal", jwal.WalManager if writer == "jax" else WalManager)
    src.create_collection("c", (jv if writer == "jax" else tv).IndexType.FLAT)
    churn(src, "c", rng)
    src.add_texts_to_collection("c", ["after the compaction", "and one more"])
    want = state(src, "c")
    if writer == "jax":
        dst = port_client()
        recover_into(dst, tmp_path / "wal")
    else:
        dst = jax_client()
        jwal.recover_into(dst, tmp_path / "wal")
    assert state(dst, "c") == want
    for client in (src, dst):
        client.get_collection("c").close()


def test_failed_mutations_log_nothing(tmp_path):
    t = port_client()
    manager = with_wal(t, tmp_path / "wal")
    t.create_collection("c", "flat")
    p = wal_path(manager.directory, "c")
    t.add_vectors_to_collection("c", np.ones((1, DIM)), ids=[7])
    with pytest.raises(Exception):
        t.add_vectors_to_collection("c", np.ones((1, DIM)), ids=[7])
    with pytest.raises(Exception):
        t.update_text_in_collection("c", 999, "missing")
    with pytest.raises((TypeError, ValueError)):
        t.delete_where_in_collection("c", {"k": {"$in": {1, 2}}})
    assert t.delete_where_in_collection("c", {"x": 1}) == 0
    assert [e["op"] for e in read_entries(p)] == ["create", "add"]
    t.delete_collection("c")
    assert not p.exists()


def test_snapshot_plus_tail_replay(tmp_path):
    t = port_client()
    manager = with_wal(t, tmp_path / "wal")
    t.create_collection("c", "flat")
    daemon = AutosaveDaemon(t, tmp_path / "snaps", interval_s=9999)
    t.add_texts_to_collection("c", ["a", "b", "c"])
    assert daemon.flush() == ["c"]  # snapshot + checkpoint
    assert read_entries(wal_path(manager.directory, "c")) == []
    t.add_text_to_collection("c", "d")
    t.delete_from_collection("c", 0)
    want = state(t, "c")
    fresh = port_client()
    restore_into(fresh, tmp_path / "snaps", **fresh.flat_index_kwargs())
    assert fresh.get_collection_info("c").count == 3  # rewound
    recover_into(fresh, tmp_path / "wal", snapshot_dir=tmp_path / "snaps")
    assert state(fresh, "c") == want
    # recovery re-snapshotted and rotated: a second crash lands the same
    again = port_client()
    restore_into(again, tmp_path / "snaps", **again.flat_index_kwargs())
    recover_into(again, tmp_path / "wal")
    assert state(again, "c") == want


def test_data_bearing_registration_gets_a_base(tmp_path):
    src = port_client()
    src.create_collection("c", "flat")
    src.add_texts_to_collection("c", ["a", "b", "c"])
    src.get_collection("c").save_to_file(tmp_path / "c.vlc")
    t = port_client()
    with_wal(t, tmp_path / "wal")
    t.add_collection(tv.Collection.load_from_file(tmp_path / "c.vlc", device="cpu"))
    assert [e["op"] for e in read_entries(wal_path(tmp_path / "wal", "c"))] == [
        "create", "add"]
    fresh = port_client()
    recover_into(fresh, tmp_path / "wal")
    assert state(fresh, "c") == state(src, "c")


def test_drop_tombstone_keeps_a_deleted_collection_dead(tmp_path):
    t = port_client()
    manager = WalManager(tmp_path / "wal", snapshot_dir=tmp_path / "snaps")
    t.set_collection_observer(manager)
    t.create_collection("c", "flat")
    t.add_text_to_collection("c", "x")
    AutosaveDaemon(t, tmp_path / "snaps", interval_s=9999).flush()
    p = wal_path(tmp_path / "wal", "c")
    saved = p.read_bytes()
    t.delete_collection("c")
    assert not p.exists() and not (tmp_path / "snaps" / "c.vlc").exists()
    # a crash in the unlink window: the log survives with its drop record
    p.write_bytes(saved + b'{"s":9,"op":"drop"}\n')
    fresh = port_client()
    assert recover_into(fresh, tmp_path / "wal") == {"c": 0}
    assert not fresh.has_collection("c")


def hnsw_searches(client, name):
    """Ids and scores of a batch of raw-vector searches."""
    q = np.random.default_rng(11).standard_normal((4, DIM))
    rows = client.search_vectors_in_collection(name, q, 5)
    return [[(h.id, round(h.score, 5)) for h in row] for row in rows]


def test_hnsw_mutations_write_the_same_log(tmp_path):
    j, t = jax_client(), port_client()
    with_wal(j, tmp_path / "j", jwal.WalManager)
    with_wal(t, tmp_path / "t")
    for client, m in ((j, jv), (t, tv)):
        client.create_collection("h", m.IndexType.HNSW, m.SimilarityMetric.EUCLIDEAN)
        churn(client, "h", np.random.default_rng(3))
    assert (tmp_path / "t" / "h.wal").read_text() == (tmp_path / "j" / "h.wal").read_text()
    assert read_entries(tmp_path / "t" / "h.wal")[0] == {
        "s": 1, "op": "create", "index_type": "HNSW", "dim": DIM, "metric": "Euclidean"}
    assert state(t, "h") == state(j, "h")
    assert hnsw_searches(t, "h") == hnsw_searches(j, "h")
    j.delete_collection("h")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hnsw_log_replays_in_the_other_package(writer, tmp_path):
    """An HNSW log (no snapshot: the collection comes from its create
    header) replays to the live state and the same search results."""
    src = jax_client() if writer == "jax" else port_client()
    m = jv if writer == "jax" else tv
    with_wal(src, tmp_path / "wal", jwal.WalManager if writer == "jax" else WalManager)
    src.create_collection("h", m.IndexType.HNSW, m.SimilarityMetric.COSINE)
    churn(src, "h", np.random.default_rng(5))
    src.add_texts_to_collection("h", ["after the compaction", "and one more"])
    want, hits = state(src, "h"), hnsw_searches(src, "h")
    if writer == "jax":
        dst = port_client()
        assert recover_into(dst, tmp_path / "wal") == {"h": 11}
    else:
        dst = jax_client()
        jwal.recover_into(dst, tmp_path / "wal")
    assert dst.get_collection("h")._index.index_type == "HNSW"
    assert state(dst, "h") == want
    assert hnsw_searches(dst, "h") == hits
    for client in (src, dst):
        client.get_collection("h").close()


def test_hnsw_snapshot_restores(tmp_path):
    """A JAX autosave snapshot of an HNSW collection restores in the
    port on the device it is given, with its graph."""
    j = jax_client()
    j.create_collection("h", jv.IndexType.HNSW, jv.SimilarityMetric.DOT_PRODUCT)
    j.add_texts_to_collection("h", [f"doc {i}" for i in range(40)])
    jautosave.AutosaveDaemon(j, tmp_path / "snaps").flush()
    t = port_client()
    assert restore_into(t, tmp_path / "snaps", device="cpu") == ["h"]
    index = t.get_collection("h")._index
    assert index.device.type == "cpu"
    want = j.get_collection("h")._index.graph_arrays()
    got = index.graph_arrays()
    assert (got[1] == want[1]).all() and got[2] == want[2]
    assert state(t, "h") == state(j, "h")
    assert hnsw_searches(t, "h") == hnsw_searches(j, "h")
    j.get_collection("h").close()


def test_observer_announces_existing_and_stats(tmp_path, monkeypatch):
    t = port_client()
    t.create_collection("pre", "flat")
    monkeypatch.setenv("VECTORLITE_WAL_FSYNC", "always")
    manager = with_wal(t, tmp_path / "wal")
    assert wal_path(tmp_path / "wal", "pre").exists()
    t.add_text_to_collection("pre", "x")
    stats = manager.stats()
    assert stats["fsync"] == "always"
    assert stats["collections"]["pre"]["appends"] == 2
    monkeypatch.setenv("VECTORLITE_WAL_FSYNC", "sometimes")
    assert WalManager(tmp_path / "other").stats()["fsync"] == "batch"
