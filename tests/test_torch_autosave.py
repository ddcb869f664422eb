"""The port's autosave daemon against the JAX package's: the same dirty
tracking, snapshots that load in either package with equal search
results, pruning, and restore (the cases of tests/test_autosave.py).
Ticks are driven with flush(); nothing sleeps on an interval."""

import re

import numpy as np
import pytest

import vectorlite_tpu as jv
import vectorlite_tpu_torch as tv
from vectorlite_tpu.persist import vlc as jvlc
from vectorlite_tpu.store import autosave as jautosave
from vectorlite_tpu_torch.store.autosave import AutosaveDaemon, restore_into, snapshot_path


def port_client(dim=8):
    return tv.VectorLiteClient(tv.MockEmbeddingFunction(dim), device="cpu")


def restore(tmp_path):
    fresh = port_client()
    return fresh, restore_into(fresh, tmp_path, **fresh.flat_index_kwargs())


def test_dirty_tracking_matches_jax(tmp_path):
    j, t = jv.VectorLiteClient(jv.MockEmbeddingFunction(8)), port_client()
    jd = jautosave.AutosaveDaemon(j, tmp_path / "j")
    td = AutosaveDaemon(t, tmp_path / "t")
    steps = [
        lambda c: c.create_collection("a", "flat"),
        lambda c: None,  # clean: skipped
        lambda c: c.add_text_to_collection("a", "hello"),
        lambda c: c.add_texts_to_collection("a", ["x", "y"]),
        lambda c: c.delete_from_collection("a", 1),
        lambda c: c.delete_where_in_collection("a", {"k": 1}),  # matches nothing
        lambda c: c.update_metadata_in_collection("a", 0, {"k": 1}),
        lambda c: c.create_collection("b", "flat"),
        lambda c: c.delete_collection("a"),
    ]
    for step in steps:
        step(j)
        step(t)
        assert td.flush() == jd.flush()
        assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
            p.name for p in (tmp_path / "j").iterdir())
    for key in ("saves", "failures", "pruned"):
        assert td.stats()[key] == jd.stats()[key]
    assert td.stats()["pruned"] == 1
    snapshot_path(tmp_path / "t", "b").unlink()
    assert td.flush() == ["b"]  # a missing file is re-saved despite a clean counter
    j.delete_collection("b")


def test_snapshot_loads_in_both_packages_with_equal_results(tmp_path):
    t = port_client(16)
    t.create_collection("a", "flat")
    t.add_texts_to_collection("a", [f"text {i} alpha" for i in range(200)],
                              [{"p": i % 3} for i in range(200)])
    t.delete_where_in_collection("a", {"p": 1})
    AutosaveDaemon(t, tmp_path).flush()
    fresh = port_client(16)
    assert restore_into(fresh, tmp_path, **fresh.flat_index_kwargs()) == ["a"]
    j = jv.VectorLiteClient(jv.MockEmbeddingFunction(16))
    assert jautosave.restore_into(j, tmp_path) == ["a"]
    q = tv.MockEmbeddingFunction(16).embed_batch_arrays([f"q{i}" for i in range(8)])
    want = [[(h.id, h.text) for h in row] for row in t.search_vectors_in_collection("a", q, 5)]
    for client in (fresh, j):
        got = client.search_vectors_in_collection("a", q, 5)
        assert [[(h.id, h.text) for h in row] for row in got] == want
    norm = lambda s: re.sub(r'"created_at": "[^"]+"', '"created_at": "T"', s)  # noqa: E731
    jvlc.save_collection_to_file(j.get_collection("a"), tmp_path / "j.out")
    assert norm((tmp_path / "j.out").read_text()) == norm((tmp_path / "a.vlc").read_text())
    j.delete_collection("a")


def test_prune_spares_foreign_files_and_can_be_disabled(tmp_path):
    t = port_client()
    (tmp_path / "My Backup.vlc").write_text("{}")
    (tmp_path / "notes.txt").write_text("keep")
    t.create_collection("a", "flat")
    d = AutosaveDaemon(t, tmp_path)
    d.flush()
    t.delete_collection("a")
    d.flush()
    assert not snapshot_path(tmp_path, "a").exists()
    assert (tmp_path / "My Backup.vlc").exists() and (tmp_path / "notes.txt").exists()
    t.create_collection("b", "flat")
    keep = AutosaveDaemon(t, tmp_path / "keep", prune=False)
    keep.flush()
    t.delete_collection("b")
    keep.flush()
    assert snapshot_path(tmp_path / "keep", "b").exists()


def test_restore_rules(tmp_path):
    assert restore_into(port_client(), tmp_path / "nope") == []
    t = port_client()
    t.create_collection("good", "flat")
    t.add_text_to_collection("good", "snapshot copy")
    name = "reports/2026 α%β"
    t.create_collection(name, "flat")
    d = AutosaveDaemon(t, tmp_path)
    assert d.flush() == ["good", name]
    assert snapshot_path(tmp_path, name).parent == tmp_path
    (tmp_path / "bad.vlc").write_text("{not json")
    fresh, loaded = restore(tmp_path)
    assert loaded == sorted(["good", name], key=lambda n: snapshot_path(tmp_path, n).name)
    assert fresh.get_collection("good")._index.device.type == "cpu"
    other = port_client()
    other.create_collection("good", "flat")  # e.g. a --filepath load wins
    restore_into(other, tmp_path, device="cpu")
    assert other.get_collection_info("good").count == 0
    t.delete_collection(name)
    d.flush()
    assert not snapshot_path(tmp_path, name).exists()


def test_daemon_start_stop_flushes_the_last_write(tmp_path):
    t = port_client()
    t.create_collection("a", "flat")
    d = AutosaveDaemon(t, tmp_path, interval_s=3600).start()
    t.add_text_to_collection("a", "last write")
    d.stop(flush=True)  # the shutdown flush captures it, no tick needed
    assert d._thread is None
    fresh, _ = restore(tmp_path)
    assert fresh.get_collection_info("a").count == 1
    with pytest.raises(ValueError):
        AutosaveDaemon(t, tmp_path, interval_s=0)


def test_restored_collection_accepts_writes_and_wal_checkpoint(tmp_path):
    from vectorlite_tpu_torch.store.wal import WalManager, read_entries, wal_path

    t = port_client()
    t.set_collection_observer(WalManager(tmp_path / "wal"))
    t.create_collection("a", "flat")
    t.add_vectors_to_collection("a", np.eye(8))
    d = AutosaveDaemon(t, tmp_path / "snaps")
    d.flush()
    assert read_entries(wal_path(tmp_path / "wal", "a")) == []  # checkpointed
    t.add_text_to_collection("a", "tail")
    assert [e["op"] for e in read_entries(wal_path(tmp_path / "wal", "a"))] == ["add"]
    fresh, _ = restore(tmp_path / "snaps")
    assert fresh.add_text_to_collection("a", "next") == 8
