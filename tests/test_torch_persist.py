"""The port's ``.vlc`` persistence against the JAX package's: saves of the
same collection are byte-identical modulo ``created_at`` (through the
native codec and its Python twin), the golden Flat files load bit-exactly
and re-save byte-identically, files cross-load in both directions with
equal search results, HNSW payloads are refused with a typed error,
malformed documents raise the reference's typed errors, and the
disk-backed truth matrix behaves as the RAM one (the cases of
tests/test_golden_vlc.py, test_vlc_native.py, test_persistence.py and
test_host_truth.py)."""

import json
import random
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import vectorlite_tpu as jv
import vectorlite_tpu_torch as tv
from vectorlite_tpu.core.types import Vector as JVector
from vectorlite_tpu.index.flat import FlatIndex as JFlat
from vectorlite_tpu.persist import vlc as jvlc
from vectorlite_tpu.store.collection import Collection as JCollection
from vectorlite_tpu_torch.core.types import Vector
from vectorlite_tpu_torch.errors import HNSWNotPorted, VectorLiteError
from vectorlite_tpu_torch.native import VLC
from vectorlite_tpu_torch.persist import vlc

GOLDEN = Path(__file__).parent / "golden"
FLAT_GOLDENS = ["flat_reference.vlc", "flat_edge_reference.vlc", "flat_empty_reference.vlc"]
HNSW_GOLDENS = sorted(p.name for p in GOLDEN.glob("hnsw_*.vlc"))


def norm(text: str) -> str:
    return re.sub(r'"created_at": "[^"]+"', '"created_at": "T"', text)


@pytest.fixture(params=["native", "python"])
def emitter(request, monkeypatch):
    """Both packages' native codecs, or both Python twins."""
    if request.param == "python":
        monkeypatch.setenv("VECTORLITE_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("VECTORLITE_NO_NATIVE", raising=False)
    return request.param


def random_meta(rng, depth=0):
    roll = rng.random()
    if depth >= 3 or roll < 0.25:
        return rng.choice([None, True, False, 0, -7, 3.5, -0.0, 1e308, 5e-324, "",
                           "naïve", "日本語 🌍", "line\nbreak\t\"q\"\\"])
    if roll < 0.55:
        return [random_meta(rng, depth + 1) for _ in range(rng.randrange(0, 4))]
    return {f"k{i}_ü": random_meta(rng, depth + 1) for i in range(rng.randrange(0, 4))}


def random_rows(trial: int):
    """(dim, [(id, values, text, metadata)]) with edge floats, unicode
    texts and nested metadata; n = 80 engages the bulk row emitter."""
    rng = random.Random(99 + trial)
    np_rng = np.random.default_rng(99 + trial)
    dim = [1, 3, 8, 17][trial]
    n = [1, 5, 80, 200][trial]
    rows = []
    for i in range(n):
        v = np_rng.standard_normal(dim) * 10.0 ** np_rng.integers(-300, 300)
        for j, slot in enumerate(np_rng.integers(0, dim, size=3)):
            v[slot] = [0.0, -0.0, 5e-324, 1e308, -1e16, 123456789.0, 1e-5][(j * 3) % 7]
        text = "".join(rng.choice("aé日🌍\t\"\\\x01 z") for _ in range(rng.randrange(0, 12)))
        rows.append((i * 7 + trial, v, text, random_meta(rng)))
    return dim, rows


def both_collections(dim, rows, name="r"):
    jidx = JFlat(dim, [JVector(id=i, values=v, text=t, metadata=m) for i, v, t, m in rows])
    tidx = tv.FlatIndex(dim, [Vector(id=i, values=v, text=t, metadata=m) for i, v, t, m in rows],
                        device="cpu")
    return JCollection(name, jidx), tv.Collection(name, tidx)


@pytest.mark.parametrize("trial", range(4))
def test_save_is_byte_identical_to_jax(trial, emitter, tmp_path):
    dim, rows = random_rows(trial)
    jcol, tcol = both_collections(dim, rows)
    for state in ("fresh", "after-mutations"):
        if state == "after-mutations":
            for col in (jcol, tcol):
                col.update_metadata(rows[-1][0], {"edited": [1, 2.5, None]})
                col.delete(rows[0][0])
        calls = VLC.calls
        jvlc.save_collection_to_file(jcol, tmp_path / "j.vlc")
        vlc.save_collection_to_file(tcol, tmp_path / "t.vlc")
        text = (tmp_path / "t.vlc").read_text(encoding="utf-8")
        assert norm(text) == norm((tmp_path / "j.vlc").read_text(encoding="utf-8"))
        served = VLC.calls - calls
        assert (served > 0) == (emitter == "native" and tcol.get_info().count > 0)
        # the port's save loads back bit-exactly and re-saves identically
        back = vlc.load_collection_from_file(tmp_path / "t.vlc", device="cpu")
        vlc.save_collection_to_file(back, tmp_path / "t2.vlc")
        assert norm((tmp_path / "t2.vlc").read_text(encoding="utf-8")) == norm(text)


EDGE_FLOATS = [0.0, -0.0, 1.0, -0.5, 0.1, 2.0 / 3.0, 1e15, 1e16, 1e17, -1e16,
               9999999999999998.0, 12345678901234567.0, 1e-4, 1e-5, 1.2345e-5, 5e-324,
               2.2250738585072014e-308, 1.7976931348623157e308, 1234567890123456.0,
               -3e10, float("inf"), float("-inf"), float("nan")]


@pytest.mark.parametrize("values", ["edges", "bitcast", "scaled"])
def test_native_float_format_matches_python_and_jax(values, monkeypatch):
    """``vlc_fmt_f64`` (the codec's scalar formatter) against the port's
    Python ``_emit_f64`` and the JAX package's, value by value."""
    import ctypes

    monkeypatch.delenv("VECTORLITE_NO_NATIVE", raising=False)
    lib = VLC.library()
    assert lib is not None, "csrc/vlc_emit.cpp did not build"
    rng = np.random.default_rng(7)
    xs = {"edges": EDGE_FLOATS,
          "bitcast": rng.integers(0, 2**64, 5000, dtype=np.uint64).view(np.float64),
          "scaled": np.concatenate([rng.standard_normal(500) * s
                                    for s in (1.0, 1e-9, 1e9, 1e300, 1e-300)])}[values]
    buf = ctypes.create_string_buffer(64)
    for x in map(float, xs):
        n = lib.vlc_fmt_f64(x, buf)
        assert buf.raw[:n].decode("ascii") == vlc._emit_f64(x) == jvlc._emit_f64(x), repr(x)


@pytest.mark.parametrize("name", FLAT_GOLDENS)
def test_golden_flat_files_load_bit_exactly_and_resave(name, emitter, tmp_path):
    path = GOLDEN / name
    tcol = vlc.load_collection_from_file(path, device="cpu")
    jcol = jvlc.load_collection_from_file(path)
    assert (tcol.name, tcol.next_id()) == (jcol.name, jcol.next_id())
    with jcol.index_read() as jix, tcol.index_read() as tix:
        assert (tix.dimension, len(tix)) == (jix.dimension, len(jix))
        for vid in jix._id_to_slot:
            a, b = jix.get_vector(vid), tix.get_vector(vid)
            # bytes, not ==: -0.0 == 0.0 would hide a lost sign
            assert (np.asarray(b.values, np.float64).tobytes()
                    == np.asarray(a.values, np.float64).tobytes())
            assert (b.text, b.metadata) == (a.text, a.metadata)
    vlc.save_collection_to_file(tcol, tmp_path / "out.vlc")
    assert norm((tmp_path / "out.vlc").read_text(encoding="utf-8")) == norm(
        path.read_text(encoding="utf-8"))


def test_golden_edge_values():
    col = vlc.load_collection_from_file(GOLDEN / "flat_edge_reference.vlc", device="cpu")
    v0 = col.get_vector(0)
    assert np.copysign(1.0, v0.values[0]) == -1.0 and v0.values[1] == 5e-324
    assert v0.text == "héllo 世界 🚀"
    assert col.get_vector(3).values == [1e-5, 1e-6, 1e16]
    res = vlc.load_collection_from_file(GOLDEN / "flat_reference.vlc", device="cpu")
    assert res._index.search([1.0, 0.0, 0.0], 1, tv.SimilarityMetric.COSINE)[0].id == 0


def cross_clients(seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((600, 48))
    texts = [f"text {i} é" for i in range(600)]
    metas = [{"p": i % 5, "w": [i, None]} for i in range(600)]
    j = jv.VectorLiteClient(jv.MockEmbeddingFunction(48))
    t = tv.VectorLiteClient(tv.MockEmbeddingFunction(48), device="cpu")
    for client, m in ((j, jv), (t, tv)):
        client.create_collection("x", m.IndexType.FLAT)
        client.add_vectors_to_collection("x", vals, texts, metas)
        client.delete_where_in_collection("x", {"p": 2})
        client.update_text_in_collection("x", 9, "moved to the end", {"p": 7})
    return j, t, rng.standard_normal((9, 48))


def results(client, queries, where=None):
    out = []
    for metric in ("Cosine", "Euclidean", "DotProduct", "Manhattan"):
        m = type(client).__module__.startswith("vectorlite_tpu_torch")
        sm = (tv if m else jv).SimilarityMetric(metric)
        for row in client.search_vectors_in_collection("x", queries, 7, sm, where=where):
            out.append([(h.id, h.text, h.metadata, h.score) for h in row])
    return out


def assert_same_results(a, b):
    assert [[r[:3] for r in row] for row in a] == [[r[:3] for r in row] for row in b]
    np.testing.assert_allclose([r[3] for row in a for r in row],
                               [r[3] for row in b for r in row], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_files_cross_load_with_equal_results(direction, emitter, tmp_path):
    j, t, queries = cross_clients()
    path = tmp_path / "x.vlc"
    if direction == "port-to-jax":
        t.get_collection("x").save_to_file(path)
        loaded = jv.VectorLiteClient(jv.MockEmbeddingFunction(48))
        loaded.add_collection(jvlc.load_collection_from_file(path))
        live = t
    else:
        j.get_collection("x").save_to_file(path)
        loaded = tv.VectorLiteClient(tv.MockEmbeddingFunction(48), device="cpu")
        loaded.add_collection(tv.Collection.load_from_file(path, **loaded.flat_index_kwargs()))
        live = j
    for where in (None, {"p": {"$in": [1, 7]}}):
        assert_same_results(results(loaded, queries, where), results(live, queries, where))
    a = loaded.list_vectors_in_collection("x", 0, 1000, None, True)[0]
    b = live.list_vectors_in_collection("x", 0, 1000, None, True)[0]
    assert [(v.id, v.text, v.metadata, v.values) for v in a] == [
        (v.id, v.text, v.metadata, v.values) for v in b]
    assert loaded.get_collection("x").next_id() == live.get_collection("x").next_id()
    for client in (j, t, loaded):
        for name in client.list_collections():
            client.delete_collection(name)


def test_load_forwards_the_clients_index_kwargs(tmp_path):
    _, t, _ = cross_clients()
    t.get_collection("x").save_to_file(tmp_path / "x.vlc")
    q = tv.VectorLiteClient(tv.MockEmbeddingFunction(48),
                            config=tv.VectorLiteConfig.profile("quantized"), device="cpu")
    col = tv.Collection.load_from_file(tmp_path / "x.vlc", **q.flat_index_kwargs())
    assert col._index._quantized and col._index.device.type == "cpu"
    assert col.get_info().count == t.get_collection_info("x").count


@pytest.mark.parametrize("name", HNSW_GOLDENS)
def test_hnsw_payloads_are_refused(name, emitter):
    with pytest.raises(HNSWNotPorted, match="HNSW"):
        vlc.load_collection_from_file(GOLDEN / name, device="cpu")
    with pytest.raises(HNSWNotPorted):
        vlc.load_collection_from_bytes((GOLDEN / name).read_bytes(), device="cpu")


def flat_doc() -> str:
    col = vlc.load_collection_from_file(GOLDEN / "flat_reference.vlc", device="cpu")
    return vlc.dumps_pretty(vlc.collection_to_json(col))


def mangled(key, value):
    doc = json.loads(flat_doc())
    node = doc
    for k in key[:-1]:
        node = node[k]
    node[key[-1]] = value
    return json.dumps(doc).encode()


MALFORMED = {
    "invalid-json": b"invalid json",
    "deep-arrays": b"[" * 10000 + b"]" * 10000,
    "deep-for-native": b"[" * 2_000_000 + b"1" + b"]" * 2_000_000,
    "deep-objects": b'{"a":' * 5000 + b"1" + b"}" * 5000,
    "top-level-array": b"[1, 2, 3]",
    "header-not-dict": b'{"header": "not a dict"}',
    "index-not-dict": (b'{"header": {"version": "1.0.0", '
                       b'"format": "vectorlite-collection"}, "index": 7}'),
    "no-index": b'{"header": {"version": "1.0.0", "format": "vectorlite-collection"}}',
    "version": None,
    "format": None,
    "unknown-index": None,
    "dim-junk": None,
    "row-short": None,
    "id-junk": None,
    "data-not-list": None,
}


def malformed_bytes(case):
    raw = MALFORMED[case]
    if raw is not None:
        return raw
    return {
        "version": lambda: mangled(["header", "version"], "2.0.0"),
        "format": lambda: mangled(["header", "format"], "something-else"),
        "unknown-index": lambda: mangled(["index"], {"IVF": {}}),
        "dim-junk": lambda: mangled(["index", "Flat", "dim"], "junk"),
        "row-short": lambda: mangled(["index", "Flat", "data", 0, "values"], [1.0]),
        "id-junk": lambda: mangled(["index", "Flat", "data", 1, "id"], [None]),
        "data-not-list": lambda: mangled(["index", "Flat", "data"], 7),
    }[case]()


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_documents_raise_the_references_typed_errors(case, emitter, tmp_path):
    path = tmp_path / "bad.vlc"
    path.write_bytes(malformed_bytes(case))
    with pytest.raises(Exception) as want:
        jvlc.load_collection_from_file(path)
    with pytest.raises(VectorLiteError) as got:
        vlc.load_collection_from_file(path, device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_missing_file_is_typed(tmp_path):
    from vectorlite_tpu_torch.errors import FileNotFound

    with pytest.raises(FileNotFound):
        vlc.load_collection_from_file(tmp_path / "nope.vlc", device="cpu")


def test_concurrent_saves_same_path(tmp_path):
    col = vlc.load_collection_from_file(GOLDEN / "flat_reference.vlc", device="cpu")
    path = tmp_path / "race.vlc"
    errors = []

    def saver():
        try:
            for _ in range(10):
                vlc.save_collection_to_file(col, path)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=saver) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    assert vlc.load_collection_from_file(path, device="cpu").get_info().count == 3
    assert not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------- disk-backed truth


@pytest.fixture
def truth_dir(tmp_path, monkeypatch):
    d = tmp_path / "truth"
    monkeypatch.setenv("VECTORLITE_HOST_TRUTH_DIR", str(d))
    return d


def unit_rows(n, d=16, seed=0):
    r = np.random.default_rng(seed).normal(size=(n, d))
    return r / np.linalg.norm(r, axis=1, keepdims=True)


def test_truth_dir_backing_is_an_unlinked_memmap(truth_dir):
    index = tv.FlatIndex(16, device="cpu")
    assert isinstance(index._values64, np.memmap)
    assert list(truth_dir.iterdir()) == []


def test_truth_dir_matches_ram_index_and_jax(truth_dir, monkeypatch, tmp_path):
    rows = unit_rows(700)
    mm = tv.FlatIndex(16, device="cpu")
    jmm = JFlat(16)
    monkeypatch.delenv("VECTORLITE_HOST_TRUTH_DIR")
    ram = tv.FlatIndex(16, device="cpu")
    for idx, vec in ((mm, Vector), (ram, Vector), (jmm, JVector)):
        idx.add_batch_arrays(list(range(600)), rows[:600],
                             metadatas=[{"p": i % 3} for i in range(600)])
        for i in range(600, 700):  # capacity growth reallocates the memmap
            idx.add(vec(id=i, values=rows[i], text=f"t{i}"))
        for i in range(0, 600, 3):
            idx.delete(i)
        idx.delete_where({"p": 1})
        idx.compact()
    assert isinstance(mm._values64, np.memmap) and isinstance(jmm._values64, np.memmap)
    assert not isinstance(ram._values64, np.memmap)
    q = unit_rows(4, seed=9)
    for metric in tv.SimilarityMetric:
        jm = jv.SimilarityMetric(metric.value)
        for b in range(4):
            a = [(r.id, r.score) for r in mm.search(q[b], 10, metric)]
            assert a == [(r.id, r.score) for r in ram.search(q[b], 10, metric)]
            assert a == [(r.id, r.score) for r in jmm.search(q[b], 10, jm)]
    col = tv.Collection("mm", mm)
    col.save_to_file(tmp_path / "mm.vlc")
    loaded = tv.Collection.load_from_file(tmp_path / "mm.vlc", device="cpu")
    for v in loaded.get_vectors([601, 650, 699]):
        assert np.asarray(v.values).tobytes() == mm._values64[mm._id_to_slot[v.id]].tobytes()


@pytest.mark.cuda
def test_card_collection_round_trips_with_equal_results(tmp_path, monkeypatch):
    """A collection served on the card at kernel scale, saved and loaded
    into a fresh card client: the same ids and scores for a batch on the
    speed path (K3 + re-score) and the exact path (K1), and the native
    codec served the save."""
    if not torch.cuda.is_available():
        pytest.skip("the scan kernels are CUDA C++ and run only on an NVIDIA card")
    from vectorlite_tpu_torch.index import flat

    monkeypatch.setattr(flat, "_PALLAS_MIN_CAPACITY", 1 << 14)
    monkeypatch.setenv("VECTORLITE_SPEED_GUARD", "0")
    monkeypatch.delenv("VECTORLITE_NO_NATIVE", raising=False)
    rng = np.random.default_rng(11)
    rows = rng.standard_normal((30_000, 96)).astype(np.float32)
    queries = rng.standard_normal((64, 96))
    t = tv.VectorLiteClient(tv.MockEmbeddingFunction(96))
    t.create_collection("c", "flat")
    t.add_vectors_to_collection("c", rows, [f"r{i}" for i in range(30_000)],
                                [{"b": i % 16} for i in range(30_000)])
    t.delete_where_in_collection("c", {"b": 3})
    t.compact_collection("c")
    before = [t.search_vectors_in_collection("c", queries, 10),
              t.search_vectors_in_collection("c", queries, 10, where={"b": 5})]
    calls = VLC.calls
    t.get_collection("c").save_to_file(tmp_path / "c.vlc")
    assert VLC.calls > calls
    fresh = tv.VectorLiteClient(tv.MockEmbeddingFunction(96))
    fresh.add_collection(tv.Collection.load_from_file(tmp_path / "c.vlc",
                                                      **fresh.flat_index_kwargs()))
    assert fresh.get_collection("c")._index.device.type == "cuda"
    after = [fresh.search_vectors_in_collection("c", queries, 10),
             fresh.search_vectors_in_collection("c", queries, 10, where={"b": 5})]
    for x, y in zip(before, after):
        assert [[(h.id, h.score) for h in row] for row in x] == [
            [(h.id, h.score) for h in row] for row in y]
    for client in (t, fresh):
        client.delete_collection("c")
