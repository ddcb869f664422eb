"""The SDK batch search's profiler ranges: each step of a
``search_vectors`` call opens its range once, the index's steps lie
inside ``vectorlite.index.search_batch`` one after another, the
re-score inside the finalize step, and a full GC pass opens
``vectorlite.gc.full`` only while a profiler records."""

import contextlib
import gc

import numpy as np
import pytest
import torch

import vectorlite_tpu_torch as tv
from vectorlite_tpu_torch import observability

ROWS, DIM, B, K = 256, 16, 8, 5
PARENT = "vectorlite.index.search_batch"
STEPS = ["vectorlite.index.prep", "vectorlite.index.launch", "vectorlite.index.fetch",
         "vectorlite.index.finalize", "vectorlite.index.results"]
RANGES = ["vectorlite.sdk.validate", PARENT] + STEPS


def profiled_call(monkeypatch, profile="default", fn=None):
    """The ``vectorlite.*`` events of one ``search_vectors`` call of ``B``
    queries (or of ``fn(client, queries)``) over a small Flat
    collection on the CPU, on the device dispatch path: {name: [(start,
    end), ...]}."""
    monkeypatch.setenv("VECTORLITE_HOST_SCAN_ROWS", "0")
    rng = np.random.default_rng(7)
    client = tv.VectorLiteClient(tv.MockEmbeddingFunction(DIM),
                                 config=tv.VectorLiteConfig.profile(profile), device="cpu")
    client.create_collection("t", "flat")
    client.add_vectors_to_collection("t", rng.standard_normal((ROWS, DIM)))
    queries = rng.standard_normal((B, DIM))
    call = fn or (lambda c, q: c.search_vectors_in_collection("t", q, K, tv.SimilarityMetric.COSINE))
    call(client, queries)  # builds the device cache outside the trace
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call(client, queries)
    out: dict = {}
    for e in prof.events():
        if e.name.startswith("vectorlite."):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


@pytest.fixture(scope="module")
def one_call():
    with pytest.MonkeyPatch.context() as mp:
        return profiled_call(mp)


@pytest.mark.parametrize("name", RANGES)
def test_a_search_call_opens_each_range_once(one_call, name):
    assert len(one_call[name]) == 1


def test_a_default_call_opens_no_other_range(one_call):
    assert set(one_call) <= set(RANGES) | {observability.GC_SPAN}
    assert "vectorlite.index.rescore" not in one_call


@pytest.mark.parametrize("step", STEPS)
def test_index_steps_lie_inside_search_batch(one_call, step):
    (p0, p1), (s0, s1) = one_call[PARENT][0], one_call[step][0]
    assert p0 <= s0 <= s1 <= p1


def test_steps_follow_each_other_and_validate_comes_first(one_call):
    spans = [one_call[n][0] for n in RANGES[:1] + STEPS]
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert one_call["vectorlite.sdk.validate"][0][1] <= one_call[PARENT][0][0]


@pytest.mark.parametrize("profile", ["quantized", "memory-optimized"])
def test_rescore_lies_inside_finalize(monkeypatch, profile):
    spans = profiled_call(monkeypatch, profile)
    (f0, f1), = spans["vectorlite.index.finalize"]
    (r0, r1), = spans["vectorlite.index.rescore"]
    assert f0 <= r0 <= r1 <= f1


def test_a_stream_fetches_and_finalizes_each_batch(monkeypatch):
    """``search_batch_stream`` shares the dispatch and fetch helpers; its
    fetch workers are other threads, which an all-threads profiler
    records."""
    def stream(client, queries):
        index = client.get_collection("t")._index
        list(index.search_batch_stream([queries, queries[:3]], K,
                                       tv.SimilarityMetric.EUCLIDEAN, depth=1))

    cfg = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: real(experimental_config=cfg, **kw))
    spans = profiled_call(monkeypatch, fn=stream)
    for name in ("vectorlite.index.prep", "vectorlite.index.launch",
                 "vectorlite.index.fetch", "vectorlite.index.finalize"):
        assert len(spans[name]) == 2, name
    assert PARENT not in spans and "vectorlite.index.results" not in spans


@contextlib.contextmanager
def auto_gc_off():
    """No automatic collection runs inside: only the test's own."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def counting_record_function(monkeypatch) -> list:
    """The names of the ranges entered from now on."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return entered


def test_a_full_gc_pass_opens_one_range_under_a_profiler():
    observability.install_gc_span()
    with auto_gc_off(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gc.collect()
    assert [e.name for e in prof.events()].count(observability.GC_SPAN) == 1


@pytest.mark.parametrize("generation", [0, 1, 2])
def test_no_gc_range_without_a_profiler(monkeypatch, generation):
    entered = counting_record_function(monkeypatch)
    observability.install_gc_span()
    gc.collect(generation)
    assert entered == []


def test_only_full_passes_open_the_gc_range(monkeypatch):
    entered = counting_record_function(monkeypatch)
    observability.install_gc_span()
    with auto_gc_off(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        gc.collect(0)
        gc.collect(1)
        assert entered == []
        gc.collect(2)
    assert entered == [observability.GC_SPAN]


def test_installing_the_gc_hook_twice_leaves_one_callback():
    observability.install_gc_span()
    observability.install_gc_span()
    assert gc.callbacks.count(observability._gc_full_span) == 1
