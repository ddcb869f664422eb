"""The port's recorders against the JAX package's: the same sequence of
records gives the same snapshots and the same Prometheus text."""

import numpy as np
import pytest

from vectorlite_tpu import observability as jobs
from vectorlite_tpu_torch import observability as tobs


def feed_latency(mod, rng):
    rec = mod.LatencyRecorder()
    routes = ["POST /collections/{name}/search/text", 'GET /we"ird\nroute', "r"]
    for i in range(3 * mod.LatencyRecorder._MAX_SAMPLES + 17):
        rec.record(routes[i % 3], float(rng.exponential(0.004)), ok=i % 11 != 0)
    return rec


@pytest.mark.parametrize("seed", [0, 1])
def test_latency_recorder_matches_jax(seed):
    j = feed_latency(jobs, np.random.default_rng(seed)).snapshot()
    t = feed_latency(tobs, np.random.default_rng(seed)).snapshot()
    assert t == j
    assert t["r"]["count"] == tobs.LatencyRecorder._MAX_SAMPLES + 5


@pytest.mark.parametrize("sizes", [[], [1], [1, 3, 4, 5, 16, 17, 64, 65, 256, 256, 2, 1]],
                         ids=["none", "one", "every-bucket"])
def test_coalesce_recorder_matches_jax(sizes):
    j, t = jobs.CoalesceRecorder(), tobs.CoalesceRecorder()
    for n in sizes:
        j.record(n)
        t.record(n)
    assert t.snapshot() == j.snapshot()


def test_filter_recorder_matches_jax():
    j, t = jobs.FilterRecorder(), tobs.FilterRecorder()
    assert t.snapshot() == j.snapshot() == {"lookups": 0}
    for kind, rows in [("build", 100), ("hit", 0), ("extend", 7), ("hit", 0), ("build", 3)]:
        j.record(kind, rows)
        t.record(kind, rows)
    assert t.snapshot() == j.snapshot()


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "autosave-and-wal"])
def test_render_prometheus_matches_jax(extras):
    rng = np.random.default_rng(3)
    latency = feed_latency(tobs, rng).snapshot()
    coalesce, filters = tobs.CoalesceRecorder(), tobs.FilterRecorder()
    for n in (1, 7, 64):
        coalesce.record(n)
    filters.record("hit")
    filters.record("build", 9)
    args = [latency, coalesce.snapshot(), filters.snapshot(),
            {'we"ird\nname': 7, "plain": 0}]
    kw = {}
    if extras:
        kw = {"autosave": {"saves": 4, "failures": 1, "last_flush_ts": 1700000000.25},
              "wal": {"collections": {"w": {"appends": 6, "size_bytes": 512,
                                            "checkpoints": 1}}}}
    text = tobs.render_prometheus(*args, **kw)
    assert text == jobs.render_prometheus(*args, **kw)
    assert 'vectorlite_collection_vectors{collection="we\\"ird\\nname"} 7' in text
    assert ("vectorlite_wal_appends_total" in text) == extras


def test_filtered_searches_count_in_filter_stats():
    import vectorlite_tpu_torch as tv

    index = tv.FlatIndex(4, device="cpu")
    index.add_batch_arrays(range(8), np.eye(8, 4), metadatas=[{"p": i % 2} for i in range(8)])
    before = tobs.filter_stats.snapshot()
    index.search_batch(np.ones((2, 4)), 2, tv.SimilarityMetric.COSINE, where={"p": 1})
    index.search_batch(np.ones((2, 4)), 2, tv.SimilarityMetric.COSINE, where={"p": 1})
    index.add_batch_arrays([8], np.ones((1, 4)), metadatas=[{"p": 1}])
    index.search_batch(np.ones((2, 4)), 2, tv.SimilarityMetric.COSINE, where={"p": 1})
    after = tobs.filter_stats.snapshot()
    assert after["full_builds"] == before.get("full_builds", 0) + 1
    assert after["cache_hits"] == before.get("cache_hits", 0) + 1
    assert after["incremental_extensions"] == before.get("incremental_extensions", 0) + 1


def test_profile_span_enters_no_range_without_a_profiler(monkeypatch):
    import torch

    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: entered.append(name) or real(name, *a))
    for _ in range(3):
        with tobs.profile_span("vectorlite.test.off"):
            pass
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.profile_span("vectorlite.test.on"):
            pass
    assert entered == ["vectorlite.test.on"]
    assert "vectorlite.test.on" in {e.name for e in prof.events()}


def test_profile_span_on_another_thread_shows_in_an_all_threads_trace():
    """The profiler's flag is process-wide: a span opened on a thread the
    profiler was not started from still enters its range (the profiler
    built as the benchmark's trace builds it)."""
    import threading

    import torch

    def work():
        with tobs.profile_span("vectorlite.test.thread"):
            torch.ones(2).add_(1)

    cfg = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                experimental_config=cfg) as prof:
        with tobs.profile_span("vectorlite.test.main"):
            worker = threading.Thread(target=work)
            worker.start()
            worker.join()
    threads = {e.name: e.thread for e in prof.events() if e.name.startswith("vectorlite.test.")}
    assert set(threads) == {"vectorlite.test.main", "vectorlite.test.thread"}
    assert threads["vectorlite.test.thread"] != threads["vectorlite.test.main"]
