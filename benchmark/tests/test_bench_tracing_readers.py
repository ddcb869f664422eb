"""The readers of the program's ranges inside the SDK batch search and
around full GC passes, on hand-made reduced traces: ``index.host_ms``
(``search_batch`` less the device stage), ``index.results_ms`` and
``gc.full_pct``."""

import gc

import pytest

from benchmark import spec
from benchmark.run import Record
from benchmark.trace import Trace

SEARCH = "vectorlite.index.search_batch"
LAUNCH, FETCH = "vectorlite.index.launch", "vectorlite.index.fetch"
RESULTS, GC_FULL = "vectorlite.index.results", "vectorlite.gc.full"


def read(metric, trace):
    return spec.load_reader(metric).read(Record(cell=None, trace=trace))


@pytest.fixture
def program_gc_hook(monkeypatch):
    """A ``gc.callbacks`` entry of the program's observability module, as
    importing the program's store installs."""
    def hook(phase, info):
        pass

    hook.__module__ = "vectorlite_tpu_torch.observability"
    monkeypatch.setattr(gc, "callbacks", [*gc.callbacks, hook])


@pytest.mark.parametrize("spans, want", [
    ({SEARCH: [0.100, 0.090], LAUNCH: [0.002, 0.004], FETCH: [0.040, 0.050]}, 95.0 - 3.0 - 45.0),
    ({SEARCH: [0.050], LAUNCH: [0.001], FETCH: [0.030], RESULTS: [0.015]}, 19.0),
], ids=["means", "one-call"])
def test_index_host_ms_is_search_batch_less_the_device_stage(spans, want):
    assert read("index.host_ms", Trace(window_s=10.0, spans=spans)) == pytest.approx(want)


@pytest.mark.parametrize("missing", [SEARCH, LAUNCH, FETCH])
def test_index_host_ms_needs_all_three_ranges(missing):
    spans = {SEARCH: [0.1], LAUNCH: [0.01], FETCH: [0.05]}
    spans[missing] = []
    assert read("index.host_ms", Trace(window_s=10.0, spans=spans)) is None
    del spans[missing]
    assert read("index.host_ms", Trace(window_s=10.0, spans=spans)) is None


def test_index_results_ms_is_the_mean_results_range():
    t = Trace(window_s=10.0, spans={RESULTS: [0.020, 0.030, 0.040], SEARCH: [0.1]})
    assert read("index.results_ms", t) == pytest.approx(30.0)
    assert read("index.results_ms", Trace(window_s=10.0, spans={SEARCH: [0.1]})) is None


def test_gc_full_pct_sums_the_passes_over_the_stretch(program_gc_hook):
    t = Trace(window_s=10.0, spans={GC_FULL: [0.25, 0.5, 0.75], SEARCH: [0.1]})
    assert read("gc.full_pct", t) == pytest.approx(15.0)


def test_gc_full_pct_reads_zero_on_a_trace_without_passes(program_gc_hook):
    assert read("gc.full_pct", Trace(window_s=10.0, spans={SEARCH: [0.1]})) == 0.0


def test_gc_full_pct_reads_nothing_where_the_program_traces_no_passes(monkeypatch):
    monkeypatch.setattr(gc, "callbacks", [])
    assert read("gc.full_pct", Trace(window_s=10.0, spans={GC_FULL: [0.5]})) is None


@pytest.mark.parametrize("metric", ["index.host_ms", "index.results_ms", "gc.full_pct"])
def test_no_trace_reads_nothing(metric, program_gc_hook):
    assert read(metric, None) is None
    assert read(metric, Trace()) is None  # a trace without the harness's mark
