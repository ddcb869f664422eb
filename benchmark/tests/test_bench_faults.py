"""A whole run on the CPU (the harness's look for a card skipped, the
deployment cut to 20,000 rows) comes out correct, and the same run with
the timed path broken underneath comes out not correct: an answer
altered where the index produces it, by its id or by its score."""

import time

import pytest

from benchmark import run
from vectorlite_tpu_torch.index import flat

CELLS = ["cohere768.batch1k.k10", "gist960.batch1k.k10"]


def run_small(cell):
    return run.run_cell(cell, 2**31 + 99, 1.5, False, "cpu", started=time.perf_counter())


def alter(how):
    sound = flat.FlatIndex.search_batch

    def broken(self, *a, **kw):
        out = sound(self, *a, **kw)
        hits = out[len(out) // 2]
        if how == "id":
            hits[-1].id = (hits[-1].id + self._count // 2) % self._count
        else:
            hits[0].score += 1e-3
        return out

    return broken


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, small_cell):
    res = run_small(small_cell(name))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"qps", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("how", ["id", "score"])
@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(name, how, small_cell, monkeypatch):
    monkeypatch.setattr(flat.FlatIndex, "search_batch", alter(how))
    res = run_small(small_cell(name))
    assert not res["correct"], res["checks"]
