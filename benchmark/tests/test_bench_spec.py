"""BENCHMARK.json keeps to its contract, and every piece it names is
found by name: each cell's deployment, mix and limits, each metric's
reader with the fields its entry states."""

import json
import re

import pytest

from benchmark import spec

BENCH = spec.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in BENCH["paths"]:
        assert (spec.ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    assert all(isinstance(w, str) and 1 <= len(w) <= 200 for w in BENCH["command"])
    kinds = [[c["name"] for c in BENCH["configs"]], CELLS, [m["name"] for m in METRICS]]
    for names in kinds:
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_are_found_by_name(cell):
    c = spec.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.config["name"] == entry["config"] and c.traffic["name"] == entry["traffic"]
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    assert "score_err" in c.limits and "malformed" in c.limits
    if c.traffic.get("where"):
        assert c.limits["off_filter"] == 0
    assert {m["name"] for m in c.end_to_end} >= {"qps", "setup_s"}
    assert "p95_ms" in {m["name"] for m in c.per_layer}
    assert c.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries_match_their_files(config):
    f = spec.load_json(spec.ROOT / config["file"])
    assert f["name"] == config["name"] and f["reduced"] == config["reduced"]
    assert config["source"].startswith("https://") and len(config["source"]) <= 200
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_readers_state_what_the_entry_states(metric):
    reader = spec.load_reader(metric["name"])
    assert reader.UNIT == metric["unit"] and UNIT.match(metric["unit"])
    assert reader.BETTER == metric["better"] and reader.SOURCE == metric["source"]
    if "layer" in metric:
        assert reader.LAYER == metric["layer"] and reader.MOVES == metric["moves"]
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    # no list of cells: every cell reports every metric, those added later too
    assert "workloads" not in metric


def test_a_missing_workload_is_named():
    with pytest.raises(KeyError, match="no workload"):
        spec.load_cell("no.such.cell")


def test_traffic_mixes_are_data_only():
    for path in (spec.HERE / "traffic").iterdir():
        mix = json.loads(path.read_text())
        assert mix["name"] == path.stem
        assert (spec.HERE / "loops" / f"{mix['loop']}.py").is_file()
