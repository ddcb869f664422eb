"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
deployment (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its correctness limits
(``limits/<workload>.json``) and each metric's reader
(``metrics/<metric>.py``). Nothing here imports torch or the program."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: the fields every metric reader declares (per-layer readers add LAYER
#: and MOVES)
READER_FIELDS = ("UNIT", "BETTER", "SOURCE")


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries: every cell reports all
    per_layer: list
    peaks: dict


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark_json(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload``; KeyError names what is missing."""
    bench = benchmark_json(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=load_json(HERE / "configs" / f"{entry['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{workload}.json"),
        end_to_end=list(bench["end_to_end"]),
        per_layer=list(bench["per_layer"]),
        peaks=load_json(HERE / "peaks.json"),
    )


def load_reader(metric: str):
    """The module ``metrics/<metric>.py``: its ``read(record)`` gives the
    metric's value, or None where it finds nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    if spec is None:
        raise KeyError(f"no reader for metric {metric!r} ({path})")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [f for f in READER_FIELDS if not hasattr(module, f)]
    if missing or not callable(getattr(module, "read", None)):
        raise TypeError(f"{path} lacks {missing or ['read']}")
    return module
