"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from
the repository root. Tests that need the card carry the ``cuda`` marker
and skip where there is none."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


import pytest  # noqa: E402


@pytest.fixture
def small_cell():
    """A cell of BENCHMARK.json at a size the CPU holds: its deployment
    cut to ``rows`` rows and its query pool to ``pool``."""
    from benchmark import spec

    def make(name, rows=20000, pool=1000):
        cell = spec.load_cell(name)
        cell.config = dict(cell.config, rows=rows)
        cell.traffic = dict(cell.traffic, query_pool=pool)
        return cell

    return make
