"""The generator: the same seed gives the same corpus, queries and
metadata; shapes and normalisation follow the deployment."""

import numpy as np
import pytest

from benchmark import data, spec


def small(name, rows=3000):
    cfg = dict(spec.load_json(spec.HERE / "configs" / f"{name}.json"))
    cfg["rows"] = rows
    return cfg


@pytest.mark.parametrize("name", ["cohere-768d-1m", "gist-960d-1m"])
def test_same_seed_same_data(name):
    cfg = small(name)
    a = data.make_data(cfg, 50, 2**31 + 7, "cpu")
    b = data.make_data(cfg, 50, 2**31 + 7, "cpu")
    c = data.make_data(cfg, 50, 2**31 + 8, "cpu")
    assert np.array_equal(a.rows, b.rows) and np.array_equal(a.queries, b.queries)
    assert not np.array_equal(a.rows, c.rows)
    assert a.metadata == b.metadata


@pytest.mark.parametrize("name", ["cohere-768d-1m", "gist-960d-1m"])
def test_shapes_and_norms(name):
    cfg = small(name)
    made = data.make_data(cfg, 64, 11, "cpu")
    assert made.rows.shape == (3000, cfg["dim"]) and made.rows.dtype == np.float32
    assert made.queries.shape == (64, cfg["dim"])
    norms = np.linalg.norm(made.rows, axis=1)
    if cfg["generator"]["normalize"]:
        assert np.allclose(norms, 1.0, atol=1e-5)
    else:
        assert norms.std() > 1e-3
    # the queries are drawn after the corpus, not a copy of its rows
    assert not np.isin(made.queries[:, 0], made.rows[:, 0]).any()


def test_metadata_holds_the_row_position():
    cfg = small("cohere-768d-1m", rows=20)
    meta = data.make_metadata(cfg)
    assert meta == [{"pos": i} for i in range(20)]
    assert data.make_metadata(small("gist-960d-1m", rows=20)) is None
