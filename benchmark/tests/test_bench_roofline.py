"""Each cell's least time a call, from its shapes and the card's peaks."""

import pytest

from benchmark import roofline, spec

#: (cell, least seconds, bound by): rows x dim x bytes / 3.35e12 against
#: 2 x batch x rows x dim / the traffic's peak (int8: 1,979e12)
EXPECTED = [
    ("cohere768.batch1k.k10", 2 * 1000 * 1e6 * 768 / 1979e12, "ops"),
    ("gist960.batch1k.k10", 2 * 1000 * 1e6 * 960 / 1979e12, "ops"),
]


@pytest.mark.parametrize("cell,least,bound_by", EXPECTED)
def test_least_seconds(cell, least, bound_by):
    c = spec.load_cell(cell)
    got = roofline.least_seconds(c.config, c.traffic, c.peaks)
    assert got == pytest.approx(least, rel=1e-12)
    ops = 2 * c.traffic["batch"] * c.config["rows"] * c.config["dim"] / c.peaks[
        c.traffic["roofline"]["peak"]]
    assert (got > ops) == (bound_by == "bytes")


@pytest.mark.parametrize("batch,width,peak,least", [
    (256, 1, "int8_ops_per_s", 1e6 * 768 * 1 / 3.35e12),
    (256, 4, "tf32_ops_per_s", 1e6 * 768 * 4 / 3.35e12),
    (4096, 4, "tf32_ops_per_s", 2 * 4096 * 1e6 * 768 / 495e12),
])
def test_bytes_or_ops_bound_by_batch_and_width(batch, width, peak, least):
    c = spec.load_cell("cohere768.batch1k.k10")
    traffic = dict(c.traffic, batch=batch, roofline={"bytes_per_element": width, "peak": peak})
    got = roofline.least_seconds(c.config, traffic, c.peaks)
    assert got == pytest.approx(least, rel=1e-12)
