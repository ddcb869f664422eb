"""Mean length of the ``vectorlite.index.results`` range, in which
``FlatIndex.search_batch`` builds a call's ``SearchResult`` objects (one
a hit), over the ranges inside the traced stretch."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "index"
MOVES = "qps"

SPAN = "vectorlite.index.results"


def read(record):
    spans = record.trace.spans.get(SPAN) if record.trace else None
    return sum(spans) / len(spans) * 1e3 if spans else None
