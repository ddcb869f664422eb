"""Mean length of the ``vectorlite.index.search_batch`` range that
``Collection.search_vectors`` opens around ``FlatIndex.search_batch``,
over the ranges inside the traced stretch."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "index"
MOVES = "qps"

SPAN = "vectorlite.index.search_batch"


def read(record):
    spans = record.trace.spans.get(SPAN) if record.trace else None
    return sum(spans) / len(spans) * 1e3 if spans else None
