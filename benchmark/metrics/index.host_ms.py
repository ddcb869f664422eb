"""The index's host self time a call: the mean ``vectorlite.index.search_batch``
range less the mean ``vectorlite.index.launch`` range (the device lock,
the cache sync, the queries' upload and the kernel launches) and the mean
``vectorlite.index.fetch`` range (the wait for the card and the copy
back), over the ranges inside the traced stretch. None unless all three
were traced."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "index"
MOVES = "qps"

SPAN = "vectorlite.index.search_batch"
DEVICE_STAGE = ("vectorlite.index.launch", "vectorlite.index.fetch")


def read(record):
    if record.trace is None:
        return None
    means = []
    for name in (SPAN,) + DEVICE_STAGE:
        spans = record.trace.spans.get(name)
        if not spans:
            return None
        means.append(sum(spans) / len(spans))
    return (means[0] - sum(means[1:])) * 1e3
