"""The cell's least time per call, from its shapes alone
(``roofline.least_seconds``), over the card's time per call: every
kernel, copy and memset on the card (the library's too) that a
``vectorlite.index.search_batch`` range launched, matched to it by the
profiler's correlation ids, averaged over the ranges inside the traced
stretch that launched any (a range whose launches the profiler did not
link has none)."""

from benchmark import roofline

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "qps"

SPAN = "vectorlite.index.search_batch"


def read(record):
    per_call = [s for s in record.trace.device_by_span.get(SPAN, [])
                if s > 0] if record.trace else []
    if not per_call:
        return None
    least = roofline.least_seconds(record.cell.config, record.cell.traffic, record.cell.peaks)
    return 100.0 * least / (sum(per_call) / len(per_call))
