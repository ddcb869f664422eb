"""Share of the traced stretch spent in full (generation 2) GC passes:
the summed ``vectorlite.gc.full`` ranges inside it over its length. The
program opens one around each pass while a profiler records, from a
``gc.callbacks`` entry of its ``observability`` module. 0.0 where the
trace holds none; None without a trace, or where the program has no such
entry (it does not trace the passes)."""

import gc

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host runtime"
MOVES = "qps"

SPAN = "vectorlite.gc.full"
HOOK_MODULE = "vectorlite_tpu_torch.observability"


def read(record):
    tr = record.trace
    if tr is None or tr.window_s <= 0:
        return None
    if not any(getattr(cb, "__module__", None) == HOOK_MODULE for cb in gc.callbacks):
        return None
    return 100.0 * sum(tr.spans.get(SPAN, [])) / tr.window_s
