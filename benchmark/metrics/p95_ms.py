"""The 95th percentile of the SDK calls (``search_vectors``, the whole
call: client, collection, index, kernels and the result objects) issued
in the window, each from when its client issued it to when it returned,
failed calls included. It is read in the traced run: the calls that
overlap the profiler's stretch (from just before the profiler is built)
or the reading of its trace after it are left out, and every other call
of the window counts.

A closed loop keeps every client busy, so its tail swings with the
host's speed and with full GC passes far more than its rate does: the
tail is a per-layer reading here, and ``qps`` the end-to-end one."""

import numpy as np

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "sdk call"
MOVES = "qps"


def read(record):
    tr = record.trace
    lat = [end - issued for _, issued, end, _, _ in record.window.calls
           if tr is None or end < tr.host_start or issued > tr.host_done]
    return float(np.percentile(lat, 95) * 1e3) if lat else None
