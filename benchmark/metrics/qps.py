"""Queries answered in the window per second of the window: the queries
of every call that returned by the window's close, over its length."""

UNIT = "queries/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(record):
    win = record.window
    done = sum(q for _, _, end, q, ok in win.calls if ok and end <= win.t_end)
    return done / win.seconds
