"""Tracing spans for the serving steps.

Only ``profile_span`` is ported so far; metrics, counters and device
trace capture come with the serving-surface port.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def profile_span(name: str):
    """A ``torch.profiler`` range around a serving step, so a profiler
    trace shows it beside the kernels it launched. Without an active
    profiler the range costs a flag check."""
    with torch.profiler.record_function(name):
        yield
