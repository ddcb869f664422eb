"""Process start to the first timed call: imports, the corpus made and
ingested through the SDK, the device cache built, kernels built or
loaded, and the cell's shapes warmed up."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(record):
    return record.timings.get("setup_s")
