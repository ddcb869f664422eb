"""The SDK ingest of the corpus in set-up: the client and collection
made, then ``add_vectors`` of every row (harness clock around it)."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "store"
MOVES = "setup_s"


def read(record):
    return record.timings.get("load_s")
