"""``ingest.to_device_s``: host seconds of the program's span
``ingest.to_device`` (``data/graph.py:build_graph``: every copy to the
graph's device, the features included), the copy part of
``data.build_graph_s``."""

from perfbench.harness.program_spans import seconds


def read(rec, cell):
    return seconds("ingest.to_device")
