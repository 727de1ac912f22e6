"""``ingest.sort_s``: host seconds of the program's span ``ingest.sort``
(``data/graph.py:sorted_unique_edges``: the int64 keys of both directions,
numpy's stable sort, the dedup), the sort part of ``data.build_graph_s``."""

from perfbench.harness.program_spans import seconds


def read(rec, cell):
    return seconds("ingest.sort")
