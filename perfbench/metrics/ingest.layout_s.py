"""``ingest.layout_s``: host seconds of the program's span ``ingest.layout``
(``data/graph.py:build_graph``: degrees, the ELL table, the CSR and the
edge padding, on the host), the layout part of ``data.build_graph_s``."""

from perfbench.harness.program_spans import seconds


def read(rec, cell):
    return seconds("ingest.layout")
