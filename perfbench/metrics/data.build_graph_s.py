"""``data.build_graph_s``: host seconds of the program's ``build_graph`` on
the benchmark's arrays (sort, CSR and ELL on the host, the copy to the
card), the ingestion part of ``setup_s``."""


def read(rec, cell):
    return rec.values.get("build_graph_s")
