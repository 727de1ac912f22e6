"""``setup_s``: process start (the first line of ``run.py``) to the first
timed step: imports, loading the built kernels (building them in a fresh
checkout), the inputs, ``build_graph``, the weights, the checked first
steps and the warm-up of the cell's own shapes."""


def read(rec, cell):
    return rec.values.get("setup_s")
