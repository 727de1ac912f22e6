"""``import.program_s``: host seconds of ``import graphsage_torch``, from
the two stamps at the first and the last line of the package's
``__init__.py`` (the span ``import.graphsage_torch``), the program's part of
the imports in ``setup_s``."""

from perfbench.harness.program_spans import seconds


def read(rec, cell):
    return seconds("import.graphsage_torch")
