"""``init.objects_s``: host seconds of the program's constructors, the
spans ``model.init`` (``GraphSAGE``'s parameters, built and moved to the
device) and ``trainer.init`` (``Trainer``, ``FullGraphTrainer``: the
optimizer, the splits, the train weights), each counted once."""

from perfbench.harness.program_spans import seconds


def read(rec, cell):
    return seconds("model.init", "trainer.init")
