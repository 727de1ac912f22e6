"""``train_step_mfu.fullgraph``: ``train_step_mfu`` of a full-graph cell,
which moves ``train_seeds_per_s.fullgraph``."""

from perfbench.harness.spec import metric_reader


def read(rec, cell):
    return metric_reader("train_step_mfu")(rec, cell)
