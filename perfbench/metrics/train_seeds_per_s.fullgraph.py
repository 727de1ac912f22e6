"""``train_seeds_per_s.fullgraph``: ``train_seeds_per_s`` of a full-graph
cell (each step takes the loss of the whole train split), an end-to-end
metric of its own so that its bound follows its own runs' spread: a
device-bound step spreads by a fraction of what a host-bound sampled step
does."""

from perfbench.harness.spec import metric_reader


def read(rec, cell):
    return metric_reader("train_seeds_per_s")(rec, cell)
