"""``device.idle_share.fullgraph``: ``device.idle_share.train`` of a
full-graph cell, which moves ``train_seeds_per_s.fullgraph``."""

from perfbench.harness.spec import metric_reader


def read(rec, cell):
    return metric_reader("device.idle_share.train")(rec, cell)
