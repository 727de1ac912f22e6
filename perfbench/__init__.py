"""The benchmark of ``graphsage_torch`` on one card: one cell per run.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs the cell ``<name>`` of the root's ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix, kind of
traffic or metric sits in a file of its own, found by name:

  configs/<config>.json   graph sizes, model widths, dtype, optimizer
  traffic/<cell>.json     a ``kind`` and that kind's parameters (and limits)
  drivers/<kind>.py       drives one entry point of the program
  metrics/<metric>.py     turns a run's record into one number

``inputs/`` makes the graph, the weights and the request schedule from the
seed; ``reference/`` is the plain PyTorch model the outputs are held to.
Nothing here imports ``jax`` or ``graphsage_tpu``.
"""
