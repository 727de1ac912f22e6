"""The plain PyTorch reference the benchmark holds the program's outputs to.

It imports neither ``jax`` nor ``graphsage_tpu`` nor anything of
``graphsage_torch``, and takes nothing the program made: its inputs are the
benchmark's own (``perfbench/inputs``), and the program's outputs reach it
only to be judged (a sampled frontier is first checked against the
benchmark's edge list).
"""
