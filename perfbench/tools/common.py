"""What the tools share: a cell's spec with a run's arguments, outside
``run.py`` (no result line, no check for the card)."""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from perfbench.harness import core, spec as specs  # noqa: E402


def make_run(workload: str, seed: int, seconds: float, variant: str = "program",
             device: str = "cuda", config: str | None = None) -> core.Run:
    """``config`` names the configuration of a parked cell, one that
    ``BENCHMARK.json`` does not list."""
    spec = specs.cell_from_files(workload, config) if config else specs.load_cell(workload)
    return core.Run(spec=spec, seed=seed, seconds=seconds, trace=False,
                    device=torch.device(device), t_start=time.perf_counter(), variant=variant)
