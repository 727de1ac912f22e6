"""Fixtures of the benchmark's own tests: cells shrunk to a few thousand
nodes, run on the CPU through the same drivers (the program's plain
versions stand in for its kernels there).

Run them from the root of the checkout: ``python -m pytest perfbench/tests``.
Tests marked ``gpu`` need a CUDA device and skip without one.
"""

from __future__ import annotations

import copy
import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from perfbench.harness import core, spec as specs  # noqa: E402

CELLS = ("reddit-sampled-train", "products-sampled-train", "reddit-sampled-serve",
         "reddit-fullgraph-train")
# A few thousand nodes and 32 features; the layers keep their widths, so
# that rounding reads as it does at the cells' own sizes.
TINY = dict(num_nodes=3000, num_edges=150000, num_edge_slots=300000, num_features=32,
            split={"train": 2300, "val": 200, "test": 500}, batch_size=64)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


# Cells that are built and ran correct on the card but are not in
# BENCHMARK.json (PERF.md, Open questions), by their configuration's name:
# their files are found by name as every cell's are; they report no metric.
PARKED = {"reddit-sampled-train": "reddit", "products-sampled-train": "ogbn-products",
          "reddit-sampled-serve": "reddit"}


def cell_spec(name: str) -> specs.CellSpec:
    """A cell of ``BENCHMARK.json``, or a parked one from its files."""
    return specs.cell_from_files(name, PARKED[name]) if name in PARKED else specs.load_cell(name)


def tiny_spec(name: str) -> specs.CellSpec:
    s = cell_spec(name)
    cfg = copy.deepcopy(s.config)
    cfg.update(copy.deepcopy(TINY))
    s.config = cfg
    s.traffic = dict(s.traffic, rate=40, check_requests=4, warmup_requests=1, warmup_steps=1,
                     limits=dict(s.traffic["limits"]))
    return s


def tiny_run(name: str, seed: int = 2 ** 31 + 5, variant: str = "program", trace: bool = False,
             seconds: float = 0.5, device: str = "cpu") -> core.Run:
    return core.Run(spec=tiny_spec(name), seed=seed, seconds=seconds, trace=trace,
                    device=torch.device(device), t_start=time.perf_counter(), variant=variant)


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
