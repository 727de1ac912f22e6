"""Profiling and throughput accounting: the counterpart of
``graphsage_tpu/utils/profiling.py``.

The reference's only instrumentation is ``time.time()`` around each step
(reference model.py:94-101). Here: a ``torch.profiler`` trace context that
exports a Chrome trace, a step timer whose barrier waits for the device
(PyTorch returns before a CUDA step finishes), and the edges/s accounting
of the JAX package, with its formulas.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (host ops, and the card's kernels when a
    card is there) and write ``log_dir/trace.json``, a Chrome trace
    (``chrome://tracing`` or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock step timing; ``stop(value)`` first waits for ``value``:
    ``torch.cuda.synchronize()`` for a tensor on the card, reading it for
    one on the CPU."""

    def __init__(self) -> None:
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        pass

    def stop(self, barrier_value=None) -> float:
        """End the current measurement; pass the step's result to wait for
        it."""
        if isinstance(barrier_value, torch.Tensor):
            if barrier_value.is_cuda:
                torch.cuda.synchronize(barrier_value.device)
            else:
                barrier_value.cpu().numpy()
        elif barrier_value is not None:
            np.asarray(barrier_value)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        # The first entry usually includes the kernels' build; report steady state.
        steady = self.times[1:] if len(self.times) > 1 else self.times
        return float(np.mean(steady)) if steady else 0.0


def edges_per_second(edges_per_step: int, sec_per_step: float) -> float:
    return edges_per_step / sec_per_step if sec_per_step > 0 else 0.0


def scaling_efficiency(single_chip_eps: float, n_chip_eps: float, n: int) -> float:
    """edges/s scaling efficiency from 1 device to n devices."""
    if single_chip_eps <= 0 or n <= 0:
        return 0.0
    return n_chip_eps / (n * single_chip_eps)
