"""One run of one cell: check for the card, run the cell's driver, read
its metrics, check what the process imported, print the result line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit.
The same numbers are the last lines of standard error.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

from perfbench.harness import spec as specs
from perfbench.harness.record import Record, profile_stretches, sync

FORBIDDEN = ("jax", "jaxlib", "flax", "graphsage_tpu")
# A metric reader of a device number reads no CPU run.
DEVICE_SOURCES = ("device_trace",)


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell, the run's arguments and its record.
    ``variant`` is ``"program"`` in every benchmark run; the calibration
    and the tests set ``"control"`` (the reference in the next lower
    precision in the program's place) or ``"fault:<name>"``
    (``harness/faults.py``)."""

    spec: specs.CellSpec
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    rec: Record = dataclasses.field(default_factory=Record)
    variant: str = "program"

    @property
    def config(self) -> dict:
        return self.spec.config

    @property
    def traffic(self) -> dict:
        return self.spec.traffic

    def span(self, name: str):
        """A host span around a call into a layer, recorded only in a
        ``--trace 1`` run (a run with ``--trace 0`` carries no wrappers)."""
        return self.rec.span(name) if self.trace else contextlib.nullcontext()

    def mark(self, phase: str) -> None:
        """Note the set-up's progress: seconds since the process started."""
        self.rec.values.setdefault("phases", {})[phase] = time.perf_counter() - self.t_start

    def setup_done(self) -> None:
        sync(self.device)
        self.rec.values["setup_s"] = time.perf_counter() - self.t_start

    def profile_after_window(self, work, length: int, span_names: tuple) -> None:
        """With ``--trace 1``, the profiled stretches: ``work(length)`` after
        the window (:func:`~perfbench.harness.record.profile_stretches`)."""
        if self.trace:
            profile_stretches(self.rec, self.device, work, length, span_names)


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    checks: dict  # name -> (value, limit)

    @property
    def correct(self) -> bool:
        return all(math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def device_info(run: Run) -> dict:
    dev = run.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "count": run.spec.chips,
            "memory_peak_bytes": int(run.rec.values.get("memory_peak_bytes", 0))}
    if run.trace and run.rec.device is not None:
        info["busy_s"] = run.rec.device["busy_s"]
        info["window_s"] = run.rec.device["window_s"]
    return info


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def read_metrics(run: Run) -> dict:
    entries = run.spec.per_layer if run.trace else run.spec.end_to_end
    out = {}
    for m in entries:
        if m["source"] in DEVICE_SOURCES and run.device.type != "cuda":
            continue
        value = specs.metric_reader(m["name"])(run.rec, run.spec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def result_line(run: Run, outcome: Outcome) -> dict:
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": read_metrics(run),
            "device": device_info(run)}
    if run.trace and run.rec.trace is not None:
        line["breakdown"] = {k: [[n, s] for n, s in run.rec.trace[k]]
                             for k in ("device_ops", "idle_gaps")}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return line


def execute(run: Run) -> tuple[Outcome, dict]:
    """Drive the cell and build its result line (no printing)."""
    driver = run.spec.driver()
    import graphsage_torch  # noqa: F401  (the program's import counts in set-up)

    run.mark("imports")
    outcome = driver.run(run)
    return outcome, result_line(run, outcome)


def main(workload: str, seed: int, seconds: float, trace: bool, t_start: float) -> int:
    spec = specs.load_cell(workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"perfbench: {workload} needs {spec.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = Run(spec=spec, seed=seed, seconds=seconds, trace=trace,
              device=torch.device("cuda", 0), t_start=t_start)
    outcome, line = execute(run)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process imported {found}", file=sys.stderr)
        return 3
    if trace and (run.rec.trace is None or run.rec.device is None):
        print("perfbench: the profiler recorded no device activity", file=sys.stderr)
        return 4
    print(f"card: {power_line()}", file=sys.stderr)
    print(f"setup_s {run.rec.values.get('setup_s')!r} build_graph_s "
          f"{run.rec.values.get('build_graph_s')!r} phases "
          f"{json.dumps(run.rec.values.get('phases', {}))}", file=sys.stderr)
    for name, (value, limit) in outcome.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
