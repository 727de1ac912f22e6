"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix; the files are ``configs/<config file>``,
``traffic/<traffic>.json``, ``drivers/<kind>.py`` (the traffic file's
``kind``) and ``metrics/<metric>.py``, each loaded from its path, so that a
later cell, kind or metric is a new file and no edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class CellSpec:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # metric entries of BENCHMARK.json that this cell reports
    per_layer: list

    def driver(self):
        kind = self.traffic["kind"]
        return load_module(BENCH_DIR / "drivers" / f"{kind}.py", f"perfbench_driver_{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(record, cell)``."""
    module = load_module(BENCH_DIR / "metrics" / f"{name}.py",
                         "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return module.read


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path | None = None) -> CellSpec:
    bench = load_json(benchmark or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return CellSpec(
        name=name, config=config, traffic=traffic, chips=cell["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def cell_from_files(name: str, config: str) -> CellSpec:
    """A cell that ``BENCHMARK.json`` does not list (a parked one, PERF.md
    §7): ``configs/<config>.json`` and ``traffic/<name>.json`` on one chip,
    reporting no metric."""
    return CellSpec(name=name, config=load_json(BENCH_DIR / "configs" / f"{config}.json"),
                    traffic=load_json(BENCH_DIR / "traffic" / f"{name}.json"), chips=1,
                    end_to_end=[], per_layer=[])
