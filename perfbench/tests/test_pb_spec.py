"""BENCHMARK.json against the benchmark's contract, and every part of
every cell found by name."""

import json
import re

import pytest

from perfbench.harness import spec as specs
from conftest import PARKED, cell_spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((specs.ROOT / "BENCHMARK.json").read_text())
CONFIG_FILES = sorted((specs.BENCH_DIR / "configs").glob("*.json"))


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_entry_keys():
    metric_keys = {"name", "unit", "better", "source"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == metric_keys | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == metric_keys | {"layer", "moves"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_parts_by_name(cell):
    s = cell_spec(cell)
    assert hasattr(s.driver(), "run")
    e2e = {m["name"] for m in s.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and s.per_layer
    for m in s.per_layer:
        assert callable(specs.metric_reader(m["name"]))
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {cell} does not report"
    for m in s.end_to_end:
        assert callable(specs.metric_reader(m["name"]))


@pytest.mark.parametrize("cell", sorted(PARKED))
def test_each_parked_cell_finds_its_files_by_name(cell):
    s = cell_spec(cell)
    assert hasattr(s.driver(), "run") and s.config["name"] == PARKED[cell]


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.stem)
def test_configs_hold_the_published_sizes(path):
    cfg = json.loads(path.read_text())
    assert cfg["name"] == path.stem and cfg["reduced"] == []
    assert cfg["num_edge_slots"] == 2 * cfg["num_edges"]
    assert sum(cfg["split"].values()) == cfg["num_nodes"]
    assert len(cfg["model"]["hidden_dims"]) == len(cfg["model"]["fanouts"])
    for entry in BENCH["configs"]:
        if entry["name"] == cfg["name"]:
            assert entry["file"] == f"perfbench/configs/{path.name}"
            assert entry["reduced"] == cfg["reduced"]


def test_every_per_layer_metric_lists_cells_that_report_what_it_moves():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells)


def test_each_config_has_a_cell_and_a_file():
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    assert {c["file"] for c in BENCH["configs"]} <= {
        f"perfbench/configs/{p.name}" for p in CONFIG_FILES}
    assert set(PARKED.values()) <= {p.stem for p in CONFIG_FILES}
