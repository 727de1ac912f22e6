"""The port stands alone: ``graphsage_torch`` and ``chip_smoke.py`` import
nothing of JAX, Flax, Optax or ``graphsage_tpu``, and ``chip_smoke.py``
fails, printing no result, without a card or without the rest of the repo."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "graphsage_tpu")
PORT_FILES = sorted((REPO / "graphsage_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
OK_LINE = '"ok": true'


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_blocked_import_in_source(path):
    assert not _imported_roots(path) & set(BLOCKED)


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


@pytest.mark.parametrize("module", ["parallel/halo.py", "parallel/native_partition.py",
                                    "data/native.py", "data/loaders.py", "_cxx.py",
                                    *(f"examples/{p.name}" for p in sorted(
                                        (REPO / "graphsage_torch" / "examples").glob("0*.py")))])
def test_halo_modules_are_checked_and_stand_alone(module):
    path = REPO / "graphsage_torch" / module
    assert path in PORT_FILES
    assert not _imported_roots(path) & set(BLOCKED)


def test_partitioner_source_is_the_ports_own_copy():
    """The native partitioner builds the port's copy of the C++ source into
    ``build/`` with ``g++``; it never runs the JAX package's ``make``."""
    from graphsage_torch.parallel import native_partition

    source = REPO / "graphsage_torch" / "csrc" / "partitioner.cpp"
    assert native_partition.SOURCE == source
    assert source.read_bytes() == (REPO / "graphsage_tpu" / "csrc" / "partitioner.cpp").read_bytes()
    assert REPO / "build" / "graphsage_torch" in native_partition.library_path().parents
    text = (REPO / "graphsage_torch" / "parallel" / "native_partition.py").read_text()
    assert '"make"' not in text and "graphsage_tpu/csrc" not in text


def test_loader_source_is_the_ports_own_copy():
    """The native loader builds the port's copy of the C++ source (its code
    the JAX package's, its header naming the port's bindings) into
    ``build/`` with ``g++``."""
    from graphsage_torch.data import native

    source = REPO / "graphsage_torch" / "csrc" / "graph_loader.cpp"
    assert native.SOURCE == source
    ours, theirs = source.read_text(), (REPO / "graphsage_tpu" / "csrc" /
                                        "graph_loader.cpp").read_text()
    assert ours[ours.index("#include"):] == theirs[theirs.index("#include"):]
    assert "graphsage_tpu" not in ours
    assert REPO / "build" / "graphsage_torch" in native.library_path().parents


@pytest.mark.parametrize("path", sorted(
    p for p in (REPO / "graphsage_torch").rglob("*")
    if p.suffix in (".py", ".cpp", ".cu", ".cuh")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_source_names_the_jax_csrc(path):
    assert "graphsage_tpu/csrc" not in path.read_text()


def test_examples_are_ported_one_for_one():
    jax_names = sorted(p.name for p in (REPO / "examples").glob("0*.py"))
    ours = sorted(p.name for p in (REPO / "graphsage_torch" / "examples").glob("0*.py"))
    assert len(jax_names) == 8 and ours == jax_names


def test_port_imports_with_jax_blocked():
    code = f"""
import importlib, pkgutil, sys
BLOCKED = {BLOCKED!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import graphsage_torch
for mod in pkgutil.walk_packages(graphsage_torch.__path__, "graphsage_torch."):
    importlib.import_module(mod.name)
import chip_smoke
loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("imported", len([n for n in sys.modules if n.startswith("graphsage_torch")]))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert OK_LINE not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert OK_LINE not in res.stdout


def _jax_top_level_names() -> list[str]:
    """``graphsage_tpu/__init__.py``'s ``__all__``, read without importing
    the package (and so JAX)."""
    tree = ast.parse((REPO / "graphsage_tpu" / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("graphsage_tpu/__init__.py has no __all__")


def _port_defined_names() -> set[str]:
    """Every top-level function, class or assigned name in the port's
    modules."""
    names = set()
    for path in (REPO / "graphsage_torch").rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return names


def test_top_level_exports_every_ported_name_of_the_jax_package():
    import graphsage_torch

    jax_names = _jax_top_level_names()
    ported = [n for n in jax_names if n in _port_defined_names()]
    # The names this slice and the earlier ones brought (a floor, so that
    # the check cannot pass by finding nothing).
    assert {"with_cached_layer0", "run_cora", "run_pubmed", "quantize_graph",
            "load_cora_lazy", "load_pubmed_lazy", "shard_features_from_loader",
            "QuantizedTable", "quantize_features", "dequantize", "FullGraphTrainer",
            "disjoint_union", "Trainer", "GraphSAGE", "UnsupervisedTrainer",
            "induced_subgraph", "build_node_partition", "locality_relabel",
            "relabel_graph"} <= set(ported)
    missing = [n for n in ported if not hasattr(graphsage_torch, n)]
    assert not missing, missing
    assert set(ported) <= set(graphsage_torch.__all__)
