"""Nothing the benchmark runs imports JAX or the JAX package, or reads the
JAX package's benchmark files. Module names are compared by their top-level
name whole: ``graphsage_torch`` is not ``graphsage_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

from perfbench.harness.core import FORBIDDEN, forbidden_modules
from perfbench.harness.spec import BENCH_DIR, ROOT

SOURCES = sorted(BENCH_DIR.rglob("*.py"))


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    assert SOURCES
    for path in SOURCES:
        assert not imported(path) & set(FORBIDDEN), path


def test_no_source_names_the_jax_packages_benchmark_files():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for name in ("bench.py", "benchmarks/", "BENCH_r", "BASELINE.", "MULTICHIP_"):
            assert name not in text, (path, name)


def test_the_check_compares_whole_top_level_names():
    sys.modules.setdefault("graphsage_torch", sys.modules.get("graphsage_torch"))
    assert "graphsage_torch" not in forbidden_modules()


def test_a_run_leaves_no_forbidden_module_loaded():
    code = ("import sys; sys.path.insert(0, 'perfbench/tests'); import conftest; "
            "from perfbench.harness import core; "
            "core.execute(conftest.tiny_run('reddit-sampled-serve')); "
            "print(core.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
