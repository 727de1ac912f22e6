"""Build and load the port's host C++ libraries (``csrc/*.cpp``).

Each library is one source compiled at first use with ``g++ -O3 -std=c++17
-fPIC -shared`` into ``build/graphsage_torch/<hash>/`` at the root of the
checkout, keyed by a hash of the flags and the source (as
:mod:`graphsage_torch.ops._build` keys the CUDA kernels): an edited source
rebuilds and an unchanged one is reused, so a built library is never stale.
The callers (:mod:`graphsage_torch.data.native`,
:mod:`graphsage_torch.parallel.native_partition`) declare the entry points'
argument types and decide what a failed build means.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "graphsage_torch"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]


def library_path(source: Path, lib_name: str) -> Path:
    """Where ``source`` builds to: ``BUILD_ROOT/<hash of flags and
    source>/lib_name``."""
    digest = hashlib.sha256(" ".join(FLAGS).encode() + source.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / lib_name


def _build(source: Path, lib: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    lib.parent.mkdir(parents=True, exist_ok=True)
    # Build privately and move into place: concurrent builders never load a
    # half-written library.
    tmp = Path(tempfile.mkdtemp(dir=lib.parent))
    try:
        res = subprocess.run([cxx, *FLAGS, "-o", str(tmp / lib.name), str(source)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode:
            raise RuntimeError(f"{cxx} failed (rc {res.returncode}):\n{res.stderr}")
        os.replace(tmp / lib.name, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load(source: Path, lib_name: str) -> ctypes.CDLL:
    """The library built from ``source`` (compiled first if this version is
    not built yet); raises when it cannot be built or loaded."""
    path = library_path(source, lib_name)
    if not path.exists():
        _build(source, path)
    return ctypes.CDLL(str(path))
