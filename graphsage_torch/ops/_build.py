"""Build and load the port's CUDA kernels (``graphsage_torch/csrc/*.cu``).

At first use every source is compiled with ``nvcc`` for ``sm_90a``, one
process per source, all started together (``rows.cuh``, included by four of
them, holds the row loads they share; ``merge_path.cuh`` the CSR walk of the
mean and max kernels), and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The library
lives under ``build/graphsage_torch/<hash>/`` at the root of the checkout,
keyed by a hash of the sources and flags, so an edited kernel rebuilds and an
unchanged one is reused. ``build.log`` beside it keeps the compiler's output,
including ``ptxas``'s register and spill counts.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; the wrappers raise when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from graphsage_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "graphsage_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libgraphsage_torch_kernels.so"

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argument types (pointers and the stream as c_void_p, sizes as c_int)
SIGNATURES = {
    "gsage_gather_mean_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gsage_gather_mean_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gsage_gather_mean_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gsage_spmm_mean_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "gsage_spmm_mean_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "gsage_scatter_mean_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gsage_gather_mean_dma_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "gsage_gather_mean_dma_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "gsage_segment_max_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gsage_segment_max_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gsage_segment_max_backward_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _P],
    "gsage_segment_max_backward_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _P],
    "gsage_segment_max_full_cols_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gsage_segment_max_full_cols_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of graphsage_torch are built from source at first use"
    )


def build() -> Path:
    """Compile the kernels if this version of the sources is not built yet;
    return the path of the shared library."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their header
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    profiling.count("kernels.builds", 1)
    # Build in a private directory and move the result into place, so that
    # processes building at the same time never load a half-written library.
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        procs = [
            (src, subprocess.Popen(
                [nvcc, *FLAGS, "-c", str(src), "-o", str(tmp / f"{src.stem}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for src in sources
        ]
        log, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== nvcc {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", *ARCH, "-o", str(tmp / LIB_NAME),
                 *(str(tmp / f"{src.stem}.o") for src in sources)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            log.append(f"== link (rc {link.returncode})\n{link.stdout}")
            if link.returncode:
                failed.append("link")
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(
                f"building the CUDA kernels failed at {failed}:\n" + "\n".join(log)
            )
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_log() -> str:
    """The compiler output of the current build (empty before one exists)."""
    path = build().parent / "build.log"
    return path.read_text() if path.exists() else ""


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; the span
    ``kernels.load``, with a count of ``kernels.builds`` when ``nvcc`` ran)."""
    with profiling.phase("kernels.load"):
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
