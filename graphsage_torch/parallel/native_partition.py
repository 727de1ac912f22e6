"""ctypes bindings to the native partitioner (``csrc/partitioner.cpp``): the
counterpart of ``graphsage_tpu/parallel/native_partition.py``.

Community-LPA shard assignment and BFS ordering for the halo-exchange plan.
The numpy versions in :mod:`graphsage_torch.parallel.halo` are the
semantics' oracle (the native results are identical, parity-tested); the
native ones replace numpy's O(E log E) lexsort sweeps with per-node counting
passes, seconds instead of minutes at 10^7 edges.

The library is built at first use with ``g++`` into
``build/graphsage_torch/<hash>/`` at the root of the checkout
(:mod:`graphsage_torch._cxx`). When it cannot be built or loaded the callers run numpy;
:data:`build_error` says why, and :data:`last_impl` records which
implementation each of the two functions ran last (``"native"`` or
``"numpy"``), so that a caller can refuse a run that fell back.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from graphsage_torch import _cxx

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "partitioner.cpp"
LIB_NAME = "libgraphsage_partition.so"

_lib: Optional[ctypes.CDLL] = None
build_error: Optional[str] = None
last_impl: dict[str, str] = {}


def library_path() -> Path:
    return _cxx.library_path(SOURCE, LIB_NAME)


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; ``None`` (and
    :data:`build_error` set) when it cannot be built or loaded."""
    global _lib, build_error
    if _lib is not None or build_error is not None:
        return _lib
    try:
        lib = _cxx.load(SOURCE, LIB_NAME)
    except Exception as e:  # no compiler, a failed build, a failed load
        build_error = f"{type(e).__name__}: {e}"
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.gsp_lpa_assign.argtypes = [
        i64p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, i32p,
    ]
    lib.gsp_lpa_assign.restype = ctypes.c_int
    lib.gsp_bfs_order.argtypes = [i64p, i32p, ctypes.c_int64, i32p]
    lib.gsp_bfs_order.restype = ctypes.c_int
    _lib = lib
    return _lib


def _csr_arrays(graph) -> tuple[np.ndarray, np.ndarray]:
    indptr = np.ascontiguousarray(graph.indptr.cpu().numpy(), dtype=np.int64)
    edge_dst = np.ascontiguousarray(graph.edge_dst[: graph.num_edges].cpu().numpy(),
                                    dtype=np.int32)
    return indptr, edge_dst


def lpa_assign_native(graph, num_shards: int, iters: int = 10,
                      slack: float = 1.05) -> Optional[np.ndarray]:
    """Native LPA shard assignment ``[N]`` int64; ``None`` when the library
    is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    indptr, edge_dst = _csr_arrays(graph)
    out = np.empty(graph.num_nodes, dtype=np.int32)
    rc = lib.gsp_lpa_assign(indptr, edge_dst, graph.num_nodes, num_shards, iters, slack, out)
    return out.astype(np.int64) if rc == 0 else None


def bfs_order_native(graph) -> Optional[np.ndarray]:
    """Native BFS order ``[N]`` int64; ``None`` when the library is
    unavailable."""
    lib = load_library()
    if lib is None:
        return None
    indptr, edge_dst = _csr_arrays(graph)
    out = np.empty(graph.num_nodes, dtype=np.int32)
    rc = lib.gsp_bfs_order(indptr, edge_dst, graph.num_nodes, out)
    return out.astype(np.int64) if rc == 0 else None
