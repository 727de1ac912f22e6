"""ctypes bindings to the native C++ data plane (``csrc/graph_loader.cpp``):
the counterpart of ``graphsage_tpu/data/native.py``.

Fast-path TSV parsing of the Cora and Pubmed formats, deduplicated CSR
construction, and the lazy loaders' range parsers (the feature rows of
given lines, read by byte offset). The numpy parsers of
:mod:`graphsage_torch.data.loaders` are the semantics' oracle: the native
results are identical, parity-tested.

The library is built at first use with ``g++`` into
``build/graphsage_torch/<hash>/`` at the root of the checkout
(:mod:`graphsage_torch._cxx`). When it cannot be built or loaded,
:func:`load_library` returns ``None`` and :data:`build_error` says why; the
functions below then raise, and the loaders' ``engine="auto"`` runs the
Python parsers instead.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional

import numpy as np

from graphsage_torch import _cxx
from graphsage_torch.data.loaders import RawDataset

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "graph_loader.cpp"
LIB_NAME = "libgraphsage_loader.so"

_lib: Optional[ctypes.CDLL] = None
build_error: Optional[str] = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


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
    for name in ("gsl_parse_cora", "gsl_parse_pubmed"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.gsl_error.restype = ctypes.c_char_p
    lib.gsl_error.argtypes = [ctypes.c_void_p]
    for name in ("gsl_num_nodes", "gsl_num_feats", "gsl_num_classes", "gsl_num_edges"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.gsl_copy_features.argtypes = [ctypes.c_void_p, _F32P]
    lib.gsl_copy_labels.argtypes = [ctypes.c_void_p, _I32P]
    lib.gsl_copy_edges.argtypes = [ctypes.c_void_p, _I64P]
    lib.gsl_free.argtypes = [ctypes.c_void_p]
    lib.gsl_build_csr.restype = ctypes.c_void_p
    lib.gsl_build_csr.argtypes = [ctypes.c_int64, _I64P, ctypes.c_int64, ctypes.c_int]
    lib.gsl_csr_nnz.restype = ctypes.c_int64
    lib.gsl_csr_nnz.argtypes = [ctypes.c_void_p]
    lib.gsl_csr_copy_indptr.argtypes = [ctypes.c_void_p, _I64P]
    lib.gsl_csr_copy_indices.argtypes = [ctypes.c_void_p, _I64P]
    lib.gsl_csr_free.argtypes = [ctypes.c_void_p]
    for name in ("gsl_cora_feature_rows", "gsl_pubmed_feature_rows"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, _F32P]
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def _library() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {build_error}")
    return lib


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def _extract(lib: ctypes.CDLL, handle: int) -> RawDataset:
    try:
        err = lib.gsl_error(handle)
        if err:
            raise RuntimeError(f"native parse error: {err.decode()}")
        n = lib.gsl_num_nodes(handle)
        f = lib.gsl_num_feats(handle)
        e = lib.gsl_num_edges(handle)
        feats = np.empty((n, f), dtype=np.float32)
        labels = np.empty((n,), dtype=np.int32)
        edges = np.empty((e, 2), dtype=np.int64)
        lib.gsl_copy_features(handle, _ptr(feats, _F32P))
        lib.gsl_copy_labels(handle, _ptr(labels, _I32P))
        if e:
            lib.gsl_copy_edges(handle, _ptr(edges, _I64P))
        return RawDataset(feats, labels, edges, int(lib.gsl_num_classes(handle)))
    finally:
        lib.gsl_free(handle)


def parse_cora_native(root: str | os.PathLike) -> RawDataset:
    """:func:`~graphsage_torch.data.loaders.parse_cora` in C++."""
    lib = _library()
    root = os.fspath(root)
    return _extract(lib, lib.gsl_parse_cora(os.path.join(root, "cora.content").encode(),
                                            os.path.join(root, "cora.cites").encode()))


def parse_pubmed_native(root: str | os.PathLike) -> RawDataset:
    """:func:`~graphsage_torch.data.loaders.parse_pubmed` in C++."""
    lib = _library()
    root = os.fspath(root)
    return _extract(lib, lib.gsl_parse_pubmed(
        os.path.join(root, "Pubmed-Diabetes.NODE.paper.tab").encode(),
        os.path.join(root, "Pubmed-Diabetes.DIRECTED.cites.tab").encode()))


def build_csr_native(num_nodes: int, edges: np.ndarray,
                     undirected: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Deduplicated sorted CSR ``(indptr [N + 1], indices)`` int64, built in
    C++: the rows of :func:`~graphsage_torch.data.graph.sorted_unique_edges`."""
    lib = _library()
    edges = np.ascontiguousarray(edges, dtype=np.int64).reshape(-1, 2)
    handle = lib.gsl_build_csr(num_nodes, _ptr(edges, _I64P), len(edges), int(undirected))
    try:
        nnz = lib.gsl_csr_nnz(handle)
        indptr = np.empty(num_nodes + 1, dtype=np.int64)
        indices = np.empty(nnz, dtype=np.int64)
        lib.gsl_csr_copy_indptr(handle, _ptr(indptr, _I64P))
        if nnz:
            lib.gsl_csr_copy_indices(handle, _ptr(indices, _I64P))
        return indptr, indices
    finally:
        lib.gsl_csr_free(handle)


def _feature_rows(fn_name: str, path, offsets, lens, num_feats: int) -> np.ndarray:
    lib = _library()
    offsets = np.ascontiguousarray(offsets, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    out = np.empty((len(offsets), num_feats), np.float32)
    rc = getattr(lib, fn_name)(os.fspath(path).encode(), _ptr(offsets, _I64P),
                               _ptr(lens, _I64P), len(offsets), num_feats, _ptr(out, _F32P))
    if rc:
        raise RuntimeError(f"{fn_name} failed with code {rc} on {path}")
    return out


def cora_feature_rows_native(path, offsets, lens, num_feats: int) -> np.ndarray:
    """The Cora content lines at byte ``offsets`` (lengths ``lens``) parsed
    into ``[n, F]`` f32 feature rows: the lazy loader's native fast path."""
    return _feature_rows("gsl_cora_feature_rows", path, offsets, lens, num_feats)


def pubmed_feature_rows_native(path, offsets, lens, num_feats: int) -> np.ndarray:
    """The Pubmed NODE.tab lines at byte ``offsets`` parsed into ``[n, F]``
    f32 rows (Q15: word=value pairs through the header's word map, the
    summary field skipped): the lazy loader's native fast path."""
    return _feature_rows("gsl_pubmed_feature_rows", path, offsets, lens, num_feats)
