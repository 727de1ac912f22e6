"""Dataset loaders for the original Cora / Pubmed file formats: the
counterpart of ``graphsage_tpu/data/loaders.py``.

Parsing semantics are pinned to the reference so that features, labels and
edge sets come out identical to the JAX package's:

* Cora: ``cora.content`` rows are ``<paper_id> <feats...> <label>``; node
  index = file line order; label ids by first appearance in file order
  (quirk Q14); ``cora.cites`` rows become *undirected* edges.
* Pubmed (quirk Q15): 2 header lines; the second maps feature names to
  columns via the token between the first and second ``:`` of each entry,
  shifted left by one; node rows are ``<id> label=<1..3> <word=value ...>
  summary=...`` — label stored as 0..2, the trailing summary field skipped;
  the DIRECTED.cites file's direction is discarded.

``engine=`` picks the parser: these Python ones (the semantics' oracle) or
the C++ ones of :mod:`graphsage_torch.data.native`. :func:`load_cora_lazy`
and :func:`load_pubmed_lazy` parse the labels and edges only, and read
feature rows on demand.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from graphsage_torch.data.graph import Graph, build_graph


class RawDataset(NamedTuple):
    """Host-side parse result, before padding/device placement."""

    features: np.ndarray  # [N, F] float32
    labels: np.ndarray  # [N] int32
    edges: np.ndarray  # [E, 2] int64 (directed as read; build_graph mirrors)
    num_classes: int


def _labels_by_first_appearance(names: list[str]) -> tuple[np.ndarray, int]:
    """Q14: label ids by first appearance in file order. One implementation,
    shared by the eager and the lazy Cora parsers."""
    label_map: dict[str, int] = {}
    labels = np.empty(len(names), dtype=np.int32)
    for i, name in enumerate(names):
        labels[i] = label_map.setdefault(name, len(label_map))
    return labels, len(label_map)


def _cora_cites_edges(cites_path: str, node_map: dict[str, int]) -> np.ndarray:
    edge_list: list[tuple[int, int]] = []
    with open(cites_path) as f:
        for line in f:
            fields = line.split()
            if len(fields) < 2:
                continue
            edge_list.append((node_map[fields[0]], node_map[fields[1]]))
    return np.array(edge_list, dtype=np.int64).reshape(-1, 2)


def _pubmed_cites_edges(cite_path: str, node_map: dict[str, int]) -> np.ndarray:
    edge_list: list[tuple[int, int]] = []
    with open(cite_path) as f:
        f.readline()
        f.readline()
        for line in f:
            fields = line.strip().split("\t")
            if len(fields) < 2:
                continue
            edge_list.append((node_map[fields[1].split(":")[1]],
                              node_map[fields[-1].split(":")[1]]))
    return np.array(edge_list, dtype=np.int64).reshape(-1, 2)


def parse_cora(root: str | os.PathLike) -> RawDataset:
    """Parse cora.content / cora.cites from ``root``."""
    root = os.fspath(root)
    node_ids: list[str] = []
    label_names: list[str] = []
    feat_rows: list[np.ndarray] = []
    with open(os.path.join(root, "cora.content")) as f:
        for line in f:
            fields = line.split()
            if not fields:
                continue
            node_ids.append(fields[0])
            feat_rows.append(np.array(fields[1:-1], dtype=np.float32))
            label_names.append(fields[-1])

    features = np.stack(feat_rows)
    labels, num_classes = _labels_by_first_appearance(label_names)
    node_map = {nid: i for i, nid in enumerate(node_ids)}
    edges = _cora_cites_edges(os.path.join(root, "cora.cites"), node_map)
    return RawDataset(features, labels, edges, num_classes)


def parse_pubmed(root: str | os.PathLike) -> RawDataset:
    """Parse the Pubmed-Diabetes TSV pair from ``root`` (Q15 semantics)."""
    root = os.fspath(root)
    with open(os.path.join(root, "Pubmed-Diabetes.NODE.paper.tab")) as f:
        f.readline()  # banner line
        header = f.readline().rstrip("\n").split("\t")
        # Entry j like "numeric:w-word:0.0" names the feature stored at column
        # j-1 (entry 0 is the label field and lands at a throwaway index).
        feat_col = {entry.split(":")[1]: j - 1 for j, entry in enumerate(header)}
        body = f.read().splitlines()

    num_nodes = len(body)
    num_feats = len(feat_col) - 1  # minus the label pseudo-entry
    features = np.zeros((num_nodes, num_feats), dtype=np.float32)
    labels = np.empty(num_nodes, dtype=np.int32)
    node_map: dict[str, int] = {}
    for i, line in enumerate(body):
        fields = line.split("\t")
        node_map[fields[0]] = i
        labels[i] = int(fields[1].split("=")[1]) - 1  # 1..3 -> 0..2
        # fields[2:-1]: word=value pairs; the final field is the summary.
        for tok in fields[2:-1]:
            name, _, val = tok.partition("=")
            features[i, feat_col[name]] = float(val)

    edges = _pubmed_cites_edges(
        os.path.join(root, "Pubmed-Diabetes.DIRECTED.cites.tab"), node_map
    )
    return RawDataset(features, labels, edges, int(labels.max()) + 1)


def _parse(name: str, root, engine: str) -> RawDataset:
    """The Python or the native C++ parser of ``name`` (the same results,
    parity-tested). ``"auto"`` runs the native one when its library builds
    and loads, else the Python one; ``"native"`` raises when it does not."""
    if engine not in ("auto", "python", "native"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "python":
        return {"cora": parse_cora, "pubmed": parse_pubmed}[name](root)
    from graphsage_torch.data import native

    if engine == "auto" and not native.available():
        return {"cora": parse_cora, "pubmed": parse_pubmed}[name](root)
    return {"cora": native.parse_cora_native, "pubmed": native.parse_pubmed_native}[name](root)


def load_cora(
    root: str | os.PathLike = "cora", engine: str = "auto", device=None, **build_kwargs
) -> Graph:
    """Load Cora into a :class:`Graph` on ``device`` (``cuda`` by default).
    ``engine``: ``"auto"`` (the native parser when it builds, else Python),
    ``"python"`` or ``"native"`` (raises when the library does not build)."""
    raw = _parse("cora", root, engine)
    return build_graph(
        raw.features, raw.labels, raw.edges, num_classes=raw.num_classes,
        undirected=True, device=device, **build_kwargs,
    )


def load_pubmed(
    root: str | os.PathLike = "pubmed-data", engine: str = "auto", device=None,
    **build_kwargs
) -> Graph:
    """Load Pubmed into a :class:`Graph` on ``device`` (``cuda`` by default);
    ``engine`` as in :func:`load_cora`."""
    raw = _parse("pubmed", root, engine)
    return build_graph(
        raw.features, raw.labels, raw.edges, num_classes=raw.num_classes,
        undirected=True, device=device, **build_kwargs,
    )


def _lazy_graph(num_nodes, num_feats, labels, edges, num_classes, **build_kwargs) -> Graph:
    """A CPU graph whose feature leaf is a zero-strided descriptor: shape and
    dtype at ``O(F)`` bytes, never a real table (:func:`build_graph` builds
    it in ``feature_dtype``). Its consumers go through the row loader; every
    path that would read the table refuses it
    (:func:`~graphsage_torch.data.graph.reject_lazy_descriptor`)."""
    build_kwargs.setdefault("device", "cpu")
    if torch.device(build_kwargs["device"]).type != "cpu":
        raise ValueError("lazy loading requires device='cpu'")
    features = np.broadcast_to(np.zeros((1, num_feats), np.float32), (num_nodes, num_feats))
    return build_graph(features, labels, edges, num_classes=num_classes, undirected=True,
                       **build_kwargs)


def _use_native_rows(engine: str) -> bool:
    """Whether the lazy row loader parses in C++: never for ``"python"``;
    for ``"auto"`` when the library builds; ``"native"`` raises when it
    does not."""
    if engine not in ("auto", "python", "native"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "python":
        return False
    from graphsage_torch.data import native

    if engine == "native" and not native.available():
        raise RuntimeError(f"native loader unavailable: {native.build_error}")
    return native.available()


def _line_lengths(offsets: list[int], path: str) -> tuple[np.ndarray, np.ndarray]:
    offsets_arr = np.asarray(offsets, np.int64)
    return offsets_arr, np.append(offsets_arr[1:], os.path.getsize(path)) - offsets_arr


def load_cora_lazy(
    root: str | os.PathLike = "cora", engine: str = "auto", **build_kwargs
) -> tuple[Graph, Callable[[int, int], np.ndarray]]:
    """Cora with its feature rows read on demand: ``(graph, row_loader)``.

    The index pass reads each content line's id and label (the Q14 label
    map) and records its byte offset, not its feature columns: adjacency,
    labels and CSR equal :func:`load_cora`'s, but no ``[N, F]`` array is
    built. The graph lies on the CPU (``device="cpu"``, the JAX package's
    ``placement="host"``; another device raises) and its feature leaf is a
    zero-strided descriptor. ``row_loader(lo, hi)`` re-reads exactly those
    lines into ``[hi - lo, F]`` f32 rows (natively where ``engine`` allows,
    as :func:`load_cora`). Feed both to
    :func:`~graphsage_torch.parallel.feature_store.shard_features_from_loader`
    and the sharded trainers' ``feature_store=``: each rank then parses only
    its own ``N/S`` feature rows.
    """
    root = os.fspath(root)
    content_path = os.path.join(root, "cora.content")
    node_ids: list[str] = []
    label_names: list[str] = []
    offsets: list[int] = []
    num_feats = None
    with open(content_path, "rb") as f:
        off = f.tell()
        for line in iter(f.readline, b""):
            stripped = line.strip()
            if stripped:
                # The id (first token) and the label (last) only: splitting
                # every line's F columns would cost most of an eager parse.
                node_ids.append(stripped.split(None, 1)[0].decode())
                label_names.append(stripped.rsplit(None, 1)[-1].decode())
                offsets.append(off)
                if num_feats is None:
                    num_feats = len(stripped.split()) - 2
            off = f.tell()
    labels, num_classes = _labels_by_first_appearance(label_names)
    node_map = {nid: i for i, nid in enumerate(node_ids)}
    edges = _cora_cites_edges(os.path.join(root, "cora.cites"), node_map)
    offsets_arr, lens_arr = _line_lengths(offsets, content_path)
    native_rows = _use_native_rows(engine)

    def row_loader(lo: int, hi: int) -> np.ndarray:
        if native_rows:
            from graphsage_torch.data.native import cora_feature_rows_native

            return cora_feature_rows_native(content_path, offsets_arr[lo:hi],
                                            lens_arr[lo:hi], num_feats)
        out = np.empty((hi - lo, num_feats), np.float32)
        with open(content_path, "rb") as f:
            for j, off in enumerate(offsets_arr[lo:hi]):
                f.seek(int(off))
                out[j] = np.array(f.readline().split()[1:-1], dtype=np.float32)
        return out

    graph = _lazy_graph(len(node_ids), num_feats, labels, edges, num_classes, **build_kwargs)
    return graph, row_loader


def load_pubmed_lazy(
    root: str | os.PathLike = "pubmed-data", engine: str = "auto", **build_kwargs
) -> tuple[Graph, Callable[[int, int], np.ndarray]]:
    """Pubmed with its feature rows read on demand: the contract of
    :func:`load_cora_lazy`, with the Q15 rules (the header's word map shifted
    by one, ``label=<n>`` - 1, the summary field skipped) applied per row
    when it is read."""
    root = os.fspath(root)
    node_path = os.path.join(root, "Pubmed-Diabetes.NODE.paper.tab")
    offsets: list[int] = []
    labels_list: list[int] = []
    node_map: dict[str, int] = {}
    with open(node_path, "rb") as f:
        f.readline()  # banner
        # \r\n, not just \n: a CRLF file would otherwise leave \r on the last
        # header word, and every lookup of it would fail (the eager text-mode
        # parser and the native one both strip it).
        header = f.readline().decode().rstrip("\r\n").split("\t")
        feat_col = {e.split(":")[1]: j - 1 for j, e in enumerate(header)}
        off = f.tell()
        for line in iter(f.readline, b""):
            if line.strip():
                fields = line.decode().split("\t", 2)  # the id and the label only
                node_map[fields[0]] = len(offsets)
                labels_list.append(int(fields[1].split("=")[1]) - 1)
                offsets.append(off)
            off = f.tell()
    num_feats = len(feat_col) - 1  # minus the label pseudo-entry
    labels = np.asarray(labels_list, np.int32)
    edges = _pubmed_cites_edges(os.path.join(root, "Pubmed-Diabetes.DIRECTED.cites.tab"),
                                node_map)
    offsets_arr, lens_arr = _line_lengths(offsets, node_path)
    native_rows = _use_native_rows(engine)

    def row_loader(lo: int, hi: int) -> np.ndarray:
        if native_rows:
            from graphsage_torch.data.native import pubmed_feature_rows_native

            return pubmed_feature_rows_native(node_path, offsets_arr[lo:hi],
                                              lens_arr[lo:hi], num_feats)
        out = np.zeros((hi - lo, num_feats), np.float32)
        with open(node_path, "rb") as f:
            for j, off in enumerate(offsets_arr[lo:hi]):
                f.seek(int(off))
                for tok in f.readline().decode().split("\t")[2:-1]:  # last: the summary
                    name, _, val = tok.partition("=")
                    out[j, feat_col[name]] = float(val)
        return out

    graph = _lazy_graph(len(offsets), num_feats, labels, edges, int(labels.max()) + 1,
                        **build_kwargs)
    return graph, row_loader
