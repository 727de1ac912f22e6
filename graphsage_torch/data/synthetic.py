"""Synthetic dataset generators: the counterpart of
``graphsage_tpu/data/synthetic.py``.

Format-identical stand-ins for Cora and Pubmed with class-correlated
features and homophilous edges, :func:`power_law_graph`, a graph with
heavy-tailed degrees, and :func:`synthetic_ppi_graphs`, a family of
multi-label graphs. From the same seed they give the same arrays as the
JAX package's generators (the numpy draws are made in the same order).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from graphsage_torch.data.graph import Graph, build_graph

_CORA_CLASSES = (
    "Case_Based",
    "Genetic_Algorithms",
    "Neural_Networks",
    "Probabilistic_Methods",
    "Reinforcement_Learning",
    "Rule_Learning",
    "Theory",
)


def _homophilous_edges(
    rng: np.random.Generator,
    labels: np.ndarray,
    num_edges: int,
    same_class_prob: float = 0.8,
) -> np.ndarray:
    """Undirected edge set where most edges connect same-class nodes.

    Every node receives at least one edge first (real Cora/Pubmed have no
    zero-degree nodes in their cite files).
    """
    n = len(labels)
    by_class = [np.flatnonzero(labels == c) for c in range(int(labels.max()) + 1)]
    edges: set[tuple[int, int]] = set()
    for a in range(n):
        peers = by_class[labels[a]]
        b = int(peers[rng.integers(len(peers))])
        if a != b:
            edges.add((min(a, b), max(a, b)))
    while len(edges) < num_edges:
        a = int(rng.integers(n))
        if rng.random() < same_class_prob:
            peers = by_class[labels[a]]
            b = int(peers[rng.integers(len(peers))])
        else:
            b = int(rng.integers(n))
        if a != b:
            edges.add((min(a, b), max(a, b)))
    return np.array(sorted(edges), dtype=np.int64)


def synthetic_cora_graph(
    num_nodes: int = 2708,
    num_feats: int = 1433,
    num_edges: int = 5429,
    num_classes: int = 7,
    seed: int = 0,
    device=None,
) -> Graph:
    """In-memory Cora-like graph: binary bag-of-words block features and
    homophilous edges."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    block_w = max(num_feats // (num_classes * 5), 1)
    features = np.zeros((num_nodes, num_feats), dtype=np.float32)
    for i in range(num_nodes):
        lo = int(labels[i]) * block_w
        features[i, rng.choice(np.arange(lo, lo + block_w), size=min(12, block_w), replace=False)] = 1.0
        features[i, rng.choice(num_feats, size=8, replace=False)] = 1.0
    edges = _homophilous_edges(rng, labels, num_edges)
    return build_graph(features, labels, edges, num_classes=num_classes,
                       undirected=True, device=device)


def synthetic_pubmed_graph(
    num_nodes: int = 19717,
    num_feats: int = 500,
    num_edges: int = 44338,
    num_classes: int = 3,
    seed: int = 0,
    device=None,
) -> Graph:
    """In-memory Pubmed-like graph: sparse nonnegative TF-IDF-scale block
    features and homophilous edges."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    block_w = max(num_feats // (num_classes * 3), 1)
    features = np.zeros((num_nodes, num_feats), dtype=np.float32)
    for c in range(num_classes):
        rows = np.flatnonzero(labels == c)
        lo = c * block_w
        for i in rows:
            idx = rng.choice(np.arange(lo, lo + block_w), size=min(10, block_w), replace=False)
            features[i, idx] = rng.uniform(0.05, 0.5, size=len(idx)).astype(np.float32)
            noise = rng.choice(num_feats, size=5, replace=False)
            features[i, noise] = rng.uniform(0.01, 0.1, size=5).astype(np.float32)
    edges = _homophilous_edges(rng, labels, num_edges)
    return build_graph(features, labels, edges, num_classes=num_classes,
                       undirected=True, device=device)


def synth_cora_files(
    root: str | os.PathLike,
    num_nodes: int = 2708,
    num_feats: int = 1433,
    num_edges: int = 5429,
    seed: int = 0,
) -> str:
    """Write a synthetic dataset in the exact cora.content/cora.cites format."""
    root = os.fspath(root)
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_classes = len(_CORA_CLASSES)
    labels = rng.integers(0, n_classes, num_nodes)
    block_w = num_feats // (n_classes * 5)  # class-specific active word block

    with open(os.path.join(root, "cora.content"), "w") as f:
        for i in range(num_nodes):
            feats = np.zeros(num_feats, dtype=np.int64)
            lo = int(labels[i]) * block_w
            feats[rng.choice(np.arange(lo, lo + block_w), size=min(12, block_w), replace=False)] = 1
            feats[rng.choice(num_feats, size=8, replace=False)] = 1
            row = "\t".join(str(v) for v in feats)
            f.write(f"{100000 + i}\t{row}\t{_CORA_CLASSES[labels[i]]}\n")

    edges = _homophilous_edges(rng, labels, num_edges)
    with open(os.path.join(root, "cora.cites"), "w") as f:
        for a, b in edges:
            f.write(f"{100000 + a}\t{100000 + b}\n")
    return root


def synth_pubmed_files(
    root: str | os.PathLike,
    num_nodes: int = 19717,
    num_feats: int = 500,
    num_edges: int = 44338,
    seed: int = 0,
) -> str:
    """Write a synthetic dataset in the Pubmed-Diabetes TSV format (Q15)."""
    root = os.fspath(root)
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, num_nodes)
    words = [f"w-term{j}" for j in range(num_feats)]
    block_w = num_feats // 9

    node_path = os.path.join(root, "Pubmed-Diabetes.NODE.paper.tab")
    with open(node_path, "w") as f:
        f.write(f"{num_nodes}\t{num_feats}\n")
        header = ["cat:label:"] + [f"numeric:{w}:0.0" for w in words]
        f.write("\t".join(header) + "\n")
        for i in range(num_nodes):
            lo = int(labels[i]) * block_w
            idx = rng.choice(np.arange(lo, lo + block_w), size=min(10, block_w), replace=False)
            noise = rng.choice(num_feats, size=5, replace=False)
            vals = {int(j): round(float(rng.uniform(0.05, 0.5)), 4) for j in idx}
            for j in noise:
                vals.setdefault(int(j), round(float(rng.uniform(0.01, 0.1)), 4))
            toks = [f"{words[j]}={v}" for j, v in sorted(vals.items())]
            f.write(
                f"{200000 + i}\tlabel={labels[i] + 1}\t" + "\t".join(toks)
                + f"\tsummary=node{i}\n"
            )

    edges = _homophilous_edges(rng, labels, num_edges)
    cite_path = os.path.join(root, "Pubmed-Diabetes.DIRECTED.cites.tab")
    with open(cite_path, "w") as f:
        f.write(f"{len(edges)}\n")
        f.write("NO\tsource\t|\ttarget\n")
        for k, (a, b) in enumerate(edges):
            f.write(f"{k}\tpaper:{200000 + a}\t|\tpaper:{200000 + b}\n")
    return root


def power_law_graph(
    num_nodes: int,
    num_edges: int,
    num_feats: int = 128,
    num_classes: int = 16,
    seed: int = 0,
    max_degree: int | None = None,
    feature_dtype: torch.dtype = torch.float32,
    homophily: float = 0.0,
    device=None,
) -> Graph:
    """In-memory synthetic graph with heavy-tailed degrees: edge sources are
    drawn from a Zipf-like node distribution (hubs spread over a random
    permutation), destinations uniformly.

    ``homophily`` redraws that fraction of edge destinations from the
    source's class; with 0 (the default) edges are label-random, and a model
    that sees only neighbour means cannot learn the labels. Nodes left
    without an edge are chained to their successor (minimum degree 1).
    ``feature_dtype`` (bf16 for the ``reddit`` and ``powerlaw_1m`` datasets)
    rounds the f32 features to nearest even, as JAX's cast does.
    """
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(num_nodes) + 1
    weights = 1.0 / ranks**0.75
    weights /= weights.sum()

    labels = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    src = rng.choice(num_nodes, size=num_edges, p=weights)
    dst = rng.integers(0, num_nodes, size=num_edges)
    if homophily > 0.0:
        order = np.argsort(labels, kind="stable")
        counts = np.bincount(labels, minlength=num_classes)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        c = labels[src]
        # An empty class keeps the uniform destination.
        safe = np.maximum(counts[c], 1)
        pick = order[
            np.minimum(
                starts[c] + (rng.random(num_edges) * safe).astype(np.int64),
                num_nodes - 1,
            )
        ]
        redraw = (rng.random(num_edges) < homophily) & (counts[c] > 0)
        dst = np.where(redraw, pick, dst)
    keep = src != dst
    edges = np.stack([src[keep], dst[keep]], axis=1).astype(np.int64)
    touched = np.zeros(num_nodes, dtype=bool)
    touched[edges.reshape(-1)] = True
    isolated = np.flatnonzero(~touched)
    if len(isolated):
        extra = np.stack([isolated, (isolated + 1) % num_nodes], axis=1)
        edges = np.concatenate([edges, extra], axis=0)

    centers = rng.normal(size=(num_classes, num_feats)).astype(np.float32)
    features = centers[labels] + 0.5 * rng.normal(size=(num_nodes, num_feats)).astype(
        np.float32
    )
    return build_graph(
        features, labels, edges, num_classes=num_classes, undirected=True,
        max_degree=max_degree, feature_dtype=feature_dtype, device=device,
    )


def synthetic_ppi_graphs(
    num_graphs: int = 6,
    num_nodes: int = 800,
    num_feats: int = 50,
    num_classes: int = 121,
    edges_per_node: int = 4,
    seed: int = 0,
    device=None,
) -> list[Graph]:
    """PPI-shaped multigraph family: ``num_graphs`` independent graphs with
    multi-hot ``[N, C]`` labels drawn from one shared labeling rule (the
    GraphSAGE paper's protein-protein-interaction benchmark: 24 graphs, 50
    features, 121 labels, an inductive split), at a chosen scale.

    Train on ``disjoint_union(graphs[:k])`` and evaluate on the held-out
    graphs: micro-F1 transfers because every graph labels its nodes with
    the same latent hyperplanes. Per graph, each node has a latent
    ``u ~ N(0, I_8)``; features are a shared random read-out of ``u`` plus
    noise; label ``c`` fires when ``u . v_c > t`` (``v_c`` shared, about 25%
    positive); edges prefer nodes in the same cell of three shared latent
    hyperplanes, so neighbourhood means carry label signal.
    """
    rng = np.random.default_rng(seed)
    latent_dim = 8
    # Shared across graphs: the labeling hyperplanes, the feature read-out,
    # and the locality hashing planes.
    v = rng.normal(size=(latent_dim, num_classes)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    thresh = 0.674  # about 25% positive per label under N(0, 1) margins
    readout = rng.normal(size=(latent_dim, num_feats)).astype(np.float32)
    planes = rng.normal(size=(latent_dim, 3)).astype(np.float32)

    graphs = []
    for _ in range(num_graphs):
        u = rng.normal(size=(num_nodes, latent_dim)).astype(np.float32)
        labels = (u @ v > thresh).astype(np.int8)
        features = (
            u @ readout
            + 0.3 * rng.normal(size=(num_nodes, num_feats)).astype(np.float32)
        )
        # Eight latent cells; edges are homophilous within a cell.
        cell = ((u @ planes) > 0) @ np.array([1, 2, 4])
        edges = _homophilous_edges(
            rng, cell.astype(np.int64), num_nodes * edges_per_node,
            same_class_prob=0.85,
        )
        graphs.append(build_graph(features, labels, edges, num_classes=num_classes,
                                  undirected=True, device=device))
    return graphs
