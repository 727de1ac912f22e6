"""The port's native and lazy ingestion on the CPU, against the JAX package:
the C++ loader (``graphsage_torch/data/native.py``), the loaders' ``engine=``,
``load_cora_lazy``/``load_pubmed_lazy``, ``shard_features_from_loader`` and
the sharded trainers' ``feature_store=``, the lazy-descriptor guards, and
``with_cached_layer0``'s blocked CPU build.

It mirrors ``tests/test_lazy_loading.py`` and ``tests/test_native.py``'s
loader tests on the synthetic Cora and Pubmed files of the session-scoped
fixtures. JAX runs on its 8-device CPU mesh with the Python engine. One job
of two gloo ranks (``tests/torch_ingestion_worker.py``, which imports no
JAX) checks that each rank's loader is asked for its own rows only.

Tolerances: parses, graphs, row ranges and stores are bitwise; a trainer on a
loader store against one on an eager store, and two ranks against one, are
within ``rtol = 1e-6`` per loss (the same sums, reduced over the ranks in
another order), their predictions equal; the blocked CPU cache against
JAX's host build within ``rtol = atol = 1e-6``.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_ingestion_worker as IW
from graphsage_torch import (
    FullGraphTrainer,
    FullyShardedTrainer,
    GraphSAGE,
    ServingEngine,
    ShardedFeatureTrainer,
    TrainConfig,
    Trainer,
)
from graphsage_torch.data import graph as tgraph
from graphsage_torch.data import loaders, native
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.ops.quantize import quantize_features
from graphsage_torch.parallel import feature_store as fs
from graphsage_torch.parallel.halo import build_node_partition
from graphsage_tpu.data import graph as jgraph
from graphsage_tpu.data import loaders as jloaders
from graphsage_tpu.data.synthetic import power_law_graph as jax_power_law_graph
from graphsage_tpu.ops.quantize import quantize_features as jax_quantize_features
from graphsage_tpu.parallel.feature_store import (
    shard_features_from_loader as jax_shard_features_from_loader,
)
from graphsage_tpu.parallel.mesh import make_mesh as jax_make_mesh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LOCKSTEP = dict(rtol=1e-6, atol=0.0)
CACHE = dict(rtol=1e-6, atol=1e-6)
JOB_TIMEOUT_S = 180
GRAPH_ARRAYS = ("neighbors", "degrees", "indptr", "edge_dst", "edge_src", "edge_mask", "labels")
DATASETS = ("cora", "pubmed")
ENGINES = ("python", "native")


@pytest.fixture(scope="module")
def roots(synth_cora_root, synth_pubmed_root):
    return {"cora": synth_cora_root, "pubmed": synth_pubmed_root}


def _lazy(name, root, engine="auto", **kw):
    return {"cora": loaders.load_cora_lazy, "pubmed": loaders.load_pubmed_lazy}[name](
        root, engine=engine, **kw)


def _jax_lazy(name, root):
    return {"cora": jloaders.load_cora_lazy, "pubmed": jloaders.load_pubmed_lazy}[name](
        root, engine="python")


@pytest.fixture(scope="module")
def world_of_one():
    from graphsage_torch.parallel import multihost
    from graphsage_torch.parallel.mesh import make_mesh

    multihost.initialize(device="cpu")
    return make_mesh({"data": 1})


# --------------------------------------------------------------------------
# The native loader and engine=
# --------------------------------------------------------------------------

def test_native_library_builds_into_build_dir():
    """The port's own copy of the C++ source, built with ``g++`` into
    ``build/graphsage_torch/<hash>/``."""
    assert native.available(), native.build_error
    assert native.SOURCE == REPO / "graphsage_torch" / "csrc" / "graph_loader.cpp"
    assert REPO / "build" / "graphsage_torch" in native.library_path().parents
    assert native.library_path().exists()


@pytest.mark.parametrize("name", DATASETS)
def test_native_parse_equals_python_and_jax(roots, name):
    py = {"cora": loaders.parse_cora, "pubmed": loaders.parse_pubmed}[name](roots[name])
    nat = {"cora": native.parse_cora_native,
           "pubmed": native.parse_pubmed_native}[name](roots[name])
    jx = {"cora": jloaders.parse_cora, "pubmed": jloaders.parse_pubmed}[name](roots[name])
    for a, b, c in zip(py[:3], nat[:3], jx[:3]):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert py.num_classes == nat.num_classes == jx.num_classes


def test_native_csr_matches_adjacency_from_edges(roots):
    raw = loaders.parse_cora(roots["cora"])
    n = raw.features.shape[0]
    indptr, indices = native.build_csr_native(n, raw.edges, undirected=True)
    rows = tgraph.adjacency_from_edges(n, raw.edges, undirected=True)
    jrows = jgraph.adjacency_from_edges(n, raw.edges, undirected=True)
    assert len(rows) == len(jrows) == n
    for v in range(n):
        np.testing.assert_array_equal(indices[indptr[v]:indptr[v + 1]], rows[v])
        np.testing.assert_array_equal(rows[v], jrows[v])
    e = tgraph.sorted_unique_edges(n, raw.edges)
    np.testing.assert_array_equal(np.repeat(np.arange(n), np.diff(indptr)), e[:, 0])
    np.testing.assert_array_equal(indices, e[:, 1])


@pytest.mark.parametrize("name", DATASETS)
def test_loader_engine_param(roots, name):
    load = {"cora": loaders.load_cora, "pubmed": loaders.load_pubmed}[name]
    g_native = load(roots[name], engine="native", device="cpu")
    g_python = load(roots[name], engine="python", device="cpu")
    g_auto = load(roots[name], device="cpu")
    for field in ("features", *GRAPH_ARRAYS):
        assert torch.equal(getattr(g_native, field), getattr(g_python, field)), field
        assert torch.equal(getattr(g_auto, field), getattr(g_python, field)), field
    with pytest.raises(ValueError, match="unknown engine"):
        load(roots[name], engine="fortran", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        _lazy(name, roots[name], engine="fortran")


# --------------------------------------------------------------------------
# Lazy graphs and their row loaders
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", DATASETS)
def test_lazy_graph_equals_jax(roots, name, engine):
    """Labels, adjacency and CSR equal JAX's lazy graph and the port's eager
    one; the feature leaf is a zero-strided descriptor; every row range
    equals JAX's row loader and the eager table, bitwise."""
    lazy, rows = _lazy(name, roots[name], engine)
    jlazy, jrows = _jax_lazy(name, roots[name])
    eager = {"cora": loaders.load_cora,
             "pubmed": loaders.load_pubmed}[name](roots[name], engine="python", device="cpu")
    assert (lazy.num_nodes, lazy.num_features, lazy.num_classes, lazy.num_edges) == (
        jlazy.num_nodes, jlazy.num_features, jlazy.num_classes, jlazy.num_edges)
    for field in GRAPH_ARRAYS:
        np.testing.assert_array_equal(getattr(lazy, field).numpy(),
                                      np.asarray(getattr(jlazy, field)), err_msg=field)
    assert lazy.on_host and lazy.features.stride(0) == 0
    assert tgraph.is_lazy_descriptor(lazy.features)
    assert lazy.features.shape == (lazy.num_nodes, lazy.num_features)
    n = lazy.num_nodes
    for lo, hi in ((0, n), (100, 164), (7, 31), (n - 5, n), (3, 3)):
        got = rows(lo, hi)
        assert got.dtype == np.float32 and got.shape == (hi - lo, lazy.num_features)
        np.testing.assert_array_equal(got, jrows(lo, hi))
        np.testing.assert_array_equal(got, eager.features[lo:hi].numpy())


def test_lazy_descriptor_in_the_target_dtype(roots):
    """``feature_dtype`` builds the descriptor in that dtype: a cast of the
    zero-strided view would materialize all ``N x F`` elements."""
    lazy, _ = loaders.load_cora_lazy(roots["cora"], feature_dtype=torch.bfloat16)
    assert lazy.features.dtype == torch.bfloat16 and lazy.features.stride() == (0, 1)
    assert lazy.to("cpu").features.stride(0) == 0
    with pytest.raises(ValueError, match="lazy loading requires device='cpu'"):
        loaders.load_cora_lazy(roots["cora"], device="cuda")


# --------------------------------------------------------------------------
# shard_features_from_loader
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name", DATASETS)
def test_loader_store_equals_jax(roots, name, quantize):
    """Each rank's store is JAX's ``shards[index]`` (q and scales for int8),
    built from one call of the loader for exactly the rank's real rows."""
    lazy, rows = _lazy(name, roots[name])
    _, jrows = _jax_lazy(name, roots[name])
    s = 3
    jstore = jax_shard_features_from_loader(
        jrows, lazy.num_nodes, lazy.num_features, s,
        NamedSharding(jax_make_mesh({"data": s}), P("data")), quantize=quantize)
    for index in range(s):
        calls = []

        def loader(lo, hi):
            calls.append((lo, hi))
            return rows(lo, hi)

        store = fs.shard_features_from_loader(loader, lazy.num_nodes, lazy.num_features, s,
                                              index, device="cpu", quantize=quantize)
        np_ = store.rows_per_shard
        assert np_ == jstore.rows_per_shard
        assert calls == [(index * np_, min((index + 1) * np_, lazy.num_nodes))]
        if quantize:
            assert store.shard.q.dtype == torch.int8
            np.testing.assert_array_equal(store.shard.q.numpy(), np.asarray(jstore.shards.q)[index])
            np.testing.assert_array_equal(store.shard.scale.numpy(),
                                          np.asarray(jstore.shards.scale)[index])
        else:
            np.testing.assert_array_equal(store.shard.numpy(), np.asarray(jstore.shards)[index])


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_loader_store_equals_shard_features(quantize):
    """From a table's loader the store is ``shard_features`` of the table (of
    ``quantize_features(table)`` with ``quantize``), bitwise, padding rows
    zero (scale 1); a rank whose range is all padding never calls the loader
    (100 rows over 8 ranks of 16)."""
    feats = (np.random.default_rng(9).normal(size=(100, 12)) * 3.7).astype(np.float32)
    table = torch.from_numpy(feats)
    for index in range(8):
        calls = []

        def loader(lo, hi):
            calls.append((lo, hi))
            return feats[lo:hi]

        got = fs.shard_features_from_loader(loader, 100, 12, 8, index, device="cpu",
                                            quantize=quantize)
        want = fs.shard_features(quantize_features(table) if quantize else table, 8, index)
        assert calls == ([] if index == 7 else [(16 * index, min(16 * index + 16, 100))])
        assert (got.num_shards, got.rows_per_shard, got.num_nodes) == (8, 16, 100)
        if quantize:
            assert torch.equal(got.shard.q, want.shard.q)
            assert torch.equal(got.shard.scale, want.shard.scale)
        else:
            assert torch.equal(got.shard, want.shard)


def test_loader_store_quantize_equals_jax_eager_quantized():
    """JAX's ``shard_features(quantize_features(full table))``, bitwise."""
    feats = (np.random.default_rng(9).normal(size=(100, 12)) * 3.7).astype(np.float32)
    jq = jax_quantize_features(feats)
    rows = 16
    for index in range(8):
        got = fs.shard_features_from_loader(lambda lo, hi: feats[lo:hi], 100, 12, 8, index,
                                            device="cpu", quantize=True)
        lo, hi = min(index * rows, 100), min(index * rows + rows, 100)
        np.testing.assert_array_equal(got.shard.q.numpy()[:hi - lo], np.asarray(jq.q)[lo:hi])
        np.testing.assert_array_equal(got.shard.scale.numpy()[:hi - lo],
                                      np.asarray(jq.scale)[lo:hi])
        assert (got.shard.q.numpy()[hi - lo:] == 0).all()
        assert (got.shard.scale.numpy()[hi - lo:] == 1).all()


# --------------------------------------------------------------------------
# Trainers over a loader store
# --------------------------------------------------------------------------

TRAIN = dict(batch_size=32, num_steps=3, learning_rate=0.5, log_every=0, eval_fanouts=(5, 5),
             test_size=100, val_size=80)
# Trainer class, its keywords, the model's, and whether the store is int8
# (against an eager quantize_graph store).
TRAINERS = {
    "sharded_dense": (ShardedFeatureTrainer, {}, {}, False),
    "sharded_compact": (ShardedFeatureTrainer, dict(gather_mode="compact"), {}, False),
    "sharded_dense_int8": (ShardedFeatureTrainer, {}, {}, True),
    "sharded_compact_int8": (ShardedFeatureTrainer, dict(gather_mode="compact"), {}, True),
    "full_allgather": (ShardedFeatureTrainer, {}, dict(layer0="full"), False),
    "full_halo": (ShardedFeatureTrainer, dict(layer0_exchange="halo"), dict(layer0="full"),
                  False),
    "fully_sharded": (FullyShardedTrainer, {}, {}, False),
    "fully_sharded_full": (FullyShardedTrainer, {}, dict(layer0="full"), False),
}


def _model(graph, **kw):
    return GraphSAGE(graph.num_features, graph.num_classes, hidden_dims=(16, 16),
                     fanouts=(5, 5), device="cpu", generator=torch.Generator().manual_seed(3),
                     **kw)


@pytest.mark.parametrize("case", list(TRAINERS))
def test_trainer_on_loader_store_in_lockstep_with_eager(roots, world_of_one, case):
    """Three steps on a loader store equal three on the eager store of the
    same rows, and so do the predictions; the store is the only table the
    trainer holds, and ``memory_stats`` reports its bytes per rank."""
    cls, kw, model_kw, quantize = TRAINERS[case]
    eager = loaders.load_cora(roots["cora"], engine="python", device="cpu")
    if quantize:
        eager = tgraph.quantize_graph(eager)
    lazy, rows = loaders.load_cora_lazy(roots["cora"])
    store = fs.shard_features_from_loader(rows, lazy.num_nodes, lazy.num_features, 1, 0,
                                          device="cpu", quantize=quantize)
    cfg = TrainConfig(**TRAIN)
    t_eager = cls(_model(eager, **model_kw), eager, cfg, world_of_one, **kw)
    t_lazy = cls(_model(lazy, **model_kw), lazy, cfg, world_of_one, feature_store=store, **kw)
    b_eager, b_lazy = t_eager.batches(), t_lazy.batches()
    for _ in range(cfg.num_steps):
        np.testing.assert_allclose(float(t_lazy.step(next(b_lazy))),
                                   float(t_eager.step(next(b_eager))), **LOCKSTEP)
    np.testing.assert_array_equal(t_lazy.predict(t_lazy.val_nodes),
                                  t_eager.predict(t_eager.val_nodes))
    assert t_lazy.features.shard is store.shard
    assert t_lazy.graph.features.shape[0] == 1  # the device graph's blank table
    stats = t_lazy.memory_stats()
    row_bytes = lazy.num_features + 4 if quantize else 4 * lazy.num_features
    assert stats["feature_bytes_per_chip"] == store.rows_per_shard * row_bytes


def _store(lazy, rows, num_shards=1):
    return fs.shard_features_from_loader(rows, lazy.num_nodes, lazy.num_features, num_shards,
                                         0, device="cpu")


STORE_ERRORS = {
    "nodes": (lambda lazy, rows, m: dict(feature_store=dataclasses.replace(
        _store(lazy, rows), num_nodes=lazy.num_nodes - 1)), {}, {}, "covers 399 nodes"),
    "shards": (lambda lazy, rows, m: dict(feature_store=_store(lazy, rows, 2)), {}, {},
               "has 2 shards"),
    "eval_fanouts": (lambda lazy, rows, m: dict(feature_store=_store(lazy, rows)),
                     dict(eval_fanouts=None), {}, "eval_fanouts"),
    "cached": (lambda lazy, rows, m: dict(feature_store=_store(lazy, rows)), {},
               dict(layer0="cached"), "precompute the cache offline"),
    "hub": (lambda lazy, rows, m: dict(feature_store=_store(lazy, rows), gather_mode="compact",
                                       hub_cache_rows=8), {}, dict(project_first=False),
            "hub_cache_rows needs the full feature table"),
    "no_store": (lambda lazy, rows, m: {}, {}, {}, "LAZY descriptor"),
}


@pytest.mark.parametrize("case", list(STORE_ERRORS))
def test_store_trainer_construction_checks_are_jax(roots, world_of_one, case):
    """JAX's construction checks of ``feature_store=`` (and a lazy graph
    without one), with JAX's messages."""
    kwargs, cfg_kw, model_kw, match = STORE_ERRORS[case]
    lazy, rows = loaders.load_cora_lazy(roots["cora"])
    cfg = TrainConfig(**{**TRAIN, **cfg_kw})
    with pytest.raises(ValueError, match=match):
        ShardedFeatureTrainer(_model(lazy, **model_kw), lazy, cfg, world_of_one,
                              **kwargs(lazy, rows, world_of_one))


def test_two_ranks_load_only_their_rows_and_match_one_rank(roots, world_of_one, tmp_path):
    """Each of two gloo ranks asks its loader for its own range, once; the
    losses (dense f32, compact int8) equal a world of one's, the
    predictions too."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1")
    with socket.socket() as sock:
        sock.bind(("", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_ingestion_worker.py"), str(r), "2", port,
         str(tmp_path), str(roots["cora"])],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOB_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]

    lazy, rows = loaders.load_cora_lazy(roots["cora"])
    one = IW.run_cases(lazy, rows, world_of_one, 0, 1)
    np_ = fs._rows_per_shard(lazy.num_nodes, 2)
    for name in IW.CASES:
        for r, res in enumerate(ranks):
            assert res[name]["calls"] == [(r * np_, min((r + 1) * np_, lazy.num_nodes))]
            np.testing.assert_allclose(res[name]["losses"], one[name]["losses"], **LOCKSTEP)
            np.testing.assert_array_equal(res[name]["predict"], one[name]["predict"])


# --------------------------------------------------------------------------
# The descriptor guards
# --------------------------------------------------------------------------

def _guard_cases():
    cfg = TrainConfig(**TRAIN)
    return {
        "Graph.to": lambda g: g.to("cuda"),
        "build_graph": lambda g: tgraph.build_graph(
            np.broadcast_to(np.zeros((1, 4), np.float32), (5, 4)), np.zeros(5), np.zeros((0, 2)),
            device="meta"),
        "quantize_graph": tgraph.quantize_graph,
        "with_cached_layer0": tgraph.with_cached_layer0,
        "induced_subgraph": lambda g: tgraph.induced_subgraph(g, np.arange(10)),
        "disjoint_union": lambda g: tgraph.disjoint_union([g, g]),
        "relabel_graph": lambda g: tgraph.relabel_graph(g, np.arange(g.num_nodes)),
        "shard_features": lambda g: fs.shard_features(g.features, 2, 0),
        "build_node_partition": lambda g: build_node_partition(g, 2),
        "Trainer": lambda g: Trainer(_model(g), g, cfg),
        "FullGraphTrainer": lambda g: FullGraphTrainer(_model(g), g, cfg),
        "ServingEngine": lambda g: ServingEngine(_model(g), g, device="cpu"),
    }


@pytest.mark.parametrize("site", list(_guard_cases()))
def test_lazy_descriptor_never_silently_consumed(roots, site):
    """Every path that would read a lazy graph's table raises JAX's
    message, naming the loader store and ``feature_store=``."""
    lazy, _ = loaders.load_cora_lazy(roots["cora"])
    with pytest.raises(ValueError, match="LAZY descriptor.*shard_features_from_loader"
                                         ".*feature_store="):
        _guard_cases()[site](lazy)


# --------------------------------------------------------------------------
# with_cached_layer0's blocked CPU build
# --------------------------------------------------------------------------

CACHE_GRAPH = dict(num_nodes=500, num_edges=3000, num_feats=16, num_classes=4, seed=6,
                   homophily=0.5)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("self_loop", [False, True], ids=["mean", "self_loop"])
@pytest.mark.parametrize("edge_block", [1, 97, 2_000_000])
def test_blocked_cpu_cache_equals_jax_host_build(edge_block, self_loop, quantize):
    """The blocked CPU build equals JAX's host build (``placement="host"``),
    at one-node blocks (``edge_block=1``), many blocks and one block; an
    int8 table is dequantized a block at a time."""
    g = power_law_graph(device="cpu", **CACHE_GRAPH)
    jg = jax_power_law_graph(placement="host", **CACHE_GRAPH)
    if quantize:
        g, jg = tgraph.quantize_graph(g), jgraph.quantize_graph(jg)
    got = tgraph.with_cached_layer0(g, self_loop=self_loop, edge_block=edge_block).layer0_cache
    want = jgraph.with_cached_layer0(jg, self_loop=self_loop,
                                     edge_block=edge_block).layer0_cache
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CACHE)
