"""The rest of the port's sharded trainers' modes on the CPU, against the JAX
package and against the port's single-device trainer: ``layer0="full"``
over the node-sharded store (the all-gather and halo table builds,
``graphsage_torch/parallel/feature_store.py``), ``FullyShardedTrainer(layer0=
"full")``, the int8 node-sharded store, and ``ShardedTrainer`` on a ``model``
axis for ``layer0="full"``, lstm and int8 tables
(``graphsage_torch/parallel/distributed.py``); a sharded resume and sharded
multilabel training.

Two multi-process jobs run once for the module (``tests/
torch_sharded_modes_worker.py`` over gloo, processes that import no JAX): one
of 2 ranks (the node-sharded and fully sharded cases) and one of 4 (the
``{"data": 2, "model": 2}`` cases). The edge slices, the int8 store's
shards, the traffic counts and the errors are compared here in one process.
JAX references run under ``jax.jit`` with ``matmul_precision="highest"`` on
the 8-device CPU mesh, with the weights the worker draws.

Tolerances: losses within ``rtol = atol = 1e-5`` (f32); parameters after
three steps at learning rate 0.5 within ``rtol = 1e-4, atol = 1e-5`` (JAX's
own in ``tests/test_layer0_full.py``); an int8 run against its dense twin
(features equal to the int8 values) within ``rtol = 1e-5, atol = 1e-6``, its
predictions equal (``tests/test_quantize.py``).
"""

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
import torch_sharded_modes_worker as SW
from graphsage_torch import FullyShardedTrainer, GraphSAGE, ShardedFeatureTrainer, TrainConfig
from graphsage_torch.convert import LAYER_FIELDS
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.ops.quantize import quantize_features
from graphsage_torch.parallel import feature_store as fs
from graphsage_torch.parallel.halo import build_node_partition
from graphsage_tpu.data.synthetic import power_law_graph as jax_power_law_graph
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_tpu.models.graphsage import SAGEParams
from graphsage_tpu.models.layers import SAGELayerParams
from graphsage_tpu.ops.quantize import quantize_features as jax_quantize_features
from graphsage_tpu.parallel import feature_store as jfs
from graphsage_tpu.parallel.halo import build_node_partition as jax_build_node_partition
from graphsage_tpu.parallel.mesh import make_mesh as jax_make_mesh
from graphsage_tpu.train.config import TrainConfig as JaxTrainConfig
from graphsage_tpu.train.trainer import Trainer as JaxTrainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-5, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-5)
TWIN = dict(rtol=1e-5, atol=1e-6)
JOB_TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _run_job(name: str, world: int, out: Path) -> list[dict]:
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_sharded_modes_worker.py"), name, str(r),
         str(world), port, str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOB_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks {bad} failed:\n" + "\n".join(logs)[-4000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def job2(tmp_path_factory):
    return _run_job("two", 2, tmp_path_factory.mktemp("sm2"))


@pytest.fixture(scope="module")
def job4(tmp_path_factory):
    return _run_job("four", 4, tmp_path_factory.mktemp("sm4"))


@pytest.fixture(scope="module")
def graphs():
    return jax_power_law_graph(**SW.GRAPH), power_law_graph(device="cpu", **SW.GRAPH)


@pytest.fixture(scope="module")
def world_of_one():
    from graphsage_torch.parallel import multihost
    from graphsage_torch.parallel.mesh import make_mesh

    multihost.initialize(device="cpu")
    return make_mesh({"data": 1})


@functools.lru_cache(maxsize=None)
def _jax_run(model_items: tuple) -> dict:
    """JAX's single-device Trainer on ``SW.GRAPH`` for ``SW.TRAIN``'s steps
    from the weights the worker draws for the port's model of the same
    keywords: its losses and parameters (named as the port's)."""
    kw = dict(model_items)
    jg = jax_power_law_graph(**SW.GRAPH)
    port = GraphSAGE(jg.num_features, jg.num_classes, device="cpu", **kw)
    tree = W.draw_params(port, 0)
    params = SAGEParams(
        layers=tuple(SAGELayerParams(**{f: None if v is None else jnp.asarray(v)
                                        for f, v in p.items()}) for p in tree["layers"]),
        head=jnp.asarray(tree["head"]))
    jm = JaxGraphSAGE(in_dim=jg.num_features, num_classes=jg.num_classes,
                      matmul_precision="highest", gather_impl="take", **kw)
    tr = JaxTrainer(jm, jg, JaxTrainConfig(**SW.TRAIN))
    state = tr.init_state()
    state = state.replace(params=params, opt_state=tr.tx.init(params))
    it = tr.batches()
    losses = []
    for _ in range(SW.TRAIN["num_steps"]):
        state, loss = tr.step(state, next(it))
        losses.append(float(loss))
    named = {"head": np.asarray(state.params.head)}
    for i, layer in enumerate(state.params.layers):
        for f in LAYER_FIELDS:
            if getattr(layer, f) is not None:
                named[f"layers.{i}.{f}"] = np.asarray(getattr(layer, f))
    return {"losses": losses, "params": named}


def _close_params(got: dict, want: dict, **tol) -> None:
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **(tol or PARAMS))


# ------------------------------------------------------------ host arrays
@pytest.mark.parametrize("world", [2, 3, 8])
def test_shard_edge_slices_equal_jax(graphs, world):
    jg, tg = graphs
    want = jfs.shard_edge_slices(jg, world)
    for s in range(world):
        got = fs.shard_edge_slices(tg, world, s)
        for name in ("edge_src", "edge_dst", "edge_mask", "degrees"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name))[s], err_msg=name)
        assert (got.num_shards, got.rows_per_shard) == (want.num_shards, want.rows_per_shard)


@pytest.mark.parametrize("world", [2, 3])
def test_local_edges_from_adjacency_equal_jax(graphs, world):
    jg, tg = graphs
    adj = jfs.shard_adjacency(jg, world)
    for s in range(world):
        got = fs.shard_adjacency(tg, world, s)
        want = jfs.local_edges_from_adjacency(adj.indptr[s], adj.edge_dst[s], adj.rows_per_shard)
        for a, b in zip(fs.local_edges_from_adjacency(got.indptr, got.edge_dst,
                                                      got.rows_per_shard), want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_local_csr_is_the_slice_and_its_transpose(graphs):
    """The CSR kernel 3 reads over the all-gathered buffer: its rows' edges
    are the slice's valid edges, its transpose lists each buffer row's
    local rows, and the counts are the slice's degrees."""
    _, tg = graphs
    sl = fs.shard_edge_slices(tg, 3, 1)
    csr = fs.slices_csr(sl, "cpu")
    m = sl.edge_mask.numpy()
    rows = np.repeat(np.arange(sl.rows_per_shard), np.diff(csr.indptr.numpy()))
    np.testing.assert_array_equal(rows, sl.edge_src.numpy()[m])
    np.testing.assert_array_equal(csr.cols.numpy(), sl.edge_dst.numpy()[m])
    np.testing.assert_array_equal(csr.count.numpy(), sl.degrees.numpy())
    t_rows = np.repeat(np.arange(3 * sl.rows_per_shard), np.diff(csr.t_indptr.numpy()))
    pairs = sorted(zip(csr.cols.numpy().tolist(), rows.tolist()))
    assert sorted(zip(t_rows.tolist(), csr.t_cols.numpy().tolist())) == pairs


@pytest.mark.parametrize("world", [2, 8])
def test_int8_shard_features_equal_jax(graphs, world):
    """``q`` and the scales cut on the same ranges, padding rows of scale 1;
    ``memory_stats`` counts ``F + 4`` bytes a row, as JAX's."""
    jg, tg = graphs
    want = jfs.shard_features(jax_quantize_features(np.asarray(jg.features)), world)
    qt = quantize_features(tg.features)
    for s in range(world):
        got = fs.shard_features(qt, world, s)
        np.testing.assert_array_equal(got.shard.q.numpy(), np.asarray(want.shards.q)[s])
        np.testing.assert_array_equal(got.shard.scale.numpy(), np.asarray(want.shards.scale)[s])
        assert got.memory_stats() == want.memory_stats()
    assert want.memory_stats()["feature_bytes_per_chip"] == want.rows_per_shard * (24 + 4)


STATS_CASES = {
    "int8": (dict(in_dim=32, num_classes=5, hidden_dims=(16, 16), fanouts=(4, 4)),
             dict(batch_size=64, num_shards=8, quantized=True)),
    "int8_project_first": (dict(in_dim=64, num_classes=5, hidden_dims=(8, 8), fanouts=(4, 4)),
                           dict(batch_size=64, num_shards=8, quantized=True,
                                fully_sharded=True)),
    "int8_cached": (dict(in_dim=500, num_classes=3, hidden_dims=(128, 128), fanouts=(10, 25),
                         layer0="cached"), dict(batch_size=1024, num_shards=4, quantized=True)),
    "full": (dict(in_dim=500, num_classes=3, hidden_dims=(128, 128), fanouts=(10, 25),
                  layer0="full"), dict(batch_size=1024, num_shards=8, num_nodes=19717)),
    "full_mean_first": (dict(in_dim=24, num_classes=5, hidden_dims=(32, 8), fanouts=(4, 4),
                             layer0="full"), dict(batch_size=32, num_shards=4, num_nodes=300,
                                                  fully_sharded=True)),
}


@pytest.mark.parametrize("name", list(STATS_CASES))
def test_sharded_comm_stats_new_keywords_equal_jax(name):
    model_kw, kw = STATS_CASES[name]
    port = GraphSAGE(model_kw["in_dim"], model_kw["num_classes"], device="cpu",
                     **{k: v for k, v in model_kw.items() if k not in ("in_dim", "num_classes")})
    jm = JaxGraphSAGE(**model_kw)
    assert fs.sharded_comm_stats(port, **kw) == jfs.sharded_comm_stats(jm, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_comm_stats_layer0_partition_equals_jax(graphs, dtype):
    """``layer0="full"`` with the halo plan (``tests/test_layer0_full.py``'s
    case): the all-gather's and the boundary rows' bytes, in the compute
    dtype; the halo build moves fewer."""
    jg, tg = graphs
    kw = dict(hidden_dims=(8, 8), fanouts=(4, 4), layer0="full")
    port = GraphSAGE(tg.num_features, tg.num_classes, device="cpu",
                     compute_dtype=getattr(torch, dtype) if dtype != "float32" else None, **kw)
    jm = JaxGraphSAGE(in_dim=jg.num_features, num_classes=jg.num_classes,
                      compute_dtype=getattr(jnp, dtype) if dtype != "float32" else None, **kw)
    got = fs.sharded_comm_stats(port, 32, 8, num_nodes=tg.num_nodes,
                                layer0_partition=build_node_partition(tg, 8,
                                                                      bounds="equal_nodes"))
    want = jfs.sharded_comm_stats(jm, 32, 8, num_nodes=jg.num_nodes,
                                  layer0_partition=jax_build_node_partition(
                                      jg, 8, bounds="equal_nodes"))
    assert got == want
    assert got["layer0_halo_bytes_per_chip_step"] < got["layer0_allgather_bytes_per_chip_step"]


# ------------------------------------------------------------------ errors
ERRORS = {
    "halo_fully_sharded": (FullyShardedTrainer, dict(layer0="full"),
                           dict(layer0_exchange="halo")),
    "unknown_exchange": (ShardedFeatureTrainer, dict(layer0="full"),
                         dict(layer0_exchange="ring")),
    "hub_layer0_full": (ShardedFeatureTrainer, dict(layer0="full"),
                        dict(gather_mode="compact", hub_cache_rows=8)),
    "hub_int8_project_first": (ShardedFeatureTrainer, dict(hidden_dims=(4, 4)),
                               dict(gather_mode="compact", hub_cache_rows=8)),
    "hub_int8_cache": (ShardedFeatureTrainer, dict(layer0="cached"),
                       dict(gather_mode="compact", hub_cache_rows=8)),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_errors_are_jax(graphs, world_of_one, name):
    """JAX's ``ValueError``s, message for message (int8 cases on the int8
    graph: an int8 row is 28 bytes against a 16-byte projected one, and an
    int8 graph's cache is int8)."""
    from graphsage_torch import quantize_graph
    from graphsage_tpu.data.graph import quantize_graph as jax_quantize_graph

    jg, tg = graphs
    cls, model_kw, kw = ERRORS[name]
    model_kw = {"hidden_dims": (8, 8), "fanouts": (4, 4), **model_kw}
    if "int8" in name:
        jg, tg = jax_quantize_graph(jg), quantize_graph(tg)
    jcls = getattr(jfs, cls.__name__)
    jm = JaxGraphSAGE(in_dim=jg.num_features, num_classes=jg.num_classes, **model_kw)
    jkw = {k: v for k, v in kw.items() if not (cls is FullyShardedTrainer and k == "gather_mode")}
    with pytest.raises(ValueError) as want:
        jcls(jm, jg, JaxTrainConfig(**SW.TRAIN), jax_make_mesh({"data": 1}), **jkw)
    with pytest.raises(ValueError) as got:
        cls(W._model(tg, **model_kw), tg, TrainConfig(**SW.TRAIN), world_of_one, **jkw)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------- layer0="full"
@pytest.mark.parametrize("mode", list(SW.FULL_CASES))
def test_layer0_full_sharded_equals_jax_single_device(job2, mode):
    """Every neighbour (deterministic frontiers): each mode's losses and
    parameters on 2 ranks against JAX's single-device Trainer
    (``tests/test_layer0_full.py``'s parity test)."""
    model_kw, _ = SW.FULL_CASES[mode]
    want = _jax_run(tuple(sorted(dict(SW.FULL, fanouts=SW.COVER, **model_kw).items())))
    for rank in job2:
        got = rank["full"][mode][SW.COVER]
        np.testing.assert_allclose(got["losses"], want["losses"], **F32)
        _close_params(got["params"], want["params"])


@pytest.mark.parametrize("mode", list(SW.FULL_CASES))
def test_layer0_full_sharded_equals_single_device_when_sampled(job2, mode):
    """Fanouts (4, 4): replicated sampling, so each mode takes the port's
    single-device steps."""
    for rank in job2:
        rec = rank["full"][mode]
        np.testing.assert_allclose(rec[(4, 4)]["losses"], rec[("single", (4, 4))]["losses"],
                                   **F32)
        _close_params(rec[(4, 4)]["params"], rec[("single", (4, 4))]["params"])


def test_layer0_full_fully_sharded_equals_jax_at_covering_fanouts(job2):
    """``FullyShardedTrainer(layer0="full")``: JAX's single-device steps,
    the node-sharded trainer's evaluation, and the transposed CSR counted
    under its own key."""
    want = _jax_run(tuple(sorted(dict(SW.FULL, fanouts=SW.COVER).items())))
    for rank in job2:
        rec = rank["full"]["fully"]
        np.testing.assert_allclose(rec["losses"], want["losses"], **F32)
        _close_params(rec["params"], want["params"])
        np.testing.assert_allclose(rec["losses"], rec["node"]["losses"], **F32)
        np.testing.assert_array_equal(rec["preds"], rec["node_preds"])
        assert rec["memory_stats"]["layer0_transpose_bytes_per_chip"] > 0


def test_layer0_full_fully_sharded_maxpool_equals_jax(job2):
    want = _jax_run(tuple(sorted(dict(SW.FULL, fanouts=SW.COVER, **SW.MAXPOOL).items())))
    for rank in job2:
        np.testing.assert_allclose(rank["full"]["fully_maxpool"]["losses"], want["losses"],
                                   **F32)


# -------------------------------------------------------------------- int8
@pytest.mark.parametrize("name", ["dense", "compact", "fully"])
def test_int8_store_equals_its_dense_twin(job2, name):
    """``tests/test_quantize.py``'s twins: the int8 exchanges (kernel 1's
    int8 route on the owner side, or int8 answers and scales) against the
    dense twin's f32 ones; the int8 run keeps aggregating first (a 36-byte
    row against 64 projected), the twin projects first."""
    for rank in job2:
        rec = rank["int8"][name]
        np.testing.assert_allclose(rec["int8"]["losses"], rec["twin"]["losses"], **TWIN)
        np.testing.assert_array_equal(rec["int8"]["preds"], rec["twin"]["preds"])
        assert rec["shard_dtype"] == "torch.float32"  # the twin's; the int8 store is int8


def test_int8_hub_cache_equals_the_routed_run(job2):
    for rank in job2:
        rec = rank["int8"]
        np.testing.assert_allclose(rec["hub"]["losses"], rec["compact"]["int8"]["losses"], **F32)
        # The [N] lookup, and each hub row's int8 values and scale.
        assert rec["hub"]["hub_bytes"] == SW.GRAPH["num_nodes"] * 4 + SW.HUB_ROWS * (32 + 4)


def test_int8_cached_sharded_equals_single_device(job2):
    for rank in job2:
        rec = rank["int8"]["cached"]
        np.testing.assert_allclose(rec["losses"], rec["single"]["losses"], **F32)
        _close_params(rec["params"], rec["single"]["params"])
        assert rec["cache_quantized"] == "QuantizedTable"
        stats = rank["int8"]["memory_stats"]
        assert stats["layer0_cache_bytes_per_chip"] == stats["rows_per_shard"] * (32 + 4)


# ------------------------------------------------------- resume, multilabel
@pytest.mark.parametrize("name", ["sharded", "fully"])
def test_sharded_resume_equals_an_uninterrupted_run(job2, name):
    for rank in job2:
        rec = rank["resume"][name]
        assert rec["step"] == SW.RESUME_STEPS
        assert rec["resumed"] == rec["straight"]
        for k in rec["params"]:
            np.testing.assert_array_equal(rec["params"][k], rec["straight_params"][k], err_msg=k)


def test_sharded_multilabel_equals_single_device(job2):
    for rank in job2:
        rec = rank["multilabel"]
        np.testing.assert_allclose(rec["losses"], rec["single"]["losses"], **F32)
        _close_params(rec["params"], rec["single"]["params"])
        assert rec["val"] == rec["single_val"]


# ----------------------------------------------------------- DP + TP
@pytest.mark.parametrize("name", list(SW.TP_CASES))
def test_sharded_trainer_tp_equals_single_device(job4, name):
    """``{"data": 2, "model": 2}`` at fanouts (4, 4): each case's losses and
    parameters against the port's single-device Trainer; the table's
    columns split over ``model``."""
    for rank in job4:
        rec = rank["tp"][name]
        np.testing.assert_allclose(rec[("", (4, 4))]["losses"], rec[("", "single")]["losses"],
                                   **F32)
        _close_params(rec[("", (4, 4))]["params"], rec[("", "single")]["params"])
        assert rec["feature_cols"] * 2 == (32 if name.startswith("int8") else 24)


@pytest.mark.parametrize("name", ["full", "full_mean_first", "full_maxpool", "lstm"])
def test_sharded_trainer_tp_equals_jax_single_device(job4, name):
    """Every neighbour: the ``full`` tables (kernel 3 over the summed
    projection, or over each rank's columns) and the lstm (the summed
    input-gate products) against JAX's single-device Trainer."""
    want = _jax_run(tuple(sorted(dict(SW.TP_CASES[name], fanouts=SW.COVER).items())))
    for rank in job4:
        got = rank["tp"][name][("", SW.COVER)]
        np.testing.assert_allclose(got["losses"], want["losses"], **F32)
        _close_params(got["params"], want["params"])


@pytest.mark.parametrize("name", ["int8", "int8_full"])
def test_sharded_trainer_tp_int8_equals_its_dense_twin(job4, name):
    """``tests/test_quantize.py``'s DP + TP twin test: ``q`` split on its
    columns, the scales whole on every rank."""
    for rank in job4:
        rec = rank["tp"][name]
        for fanouts in ((4, 4), SW.COVER):
            np.testing.assert_allclose(rec[("", fanouts)]["losses"],
                                       rec[("twin", fanouts)]["losses"], **TWIN)
