"""The port's halo exchange (``graphsage_torch/parallel/halo.py``,
``native_partition.py``, ``data/graph.py:relabel_graph`` and the two callers)
on the CPU, against the JAX package.

* The plans and the host functions are compared array for array with
  JAX's, in one process (numpy; no ``shard_map``).
* The native partitioner (built with ``g++`` into ``build/``) against the
  port's numpy versions.
* The exchange runs in gloo jobs of 1, 2 and 3 ranks
  (``tests/torch_halo_worker.py``, processes that import no JAX), spawned
  once for the module. Their logits are held to JAX's single-device
  ``forward_full_graph`` at the same weights (``tests/test_halo.py`` pins
  JAX's halo logits to it), ``rtol = atol = 1e-5`` in f32 and 2e-2 of the
  largest entry in bf16; their input and parameter gradients to JAX's within
  1e-4 of each leaf's largest entry. The callers
  (``FullGraphTrainer(mesh=)``, ``ServingEngine(mesh=)``) are held to the
  port's single-device ones. JAX runs under ``jax.jit`` with
  ``matmul_precision="highest"``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_halo_worker as HW
import torch_parallel_worker as W
from graphsage_torch import GraphSAGE, locality_relabel, relabel_graph
from graphsage_torch.convert import LAYER_FIELDS
from graphsage_torch.data.graph import build_graph, quantize_graph
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.parallel import halo, native_partition
from graphsage_tpu.data.graph import build_graph as jax_build_graph
from graphsage_tpu.data.graph import quantize_graph as jax_quantize_graph
from graphsage_tpu.data.graph import relabel_graph as jax_relabel_graph
from graphsage_tpu.data.synthetic import power_law_graph as jax_power_law_graph
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_tpu.models.graphsage import SAGEParams
from graphsage_tpu.models.layers import SAGELayerParams
from graphsage_tpu.parallel import halo as jhalo

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2
GRAD_REL = 1e-4
JOB_TIMEOUT_S = 240
# The plan configurations held to JAX's (build_node_partition keywords).
PLAN_CASES = {
    "global_c1": dict(sizing="global", halo_chunks=1),
    "global_c3": dict(sizing="global", halo_chunks=3),
    "per_offset": dict(sizing="per_offset"),
    "hub": dict(hub_threshold=HW.HUB),
    "input": dict(order="input"),
    "bfs": dict(order="bfs"),
    "lpa": dict(order="lpa"),
    "auto": dict(order="auto"),
    "equal_nodes": dict(bounds="equal_nodes"),
    "bfs_per_offset_hub": dict(order="bfs", sizing="per_offset", hub_threshold=HW.HUB),
}
GRAPH_FIELDS = ("neighbors", "degrees", "indptr", "edge_dst", "edge_src", "edge_mask",
                "features", "labels")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _run_job(world: int, out: Path) -> list[dict]:
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_halo_worker.py"), str(r), str(world), port,
         str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
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
def jobs(tmp_path_factory):
    return {w: _run_job(w, tmp_path_factory.mktemp(f"halo{w}")) for w in HW.PLANS}


@pytest.fixture(scope="module")
def graphs():
    return jax_power_law_graph(**HW.HALO_GRAPH), power_law_graph(device="cpu", **HW.HALO_GRAPH)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _assert_plan_equal(got, want):
    assert got._fields == want._fields
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f == "rounds":
            assert (a is None) == (b is None)
            for ra, rb in zip(a or (), b or ()):
                for g in ra._fields:
                    np.testing.assert_array_equal(_np(getattr(ra, g)), _np(getattr(rb, g)),
                                                  err_msg=f"rounds.{g}")
        elif a is None or b is None:
            assert a is None and b is None, f
        elif isinstance(a, (int, tuple)):
            assert a == b, (f, a, b)
        else:
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=f)


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("case", list(PLAN_CASES))
@pytest.mark.parametrize("shards", [2, 3])
def test_plan_equals_jax(graphs, shards, case):
    jg, tg = graphs
    kw = PLAN_CASES[case]
    got = halo.build_node_partition(tg, shards, **kw)
    want = jhalo.build_node_partition(jg, shards, **kw)
    _assert_plan_equal(got, want)
    assert got.comm_stats() == want.comm_stats()


@pytest.mark.parametrize("table", ["bf16", "int8"])
def test_plan_h0_of_reduced_tables_equals_jax(table):
    """A bf16 table stacks as bf16; an int8 one dequantizes on the host."""
    kw = dict(HW.HALO_GRAPH)
    if table == "bf16":
        jg = jax_power_law_graph(**kw, feature_dtype=jnp.bfloat16)
        tg = power_law_graph(device="cpu", **kw, feature_dtype=torch.bfloat16)
    else:
        jg = jax_quantize_graph(jax_power_law_graph(**kw))
        tg = quantize_graph(power_law_graph(device="cpu", **kw))
    got = halo.build_node_partition(tg, 2)
    want = jhalo.build_node_partition(jg, 2)
    assert got.h0.dtype == (torch.bfloat16 if table == "bf16" else torch.float32)
    np.testing.assert_array_equal(_np(got.h0), _np(want.h0))


def test_plan_errors(graphs):
    _, tg = graphs
    with pytest.raises(ValueError, match="requires input order"):
        halo.build_node_partition(tg, 2, order="bfs", bounds="equal_nodes")
    with pytest.raises(ValueError, match="unknown sizing"):
        halo.build_node_partition(tg, 2, sizing="ring")
    with pytest.raises(ValueError, match="permutation"):
        halo.build_node_partition(tg, 2, order=np.zeros(tg.num_nodes, np.int64))


# --------------------------------------------------------- host functions
def test_bfs_order_equals_jax(graphs):
    jg, tg = graphs
    np.testing.assert_array_equal(halo.bfs_order(tg), jhalo.bfs_order(jg))


@pytest.mark.parametrize("shards", [2, 3])
def test_lpa_assign_equals_jax(graphs, shards):
    jg, tg = graphs
    np.testing.assert_array_equal(halo.lpa_assign(tg, shards), jhalo.lpa_assign(jg, shards))


@pytest.mark.parametrize("case", [
    dict(), dict(order="bfs"), dict(order="lpa", sizing="per_offset"),
    dict(hub_threshold=HW.HUB), dict(bounds="equal_nodes", order="bfs")])
def test_partition_comm_rows_equals_jax(graphs, case):
    jg, tg = graphs
    for shards in (2, 3):
        assert (halo.partition_comm_rows(tg, shards, **case)
                == jhalo.partition_comm_rows(jg, shards, **case))


@pytest.mark.parametrize("shards", [2, 3])
def test_auto_partition_plan_equals_jax(graphs, shards):
    jg, tg = graphs
    got = halo.auto_partition_plan(tg, shards)
    want = jhalo.auto_partition_plan(jg, shards)
    assert got == want


@pytest.mark.parametrize("order", ["auto", "bfs", "lpa"])
def test_locality_relabel_equals_jax(graphs, order):
    jg, tg = graphs
    g_got, perm_got = locality_relabel(tg, 3, order=order)
    g_want, perm_want = jhalo.locality_relabel(jg, 3, order=order)
    np.testing.assert_array_equal(perm_got, perm_want)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(_np(getattr(g_got, f)), _np(getattr(g_want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("symmetric", [True, False])
def test_relabel_graph_equals_jax(graphs, symmetric):
    jg, tg = graphs
    if not symmetric:  # the upper triangle, directed
        e = tg.num_edges
        edges = np.stack([tg.edge_src[:e].numpy(), tg.edge_dst[:e].numpy()], axis=1)
        edges = edges[edges[:, 0] < edges[:, 1]]
        feats, labels = tg.features.numpy(), tg.labels.numpy()
        jg = jax_build_graph(feats, labels, edges, undirected=False)
        tg = build_graph(feats, labels, edges, undirected=False, device="cpu")
    order = np.random.default_rng(1).permutation(tg.num_nodes)
    g_got, perm_got = relabel_graph(tg, order)
    g_want, perm_want = jax_relabel_graph(jg, order)
    np.testing.assert_array_equal(perm_got, perm_want)
    assert g_got.symmetric == g_want.symmetric == symmetric
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(_np(getattr(g_got, f)), _np(getattr(g_want, f)),
                                      err_msg=f)


def test_relabel_graph_refuses_int8_with_jax_message(graphs):
    jg, tg = graphs
    order = np.arange(tg.num_nodes)
    with pytest.raises(ValueError) as want:
        jax_relabel_graph(jax_quantize_graph(jg), order)
    with pytest.raises(ValueError) as got:
        relabel_graph(quantize_graph(tg), order)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------- the native library
def test_native_partitioner_builds_into_build_dir():
    lib = native_partition.load_library()
    assert lib is not None, native_partition.build_error
    path = native_partition.library_path()
    assert path.exists() and REPO / "build" / "graphsage_torch" in path.parents
    assert native_partition.SOURCE == REPO / "graphsage_torch" / "csrc" / "partitioner.cpp"


@pytest.mark.parametrize("shards", [2, 3, 5])
def test_native_lpa_equals_numpy(graphs, shards):
    _, tg = graphs
    np.testing.assert_array_equal(native_partition.lpa_assign_native(tg, shards),
                                  halo.lpa_assign(tg, shards))


def test_native_bfs_equals_numpy(graphs):
    _, tg = graphs
    np.testing.assert_array_equal(native_partition.bfs_order_native(tg), halo.bfs_order(tg))
    halo.build_node_partition(tg, 2, order="bfs")
    halo.build_node_partition(tg, 2, order="lpa")
    assert native_partition.last_impl == {"bfs": "native", "lpa": "native"}


# ------------------------------------------------------------ the exchange
def _jax_reference(jg, name):
    """JAX's single-device logits ``[N, C]`` at the worker's weights, and the
    gradients of ``sum(logits * W)`` (the port's parameter names, and the
    features')."""
    kw = dict(HW.MODELS[name])
    cd = kw.pop("compute_dtype", None)
    port = GraphSAGE(jg.num_features, jg.num_classes, device="cpu",
                     fanouts=(None,) * len(kw["hidden_dims"]), **kw)
    tree = W.draw_params(port, HW.model_seed(name))
    params = SAGEParams(
        layers=tuple(SAGELayerParams(**{f: None if v is None else jnp.asarray(v)
                                        for f, v in p.items()}) for p in tree["layers"]),
        head=jnp.asarray(tree["head"]))
    jm = JaxGraphSAGE(in_dim=jg.num_features, num_classes=jg.num_classes,
                      fanouts=(None,) * len(kw["hidden_dims"]), matmul_precision="highest",
                      compute_dtype=None if cd is None else jnp.bfloat16, **kw)
    w = jnp.asarray(HW.cotangent(jg.num_nodes, jg.num_classes))

    def loss(p, feats):
        return (jm.forward_full_graph(p, jg.replace(features=feats)) * w).sum()

    logits = jax.jit(lambda p: jm.forward_full_graph(p, jg))(params)
    gp, gf = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jg.features)
    grads = {"head": np.asarray(gp.head)}
    for i, layer in enumerate(gp.layers):
        for f in LAYER_FIELDS:
            v = getattr(layer, f, None)
            if v is not None:
                grads[f"layers.{i}.{f}"] = np.asarray(v)
    return np.asarray(logits), grads, np.asarray(gf)


@pytest.fixture(scope="module")
def references(graphs):
    jg, _ = graphs
    with jax.default_matmul_precision("highest"):
        return {name: _jax_reference(jg, name) for name in HW.MODELS}


def _close_rel(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, f"{what}: max error {err:.3g} above {rel} x {scale:.3g}"


EXCHANGE_CASES = [(w, p, m) for w, plans in HW.PLANS.items() for p in plans for m in HW.MODELS]


@pytest.mark.parametrize("world,plan,model", EXCHANGE_CASES,
                         ids=[f"S{w}-{p}-{m}" for w, p, m in EXCHANGE_CASES])
def test_halo_exchange_matches_jax(jobs, references, world, plan, model):
    want_logits, want_grads, want_feat_grad = references[model]
    recs = jobs[world]
    for rank, rec in enumerate(recs):
        got = rec["exchange"][plan][model]
        what = f"S={world} {plan} {model} rank {rank}"
        if model == "bf16":
            _close_rel(got["logits"], want_logits, BF16_REL, what + " logits")
        else:
            np.testing.assert_allclose(got["logits"], want_logits, err_msg=what, **F32)
        rel = BF16_REL if model == "bf16" else GRAD_REL
        assert got["grads"].keys() == want_grads.keys()
        for name, g in got["grads"].items():
            _close_rel(g, want_grads[name], rel, f"{what} grad {name}")
        # The rank's feature rows, in stacked order.
        info = rec["exchange"][plan]
        np_ = info["nodes_per_shard"]
        idx = info["stacked_index"]
        mine = np.flatnonzero(idx // np_ == rank)
        feat = np.zeros_like(got["h0_grad"])
        feat[idx[mine] - rank * np_] = want_feat_grad[mine]
        _close_rel(got["h0_grad"], feat, rel, f"{what} feature grad")


@pytest.mark.parametrize("world", list(HW.PLANS))
def test_comm_stats_equal_the_estimate(jobs, graphs, world):
    _, tg = graphs
    for plan, kw in HW.PLANS[world].items():
        stats = jobs[world][0]["exchange"][plan]["comm_stats"]
        est = halo.partition_comm_rows(
            tg, world, **{k: v for k, v in kw.items() if k != "halo_chunks"})
        assert stats["rows_exchanged_per_shard"] == est["rows_exchanged_per_shard"]


# ------------------------------------------------------------- the callers
@pytest.mark.parametrize("model", ["mean", "maxpool"])
@pytest.mark.parametrize("world", list(HW.PLANS))
def test_full_graph_trainer_mesh_equals_single_device(jobs, world, model):
    for rec in jobs[world]:
        got = rec["callers"][f"train {model}"]
        np.testing.assert_allclose(got["losses"], got["single_losses"], **F32)
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, got["single_params"][name], err_msg=name, **F32)
        assert got["val"] == got["single_val"]
        np.testing.assert_array_equal(got["predict"], got["single_predict"])


@pytest.mark.parametrize("world", list(HW.PLANS))
def test_full_graph_trainer_mesh_resumes(jobs, world):
    for rank, rec in enumerate(jobs[world]):
        got = rec["callers"]["resume"]
        np.testing.assert_allclose(got["resumed"], got["straight"][2:], **F32)
        assert (got["written"] is not None) == (rank == 0)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("world", list(HW.PLANS))
def test_sharded_serving_equals_single_device(jobs, world, quantize):
    for rec in jobs[world]:
        got = rec["callers"][f"serve quantize={quantize}"]
        for what in ("logits", "embed"):
            np.testing.assert_allclose(got[what], got[f"single_{what}"], err_msg=what, **F32)
        np.testing.assert_array_equal(got["predict"], got["single_predict"])
        stats, single = got["memory_stats"], got["single_memory_stats"]
        assert stats["refresh_comm"]["num_shards"] == world
        assert stats["table_bytes_replicated_equiv"] == world * stats["table_bytes_per_chip"]
        assert stats["table_bytes_per_chip"] * world >= single["table_bytes_per_chip"]


def test_callers_raise_jax_messages(jobs, graphs):
    jg, _ = graphs
    errors = jobs[2][0]["callers"]["errors"]
    lstm = JaxGraphSAGE(in_dim=jg.num_features, num_classes=jg.num_classes, hidden_dims=(8,),
                        fanouts=(None,), aggregator="lstm")
    with pytest.raises(ValueError) as want:
        jhalo.halo_full_graph_logits(lstm, None, None, None)
    assert errors["logits lstm"] == f"ValueError: {want.value}"
    assert errors["trainer lstm"] == (
        "ValueError: FullGraphTrainer's halo mesh path supports mean and maxpool only (lstm "
        "aggregation is not a per-edge segment reduction); use the sampled trainers for lstm")
    assert errors["serve sampled"] == ("ValueError: sharded serving is table-mode only "
                                       "(sampled serving at scale is "
                                       "FullyShardedTrainer.predict)")
