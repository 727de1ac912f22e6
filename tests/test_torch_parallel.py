"""The port's parallel training (``graphsage_torch/parallel/``) on the CPU
over gloo, against the JAX package on its 8-device CPU mesh and against the
single-device port.

Two multi-process jobs run once for the module (``tests/
torch_parallel_worker.py``, spawned as plain processes that import no JAX):
one of 2 ranks (the edge-partitioned SpMM and full-graph logits, the
sharded row gather, ``ShardedFeatureTrainer``, ``run_preset(mode=
"sharded")`` and the errors) and one of 4 (the SpMM at 4 ranks and
``ShardedTrainer`` on a ``{"data": 2, "model": 2}`` mesh). Each rank writes
what it computed to a file; the tests compare it here, where the JAX
references run under ``jax.jit`` with ``matmul_precision="highest"``, the
same graphs built from the same seeds and the same weights carried across
as numpy (``graphsage_torch/convert.py``).

Tolerances: f32 results within ``rtol = atol = 1e-5``; bf16 ones within
2e-2 of the result's largest entry (PyTorch's bf16 products return bf16,
JAX keeps f32 until its cast; the sharded sums also add in another order).
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
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_parallel_worker as W
from graphsage_torch import GraphSAGE, run_preset
from graphsage_torch.data.synthetic import power_law_graph, synth_cora_files
from graphsage_torch.parallel.partition import partition_edges, partition_stats
from graphsage_tpu.data.synthetic import power_law_graph as jax_power_law_graph
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_tpu.models.graphsage import SAGEParams
from graphsage_tpu.models.layers import SAGELayerParams
from graphsage_tpu.parallel import distributed as jd
from graphsage_tpu.parallel import feature_store as jfs
from graphsage_tpu.parallel.mesh import make_mesh as jax_make_mesh
from graphsage_tpu.parallel.partition import partition_edges as jax_partition_edges
from graphsage_tpu.parallel.partition import partition_stats as jax_partition_stats
from graphsage_tpu.train.config import TrainConfig as JaxTrainConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_OF_MAX = 2e-2
JOB_TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _run_job(name: str, world: int, out: Path, *extra: str) -> list[dict]:
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_parallel_worker.py"), name, str(r),
         str(world), port, str(out), *extra],
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
def cora_root(tmp_path_factory):
    return synth_cora_files(tmp_path_factory.mktemp("cora"), num_nodes=400, num_feats=64,
                            num_edges=900, seed=0)


@pytest.fixture(scope="module")
def job2(tmp_path_factory, cora_root):
    return _run_job("two", 2, tmp_path_factory.mktemp("job2"), str(cora_root))


@pytest.fixture(scope="module")
def job4(tmp_path_factory):
    return _run_job("four", 4, tmp_path_factory.mktemp("job4"))


@pytest.fixture(scope="module")
def graphs():
    """``{"dist": (jax, port), "fs": (jax, port)}``: the same graph from the
    same seed in both packages."""
    return {"dist": (jax_power_law_graph(**W.DIST_GRAPH),
                     power_law_graph(device="cpu", **W.DIST_GRAPH)),
            "fs": (jax_power_law_graph(**W.FS_GRAPH),
                   power_law_graph(device="cpu", **W.FS_GRAPH))}


def _jax_params(tree: dict) -> SAGEParams:
    return SAGEParams(
        layers=tuple(SAGELayerParams(**{f: None if v is None else jnp.asarray(v)
                                        for f, v in p.items()}) for p in tree["layers"]),
        head=jnp.asarray(tree["head"]))


def _models(graph, seed: int, **kw):
    """JAX's model and its parameters, the weights the worker draws for the
    port's model of the same configuration."""
    port = GraphSAGE(graph.num_features, graph.num_classes, device="cpu", **kw)
    jax_kw = {k: v for k, v in kw.items() if k != "compute_dtype"}
    jm = JaxGraphSAGE(in_dim=graph.num_features, num_classes=graph.num_classes,
                      matmul_precision="highest", gather_impl="take", **jax_kw)
    return jm, _jax_params(W.draw_params(port, seed))


def _close_params(got: dict, want: dict, **tol) -> None:
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **(tol or F32))


# ------------------------------------------------------------- partition
@pytest.mark.parametrize("num_shards", [2, 3, 8])
def test_partition_equals_jax(graphs, num_shards):
    jg, tg = graphs["dist"]
    got, want = partition_edges(tg, num_shards), jax_partition_edges(jg, num_shards)
    for name in ("edge_src", "edge_dst", "edge_mask"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))
    assert got.num_shards == num_shards
    assert partition_stats(tg, num_shards) == jax_partition_stats(jg, num_shards)


# --------------------------------------------------- edge-partitioned SpMM
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_spmm_mean_and_gradient_equal_jax(graphs, job2, job4, world):
    jg, _ = graphs["dist"]
    ranks = job2 if world == 2 else job4
    mesh = jax_make_mesh({"graph": world})
    part = jax_partition_edges(jg, world)
    w = jnp.asarray(W.spmm_weights(jg.num_nodes, jg.num_features))
    f = jax.jit(lambda x: jd.sharded_spmm_mean(mesh, "graph", x, part, jg.num_nodes))
    (mean, count), vjp = jax.vjp(f, jg.features)
    (grad,) = vjp((w, jnp.zeros_like(count)))
    for rank in ranks:
        got = rank["spmm"]
        np.testing.assert_allclose(got["mean"], np.asarray(mean), **F32)
        np.testing.assert_array_equal(got["count"], np.asarray(count))
        np.testing.assert_allclose(got["grad"], np.asarray(grad), **F32)


@pytest.mark.parametrize("case", W.FULL_GRAPH_CASES, ids=lambda c: f"{c[0]}-self_loop={c[1]}")
def test_distributed_full_graph_logits_equal_jax(graphs, job2, case):
    jg, _ = graphs["dist"]
    agg, self_loop = case
    kw = dict(hidden_dims=(8, 8), fanouts=(None, None), aggregator=agg, self_loop=self_loop)
    if agg == "maxpool":
        kw.update(pool_dim=8, concat_self=not self_loop)
    jm, params = _models(jg, 10 + W.FULL_GRAPH_CASES.index(case), **kw)
    want = jax.jit(lambda p: jd.distributed_full_graph_logits(
        jm, p, jg, jax_make_mesh({"graph": 2})))(params)
    for rank in job2:
        got = rank["full_graph"][case]
        np.testing.assert_allclose(got["logits"], np.asarray(want), **F32)
        # The sharded SpMM's and segment max's backward against the
        # single-device forward's, each leaf within 1e-5 of its largest entry.
        for name, g in got["grads"].items():
            ref = got["local_grads"][name]
            assert np.abs(g - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0), name


def test_lstm_full_graph_raises_jax_message(graphs):
    from graphsage_torch.parallel.distributed import distributed_full_graph_logits

    _, tg = graphs["dist"]
    model = GraphSAGE(tg.num_features, tg.num_classes, hidden_dims=(8,), fanouts=(None,),
                      aggregator="lstm", device="cpu")
    with pytest.raises(ValueError, match="supports mean and maxpool only"):
        distributed_full_graph_logits(model, tg, mesh=None)


# ------------------------------------------------------ node-sharded store
def test_sharded_row_gather_and_its_gradient_equal_jax(graphs, job2):
    """tests/test_feature_store.py:35 and :52 on a 2-device mesh: the rows,
    and the gradient of half their sum of squares, a scatter-add into the
    owners' shards."""
    jg, _ = graphs["fs"]
    mesh = jax_make_mesh({"data": 2})
    fs = jfs.shard_features(jg.features, 2)
    ids = jnp.asarray(W.gather_ids(2, jg.num_nodes))

    def per_rank(shards):
        def f(shard, ids_local):
            rows = jfs.sharded_row_gather("data", shard[0], ids_local[0])
            return rows[None], ((rows * rows).sum() / 2)[None]

        return shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                         out_specs=(P("data"), P("data")))(shards, ids)

    rows = jax.jit(lambda s: per_rank(s)[0])(fs.shards)
    grad = jax.jit(jax.grad(lambda s: per_rank(s)[1].sum()))(fs.shards)
    for r, rank in enumerate(job2):
        np.testing.assert_allclose(rank["row_gather"]["rows"], np.asarray(rows[r]), **F32)
        np.testing.assert_allclose(rank["row_gather"]["grad"], np.asarray(grad[r]), **F32)


def test_each_rank_holds_its_rows_and_memory_stats_equal_jax(graphs, job2):
    jg, _ = graphs["fs"]
    want = jfs.shard_features(jg.features, 2).memory_stats()
    np_ = want["rows_per_shard"]
    assert np_ == 104  # round_up(ceil(200 / 2), 8)
    for rank in job2:
        assert rank["row_gather"]["shard_rows"] == np_
        assert rank["row_gather"]["memory_stats"] == want
        for key, rec in rank["feature_trainer"].items():
            if key == "bf16":
                continue
            assert rec["shard_rows"] == np_
            cached = key[0] == "cached"
            assert rec["cache_rows"] == (np_ if cached else None)
            stats = rec["memory_stats"]
            assert {k: stats[k] for k in ("num_shards", "rows_per_shard",
                                          "memory_reduction")} == {
                k: want[k] for k in ("num_shards", "rows_per_shard", "memory_reduction")}
            factor = 2 if cached else 1  # the cache is a second table of the same shape
            assert stats["feature_bytes_per_chip"] == factor * want["feature_bytes_per_chip"]
            assert stats["feature_bytes_replicated"] == factor * want["feature_bytes_replicated"]


# ---------------------------------------------------- ShardedFeatureTrainer
@pytest.mark.parametrize("name", list(W.FEATURE_CASES))
def test_feature_trainer_steps_equal_single_device(job2, name):
    """Three steps at fanouts (4, 4) against the single-device Trainer with
    the same seed: the same frontiers, batches and weights."""
    for rank in job2:
        rec = rank["feature_trainer"][(name, (4, 4))]
        np.testing.assert_allclose(rec["losses"], rec["single_losses"], **F32)
        _close_params(rec["params"], rec["single_params"])


@pytest.mark.parametrize("name", W.JAX_FEATURE_CASES)
def test_feature_trainer_losses_equal_jax_at_covering_fanouts(graphs, job2, name):
    """Fanouts ``None`` (every neighbour): the frontiers are deterministic,
    so JAX's ShardedFeatureTrainer on a 2-device mesh takes the same steps."""
    jg, _ = graphs["fs"]
    kw = dict(hidden_dims=(8, 8), fanouts=(None, None), **W.FEATURE_CASES[name])
    jm, params = _models(jg, 0, **kw)
    tr = jfs.ShardedFeatureTrainer(jm, jg, JaxTrainConfig(**W.TRAIN), jax_make_mesh({"data": 2}))
    state = tr.init_state()
    state = state.replace(params=params, opt_state=tr.tx.init(params))
    it = tr.batches()
    want = []
    for _ in range(W.TRAIN["num_steps"]):
        state, loss = tr.step(state, next(it))
        want.append(float(loss))
    for rank in job2:
        np.testing.assert_allclose(rank["feature_trainer"][(name, (None, None))]["losses"],
                                   want, **F32)


def test_feature_trainer_bf16_within_its_tolerance(job2):
    rec = job2[0]["feature_trainer"]["bf16"]
    assert rec["shard_dtype"] == "torch.bfloat16"
    losses, ref = np.asarray(rec["losses"]), np.asarray(rec["single_losses"])
    assert np.abs(losses - ref).max() <= BF16_OF_MAX * np.abs(ref).max()
    for name, want in rec["single_params"].items():
        assert np.abs(rec["params"][name] - want).max() <= BF16_OF_MAX * np.abs(want).max()


def test_run_preset_sharded_matches_single_device_step_for_step(job2):
    """``run_preset("cora", mode="sharded")`` under the 2-rank job against
    the single-device run: losses, parameters and validation F1."""
    for rank in job2:
        rec = rank["run_preset"]
        np.testing.assert_allclose(rec["losses"], rec["single_losses"], **F32)
        _close_params(rec["params"], rec["single_params"])
        assert rec["val"] == rec["single_val"]
    assert [r["primary"] for r in job2] == [True, False]
    assert [r["info"]["process_index"] for r in job2] == [0, 1]
    assert all(r["info"]["process_count"] == r["info"]["global_devices"] == 2 for r in job2)


def test_run_preset_sharded_in_a_world_of_one(cora_root):
    over = {"num_steps": 3, "batch_size": 32, "test_size": 100, "val_size": 80}
    lines = []
    sharded = run_preset("cora", str(cora_root), log=lines.append, mode="sharded",
                         device="cpu", overrides=over)
    single = run_preset("cora", str(cora_root), log=None, device="cpu", overrides=over)
    np.testing.assert_allclose(sharded["losses"], single["losses"], **F32)
    assert lines[0].startswith("sharded over 1 device(s): ")


def test_sharded_layer0_order_is_the_single_device_rule(graphs):
    """A world of one takes the single device's layer-0 order: at 8 seeds
    (128 slots against 200 rows of width 48) both aggregate first, though
    layer 0 shrinks its width; exchanged rows count like gathered slots."""
    from graphsage_torch import ShardedFeatureTrainer, TrainConfig, Trainer
    from graphsage_torch.parallel import multihost
    from graphsage_torch.parallel.mesh import make_mesh

    multihost.initialize(device="cpu")
    _, tg = graphs["fs"]
    cfg = TrainConfig(**{**W.TRAIN, "batch_size": 8})
    picked = {}
    for kind in ("single", "sharded"):
        model = GraphSAGE(tg.num_features, tg.num_classes, hidden_dims=(8, 8),
                          fanouts=(4, 4), device="cpu")
        rule, seen = model.sampled_layer0_project_first, picked.setdefault(kind, [])
        model.sampled_layer0_project_first = lambda *a, rule=rule, seen=seen: (
            seen.append(rule(*a)) or seen[-1])
        tr = (Trainer(model, tg, cfg) if kind == "single" else
              ShardedFeatureTrainer(model, tg, cfg, make_mesh({"data": 1})))
        tr.step(next(tr.batches()))
    assert picked["single"] == picked["sharded"] == [False]
    assert not rule(200, 128)
    assert rule(200, 128, exchanged_rows=400)


# ------------------------------------------------------------ ShardedTrainer
@pytest.mark.parametrize("name", list(W.TP_CASES))
def test_sharded_trainer_dp_tp_equals_single_device(job4, name):
    """``{"data": 2, "model": 2}``: JAX's test_sharded_trainer_tp_parity_
    when_dims_collide (F = hidden = 16) and its cached-layer-0 case, and the
    max-pool layer 0, three steps against the single-device Trainer."""
    for rank in job4:
        rec = rank["tp"][name]
        np.testing.assert_allclose(rec["losses"], rec["single_losses"], **F32)
        _close_params(rec["params"], rec["single_params"])
        assert rec["val"] == rec["single_val"]
        assert rec["feature_cols"] == W.DIST_GRAPH["num_feats"] // 2
        assert rec["cache"] == (name == "cached")


@pytest.mark.parametrize("name", list(W.TP_CASES))
def test_sharded_trainer_dp_tp_losses_equal_jax_at_covering_fanouts(graphs, job4, name):
    """Fanouts ``None`` (deterministic frontiers): the 4-rank job's
    ``{"data": 2, "model": 2}`` steps against JAX's ShardedTrainer on a 2 x 2
    mesh with the same weights, which holds the tensor-parallel layer 0
    (mean, cached, max-pool) to JAX's."""
    jg, _ = graphs["dist"]
    kw = {**W.TP_CASES[name], "fanouts": (None, None)}
    jm, params = _models(jg, 0, **kw)
    tr = jd.ShardedTrainer(jm, jg, JaxTrainConfig(**W.TRAIN),
                           jax_make_mesh({"data": 2, "model": 2}))
    state = tr.init_state()
    state = jax.device_put(state.replace(params=params, opt_state=tr.tx.init(params)),
                           tr._state_shardings(state))
    it = tr.batches()
    want = []
    for _ in range(W.TRAIN["num_steps"]):
        state, loss = tr.step(state, next(it))
        want.append(float(loss))
    for rank in job4:
        np.testing.assert_allclose(rank["tp"][(name, (None, None))], want, **F32)


# ------------------------------------------------------------------ errors
@pytest.mark.parametrize("key,match", [
    ("indivisible", "ValueError: batch_size 31 must be divisible by the 'data' axis size 2"),
    ("run_preset_indivisible",
     "ValueError: batch_size 31 is not divisible by the 2 visible devices; pass --batch-size"),
    ("compact", "ValueError: hub_cache_rows only affects the compact exchange "
                r"\(the dense psum_scatter is exact for any skew\)"),
    ("hub_cache_rows", "ValueError: hub_cache_rows requires a frozen gather table: the "
                       "injected project-first and layer0='full' modes gather"),
    ("layer0_full", "ValueError: unknown layer0_exchange 'ring'"),
    ("int8", "ValueError: hub_cache_rows requires a frozen gather table: the "
             "injected project-first and layer0='full' modes gather"),
    ("feature_store", "ValueError: feature_store covers 199 nodes, graph has 200"),
])
def test_feature_trainer_errors(job2, key, match):
    import re

    assert re.fullmatch(match + ".*", job2[0]["errors"][key]), job2[0]["errors"][key]


def test_sharded_trainer_rejects_indivisible_batch(job4):
    assert job4[0]["tp"]["indivisible"] == (
        "ValueError: batch_size 31 must divide over data axis size 2")


def test_run_preset_fully_sharded_in_a_world_of_one(cora_root):
    """``mode="fully-sharded"`` trains the preset through
    ``FullyShardedTrainer`` (the adjacency sharded, each hop sampled at its
    owner) in a world of one over gloo."""
    from graphsage_torch.parallel.feature_store import FullyShardedTrainer

    over = {"num_steps": 3, "batch_size": 32, "test_size": 100, "val_size": 80}
    lines = []
    res = run_preset("cora", str(cora_root), log=lines.append, mode="fully-sharded",
                     device="cpu", overrides=over)
    assert isinstance(res["trainer"], FullyShardedTrainer)
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert 0.0 <= res["val_micro_f1"] <= 1.0
    assert lines[0].startswith("fully-sharded over 1 device(s): ")


# --------------------------------------------------------------- multihost
def test_initialize_without_environment_is_a_world_of_one():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    code = ("from graphsage_torch.parallel import multihost as m\n"
            "a = m.initialize(device='cpu'); b = m.initialize(device='cpu')\n"
            "print(a == b, a, m.is_primary(), m.device())")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[0] == (
        "True {'process_index': 0, 'process_count': 1, 'local_devices': 1, "
        "'global_devices': 1} True cpu")
