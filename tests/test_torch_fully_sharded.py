"""The port's compact exchange, hub cache and fully sharded trainers
(``graphsage_torch/parallel/feature_store.py``, ``train/unsupervised.py``) on
the CPU, against the JAX package and against the port's other trainers.

Two multi-process jobs run once for the module (``tests/
torch_fully_sharded_worker.py`` over gloo, processes that import no JAX): one
of 2 ranks (the compact and dense gathers, the hub cache, the fully sharded
and compact trainers, the retry ladder, the distributed walk, the
unsupervised trainers, errors) and one of 4 (the gathers and trainers). The
routing, capacities, traffic counts, hub tables and adjacency shards are
pure functions, compared here in one process (JAX's routing under
``jax.vmap`` with a named axis, which runs its 40-shard sort route); the
retry ladder's no-op also runs here, in a world of one. JAX references run
under ``jax.jit`` with ``matmul_precision="highest"`` on the 8-device CPU
mesh. Tolerances: ``rtol = atol = 1e-5`` (f32).
"""

import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_fully_sharded_worker as FW
import torch_parallel_worker as W
from graphsage_torch import GraphSAGE, ShardedFeatureTrainer, TrainConfig
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.models.graphsage import Frontier
from graphsage_torch.parallel import feature_store as fs
from graphsage_tpu.data.synthetic import power_law_graph as jax_power_law_graph
from graphsage_tpu.models.graphsage import Frontier as JaxFrontier
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_tpu.models.graphsage import SAGEParams
from graphsage_tpu.models.layers import SAGELayerParams
from graphsage_tpu.parallel import feature_store as jfs
from graphsage_tpu.parallel.mesh import make_mesh as jax_make_mesh
from graphsage_tpu.train.config import TrainConfig as JaxTrainConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-5, atol=1e-5)
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
        [sys.executable, str(REPO / "tests" / "torch_fully_sharded_worker.py"), name, str(r),
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
def jobs(tmp_path_factory):
    return {2: _run_job("two", 2, tmp_path_factory.mktemp("fs2")),
            4: _run_job("four", 4, tmp_path_factory.mktemp("fs4"))}


@pytest.fixture(scope="module")
def graphs():
    return (jax_power_law_graph(**W.FS_GRAPH), power_law_graph(device="cpu", **W.FS_GRAPH))


@pytest.fixture(scope="module")
def world_of_one():
    from graphsage_torch.parallel import multihost
    from graphsage_torch.parallel.mesh import make_mesh

    multihost.initialize(device="cpu")
    return make_mesh({"data": 1})


def _jax_models(graph, seed: int, **kw):
    """JAX's model and the weights the worker draws for the port's model of
    the same configuration."""
    port = GraphSAGE(graph.num_features, graph.num_classes, device="cpu", **kw)
    tree = W.draw_params(port, seed)
    params = SAGEParams(
        layers=tuple(SAGELayerParams(**{f: None if v is None else jnp.asarray(v)
                                        for f, v in p.items()}) for p in tree["layers"]),
        head=jnp.asarray(tree["head"]))
    jm = JaxGraphSAGE(in_dim=graph.num_features, num_classes=graph.num_classes,
                      matmul_precision="highest", gather_impl="take", **kw)
    return jm, params


def _close_params(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **F32)


# ------------------------------------------------------------ routing
def _route_inputs(world: int, q: int, rows: int, seed: int, skew: bool):
    rng = np.random.default_rng(seed)
    hi = rows if skew else rows * world  # skew: every valid request to rank 0
    ids = rng.integers(0, hi, (world, q)).astype(np.int32)
    valid = rng.random((world, q)) < 0.7
    return ids, valid


@pytest.mark.parametrize("world,slack,skew", [(2, 1.5, False), (4, 1.5, False),
                                              (4, 0.5, True), (40, 1.5, False),
                                              (40, 1.0, True)])
def test_route_buckets_equal_jax(world, slack, skew):
    """Buckets, the composed restore index and the overflow flag of each of
    ``world`` requesters against JAX's ``_route_requests`` (under
    ``jax.vmap`` with a named axis: its all-to-all hands requester ``s``'s
    bucket ``d`` to ``d``). Masked slots spread round-robin and take bucket
    room; 40 shards take the sort route in both packages."""
    rows, q = 24, 96
    ids, valid = _route_inputs(world, q, rows, world, skew)
    cap = jfs.request_capacity(q, world, slack)

    def per(ids_l, valid_l):
        recv, ctx = jfs._route_requests("data", ids_l, rows, cap, valid_l)
        return recv, ctx.take, ctx.violated

    recv, take, violated = jax.jit(jax.vmap(per, axis_name="data"))(
        jnp.asarray(ids), jnp.asarray(valid))
    recv = np.asarray(recv)  # [owner, requester, cap]
    for s in range(world):
        req, got_take, got_violated = fs.route_buckets(
            torch.from_numpy(ids[s]), world, rows, cap, torch.from_numpy(valid[s]))
        assert bool(got_violated) == bool(violated[s])
        np.testing.assert_array_equal(got_take.numpy(), np.asarray(take[s]))
        if not bool(got_violated):  # -1 in masked and unused slots (feature_store)
            used = req.numpy() >= 0
            np.testing.assert_array_equal(req.numpy()[used], recv[:, s][used])
            assert used.sum() == valid[s].sum()
    assert bool(np.asarray(violated).any()) or not skew


def test_route_buckets_sort_route_equals_counting_route(monkeypatch):
    ids, valid = _route_inputs(8, 200, 16, 3, False)
    cap = fs.request_capacity(200, 8, 1.5)
    args = (torch.from_numpy(ids[0]), 8, 16, cap, torch.from_numpy(valid[0]))
    counted = fs.route_buckets(*args)
    monkeypatch.setattr(fs, "_RANK_SORT_MIN_SHARDS", 0)
    for a, b in zip(counted, fs.route_buckets(*args)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# --------------------------------------------------- capacities and traffic
@pytest.mark.parametrize("q,world,slack", [(2560, 8, 1.5), (7, 2, 1.5), (100, 4, 0.25),
                                           (25600, 1, 1.0), (640, 4, 4.0)])
def test_request_capacity_equals_jax(q, world, slack):
    assert fs.request_capacity(q, world, slack) == jfs.request_capacity(q, world, slack)


STATS_CASES = {
    "cora": (dict(in_dim=1433, num_classes=7, hidden_dims=(128, 128), fanouts=(10, 10)),
             dict(batch_size=256, num_shards=8, slack=1.5, fully_sharded=True)),
    "concat_self": (dict(in_dim=64, num_classes=7, hidden_dims=(16, 16), fanouts=(4, 4),
                         concat_self=True), dict(batch_size=64, num_shards=8)),
    "cached": (dict(in_dim=500, num_classes=3, hidden_dims=(128, 128), fanouts=(10, 25),
                    layer0="cached"), dict(batch_size=1024, num_shards=4,
                                           fully_sharded=True)),
    "maxpool": (dict(in_dim=64, num_classes=7, hidden_dims=(16, 16), fanouts=(5, 3),
                     aggregator="maxpool", pool_dim=8, concat_self=True),
                dict(batch_size=32, num_shards=2, slack=2.0, fully_sharded=True)),
    "narrow": (dict(in_dim=12, num_classes=2, hidden_dims=(16,), fanouts=(4,), self_loop=True),
               dict(batch_size=16, num_shards=4)),
}


@pytest.mark.parametrize("name", list(STATS_CASES))
def test_sharded_comm_stats_equal_jax(name):
    model_kw, kw = STATS_CASES[name]
    kw = dict(kw)
    port = GraphSAGE(model_kw.pop("in_dim"), model_kw.pop("num_classes"), device="cpu",
                     **model_kw)
    jm = JaxGraphSAGE(in_dim=port.in_dim, num_classes=port.head.shape[1], **model_kw)
    assert fs.sharded_comm_stats(port, **kw) == jfs.sharded_comm_stats(jm, **kw)


def test_compact_sites_equal_jax():
    """The sites' shapes against JAX's, and its layout error."""
    for kw, sizes in ((dict(fanouts=(3, 3)), (4, 12, 36)),
                      (dict(fanouts=(3, 3), concat_self=True), (4, 16, 64)),
                      (dict(fanouts=(3, 3), layer0="cached"), (4, 12))):
        port = GraphSAGE(8, 2, hidden_dims=(4, 4), device="cpu", **kw)
        jm = JaxGraphSAGE(in_dim=8, num_classes=2, hidden_dims=(4, 4), **kw)
        fr = Frontier(ids=tuple(torch.zeros(n, dtype=torch.int32) for n in sizes),
                      masks=tuple(torch.ones(n, dtype=torch.bool) for n in sizes))
        jfr = JaxFrontier(ids=tuple(np.zeros(n, np.int32) for n in sizes),
                          masks=tuple(np.ones(n, bool) for n in sizes))
        got = [tuple(i.shape) for i, _ in fs.compact_sites(port, fr)]
        assert got == [tuple(i.shape) for i, _ in jfs.compact_sites(jm, jfr)]
    port = GraphSAGE(8, 2, hidden_dims=(4, 4), fanouts=(3, 3), device="cpu")
    bad = Frontier(ids=tuple(torch.zeros(n, dtype=torch.int32) for n in (4, 12, 40)),
                   masks=tuple(torch.ones(n, dtype=torch.bool) for n in (4, 12, 40)))
    with pytest.raises(ValueError, match="does not come from"):
        fs.compact_sites(port, bad)


# ----------------------------------------------------------- hub cache
def test_hub_cache_tables_equal_jax(graphs):
    jg, tg = graphs
    lookup, rows = fs.build_hub_cache(tg.features, tg.degrees, FW.HUB_ROWS)
    j_lookup, j_rows = jfs.build_hub_cache(np.asarray(jg.features), np.asarray(jg.degrees),
                                           FW.HUB_ROWS)
    np.testing.assert_array_equal(lookup.numpy(), j_lookup)
    np.testing.assert_array_equal(rows.numpy(), j_rows)
    for h in (1, 8, 50, 200):
        assert fs.hub_request_fraction(tg.degrees, h) == jfs.hub_request_fraction(
            np.asarray(jg.degrees), h)
    with pytest.raises(ValueError, match=r"num_hub_rows must be in \(0, 200\]"):
        fs.build_hub_cache(tg.features, tg.degrees, 0)


HUB_ERRORS = {
    "dense": (dict(hidden_dims=(8, 8), fanouts=(4, 4), project_first=False),
              dict(gather_mode="dense")),
    "project_first": (dict(hidden_dims=(8, 8), fanouts=(4, 4)), dict(gather_mode="compact")),
    "cached_concat_self": (dict(hidden_dims=(8, 8), fanouts=(4, 4), layer0="cached",
                                concat_self=True), dict(gather_mode="compact")),
}


@pytest.mark.parametrize("name", list(HUB_ERRORS))
def test_hub_cache_errors_are_jax(graphs, world_of_one, name):
    jg, tg = graphs
    model_kw, kw = HUB_ERRORS[name]
    jm, _ = _jax_models(jg, 0, **model_kw)
    with pytest.raises(ValueError) as want:
        jfs.ShardedFeatureTrainer(jm, jg, JaxTrainConfig(**W.TRAIN), jax_make_mesh({"data": 1}),
                                  hub_cache_rows=8, **kw)
    with pytest.raises(ValueError) as got:
        ShardedFeatureTrainer(W._model(tg, **model_kw), tg, TrainConfig(**W.TRAIN),
                              world_of_one, hub_cache_rows=8, **kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- adjacency shards
@pytest.mark.parametrize("world", [2, 3, 8])
def test_shard_adjacency_equals_jax(graphs, world):
    jg, tg = graphs
    want = jfs.shard_adjacency(jg, world)
    for s in range(world):
        got = fs.shard_adjacency(tg, world, s)
        for name in ("ell", "degrees", "indptr", "edge_dst"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name))[s], err_msg=name)
        assert (got.rows_per_shard, got.ell_covers_all) == (want.rows_per_shard,
                                                            want.ell_covers_all)
        assert got.memory_stats() == want.memory_stats()


def test_owner_generator_is_a_function_of_seed_step_rank():
    draw = lambda *a: torch.rand(4, generator=fs.owner_generator("cpu", *a))  # noqa: E731
    assert torch.equal(draw(1, 5, 0), draw(1, 5, 0))
    assert not torch.equal(draw(1, 5, 0), draw(1, 5, 1))
    assert not torch.equal(draw(1, 5, 0), draw(1, 6, 0))


# ------------------------------------------------------- compact gathers
def _jax_compact(jg, world: int, hub=None):
    """JAX's compact rows and ``masked_mean`` of them on each rank's
    requests, and the gradients of ``sum(mean * w)`` and of half the valid
    rows' sum of squares (a masked slot's row is padding: the port sends
    no cotangent back for it, JAX adds its cotangent onto the row its slot
    was spread to)."""
    from graphsage_tpu.ops.aggregate import masked_mean

    mesh = jax_make_mesh({"data": world})
    shards = jfs.shard_features(jg.features, world).shards
    idx, mask, w = (jnp.asarray(a) for a in FW.gather_inputs(world, jg.num_nodes,
                                                             jg.num_features))
    g_fn, _ = jfs.make_sharded_gather_fns("data", "compact", num_shards=world, slack=1.5)
    if hub is not None:
        g_fn, _ = jfs._hub_wrap_gather_fns(g_fn, None, tuple(jnp.asarray(a) for a in hub))

    def run(s):
        def per(shard, i, m, w_l):
            rows = g_fn(shard[0], i[0], m[0])
            mean = masked_mean(rows, m[0])
            return (mean[None], rows[None], (mean * w_l[0]).sum()[None],
                    ((rows * rows * m[0][..., None]).sum() / 2)[None])

        return shard_map(per, mesh=mesh, in_specs=(P("data"),) * 4,
                         out_specs=(P("data"),) * 4)(s, idx, mask, w)

    mean, rows, _, _ = jax.jit(run)(shards)
    mean_grad = jax.jit(jax.grad(lambda s: run(s)[2].sum()))(shards)
    rows_grad = jax.jit(jax.grad(lambda s: run(s)[3].sum()))(shards)
    return [np.asarray(a) for a in (mean, rows, mean_grad, rows_grad)]


@pytest.mark.parametrize("world", [2, 4])
def test_compact_gather_and_gradients_equal_jax(graphs, jobs, world):
    jg, _ = graphs
    mean, rows, mean_grad, rows_grad = _jax_compact(jg, world)
    for r, rank in enumerate(jobs[world]):
        got = rank["compact"]
        np.testing.assert_allclose(got["mean"], mean[r], **F32)
        np.testing.assert_allclose(got["rows"], rows[r], **F32)
        np.testing.assert_allclose(got["mean_grad"], mean_grad[r], **F32)
        np.testing.assert_allclose(got["rows_grad"], rows_grad[r], **F32)


@pytest.mark.parametrize("world", [2, 4])
def test_compact_gather_equals_the_dense_exchange(jobs, world):
    for rank in jobs[world]:
        got = rank["compact"]
        np.testing.assert_allclose(got["mean"], got["dense_mean"], **F32)
        np.testing.assert_allclose(got["mean_grad"], got["dense_grad"], **F32)


@pytest.mark.parametrize("world", [2, 4])
def test_hub_cache_gather_equals_jax_and_the_routed_one(graphs, jobs, world):
    """With 8 hub rows: JAX's ``masked_mean(where(is_hub, cached, routed))``
    and the port's one pass over the answer buffer; both equal the gather
    without the cache on every valid slot (the table is frozen; a masked
    slot naming a hub reads the hub row, not its spread slot's)."""
    jg, tg = graphs
    hub = fs.build_hub_cache(tg.features, tg.degrees, FW.HUB_ROWS)
    mean, rows, _, _ = _jax_compact(jg, world, hub=tuple(t.numpy() for t in hub))
    _, mask, _ = FW.gather_inputs(world, jg.num_nodes, jg.num_features)
    for r, rank in enumerate(jobs[world]):
        got = rank["compact"]
        np.testing.assert_allclose(got["hub_mean"], mean[r], **F32)
        np.testing.assert_array_equal(got["hub_rows"], rows[r])
        np.testing.assert_array_equal(got["hub_rows"][mask[r]], got["rows"][mask[r]])
        np.testing.assert_allclose(got["hub_mean"], got["mean"], **F32)


# ------------------------------------------------------------- trainers
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["sampled", "cached"])
def test_fully_sharded_equals_node_sharded_at_covering_fanouts(jobs, world, name):
    """Covering fanouts: sampling at the owners is deterministic, so the
    fully sharded trainer takes the node-sharded trainer's steps, and its
    distributed evaluation gives the replicated sampled evaluation's
    predictions."""
    for rank in jobs[world]:
        rec = rank["fully"][name]
        np.testing.assert_allclose(rec["losses"], rec["node_losses"], **F32)
        _close_params(rec["params"], rec["node_params"])
        np.testing.assert_array_equal(rec["preds"], rec["node_preds"])
        stats = rec["memory_stats"]
        assert stats["num_shards"] == world and stats["adjacency_bytes_per_chip"] > 0
        assert rec["adjacency_rows"] == stats["rows_per_shard"]


def test_fully_sharded_losses_equal_jax(graphs, jobs):
    """JAX's FullyShardedTrainer on a 2-device mesh at covering fanouts,
    with the same weights and batches."""
    jg, tg = graphs
    cover = FW.covering_fanout(tg)
    jm, params = _jax_models(jg, 0, hidden_dims=(8, 8), fanouts=(cover, cover))
    tr = jfs.FullyShardedTrainer(jm, jg, JaxTrainConfig(**W.TRAIN), jax_make_mesh({"data": 2}),
                                 capacity_slack=FW.SLACK)
    state = tr.init_state()
    state = state.replace(params=params, opt_state=tr.tx.init(params))
    it = tr.batches()
    want = []
    for _ in range(W.TRAIN["num_steps"]):
        state, loss = tr.step(state, next(it))
        want.append(float(loss))
    for rank in jobs[2]:
        np.testing.assert_allclose(rank["fully"]["sampled"]["losses"], want, **F32)


@pytest.mark.parametrize("world", [2, 4])
def test_compact_trainer_equals_single_device(jobs, world):
    for rank in jobs[world]:
        rec = rank["fully"]["compact"]
        np.testing.assert_allclose(rec["losses"], rec["single_losses"], **F32)
        _close_params(rec["params"], rec["single_params"])


def test_fully_sharded_errors(jobs):
    errors = jobs[2][0]["errors"]
    assert errors["topk"] == (
        "ValueError: FullyShardedTrainer samples through the owner-side CSR slice; "
        "method='topk' is ELL-only — use 'floyd' (exact) or 'windowed'")
    assert errors["layer0_full"] == (
        "ValueError: layer0_exchange='halo' is ShardedFeatureTrainer-only: the halo plan "
        "is a second edge copy, which FullyShardedTrainer exists to avoid (it derives "
        "layer-0 edges from its sharded adjacency)")


# ------------------------------------------------------------ the ladder
def test_ladder_across_two_ranks(jobs):
    """Slack 0.25 overflows on some rank at every step: no rank applies the
    step, and the redone steps equal the default slack's."""
    for rank in jobs[2]:
        rec = rank["ladder"]
        np.testing.assert_allclose(rec["losses"], rec["ref_losses"], **F32)
        _close_params(rec["params"], rec["ref_params"])
        assert rec["step_count"] == W.TRAIN["num_steps"]
        assert rec["warnings"] and len(rec["warnings"]) % W.TRAIN["num_steps"] == 0
        assert all("(step NOT applied)" in w for w in rec["warnings"])


def _compact_trainer(tg, mesh, slack):
    return ShardedFeatureTrainer(W._model(tg, hidden_dims=(8, 8), fanouts=(4, 4)), tg,
                                 TrainConfig(**W.TRAIN), mesh, gather_mode="compact",
                                 capacity_slack=slack)


def _snapshot(tr):
    return {k: v.clone() for k, v in tr.state_dict().items()}


def test_violated_step_is_a_no_op_and_redone_on_the_same_frontier(graphs, world_of_one):
    """In a world of one every request goes to rank 0, so slacks 0.25 and
    0.5 overflow and 1.0 fits: the overflowing attempts change no parameter,
    optimizer slot, step count or generator state; the step is redone on
    the same frontier and equals the default slack's."""
    _, tg = graphs
    tr = _compact_trainer(tg, world_of_one, 0.25)
    frontiers = []
    sample = tr.model.sample
    tr.model.sample = lambda *a, **k: frontiers.append(sample(*a, **k)) or frontiers[-1]
    seeds = next(tr.batches())
    ids = torch.from_numpy(seeds)
    before = _snapshot(tr)
    assert tr._attempt(ids, 0.25) is None
    for k, v in tr.state_dict().items():
        if k != "key":
            assert torch.equal(v, before[k]), k
    tr.generator.set_state(before["key"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loss = float(tr.step(seeds))
    assert [str(w.message).split(" (")[0] for w in caught] == [
        "sharded request capacity exceeded at slack=0.25",
        "sharded request capacity exceeded at slack=0.5"]
    assert len(frontiers) == 4
    for fr in frontiers[1:]:
        for a, b in zip(fr.ids + fr.masks, frontiers[0].ids + frontiers[0].masks):
            assert torch.equal(a, b)
    ref = _compact_trainer(tg, world_of_one, 1.5)
    np.testing.assert_allclose(loss, float(ref.step(seeds)), **F32)
    _close_params(W._params(tr.model), W._params(ref.model))
    assert tr.step_count == ref.step_count == 1


def test_exhausted_ladder_raises_and_applies_nothing(graphs, world_of_one):
    _, tg = graphs
    tr = _compact_trainer(tg, world_of_one, 0.01)
    before = _snapshot(tr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match=r"still exceeded after retries up to slack=0\.08"):
            tr.step(next(tr.batches()))
    for k, v in tr.state_dict().items():
        if k != "key":
            assert torch.equal(v, before[k]), k


# ---------------------------------------------------------- walks, unsup
def test_distributed_walk_equals_random_walk_on_out_degree_one(jobs):
    for rank in jobs[2]:
        rec = rank["walk"]
        assert not rec["violated"]
        np.testing.assert_array_equal(rec["walks"], rec["want_walks"])
        np.testing.assert_array_equal(rec["valid"], rec["want_valid"])


@pytest.mark.parametrize("mode", ["dense", "compact"])
def test_unsupervised_sharded_equals_single_device(jobs, mode):
    for rank in jobs[2]:
        rec = rank["unsup"]
        np.testing.assert_allclose(rec[mode], rec["single"], **F32)
        assert rec["sharded_preds"].shape == (W.TRAIN["val_size"],)


def test_unsupervised_fully_sharded_trains(jobs):
    losses = [np.asarray(rank["unsup"]["fully"]) for rank in jobs[2]]
    np.testing.assert_array_equal(losses[0], losses[1])  # the batch's loss, on every rank
    assert np.isfinite(losses[0]).all()
    assert losses[0][-3:].mean() < losses[0][:3].mean() - 0.3
    assert jobs[2][0]["unsup"]["fully_slack"] == 4.0
    np.testing.assert_array_equal(jobs[2][0]["unsup"]["fully_preds"],
                                  jobs[2][1]["unsup"]["fully_preds"])
