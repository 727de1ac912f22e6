"""The port's ServingEngine: the table tier against the JAX engine with
weights carried across, the sampled tier's per-request determinism and its
agreement with the table tier at covering fanouts, bucket padding, refresh
and request checks."""

import copy

import jax
import numpy as np
import pytest
import torch

from graphsage_tpu.data.synthetic import synthetic_pubmed_graph as jax_synthetic_pubmed
from graphsage_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from graphsage_tpu.serve import ServingEngine as JaxServingEngine
from graphsage_torch import GraphSAGE, ServingEngine, params_from_numpy
from graphsage_torch.data.synthetic import synthetic_pubmed_graph

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
GRAPH = dict(num_nodes=180, num_feats=36, num_edges=400, num_classes=3, seed=1)


@pytest.fixture(scope="module")
def setup():
    jg = jax_synthetic_pubmed(**GRAPH)
    tg = synthetic_pubmed_graph(device="cpu", **GRAPH)
    jm = JaxGraphSAGE(in_dim=GRAPH["num_feats"], num_classes=GRAPH["num_classes"],
                      hidden_dims=(16, 16), fanouts=(3, 5),
                      matmul_precision="highest")
    params = jm.init(jax.random.PRNGKey(4))
    tm = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], (16, 16), (3, 5),
                   device="cpu")
    params_from_numpy(tm, {
        "layers": [{"weight": np.asarray(p.weight)} for p in params.layers],
        "head": np.asarray(params.head)})
    return jg, tg, jm, params, tm


def test_table_tier_matches_jax(setup):
    jg, tg, jm, params, tm = setup
    jeng = JaxServingEngine(jm, jg, params, batch_buckets=(64,))
    teng = ServingEngine(tm, tg, batch_buckets=(64,), device="cpu")
    nodes = np.arange(tg.num_nodes)
    np.testing.assert_allclose(teng.logits(nodes), jeng.logits(nodes), **TOL)
    np.testing.assert_allclose(teng.embed(nodes), jeng.embed(nodes), **TOL)
    np.testing.assert_allclose(teng.table.numpy(), np.asarray(jeng.table), **TOL)
    agree = (teng.predict(nodes) == jeng.predict(nodes)).mean()
    assert agree > 0.98  # near-tied logits may flip within the tolerance


def test_sampled_tier_deterministic_and_covering_parity(setup):
    _, tg, _, _, tm = setup
    max_deg = int(tg.degrees.max())
    eng_s = ServingEngine(tm, tg, mode="sampled", batch_buckets=(64,),
                          eval_fanouts=(max_deg, max_deg), device="cpu")
    nodes = np.arange(64)
    a, b = eng_s.logits(nodes), eng_s.logits(nodes)
    np.testing.assert_array_equal(a, b)  # re-seeded per request
    eng_t = ServingEngine(tm, tg, batch_buckets=(64,), device="cpu")
    np.testing.assert_allclose(a, eng_t.logits(nodes), **TOL)


def test_sampled_tier_below_covering_fanouts(setup):
    _, tg, _, _, tm = setup
    nodes = np.arange(0, 120, 3)
    eng = ServingEngine(tm, tg, mode="sampled", batch_buckets=(64,), seed=3,
                        device="cpu")
    a = eng.logits(nodes)
    np.testing.assert_array_equal(a, eng.logits(nodes))
    assert a.shape == (len(nodes), tg.num_classes) and np.isfinite(a).all()
    other = ServingEngine(tm, tg, mode="sampled", batch_buckets=(64,), seed=4,
                          device="cpu")
    assert not np.array_equal(a, other.logits(nodes))  # another sampling stream
    assert eng.memory_stats() == {"mode": "sampled", "buckets": (64,)}


def test_bucket_padding_and_repeats(setup):
    _, tg, _, _, tm = setup
    eng = ServingEngine(tm, tg, batch_buckets=(16, 64), device="cpu")
    whole = eng.logits(np.arange(tg.num_nodes))
    # Below, between and beyond the buckets (beyond -> multiple of 64), with
    # repeated ids: rows do not depend on the padding.
    for ids in ([3], [7, 7, 7], list(range(40)), list(range(150))):
        got = eng.logits(np.asarray(ids))
        assert got.shape == (len(ids), tg.num_classes)
        np.testing.assert_allclose(got, whole[np.asarray(ids)], rtol=1e-6, atol=1e-6)
    assert eng._pad([1, 2])[0].shape == (16,)
    assert eng._pad(np.arange(65))[0].shape == (128,)


def test_refresh_swaps_parameters(setup):
    _, tg, _, _, tm = setup
    model = copy.deepcopy(tm)
    eng = ServingEngine(model, tg, batch_buckets=(32,), device="cpu")
    before = eng.logits(np.arange(32))
    saved = copy.deepcopy(model.state_dict())
    fresh = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], (16, 16), (3, 5),
                      device="cpu", generator=torch.Generator().manual_seed(99))
    eng.refresh(fresh.state_dict())
    assert not np.allclose(before, eng.logits(np.arange(32)))
    eng.refresh(saved)
    np.testing.assert_allclose(eng.logits(np.arange(32)), before, rtol=1e-6, atol=1e-6)


def test_memory_stats_and_request_checks(setup):
    _, tg, _, _, tm = setup
    eng = ServingEngine(tm, tg, device="cpu")
    stats = eng.memory_stats()
    assert stats["table_bytes_per_chip"] == tg.num_nodes * 16 * 4
    assert stats["buckets"] == (256, 1024)
    for bad in ([], [-1], [tg.num_nodes]):
        with pytest.raises(ValueError):
            eng.logits(np.asarray(bad, dtype=np.int64))
    with pytest.raises(ValueError):
        ServingEngine(tm, tg, mode="nope", device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(tm, tg, batch_buckets=(0,), device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(tm, tg, mode="sampled", eval_fanouts=(3,), device="cpu")


@pytest.mark.parametrize("kw", [dict(layer0="full"), dict(aggregator="maxpool", pool_dim=8,
                                 concat_self=True), dict(aggregator="lstm", pool_dim=8)],
                         ids=["mean-full", "maxpool", "lstm"])
def test_both_tiers_serve_the_new_modes(setup, kw):
    """Sampled == table at covering fanouts for a ``layer0="full"`` model
    and the maxpool and lstm aggregators."""
    _, tg, _, _, _ = setup
    tm = GraphSAGE(GRAPH["num_feats"], GRAPH["num_classes"], (16, 16), (3, 5),
                   device="cpu", **kw)
    max_deg = int(tg.degrees.max())
    nodes = np.arange(0, 60, 2)
    table = ServingEngine(tm, tg, batch_buckets=(32,), device="cpu").logits(nodes)
    sampled = ServingEngine(tm, tg, mode="sampled", batch_buckets=(32,),
                            eval_fanouts=(max_deg, max_deg), device="cpu").logits(nodes)
    assert np.isfinite(table).all()
    np.testing.assert_allclose(sampled, table, **TOL)


def test_engine_defaults_to_cuda(setup, monkeypatch):
    _, tg, _, _, tm = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tm, tg)
