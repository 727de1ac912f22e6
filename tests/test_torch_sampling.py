"""The port's sampler on a torch generator: the semantics that
``tests/test_sampling.py`` pins for the JAX sampler (without replacement,
exactly min(degree, fanout) valid, zero-degree rows masked, uniform
marginals and subsets, the capped-ELL CSR path), plus the deterministic
paths, which must equal the JAX package's arrays exactly."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data.graph import build_graph as jax_build_graph
from graphsage_tpu.ops.sampling import full_neighbors as jax_full_neighbors
from graphsage_tpu.ops.sampling import sample_neighbors as jax_sample_neighbors
from graphsage_torch.data.graph import build_graph
from graphsage_torch.ops.sampling import full_neighbors, sample_neighbors

torch.set_num_threads(1)

TINY_EDGES = np.array([[0, 1], [0, 2], [1, 2], [2, 3], [3, 4]])  # node 5 isolated


@pytest.fixture(scope="module")
def tiny():
    feats = np.arange(6 * 4, dtype=np.float32).reshape(6, 4)
    return build_graph(feats, np.array([0, 1, 0, 1, 0, 1]), TINY_EDGES,
                       num_classes=2, device="cpu")


def _star_edges(hub_deg):
    return np.array([[0, i] for i in range(1, hub_deg + 1)])


def _star(hub_deg, **kw):
    return build_graph(np.zeros((hub_deg + 1, 2), np.float32), np.zeros(hub_deg + 1),
                       _star_edges(hub_deg), num_classes=1, device="cpu", **kw)


def _sample(g, seed, nodes, fanout, **kw):
    ids, mask = sample_neighbors(
        torch.Generator().manual_seed(seed), g.neighbors, g.degrees,
        torch.as_tensor(np.asarray(nodes), dtype=torch.int32), fanout, **kw,
    )
    assert ids.dtype == torch.int32 and mask.dtype == torch.bool
    return ids.numpy(), mask.numpy()


def test_without_replacement_and_count(tiny):
    degrees = tiny.degrees.numpy()
    for fanout in (1, 2, 3, 5):
        ids, mask = _sample(tiny, 0, np.arange(6), fanout)
        assert ids.shape == (6, fanout)
        for v in range(6):
            valid = ids[v][mask[v]]
            assert len(valid) == min(degrees[v], fanout)
            assert len(set(valid.tolist())) == len(valid)


def test_sampled_ids_are_real_neighbors(tiny):
    neighbors, degrees = tiny.neighbors.numpy(), tiny.degrees.numpy()
    for s in range(5):
        ids, mask = _sample(tiny, s, np.arange(6), 2)
        for v in range(6):
            assert set(ids[v][mask[v]].tolist()) <= set(neighbors[v, : degrees[v]].tolist())


def test_zero_degree_fully_masked(tiny):
    _, mask = _sample(tiny, 3, [5], 4)
    assert not mask.any()


def test_full_neighbors_identical_to_jax(tiny):
    jg = jax_build_graph(np.zeros((6, 4), np.float32), np.zeros(6), TINY_EDGES)
    want_ids, want_mask = jax_full_neighbors(jg.neighbors, jg.degrees, jnp.arange(6))
    ids, mask = full_neighbors(tiny.neighbors, tiny.degrees, torch.arange(6))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    # fanout=None routes to the same path.
    ids2, mask2 = _sample(tiny, 0, np.arange(6), None)
    np.testing.assert_array_equal(ids2, ids.numpy())
    np.testing.assert_array_equal(mask2, mask.numpy())


def test_fanout_wider_than_ell_identical_to_jax(tiny):
    # Every valid slot fits: deterministic padding, the same arrays as JAX.
    jg = jax_build_graph(np.zeros((6, 4), np.float32), np.zeros(6), TINY_EDGES)
    fanout = tiny.max_degree + 5
    ids, mask = _sample(tiny, 0, np.arange(6), fanout)
    want_ids, want_mask = jax_sample_neighbors(
        jax.random.PRNGKey(0), jg.neighbors, jg.degrees, jnp.arange(6), fanout)
    np.testing.assert_array_equal(ids, np.asarray(want_ids))
    np.testing.assert_array_equal(mask, np.asarray(want_mask))
    assert (mask.sum(1) == tiny.degrees.numpy()).all()


def test_uniform_marginals():
    """Sampling 2 of 8 neighbors gives each a marginal probability ~1/4."""
    draws = 4000
    ids, _ = _sample(_star(8), 42, np.zeros(draws), 2)
    counts = np.bincount(ids.reshape(-1), minlength=9)
    np.testing.assert_allclose(counts[1:] / draws, 0.25, atol=0.03)


def test_floyd_subset_uniformity():
    """All C(4,2)=6 2-subsets of a degree-4 node are equally likely."""
    draws = 6000
    ids, _ = _sample(_star(4), 3, np.zeros(draws), 2)
    counts = Counter(frozenset(row.tolist()) for row in ids)
    assert len(counts) == 6
    freqs = np.array([c / draws for c in counts.values()])
    np.testing.assert_allclose(freqs, 1 / 6, atol=0.02)


def test_same_generator_state_same_sample(tiny):
    a = _sample(tiny, 11, np.arange(6), 2)
    b = _sample(tiny, 11, np.arange(6), 2)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_unknown_method_raises(tiny):
    with pytest.raises(ValueError, match="unknown sampling method"):
        _sample(tiny, 0, np.arange(2), 2, method="reservoir")


# ------------------------------------------------------------------ topk
@pytest.mark.parametrize("method", ["floyd", "topk"])
def test_floyd_and_topk_same_semantics(tiny, method):
    """Both draw exactly min(degree, fanout) distinct real neighbors."""
    neighbors, degrees = tiny.neighbors.numpy(), tiny.degrees.numpy()
    for seed in range(5):
        ids, mask = _sample(tiny, seed, np.arange(6), 2, method=method)
        for v in range(6):
            valid = ids[v][mask[v]]
            assert len(valid) == min(degrees[v], 2)
            assert len(set(valid.tolist())) == len(valid)
            assert set(valid.tolist()) <= set(neighbors[v, : degrees[v]].tolist())


def test_topk_uniform_marginals_and_subsets():
    """topk keeps Floyd's distribution: each of 8 neighbors drawn with
    probability 2/8, and all 6 two-subsets of 4 neighbors equally often."""
    draws = 6000
    ids, _ = _sample(_star(8), 42, np.zeros(draws), 2, method="topk")
    counts = np.bincount(ids.reshape(-1), minlength=9)
    np.testing.assert_allclose(counts[1:] / draws, 0.25, atol=0.03)
    ids, _ = _sample(_star(4), 3, np.zeros(draws), 2, method="topk")
    counts = Counter(frozenset(row.tolist()) for row in ids)
    assert len(counts) == 6
    np.testing.assert_allclose(np.array(list(counts.values())) / draws, 1 / 6, atol=0.02)


def test_topk_rejects_a_capped_graph():
    g = _star(30, ell_width_cap=8)
    with pytest.raises(ValueError, match="ELL-only"):
        _sample(g, 0, np.zeros(4), 3, method="topk", indptr=g.indptr,
                edge_dst=g.edge_dst, ell_covers_all=False)


# -------------------------------------------------------------- windowed
def _windowed(g, seed, nodes, fanout):
    return _sample(g, seed, nodes, fanout, method="windowed", indptr=g.indptr,
                   edge_dst=g.edge_dst, ell_covers_all=g.ell_covers_all)


@pytest.mark.parametrize("fanout", [3, 8, 40])
def test_windowed_draws_lie_in_one_aligned_window_of_the_row(fanout):
    """Every valid id sits at an ``edge_dst`` position inside one
    128-aligned window of the parent's CSR row (aligned to the edge list,
    not to the row), and the valid count is ``min(fanout, |window|)``."""
    rng = np.random.default_rng(fanout)
    edges = np.concatenate([_star_edges(300),                      # a hub row
                            rng.integers(1, 301, (600, 2))])
    g = build_graph(np.zeros((301, 2), np.float32), np.zeros(301), edges, num_classes=1,
                    device="cpu", ell_width_cap=16)
    indptr, edge_dst = g.indptr.numpy(), g.edge_dst.numpy()
    nodes = rng.integers(0, 301, 400)
    ids, mask = _windowed(g, fanout, nodes, fanout)
    for v, row_ids, row_mask in zip(nodes, ids, mask):
        lo, hi = indptr[v], indptr[v + 1]
        valid = row_ids[row_mask]
        assert len(set(valid.tolist())) == len(valid)  # without replacement
        # A row's neighbours are distinct, so each id names one position.
        pos = lo + np.searchsorted(edge_dst[lo:hi], valid)
        np.testing.assert_array_equal(edge_dst[pos], valid)
        window = np.unique(pos // 128)
        assert len(window) == 1
        w_lo, w_hi = max(window[0] * 128, lo), min(window[0] * 128 + 128, hi)
        assert len(valid) == min(fanout, w_hi - w_lo)


def test_windowed_zero_degree_and_shapes():
    g = build_graph(np.zeros((5, 4), np.float32), np.zeros(5), [[0, 1], [0, 2]],
                    num_classes=1, device="cpu", ell_width_cap=2)
    ids, mask = _windowed(g, 0, [3, 4, 0], 3)
    assert ids.shape == (3, 3) and mask.shape == (3, 3)
    assert not mask[:2].any()  # isolated parents come back fully masked
    assert sorted(ids[2][mask[2]].tolist()) == [1, 2]


def test_windowed_needs_csr():
    g = _star(10)
    with pytest.raises(ValueError, match="indptr and edge_dst"):
        _sample(g, 0, np.zeros(4), 3, method="windowed")


def test_windowed_uniform_marginals_across_windows():
    """A 300-degree hub (two full windows and a 44-slot remnant, the
    windows not aligned to the row's start): each neighbor's marginal is
    the uniform ``k/d``."""
    hub_deg, k = 300, 4
    g = _star(hub_deg, ell_width_cap=16)
    ids, mask = _windowed(g, 0, np.zeros(64 * 120), k)
    assert mask.all()  # every window of the row holds >= 4 slots
    for row in ids[:200]:
        assert len(set(row.tolist())) == k
    counts = np.bincount(ids.reshape(-1), minlength=hub_deg + 1)
    assert counts[0] == 0
    rel = counts[1:] / counts[1:].mean()
    assert rel.min() > 0.6 and rel.max() < 1.4


def test_windowed_mean_estimator_unbiased_with_tiny_edge_window():
    """The masked mean is unbiased for any window partition, edge windows
    of fewer than ``k`` slots included (their count is the denominator)."""
    hub_deg, k = 130, 8
    # Nodes 0 and 1 share an edge, so hub 2's row starts at position 2: its
    # windows hold 126 and 4 slots.
    edges = np.concatenate([[[0, 1]], [[2, i] for i in range(3, hub_deg + 3)]])
    g = build_graph(np.zeros((hub_deg + 3, 1), np.float32), np.zeros(hub_deg + 3), edges,
                    num_classes=1, device="cpu", ell_width_cap=16)
    assert (int(g.indptr[2]), int(g.degrees[2])) == (2, hub_deg)
    feats = np.zeros(hub_deg + 3)
    feats[3:] = np.arange(1, hub_deg + 1)
    est, remnant = [], 0
    for t in range(150):
        ids, mask = _windowed(g, 1000 + t, np.full(128, 2), k)
        cnt = mask.sum(axis=1)
        assert (cnt >= 1).all() and (cnt <= k).all()
        remnant += int((cnt == 4).sum())
        est.append(((feats[ids] * mask).sum(axis=1) / cnt).mean())
    assert remnant > 0
    est = np.asarray(est)
    se = est.std() / np.sqrt(len(est))
    assert abs(est.mean() - feats[3:].mean()) < 4 * se + 1e-6


@pytest.mark.parametrize("kw", [dict(concat_self=True), dict(self_loop=True),
                                dict(aggregator="maxpool", pool_dim=16, concat_self=True),
                                dict(aggregator="lstm", pool_dim=16, concat_self=True)],
                         ids=["concat_self", "self_loop", "maxpool", "lstm"])
def test_windowed_model_trains(kw):
    from graphsage_torch import GraphSAGE, Trainer, TrainConfig
    from graphsage_torch.data.synthetic import power_law_graph

    g = power_law_graph(num_nodes=400, num_edges=2000, num_feats=16, num_classes=4,
                        seed=3, homophily=0.8, device="cpu")
    model = GraphSAGE(16, 4, (16, 16), (4, 4), sampling="windowed", device="cpu", **kw)
    res = Trainer(model, g, TrainConfig(batch_size=64, num_steps=40, learning_rate=0.5,
                                        log_every=0, test_size=60, val_size=40,
                                        eval_fanouts=(4, 4))).run(log=None)
    losses = np.asarray(res["losses"])
    assert np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean() * 0.7


def test_multi_dim_nodes(tiny):
    ids, mask = _sample(tiny, 0, np.array([[0, 1], [2, 3]]), 2)
    assert ids.shape == (2, 2, 2) and mask.shape == (2, 2, 2)


def test_capped_ell_csr_sampling_uniform_over_full_set():
    """Hub rows overflow the ELL cap; CSR sampling still reaches every
    neighbor (those beyond the cap too) uniformly without replacement."""
    hub_deg, k = 40, 8
    g = _star(hub_deg, ell_width_cap=16)
    assert not g.ell_covers_all and g.neighbors.shape[1] == 16
    ids, mask = _sample(g, 0, np.zeros(64 * 30), k, indptr=g.indptr,
                        edge_dst=g.edge_dst, ell_covers_all=False)
    assert mask.all()  # deg 40 >= k
    for row in ids:
        assert len(set(row.tolist())) == k
        assert set(row.tolist()) <= set(range(1, hub_deg + 1))
    counts = np.bincount(ids.reshape(-1), minlength=hub_deg + 1)
    assert (counts[17:] > 0).all()
    rel = counts[1:] / counts[1:].mean()
    assert rel.min() > 0.7 and rel.max() < 1.3


def test_capped_ell_low_degree_rows_and_last_row():
    # The last rows' masked slots point past the edge list: they are clamped,
    # and the valid slots are still each row's own neighbors.
    edges = np.concatenate([_star_edges(20), [[21, 22]]])
    g = build_graph(np.zeros((23, 2), np.float32), np.zeros(23), edges,
                    num_classes=1, device="cpu", ell_width_cap=8, edge_pad_multiple=2)
    assert g.edge_dst.shape[0] == g.num_edges  # no padding to absorb them
    ids, mask = _sample(g, 1, [0, 21, 22], 6, indptr=g.indptr,
                        edge_dst=g.edge_dst, ell_covers_all=False)
    assert mask.sum(1).tolist() == [6, 1, 1]
    assert ids[1][mask[1]].tolist() == [22] and ids[2][mask[2]].tolist() == [21]


def test_capped_ell_needs_csr_and_fanout():
    g = _star(30, ell_width_cap=8)
    with pytest.raises(ValueError):
        _sample(g, 0, np.zeros(4), None, ell_covers_all=False)
    with pytest.raises(ValueError):
        _sample(g, 0, np.zeros(4), 3, ell_covers_all=False)
