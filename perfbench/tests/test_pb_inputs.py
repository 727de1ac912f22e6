"""The generators: sizes, seeding, and the schedule's fixed multiset."""

import numpy as np
import pytest
import torch

from perfbench.inputs.graph import make_graph, splits
from perfbench.inputs.schedule import make_schedule
from perfbench.inputs.seeds import sub_seed
from perfbench.inputs.weights import leaf_shapes, make_weights
from conftest import tiny_spec

BIG = 2 ** 31 + 12345


def test_graph_has_exactly_the_configured_distinct_undirected_pairs():
    cfg = tiny_spec("reddit-sampled-train").config
    g = make_graph(cfg, BIG, "cpu")
    a, b = g.pairs[:, 0], g.pairs[:, 1]
    assert g.pairs.shape == (cfg["num_edges"], 2)
    assert (a < b).all() and (b < cfg["num_nodes"]).all()
    keys = a * cfg["num_nodes"] + b
    assert len(np.unique(keys)) == len(keys) and (np.diff(keys) > 0).all()
    assert g.features.shape == (cfg["num_nodes"], cfg["num_features"])
    assert g.feature_dtype == torch.float32
    # A bf16 configuration's values are exact in bf16.
    bf = make_graph(dict(cfg, feature_dtype="bfloat16"), BIG, "cpu")
    assert bf.feature_dtype == torch.bfloat16
    f = torch.from_numpy(bf.features)
    assert torch.equal(f.to(torch.bfloat16).to(torch.float32), f)
    assert g.labels.min() >= 0 and g.labels.max() < cfg["num_classes"]


def test_graph_is_a_function_of_the_seed():
    cfg = tiny_spec("products-sampled-train").config
    g1, g2, g3 = (make_graph(cfg, s, "cpu") for s in (BIG, BIG, BIG + 1))
    assert np.array_equal(g1.pairs, g2.pairs) and np.array_equal(g1.features, g2.features)
    assert not np.array_equal(g1.pairs, g3.pairs)


def test_sources_are_heavy_tailed_and_edges_homophilous():
    cfg = tiny_spec("reddit-sampled-train").config
    g = make_graph(cfg, BIG, "cpu")
    deg = np.bincount(g.pairs.reshape(-1), minlength=cfg["num_nodes"])
    assert deg.max() > 10 * deg.mean()
    same = (g.labels[g.pairs[:, 0]] == g.labels[g.pairs[:, 1]]).mean()
    assert same > 0.5  # 0.8 of destinations redrawn from the source's class


def test_splits_have_the_configured_sizes_and_cover_every_node():
    test, val, train = splits(3000, sub_seed(BIG, "split", 32), 500, 200)
    assert (len(test), len(val), len(train)) == (500, 200, 2300)
    assert len(np.unique(np.concatenate([test, val, train]))) == 3000


def test_weights_are_glorot_leaves_from_the_seed():
    cfg = tiny_spec("products-sampled-train").config
    w1, w2 = make_weights(cfg, BIG, "cpu"), make_weights(cfg, BIG, "cpu")
    assert list(w1) == list(leaf_shapes(cfg)) == [
        "layers.0.weight", "layers.1.weight", "layers.2.weight", "head"]
    for name, (a, b) in leaf_shapes(cfg).items():
        assert w1[name].shape == (a, b) and torch.equal(w1[name], w2[name])
        assert w1[name].abs().max() <= (6.0 / (a + b)) ** 0.5


@pytest.mark.parametrize("seed", [1, BIG, 2 ** 40 + 3])
def test_schedule_offers_the_same_work_to_every_seed_in_another_order(seed):
    tr = tiny_spec("reddit-sampled-serve").traffic
    pool = np.arange(1000, 1500)
    ref = make_schedule(tr, 10.0, 7, pool)
    s = make_schedule(tr, 10.0, seed, pool)
    assert len(s) == len(ref) == round(tr["rate"] * 10.0)
    assert np.array_equal(np.sort(s.sizes), np.sort(ref.sizes))
    def gaps(x):  # every gap, the last one to the window's end too
        return np.sort(np.append(np.diff(x.due), 10.0 - x.due[-1]))
    assert np.allclose(gaps(s), gaps(ref))
    assert s.due[0] == 0.0 and (np.diff(s.due) >= 0).all() and s.due[-1] < 10.0
    assert s.sizes.min() >= tr["size_min"] and s.sizes.max() <= tr["size_max"]
    assert all(len(i) == n for i, n in zip(s.ids, s.sizes))
    assert np.isin(np.concatenate(s.ids), pool).all()
