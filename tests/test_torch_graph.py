"""The port's graph container, loaders and synthetic generators against the
JAX package's: the same inputs and seeds give identical arrays."""

import numpy as np
import pytest
import torch

import graphsage_tpu.data.graph as jax_graph
import graphsage_tpu.data.loaders as jax_loaders
import graphsage_tpu.data.synthetic as jax_synthetic
from graphsage_torch.data import graph, loaders, synthetic

torch.set_num_threads(1)

ARRAYS = ("neighbors", "degrees", "indptr", "edge_dst", "edge_src", "edge_mask",
          "features", "labels")
STATIC = ("num_nodes", "num_features", "num_classes", "max_degree", "num_edges",
          "ell_covers_all", "symmetric")


def assert_same_graph(jg, tg):
    assert tg.device == torch.device("cpu")
    for name in ARRAYS:
        want = np.asarray(getattr(jg, name))
        got = getattr(tg, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in STATIC:
        assert getattr(tg, name) == getattr(jg, name), name


def _star(hub_deg):
    return np.array([[0, i] for i in range(1, hub_deg + 1)])


_RNG = np.random.default_rng(5)
CASES = {
    # Node 5 is isolated (the zero-degree guard, quirk Q4).
    "tiny": (6, np.array([[0, 1], [0, 2], [1, 2], [2, 3], [3, 4]]), {}),
    # Hub rows overflow the ELL cap: CSR stays complete.
    "ell_capped": (41, _star(40), dict(ell_width_cap=16)),
    "max_degree": (30, _RNG.integers(0, 30, (120, 2)), dict(max_degree=3)),
    "directed": (25, _RNG.integers(0, 25, (60, 2)), dict(undirected=False)),
    # Duplicates and self-loops; edge count exactly on the pad multiple.
    "duplicates": (40, _RNG.integers(0, 40, (64, 2)), dict(edge_pad_multiple=8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_graph_identical_to_jax(case):
    n, edges, kwargs = CASES[case]
    feats = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    labels = np.arange(n) % 3
    jg = jax_graph.build_graph(feats, labels, edges, num_classes=3, **kwargs)
    tg = graph.build_graph(feats, labels, edges, num_classes=3, device="cpu", **kwargs)
    assert_same_graph(jg, tg)
    if case == "ell_capped":
        assert not tg.ell_covers_all and tg.neighbors.shape[1] == 16
        assert int(tg.degrees[0]) == 40


def test_padding_rules():
    # ELL width rounds up to 8; padded edges: src N-1, dst 0, mask False.
    tg = graph.build_graph(np.zeros((6, 2), np.float32), np.zeros(6),
                           CASES["tiny"][1], device="cpu")
    assert tg.max_degree == 8 and tg.edge_dst.shape[0] == 128
    e = tg.num_edges
    assert (tg.edge_src[e:] == 5).all() and (tg.edge_dst[e:] == 0).all()
    assert not tg.edge_mask[e:].any() and tg.edge_mask[:e].all()


def test_sorted_unique_edges_identical_to_jax():
    edges = np.random.default_rng(1).integers(0, 50, (300, 2))
    for undirected in (True, False):
        np.testing.assert_array_equal(
            graph.sorted_unique_edges(50, edges, undirected),
            jax_graph.sorted_unique_edges(50, edges, undirected),
        )


@pytest.mark.parametrize("name", ["cora", "pubmed"])
def test_loaders_identical_to_jax(name, synth_cora_root, synth_pubmed_root):
    root = synth_cora_root if name == "cora" else synth_pubmed_root
    parse = {"cora": "parse_cora", "pubmed": "parse_pubmed"}[name]
    raw_t = getattr(loaders, parse)(root)
    raw_j = getattr(jax_loaders, parse)(root)
    for field in ("features", "labels", "edges"):
        np.testing.assert_array_equal(getattr(raw_t, field), getattr(raw_j, field))
    assert raw_t.num_classes == raw_j.num_classes
    load = f"load_{name}"
    assert_same_graph(
        getattr(jax_loaders, load)(root, engine="python"),
        getattr(loaders, load)(root, device="cpu"),
    )


@pytest.mark.parametrize("name", ["synth_cora_files", "synth_pubmed_files"])
def test_synthetic_files_identical_to_jax(name, tmp_path):
    kw = dict(num_nodes=90, num_feats=60, num_edges=200, seed=3)
    j_root = getattr(jax_synthetic, name)(tmp_path / "jax", **kw)
    t_root = getattr(synthetic, name)(tmp_path / "torch", **kw)
    for f in sorted((tmp_path / "jax").iterdir()):
        assert (tmp_path / "torch" / f.name).read_bytes() == f.read_bytes(), f.name
    assert j_root != t_root


@pytest.mark.parametrize("name", ["synthetic_cora_graph", "synthetic_pubmed_graph"])
def test_synthetic_graphs_identical_to_jax(name):
    kw = dict(num_nodes=150, num_feats=45, num_edges=400, seed=4)
    assert_same_graph(getattr(jax_synthetic, name)(**kw),
                      getattr(synthetic, name)(device="cpu", **kw))


@pytest.mark.parametrize("kw", [
    dict(homophily=0.0),
    dict(homophily=0.8, num_classes=3),
    dict(homophily=0.8, max_degree=5, seed=2),
])
def test_power_law_graph_identical_to_jax(kw):
    kw = dict(num_nodes=300, num_edges=1500, num_feats=12, **kw)
    jg = jax_synthetic.power_law_graph(**kw)
    tg = synthetic.power_law_graph(device="cpu", **kw)
    assert_same_graph(jg, tg)
    assert int(tg.degrees.min()) >= 1


def test_power_law_graph_caps_its_ell_view():
    # Hubs above the ELL cap keep their full neighbour lists in CSR.
    tg = synthetic.power_law_graph(num_nodes=2000, num_edges=20000,
                                   homophily=0.8, device="cpu")
    assert not tg.ell_covers_all and tg.neighbors.shape[1] == 256
    assert int(tg.degrees.max()) > 256


def test_homophilous_edges_identical_to_jax():
    labels = np.random.default_rng(0).integers(0, 3, 80)
    np.testing.assert_array_equal(
        synthetic._homophilous_edges(np.random.default_rng(9), labels, 150),
        jax_synthetic._homophilous_edges(np.random.default_rng(9), labels, 150),
    )


def test_graph_to_moves_every_tensor():
    tg = graph.build_graph(np.ones((6, 3), np.float32), np.zeros(6),
                           CASES["tiny"][1], device="cpu")
    moved = tg.to("cpu")
    for name in ARRAYS:
        assert torch.equal(getattr(moved, name), getattr(tg, name))
    assert moved.num_edges == tg.num_edges and "device=cpu" in repr(moved)


def test_multihot_labels_identical_to_jax():
    """Multi-hot ``[N, C]`` labels stay 2-D as int8 (any non-zero is 1), and
    ``num_classes`` defaults to their width."""
    labels = (np.random.default_rng(3).random((30, 5)) < 0.3) * 2
    feats = np.ones((30, 4), np.float32)
    edges = CASES["directed"][1] % 30
    jg = jax_graph.build_graph(feats, labels, edges)
    tg = graph.build_graph(feats, labels, edges, device="cpu")
    assert_same_graph(jg, tg)
    assert tg.labels.dtype == torch.int8 and tg.labels.shape == (30, 5)
    assert tg.num_classes == 5 and set(np.unique(tg.labels.numpy())) <= {0, 1}


def test_multihot_label_width_must_match_num_classes():
    with pytest.raises(ValueError, match="multi-hot"):
        graph.build_graph(np.zeros((10, 4), np.float32), np.zeros((10, 3), np.int8),
                          [(0, 1)], num_classes=5, device="cpu")


def test_synthetic_ppi_graphs_identical_to_jax():
    kw = dict(num_graphs=3, num_nodes=150, num_feats=20, num_classes=12,
              edges_per_node=5, seed=4)
    jgs = jax_synthetic.synthetic_ppi_graphs(**kw)
    tgs = synthetic.synthetic_ppi_graphs(device="cpu", **kw)
    assert len(tgs) == 3
    for jg, tg in zip(jgs, tgs):
        assert_same_graph(jg, tg)
        assert tg.labels.shape == (150, 12)


def _ppi_pair(**kw):
    kw = dict(num_graphs=3, num_nodes=60, num_feats=8, num_classes=6, seed=1, **kw)
    return (jax_synthetic.synthetic_ppi_graphs(**kw),
            synthetic.synthetic_ppi_graphs(device="cpu", **kw))


@pytest.mark.parametrize("case", ["multi-hot", "single-label directed"])
def test_disjoint_union_identical_to_jax(case):
    if case == "multi-hot":
        jgs, tgs = _ppi_pair()
    else:  # class-id labels on directed graphs: the union is not symmetric
        jgs, tgs = [], []
        for n in (20, 25):
            feats = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
            labels, edges = np.arange(n) % 3, _RNG.integers(0, n, (40, 2))
            jgs.append(jax_graph.build_graph(feats, labels, edges, num_classes=3,
                                             undirected=False))
            tgs.append(graph.build_graph(feats, labels, edges, num_classes=3,
                                         undirected=False, device="cpu"))
    ju, tu = jax_graph.disjoint_union(jgs), graph.disjoint_union(tgs)
    assert_same_graph(ju, tu)
    assert tu.symmetric == (case == "multi-hot")
    assert tu.num_nodes == sum(g.num_nodes for g in tgs)
    assert tu.num_edges == sum(g.num_edges for g in tgs)
    # No edge crosses components.
    comp = np.repeat(np.arange(len(tgs)), [g.num_nodes for g in tgs])
    src, dst = tu.edge_src[:tu.num_edges].numpy(), tu.edge_dst[:tu.num_edges].numpy()
    assert (comp[src] == comp[dst]).all()


def test_disjoint_union_rejects_mixed_inputs():
    _, tgs = _ppi_pair()
    single = graph.build_graph(np.zeros((8, 8), np.float32), np.zeros(8, np.int64),
                               [(0, 1), (2, 3)], num_classes=6, device="cpu")
    with pytest.raises(ValueError, match="label layouts"):
        graph.disjoint_union([tgs[0], single])
    narrow = graph.build_graph(np.zeros((8, 4), np.float32), np.zeros(8, np.int64),
                               [(0, 1)], num_classes=6, device="cpu")
    with pytest.raises(ValueError, match="feature widths"):
        graph.disjoint_union([single, narrow])
    with pytest.raises(ValueError, match="no graphs"):
        graph.disjoint_union([])


def test_data_entry_points_default_to_cuda(monkeypatch, synth_cora_root,
                                           synth_pubmed_root):
    """Without a card, an entry point given no device raises instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: graph.build_graph(np.zeros((3, 2), np.float32), np.zeros(3), [[0, 1]]),
        lambda: loaders.load_cora(synth_cora_root),
        lambda: loaders.load_pubmed(synth_pubmed_root),
        lambda: synthetic.synthetic_cora_graph(num_nodes=40, num_feats=40, num_edges=60),
        lambda: synthetic.power_law_graph(num_nodes=40, num_edges=80),
        lambda: synthetic.synthetic_ppi_graphs(num_graphs=1, num_nodes=30),
        lambda: graph.build_graph(np.zeros((3, 2), np.float32), np.zeros(3),
                                  [[0, 1]], device="cpu").to("cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
