"""The graph generator: a frozen copy of the recipe of the port's
``power_law_graph``, rewritten to draw on the device from the seed.

Edge sources follow a Zipf-like law (weight ``rank ** -alpha`` over a random
permutation of the nodes), destinations are uniform, and a ``homophily``
share of destinations is redrawn from the source's class. Features are
class centres plus Gaussian noise, rounded to the configuration's feature
dtype. Unlike the port's recipe, the edge set is drawn until it holds
exactly the configuration's ``num_edges`` distinct undirected pairs (self
loops dropped), so the graph has the published number of edge slots,
``2 * num_edges``.

Nothing here imports the program: the same arrays go to the program's
``build_graph`` and to the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.inputs.seeds import sub_seed

FEATURE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Draws per round are capped so that one round's transients stay a few GiB.
MAX_DRAWS = 1 << 26


@dataclasses.dataclass
class GraphInputs:
    """Host copies of what the program is handed (``build_graph``'s
    arguments), shared with the reference."""

    features: np.ndarray  # f32 [N, F], values exact in the feature dtype
    labels: np.ndarray  # int64 [N]
    pairs: np.ndarray  # int64 [E, 2], distinct undirected pairs a < b, sorted
    num_classes: int
    feature_dtype: torch.dtype

    @property
    def num_nodes(self) -> int:
        return self.labels.shape[0]


def _draw_pairs(g: torch.Generator, labels: torch.Tensor, num_classes: int, target: int,
                alpha: float, homophily: float, device) -> torch.Tensor:
    """Sorted keys ``a * N + b`` of exactly ``target`` distinct pairs ``a < b``."""
    n = labels.numel()
    ranks = torch.randperm(n, generator=g, device=device).to(torch.float64) + 1.0
    cdf = torch.cumsum(ranks.pow(-alpha), 0)
    cdf /= cdf[-1].clone()
    order = torch.argsort(labels, stable=True)
    counts = torch.bincount(labels, minlength=num_classes)
    starts = torch.cumsum(counts, 0) - counts
    keys = torch.zeros(0, dtype=torch.int64, device=device)
    yield_rate = 1.0
    while keys.numel() < target:
        need = target - keys.numel()
        m = min(int(need / yield_rate * 1.1) + 1024, MAX_DRAWS)
        u = torch.rand(m, generator=g, device=device, dtype=torch.float64)
        src = torch.searchsorted(cdf, u).clamp_(max=n - 1)
        dst = torch.randint(0, n, (m,), generator=g, device=device)
        if homophily > 0.0:
            c = labels[src]
            within = (torch.rand(m, generator=g, device=device) * counts[c]).long()
            pick = order[starts[c] + torch.minimum(within, (counts[c] - 1).clamp(min=0))]
            redraw = torch.rand(m, generator=g, device=device) < homophily
            dst = torch.where(redraw & (counts[c] > 0), pick, dst)
        keep = src != dst
        a = torch.minimum(src, dst)[keep]
        b = torch.maximum(src, dst)[keep]
        before = keys.numel()
        keys = torch.unique(torch.cat([keys, a * n + b]))
        yield_rate = max((keys.numel() - before) / m, 1e-3)
    if keys.numel() > target:
        pick = torch.randperm(keys.numel(), generator=g, device=device)[:target]
        keys = keys[torch.sort(pick).values]
    return keys


def make_graph(config: dict, seed: int, device) -> GraphInputs:
    """The configuration's graph from ``seed``, drawn on ``device``."""
    n, f, c = config["num_nodes"], config["num_features"], config["num_classes"]
    gen = config["generator"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "graph"))
    labels = torch.randint(0, c, (n,), generator=g, device=device)
    keys = _draw_pairs(g, labels, c, config["num_edges"], gen["zipf_exponent"],
                       gen["homophily"], device)
    pairs = torch.stack([keys // n, keys % n], dim=1)
    del keys
    dtype = FEATURE_DTYPES[config["feature_dtype"]]
    centers = torch.randn((c, f), generator=g, device=device)
    noise = torch.randn((n, f), generator=g, device=device)
    features = (centers[labels] + gen["noise"] * noise).to(dtype).to(torch.float32)
    return GraphInputs(features=features.cpu().numpy(), labels=labels.cpu().numpy(),
                       pairs=pairs.cpu().numpy(), num_classes=c, feature_dtype=dtype)


def splits(num_nodes: int, seed32: int, test_size: int, val_size: int
           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(test, val, train) ids: a frozen copy of the split recipe the program
    states (a ``RandomState(seed)`` permutation: test first, then
    validation, the rest training), for the reference's own use."""
    perm = np.random.RandomState(seed32).permutation(num_nodes)
    return perm[:test_size], perm[test_size:test_size + val_size], perm[test_size + val_size:]
