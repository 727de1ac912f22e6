"""Random walks and negative sampling for the unsupervised objective: the
counterpart of ``graphsage_tpu/ops/walks.py``.

The GraphSAGE paper's unsupervised graph-context loss (Hamilton et al. 2017,
eq. 1) pulls together nodes that co-occur on short random walks, against
``Q`` negatives drawn from a smoothed degree distribution:

* :func:`random_walk` — batched fixed-length uniform walks as ``L``
  unrolled ``fanout=1`` calls of :func:`sample_neighbors` (so a hub-capped
  ELL row resolves through the CSR, as training-time sampling does). Static
  ``[B, L+1]`` shape; a walk that reaches a sink stays there, masked from
  that step on.
* :func:`positive_pairs` — one co-occurrence partner per seed: a uniformly
  chosen visited step of its walk (:func:`pick_positive_step`).
* :func:`negative_cdf` / :func:`sample_from_cdf` — the ``degree**0.75``
  negative table as an inverse CDF: one ``[N]`` f32 array built on the
  host once, and a ``searchsorted`` per draw (:func:`cdf_lookup`).

Every draw comes from the caller's ``torch.Generator``, whose stream differs
from ``jax.random``'s: the two steps that turn uniforms into ids take the
uniforms as arguments (:func:`pick_positive_step`, :func:`cdf_lookup`), so
that tests can feed them JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from graphsage_torch.data.graph import Graph
from graphsage_torch.ops.sampling import sample_neighbors


def random_walk(
    generator: torch.Generator, graph: Graph, starts: torch.Tensor, length: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform random walks of ``length`` steps from ``starts``.

    Returns ``(walks [B, length+1] int32, valid [B, length+1] bool)``.
    ``walks[:, 0] = starts`` (always valid); step ``t`` is a uniformly
    sampled neighbor of step ``t-1``. A walk that reaches a node with no
    neighbors stays there with ``valid=False`` for that and every later
    step.
    """
    cur = starts.to(torch.int32)
    alive = torch.ones(cur.shape, dtype=torch.bool, device=cur.device)
    steps, flags = [cur], [alive]
    for _ in range(length):
        ids, mask = sample_neighbors(
            generator, graph.neighbors, graph.degrees, cur, 1,
            indptr=graph.indptr, edge_dst=graph.edge_dst,
            ell_covers_all=graph.ell_covers_all,
        )
        alive = alive & mask[..., 0]
        cur = torch.where(alive, ids[..., 0].to(torch.int32), cur)
        steps.append(cur)
        flags.append(alive)
    return torch.stack(steps, dim=-1), torch.stack(flags, dim=-1)


def positive_pairs(
    generator: torch.Generator, graph: Graph, seeds: torch.Tensor, walk_length: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One random-walk co-occurrence partner per seed: ``(pos [B] int32,
    mask [B] bool)``. Seeds whose walk has no valid step (isolated nodes)
    return themselves with ``mask=False``."""
    walks, valid = random_walk(generator, graph, seeds, walk_length)
    u = torch.rand(seeds.shape, generator=generator, device=seeds.device)
    return pick_positive_step(u, walks, valid, seeds)


def pick_positive_step(
    u: torch.Tensor, walks: torch.Tensor, valid: torch.Tensor, seeds: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """A uniform choice among each walk's visited steps, from uniforms
    ``u [B]`` in ``[0, 1)`` (JAX's takes a key and draws them itself).

    Valid steps form a prefix (a dead walk never revives), so index
    ``u * count`` truncated toward zero, clamped to ``count - 1``, is a
    uniform choice among them."""
    visited, ok = walks[..., 1:], valid[..., 1:]
    count = ok.sum(dim=-1, dtype=torch.int32)
    idx = torch.minimum((u * count.to(u.dtype)).to(torch.int32),
                        (count - 1).clamp(min=0))
    pos = torch.gather(visited, -1, idx[..., None].long())[..., 0]
    mask = count > 0
    return torch.where(mask, pos, seeds.to(torch.int32)), mask


def negative_cdf(degrees: np.ndarray, power: float = 0.75) -> np.ndarray:
    """Inverse-CDF table for ``P(v) ∝ degree(v)**power`` negatives (the
    word2vec smoothing the GraphSAGE paper adopts), built on the host once:
    an f64 cumulative sum so that a 10^6-node tail keeps its mass, its last
    entry set to 1.0, stored f32. Uniform when every degree is zero."""
    w = np.asarray(degrees, np.float64) ** power
    total = w.sum()
    if total <= 0:
        w = np.ones_like(w)
        total = w.sum()
    cdf = np.cumsum(w / total)
    cdf[-1] = 1.0  # guard rounding so u < 1 always lands in range
    return cdf.astype(np.float32)


def cdf_lookup(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The node ids that uniforms ``u`` in ``[0, 1)`` map to under ``cdf``:
    the first entry above ``u``, clamped to ``N - 1``."""
    idx = torch.searchsorted(cdf, u, right=True)
    return idx.clamp(max=cdf.shape[0] - 1).to(torch.int32)


def sample_from_cdf(
    generator: torch.Generator, cdf: torch.Tensor, shape: tuple[int, ...]
) -> torch.Tensor:
    """Node ids i.i.d. from the distribution ``cdf`` encodes."""
    u = torch.rand(shape, generator=generator, device=cdf.device)
    return cdf_lookup(cdf, u)
