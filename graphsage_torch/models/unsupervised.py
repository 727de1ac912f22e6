"""Unsupervised GraphSAGE: the graph-context loss and the linear-probe
readout, the counterpart of ``graphsage_tpu/models/unsupervised.py``.

The GraphSAGE paper's other objective (Hamilton et al. 2017, eq. 1):

    J(z_u) = -log σ(z_u·z_v) - Q · E_{v_n~P_n} log σ(-z_u·z_{v_n})

with ``v`` a random-walk co-occurrence of ``u`` and ``P_n`` the
degree^0.75 negative distribution (:mod:`graphsage_torch.ops.walks`). The
seeds, their positives and all ``B·Q`` negatives are embedded by ONE
sampled forward over the ``[B·(2+Q)]`` group seeds, so the deepest hop's
gather-mean (kernel 1 on the card) and its backward (kernel 2) launch once
per step.

Evaluation follows the paper: the embeddings are frozen and a linear
(multinomial logistic) probe is fitted on the train split
(:func:`linear_probe_predict`, full-batch Adam).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from graphsage_torch.data.graph import Graph
from graphsage_torch.models.graphsage import Frontier, GraphSAGE
from graphsage_torch.ops.walks import positive_pairs, sample_from_cdf


def context_groups(
    generator: torch.Generator,
    graph: Graph,
    seeds: torch.Tensor,
    neg_cdf: torch.Tensor,
    *,
    walk_length: int,
    num_negatives: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(group_seeds [B*(2+Q)] int32, pair_mask [B] bool)`` for one step.

    Groups are seed-major, ``(u_i, v_i, n_i1..n_iQ)`` contiguous, the
    layout the JAX package's sharded trainers rely on."""
    b = seeds.shape[0]
    pos, pair_mask = positive_pairs(generator, graph, seeds, walk_length)
    negs = sample_from_cdf(generator, neg_cdf, (b, num_negatives))
    groups = torch.cat([seeds.to(torch.int32)[:, None], pos[:, None], negs], dim=1)
    return groups.reshape(-1), pair_mask


def context_group_scores(
    z: torch.Tensor, pair_mask: torch.Tensor, num_negatives: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(per_seed_loss [G], kept [G])`` over seed-major ``(u, v,
    n_1..n_Q)`` embedding groups ``z [G*(2+Q), d]``.

    The rows are L2-normalised first (GraphSAGE Algorithm 1 line 7): on raw
    embeddings the Q negative terms push every embedding to 0. The norm is
    ``z * rsqrt(sq)`` with ``sq = 1`` where it is exactly 0, not
    ``F.normalize``: an isolated node embeds to exactly 0 (quirk Q4), and
    its gradient must stay exactly 0 instead of 0/0 inside the norm's
    backward, which the pair mask would not stop.
    """
    sq = (z * z).sum(dim=-1, keepdim=True)
    z = z * torch.rsqrt(torch.where(sq == 0.0, torch.ones_like(sq), sq))
    z3 = z.reshape(-1, 2 + num_negatives, z.shape[-1])
    zu, zv, zn = z3[:, 0], z3[:, 1], z3[:, 2:]
    pos_score = (zu * zv).sum(dim=-1)
    neg_score = torch.einsum("bd,bqd->bq", zu, zn)
    per_seed = -F.logsigmoid(pos_score) - F.logsigmoid(-neg_score).sum(dim=-1)
    return per_seed, pair_mask.to(per_seed.dtype)


def context_group_loss(
    z: torch.Tensor, pair_mask: torch.Tensor, num_negatives: int
) -> torch.Tensor:
    """The graph-context loss's mean over the groups whose pair is kept."""
    per_seed, kept = context_group_scores(z, pair_mask, num_negatives)
    return (per_seed * kept).sum() / kept.sum().clamp(min=1.0)


def frontier_loss(
    model: GraphSAGE, graph: Graph, frontier: Frontier, pair_mask: torch.Tensor,
    num_negatives: int,
) -> torch.Tensor:
    """The graph-context loss of the groups whose seeds ``frontier``
    expands: one forward to the embeddings, then
    :func:`context_group_loss`."""
    z = model(graph.features, frontier, return_embeddings=True, graph=graph)
    return context_group_loss(z, pair_mask, num_negatives)


def unsupervised_loss(
    model: GraphSAGE,
    graph: Graph,
    generator: torch.Generator,
    seeds: torch.Tensor,
    neg_cdf: torch.Tensor,
    *,
    walk_length: int = 3,
    num_negatives: int = 10,
) -> torch.Tensor:
    """Mean graph-context loss over the seed batch: groups, one sampled
    frontier over every group seed, one forward. Seeds whose walk found no
    positive (isolated nodes) drop out of the mean through the pair mask."""
    group_seeds, pair_mask = context_groups(
        generator, graph, seeds, neg_cdf,
        walk_length=walk_length, num_negatives=num_negatives,
    )
    frontier = model.sample(generator, graph, group_seeds)
    return frontier_loss(model, graph, frontier, pair_mask, num_negatives)


@torch.enable_grad()
def linear_probe_predict(
    train_x: torch.Tensor,
    train_y: torch.Tensor,
    eval_x: torch.Tensor,
    num_classes: int,
    *,
    steps: int = 300,
    lr: float = 0.1,
    l2: float = 1e-4,
) -> torch.Tensor:
    """Class predictions ``[E]`` int32 for ``eval_x`` from a logistic probe
    fitted on ``(train_x, train_y)``: standardised by the train split's
    mean and population std (``jnp.std``'s ddof 0), ``steps`` full-batch
    Adam steps (``optax.adam(lr)``'s defaults) from a zero init, the L2
    term in the loss. Runs eagerly: about a dozen launches a step."""
    train_x = train_x.detach().to(torch.float32)
    eval_x = eval_x.detach().to(torch.float32)
    mu = train_x.mean(dim=0)
    sd = train_x.std(dim=0, correction=0) + 1e-6
    tx, ex = (train_x - mu) / sd, (eval_x - mu) / sd
    y = train_y.reshape(-1).long()
    w = torch.zeros(tx.shape[-1], num_classes, device=tx.device, requires_grad=True)
    b = torch.zeros(num_classes, device=tx.device, requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        loss = F.cross_entropy(tx @ w + b, y) + l2 * (w * w).sum()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    with torch.no_grad():
        return (ex @ w + b).argmax(dim=-1).to(torch.int32)
