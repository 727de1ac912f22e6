"""GraphSAGE with the mean aggregator, written out plainly (Hamilton, Ying
and Leskovec, NeurIPS 2017, Algorithm 1, without the normalisation): layer
``l`` maps a node to ``relu(CONCAT(h_v, mean of its neighbours' h) @ W_l)``
with ``concat_self``, else to ``relu(mean of its neighbours' h @ W_l)``;
``W_l``'s first ``d_in`` rows take the node's own ``h``. A linear head
gives the logits; the loss is the mean softmax cross-entropy over the batch
(or the train split, full-graph). Float32 throughout; the products go
through :func:`perfbench.reference.precision.mm`.

* :func:`sampled_logits` runs over a sampled frontier: ``ids[h]`` holds
  ``ids[h - 1].numel() * k`` children, ``masks[h]`` which of them count;
  with ``concat_self`` column 0 of each row is the parent itself (which
  :func:`perfbench.reference.frontier.frontier_faults` checks); the
  deepest hop is gathered from the feature table.
* :func:`full_logits` runs over every node with its complete neighbour
  list, the mean formed from the benchmark's own edge list in blocks of
  edges (:class:`CsrMean`).
* :func:`momentum_step` and :func:`adam_step` are the optimizers' updates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.precision import mm

EDGE_BLOCK = 1 << 23


def masked_mean(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``h[n, k, d]`` over the valid ``mask[n, k]`` slots; 0 for a
    row with none."""
    m = mask.to(torch.float32)[..., None]
    return (h * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)


def sampled_logits(x: torch.Tensor, ids, masks, weights: list, head: torch.Tensor,
                   precision: str = "f32", concat_self: bool = False) -> torch.Tensor:
    num_layers = len(weights)
    h = x.index_select(0, ids[num_layers].long()).to(torch.float32)
    for layer, w in enumerate(weights):
        hop = num_layers - layer
        n_out = ids[hop - 1].numel()
        k = ids[hop].numel() // n_out
        h3, m3 = h.view(n_out, k, -1), masks[hop].view(n_out, k)
        if concat_self:
            agg = torch.cat([h3[:, 0], masked_mean(h3[:, 1:], m3[:, 1:])], dim=1)
        else:
            agg = masked_mean(h3, m3)
        h = torch.relu(mm(agg, w, precision))
    return mm(h, head, precision)


class Csr:
    """The benchmark's adjacency as directed edges ``src -> dst`` (both
    directions of each undirected pair), sorted, with each node's degree."""

    def __init__(self, pairs: torch.Tensor, num_nodes: int):
        a, b = pairs[:, 0], pairs[:, 1]
        keys = torch.sort(torch.cat([a * num_nodes + b, b * num_nodes + a])).values
        self.num_nodes = num_nodes
        self.keys = keys
        self.src = keys // num_nodes
        self.dst = keys % num_nodes
        self.degrees = torch.bincount(self.src, minlength=num_nodes)


class CsrMean(torch.autograd.Function):
    """``out[v] = mean of x[u]`` over the neighbours ``u`` of ``v``, summed
    edge block by edge block; the backward sends ``g[v] / deg v`` back to
    every neighbour."""

    @staticmethod
    def forward(ctx, x, csr: Csr):
        ctx.csr = csr
        out = torch.zeros_like(x)
        for lo in range(0, csr.src.numel(), EDGE_BLOCK):
            hi = lo + EDGE_BLOCK
            out.index_add_(0, csr.src[lo:hi], x.index_select(0, csr.dst[lo:hi]))
        return out / csr.degrees.clamp(min=1).to(x.dtype)[:, None]

    @staticmethod
    def backward(ctx, g):
        csr = ctx.csr
        gs = g / csr.degrees.clamp(min=1).to(g.dtype)[:, None]
        dx = torch.zeros_like(g)
        for lo in range(0, csr.src.numel(), EDGE_BLOCK):
            hi = lo + EDGE_BLOCK
            dx.index_add_(0, csr.dst[lo:hi], gs.index_select(0, csr.src[lo:hi]))
        return dx, None


def full_logits(x: torch.Tensor, csr: Csr, weights: list, head: torch.Tensor,
                precision: str = "f32", concat_self: bool = False) -> torch.Tensor:
    """Every node's logits. The mean is linear, so each layer projects
    before it averages (``mean(h) @ W == mean(h @ W)``), which moves the
    narrower rows; the node's own half is ``h @ W[:d_in]``."""
    h = x.to(torch.float32)
    for w in weights:
        d = h.shape[1]
        if concat_self:
            pre = mm(h, w[:d], precision) + CsrMean.apply(mm(h, w[d:], precision), csr)
        else:
            pre = CsrMean.apply(mm(h, w, precision), csr)
        h = torch.relu(pre)
    return mm(h, head, precision)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long())


def momentum_step(params: list, grads: list, state: dict, lr: float, momentum: float) -> None:
    """SGD with momentum, no dampening: ``t = g + m t`` (``t = g`` at the
    first step), ``p -= lr t``."""
    bufs = state.setdefault("momentum", [None] * len(params))
    for i, (p, g) in enumerate(zip(params, grads)):
        bufs[i] = g.clone() if bufs[i] is None else bufs[i] * momentum + g
        p -= lr * bufs[i]


def adam_step(params: list, grads: list, state: dict, lr: float, beta1: float = 0.9,
              beta2: float = 0.999, eps: float = 1e-8) -> None:
    """Adam (Kingma and Ba, 2015) with bias correction, ``eps`` added to the
    corrected root."""
    t = state["t"] = state.get("t", 0) + 1
    m = state.setdefault("m", [torch.zeros_like(p) for p in params])
    v = state.setdefault("v", [torch.zeros_like(p) for p in params])
    for i, (p, g) in enumerate(zip(params, grads)):
        m[i] = beta1 * m[i] + (1 - beta1) * g
        v[i] = beta2 * v[i] + (1 - beta2) * g * g
        m_hat = m[i] / (1 - beta1 ** t)
        v_hat = v[i] / (1 - beta2 ** t)
        p -= lr * m_hat / (v_hat.sqrt() + eps)


def optimizer_step(optimizer: dict, params: list, grads: list, state: dict) -> None:
    """The configuration's optimizer (``{"name": "momentum" | "adam", ...}``)."""
    if optimizer["name"] == "momentum":
        momentum_step(params, grads, state, optimizer["lr"], optimizer["momentum"])
    elif optimizer["name"] == "adam":
        adam_step(params, grads, state, optimizer["lr"])
    else:
        raise ValueError(f"unknown optimizer {optimizer['name']!r}")
