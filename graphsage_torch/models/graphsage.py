"""Multi-layer supervised GraphSAGE with explicit per-hop frontiers: the
counterpart of ``graphsage_tpu/models/graphsage.py`` for the mean aggregator
and ``layer0="sampled"``.

  1. ``sample``  — build hop frontiers seeds -> hop1 -> ... -> hopL with the
     fixed-fanout sampler. Frontiers are flat ``[B * prod(k)]`` tensors; no
     deduplication.
  2. ``forward`` — layer 0 is the fused masked gather-mean (Hopper kernel 1
     on the card), then the upper layers fold inward: reshape to
     ``[parents, k, d]``, masked mean, project, ReLU.
  3. a linear classification head; ``loss`` is its mean softmax
     cross-entropy, the training objective.

Hop ``h`` is built with the fanout of layer ``L-h`` (0-based): the top
layer's fanout governs the first expansion. With ``concat_self`` or
``self_loop`` each frontier row carries the parent in column 0.

``forward_full_graph`` runs the same layers over every node with complete
neighborhoods through the CSR mean-SpMM (Hopper kernel 3 on the card) — the
deterministic inference path behind the serving table tier and evaluation
with ``eval_fanouts=None``. Both kernels have backward kernels
(:mod:`graphsage_torch.ops.scatter_mean`; the SpMM kernel itself on a
symmetric graph), so both paths train.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from graphsage_torch._device import resolve_device
from graphsage_torch.data.graph import Graph
from graphsage_torch.models.layers import (
    SAGELayer,
    apply_full_graph_mean_layer,
    glorot_uniform,
    split_mean_weight,
)
from graphsage_torch.ops.aggregate import gather, gather_mean, spmm_mean
from graphsage_torch.ops.sampling import sample_neighbors


class Frontier(NamedTuple):
    """Flattened hop frontiers. ``ids[0]`` is the seed batch; ``ids[h]`` has
    ``ids[h-1].numel() * k_h`` entries (``k_h + 1`` with a self column)."""

    ids: tuple[torch.Tensor, ...]
    masks: tuple[torch.Tensor, ...]

    @property
    def num_hops(self) -> int:
        return len(self.ids) - 1

    def to(self, device) -> "Frontier":
        return Frontier(
            ids=tuple(i.to(device) for i in self.ids),
            masks=tuple(m.to(device) for m in self.masks),
        )


# What the port does not run yet, and the ROADMAP Queue 1 item that brings it.
_NOT_PORTED = {
    "aggregator": ("mean", 7),
    "layer0": ("sampled", 6),
    "sampling": ("floyd", 9),
    "compute_dtype": (None, 8),
    "multilabel": (False, 7),
}


class GraphSAGE(nn.Module):
    """Supervised GraphSAGE holding its parameters: one :class:`SAGELayer`
    per entry of ``hidden_dims`` and a ``[hidden[-1], num_classes]`` head.

    Parameters are glorot-initialised on the CPU from ``generator`` (seed 0
    when omitted) and then placed on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``).
    """

    def __init__(
        self,
        in_dim: int,
        num_classes: int,
        hidden_dims: Sequence[int] = (128, 128),
        fanouts: Sequence[int | None] = (10, 10),
        *,
        aggregator: str = "mean",
        concat_self: bool = False,
        self_loop: bool = False,
        layer0: str = "sampled",
        sampling: str = "floyd",
        compute_dtype=None,
        multilabel: bool = False,
        gather_impl: str = "auto",
        spmm_impl: str = "auto",
        project_first: bool | str = "auto",
        generator: torch.Generator | None = None,
        device=None,
    ):
        super().__init__()
        if len(hidden_dims) != len(fanouts):
            raise ValueError("hidden_dims and fanouts must have one entry per layer")
        if self_loop and concat_self:
            raise ValueError("self_loop and concat_self are mutually exclusive")
        given = {"aggregator": aggregator, "layer0": layer0, "sampling": sampling,
                 "compute_dtype": compute_dtype, "multilabel": multilabel}
        for name, (supported, item) in _NOT_PORTED.items():
            if given[name] != supported:
                raise NotImplementedError(
                    f"{name}={given[name]!r} is not ported yet (ROADMAP Queue 1 "
                    f"item {item}); the port runs {name}={supported!r}"
                )
        dev = resolve_device(device)
        self.in_dim = in_dim
        self.num_classes = num_classes
        self.hidden_dims = tuple(hidden_dims)
        self.fanouts = tuple(fanouts)
        self.concat_self = concat_self
        self.self_loop = self_loop
        self.gather_impl = gather_impl
        self.spmm_impl = spmm_impl
        self.project_first = project_first
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        layers, d_in = [], in_dim
        for d_out in self.hidden_dims:
            layers.append(SAGELayer(d_in, d_out, concat_self, generator=generator))
            d_in = d_out
        self.layers = nn.ModuleList(layers)
        self.head = nn.Parameter(glorot_uniform((d_in, num_classes), generator))
        self.to(dev)

    @classmethod
    def from_config(cls, cfg, in_dim: int, num_classes: int, **kwargs) -> "GraphSAGE":
        """Build from a :class:`graphsage_torch.train.config.ModelConfig`."""
        if cfg.quantize_features:
            raise NotImplementedError(
                "quantize_features is not ported yet (ROADMAP Queue 1 item 8)"
            )
        if cfg.final_activation != "relu":
            raise NotImplementedError(
                "final_activation='linear' is not ported yet (ROADMAP Queue 1 "
                "item 11)"
            )
        return cls(
            in_dim, num_classes, cfg.hidden_dims, cfg.fanouts,
            aggregator=cfg.aggregator, concat_self=cfg.concat_self,
            self_loop=cfg.self_loop, layer0=cfg.layer0, sampling=cfg.sampling,
            compute_dtype=cfg.compute_dtype, gather_impl=cfg.gather_impl,
            spmm_impl=cfg.spmm_impl, project_first=cfg.project_first, **kwargs,
        )

    @property
    def num_layers(self) -> int:
        return len(self.hidden_dims)

    @property
    def device(self) -> torch.device:
        return self.head.device

    def use_project_first(self, layer: int, d_in: int) -> bool:
        """Whether layer ``layer`` aggregates after projecting. ``"auto"``
        projects whenever the layer shrinks its width (``d_in > d_out``), so
        the gather-mean (or SpMM) moves ``d_out``-wide rows. That is the
        traffic rule; it does not weigh what projecting first adds to a
        training step (the ``[N, d_in] x [d_in, d_out]`` product over the
        whole table and the backward scatter into the projected table), so
        which order is cheaper there depends on N against the number of
        gathered rows and on the widths. The H100 step times of both orders
        for the ``cora`` and ``pubmed`` presets are in ``PERF.md``."""
        if self.project_first == "auto":
            return d_in > self.hidden_dims[layer]
        return bool(self.project_first)

    # -------------------------------------------------------------- sample
    def sample(
        self,
        generator: torch.Generator,
        graph: Graph,
        seeds: torch.Tensor,
        fanouts: Sequence[int | None] | None = None,
    ) -> Frontier:
        """Expand seed nodes into per-hop frontiers (static shapes).
        ``fanouts`` overrides the model's own (serving's ``eval_fanouts``)."""
        fanouts = self.fanouts if fanouts is None else tuple(fanouts)
        seeds = seeds.reshape(-1)
        ids = [seeds]
        masks = [torch.ones(seeds.shape, dtype=torch.bool, device=seeds.device)]
        L = self.num_layers
        for h in range(1, L + 1):
            parent_ids, parent_mask = ids[-1], masks[-1]
            nids, nmask = sample_neighbors(
                generator, graph.neighbors, graph.degrees, parent_ids,
                fanouts[L - h],
                indptr=graph.indptr, edge_dst=graph.edge_dst,
                ell_covers_all=graph.ell_covers_all,
            )
            nmask = nmask & parent_mask[:, None]
            if self.concat_self or self.self_loop:
                # Column 0 carries the parent: concat_self splits it off for
                # the concat branch; self_loop leaves it inside the mean.
                nids = torch.cat([parent_ids[:, None].to(nids.dtype), nids], dim=1)
                nmask = torch.cat([parent_mask[:, None], nmask], dim=1)
            ids.append(nids.reshape(-1))
            masks.append(nmask.reshape(-1))
        return Frontier(ids=tuple(ids), masks=tuple(masks))

    # ------------------------------------------------------------- forward
    def forward(
        self,
        features: torch.Tensor,
        frontier: Frontier,
        return_embeddings: bool = False,
    ) -> torch.Tensor:
        """Logits ``[B, num_classes]`` for the frontier's seed batch (or the
        pre-head representations with ``return_embeddings``)."""
        L = self.num_layers
        n_out = frontier.ids[L - 1].shape[0]
        k_cols = frontier.ids[L].shape[0] // n_out
        ids2 = frontier.ids[L].reshape(n_out, k_cols)
        m2 = frontier.masks[L].reshape(n_out, k_cols)
        if self.concat_self:
            ids2, m2 = ids2[:, 1:], m2[:, 1:]
        neigh_ids, neigh_mask = ids2.contiguous(), m2.contiguous()
        layer0 = self.layers[0]
        fused = lambda table: gather_mean(  # noqa: E731
            table, neigh_ids, neigh_mask, impl=self.gather_impl
        )
        self_ids = frontier.ids[L - 1]
        if self.use_project_first(0, self.in_dim):
            # Project the whole table to d_out once, then gather-mean narrow
            # rows (exact: the mean is linear).
            w_self, w_neigh = split_mean_weight(
                layer0.weight, self.in_dim, self.concat_self
            )
            pre = fused(features @ w_neigh)
            if self.concat_self:
                pre = pre + gather(features @ w_self, self_ids)
            h = torch.relu(pre)
        else:
            self_h = gather(features, self_ids) if self.concat_self else None
            h = layer0(self_h, None, None, precomputed_agg=fused(features))
        for l in range(1, L):
            hop_in = L - l  # activations currently live at this hop
            n_out = frontier.ids[hop_in - 1].shape[0]
            k_cols = frontier.ids[hop_in].shape[0] // n_out
            h3 = h.reshape(n_out, k_cols, h.shape[-1])
            m3 = frontier.masks[hop_in].reshape(n_out, k_cols)
            if self.concat_self:
                self_h, neigh, nm = h3[:, 0], h3[:, 1:], m3[:, 1:]
            else:
                self_h, neigh, nm = None, h3, m3
            h = self.layers[l](self_h, neigh, nm)
        if return_embeddings:
            return h
        return h @ self.head

    def apply_sampled(
        self, generator: torch.Generator, graph: Graph, seeds: torch.Tensor
    ) -> torch.Tensor:
        """``sample`` + ``forward`` in one call: logits ``[B, C]`` (the JAX
        model's ``apply``; the name ``apply`` stays ``nn.Module``'s)."""
        return self(graph.features, self.sample(generator, graph, seeds))

    def embed(
        self, generator: torch.Generator, graph: Graph, seeds: torch.Tensor
    ) -> torch.Tensor:
        """Sampled node representations ``[B, hidden[-1]]`` (what the head
        consumes); :meth:`embed_full_graph` gives deterministic ones."""
        return self(graph.features, self.sample(generator, graph, seeds),
                    return_embeddings=True)

    # ----------------------------------------------------------------- loss
    def loss(
        self, features: torch.Tensor, frontier: Frontier, labels: torch.Tensor
    ) -> torch.Tensor:
        """Mean softmax cross-entropy of the frontier's seeds against their
        integer ``labels`` (reference model.py:35-37)."""
        return self.classification_loss(self(features, frontier), labels).mean()

    def classification_loss(
        self, logits: torch.Tensor, labels: torch.Tensor
    ) -> torch.Tensor:
        """Per-example softmax cross-entropy ``[B]`` on integer labels."""
        return F.cross_entropy(logits, labels.reshape(-1).long(), reduction="none")

    # --------------------------------------------------------- full graph
    def forward_full_graph(
        self, graph: Graph, return_embeddings: bool = False
    ) -> torch.Tensor:
        """Deterministic logits for every node, using complete neighborhoods
        (the reference with ``num_sample=None``, quirk Q7)."""

        def spmm(x):
            mean = spmm_mean(
                x, graph.edge_src, graph.edge_dst, graph.edge_mask,
                graph.num_nodes, indptr=graph.indptr, impl=self.spmm_impl,
                symmetric=graph.symmetric,
            )
            return mean, graph.degrees

        h = graph.features
        for l, layer in enumerate(self.layers):
            h = apply_full_graph_mean_layer(
                layer, h, spmm,
                self_loop=self.self_loop,
                project_first=self.use_project_first(l, h.shape[-1]),
            )
        if return_embeddings:
            return h
        return h @ self.head

    def embed_full_graph(self, graph: Graph) -> torch.Tensor:
        """Deterministic embeddings ``[N, hidden[-1]]`` for every node."""
        return self.forward_full_graph(graph, return_embeddings=True)

    def predictions(self, logits) -> np.ndarray:
        """Host-side class decisions from logits (argmax)."""
        if isinstance(logits, torch.Tensor):
            logits = logits.detach().cpu().numpy()
        return np.asarray(logits).argmax(axis=-1)
