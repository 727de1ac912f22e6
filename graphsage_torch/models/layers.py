"""One GraphSAGE layer: the counterpart of ``graphsage_tpu/models/layers.py``.

Three aggregators, the GraphSAGE paper's family (§3.3):

* ``mean``    — masked neighbor mean.
* ``maxpool`` — a per-neighbor MLP (``relu(x @ pool_weight + pool_bias)``),
  then the masked max.
* ``lstm``    — an LSTM run over each row's neighbor sequence; the aggregate
  is its final hidden state (:func:`masked_lstm`).

Two combine modes:

* ``concat_self=False`` — the reference's *shipped* mode (quirk Q2):
  ``h = act(agg(neigh) @ W)`` with no self term.
* ``concat_self=True``  — ``h = act([self ; agg(neigh)] @ W)``.

Weights are stored ``[in, out]``, the JAX layout, and named as the fields of
the JAX ``SAGELayerParams``, so that carrying weights across is a plain copy.
They stay f32; a reduced ``compute_dtype`` (bf16) casts them at use, as the
JAX layers do. A bf16 product returns bf16 (JAX keeps its f32 accumulator
until the cast that follows), and the LSTM's recurrence stays f32.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from graphsage_torch.ops.aggregate import masked_max, masked_mean
from graphsage_torch.utils import profiling

AGGREGATORS = ("mean", "maxpool", "lstm")


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def glorot_uniform(shape: tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    """Xavier/glorot-uniform ``[fan_in, fan_out]`` on the CPU, from
    ``generator`` (the reference's ``init.xavier_uniform_``)."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


def combined_input_dim(in_dim: int, pool_dim: int | None, aggregator: str,
                       concat_self: bool) -> int:
    """Rows of a layer's ``weight``: the aggregate's width (``pool_dim``, the
    pooling MLP's and the LSTM's hidden width, for maxpool and lstm) plus
    ``in_dim`` with ``concat_self``."""
    agg_dim = in_dim if aggregator == "mean" else (pool_dim or in_dim)
    return agg_dim + (in_dim if concat_self else 0)


def split_mean_weight(
    weight: torch.Tensor, in_dim: int, concat_self: bool
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Split a mean-aggregator layer weight into (self, neighbor) halves.

    With ``concat_self`` the weight is ``[2*in, out]`` applied to
    ``[self ‖ mean(neigh)]``; since the mean is linear,
    ``concat @ W == self @ W[:in] + mean(neigh) @ W[in:]`` — the identity
    behind project-then-aggregate. Returns ``(None, W)`` without a self term.
    """
    if not concat_self:
        return None, weight
    return weight[:in_dim], weight[in_dim:]


class SAGELayer(nn.Module):
    """One layer's parameters, glorot-initialised on the CPU from
    ``generator``: ``weight [combined_in, out]`` and, for ``maxpool``,
    ``pool_weight [in, pool_dim]`` and ``pool_bias`` (zeros); for ``lstm``,
    ``lstm_wx [in, 4H]``, ``lstm_wh [H, 4H]`` and ``lstm_b`` (zeros, with
    the forget gate's slice ``[H:2H]`` set to 1), ``H = pool_dim or in``."""

    def __init__(self, in_dim: int, out_dim: int, concat_self: bool = False,
                 generator: torch.Generator | None = None, *,
                 aggregator: str = "mean", pool_dim: int | None = None):
        super().__init__()
        if aggregator not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {aggregator!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.in_dim, self.out_dim, self.concat_self = in_dim, out_dim, concat_self
        self.aggregator = aggregator
        cin = combined_input_dim(in_dim, pool_dim, aggregator, concat_self)
        self.weight = nn.Parameter(glorot_uniform((cin, out_dim), generator))
        hdim = pool_dim or in_dim
        if aggregator == "maxpool":
            self.pool_weight = nn.Parameter(glorot_uniform((in_dim, hdim), generator))
            self.pool_bias = nn.Parameter(torch.zeros(hdim))
        elif aggregator == "lstm":
            self.lstm_wx = nn.Parameter(glorot_uniform((in_dim, 4 * hdim), generator))
            self.lstm_wh = nn.Parameter(glorot_uniform((hdim, 4 * hdim), generator))
            b = torch.zeros(4 * hdim)
            b[hdim:2 * hdim] = 1.0
            self.lstm_b = nn.Parameter(b)

    def forward(self, self_feats, neigh_feats, neigh_mask, *,
                activation=torch.relu, precomputed_agg=None,
                compute_dtype=None) -> torch.Tensor:
        return apply_sage_layer(
            self, self_feats, neigh_feats, neigh_mask,
            activation=activation, precomputed_agg=precomputed_agg,
            compute_dtype=compute_dtype,
        )


def pool(layer: SAGELayer, x: torch.Tensor, param_dtype: torch.dtype) -> torch.Tensor:
    """The max-pooling aggregator's per-row MLP, ``relu(x @ Wp + bp)``, in
    ``x``'s dtype. ``Wp`` and ``bp`` are rounded to ``param_dtype`` (the
    compute dtype) at use. The product is formed in f32 from those values and
    the bias added to it before the one rounding to ``x``'s dtype, as JAX's
    f32 accumulator does: a bf16 product rounded before the bias moves
    near-tied rows past each other in the max that follows, which sends
    their gradient to another neighbor."""
    w = layer.pool_weight.to(param_dtype).to(torch.float32)
    pre = x.to(torch.float32) @ w + layer.pool_bias.to(param_dtype)
    return torch.relu(pre).to(x.dtype)


def masked_lstm(
    wx: torch.Tensor,  # [d_in, 4H]
    wh: torch.Tensor,  # [H, 4H]
    b: torch.Tensor,  # [4H]
    neigh_feats: torch.Tensor,  # [..., k, d_in]
    neigh_mask: torch.Tensor,  # [..., k]
) -> torch.Tensor:
    """Final hidden state ``[..., H]`` of an LSTM over each row's neighbor
    sequence (gates ``i, f, g, o`` in that order, computed in f32).

    The input projection runs once for all ``k`` steps; the recurrence is a
    Python loop over them. A masked slot carries ``(h, c)`` through
    unchanged, so the result does not depend on where padding sits in the
    row and an empty row gives 0 (quirk Q4). ``nn.LSTM`` cannot skip masked
    slots, hence the gate math written out.
    """
    lead, k = neigh_feats.shape[:-2], neigh_feats.shape[-2]
    x = neigh_feats.reshape(-1, k, neigh_feats.shape[-1])
    xg = (x @ wx.to(x.dtype)).to(torch.float32)  # [B, k, 4H]
    h = lstm_recurrence(xg, wh, b, neigh_mask.reshape(-1, k))
    return h.reshape(*lead, wh.shape[0]).to(neigh_feats.dtype)


def lstm_recurrence(xg: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """:func:`masked_lstm`'s recurrence over input-gate products ``xg [B,
    k, 4H]`` f32 (the tensor-parallel layer 0 sums them over its ranks
    first): the final hidden state ``[B, H]`` f32."""
    h_dim = wh.shape[0]
    m = mask[..., None]
    wh32, b32 = wh.to(torch.float32), b.to(torch.float32)
    h = xg.new_zeros((xg.shape[0], h_dim))
    c = xg.new_zeros((xg.shape[0], h_dim))
    for t in range(xg.shape[1]):
        i, f, g, o = (xg[:, t] + h @ wh32 + b32).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = torch.where(m[:, t], h_new, h)
        c = torch.where(m[:, t], c_new, c)
    return h


def apply_sage_layer(
    layer: SAGELayer,
    self_feats: torch.Tensor | None,  # [..., in_dim] or None without concat_self
    neigh_feats: torch.Tensor | None,  # [..., k, in_dim]
    neigh_mask: torch.Tensor | None,  # [..., k]
    activation: Callable[[torch.Tensor], torch.Tensor] | None = torch.relu,
    precomputed_agg: torch.Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Apply one layer with its own aggregator. Returns ``[..., out_dim]`` in
    the weights' dtype (f32).

    ``precomputed_agg`` replaces the aggregation when it was already done
    upstream (the gather-mean kernel on the deepest hop, the cached layer 0).
    ``compute_dtype`` (bf16) casts the inputs, the aggregate and the weights
    before the products; without it, inputs of another dtype than the
    weights meet them in the wider of the two.
    """
    w = layer.weight
    out_dtype = w.dtype
    if compute_dtype is not None:
        if neigh_feats is not None:
            neigh_feats = neigh_feats.to(compute_dtype)
        if self_feats is not None:
            self_feats = self_feats.to(compute_dtype)
        w = w.to(compute_dtype)
    if precomputed_agg is not None:
        agg = precomputed_agg.to(compute_dtype or out_dtype)
    elif layer.aggregator == "mean":
        agg = masked_mean(neigh_feats, neigh_mask)
    elif layer.aggregator == "lstm":
        agg = masked_lstm(layer.lstm_wx, layer.lstm_wh, layer.lstm_b,
                          neigh_feats, neigh_mask)
    else:
        agg = masked_max(pool(layer, neigh_feats, compute_dtype or out_dtype),
                         neigh_mask)
    if layer.concat_self:
        if self_feats is None:
            raise ValueError("concat_self=True requires self_feats")
        combined = torch.cat([self_feats, agg], dim=-1)
    else:
        combined = agg
    dt = torch.promote_types(combined.dtype, w.dtype)
    out = (combined.to(dt) @ w.to(dt)).to(out_dtype)
    return activation(out) if activation is not None else out


def apply_full_graph_mean_layer(
    layer: SAGELayer,
    h: torch.Tensor,  # [N, d_in]
    spmm,  # Callable[[x], (neigh_mean [N, d], valid_count [N])]
    *,
    self_loop: bool,
    project_first: bool,
    activation=torch.relu,
    rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """One full-graph mean layer over every node, in ``h``'s dtype (the
    weights are cast to it). ``activation=None`` leaves the output linear
    (the unsupervised model's last layer).

    With ``project_first`` the layer projects to ``d_out`` before the SpMM
    (exact: the mean is linear), so the SpMM moves ``d_out``-wide rows; the
    sums that follow it are f32. ``self_loop`` folds the node itself into the
    mean: ``(mean * cnt + self) / (cnt + 1)``.

    ``rows``: only those nodes' outputs ``[R, d_out]``; ``spmm`` then gives
    their means and degrees (over a row block of the graph) and the self
    terms read their rows of ``h``.
    """
    if activation is None:
        activation = _identity
    d_in = h.shape[-1]
    w = layer.weight.to(h.dtype)
    take = (lambda t: t) if rows is None else (lambda t: t[rows])  # noqa: E731
    if project_first:
        w_self, w_neigh = split_mean_weight(w, d_in, layer.concat_self)
        hp = h @ w_neigh
        mean, cnt = spmm(hp)
        pre = mean.to(torch.float32)
        if self_loop:
            c = cnt.to(torch.float32)[:, None]
            pre = (pre * c + take(hp).to(torch.float32)) / (c + 1.0)
        if layer.concat_self:
            pre = pre + (take(h) @ w_self).to(torch.float32)
        return activation(pre).to(h.dtype)
    mean, cnt = spmm(h)
    if self_loop or layer.concat_self:
        h = take(h)  # the self terms' rows
    if self_loop:
        c = cnt.to(mean.dtype)[:, None]
        mean = (mean * c + h) / (c + 1.0)
    combined = torch.cat([h, mean], dim=-1) if layer.concat_self else mean
    return activation(combined @ w)


def apply_full_graph_maxpool_layer(
    layer: SAGELayer,
    h: torch.Tensor,  # [N, d_in]
    segmax,  # Callable[[pooled [N, pd]], guarded per-node max [N, pd]]
    *,
    self_loop: bool,
    activation=torch.relu,
    rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """One full-graph max-pooling layer over every node, in ``h``'s dtype:
    the pooling MLP once per node (the span ``agg.pool``), then ``segmax``
    (0 on rows without neighbors); ``activation=None`` leaves the output
    linear. ``rows``: only those nodes' outputs; the MLP still runs over
    every node (the rows' neighbours), ``segmax`` gives the rows' maxima."""
    if activation is None:
        activation = _identity
    take = (lambda t: t) if rows is None else (lambda t: t[rows])  # noqa: E731
    with profiling.span("agg.pool", device=h.device):
        pooled = pool(layer, h, h.dtype)
    agg = segmax(pooled).to(h.dtype)
    if self_loop:
        # pooled >= 0 (ReLU) and empty rows give 0, so an elementwise max
        # adds the self loop exactly.
        agg = torch.maximum(agg, take(pooled))
    combined = torch.cat([take(h), agg], dim=-1) if layer.concat_self else agg
    return activation(combined @ layer.weight.to(h.dtype))
