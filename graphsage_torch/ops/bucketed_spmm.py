"""Degree-bucketed full-graph mean aggregation: the counterpart of
``graphsage_tpu/ops/bucketed_spmm.py``, in plain PyTorch ops.

Nodes are sorted by degree (on the host, once per graph) and cut into
buckets of ELL widths (8, 32, 128 and a last one up to ``hub_cap``); each
bucket is summed one column at a time, a row gather per column, so the
forward scatters nothing. Rows with more than ``hub_cap`` neighbours sum
their CSR edges with one ``index_add_``. The backward uses ``A == A^T``
(symmetric graphs only): ``dX = A (g / deg)``, the same bucketed pass
unnormalised.

The JAX package sums each ELL bucket in the compute dtype; here every sum
accumulates in f32 and rounds once, as every sum of the port does (a bf16
result may differ from JAX's in its last bits). The JAX package picks this
pass for its full-graph trainer for reasons measured on a TPU; the port's
full-graph SpMM is kernel 3 (``ops/spmm.py``), and this pass runs when a
model asks for ``spmm_impl="bucketed_ell"``. It is no Pallas kernel in the
JAX package, and no kernel here.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from graphsage_torch.data.graph import Graph


class BucketedPlan(NamedTuple):
    """Static per-graph aggregation plan, built on the host, its arrays on
    the graph's device and equal to the JAX package's plan.

    Nodes are ordered ascending by degree and split into buckets whose ELL
    width covers every member's full neighbor list."""

    inv_perm: torch.Tensor  # [N] position of node v's row in the bucket-concat order
    ell: tuple  # per bucket: int32 [N_b, w_b] neighbor ids (0-padded)
    deg: tuple  # per bucket: float32 [N_b] true degrees
    widths: tuple  # per-bucket ELL widths
    # Hub overflow (rows with degree > hub_cap), after the ELL buckets in
    # the concat order, summed over their COO edges. All None when no row
    # exceeds the cap.
    hub_edge_src: torch.Tensor | None = None  # [E_hub] neighbour ids
    hub_edge_row: torch.Tensor | None = None  # [E_hub] local hub-row index
    hub_deg: torch.Tensor | None = None  # [N_hub] float32 true degrees


def plan_bucketed_spmm(
    graph: Graph, widths: Sequence[int] = (8, 32, 128), hub_cap: int = 256
) -> BucketedPlan:
    """Build the degree-bucket plan from the graph's (full) CSR.

    ``hub_cap`` bounds the widest ELL bucket; rows above it go to the hub
    group."""
    indptr = graph.indptr.cpu().numpy()
    edge_dst = graph.edge_dst.cpu().numpy()
    degrees = (indptr[1:] - indptr[:-1]).astype(np.int64)
    n = graph.num_nodes
    max_deg = int(degrees.max()) if n else 1
    dev = graph.device

    def put(a):
        return torch.from_numpy(a).to(dev)

    cap_eff = min(max_deg, int(hub_cap))
    bounds = [w for w in sorted(widths) if w < cap_eff] + [max(cap_eff, 1)]
    order = np.argsort(degrees, kind="stable")
    inv_perm = np.empty(n, np.int32)

    ells, degs, used_widths = [], [], []
    lo = 0
    pos = 0
    for w in bounds:
        hi = int(np.searchsorted(degrees[order], w, side="right"))
        members = order[lo:hi]
        lo = hi
        if len(members) == 0:
            continue
        # Flat CSR positions of every member edge and its rank in its row.
        deg_m = degrees[members]
        total = int(deg_m.sum())
        row_idx = np.repeat(np.arange(len(members)), deg_m)
        row_start = np.concatenate([[0], np.cumsum(deg_m)[:-1]])
        within = np.arange(total) - np.repeat(row_start, deg_m)
        src_pos = np.repeat(indptr[members], deg_m) + within
        ell = np.zeros((len(members), w), np.int32)
        ell[row_idx, within] = edge_dst[src_pos]
        inv_perm[members] = pos + np.arange(len(members))
        pos += len(members)
        ells.append(put(ell))
        degs.append(put(deg_m.astype(np.float32)))
        used_widths.append(w)

    hub_edge_src = hub_edge_row = hub_deg = None
    hubs = order[lo:]
    if len(hubs):
        deg_h = degrees[hubs]
        hub_edge_row = np.repeat(np.arange(len(hubs), dtype=np.int32), deg_h)
        within = (
            np.arange(int(deg_h.sum())) -
            np.repeat(np.concatenate([[0], np.cumsum(deg_h)[:-1]]), deg_h)
        )
        hub_edge_src = edge_dst[np.repeat(indptr[hubs], deg_h) + within]
        inv_perm[hubs] = pos + np.arange(len(hubs))
        hub_edge_src = put(hub_edge_src.astype(np.int32))
        hub_edge_row = put(hub_edge_row)
        hub_deg = put(deg_h.astype(np.float32))

    return BucketedPlan(
        inv_perm=put(inv_perm),
        ell=tuple(ells),
        deg=tuple(degs),
        widths=tuple(used_widths),
        hub_edge_src=hub_edge_src,
        hub_edge_row=hub_edge_row,
        hub_deg=hub_deg,
    )


class _Pass:
    """The bucketed sum ``out[v] = (1/deg(v))? * sum_{u in N(v)} x[u]`` over
    one plan, f32 sums rounded once to ``x``'s dtype.

    Each bucket's columns are kept contiguous, and since its rows ascend by
    degree, column ``j`` is valid exactly on the rows from ``starts[j]`` on:
    each column gathers only those rows and adds the same terms, in the same
    column order, as the JAX package's masked pass."""

    def __init__(self, plan: BucketedPlan):
        self.plan = plan
        self.cols = [ell.t().contiguous() for ell in plan.ell]
        self.starts = [np.searchsorted(deg.cpu().numpy(), np.arange(w), side="right")
                       for deg, w in zip(plan.deg, plan.widths)]
        self.hub_row = None if plan.hub_edge_row is None else plan.hub_edge_row.long()

    def __call__(self, x: torch.Tensor, normalize: bool) -> torch.Tensor:
        plan = self.plan
        parts = []
        for cols, starts, deg in zip(self.cols, self.starts, plan.deg):
            n_b = cols.shape[1]
            acc = torch.zeros((n_b, x.shape[-1]), dtype=torch.float32, device=x.device)
            for j, s in enumerate(starts):
                if s == n_b:  # no row of the bucket has a j-th neighbour
                    break
                acc[s:] += x.index_select(0, cols[j, s:]).to(torch.float32)
            if normalize:
                acc = acc / deg.clamp(min=1.0)[:, None]
            parts.append(acc)
        if plan.hub_deg is not None:
            hub = torch.zeros((plan.hub_deg.shape[0], x.shape[-1]), dtype=torch.float32,
                              device=x.device).index_add_(
                0, self.hub_row, x.index_select(0, plan.hub_edge_src).to(torch.float32))
            if normalize:
                hub = hub / plan.hub_deg[:, None]
            parts.append(hub)
        return torch.cat(parts).index_select(0, plan.inv_perm).to(x.dtype)


class _BucketedMean(torch.autograd.Function):
    """``forward(x, pass_, deg)``: the normalised pass; backward: the
    unnormalised pass on ``g / max(deg, 1)`` (``A == A^T``)."""

    @staticmethod
    def forward(ctx, x, pass_, deg):
        ctx.pass_ = pass_
        ctx.save_for_backward(deg)
        return pass_(x, True)

    @staticmethod
    def backward(ctx, g):
        (deg,) = ctx.saved_tensors
        gs = (g.to(torch.float32) / deg.clamp(min=1.0)[:, None]).to(g.dtype)
        return ctx.pass_(gs, False), None, None


def make_spmm_mean_bucketed(plan: BucketedPlan):
    """Return ``f(x) -> D^-1 A x`` (``[N, F]`` in ``x``'s dtype) with the
    scatter-free backward. Only valid for a symmetric adjacency (the
    backward uses ``A == A^T``); callers check ``Graph.symmetric``."""
    pass_ = _Pass(plan)
    deg_parts = list(plan.deg)
    if plan.hub_deg is not None:
        deg_parts.append(plan.hub_deg)
    deg_full = torch.cat(deg_parts).index_select(0, plan.inv_perm)

    def spmm_mean(x: torch.Tensor) -> torch.Tensor:
        return _BucketedMean.apply(x, pass_, deg_full)

    return spmm_mean
