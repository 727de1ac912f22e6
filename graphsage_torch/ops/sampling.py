"""Vectorized fixed-fanout neighbor sampling: the counterpart of
``graphsage_tpu/ops/sampling.py``.

Semantics are pinned to the reference's (quirk Q8):

* uniform, **without replacement**;
* exactly ``min(degree, fanout)`` distinct neighbors per node, and the
  aggregation denominator is that valid count;
* ``fanout=None`` returns the full (padded) row — the deterministic path
  (quirk Q7);
* zero-degree nodes yield a fully-masked row (guarded downstream, quirk Q4).

Three methods (``method``): ``"floyd"`` (default) and ``"topk"`` draw exact
uniform k-subsets; ``"windowed"`` draws within one 128-slot window of the
CSR edge list per parent (:func:`_windowed_sample`), which keeps the masked
mean unbiased and the marginals uniform but correlates the draws.

Random numbers come from a ``torch.Generator`` on the tensors' device. Its
stream differs from ``jax.random``'s, so tests hold sampled paths to the JAX
package through shared frontiers, covering fanouts, or statistics.
"""

from __future__ import annotations

import torch


def _slot_validity(degrees: torch.Tensor, width: int) -> torch.Tensor:
    """mask[..., width]: slot j is a real neighbor iff j < degree."""
    iota = torch.arange(width, dtype=torch.int32, device=degrees.device)
    return iota < degrees[..., None]


def full_neighbors(
    neighbors: torch.Tensor,
    degrees: torch.Tensor,
    nodes: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """No-sampling path: every neighbor, padded to the ELL width.

    Returns ``(ids[..., width] int32, mask[..., width] bool)``. Only exact
    when the ELL table covers all rows (``Graph.ell_covers_all``).
    """
    nodes = nodes.long()
    width = neighbors.shape[-1]
    mask = _slot_validity(torch.clamp(degrees[nodes], max=width), width)
    return neighbors[nodes], mask


def _floyd_slots(
    generator: torch.Generator, degrees: torch.Tensor, fanout: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform without-replacement slot indices via Floyd's algorithm.

    Round ``j`` draws ``t ~ U[0, d-k+j]``; if ``t`` was already selected the
    fresh value ``d-k+j`` is taken instead (it cannot have been selected —
    all earlier rounds drew from strictly smaller ranges). Rows with
    ``degree < fanout`` take the identity slots ``0..degree-1``.

    Returns ``slots[..., k]`` int32 and ``mask[..., k]`` bool.
    """
    d = degrees.to(torch.int32)
    k = fanout
    u = torch.rand((*d.shape, k), generator=generator, device=d.device)
    slots = torch.zeros((*d.shape, k), dtype=torch.int32, device=d.device)
    full = d >= k
    for j in range(k):
        m = d - k + j  # inclusive upper bound of this round's range
        # The float-to-int step can round up to m + 1 for u near 1: clamp.
        t = torch.minimum((u[..., j] * (m + 1).to(u.dtype)).to(torch.int32), m)
        if j:
            dup = (slots[..., :j] == t[..., None]).any(dim=-1)
            t = torch.where(dup, m, t)
        slots[..., j] = torch.where(full, t, torch.full_like(t, j))
    jj = torch.arange(k, dtype=torch.int32, device=d.device)
    mask = full[..., None] | (jj < d[..., None])
    return slots, mask


# The windowed sampler's window: 128 consecutive positions of ``edge_dst``,
# aligned to position 0 of the edge list (not to a row's start), as in the
# JAX package, whose graphs pad ``edge_dst`` the same way.
WINDOW = 128


def _windowed_sample(
    generator: torch.Generator,
    degrees: torch.Tensor,
    indptr: torch.Tensor,
    edge_dst: torch.Tensor,
    nodes: torch.Tensor,
    fanout: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample within one window of the parent's CSR row.

    Draw ``u ~ U[0, d)`` per parent; the window is the ``WINDOW``-aligned
    block of ``edge_dst`` positions holding ``indptr[v] + u``, clipped to
    the row on both ends (so a window is chosen with probability
    proportional to how many of the parent's neighbors it holds); then
    Floyd-sample up to ``fanout`` slots without replacement inside it. The
    masked mean stays unbiased for any partition into windows, and each
    neighbor's marginal is ``min(fanout, |w|) / d``; the draws of one parent
    share a window. The valid count is ``min(fanout, |window|)``; zero-degree
    parents come back fully masked.

    The JAX package fetches one 128-lane row of ``edge_dst`` per parent and
    selects lanes by compare-and-reduce, a workaround for TPU gathers; here
    ``edge_dst[lo + slot]`` reads the same ids.
    """
    d = degrees[nodes].to(torch.int32)
    base = indptr[nodes].to(torch.int32)
    u = torch.rand(d.shape, generator=generator, device=d.device)
    u = torch.minimum((u * d.to(torch.float32)).to(torch.int32),
                      (d - 1).clamp(min=0))
    r = (base + u) // WINDOW
    lo = torch.maximum(r * WINDOW, base)
    hi = torch.minimum(r * WINDOW + WINDOW, base + d)
    slots, mask = _floyd_slots(generator, (hi - lo).clamp(min=0), fanout)
    mask = mask & (d > 0)[..., None]
    # Masked slots may point past the edge list; their ids are never read.
    flat = (lo[..., None].long() + slots).clamp_(max=edge_dst.shape[0] - 1)
    return edge_dst[flat], mask


METHODS = ("floyd", "topk", "windowed")


def sample_neighbors(
    generator: torch.Generator,
    neighbors: torch.Tensor,
    degrees: torch.Tensor,
    nodes: torch.Tensor,
    fanout: int | None,
    method: str = "floyd",
    indptr: torch.Tensor | None = None,
    edge_dst: torch.Tensor | None = None,
    ell_covers_all: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample up to ``fanout`` neighbors for each node in ``nodes``.

    Args:
      generator: ``torch.Generator`` on the tensors' device.
      neighbors: padded neighbor table ``[N, width]`` (ELL view).
      degrees: true row lengths ``[N]``.
      nodes: node ids of any shape ``[...]``.
      fanout: neighbors to draw per node; ``None`` = all (deterministic).
      method: ``"floyd"`` (default), ``"topk"`` (the same semantics from one
        uniform key per ELL slot; ELL-only) or ``"windowed"`` (see
        :func:`_windowed_sample`; needs the CSR view).
      indptr/edge_dst: CSR view; required when ``ell_covers_all=False`` and
        for ``"windowed"``.
      ell_covers_all: False when hub rows overflow the ELL width — sampling
        then resolves slots through CSR (``edge_dst[indptr[v] + slot]``),
        staying uniform over the full neighbor set at any degree.

    Returns:
      ``ids[..., k]`` int32 and ``mask[..., k]`` bool with ``k = fanout``
      (or the ELL width when ``fanout`` is ``None``).
    """
    if fanout is None:
        if not ell_covers_all:
            raise ValueError(
                "fanout=None needs the full ELL view, but the table is capped "
                "below the max degree — use the CSR full-graph forward instead"
            )
        return full_neighbors(neighbors, degrees, nodes)
    if method not in METHODS:
        raise ValueError(f"unknown sampling method {method!r}")

    nodes = nodes.long()
    if method == "windowed":
        if indptr is None or edge_dst is None:
            raise ValueError("windowed sampling requires indptr and edge_dst")
        return _windowed_sample(generator, degrees, indptr, edge_dst, nodes, fanout)

    max_deg = neighbors.shape[-1]

    if not ell_covers_all:
        if indptr is None or edge_dst is None:
            raise ValueError("capped ELL sampling requires indptr and edge_dst")
        if method != "floyd":
            raise ValueError(
                f"method={method!r} is ELL-only; capped graphs sample via CSR "
                "(floyd)"
            )
        slots, mask = _floyd_slots(generator, degrees[nodes], fanout)
        flat = indptr[nodes][..., None].long() + slots
        # Masked slots of the last rows may point past the edge list; their
        # ids are never read, so clamp them into range.
        flat = flat.clamp_(max=edge_dst.shape[0] - 1)
        return edge_dst[flat], mask

    if fanout >= max_deg:
        # Every valid slot fits; pad the row out to the requested width.
        rows = neighbors[nodes]
        valid = _slot_validity(degrees[nodes], max_deg)
        pad = fanout - max_deg
        ids = torch.cat([rows, rows.new_zeros((*rows.shape[:-1], pad))], dim=-1)
        mask = torch.cat([valid, valid.new_zeros((*valid.shape[:-1], pad))], dim=-1)
        return ids, mask

    rows = neighbors[nodes]
    if method == "topk":
        # One uniform key per valid slot, padding at -1: the top ``fanout``
        # keys are a uniform ``fanout``-subset of the valid slots. Ties order
        # differently from JAX's ``lax.top_k``; only the distribution is
        # shared.
        keys = torch.rand(rows.shape, generator=generator, device=rows.device)
        scored = torch.where(_slot_validity(degrees[nodes], max_deg), keys, -1.0)
        top_vals, top_slots = torch.topk(scored, fanout, dim=-1)
        return torch.gather(rows, -1, top_slots), top_vals >= 0.0
    slots, mask = _floyd_slots(generator, degrees[nodes], fanout)
    return torch.gather(rows, -1, slots.long()), mask
