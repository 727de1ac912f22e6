"""Checks of sampled frontiers against the benchmark's own edge list.

A fixed-fanout sample without replacement (the configurations' sampler)
gives each valid parent exactly ``min(degree, k)`` valid children, all of
them distinct neighbours of the parent, and a masked parent none; with
``concat_self`` each row's column 0 is the parent itself, under the
parent's mask, ahead of the ``k`` children. The count of entries that
break one of these rules is exact: its limit is 0.

The sample is also uniform: every ``k``-subset of a parent's neighbours is
as likely as any other, on every draw. Two numbers test that over the
checked frontiers, for the parents with more than ``k`` neighbours:

* :func:`sample_skew`: where the children sit in their parent's row of the
  sorted edge list. A child's position over ``degree - 1`` has mean 1/2
  under a uniform draw, with a variance known exactly (a draw without
  replacement from a discrete uniform); the statistic is the sum of the
  deviations over its standard deviation, a standard normal's absolute
  value when the sample is sound. A sampler that prefers the first or the
  last neighbours reads hundreds.
* :func:`sample_repeats`: how many draws of a parent repeat, child for
  child, an earlier draw of the same parent, among parents with at least
  ``REPEAT_SUBSETS`` subsets to draw from (so that a sound sampler repeats
  with a chance under one in a million a pair). A sampler that draws the
  same set for a node each time reads a repeat for nearly every hub.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.model import Csr

REPEAT_SUBSETS = 1e9


def _rows(ids, masks, hop: int):
    """Hop ``hop``'s parents, their mask, and their children ``[rows, k]``
    with the children's mask; ``None`` when the hop's size is no multiple
    of its parents'."""
    parents = ids[hop - 1].long().reshape(-1)
    pmask = masks[hop - 1].reshape(-1)
    rows = parents.numel()
    if rows == 0 or ids[hop].numel() % rows:
        return None
    k = ids[hop].numel() // rows
    child = ids[hop].long().reshape(rows, k)
    cmask = masks[hop].reshape(rows, k)
    return parents, pmask, child, cmask


def frontier_faults(csr: Csr, ids, masks, seeds: torch.Tensor,
                    concat_self: bool = False) -> int:
    """Entries of the frontier ``(ids, masks)`` grown from ``seeds`` that
    break the sampler's rules: hop 0 other than the seeds, a valid child
    that is not a neighbour of its parent, a repeated valid child, a row
    whose valid count is not ``min(degree, k)`` (0 under a masked parent),
    and under ``concat_self`` a column 0 other than the parent or its
    mask."""
    n = csr.num_nodes
    bad = int((ids[0].long().reshape(-1) != seeds.long().reshape(-1)).sum())
    bad += int((~masks[0]).sum())
    for hop in range(1, len(ids)):
        got = _rows(ids, masks, hop)
        if got is None:
            return bad + max(ids[hop].numel(), 1)
        parents, pmask, child, cmask = got
        if concat_self:
            bad += int((child[:, 0] != parents).sum()) + int((cmask[:, 0] != pmask).sum())
            child, cmask = child[:, 1:], cmask[:, 1:]
        rows, k = child.shape
        in_range = (child >= 0) & (child < n)
        key = parents[:, None] * n + child.clamp(0, n - 1)
        at = torch.searchsorted(csr.keys, key.reshape(-1)).clamp_(max=csr.keys.numel() - 1)
        found = (csr.keys[at] == key.reshape(-1)).view(rows, k) & in_range
        bad += int((cmask & ~found).sum())
        # Repeats: sort each row with masked slots moved out of the way.
        marked = torch.where(cmask, child, -1 - torch.arange(k, device=child.device))
        srt = torch.sort(marked, dim=1).values
        bad += int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum())
        want = torch.where(pmask, csr.degrees[parents].clamp(max=k), 0)
        bad += int((cmask.sum(dim=1) != want).sum())
    return bad


def _sampled_rows(csr: Csr, frontiers, concat_self: bool):
    """For every hop of every frontier: the valid parents with more
    neighbours than ``k``, their degrees and their children's positions in
    their rows of the sorted edge list ``[rows, k]`` (each row full)."""
    n = csr.num_nodes
    for ids, masks in frontiers:
        for hop in range(1, len(ids)):
            got = _rows(ids, masks, hop)
            if got is None:
                continue
            parents, pmask, child, cmask = got
            if concat_self:
                child, cmask = child[:, 1:], cmask[:, 1:]
            k = child.shape[1]
            deg = csr.degrees[parents]
            keep = pmask & (deg > k) & cmask.all(dim=1)
            parents, child, deg = parents[keep], child[keep], deg[keep]
            if parents.numel() == 0:
                continue
            start = torch.searchsorted(csr.keys, parents * n)
            pos = torch.searchsorted(csr.keys, (parents[:, None] * n + child).reshape(-1))
            yield parents, deg, pos.view(-1, k) - start[:, None], k


def sample_skew(csr: Csr, frontiers, concat_self: bool = False) -> float:
    """``|sum (u - 1/2)| / sd`` over every child ``u = position / (deg - 1)``
    of a parent with more than ``k`` neighbours; 0 when there is none. A
    row's ``k`` positions drawn without replacement from ``0 .. deg - 1``
    sum with variance ``k (deg^2 - 1) / 12 * (deg - k) / (deg - 1)``."""
    dev, var = 0.0, 0.0
    for _, deg, pos, k in _sampled_rows(csr, frontiers, concat_self):
        d = deg.to(torch.float64)
        u = pos.to(torch.float64) / (d - 1)[:, None]
        dev += float((u - 0.5).sum())
        var += float((k * (d * d - 1) / 12 * (d - k) / (d - 1) / (d - 1) ** 2).sum())
    return abs(dev) / math.sqrt(var) if var > 0 else 0.0


def sample_repeats(csr: Csr, frontiers, concat_self: bool = False) -> int:
    """Draws of a parent whose children, as a set, repeat an earlier draw
    of the same parent with the same ``k``, among parents whose degree
    gives at least ``REPEAT_SUBSETS`` subsets of ``k``."""
    keys = []
    for parents, deg, pos, k in _sampled_rows(csr, frontiers, concat_self):
        d = deg.to(torch.float64)
        log_subsets = torch.lgamma(d + 1) - torch.lgamma(d - k + 1) - math.lgamma(k + 1)
        many = log_subsets >= math.log(REPEAT_SUBSETS)
        srt = torch.sort(pos[many], dim=1).values
        # Two polynomial hashes of the sorted positions (wrapping int64).
        h1 = torch.zeros(srt.shape[0], dtype=torch.int64, device=srt.device)
        h2 = torch.zeros_like(h1)
        for j in range(k):
            h1 = h1 * 1000003 + srt[:, j]
            h2 = h2 * 998244353 + srt[:, j] * 7 + 1
        keys.append(torch.stack([parents[many], torch.full_like(h1, k), h1, h2], dim=1))
    if not keys:
        return 0
    every = torch.cat(keys)
    return every.shape[0] - torch.unique(every, dim=0).shape[0]
