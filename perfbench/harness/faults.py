"""Faults planted in the program for the calibration and the tests (a
benchmark run never plants one): each breaks the timed path the way a
faulty change could, and ``correct`` has to come out false.

* ``unchanged``: the optimizer's step returns the state unchanged;
* ``half_batch``: half of the batch is left out of the loss, the mean taken
  over the rest (full-graph: half of the train split);
* ``altered``: an answer altered where it is produced: a sampled child
  replaced by another node (training), a served row's logits reordered
  (serving), half of the rows of the CSR mean left at zero (full-graph);
* ``first_k``: a sampler that takes each parent's first ``min(deg, k)``
  neighbours in the program's CSR, not a uniform draw;
* ``fixed_sample``: a sampler that takes the same ``k`` neighbours of a
  node on every draw (from a start fixed by the node's id).

The exchange between chips has no fault here: every cell runs on one chip.
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered", "first_k", "fixed_sample")
SAMPLER_FAULTS = ("first_k", "fixed_sample")


def name(run) -> str | None:
    return run.variant.split(":", 1)[1] if run.variant.startswith("fault:") else None


def plant(run, *, trainer=None, model=None, engine=None):
    """Plant the run's fault; returns a function that takes out what the
    fault patched at module level or on the model's sampler."""
    fault = name(run)
    if fault is None:
        return lambda: None
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault in SAMPLER_FAULTS:
        sample = model.sample
        model.sample = fixed_sampler(model, fault)
        return lambda: setattr(model, "sample", sample)
    if fault == "unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch" and hasattr(trainer, "_train_weight"):
        w = trainer._train_weight
        on = torch.nonzero(w).reshape(-1)
        w[on[: on.numel() // 2]] = 0.0
        trainer._train_count = float(w.sum())
    elif fault == "half_batch":
        loss = model.classification_loss
        model.classification_loss = lambda logits, labels: loss(logits, labels)[
            : labels.shape[0] // 2]
    elif fault == "altered" and engine is not None:
        produce = engine._logits

        def reordered(nodes):
            rows, logits, n = produce(nodes)
            return rows, torch.roll(logits, 1, dims=1), n
        engine._logits = reordered
    elif fault == "altered" and hasattr(trainer, "_train_weight"):
        from graphsage_torch.models import graphsage as gs

        spmm = gs.spmm_mean

        def half_rows(*args, **kwargs):
            out = spmm(*args, **kwargs)
            return torch.cat([out[: out.shape[0] // 2], torch.zeros_like(out[out.shape[0] // 2:])])
        gs.spmm_mean = half_rows
        return lambda: setattr(gs, "spmm_mean", spmm)
    else:
        sample = model.sample

        def altered(gen, graph, seeds, fanouts=None):
            fr = sample(gen, graph, seeds, fanouts)
            # A node is never its own neighbour: the first valid child that
            # is not its parent (column 0 is, under concat_self) becomes it.
            last = fr.ids[-1].clone()
            k = last.numel() // fr.ids[-2].numel()
            parent = fr.ids[-2].repeat_interleave(k)
            j = int(torch.nonzero(fr.masks[-1] & (last != parent))[0])
            last[j] = parent[j]
            return type(fr)(ids=fr.ids[:-1] + (last,), masks=fr.masks)
        model.sample = altered
    return lambda: None


def fixed_sampler(model, fault: str):
    """``model.sample`` with the sampler broken as ``fault`` says: each
    valid parent takes ``min(deg, k)`` distinct neighbours from its row of
    the program's CSR, from position 0 (``first_k``) or from a position
    fixed by its id (``fixed_sample``), cyclically."""
    sample = model.sample

    def broken(gen, graph, seeds, fanouts=None):
        fr = sample(gen, graph, seeds, fanouts)  # the shapes and the types
        fanouts = model.fanouts if fanouts is None else tuple(fanouts)
        num_layers = len(fr.ids) - 1
        ids, masks = [fr.ids[0]], [fr.masks[0]]
        for hop in range(1, num_layers + 1):
            p, pm = ids[-1].long(), masks[-1]
            k = fanouts[model.num_layers - hop]
            deg = graph.degrees[p].long()
            j = torch.arange(k, device=p.device)
            valid = (j[None, :] < deg.clamp(max=k)[:, None]) & pm[:, None]
            start = torch.zeros_like(p) if fault == "first_k" else (p * 2654435761) % deg.clamp(min=1)
            at = graph.indptr[p].long()[:, None] + (start[:, None] + j) % deg.clamp(min=1)[:, None]
            child = torch.where(valid, graph.edge_dst[at.clamp(max=graph.edge_dst.numel() - 1)].long(), 0)
            if model.concat_self:
                child = torch.cat([p[:, None], child], dim=1)
                valid = torch.cat([pm[:, None], valid], dim=1)
            ids.append(child.reshape(-1).to(fr.ids[hop].dtype))
            masks.append(valid.reshape(-1))
        return type(fr)(ids=tuple(ids), masks=tuple(masks))
    return broken
