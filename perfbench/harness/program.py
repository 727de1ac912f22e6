"""Building the program's objects from the benchmark's inputs: the graph
through the program's public ``build_graph`` (its ingestion, timed into
``build_graph_s``), the model with the benchmark's weights copied in, and
the training configuration. Everything of ``graphsage_torch`` that a driver
touches is imported here or in the driver, inside functions."""

from __future__ import annotations

import time

import torch

from perfbench.harness.record import sync
from perfbench.inputs.graph import GraphInputs
from perfbench.inputs.seeds import sub_seed
from perfbench.inputs.weights import make_weights

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def split_seed(seed: int) -> int:
    """The 32-bit seed of the program's split (numpy's ``RandomState``)."""
    return sub_seed(seed, "split", bits=32)


def build_graph(run, inputs: GraphInputs):
    from graphsage_torch import build_graph as program_build_graph

    t0 = time.perf_counter()
    graph = program_build_graph(inputs.features, inputs.labels, inputs.pairs,
                                num_classes=inputs.num_classes, undirected=True,
                                feature_dtype=inputs.feature_dtype, device=run.device)
    sync(run.device)
    run.rec.values["build_graph_s"] = time.perf_counter() - t0
    run.mark("build_graph")
    return graph


def build_model(run, graph) -> tuple[torch.nn.Module, dict]:
    """The configuration's model, holding the benchmark's weights; returns it
    and a copy of those weights (the reference draws its own)."""
    from graphsage_torch import GraphSAGE

    m = run.config["model"]
    model = GraphSAGE(graph.num_features, graph.num_classes, tuple(m["hidden_dims"]),
                      tuple(m["fanouts"]), aggregator=m["aggregator"],
                      concat_self=m.get("concat_self", False),
                      compute_dtype=COMPUTE_DTYPES[m["compute_dtype"]],
                      sampling=m["sampling"], layer0=m["layer0"], device=run.device)
    weights = make_weights(run.config, run.seed, run.device)
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the model's leaves {sorted(params)} are not {sorted(weights)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    return model, weights


def train_config(run):
    from graphsage_torch import TrainConfig

    cfg, opt = run.config, run.config["optimizer"]
    return TrainConfig(batch_size=cfg.get("batch_size", 1), learning_rate=opt["lr"],
                       optimizer=opt["name"], momentum=opt.get("momentum", 0.9),
                       seed=split_seed(run.seed), test_size=cfg["split"]["test"],
                       val_size=cfg["split"]["val"], batching="epoch", log_every=0)


def peak_memory(run) -> None:
    if run.device.type == "cuda":
        sync(run.device)
        run.rec.values["memory_peak_bytes"] = torch.cuda.max_memory_allocated(run.device)


def free(run) -> None:
    """Release the program's device memory before the reference runs."""
    import gc

    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


class _BackwardSpan(torch.autograd.Function):
    """``fn(x, *args, **kwargs)`` as one node whose backward runs ``fn``'s
    own backward inside the span ``name`` (on autograd's thread), so that
    the trace attributes its kernels to the op as it does the forward's."""

    @staticmethod
    def forward(ctx, x, fn, args, kwargs, rec, name, note):
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            out = fn(xd, *args, **kwargs)
        ctx.inner, ctx.rec, ctx.name, ctx.note = (xd, out), rec, name, note
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        xd, out = ctx.inner
        with ctx.rec.span(ctx.name):
            (gx,) = torch.autograd.grad(out, xd, g)
        if ctx.rec.traced:
            ctx.rec.calls[ctx.name].append(ctx.note(g, gx))
        ctx.inner = None
        return gx, None, None, None, None, None, None


def patch_ops(run):
    """In a ``--trace 1`` run, spans around the ops the model looks up by
    name in ``graphsage_torch.models.graphsage``: the sampled neighbour mean
    (``gather_mean``) and the CSR mean (``spmm_mean``, and its backward,
    where its input takes a gradient), each call noted for the rooflines.
    Returns a function that restores them."""
    if not run.trace:
        return lambda: None
    from graphsage_torch.models import graphsage as gs

    saved = {"gather_mean": gs.gather_mean, "spmm_mean": gs.spmm_mean}

    def note_mean(args, kwargs, out):
        table, idx, mask = args[:3]
        return {"rows": table.shape[0], "cols": table.shape[1], "elem": table.element_size(),
                "idx": idx, "mask": mask, "out_bytes": out.numel() * out.element_size()}

    def note_spmm(args, kwargs, out):
        x, _src, dst, _mask, n = args[:5]
        return {"rows": n, "cols": x.shape[1], "elem": x.element_size(),
                "indptr": kwargs.get("indptr"), "idx_elem": dst.element_size(),
                "out_bytes": out.numel() * out.element_size()}

    gs.gather_mean = run.rec.wrap(saved["gather_mean"], "pb.neighbor_mean", note_mean)
    spmm_forward = run.rec.wrap(saved["spmm_mean"], "pb.spmm_mean", note_spmm)

    def spmm(x, *args, **kwargs):
        if not (torch.is_grad_enabled() and x.requires_grad):
            return spmm_forward(x, *args, **kwargs)
        note = lambda g, gx: note_spmm((g, *args), kwargs, gx)  # noqa: E731
        return _BackwardSpan.apply(x, spmm_forward, args, kwargs, run.rec,
                                   "pb.spmm_mean.backward", note)
    gs.spmm_mean = spmm

    def restore():
        for name, fn in saved.items():
            setattr(gs, name, fn)
    return restore


OP_SPANS = ("pb.neighbor_mean", "pb.spmm_mean", "pb.spmm_mean.backward")
