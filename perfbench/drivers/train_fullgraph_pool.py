"""Kind ``train_fullgraph_pool``: full-batch training of the max-pooling
model through the program's ``FullGraphTrainer.step``, as ``train_fullgraph``
runs the mean: every step runs every node with its complete neighbour list
and takes the loss over the whole train split; the loss is read every
``loss_every`` steps.

What the mean's shared pieces lack is here: the leaves of a max-pooling
model (each layer's pooling MLP ``pool_weight``, ``pool_bias`` beside its
``weight``), the model built with its ``pool_dim``, the check that draws
those leaves, the step's products with the pooling MLP, the ``altered``
fault on the segment max, and the spans around the program's segment max
(``pb.segment_max`` and ``pb.segment_max.backward``, read by
``segment_max_roofline``) in a ``--trace 1`` run.

Traffic parameters: ``loss_every``, ``warmup_steps``, ``trace_steps``,
``limits``.
"""

from __future__ import annotations

import math

import torch

from perfbench.harness import faults, program, training
from perfbench.harness.core import Outcome
from perfbench.inputs.graph import make_graph, splits
from perfbench.inputs.seeds import sub_seed
from perfbench.reference.maxpool import full_logits
from perfbench.reference.model import Csr, cross_entropy

OP_SPANS = ("pb.segment_max", "pb.segment_max.backward")
# The program's segment max, by the names graphsage_torch.models.graphsage
# looks it up under: the kernel's op (on the card) and the plain route.
OPS = ("segment_max", "segment_max_csr")


def leaf_shapes(config: dict) -> dict[str, tuple]:
    """The leaves in the order of the program's ``named_parameters``: the
    head, then per layer ``weight [d_in + pool, d_out]`` (``[pool, d_out]``
    without ``concat_self``), ``pool_weight [d_in, pool]``, ``pool_bias
    [pool]``."""
    m = config["model"]
    pool, dims = m["pool_dim"], [config["num_features"], *m["hidden_dims"]]
    shapes = {"head": (dims[-1], config["num_classes"])}
    for i, (d_in, d_out) in enumerate(zip(dims, dims[1:])):
        shapes[f"layers.{i}.weight"] = (pool + (d_in if m.get("concat_self") else 0), d_out)
        shapes[f"layers.{i}.pool_weight"] = (d_in, pool)
        shapes[f"layers.{i}.pool_bias"] = (pool,)
    return shapes


def make_weights(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Glorot-uniform matrices drawn on the device in one call from the
    seed, and zero biases, as the program's ``SAGELayer`` makes them."""
    shapes = leaf_shapes(config)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.rand(sum(math.prod(s) for s in shapes.values() if len(s) == 2), generator=g,
                      device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
            continue
        a, b = shape
        out[name] = (flat[at:at + a * b].view(a, b) * 2.0 - 1.0) * math.sqrt(6.0 / (a + b))
        at += a * b
    return out


def build_model(run, graph) -> tuple[torch.nn.Module, dict]:
    """The configuration's model with its ``pool_dim``, holding the
    benchmark's weights; returns it and a copy of those weights."""
    from graphsage_torch import GraphSAGE

    m = run.config["model"]
    model = GraphSAGE(graph.num_features, graph.num_classes, tuple(m["hidden_dims"]),
                      tuple(m["fanouts"]), aggregator=m["aggregator"], pool_dim=m["pool_dim"],
                      concat_self=m.get("concat_self", False),
                      compute_dtype=program.COMPUTE_DTYPES[m["compute_dtype"]],
                      sampling=m["sampling"], layer0=m["layer0"], device=run.device)
    weights = make_weights(run.config, run.seed, run.device)
    params = dict(model.named_parameters())
    if list(params) != list(weights) or any(p.shape != weights[n].shape
                                            for n, p in params.items()):
        raise ValueError(f"the model's leaves {[(n, tuple(p.shape)) for n, p in params.items()]}"
                         f" are not {[(n, tuple(w.shape)) for n, w in weights.items()]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    return model, weights


def step_products(config: dict, num_nodes: int) -> list:
    """Per layer, over all ``num_nodes`` rows: the pooling MLP ``[N, d_l] @
    [d_l, pool]``, and the concatenation's product split into its self half
    ``[N, d_l] @ [d_l, d_{l+1}]`` and its pooled half ``[N, pool] @ [pool,
    d_{l+1}]``; then the head. Layer 0's inputs (the frozen features) take
    no gradient; the pooled max always does."""
    m = config["model"]
    pool, dims = m["pool_dim"], [config["num_features"], *m["hidden_dims"]]
    products = []
    for l, (d_in, d_out) in enumerate(zip(dims, dims[1:])):
        products.append({"m": num_nodes, "k": d_in, "n": pool, "input_grad": l > 0})
        if m.get("concat_self"):
            products.append({"m": num_nodes, "k": d_in, "n": d_out, "input_grad": l > 0})
        products.append({"m": num_nodes, "k": pool, "n": d_out, "input_grad": True})
    products.append({"m": num_nodes, "k": dims[-1], "n": config["num_classes"],
                     "input_grad": True})
    return products


def plant_altered(run):
    """The ``altered`` fault: half of the rows of the segment max left at
    zero, under every name the model may look it up by."""
    from graphsage_torch.models import graphsage as gs

    saved = {name: getattr(gs, name) for name in OPS if hasattr(gs, name)}

    def halved(op):
        def half_rows(*args, **kwargs):
            out = op(*args, **kwargs)
            return torch.cat([out[: out.shape[0] // 2], torch.zeros_like(out[out.shape[0] // 2:])])
        return half_rows
    for name, op in saved.items():
        setattr(gs, name, halved(op))
    return lambda: [setattr(gs, name, op) for name, op in saved.items()]


def patch_segment_max(run):
    """In a ``--trace 1`` run, spans around the program's segment max
    (``pb.segment_max``) and its backward (``pb.segment_max.backward``, on
    autograd's thread), each call noted for the roofline. A program without
    the op (it gathers a per-edge tensor instead) gets none."""
    from graphsage_torch.models import graphsage as gs

    op = getattr(gs, "segment_max", None)
    if not run.trace or op is None:
        return lambda: None

    def note(args, kwargs, out):
        x, indptr = args[:2]
        return {"rows": x.shape[0], "cols": x.shape[1], "elem": x.element_size(),
                "indptr": indptr, "backward": False}

    forward = run.rec.wrap(op, "pb.segment_max", note)

    def wrapped(x, *args, **kwargs):
        if not (torch.is_grad_enabled() and x.requires_grad):
            return forward(x, *args, **kwargs)
        back = lambda g, gx: dict(note((g, *args), kwargs, gx), backward=True)  # noqa: E731
        return program._BackwardSpan.apply(x, forward, args, kwargs, run.rec,
                                           "pb.segment_max.backward", back)
    gs.segment_max = wrapped
    return lambda: setattr(gs, "segment_max", op)


def check(run, prog: dict, loss_fn) -> dict:
    """``training.check`` with this model's leaves: the program's first steps
    (or the control's) against the float32 reference from the same weights."""
    opt = run.config["optimizer"]
    weights = make_weights(run.config, run.seed, run.device)
    ref = training.reference_steps(run, weights, loss_fn, opt, "f32")
    if run.variant == "control":
        prog = training.reference_steps(
            run, weights, loss_fn, opt,
            training.CONTROL_PRECISION[run.config["model"]["compute_dtype"]])
    run.rec.values["readings"] = {side: {k: v for k, v in r.items() if k != "grad_vecs"}
                                  for side, r in (("program", prog), ("reference", ref))}
    return training.judge(prog, ref, run.traffic["limits"])


def run(run) -> Outcome:
    cfg, tr, rec = run.config, run.traffic, run.rec
    inputs = make_graph(cfg, run.seed, run.device)
    run.mark("inputs")
    graph = program.build_graph(run, inputs)
    model, weights = build_model(run, graph)
    from graphsage_torch import FullGraphTrainer

    trainer = FullGraphTrainer(model, graph, program.train_config(run))
    if faults.name(run) == "altered":
        restore_fault = plant_altered(run)
    else:
        restore_fault = faults.plant(run, trainer=trainer, model=model)
    step = trainer.step
    run.mark("program objects")
    prog = training.first_steps(model, trainer.optimizer, weights, step)
    rec.values["step_products"] = step_products(cfg, inputs.num_nodes)
    for _ in range(tr["warmup_steps"]):
        loss = step()
    float(loss)

    run.mark("checked steps and warm-up")
    restore_ops = patch_segment_max(run)
    run.setup_done()
    steps = training.window(run, step, tr["loss_every"], ("pb.step",) + OP_SPANS)
    _, _, train = splits(inputs.num_nodes, program.split_seed(run.seed),
                         cfg["split"]["test"], cfg["split"]["val"])
    rec.values["seeds_done"] = steps * len(train)
    program.peak_memory(run)
    restore_ops()
    restore_fault()
    del trainer, model, graph, step
    program.free(run)

    dev = run.device
    x = torch.from_numpy(inputs.features).to(dev)
    labels = torch.from_numpy(inputs.labels).to(dev)
    csr = Csr(torch.from_numpy(inputs.pairs).to(dev), inputs.num_nodes)
    train_ids = torch.from_numpy(train).to(dev)
    names = list(leaf_shapes(cfg))
    num_layers = len(cfg["model"]["hidden_dims"])

    def loss_fn(s, leaves, precision):
        p = dict(zip(names, leaves))
        layers = [(p[f"layers.{i}.weight"], p[f"layers.{i}.pool_weight"],
                   p[f"layers.{i}.pool_bias"]) for i in range(num_layers)]
        logits = full_logits(x, csr, layers, p["head"], precision,
                             cfg["model"].get("concat_self", False))
        return cross_entropy(logits[train_ids], labels[train_ids])
    checks = check(run, prog, loss_fn)
    return Outcome(attempted=steps, failed=0, checks=checks)
