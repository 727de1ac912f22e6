"""Kind ``train_sampled``: sampled supervised training through the
program's ``Trainer.step`` on its epoch-shuffled batches of the train split
(``Trainer.batches``), the loss read every ``loss_every`` steps.

Traffic parameters: ``loss_every``, ``warmup_steps`` (after the checked
steps, in set-up), ``trace_steps`` (the profiled stretches of a
``--trace 1`` run, after the window), ``limits``.
"""

from __future__ import annotations

import torch

from perfbench.harness import faults, program, training
from perfbench.harness.core import Outcome
from perfbench.inputs.graph import make_graph, splits
from perfbench.reference.frontier import frontier_faults, sample_repeats, sample_skew
from perfbench.reference.model import Csr, cross_entropy, sampled_logits


def step_products(config: dict, ids) -> list:
    """The step's dense products over the frontier's shapes: layer ``l``
    maps the rows of hop ``L - 1 - l`` from ``d_l`` columns (``2 d_l`` with
    ``concat_self``); layer 0's input (frozen features) takes no gradient."""
    dims = [config["num_features"], *config["model"]["hidden_dims"]]
    rows = 2 if config["model"].get("concat_self") else 1
    num_layers = len(dims) - 1
    out = [{"m": ids[num_layers - 1 - l].numel(), "k": rows * dims[l], "n": dims[l + 1],
            "input_grad": l > 0} for l in range(num_layers)]
    out.append({"m": ids[0].numel(), "k": dims[-1], "n": config["num_classes"],
                "input_grad": True})
    return out


def run(run) -> Outcome:
    cfg, tr, rec = run.config, run.traffic, run.rec
    inputs = make_graph(cfg, run.seed, run.device)
    run.mark("inputs")
    graph = program.build_graph(run, inputs)
    model, weights = program.build_model(run, graph)
    from graphsage_torch import Trainer

    trainer = Trainer(model, graph, program.train_config(run))
    restore_fault = faults.plant(run, trainer=trainer, model=model)
    batches = trainer.batches()
    step = lambda: trainer.step(next(batches))  # noqa: E731

    captured = []
    sample = model.sample

    def capture(gen, g, seeds, fanouts=None):
        fr = sample(gen, g, seeds, fanouts)
        captured.append(fr)
        return fr
    model.sample = capture
    run.mark("program objects")
    prog = training.first_steps(model, trainer.optimizer, weights, step)
    model.sample = sample
    rec.values["step_products"] = step_products(cfg, captured[0].ids)
    for _ in range(tr["warmup_steps"]):
        loss = step()
    float(loss)

    run.mark("checked steps and warm-up")
    restore_ops = program.patch_ops(run)
    if run.trace:
        model.sample = rec.wrap(sample, "pb.sample")
    run.setup_done()
    steps = training.window(run, step, tr["loss_every"], ("pb.step",) + program.OP_SPANS)
    rec.values["seeds_done"] = steps * cfg["batch_size"]
    program.peak_memory(run)
    restore_ops()
    restore_fault()
    del trainer, model, graph, step, batches, sample
    program.free(run)

    dev = run.device
    x = torch.from_numpy(inputs.features).to(dev)
    labels = torch.from_numpy(inputs.labels).to(dev)
    csr = Csr(torch.from_numpy(inputs.pairs).to(dev), inputs.num_nodes)
    _, _, train = splits(inputs.num_nodes, program.split_seed(run.seed),
                         cfg["split"]["test"], cfg["split"]["val"])
    is_train = torch.zeros(inputs.num_nodes, dtype=torch.bool, device=dev)
    is_train[torch.from_numpy(train).to(dev)] = True
    concat = cfg["model"].get("concat_self", False)
    bad = 0
    seen = torch.zeros_like(is_train)
    for fr in captured:
        seeds = fr.ids[0].long()
        bad += frontier_faults(csr, fr.ids, fr.masks, fr.ids[0], concat)
        # Seeds from the train split, and no row twice in the checked steps.
        bad += int((~is_train[seeds]).sum()) + int(seen[seeds].sum())
        bad += seeds.numel() - int(torch.unique(seeds).numel())
        seen[seeds] = True
    if len(captured) != training.CHECK_STEPS:
        bad += 1

    def loss_fn(s, leaves, precision):
        fr = captured[s]
        logits = sampled_logits(x, fr.ids, fr.masks, leaves[:-1], leaves[-1], precision,
                                concat)
        return cross_entropy(logits, labels[fr.ids[0].long()])
    drawn = [(fr.ids, fr.masks) for fr in captured]
    lim = tr["limits"]
    checks = {"frontier_faults": (bad, lim["frontier_faults"]),
              "sample_skew": (sample_skew(csr, drawn, concat), lim["sample_skew"]),
              "sample_repeats": (sample_repeats(csr, drawn, concat), lim["sample_repeats"])}
    checks.update(training.check(run, prog, loss_fn))
    return Outcome(attempted=steps, failed=0, checks=checks)
