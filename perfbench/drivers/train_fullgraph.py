"""Kind ``train_fullgraph``: full-batch training through the program's
``FullGraphTrainer.step``: every step runs every node with its complete
neighbour list and takes the loss over the whole train split; the loss is
read every ``loss_every`` steps.

Traffic parameters: ``loss_every``, ``warmup_steps``, ``trace_steps``,
``limits``.
"""

from __future__ import annotations

import torch

from perfbench.harness import faults, program, training
from perfbench.harness.core import Outcome
from perfbench.inputs.graph import make_graph, splits
from perfbench.reference.model import Csr, cross_entropy, full_logits


def step_products(config: dict, num_nodes: int) -> list:
    """Every layer and the head map all ``num_nodes`` rows, a layer from
    ``2 d_l`` columns with ``concat_self``; layer 0's input (the frozen
    features) takes no gradient."""
    dims = [config["num_features"], *config["model"]["hidden_dims"], config["num_classes"]]
    rows = 2 if config["model"].get("concat_self") else 1
    return [{"m": num_nodes, "k": (rows if l < len(dims) - 2 else 1) * dims[l],
             "n": dims[l + 1], "input_grad": l > 0} for l in range(len(dims) - 1)]


def run(run) -> Outcome:
    cfg, tr, rec = run.config, run.traffic, run.rec
    inputs = make_graph(cfg, run.seed, run.device)
    run.mark("inputs")
    graph = program.build_graph(run, inputs)
    model, weights = program.build_model(run, graph)
    from graphsage_torch import FullGraphTrainer

    trainer = FullGraphTrainer(model, graph, program.train_config(run))
    restore_fault = faults.plant(run, trainer=trainer, model=model)
    step = trainer.step
    run.mark("program objects")
    prog = training.first_steps(model, trainer.optimizer, weights, step)
    rec.values["step_products"] = step_products(cfg, inputs.num_nodes)
    for _ in range(tr["warmup_steps"]):
        loss = step()
    float(loss)

    run.mark("checked steps and warm-up")
    restore_ops = program.patch_ops(run)
    run.setup_done()
    steps = training.window(run, step, tr["loss_every"], ("pb.step",) + program.OP_SPANS)
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

    def loss_fn(s, leaves, precision):
        logits = full_logits(x, csr, leaves[:-1], leaves[-1], precision,
                             cfg["model"].get("concat_self", False))
        return cross_entropy(logits[train_ids], labels[train_ids])
    checks = training.check(run, prog, loss_fn)
    return Outcome(attempted=steps, failed=0, checks=checks)
