"""What the training cells share: the program's first steps and what they
read, the measured window, and the check against the reference.

Set-up builds one trainer, drives it from the seed through its first
``CHECK_STEPS`` steps through the window's own call and feed, and hands that
same trainer to the window. From those steps it keeps each loss, the first
gradient as the optimizer got it (read back from the optimizer's state
after step 1) and each leaf's change after the last. After the window the
reference follows the same steps from the same weights (on the frontiers
the program sampled, which are checked against the edge list first), and
the program is judged by the worst leaf:

* ``loss_gap``: the largest gap of a step's loss, over the first step's
  reference loss (Adam takes the stand-in's loss down some hundredfold in
  three steps, and a gap relative to a loss near nought measures the
  rounding of its log-softmax, not the step);
* ``grad_gap``: ``| |g_prog| - |g_ref| |`` of a leaf over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same of the parameters' change after the last step,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf whose gradient is nought to rounding moves under
  Adam by rounding alone);
* ``grad_diff``, where the traffic file gives it a limit: ``|g_prog -
  g_ref|`` of the first gradient over the same scale, for a cell whose
  batch is so large that a gradient over half of it has nearly the same
  norm (the full-graph cell: over half and all of 153,431 nodes the norms
  are close, the gradients themselves are not).
"""

from __future__ import annotations

import statistics
import time

import torch

from perfbench.harness.record import sync

CHECK_STEPS = 3
# The next lower precision than the configuration states, the control's.
CONTROL_PRECISION = {"bfloat16": "fp8", "float32": "tf32"}
EXCLUDE_BELOW = 1e-3


def first_grad(optimizer, p) -> torch.Tensor:
    """The first gradient as the optimizer got it, from its state after one
    step (momentum: the buffer; Adam: the first moment over ``1 - beta1``);
    zeros when the step left no state."""
    state = optimizer.state.get(p, {})
    if state.get("momentum_buffer") is not None:
        return state["momentum_buffer"].detach().float().clone()
    if "exp_avg" in state:
        beta1 = optimizer.param_groups[0]["betas"][0]
        return state["exp_avg"].detach().float() / (1.0 - beta1)
    return torch.zeros_like(p, dtype=torch.float32)


def first_steps(model, optimizer, weights: dict, step) -> dict:
    """Run ``step()`` ``CHECK_STEPS`` times; the program's readings."""
    losses, grad_vecs = [], {}
    for s in range(CHECK_STEPS):
        losses.append(float(step()))
        if s == 0:
            grad_vecs = {n: first_grad(optimizer, p) for n, p in model.named_parameters()}
    changes = {n: float((p.detach().float() - weights[n]).norm())
               for n, p in model.named_parameters()}
    return {"losses": losses, "grads": {n: float(g.norm()) for n, g in grad_vecs.items()},
            "grad_vecs": grad_vecs, "changes": changes}


def window(run, step, loss_every: int, span_names: tuple) -> int:
    """Step until ``run.seconds`` have passed, reading the loss every
    ``loss_every`` steps, and synchronise; with ``--trace 1``, then profile
    ``trace_steps`` more steps. Returns the steps taken in the window."""
    def steps(n: int) -> None:
        for i in range(n):
            with run.span("pb.step"):
                loss = step()
            if (i + 1) % loss_every == 0:
                with run.span("pb.loss_read"):
                    float(loss)
        sync(run.device)

    done = 0
    t0 = time.perf_counter()
    while done == 0 or time.perf_counter() - t0 < run.seconds:
        with run.span("pb.step"):
            loss = step()
        done += 1
        if done % loss_every == 0:
            with run.span("pb.loss_read"):
                float(loss)
    sync(run.device)
    run.rec.values["window_s"] = time.perf_counter() - t0
    run.rec.values["steps"] = done
    run.profile_after_window(steps, run.traffic["trace_steps"], span_names)
    return done


def leaf_gap(prog: dict, ref: dict, scale: dict, keep) -> float:
    med = statistics.median(scale[k] for k in keep)
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in keep)


def judge(prog: dict, ref: dict, limits: dict) -> dict:
    """The three training numbers, each with its limit."""
    loss_gap = (max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
                / max(abs(ref["losses"][0]), 1e-30))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = float("inf")
    leaves = list(ref["grads"])
    g_med = statistics.median(ref["grads"].values())
    moved = [k for k in leaves if ref["grads"][k] >= EXCLUDE_BELOW * g_med]
    checks = {
        "loss_gap": (loss_gap, limits["loss_gap"]),
        "grad_gap": (leaf_gap(prog["grads"], ref["grads"], ref["grads"], leaves),
                     limits["grad_gap"]),
        "change_gap": (leaf_gap(prog["changes"], ref["changes"], ref["changes"], moved),
                       limits["change_gap"]),
    }
    if "grad_diff" in limits:
        diff = {k: float((prog["grad_vecs"][k] - ref["grad_vecs"][k]).norm()) for k in leaves}
        checks["grad_diff"] = (max(diff[k] / max(ref["grads"][k], g_med, 1e-30) for k in leaves),
                               limits["grad_diff"])
    return checks


def reference_steps(run, weights: dict, loss_fn, optimizer: dict, precision: str) -> dict:
    """The reference's ``CHECK_STEPS`` steps from ``weights``:
    ``loss_fn(step, leaves, precision)`` gives step ``step``'s loss."""
    from perfbench.reference.model import optimizer_step

    names = list(weights)
    leaves = [weights[n].detach().clone().requires_grad_(True) for n in names]
    start = [p.detach().clone() for p in leaves]
    state, losses, grad_vecs = {}, [], {}
    for s in range(CHECK_STEPS):
        loss = loss_fn(s, leaves, precision)
        g = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if s == 0:
            grad_vecs = {n: x.detach().clone() for n, x in zip(names, g)}
        with torch.no_grad():
            optimizer_step(optimizer, leaves, list(g), state)
    changes = {n: float((p.detach() - p0).norm()) for n, p, p0 in zip(names, leaves, start)}
    return {"losses": losses, "grads": {n: float(g.norm()) for n, g in grad_vecs.items()},
            "grad_vecs": grad_vecs, "changes": changes}


def check(run, prog: dict, loss_fn) -> dict:
    """Judge the program's first steps (or, for the control, the reference
    in the next lower precision) against the float32 reference."""
    from perfbench.inputs.weights import make_weights
    from perfbench.reference.precision import no_tf32

    no_tf32()
    weights = make_weights(run.config, run.seed, run.device)
    opt = run.config["optimizer"]
    ref = reference_steps(run, weights, loss_fn, opt, "f32")
    if run.variant == "control":
        prog = reference_steps(run, weights, loss_fn, opt,
                               CONTROL_PRECISION[run.config["model"]["compute_dtype"]])
    run.rec.values["readings"] = {side: {k: v for k, v in r.items() if k != "grad_vecs"}
                                  for side, r in (("program", prog), ("reference", ref))}
    return judge(prog, ref, run.traffic["limits"])
