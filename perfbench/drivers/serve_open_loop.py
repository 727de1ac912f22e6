"""Kind ``serve_open_loop``: open-loop requests to the program's
``ServingEngine`` (``mode``: ``"sampled"``), one process, one thread.

The schedule (``inputs/schedule.py``) is due from the moment the window
opens; each request is sent at its due time, or as soon as the previous
one has been answered, and is timed from its due time to the moment its
logits are on the host, so a stall counts for every request it delays.
Requests due in the window are all answered, however late. The
generator's own lateness (how long after it could have sent a request it
did) goes to standard error.

After the window a sample of the answered requests drawn from the seed,
with the largest among them, is judged: its frontier (recorded as the
program sampled it) against the edge list, and the served logits against
the reference's over that frontier: ``answer_gap`` is the widest gap by
which the reference's logit of a served argmax lies below its best, and
``logit_gap`` the largest difference of a served logit from the
reference's, over the largest reference logit of its request.

Traffic parameters: ``mode``, ``buckets``, ``rate`` (requests per
second), ``size_min``, ``size_max``, ``zipf_exponent``, ``base_seed``,
``warmup_requests`` (per bucket), ``check_requests``, ``trace_requests``
(the profiled stretches of a ``--trace 1`` run: the schedule's first
requests again, after the window), ``limits``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench.harness import faults, program
from perfbench.harness.core import Outcome
from perfbench.harness.training import CONTROL_PRECISION
from perfbench.inputs.graph import make_graph, splits
from perfbench.inputs.schedule import make_schedule
from perfbench.inputs.seeds import sub_seed
from perfbench.reference.frontier import frontier_faults, sample_repeats, sample_skew
from perfbench.reference.model import Csr, sampled_logits
from perfbench.reference.precision import no_tf32

SPIN_S = 0.002


def wait_until(t: float) -> None:
    """Sleep to ``SPIN_S`` before ``t``, then spin: a sleep alone wakes up
    late by up to a scheduler tick."""
    rest = t - time.perf_counter()
    if rest > SPIN_S:
        time.sleep(rest - SPIN_S)
    while time.perf_counter() < t:
        pass


def open_loop(run, engine, sched, chosen=(), current=None, served=None):
    """Send every request of ``sched`` at its due time (or when the previous
    one is answered); returns each request's latency (``inf`` when it
    failed), the generator's lateness and the failures. The answers of
    the ``chosen`` requests go to ``served``, and ``current[0]`` names the
    chosen request in flight."""
    lat = np.full(len(sched), np.inf)
    late = np.zeros(len(sched))
    service = np.zeros(len(sched))
    failed, free_at = 0, 0.0
    base = time.perf_counter()
    for i in range(len(sched)):
        due = base + sched.due[i]
        with run.span("pb.wait"):
            wait_until(due)
        start = time.perf_counter()
        late[i] = start - max(due, free_at)
        if current is not None:
            current[0] = i if i in chosen else None
        try:
            with run.span("pb.request"):
                out = engine.logits(sched.ids[i])
        except Exception as e:  # a failed request counts as missing
            failed += 1
            print(f"request {i} failed: {e!r}", file=sys.stderr)
            out = None
        free_at = time.perf_counter()
        service[i] = free_at - start
        if out is not None:
            lat[i] = free_at - due
            if i in chosen:
                served[i] = out
    if current is not None:
        current[0] = None
    run.rec.values["service_s"] = service
    return lat, late, failed


def run(run) -> Outcome:
    cfg, tr, rec = run.config, run.traffic, run.rec
    inputs = make_graph(cfg, run.seed, run.device)
    run.mark("inputs")
    graph = program.build_graph(run, inputs)
    model, _ = program.build_model(run, graph)
    from graphsage_torch import ServingEngine

    engine = ServingEngine(model, graph, mode=tr["mode"], batch_buckets=tuple(tr["buckets"]),
                           seed=sub_seed(run.seed, "serve", bits=32), device=run.device)
    restore_fault = faults.plant(run, model=engine.model, engine=engine)
    test, _, _ = splits(inputs.num_nodes, program.split_seed(run.seed),
                        cfg["split"]["test"], cfg["split"]["val"])
    sched = make_schedule(tr, run.seconds, run.seed, test)

    rng = np.random.default_rng(sub_seed(run.seed, "check"))
    chosen = set(rng.choice(len(sched), size=min(tr["check_requests"], len(sched)),
                            replace=False).tolist())
    chosen.add(int(np.argmax(sched.sizes)))
    captured, served = {}, {}
    sample = engine.model.sample
    current = [None]

    def capture(gen, g, seeds, fanouts=None):
        fr = sample(gen, g, seeds, fanouts)
        if current[0] is not None:
            captured[current[0]] = fr
        return fr
    engine.model.sample = capture

    warm = np.random.default_rng(sub_seed(run.seed, "warmup"))
    bounds = [0, *tr["buckets"]]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        for _ in range(tr["warmup_requests"]):
            engine.logits(warm.choice(test, size=int(warm.integers(lo + 1, hi + 1))))

    run.mark("warm-up")
    restore_ops = program.patch_ops(run)
    if run.trace:
        engine.model.sample = rec.wrap(capture, "pb.sample")
    run.setup_done()

    lat, late, failed = open_loop(run, engine, sched, chosen, current, served)
    service = rec.values["service_s"]
    run.profile_after_window(lambda n: open_loop(run, engine, sched.head(n)),
                             tr["trace_requests"], ("pb.request", "pb.wait") + program.OP_SPANS)
    rec.values["window_s"] = run.seconds
    rec.values["latencies_s"] = lat
    print(f"generator lateness: mean {1e3 * late.mean():.4f} ms, max {1e3 * late.max():.4f} ms, "
          f"{len(sched)} requests due in {run.seconds} s; service mean "
          f"{1e3 * service.mean():.4f} ms, busy {service.sum() / run.seconds:.4f} of the window",
          file=sys.stderr)
    program.peak_memory(run)
    restore_ops()
    restore_fault()
    engine.model.sample = sample
    del engine, model, graph, sample
    program.free(run)
    return Outcome(attempted=len(sched), failed=failed,
                   checks=judge(run, inputs, sched, captured, served, failed))


def judge(run, inputs, sched, captured: dict, served: dict, failed: int) -> dict:
    no_tf32()
    dev = run.device
    from perfbench.inputs.weights import make_weights

    w = make_weights(run.config, run.seed, dev)
    leaves = list(w.values())
    x = torch.from_numpy(inputs.features).to(dev)
    csr = Csr(torch.from_numpy(inputs.pairs).to(dev), inputs.num_nodes)
    bad, gap, logit_gap, drawn = 0, 0.0, 0.0, []
    concat = run.config["model"].get("concat_self", False)
    control = CONTROL_PRECISION[run.config["model"]["compute_dtype"]]
    for i, out in served.items():
        fr = captured.get(i)
        if fr is None:
            bad += 1
            continue
        n = len(sched.ids[i])
        seeds = fr.ids[0].clone()
        seeds[:n] = torch.from_numpy(sched.ids[i]).to(seeds)
        bad += frontier_faults(csr, fr.ids, fr.masks, seeds, concat)
        drawn.append((fr.ids, fr.masks))
        with torch.no_grad():
            ref = sampled_logits(x, fr.ids, fr.masks, leaves[:-1], leaves[-1], "f32",
                                 concat)[:n]
            if run.variant == "control":
                out = sampled_logits(x, fr.ids, fr.masks, leaves[:-1], leaves[-1],
                                     control, concat)[:n].cpu().numpy()
        if out.shape != tuple(ref.shape):
            bad += 1
            continue
        served_logits = torch.from_numpy(np.asarray(out)).to(dev, torch.float32)
        pick = served_logits.argmax(dim=1)
        best = ref.max(dim=1).values
        gap = max(gap, float((best - ref.gather(1, pick[:, None])[:, 0]).max()))
        scale = float(ref.abs().max().clamp(min=1e-30))
        logit_gap = max(logit_gap, float((served_logits - ref).abs().max()) / scale)
    lim = run.traffic["limits"]
    run.rec.values["readings"] = {"answer_gap": gap, "logit_gap": logit_gap,
                                  "checked": len(served)}
    return {"unanswered": (failed, lim["unanswered"]),
            "frontier_faults": (bad, lim["frontier_faults"]),
            "sample_skew": (sample_skew(csr, drawn, concat), lim["sample_skew"]),
            # Within each request: the engine seeds its generator alike for
            # every request (its answers are reproducible), so a node that
            # sits at the same place in two requests draws alike by design.
            "sample_repeats": (sum(sample_repeats(csr, [d], concat) for d in drawn),
                               lim["sample_repeats"]),
            "answer_gap": (gap, lim["answer_gap"]),
            "logit_gap": (logit_gap, lim["logit_gap"])}
