"""Find the highest request rate the program sustains at a serving cell's
mix: open-loop runs at each rate in turn, in one process, on one graph.
A rate is sustained when the backlog does not grow: the mean latency of
the last third of its requests is within twice that of the first third.
Not part of a benchmark run; the cell's traffic file keeps the rate chosen.

    python3 perfbench/tools/serve_sweep.py --workload reddit-sampled-serve \\
        --config reddit --seed 1 --seconds 10 --rates 80,100,120,140
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import common  # noqa: F401  (puts the checkout on sys.path)
from perfbench.harness import program
from perfbench.harness.spec import BENCH_DIR, load_module
from perfbench.inputs.graph import make_graph, splits
from perfbench.inputs.schedule import make_schedule
from perfbench.inputs.seeds import sub_seed


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="reddit-sampled-serve")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--config", help="a parked cell's configuration")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", required=True)
    p.add_argument("--repeats", type=int, default=1)
    a = p.parse_args()
    run = common.make_run(a.workload, a.seed, a.seconds, config=a.config)
    cfg, tr = run.config, dict(run.traffic)
    driver = load_module(BENCH_DIR / "drivers" / f"{tr['kind']}.py", "sweep_driver")
    inputs = make_graph(cfg, run.seed, run.device)
    graph = program.build_graph(run, inputs)
    model, _ = program.build_model(run, graph)
    from graphsage_torch import ServingEngine

    engine = ServingEngine(model, graph, mode=tr["mode"], batch_buckets=tuple(tr["buckets"]),
                           seed=sub_seed(run.seed, "serve", bits=32), device=run.device)
    test, _, _ = splits(inputs.num_nodes, program.split_seed(run.seed),
                        cfg["split"]["test"], cfg["split"]["val"])
    warm = make_schedule(dict(tr, rate=50), 2.0, run.seed + 1, test)
    for ids in warm.ids:
        engine.logits(ids)
    for rate in (float(r) for r in a.rates.split(",")):
        for rep in range(a.repeats):
            sched = make_schedule(dict(tr, rate=rate), a.seconds, run.seed + rep, test)
            lat, late, failed = driver.open_loop(run, engine, sched)
            third = max(len(lat) // 3, 1)
            first, last = lat[:third].mean(), lat[-third:].mean()
            print(json.dumps({
                "rate": rate, "seconds": a.seconds, "repeat": rep, "requests": len(sched),
                "failed": failed,
                "p50_ms": 1e3 * float(np.percentile(lat, 50)),
                "p95_ms": 1e3 * float(np.percentile(lat, 95)),
                "first_third_ms": 1e3 * float(first), "last_third_ms": 1e3 * float(last),
                "late_mean_ms": 1e3 * float(late.mean()),
                "service_ms": 1e3 * float(run.rec.values["service_s"].mean()),
                "sustained": bool(failed == 0 and last <= 2 * first)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
