"""Read a cell's compared numbers on many seeds and variants in one
process: the program (the lower readings), the control (the reference in
the next lower precision in the program's place) and the planted faults
(the upper readings). Not part of a benchmark run.

    python3 perfbench/tools/readings.py --workload <name> --seeds 1,2,3 \\
        --variants program,control,fault:unchanged [--seconds 3] [--config reddit]

``--config`` names the configuration of a parked cell (one that
``BENCHMARK.json`` does not list).

Each seed's graph is made and built once and shared by its variants; one
JSON line per seed and variant: the numbers and whether they pass.
"""

from __future__ import annotations

import argparse
import json
import sys

import common  # noqa: F401  (puts the checkout on sys.path)
from perfbench.harness import core, program
from perfbench.inputs import graph as graph_inputs


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="program")
    p.add_argument("--config", help="a parked cell's configuration")
    p.add_argument("--seconds", type=float, default=0.0)
    a = p.parse_args()
    make_graph, build_graph = graph_inputs.make_graph, program.build_graph
    for seed in (int(s) for s in a.seeds.split(",")):
        cfg = common.make_run(a.workload, seed, 0, config=a.config).config
        inputs = make_graph(cfg, seed, "cuda")
        graph = None
        graph_inputs.make_graph = lambda config, s, device: inputs
        for variant in a.variants.split(","):
            run = common.make_run(a.workload, seed, a.seconds, variant, config=a.config)
            if graph is None:
                graph = build_graph(run, inputs)
            program.build_graph = lambda run, inputs: graph
            try:
                outcome, _ = core.execute(run)
                line = {"seed": seed, "variant": variant, "correct": outcome.correct,
                        "checks": {k: v for k, (v, _) in outcome.checks.items()},
                        "readings": run.rec.values.get("readings")}
            except Exception as e:  # a control that crashes has failed
                line = {"seed": seed, "variant": variant, "correct": False, "error": repr(e)}
            finally:
                program.build_graph = build_graph
            print(json.dumps(line), flush=True)
        graph_inputs.make_graph = make_graph
        del graph, inputs
        program.free(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
