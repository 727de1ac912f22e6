"""The max-pooling cell ``reddit-pool-fullgraph-train`` on a tiny graph on
the CPU: the program is correct against ``reference/maxpool.py``, the
control and each fault are not, and the traced run reports its host
metrics. On the card (marked ``gpu``): the segment max at the cell's own
shape against the reference's ``CsrMax``."""

import pytest
import torch

from perfbench.harness import core, spec as specs
from conftest import tiny_run

CELL = "reddit-pool-fullgraph-train"
# Fewer edges than the other tiny cells: the CPU's plain route gathers a
# 512-wide row per edge slot.
EDGES = 20000


def pool_run(**kwargs) -> core.Run:
    run = tiny_run(CELL, **kwargs)
    run.spec.config.update(num_edges=EDGES, num_edge_slots=2 * EDGES)
    return run


def test_the_program_agrees_with_the_reference_on_a_tiny_graph():
    outcome, line = core.execute(pool_run())
    assert outcome.correct, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in specs.load_cell(CELL).end_to_end}


@pytest.mark.parametrize("variant", ["control", "fault:unchanged", "fault:half_batch",
                                     "fault:altered"])
def test_the_control_and_each_fault_are_not_correct(variant):
    outcome, line = core.execute(pool_run(variant=variant))
    assert not outcome.correct, line["checks"]


def test_the_traced_run_reports_its_host_metrics():
    run = pool_run(trace=True)
    outcome, line = core.execute(run)
    assert outcome.correct
    host = {m["name"] for m in run.spec.per_layer if m["source"] == "host_clock"}
    assert set(line["metrics"]) == host
    assert all(v["value"] > 0 for v in line["metrics"].values())


def test_step_products_count_the_pooling_mlp_and_both_halves():
    cell = specs.load_cell(CELL)
    prods = cell.driver().step_products(cell.config, 232965)
    assert [(p["k"], p["n"], p["input_grad"]) for p in prods] == [
        (602, 512, False), (602, 128, False), (512, 128, True),
        (128, 512, True), (128, 128, True), (512, 128, True), (128, 41, True)]


def test_segment_max_bytes_read_rows_ids_and_write_output_and_record():
    from perfbench.harness.spec import BENCH_DIR, load_module

    roof = load_module(BENCH_DIR / "metrics" / "segment_max_roofline.py", "t_smx_roofline")
    indptr = torch.tensor([0, 2, 5, 5], dtype=torch.int32)
    fwd = {"rows": 3, "cols": 8, "elem": 4, "indptr": indptr, "backward": False}
    assert roof.call_bytes(fwd) == 3 * 8 * (4 + 4 + 4) + 4 * 4 + 5 * 4
    assert roof.call_bytes(dict(fwd, backward=True)) == 3 * 8 * (4 + 4 + 4)


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric", [False, True])
def test_on_the_card_the_kernel_matches_csr_max_at_the_cells_shape(cuda, symmetric):
    """The generated Reddit graph and a pooled table [232965, 512] f32 of
    ReLU outputs: the forward bitwise, the backward to f32 rounding of its
    sums (zeros take none; ``symmetric``, as the model calls it, sends full
    ties through kernel 3), 16 column panels a call."""
    from graphsage_torch.ops import segment_max as smx
    from graphsage_torch.utils import profiling
    from perfbench.inputs.graph import make_graph
    from perfbench.reference.maxpool import CsrMax
    from perfbench.reference.model import Csr

    cfg = specs.load_cell(CELL).config
    inputs = make_graph(cfg, 2 ** 31 + 7, cuda)
    n = inputs.num_nodes
    csr = Csr(torch.from_numpy(inputs.pairs).to(cuda), n)
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=cuda)
    indptr[1:] = torch.cumsum(csr.degrees, 0)
    edge_dst = csr.dst.to(torch.int32)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.relu(torch.randn((n, cfg["model"]["pool_dim"]), generator=g, device=cuda))
    x[:, 5] = 0  # a unit that is off everywhere: every row ties at 0
    x[:, 6] = 0.5  # a dead unit's bias: every row ties with all its neighbours
    grad = torch.randn(x.shape, generator=g, device=cuda)
    profiling.reset()
    profiling.enable()
    try:
        xk = x.clone().requires_grad_(True)
        got = smx.segment_max(xk, indptr, edge_dst, symmetric)
        got.backward(grad)
        torch.cuda.synchronize()
        panels = {e["name"]: e["args"]["value"] for e in profiling.export()["traceEvents"]
                  if e["ph"] == "C"}["agg.segment_max.panels"]
    finally:
        profiling.disable()
        profiling.reset()
    assert panels == 16
    xr = x.clone().requires_grad_(True)
    want = CsrMax.apply(xr, csr)
    assert torch.equal(got, want)
    want.backward(grad)
    xs = x.clone().requires_grad_(True)
    CsrMax.apply(xs, csr).backward(grad.abs())  # the magnitude of each gradient's sum
    expect = torch.where(x == 0, 0.0, xr.grad)
    assert ((xk.grad - expect).abs() <= 1e-5 * xs.grad + 1e-6).all()
