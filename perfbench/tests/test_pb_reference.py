"""The reference: its frontier checks, its precisions, and the program
held to it on tiny graphs on the CPU (every cell's sound run is correct)."""

import pytest
import torch

from perfbench.harness import core
from perfbench.reference.frontier import frontier_faults, sample_repeats, sample_skew
from perfbench.reference.model import Csr, CsrMean
from perfbench.reference.precision import mm, rounded
from conftest import CELLS, cell_spec, tiny_run


def small_csr():
    # 0-1, 0-2, 1-2, 2-3
    return Csr(torch.tensor([[0, 1], [0, 2], [1, 2], [2, 3]]), 5)


def test_csr_mean_and_its_transpose_backward():
    csr = small_csr()
    x = torch.arange(10.0).reshape(5, 2).requires_grad_(True)
    out = CsrMean.apply(x, csr)
    assert torch.allclose(out[2], (x[0] + x[1] + x[3]) / 3)
    assert torch.equal(out[4], torch.zeros(2))  # an isolated node
    out.sum().backward()
    # d out / d x[u] = sum over neighbours v of 1 / deg v.
    assert torch.allclose(x.grad[0], torch.full((2,), 1 / 2 + 1 / 3))


def frontier(parent_ids, child_rows, child_mask):
    ids = (torch.tensor(parent_ids), torch.tensor(child_rows).reshape(-1))
    masks = (torch.ones(len(parent_ids), dtype=torch.bool), torch.tensor(child_mask).reshape(-1))
    return ids, masks


def test_a_sound_frontier_has_no_faults():
    ids, masks = frontier([2, 4], [[0, 3], [0, 0]], [[True, True], [False, False]])
    assert frontier_faults(small_csr(), ids, masks, torch.tensor([2, 4])) == 0


@pytest.mark.parametrize("rows,mask,seeds", [
    ([[0, 4], [0, 0]], [[True, True], [False, False]], [2, 4]),  # 4 is no neighbour of 2
    ([[0, 0], [0, 0]], [[True, True], [False, False]], [2, 4]),  # a repeated child
    ([[0, 3], [0, 0]], [[True, False], [False, False]], [2, 4]),  # one short of min(deg, k)
    ([[0, 3], [0, 0]], [[True, True], [False, False]], [2, 3]),  # hop 0 is not the seeds
])
def test_each_broken_rule_is_counted(rows, mask, seeds):
    ids, masks = frontier([2, 4], rows, mask)
    assert frontier_faults(small_csr(), ids, masks, torch.tensor(seeds)) >= 1


def test_with_the_self_term_column_0_is_the_parent_under_its_mask():
    csr = small_csr()
    ids = (torch.tensor([2, 4]), torch.tensor([[2, 0, 3], [4, 0, 0]]).reshape(-1))
    mask = torch.tensor([[True, True, True], [True, False, False]]).reshape(-1)
    masks = (torch.ones(2, dtype=torch.bool), mask)
    assert frontier_faults(csr, ids, masks, torch.tensor([2, 4]), concat_self=True) == 0
    wrong = (ids[0], torch.tensor([[1, 0, 3], [4, 0, 0]]).reshape(-1))
    assert frontier_faults(csr, wrong, masks, torch.tensor([2, 4]), concat_self=True) == 1
    unmasked = (masks[0], torch.tensor([[False, True, True], [True, False, False]]).reshape(-1))
    assert frontier_faults(csr, ids, unmasked, torch.tensor([2, 4]), concat_self=True) >= 1


def star(deg):
    """Node 0 joined to nodes 1..deg."""
    return Csr(torch.stack([torch.zeros(deg, dtype=torch.long), torch.arange(1, deg + 1)], 1),
               deg + 1)


def draws(csr, children):
    """One frontier per row of ``children``, each grown from the seed 0."""
    k = children.shape[1]
    return [((torch.tensor([0]), row), (torch.ones(1, dtype=torch.bool), torch.ones(k, dtype=torch.bool)))
            for row in children]


def test_a_uniform_sample_reads_a_small_skew_and_no_repeat():
    csr, g = star(200), torch.Generator().manual_seed(3)
    children = torch.stack([torch.randperm(200, generator=g)[:10] + 1 for _ in range(300)])
    assert sample_skew(csr, draws(csr, children)) < 4
    assert sample_repeats(csr, draws(csr, children)) == 0


def test_the_first_k_neighbours_skew_and_a_fixed_draw_repeats():
    csr = star(200)
    first = torch.arange(1, 11).repeat(300, 1)
    assert sample_skew(csr, draws(csr, first)) > 50
    assert sample_repeats(csr, draws(csr, first)) == 299
    # Few subsets (C(12, 10) = 66): a repeat there is chance, not counted.
    small = star(12)
    assert sample_repeats(small, draws(small, torch.arange(1, 11).repeat(5, 1))) == 0


def test_tf32_keeps_ten_mantissa_bits_and_fp8_about_three():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -10)])
    assert torch.equal(rounded(x, "tf32"), torch.tensor([1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -10)]))
    y = torch.randn(1000)
    err = (rounded(y, "fp8") - y).abs() / y.abs().amax()
    assert 0 < err.max() < 2 ** -4
    a = torch.randn(8, 8, requires_grad=True)
    mm(a, torch.eye(8), "fp8").sum().backward()  # the gradient passes straight through
    assert torch.equal(a.grad, torch.ones(8, 8))


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference_on_a_tiny_graph(cell):
    outcome, line = core.execute(tiny_run(cell))
    assert outcome.correct, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    names = {m["name"] for m in cell_spec(cell).end_to_end}
    assert set(line["metrics"]) == names


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_run_reports_its_host_metrics(cell):
    run = tiny_run(cell, trace=True)
    outcome, line = core.execute(run)
    assert outcome.correct
    host = {m["name"] for m in run.spec.per_layer if m["source"] == "host_clock"}
    assert set(line["metrics"]) == host
    assert all(v["value"] > 0 for v in line["metrics"].values())


def test_the_same_seed_gives_the_same_checks():
    a = core.execute(tiny_run("reddit-sampled-train"))[0].checks
    b = core.execute(tiny_run("reddit-sampled-train"))[0].checks
    assert a == b
