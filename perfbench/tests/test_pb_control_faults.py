"""The comparison has to fail: the control (the reference in the next lower
precision in the program's place) and each fault a cell can have, planted
in the program underneath a run that skips only the look for a card."""

import pytest

from perfbench.harness import core
from conftest import tiny_run

SAMPLER = ("first_k", "fixed_sample")
FAULTS = {
    "reddit-sampled-train": ("unchanged", "half_batch", "altered") + SAMPLER,
    "products-sampled-train": ("unchanged", "half_batch", "altered") + SAMPLER,
    "reddit-fullgraph-train": ("unchanged", "half_batch", "altered"),
    "reddit-sampled-serve": ("altered",) + SAMPLER,
}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_the_control_is_not_correct(cell):
    outcome, line = core.execute(tiny_run(cell, variant="control"))
    assert not outcome.correct, line["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(FAULTS.items()) for f in fs])
def test_each_fault_is_not_correct(cell, fault):
    outcome, line = core.execute(tiny_run(cell, variant=f"fault:{fault}"))
    assert not outcome.correct, line["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_on_the_card_sound_is_correct_and_the_control_is_not(cuda, cell):
    assert core.execute(tiny_run(cell, device="cuda"))[0].correct
    assert not core.execute(tiny_run(cell, variant="control", device="cuda"))[0].correct
