"""The port's examples (``graphsage_torch/examples/01``-``08``) run end to
end on the CPU, in-process, with few steps: each prints something, and the
lazy-ingestion example reports a zero-strided descriptor feature leaf.
``03`` and ``05`` form (or join) a gloo world of one in this process."""

import importlib

import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = [
    "01_train_cora",
    "02_unsupervised",
    "03_distributed",
    "04_serving",
    "05_pod_ingestion",
    "06_inductive",
    "07_skew_and_samplers",
    "08_layer0_modes",
]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name, capsys):
    module = importlib.import_module(f"graphsage_torch.examples.{name}")
    module.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert out.strip(), f"{name} printed nothing"
    if name == "05_pod_ingestion":
        assert "feature leaf is a descriptor (strides (0, 1))" in out
