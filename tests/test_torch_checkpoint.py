"""Checkpoints and resume in the port (``utils/checkpoint.py``,
``TrainLoop.state_dict``, ``run(initial_state=, checkpoint_path=,
checkpoint_every=)``) and the CLI flags around them, on the CPU.

A resumed run must equal an uninterrupted one bitwise here: the state holds
the parameters, the optimizer's moments, the generator and the step, and
the batch stream continues from the step.
"""

import json
import os
import shutil
import time

import pytest
import torch

from graphsage_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from graphsage_torch import (
    FullGraphTrainer,
    GraphSAGE,
    Trainer,
    TrainConfig,
    UnsupervisedTrainer,
)
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.train.experiments import main
from graphsage_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from graphsage_torch.utils.diagnostics import diagnose
from graphsage_torch.utils.logging import MetricsLogger

torch.set_num_threads(1)

CFG = dict(batch_size=16, test_size=20, val_size=20, log_every=0)


@pytest.fixture(scope="module")
def graph():
    return power_law_graph(num_nodes=100, num_edges=400, num_feats=8, num_classes=3,
                           seed=5, device="cpu")


def make(kind, graph, num_steps, **over):
    """A fresh trainer of ``kind`` whose model is initialised from seed 0."""
    gen = torch.Generator().manual_seed(0)
    if kind == "full-graph":
        model = GraphSAGE(8, 3, (8, 8), (None, None), device="cpu", generator=gen)
        cfg = TrainConfig(num_steps=num_steps, optimizer="adam", learning_rate=0.01,
                          **{**CFG, **over})
        return FullGraphTrainer(model, graph, cfg)
    if kind == "unsupervised":
        model = GraphSAGE(8, 3, (8, 8), (3, 3), final_activation="linear", device="cpu",
                          generator=gen)
        cfg = TrainConfig(num_steps=num_steps, optimizer="adam", learning_rate=0.01,
                          objective="unsupervised", num_negatives=4, **{**CFG, **over})
        return UnsupervisedTrainer(model, graph, cfg)
    model = GraphSAGE(8, 3, (8, 8), (3, 3), device="cpu", generator=gen)
    cfg = TrainConfig(num_steps=num_steps, optimizer=kind, learning_rate=0.1,
                      **{**CFG, **over})
    return Trainer(model, graph, cfg)


def test_roundtrip_identical(tmp_path, graph):
    tr = make("adam", graph, 2)
    tr.run(log=None)
    state = tr.state_dict()
    assert {"params|layers|0|weight", "params|layers|1|weight", "params|head", "key",
            "step", "opt_state|0|exp_avg", "opt_state|2|step"} <= set(state)
    path = save_checkpoint(tmp_path / "ckpt", state)
    assert path == str(tmp_path / "ckpt.pt") and os.listdir(tmp_path) == ["ckpt.pt"]
    back = restore_checkpoint(path, make("adam", graph, 2).state_dict(), map_location="cpu")
    assert back.keys() == state.keys()
    for k in state:
        assert back[k].dtype == state[k].dtype and torch.equal(back[k], state[k]), k


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam", "full-graph", "unsupervised"])
def test_resume_is_bitwise_an_uninterrupted_run(tmp_path, graph, kind):
    """Ten steps straight against five, a checkpoint, a fresh trainer
    restored from it, five more."""
    straight = make(kind, graph, 10)
    want = straight.run(log=None)
    first = make(kind, graph, 5)
    head = first.run(log=None, checkpoint_path=tmp_path / "ck", checkpoint_every=5)
    second = make(kind, graph, 5)
    state = restore_checkpoint(tmp_path / "ck", second.state_dict())
    assert int(state["step"]) == 5
    tail = second.run(log=None, initial_state=state)
    assert head["losses"] + tail["losses"] == want["losses"]
    assert second.step_count == straight.step_count == 10
    for (name, p), q in zip(straight.model.named_parameters(), second.model.parameters()):
        assert torch.equal(p, q), name
    assert tail["val_micro_f1"] == want["val_micro_f1"]
    if kind == "unsupervised":  # labels never reach the gradient
        assert second.model.head.grad is None
        assert torch.equal(second.model.head, make(kind, graph, 1).model.head)


def test_restores_raise(tmp_path, graph):
    tr = make("adam", graph, 1)
    state = tr.state_dict()
    path = save_checkpoint(tmp_path / "ck", state)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "nope", state)
    other = GraphSAGE(8, 3, (16, 8), (3, 3), device="cpu")
    wider = Trainer(other, graph, TrainConfig(optimizer="adam", **CFG)).state_dict()
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, wider)
    halves = {k: v.to(torch.float16) if k == "params|head" else v for k, v in state.items()}
    with pytest.raises(ValueError, match="a silent cast would mask a bf16/f32 mixup"):
        restore_checkpoint(path, halves)
    with pytest.raises(KeyError, match="checkpoint missing 'extra'"):
        restore_checkpoint(path, {**state, "extra": torch.zeros(1)})
    fewer = {k: v for k, v in state.items() if k != "key"}
    with pytest.raises(ValueError, match="extra entries"):
        restore_checkpoint(path, fewer)
    # An SGD trainer's state has no moments: its template rejects Adam's file.
    with pytest.raises(ValueError, match="extra entries"):
        restore_checkpoint(path, make("sgd", graph, 1).state_dict())


def test_periodic_snapshot_leaves_no_temp_file(tmp_path, graph):
    tr = make("adam", graph, 7)
    with pytest.raises(ValueError, match="needs checkpoint_path"):
        tr.run(log=None, checkpoint_every=3)
    tr.run(log=None, checkpoint_path=str(tmp_path / "snap"), checkpoint_every=3)
    assert os.listdir(tmp_path) == ["snap.pt"]
    assert int(restore_checkpoint(tmp_path / "snap", tr.state_dict())["step"]) == 6


# --------------------------------------------------------------------- CLI
def _cli(root, *extra):
    main(["--preset", "cora", "--data-root", str(root), "--device", "cpu", "--steps",
          "6", "--batch-size", "32", "--test-size", "100", "--val-size", "80", *extra])


def _value(lines, prefix):
    return next(float(ln.split(": ")[1]) for ln in lines if ln.startswith(prefix))


def test_cli_checkpoint_resume_eval_only(synth_cora_root, tmp_path, capsys):
    ck = str(tmp_path / "ck")
    _cli(synth_cora_root, "--checkpoint", ck, "--checkpoint-every", "4")
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == f"checkpoint written: {ck}.pt" and os.listdir(tmp_path) == ["ck.pt"]
    val = _value(out, "Validation F1: ")
    _cli(synth_cora_root, "--resume", ck, "--eval-only")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"resumed from {ck} at step 6"
    assert _value(out, "Validation F1: ") == val
    assert 0.0 <= _value(out, "Test F1: ") <= 1.0
    _cli(synth_cora_root, "--resume", ck, "--quiet")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"resumed from {ck} at step 6" and out[1].startswith("Validation F1: ")
    with pytest.raises(ValueError, match="eval_only requires resume_path"):
        _cli(synth_cora_root, "--eval-only")
    with pytest.raises(ValueError, match="eval_only does not train"):
        _cli(synth_cora_root, "--resume", ck, "--eval-only", "--checkpoint", ck + "2")


def test_cli_log_jsonl_writes_jax_records(synth_cora_root, tmp_path, capsys):
    path = tmp_path / "logs" / "run.jsonl"
    _cli(synth_cora_root, "--log-jsonl", str(path), "--quiet")
    capsys.readouterr()
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["event"] for r in recs] == ["step"] * 6 + ["eval"]
    assert [r["step"] for r in recs[:6]] == list(range(6))
    # The JAX package's logger, fed the same events, writes the same keys.
    want = tmp_path / "jax.jsonl"
    with JaxMetricsLogger(str(want), stdout=False, run_name="cora") as ml:
        for r in recs:
            ml.log(r["event"], **{k: v for k, v in r.items()
                                  if k not in ("run", "event", "t")})
    for got, exp in zip(recs, (json.loads(ln) for ln in want.read_text().splitlines())):
        assert list(got) == list(exp) and got["run"] == exp["run"] == "cora"
        assert {k: v for k, v in got.items() if k != "t"} == \
            {k: v for k, v in exp.items() if k != "t"}
    with MetricsLogger(stdout=True, run_name="x") as ml:  # stdout mode
        ml.log("step", step=3, loss=0.5)
        ml.log("eval", val_micro_f1=0.9)
    assert capsys.readouterr().out.splitlines() == ["3 0.5", "[eval] val_micro_f1=0.9"]


def test_cli_debug_nans_raises_on_a_nan_loss(synth_cora_root, tmp_path):
    root = tmp_path / "nan_cora"
    shutil.copytree(synth_cora_root, root)
    rows = (root / "cora.content").read_text().splitlines()
    with open(root / "cora.content", "w") as f:
        for row in rows:
            cols = row.split("\t")
            f.write("\t".join([cols[0]] + ["nan"] * (len(cols) - 2) + [cols[-1]]) + "\n")
    with pytest.raises(FloatingPointError, match="at step 0"):
        _cli(root, "--debug-nans", "--quiet")
    assert not torch.is_anomaly_enabled()  # the flag's scope ends with the run
    _cli(root, "--quiet")  # without the flag the NaN trains on


def test_cli_diagnostics_dir(synth_cora_root, tmp_path, capsys):
    diag = tmp_path / "diag"
    _cli(synth_cora_root, "--diagnostics-dir", str(diag), "--quiet")
    assert capsys.readouterr().out.splitlines()[0].startswith("Validation F1: ")
    assert os.listdir(diag) == [f"stack_trace_{os.getpid()}.txt"]
    # The watchdog dumps every thread's stack while the block runs.
    with diagnose(str(diag), hang_interval_seconds=0.05) as path:
        time.sleep(0.3)
    text = open(path).read()
    assert "most recent call first" in text and "test_cli_diagnostics_dir" in text
