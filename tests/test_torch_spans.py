"""The span recorder of ``graphsage_torch/utils/profiling.py`` and the spans
and counters the program records with it, on the CPU; one test, marked
``gpu``, on the card. This file imports neither JAX nor the JAX package:

    python -m pytest -m gpu --noconftest tests/test_torch_spans.py
"""

import json
import threading
import warnings

import numpy as np
import pytest
import torch

from graphsage_torch import (
    FullGraphTrainer,
    GraphSAGE,
    ServingEngine,
    Trainer,
    TrainConfig,
    build_graph,
)
from graphsage_torch.data.synthetic import power_law_graph
from graphsage_torch.train.experiments import main
from graphsage_torch.utils import profiling

torch.set_num_threads(1)

CFG = dict(test_size=20, val_size=20, log_every=0)


@pytest.fixture
def recorder():
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def graph():
    return power_law_graph(num_nodes=160, num_edges=700, num_feats=12, num_classes=3,
                           seed=3, device="cpu")


def spans(out=None):
    """``name -> [event]`` of an export, and ``id -> event``."""
    out = profiling.export() if out is None else out
    by_name, by_id = {}, {}
    for e in out["traceEvents"]:
        if e["ph"] == "X":
            by_name.setdefault(e["name"], []).append(e)
            by_id[e["args"]["id"]] = e
    return by_name, by_id


def counters(out=None):
    out = profiling.export() if out is None else out
    return {e["name"]: e["args"]["value"] for e in out["traceEvents"] if e["ph"] == "C"}


def parent_name(e, by_id):
    p = e["args"]["parent"]
    return None if p is None else by_id[p]["name"]


def full_graph_trainer(graph, dev="cpu", **over):
    model = GraphSAGE(graph.num_features, graph.num_classes, (8, 8), (None, None),
                      concat_self=True, device=dev, generator=torch.Generator().manual_seed(0))
    cfg = TrainConfig(optimizer="adam", learning_rate=0.01, **{**CFG, **over})
    return FullGraphTrainer(model, graph, cfg)


def sampled_trainer(graph):
    model = GraphSAGE(graph.num_features, graph.num_classes, (8, 8), (5, 3), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    return Trainer(model, graph, TrainConfig(batch_size=16, **CFG))


def test_off_records_nothing_and_annotates_nothing(graph, monkeypatch):
    profiling.disable()
    profiling.reset()
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    assert profiling.span("a") is profiling.span("b", device=True)
    with profiling.span("a"):
        profiling.count("c", 3)
    trainer = full_graph_trainer(graph)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.step()
        trainer.model.sample(torch.Generator().manual_seed(0), graph,
                             torch.arange(4, dtype=torch.int32))
    by_name, _ = spans()
    assert calls == []
    assert counters() == {}
    # Off, only the set-up phases and the import are recorded.
    assert set(by_name) == {"import.graphsage_torch", "model.init", "trainer.init"}


def test_nesting_threads_and_counters(recorder, monkeypatch):
    with profiling.span("outer"):
        with profiling.span("inner"):
            profiling.count("c", 2)
        profiling.count("c", 5)
        # A span opened on another thread while a backward runs (autograd's
        # thread on the card) takes the calling thread's innermost span.
        monkeypatch.setattr(torch._C, "_current_graph_task_id", lambda: 7)
        worker = threading.Thread(target=lambda: profiling.span("on_autograd").__enter__()
                                  .__exit__(None, None, None))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        monkeypatch.undo()
        # Outside a backward, another thread's span is a root.
        other = threading.Thread(target=lambda: profiling.span("root").__enter__()
                                 .__exit__(None, None, None))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
    profiling.count("d", 1)
    with pytest.raises(TypeError, match="host int"):
        profiling.count("c", torch.tensor(1))
    by_name, by_id = spans()
    assert parent_name(by_name["inner"][0], by_id) == "outer"
    assert parent_name(by_name["outer"][0], by_id) is None
    assert parent_name(by_name["on_autograd"][0], by_id) == "outer"
    assert by_name["on_autograd"][0]["tid"] != by_name["outer"][0]["tid"]
    assert parent_name(by_name["root"][0], by_id) is None
    assert counters() == {"c": 7, "d": 1}
    outer, inner = by_name["outer"][0], by_name["inner"][0]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert all(e["args"]["device_ms"] is None for es in by_name.values() for e in es)


def test_spans_sit_on_the_profilers_clock(recorder, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            torch.ones(64).sum()
            with profiling.span("inner"):
                torch.ones(64).sum()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    ann = {e["name"]: e for e in trace["traceEvents"]
           if e.get("cat") == "user_annotation" and e["name"] in ("outer", "inner")}
    ours = profiling.export(str(tmp_path / "spans.json"))
    with open(tmp_path / "spans.json") as f:
        assert json.load(f) == json.loads(json.dumps(ours))
    by_name, _ = spans(ours)
    for name in ("outer", "inner"):
        theirs = ann[name]["ts"] + trace["baseTimeNanoseconds"] / 1e3
        mine = by_name[name][0]["ts"] + ours["baseTimeNanoseconds"] / 1e3
        assert abs(theirs - mine) < 1e3, name


def spmm_call_bytes(rows_in, rows_out, cols, elem, num_edges):
    """The bytes of one CSR-mean call: its input rows once, the CSR of its
    ``rows_out`` output rows (int32), their edges' ids, the output once. Over
    a whole graph (``rows_in == rows_out``) this is the benchmark's
    (``perfbench/metrics/spmm_mean_roofline.py:call_bytes``)."""
    return (rows_in + rows_out) * cols * elem + 4 * (rows_out + 1) + 4 * num_edges


def test_full_graph_step_tree_and_bytes(graph, recorder, monkeypatch):
    from graphsage_torch.models import graphsage as gs

    trainer = full_graph_trainer(graph)
    calls = []  # (input rows, output rows, width, edges, takes a gradient) of each CSR mean
    inner = gs.spmm_mean

    def noted(x, *args, **kwargs):
        calls.append((x.shape[0], args[3], x.shape[1], kwargs["num_edges"], x.requires_grad))
        return inner(x, *args, **kwargs)
    monkeypatch.setattr(gs, "spmm_mean", noted)
    profiling.reset()
    trainer.step()
    by_name, by_id = spans()
    assert [parent_name(by_name[n][0], by_id) for n in
            ("step", "step.forward", "step.backward", "step.optimizer")] == \
        [None, "step", "step", "step"]
    fwd, bwd = by_name["agg.spmm_mean"], by_name["agg.spmm_mean.backward"]
    assert len(fwd) == len(calls) == trainer.model.num_layers
    assert len(bwd) == sum(c[-1] for c in calls) >= 1
    assert {parent_name(e, by_id) for e in fwd} == {"step.forward"}
    assert {parent_name(e, by_id) for e in bwd} == {"step.backward"}
    # Layer 0 over every node, the last layer over the train rows.
    assert [c[:2] for c in calls] == [(graph.num_nodes, graph.num_nodes),
                                      (graph.num_nodes, len(trainer.train_nodes))]
    assert calls[0][3] == graph.num_edges > calls[1][3]
    # The forward calls, and the backward of each whose input takes a
    # gradient: from the gradient's rows back to the input's, over the
    # transpose of the same edges.
    want = sum(spmm_call_bytes(n, r, w, 4, e) + g * spmm_call_bytes(r, n, w, 4, e)
               for n, r, w, e, g in calls)
    assert counters()["agg.spmm_mean.bytes"] == want


def test_loss_rows_counter_counts_the_last_layers_rows(graph, monkeypatch):
    """``step.loss_rows``: the rows the full-graph step's last layer and head
    computed, once a step while the recorder is on (the train rows here, all
    N where the split leaves none out); off, the step makes no call to the
    recorder's counter."""
    calls = []
    count = profiling.count
    monkeypatch.setattr(profiling, "count", lambda *a: (calls.append(a), count(*a)))
    trainer = full_graph_trainer(graph)
    every = full_graph_trainer(graph, test_size=0, val_size=0)
    profiling.disable()
    profiling.reset()
    trainer.step()
    every.step()
    assert calls == [] and counters() == {}
    profiling.enable()
    try:
        for t in (trainer, trainer, every):
            t.step()
        c = counters()
    finally:
        profiling.disable()
        profiling.reset()
    assert len(trainer.train_nodes) < graph.num_nodes
    assert c["step.loss_rows"] == 2 * len(trainer.train_nodes) + graph.num_nodes


def test_build_graph_phases(graph, recorder):
    profiling.disable()  # phases are recorded either way
    build_graph(np.ones((5, 3), np.float32), np.zeros(5), np.array([[0, 1], [1, 2], [2, 1]]),
                device="cpu")
    by_name, by_id = spans()
    for name in ("ingest.sort", "ingest.layout", "ingest.to_device"):
        assert [parent_name(e, by_id) for e in by_name[name]] == ["ingest.build_graph"]
    assert parent_name(by_name["ingest.build_graph"][0], by_id) is None
    assert by_name["import.graphsage_torch"][0]["dur"] > 0


@pytest.mark.parametrize("kind", ["trainer", "sampled-serving", "table-serving"])
def test_sampled_step_and_serving_spans(graph, recorder, kind):
    if kind == "trainer":
        trainer = sampled_trainer(graph)
        profiling.reset()
        trainer.step(trainer.train_nodes[:16])
        tree = {"step": None, "step.sample": "step", "step.forward": "step",
                "step.backward": "step", "step.optimizer": "step"}
        hops, slots = 2, 16 * 3 + 16 * 3 * 5
    else:
        model = GraphSAGE(graph.num_features, graph.num_classes, (8, 8), (5, 3), device="cpu")
        engine = ServingEngine(model, graph, mode=kind.split("-")[0], batch_buckets=(8,),
                               device="cpu")
        profiling.reset()
        assert engine.logits(np.arange(5)).shape == (5, graph.num_classes)
        tree = {"serve.logits": None, "serve.pad": "serve.logits",
                "serve.copy_in": "serve.logits", "serve.forward": "serve.logits",
                "serve.copy_out": "serve.logits"}
        if kind == "sampled-serving":
            tree["serve.sample"] = "serve.logits"
            hops, slots = 2, 8 * 3 + 8 * 3 * 5
        else:
            hops = slots = None
    by_name, by_id = spans()
    assert {n: parent_name(by_name[n][0], by_id) for n in tree} == tree
    assert all(len(by_name[n]) == 1 for n in tree)
    c = counters()
    assert (c.get("sample.hops"), c.get("sample.slots")) == (hops, slots)


@pytest.mark.parametrize("kind", ["full-graph", "sampled"])
def test_recorder_changes_no_result(graph, kind):
    def run(on):
        profiling.reset()
        (profiling.enable if on else profiling.disable)()
        try:
            t = full_graph_trainer(graph) if kind == "full-graph" else sampled_trainer(graph)
            batches = t.batches() if kind == "sampled" else None
            losses = [t.step(next(batches)) if batches else t.step() for _ in range(3)]
            return losses, [p.detach().clone() for p in t.model.parameters()]
        finally:
            profiling.disable()
            profiling.reset()
    (l_off, p_off), (l_on, p_on) = run(False), run(True)
    for a, b in zip(l_off + p_off, l_on + p_on):
        assert torch.equal(a, b)


def test_cli_spans_writes_a_chrome_trace(synth_cora_root, tmp_path, capsys):
    path = tmp_path / "spans.json"
    try:
        main(["--preset", "cora", "--data-root", str(synth_cora_root), "--device", "cpu",
              "--steps", "2", "--test-size", "100", "--val-size", "80", "--quiet",
              "--spans", str(path)])
    finally:
        profiling.disable()
        profiling.reset()
    with open(path) as f:
        out = json.load(f)
    by_name, by_id = spans(out)
    assert len(by_name["step"]) == 2 and len(by_name["step.sample"]) == 2
    assert {"import.graphsage_torch", "ingest.build_graph", "model.init",
            "trainer.init"} <= set(by_name)
    assert all(e["ph"] in ("X", "C") and e["ts"] >= 0 for e in out["traceEvents"])
    # Two steps and the validation's sampled forward, two hops each.
    assert counters(out)["sample.hops"] == 6


@pytest.mark.gpu
def test_card_spans_read_no_device_value():
    """A traced full-graph step warns no more under ``set_sync_debug_mode``
    than an untraced one, and every span on the card exports a device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = power_law_graph(num_nodes=3000, num_edges=20000, num_feats=64, num_classes=5,
                        seed=1, device="cuda")
    trainer = full_graph_trainer(g, dev="cuda")
    trainer.step()
    torch.cuda.synchronize()

    def warnings_of_a_step(on):
        profiling.reset()
        (profiling.enable if on else profiling.disable)()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                trainer.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            profiling.disable()
        return len(caught)

    off, on = warnings_of_a_step(False), warnings_of_a_step(True)
    assert on <= off
    by_name, by_id = spans()
    device_spans = ("step", "step.forward", "step.backward", "step.optimizer",
                    "agg.spmm_mean", "agg.spmm_mean.backward")
    for name in device_spans:
        assert by_name[name] and all(e["args"]["device_ms"] > 0 for e in by_name[name]), name
    # The CSR mean's backward runs on autograd's device thread.
    for e in by_name["agg.spmm_mean.backward"]:
        assert parent_name(e, by_id) == "step.backward"
    profiling.reset()
