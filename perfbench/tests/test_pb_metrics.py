"""The metric arithmetic: FLOP and byte counts, the idle union, the trace's
attribution of kernels to spans, a p95 over all requests, and request
times taken from the due time."""

import json
import math
import time

import numpy as np
import pytest
import torch

from perfbench.harness import spec as specs
from perfbench.harness.record import Record, _union, device_window, parse_trace
from perfbench.harness.spec import BENCH_DIR, load_module
from perfbench.inputs.schedule import Schedule
from conftest import cell_spec, tiny_run


def reader_module(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


def test_step_flops_counts_three_products_except_a_frozen_input():
    mfu = reader_module("train_step_mfu")
    products = [{"m": 12800, "k": 602, "n": 128, "input_grad": False},
                {"m": 512, "k": 128, "n": 128, "input_grad": True}]
    assert mfu.step_flops(products) == 2 * 12800 * 602 * 128 * 2 + 2 * 512 * 128 * 128 * 3


def test_mfu_is_flops_over_window_over_the_peak_of_the_compute_dtype():
    mfu = reader_module("train_step_mfu")
    rec = Record()
    rec.values.update(step_products=[{"m": 1000, "k": 1000, "n": 1000, "input_grad": True}],
                      steps=10, window_s=2.0)
    cell = cell_spec("products-sampled-train")  # float32: 67 TFLOP/s
    assert mfu.read(rec, cell) == pytest.approx(100 * 6e9 * 10 / 2.0 / 67e12)


def test_sampled_step_products_follow_the_frontier():
    drv = cell_spec("reddit-sampled-train").driver()
    cfg = cell_spec("reddit-sampled-train").config
    # With the self term each row carries its parent ahead of its children.
    ids = [torch.zeros(512), torch.zeros(512 * 26), torch.zeros(512 * 26 * 11)]
    prods = drv.step_products(cfg, ids)
    assert [(p["m"], p["k"], p["n"], p["input_grad"]) for p in prods] == [
        (13312, 1204, 128, False), (512, 256, 128, True), (512, 128, 41, True)]


def test_fullgraph_step_products_map_every_node():
    cell = specs.load_cell("reddit-fullgraph-train")
    prods = cell.driver().step_products(cell.config, 232965)
    assert [(p["m"], p["k"], p["n"]) for p in prods] == [
        (232965, 1204, 128), (232965, 256, 128), (232965, 128, 41)]


def test_neighbor_mean_bytes_count_distinct_valid_rows_once():
    roof = reader_module("neighbor_mean_roofline")
    idx = torch.tensor([[3, 3, 7], [9, 1, 1]], dtype=torch.int32)
    mask = torch.tensor([[True, True, True], [True, False, False]])
    call = {"cols": 100, "elem": 2, "idx": idx, "mask": mask, "out_bytes": 2 * 100 * 4}
    assert roof.call_bytes(call) == 3 * 100 * 2 + 6 * 4 + 6 + 800


def test_spmm_bytes_read_x_indptr_indices_and_write_the_output_once():
    roof = reader_module("spmm_mean_roofline")
    indptr = torch.tensor([0, 2, 5, 5], dtype=torch.int32)
    call = {"rows": 3, "cols": 8, "elem": 2, "indptr": indptr, "idx_elem": 4, "out_bytes": 48}
    assert roof.call_bytes(call) == 3 * 8 * 2 + 4 * 4 + 5 * 4 + 48


def test_roofline_share_is_least_time_over_device_time():
    roof = reader_module("spmm_mean_roofline")
    rec = Record()
    indptr = torch.tensor([0, 1], dtype=torch.int32)
    rec.calls["pb.spmm_mean"] = [{"rows": 1, "cols": 1, "elem": 4, "indptr": indptr,
                                  "idx_elem": 4, "out_bytes": 4}] * 2
    rec.trace = {"span_device_s": {"pb.spmm_mean": [1e-9, 3e-9]}}
    least = 2 * 20 / 3.35e12
    assert roof.read(rec, None) == pytest.approx(100 * least / 4e-9)
    rec.trace = {"span_device_s": {}}
    assert roof.read(rec, None) is None  # nothing to read: no number, never 0


def test_union_of_overlapping_intervals_and_its_gaps():
    busy, gaps = _union([(1, 3), (2, 5), (7, 8), (12, 20)], 0, 10)
    assert busy == 5 and gaps == [(0, 1), (5, 7), (8, 10)]


def trace_file(tmp_path, events):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def test_trace_attributes_kernels_by_launch_inside_the_span(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb.stretch", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.neighbor_mean", "ts": 10, "dur": 15, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 2, "tid": 1,
         "args": {"correlation": 5}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 30, "dur": 2, "tid": 1,
         "args": {"correlation": 6}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 40, "dur": 20, "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 60, "dur": 10, "args": {"correlation": 6}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 75, "dur": 20, "tid": 1},
    ]
    t = parse_trace(trace_file(tmp_path, ev), ("pb.neighbor_mean",))
    assert t["span_device_s"]["pb.neighbor_mean"] == [pytest.approx(20e-6)]
    assert dict(t["device_ops"]) == {"k1": pytest.approx(20e-6), "k2": pytest.approx(10e-6)}
    gaps = dict(t["idle_gaps"])
    assert gaps["aten::add"] == pytest.approx(30e-6)  # the gap from 70 to 100
    # The gap from 0 to 40 is labelled by the span holding its midpoint.
    assert gaps["pb.neighbor_mean"] == pytest.approx(40e-6)


def test_a_span_on_autograds_thread_takes_the_kernels_launched_there(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb.stretch", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.spmm_mean.backward", "ts": 10, "dur": 15,
         "tid": 2},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 2, "tid": 2,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 13, "dur": 2, "tid": 1,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 40, "dur": 20, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 60, "dur": 10, "args": {"correlation": 8}},
    ]
    t = parse_trace(trace_file(tmp_path, ev), ("pb.spmm_mean.backward",))
    assert t["span_device_s"]["pb.spmm_mean.backward"] == [pytest.approx(20e-6)]


def test_spmm_roofline_takes_forward_and_backward_calls():
    roof = reader_module("spmm_mean_roofline")
    rec = Record()
    indptr = torch.tensor([0, 1], dtype=torch.int32)
    call = {"rows": 1, "cols": 1, "elem": 4, "indptr": indptr, "idx_elem": 4, "out_bytes": 4}
    rec.calls["pb.spmm_mean"] = [call]
    rec.calls["pb.spmm_mean.backward"] = [call]
    rec.trace = {"span_device_s": {"pb.spmm_mean": [1e-9], "pb.spmm_mean.backward": [3e-9]}}
    assert roof.read(rec, None) == pytest.approx(100 * 2 * 20 / 3.35e12 / 4e-9)
    rec.trace["span_device_s"]["pb.spmm_mean.backward"] = []  # a call the trace missed
    assert roof.read(rec, None) is None


def test_device_window_runs_from_first_start_to_last_end(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 100, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "b", "ts": 105, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "c", "ts": 150, "dur": 50}]
    w = device_window(trace_file(tmp_path, ev))
    assert w["window_s"] == pytest.approx(100e-6) and w["busy_s"] == pytest.approx(65e-6)
    assert device_window(trace_file(tmp_path, ev[:0])) is None


def test_p95_is_the_nearest_rank_over_all_requests_and_a_failure_is_missing():
    p95 = reader_module("serve_p95_ms")
    lat = np.arange(1, 101) / 1e3  # 1..100 ms
    assert p95.percentile_ms(lat, 0.95) == pytest.approx(95.0)
    lat[:6] = np.inf  # six failed requests: beyond the 95th percentile
    assert math.isinf(p95.percentile_ms(lat, 0.95))
    p50 = reader_module("serve.p50_ms")
    rec = Record()
    rec.values["latencies_s"] = np.arange(1, 102) / 1e3
    assert p50.read(rec, None) == pytest.approx(51.0)


class SlowEngine:
    """Answers each request after ``service`` seconds."""

    def __init__(self, service):
        self.service = service

    def logits(self, ids):
        time.sleep(self.service)
        return np.zeros((len(ids), 2))


def test_request_time_counts_from_the_due_time_so_a_stall_delays_later_requests():
    drv = cell_spec("reddit-sampled-serve").driver()
    run = tiny_run("reddit-sampled-serve")
    sched = Schedule(due=np.array([0.0, 0.001, 0.002]), sizes=np.array([1, 1, 1]),
                     ids=[np.array([0])] * 3)
    lat, late, failed = drv.open_loop(run, SlowEngine(0.05), sched)
    assert failed == 0
    # All three are due within 2 ms, and each waits for the one before it.
    assert lat[0] >= 0.05 and lat[1] >= 0.099 and lat[2] >= 0.148
    assert late.max() < 0.01  # the generator itself was on time
