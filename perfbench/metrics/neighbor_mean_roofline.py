"""``neighbor_mean_roofline``: the sampled neighbour mean (the op the
model looks up as ``gather_mean``) against the card's memory bandwidth.

Bytes of one call: the distinct table rows its valid slots reference, its
ids and its mask, and its output, each read or written once. The least
time is those bytes at 3.35 TB/s; the time is the profiler's device time of
every kernel launched inside the benchmark's span around the call, in the
annotated stretch profiled after the window. The share is the summed least time over the summed
device time, whatever kernels do the work."""

import torch

from perfbench.harness.peaks import HBM_BYTES_PER_S

SPAN = "pb.neighbor_mean"


def call_bytes(call) -> int:
    idx, mask = call["idx"], call["mask"]
    rows = int(torch.unique(idx[mask]).numel())
    return (rows * call["cols"] * call["elem"] + idx.numel() * idx.element_size()
            + mask.numel() * mask.element_size() + call["out_bytes"])


def read(rec, cell):
    if rec.trace is None:
        return None
    calls = rec.calls.get(SPAN, [])
    times = rec.trace["span_device_s"].get(SPAN, [])
    pairs = [(c, t) for c, t in zip(calls, times) if t > 0]
    if not pairs:
        return None
    least = sum(call_bytes(c) for c, _ in pairs) / HBM_BYTES_PER_S
    return 100.0 * least / sum(t for _, t in pairs)
