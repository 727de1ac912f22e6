"""``segment_max_roofline``: the CSR segment max of the full-graph max-pool
layers (the op the model looks up as ``segment_max``), forward calls and
the backward calls of those whose input takes a gradient, against the
card's memory bandwidth.

Bytes of a forward call: the input rows once, ``indptr``, the ids of the
edges in use, the output once and the int32 record it writes (the
neighbour that holds each max, or the count of a tie). Of a backward call:
the gradient and the record read once, the input's gradient written once.
The least time is those bytes at 3.35 TB/s; the time is the profiler's
device time of every kernel launched inside the benchmark's spans around
the call and around its backward. A program without the op (it gathers a
per-edge tensor instead) gives no calls, and no share."""

from perfbench.harness.peaks import HBM_BYTES_PER_S

SPANS = ("pb.segment_max", "pb.segment_max.backward")
RECORD_BYTES = 4  # int32


def call_bytes(call) -> int:
    table = call["rows"] * call["cols"]
    if call["backward"]:
        return table * (2 * call["elem"] + RECORD_BYTES)
    indptr = call["indptr"]
    edges = int(indptr[-1])
    return (table * (2 * call["elem"] + RECORD_BYTES)
            + indptr.numel() * indptr.element_size() + edges * indptr.element_size())


def read(rec, cell):
    if rec.trace is None:
        return None
    pairs = []
    for span in SPANS:
        calls = rec.calls.get(span, [])
        times = rec.trace["span_device_s"].get(span, [])
        if len(calls) != len(times):
            return None  # a call the trace did not see: no share to give
        pairs += [(c, t) for c, t in zip(calls, times) if t > 0]
    if not pairs:
        return None
    least = sum(call_bytes(c) for c, _ in pairs) / HBM_BYTES_PER_S
    return 100.0 * least / sum(t for _, t in pairs)
