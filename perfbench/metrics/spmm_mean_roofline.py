"""``spmm_mean_roofline``: the CSR mean of the full-graph layers (the
op the model looks up as ``spmm_mean``), forward calls and the backward
calls of those whose input takes a gradient, against the card's memory
bandwidth.

Bytes of one call: the input rows once (the forward's ``x``, the
backward's gradient), ``indptr``, the column indices of the edges in use,
and the output once. The least time is those bytes at 3.35 TB/s; the time
is the profiler's device time of every kernel launched inside the
benchmark's spans around the call and around its backward."""

from perfbench.harness.peaks import HBM_BYTES_PER_S

SPANS = ("pb.spmm_mean", "pb.spmm_mean.backward")


def call_bytes(call) -> int:
    indptr = call["indptr"]
    edges = int(indptr[-1])
    return (call["rows"] * call["cols"] * call["elem"] + indptr.numel() * indptr.element_size()
            + edges * call["idx_elem"] + call["out_bytes"])


def read(rec, cell):
    if rec.trace is None:
        return None
    pairs = []
    for span in SPANS:
        calls = rec.calls.get(span, [])
        times = rec.trace["span_device_s"].get(span, [])
        if len(calls) != len(times):
            return None  # a call the trace did not see: no share to give
        pairs += [(c, t) for c, t in zip(calls, times) if t > 0 and c["indptr"] is not None]
    if not pairs:
        return None
    least = sum(call_bytes(c) for c, _ in pairs) / HBM_BYTES_PER_S
    return 100.0 * least / sum(t for _, t in pairs)
