"""``sample.host_ms.serve``: host milliseconds per call of the model's
``sample`` in a served request, from the benchmark's span around the call,
averaged over the window outside the profiled stretch."""


def read(rec, cell):
    if not cell.traffic["kind"].startswith("serve"):
        return None
    return rec.host_ms("pb.sample")
