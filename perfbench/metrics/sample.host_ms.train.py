"""``sample.host_ms.train``: host milliseconds per call of the model's
``sample`` in a training step, from the benchmark's span around the call,
averaged over the window outside the profiled stretch."""


def read(rec, cell):
    if not cell.traffic["kind"].startswith("train"):
        return None
    return rec.host_ms("pb.sample")
