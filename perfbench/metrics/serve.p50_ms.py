"""``serve.p50_ms``: the median (nearest rank) of the same request times as
``serve_p95_ms``, in the traced run."""

import math


def read(rec, cell):
    lat = sorted(float(x) for x in rec.values.get("latencies_s", ()))
    if not lat:
        return None
    return 1e3 * lat[max(math.ceil(0.5 * len(lat)) - 1, 0)]
