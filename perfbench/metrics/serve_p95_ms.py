"""``serve_p95_ms``: the 95th percentile (nearest rank) of all the window's
requests, each timed from its due time in the open-loop schedule to the
moment its answer is on the host; a failed request counts as missing
(infinitely late)."""

import math


def percentile_ms(latencies, q: float):
    lat = sorted(float(x) for x in latencies)
    if not lat:
        return None
    return 1e3 * lat[max(math.ceil(q * len(lat)) - 1, 0)]


def read(rec, cell):
    if "latencies_s" not in rec.values:
        return None
    return percentile_ms(rec.values["latencies_s"], 0.95)
