"""``device.idle_share.serve``: in a device-only profiled stretch of served requests
(the waits between arrivals count), the share of the wall time in which no kernel, copy or
fill ran on the card: 1 - (the union of their intervals / the time from
the first one's start to the last one's end). The stretch profiles the
device alone, since recording the host's ops slows the host."""


def read(rec, cell):
    if rec.device is None or not cell.traffic["kind"].startswith("serve"):
        return None
    return 100.0 * (1.0 - rec.device["busy_s"] / rec.device["window_s"])
