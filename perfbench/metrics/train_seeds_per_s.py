"""``train_seeds_per_s``: labelled seed nodes whose loss the window's steps
took (a sampled step's batch; a full-graph step's whole train split), over
the window's whole time, which ends in a synchronise."""


def read(rec, cell):
    if "seeds_done" not in rec.values:
        return None
    return rec.values["seeds_done"] / rec.values["window_s"]
