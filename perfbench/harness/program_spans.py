"""The program's own set-up spans, read after the run from its recorder
(``graphsage_torch/utils/profiling.py``): the import of the package and the
phases it records whether or not the recorder is on (``ingest.*``,
``model.init``, ``trainer.init``, ``kernels.load``). A version of the
program without the recorder gives none, and its readers give ``None``."""

from __future__ import annotations


def program_spans() -> list | None:
    """The ``ph: "X"`` events of the program's export, or ``None``."""
    try:
        from graphsage_torch.utils import profiling

        export = profiling.export
    except (ImportError, AttributeError):
        return None
    return [e for e in export()["traceEvents"] if e.get("ph") == "X"]


def seconds(*names: str) -> float | None:
    """Host seconds of the process's spans named ``names``, each counted once
    (a span inside another of ``names`` is left out); ``None`` when there is
    none."""
    spans = program_spans()
    if spans is None:
        return None
    by_id = {e["args"]["id"]: e for e in spans}

    def inside_another(e) -> bool:
        p = e["args"]["parent"]
        while p is not None and p in by_id:
            if by_id[p]["name"] in names:
                return True
            p = by_id[p]["args"]["parent"]
        return False

    hits = [e for e in spans if e["name"] in names and not inside_another(e)]
    return 1e-6 * sum(e["dur"] for e in hits) if hits else None
