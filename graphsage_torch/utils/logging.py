"""Structured metrics logging: the counterpart of
``graphsage_tpu/utils/logging.py``, with the same record keys.

The reference prints raw ``(batch, loss)`` tuples (reference model.py:102).
``MetricsLogger`` keeps that stdout-compatible mode and additionally writes
JSONL records (one object per event: ``run``, ``event``, ``t`` and the
fields) for machine consumption.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class MetricsLogger:
    def __init__(
        self,
        jsonl_path: Optional[str] = None,
        stdout: bool = True,
        run_name: str = "run",
    ) -> None:
        self.stdout = stdout
        self.run_name = run_name
        self._fh = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._fh = open(jsonl_path, "a")
        self._t0 = time.time()

    def log(self, event: str, **fields: Any) -> None:
        if self._fh:
            rec = {"run": self.run_name, "event": event,
                   "t": round(time.time() - self._t0, 4), **fields}
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.stdout:
            if event == "step" and "step" in fields and "loss" in fields:
                print(fields["step"], fields["loss"])  # reference-compatible
            else:
                kv = " ".join(f"{k}={v}" for k, v in fields.items())
                print(f"[{event}] {kv}")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
