"""Fault and hang stack traces for long runs: the counterpart of
``graphsage_tpu/utils/diagnostics.py``.

Inside :func:`diagnose`, a fault (SIGSEGV, SIGFPE, SIGABRT, SIGBUS, SIGILL)
dumps every Python thread's stack, and a watchdog dumps them again every
``hang_interval_seconds`` (a wedged kernel or collective shows where the
host waits), into one file in ``stack_trace_dir``. It is the standard
library's ``faulthandler``; the JAX package's ``cloud-tpu-diagnostics``
collector has no counterpart here, and this always acts, never a no-op.

Usage::

    from graphsage_torch.utils.diagnostics import diagnose
    with diagnose(stack_trace_dir="/path/to/debug"):
        trainer.run()

(CLI: ``python -m graphsage_torch.train --diagnostics-dir DIR ...``)
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import sys
from typing import Iterator, Optional


@contextlib.contextmanager
def diagnose(
    stack_trace_dir: Optional[str] = None,
    hang_interval_seconds: float = 600,
) -> Iterator[Optional[str]]:
    """Collect fault and hang stack traces for the enclosed block; yields
    the trace file's path (``stack_trace_<pid>.txt`` in ``stack_trace_dir``,
    which is created), or ``None`` without a directory (traces then go to
    standard error). On exit the watchdog stops and ``faulthandler``
    returns to the state it had (enabled on standard error or not)."""
    was_enabled = faulthandler.is_enabled()
    fh = None
    path = None
    if stack_trace_dir:
        os.makedirs(stack_trace_dir, exist_ok=True)
        path = os.path.join(stack_trace_dir, f"stack_trace_{os.getpid()}.txt")
        fh = open(path, "a")
    out = fh or sys.stderr
    faulthandler.enable(file=out, all_threads=True)
    faulthandler.dump_traceback_later(hang_interval_seconds, repeat=True, file=out)
    try:
        yield path
    finally:
        faulthandler.cancel_dump_traceback_later()
        if was_enabled:
            faulthandler.enable(file=sys.__stderr__, all_threads=True)
        else:
            faulthandler.disable()
        if fh is not None:
            fh.close()
