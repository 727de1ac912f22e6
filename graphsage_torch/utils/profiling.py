"""Profiling: a ``torch.profiler`` trace of a block, and the program's span
recorder.

:func:`trace` profiles the enclosed block and writes a Chrome trace.

The recorder notes spans and counters at the program's layer boundaries
(the training step and its phases, the CSR mean, ingestion, the kernels'
build, serving) and keeps them in memory until :func:`export` writes them as
Chrome-trace events. It is off by default; :func:`enable` turns it on.

* ``span(name, device=False)`` is a context manager. A span records its name,
  start, end, thread and parent: the innermost span open on the same thread,
  or, for a span opened on autograd's thread during a backward, the innermost
  span open on the thread that called ``backward()``. With a CUDA ``device``
  it also records a pair of CUDA events on that device's current stream;
  :func:`export` reads their elapsed time once, as the span's ``device_ms``.
* ``count(name, n)`` adds the host integer ``n`` to a counter.
* ``phase(name)`` is a span of set-up (ingestion, a constructor, the
  kernels' load), recorded whether or not the recorder is on: a process runs
  a few, each costing two clock reads, and the last ``PHASE_LIMIT`` are kept.
  So a process that enables the recorder late, or never, can still export
  its set-up. The package's own import is one more, from two stamps in
  ``graphsage_torch/__init__.py``.

Off, ``span()`` returns one shared object that does nothing and ``count()``
returns after one flag test: no allocation, no profiler annotation, no
event, no lock. No span or counter reads a device value or synchronises;
only :func:`export` waits for the events it reads.

While a ``torch.profiler`` records and the recorder is on, every span and
phase is also a ``torch.profiler.record_function`` of its name, so it sits in
the profiler's trace on the same clock as the kernels. :func:`export` uses
the profiler's time base: an event's ``ts`` plus ``baseTimeNanoseconds`` /
1e3 is the wall clock (``time.time_ns()`` / 1e3) in µs, through one
``perf_counter_ns`` to ``time_ns`` anchor taken at :func:`enable`, so the
file overlays a profiler trace of the same process.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (host ops, and the card's kernels when a
    card is there) and write ``log_dir/trace.json``, a Chrome trace
    (``chrome://tracing`` or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------- recorder
PHASE_LIMIT = 4096  # set-up spans kept (the newest)
IMPORT_SPAN = "import.graphsage_torch"

_on = False
_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open spans, innermost last
_open: dict[int, list] = {}  # thread ident -> its stack, while it holds a span
_ids = itertools.count(1)
_spans: list = []  # closed spans, while the recorder is on
_phases: collections.deque = collections.deque(maxlen=PHASE_LIMIT)
_counts: dict[str, int] = {}
_anchor = (time.perf_counter_ns(), time.time_ns())


class _Off:
    """The span of a recorder that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _caller_span():
    """The innermost span open on the thread that called ``backward()``, for
    a span opened on autograd's thread: of every thread's open spans, the
    one opened last (one thread runs a backward at a time)."""
    with _lock:
        tops = [s[-1:] for s in _open.values()]
    return max((t[0] for t in tops if t), key=lambda s: s.id, default=None)


class _Span:
    __slots__ = ("name", "id", "parent", "tid", "t0", "t1", "events", "device_ms", "_rf",
                 "_store")

    def __init__(self, name: str, device, store):
        self.name, self._store = name, store
        self.events = self.device_ms = self._rf = None
        if device:
            dev = torch.device("cuda") if device is True else torch.device(device)
            if dev.type == "cuda" and torch.cuda.is_initialized():
                stream = torch.cuda.current_stream(dev)
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True), stream)

    def __enter__(self):
        stack = _stack()
        if stack:
            parent = stack[-1]
        elif torch._C._current_graph_task_id() != -1:
            parent = _caller_span()
        else:
            parent = None
        self.parent = parent.id if parent is not None else None
        self.id, self.tid = next(_ids), threading.get_native_id()
        if not stack:
            with _lock:
                _open[threading.get_ident()] = stack
        stack.append(self)
        if _on and torch._C._autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.events is not None:
            self.events[0].record(self.events[2])
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.events[2])
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        with _lock:
            if not stack:
                _open.pop(threading.get_ident(), None)
            self._store.append(self)
        return False


def enable() -> None:
    """Turn the recorder on, and anchor its clock to the wall clock."""
    global _on, _anchor
    _anchor = (time.perf_counter_ns(), time.time_ns())
    _on = True


def disable() -> None:
    """Turn the recorder off; what it recorded stays until :func:`reset`."""
    global _on
    _on = False


def recording() -> bool:
    """Whether the recorder is on (for a caller that must compute what it
    would count)."""
    return _on


def reset() -> None:
    """Forget every recorded span, phase and count."""
    with _lock:
        _spans.clear()
        _phases.clear()
        _counts.clear()


def span(name: str, device=False):
    """A span ``name`` around the enclosed block, while the recorder is on;
    ``device`` (a ``torch.device``, or ``True`` for the current CUDA device)
    adds CUDA events around it when it is a card."""
    if not _on:
        return _OFF
    return _Span(name, device, _spans)


def phase(name: str):
    """A set-up span ``name``, recorded whether the recorder is on or not."""
    return _Span(name, None, _phases)


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to the counter ``name``, while the recorder
    is on."""
    if not _on:
        return
    if not isinstance(n, int):
        raise TypeError(f"count({name!r}) takes a host int, got {type(n).__name__}")
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def _import_span() -> tuple | None:
    pkg = sys.modules.get("graphsage_torch")
    t0 = getattr(pkg, "_IMPORT_START_NS", None)
    t1 = getattr(pkg, "_IMPORT_END_NS", None)
    return (t0, t1) if t0 is not None and t1 is not None else None


def _device_ms(s: _Span) -> float | None:
    if s.events is not None and s.device_ms is None:
        s.events[1].synchronize()
        s.device_ms = s.events[0].elapsed_time(s.events[1])
        s.events = None
    return s.device_ms


def export(path: str | None = None) -> dict:
    """The recorded spans (``ph: "X"``, with ``id``, ``parent`` and
    ``device_ms`` in ``args``; the package's import as
    ``import.graphsage_torch``) and counters (``ph: "C"``, their totals) as a
    Chrome trace; written to ``path`` as JSON when given."""
    perf0, wall0 = _anchor
    pid = os.getpid()
    with _lock:
        closed = sorted([*_spans, *_phases], key=lambda s: s.t0)
        counts = dict(_counts)
    imp = _import_span()
    first = min([perf0, *(s.t0 for s in closed[:1]), *(imp[:1] if imp else ())])
    base = (first - perf0 + wall0) // 10**9 * 10**9  # a whole second, before every event

    def us(t_ns: int) -> float:
        return (t_ns - perf0 + wall0 - base) / 1e3

    events = []
    if imp is not None:
        events.append({"ph": "X", "name": IMPORT_SPAN, "ts": us(imp[0]),
                       "dur": (imp[1] - imp[0]) / 1e3, "pid": pid,
                       "tid": threading.main_thread().native_id,
                       "args": {"id": 0, "parent": None, "device_ms": None}})
    for s in closed:
        events.append({"ph": "X", "name": s.name, "ts": us(s.t0), "dur": (s.t1 - s.t0) / 1e3,
                       "pid": pid, "tid": s.tid,
                       "args": {"id": s.id, "parent": s.parent, "device_ms": _device_ms(s)}})
    now = us(time.perf_counter_ns())
    for name, value in sorted(counts.items()):
        events.append({"ph": "C", "name": name, "ts": now, "pid": pid,
                       "args": {"value": value}})
    out = {"traceEvents": events, "baseTimeNanoseconds": base, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f)
    return out
