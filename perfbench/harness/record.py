"""A run's record: host-clock spans recorded by the benchmark's own
wrappers around the calls into each layer, values the drivers note, and
the parsed profiler traces of a ``--trace 1`` run's two stretches.

Spans are kept in memory (a list of ``(start, end, inside a stretch)`` per
name) and read by the metric readers after the run. Inside the annotated
stretch each span is also a ``torch.profiler.record_function`` of the same
name, so the trace can attribute device kernels to it: a kernel belongs to
a span when the runtime call that launched it starts inside the span, on
its thread (the main thread, or autograd's for a span around a backward).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

STRETCH = "pb.stretch"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver", "runtime", "driver"}
HOST_CATS = {"cpu_op", "user_annotation", "operator"}
TOP = 10
NAME_CHARS = 120


class Record:
    def __init__(self) -> None:
        self.values: dict = {}
        self.spans: dict[str, list] = defaultdict(list)
        self.calls: dict[str, list] = defaultdict(list)
        self.traced = False  # spans are also profiler annotations
        self.in_stretch = False  # inside a profiled stretch: left out of host_ms
        self.trace: dict | None = None  # the annotated stretch, parsed
        self.device: dict | None = None  # the device-only stretch: busy_s, window_s
        self.pending: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = torch.profiler.record_function(name) if self.traced else contextlib.nullcontext()
        inside = self.in_stretch
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans[name].append((t0, time.perf_counter(), inside))

    def wrap(self, fn, name: str, on_call=None):
        """``fn`` inside a span ``name``; ``on_call(args, kwargs, out)`` notes
        each call made inside the profiled stretch (for the rooflines)."""
        def wrapped(*args, **kwargs):
            with self.span(name):
                out = fn(*args, **kwargs)
            if on_call is not None and self.traced:
                self.calls[name].append(on_call(args, kwargs, out))
            return out
        wrapped.__wrapped__ = fn
        return wrapped

    def host_ms(self, name: str) -> float | None:
        """Mean host milliseconds of the spans ``name`` outside the profiled
        stretches (the profiler slows the host inside them)."""
        spans = [t1 - t0 for t0, t1, inside in self.spans.get(name, ()) if not inside]
        return 1e3 * sum(spans) / len(spans) if spans else None


def _cat(e: dict) -> str:
    return str(e.get("cat", "")).lower()


def _union(intervals: list, lo: float, hi: float) -> tuple[float, list]:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]`` and the
    gaps it leaves there."""
    busy, gaps, at = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        if e > at:
            busy += e - max(s, at)
            at = e
    if hi > at:
        gaps.append((at, hi))
    return busy, gaps


def _innermost(starts: list, events: list, t: float, depth: int = 256) -> str | None:
    """Name of the latest-starting event of ``events`` (sorted by start)
    that contains ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - depth, -1), -1):
        e = events[j]
        if e["ts"] + e.get("dur", 0) >= t:
            return e["name"]
    return None


def parse_trace(path: str, span_names: tuple) -> dict | None:
    """The stretch's device picture from a Chrome trace of
    ``torch.profiler`` with host activity: device seconds per span of
    ``span_names`` (in order), the kernels that took most time, and the
    idle gaps by what the host was doing. ``None`` when the trace holds no
    device activity (the profiler on the card now and then records none)."""
    with open(path) as f:
        data = json.load(f)
    events = [e for e in (data["traceEvents"] if isinstance(data, dict) else data)
              if e.get("ph") == "X" and "ts" in e]
    stretch = [e for e in events if e.get("name") == STRETCH and "gpu" not in _cat(e)]
    device = [e for e in events if _cat(e) in DEVICE_CATS]
    if not stretch or not device:
        return None
    st = stretch[0]
    lo, hi, tid = st["ts"], st["ts"] + st["dur"], st.get("tid")
    _, gaps = _union([(e["ts"], e["ts"] + e.get("dur", 0)) for e in device], lo, hi)

    by_corr = defaultdict(float)
    for e in device:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr[corr] += e.get("dur", 0)
    runtime = defaultdict(list)  # by thread
    for e in sorted((e for e in events if _cat(e) in RUNTIME_CATS), key=lambda e: e["ts"]):
        runtime[e.get("tid")].append(e)
    rt_starts = {t: [e["ts"] for e in es] for t, es in runtime.items()}
    span_device = {}
    for name in span_names:
        spans = sorted((e for e in events if e.get("name") == name and "gpu" not in _cat(e)
                        and lo <= e["ts"] <= hi), key=lambda e: e["ts"])
        per = []
        for s in spans:
            rt, starts = runtime.get(s.get("tid"), []), rt_starts.get(s.get("tid"), [])
            a = bisect.bisect_left(starts, s["ts"])
            b = bisect.bisect_right(starts, s["ts"] + s["dur"])
            per.append(1e-6 * sum(by_corr.get(rt[i].get("args", {}).get("correlation"), 0.0)
                                  for i in range(a, b)))
        span_device[name] = per

    kernels = defaultdict(float)
    for e in device:
        kernels[str(e.get("name", "?"))[:NAME_CHARS]] += 1e-6 * e.get("dur", 0)
    host = sorted((e for e in events if e.get("tid") == tid and _cat(e) in HOST_CATS
                   and e.get("name") != STRETCH), key=lambda e: e["ts"])
    ann = [e for e in host if str(e.get("name", "")).startswith("pb.")]
    ops = [e for e in host if not str(e.get("name", "")).startswith("pb.")]
    ann_starts, op_starts = [e["ts"] for e in ann], [e["ts"] for e in ops]
    idle = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label = "/".join(x for x in (_innermost(ann_starts, ann, mid),
                                     _innermost(op_starts, ops, mid)) if x) or "host outside any op"
        idle[label[:NAME_CHARS]] += 1e-6 * (e - s)
    return {
        "span_device_s": span_device,
        "device_ops": sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:TOP],
    }


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_window(path: str) -> dict | None:
    """Busy and window seconds of a device-only trace: the union of the
    device's intervals over the span from its first start to its last end."""
    with open(path) as f:
        data = json.load(f)
    device = [(e["ts"], e["ts"] + e.get("dur", 0))
              for e in (data["traceEvents"] if isinstance(data, dict) else data)
              if e.get("ph") == "X" and "ts" in e and _cat(e) in DEVICE_CATS]
    if not device:
        return None
    lo, hi = min(s for s, _ in device), max(e for _, e in device)
    busy, _ = _union(device, lo, hi)
    return {"window_s": 1e-6 * (hi - lo), "busy_s": 1e-6 * busy}


class Stretch:
    """A profiled stretch of the window. ``annotate``: host ops and the
    benchmark's spans are recorded too (for the rooflines and the
    breakdown); otherwise only the device's activity, whose host cost is
    small enough for the idle share. Parsing waits for :func:`finish`, after
    the window."""

    def __init__(self, rec: Record, device, annotate: bool):
        self.rec, self.device, self.annotate = rec, device, annotate

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CUDA] if self.device.type == "cuda" else []
        if self.annotate or not acts:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        sync(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.rec.in_stretch = True
        if self.annotate:
            self.rec.calls.clear()
            self.rec.traced = True
            self.mark = torch.profiler.record_function(STRETCH)
            self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        if self.annotate:
            self.mark.__exit__(None, None, None)
        self.rec.traced = self.rec.in_stretch = False
        self.prof.stop()
        self.rec.pending.append(self)
        return False


def finish(rec: Record, span_names: tuple) -> None:
    """Parse the stretches profiled so far: an annotated one gives
    ``rec.trace``, a device-only one ``rec.device``."""
    pending, rec.pending = rec.pending, []
    for st in pending:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            st.prof.export_chrome_trace(path)
            parsed = parse_trace(path, span_names) if st.annotate else device_window(path)
        finally:
            os.remove(path)
        if parsed is not None and st.annotate:
            rec.trace = parsed
        elif parsed is not None:
            rec.device = parsed


ATTEMPTS = 3


def profile_stretches(rec: Record, device, work, length: int, span_names: tuple) -> None:
    """The profiled stretches of a ``--trace 1`` run, taken after the window
    over ``work(length)``: ``length`` more units (steps or requests) of the
    same work, so that the profiler's start (a stall of a second or more on
    the card) stays out of the window. First a stretch of the device's
    activity alone (the idle share: recording the host's ops slows the
    host), then an annotated one (the rooflines and the breakdown). Each
    profile is parsed before the next one starts (the card's device times
    read 0 in a profile exported after another profile ran), and one that
    recorded no device activity (the profiler on the card now and then
    records none) is taken again, up to ``ATTEMPTS`` times."""
    for annotate in (False, True):
        for attempt in range(ATTEMPTS):
            if (rec.trace if annotate else rec.device) is not None:
                break
            if attempt:
                time.sleep(1.0)
            with Stretch(rec, device, annotate):
                work(length)
            finish(rec, span_names)
            if device.type != "cuda":
                break  # no device activity to wait for
