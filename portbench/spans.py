"""Spans around calls into the program, and the reading of a profiler trace.

A span wraps one function of the program for the traced window only and is
taken off again after it: a host span records the host clock's interval of
each call (and names it in the profiler's trace); a device span records a
CUDA event pair on the current stream before and after each call, read once
the window has closed. Nothing in the program changes.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import time


class Span:
    def __init__(self, name: str, kind: str):
        self.name, self.kind = name, kind
        self.intervals: list[tuple[float, float]] = []  # host clock, s
        self.device_ms: list[float] = []
        self._events: list = []

    def finish(self) -> None:
        """Read the device times of the window's calls (after a synchronize)."""
        self.device_ms = [a.elapsed_time(b) for a, b in self._events]
        self._events = []

    @property
    def count(self) -> int:
        return len(self.intervals)

    def host_s(self) -> list[float]:
        return [b - a for a, b in self.intervals]


@contextlib.contextmanager
def record(name: str):
    import torch

    with torch.profiler.record_function(name):
        yield


def _resolve(path: str, attr: str):
    obj = importlib.import_module(path)
    *owners, leaf = attr.split(".")
    for o in owners:
        obj = getattr(obj, o)
    return obj, leaf


def install(wanted: dict, on_cuda: bool):
    """``wanted``: span name -> (module, attribute, "host" | "device").
    Returns (spans by name, what to restore)."""
    import torch

    spans, installed = {}, []
    for name, (path, attr, kind) in wanted.items():
        owner, leaf = _resolve(path, attr)
        fn = getattr(owner, leaf)
        span = Span(name, kind)

        def wrapper(*a, _fn=fn, _span=span, **kw):
            ev = None
            if _span.kind == "device" and on_cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t = time.perf_counter()
            with torch.profiler.record_function("portbench." + _span.name):
                out = _fn(*a, **kw)
            if ev is not None:
                ev[1].record()
                _span._events.append(ev)
            _span.intervals.append((t, time.perf_counter()))
            return out

        functools.update_wrapper(wrapper, fn)
        setattr(owner, leaf, wrapper)
        spans[name] = span
        installed.append((owner, leaf, fn))
    return spans, installed


def uninstall(installed) -> None:
    for owner, leaf, orig in reversed(installed):
        setattr(owner, leaf, orig)


def self_time_s(parent: Span, child: Span) -> list[float]:
    """Each parent call's duration less the child calls inside it."""
    starts = [a for a, _ in child.intervals]
    out = []
    for a, b in parent.intervals:
        i = bisect.bisect_left(starts, a)
        inner = 0.0
        while i < len(starts) and starts[i] < b:
            ca, cb = child.intervals[i]
            inner += min(cb, b) - ca
            i += 1
        out.append(b - a - inner)
    return out


# ------------------------------------------------------------ the profiler


class TraceSummary:
    """Device activity of a traced window: the union of the device's busy
    intervals, the window's length, time by device operation, and the idle
    gaps by the innermost ``portbench.*`` range open on the host."""

    def __init__(self, device_events, host_ranges, window_us):
        self.window_s = window_us / 1e6
        iv = sorted((s, s + d) for _, s, d in device_events if d > 0)
        busy, merged = 0.0, []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        self.busy_s = busy / 1e6
        by_op: dict[str, float] = {}
        for name, _, d in device_events:
            by_op[name] = by_op.get(name, 0.0) + d / 1e6
        self.by_op = by_op
        gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
        host = sorted(host_ranges, key=lambda r: r[1])
        starts = [s for _, s, _ in host]
        by_gap: dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            label, width = "no portbench range", None
            # the innermost (shortest) range that covers the gap's middle
            i = bisect.bisect_right(starts, mid)
            for name, s, e in host[max(0, i - 64) : i]:
                if s <= mid <= e and (width is None or e - s < width):
                    label, width = name, e - s
            by_gap[label] = by_gap.get(label, 0.0) + (b - a) / 1e6
        self.idle_by_range = by_gap

    def breakdown(self) -> dict:
        ops = sorted(self.by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_range.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


class Profiled:
    """``torch.profiler`` over a window; ``summary()`` reads it."""

    def __init__(self, on_cuda: bool):
        self.on_cuda = on_cuda

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.on_cuda:
            torch.cuda.synchronize()
        self.wall_us = (time.perf_counter() - self.t0) * 1e6
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> TraceSummary:
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns() / 1e3 if hasattr(e, "start_ns") else e.start_us()
            dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else e.duration_us()
            if str(e.device_type()).endswith("CUDA"):
                if not name.startswith("portbench."):  # the ranges' shadows on the device's timeline
                    device.append((name, start, dur))
            elif name.startswith("portbench."):
                host.append((name[len("portbench."):], start, start + dur))
        return TraceSummary(device, host, self.wall_us)
