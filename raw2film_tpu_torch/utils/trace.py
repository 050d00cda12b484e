"""Per-stage tracing: spans, counters and host-device copies (the
counterpart of ``raw2film_tpu/utils/trace.py``).

Recording is off by default. Off, a span costs one flag check (no clock
read, no profiler range, no allocation) and :func:`count` one dict add
under a lock. It turns on with :func:`enable`, or with ``RAW2FILM_TRACE``
set to a non-zero value when this module is imported; the CLI's
``--trace`` calls :func:`enable` and prints :func:`summary` at the end of
its run.

While recording:

- :func:`stage_timer` records each call as a
  :class:`Span`: its name, its start and end on ``time.perf_counter_ns()``,
  the id of the span open around it on its thread, and a request id. A span
  opened while none is open on its thread is a request root and takes a new
  request id; its descendants share it. A worker thread that runs part of a
  request opens its spans inside :func:`adopted` with the span that handed
  it the work (:func:`current` on the handing thread), so they join that
  request's tree instead of starting their own. Given a CUDA tensor as
  ``device``, a span also records a CUDA event pair on that device's
  current stream (unless ``enable(events=False)``), read only when asked
  (:meth:`Span.device_ms`): a span never waits on the device. With
  profiler ranges on (the default), a span nests
  ``torch.profiler.record_function("r2f." + name)``, which places it on a
  ``torch.profiler`` trace beside the device's operations.
- :func:`count` adds to the innermost open span's counts as well as to the
  running totals, so each request's tree carries its own counts. It takes
  a lock, so threads counting at once lose nothing.

The log keeps every span until :func:`reset_stats`. The running totals
(:data:`COUNTS`) count whether or not recording is on: kernel launches
(``launch.<kernel>``, which ``kernels/build.py::launches`` shows by kernel)
and the copies made by :func:`to_host` and :func:`to_device`: between the
host and a device (``copy.d2h.n``, ``copy.d2h.bytes``, ``copy.h2d.n``,
``copy.h2d.bytes``) and from one device to another (``copy.d2d.n``,
``copy.d2d.bytes``); of the copies down, those that land in page-locked
memory (``copy.d2h.pinned.n``, ``copy.d2h.pinned.bytes``).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch
from torch.profiler import record_function

_RECORDING = os.environ.get("RAW2FILM_TRACE", "") not in ("", "0")
_RANGES = True
_EVENTS = True
COUNTS: dict[str, int] = {}  # running totals; cleared in place only (kernels/build.py views it)
_LOG: list = []  # every span recorded since the last reset, in the order they opened
_OPEN = threading.local()  # .stack: the spans open on this thread
_COUNT_LOCK = threading.Lock()  # count()'s read-modify-write of COUNTS and a span's counts
_SPAN_IDS = itertools.count(1)
_REQUEST_IDS = itertools.count(1)


def enable(on: bool = True, ranges: bool = True, events: bool = True) -> None:
    """Turn recording on (or off with ``on=False``). ``ranges=False`` keeps
    the spans out of ``torch.profiler`` traces; ``events=False`` keeps the
    device spans to host time (a CUDA event pair costs tens of us of host
    time, where a caller times the same calls by other means)."""
    global _RECORDING, _RANGES, _EVENTS
    _RECORDING, _RANGES, _EVENTS = bool(on), bool(ranges), bool(events)


def recording() -> bool:
    return _RECORDING


class _Off:
    """The context of every span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class Span:
    """One recorded call: ``name``; ``id``; ``parent``, the id of the span
    open around it on its thread (None for a request root); ``request``;
    ``start_ns`` and ``end_ns`` (None while open) on
    ``time.perf_counter_ns()``; ``counts``, what :func:`count` added while
    it was the innermost open span (None for nothing); ``events``, its CUDA
    event pair or None."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns", "counts", "events",
                 "_device", "_range")  # _device: the tensor given, then the stream of the events

    def __init__(self, name: str, device=None, start_ns: int | None = None):
        self.name, self._device, self.start_ns = name, device, start_ns
        self.end_ns = self.counts = self.events = self._range = None

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, next(_REQUEST_IDS)
        self.id = next(_SPAN_IDS)
        stack.append(self)
        _LOG.append(self)
        if _RANGES:
            self._range = record_function("r2f." + self.name)
            self._range.__enter__()
        dev, self._device = self._device, None
        if dev is not None and _EVENTS and dev.is_cuda:
            self._device, self.events = _event_pair(dev)
            self.events[0].record(self._device)
        if self.start_ns is None:
            self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self._device)
            self._device = None
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        return False

    @property
    def ms(self) -> float:
        """Host time, in ms (the span must have closed)."""
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self) -> float | None:
        """Device time between the event pair, in ms; None without a pair
        or while its work is still queued (synchronise first)."""
        if self.events is None or not self.events[1].query():
            return None
        return self.events[0].elapsed_time(self.events[1])


def _event_pair(t: torch.Tensor) -> tuple:
    """(the current stream of ``t``'s device, two timing events)."""
    return (torch.cuda.current_stream(t.device),
            (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))


def stage_timer(name: str, device=None, start_ns: int | None = None):
    """The span ``name`` around a ``with`` block, while recording.

    Host time: a stage that queues device work returns once it is queued,
    unless it waits for a result (a download does); no synchronisation is
    added. ``device``: a tensor; on a CUDA device the span also records an
    event pair on its current stream. ``start_ns``: the span's start, where
    it began before the block (a queued request)."""
    if not _RECORDING:
        return _OFF
    return Span(name, device, start_ns)


def current() -> Span | None:
    """The innermost span open on this thread (None while none is, which
    recording off always gives): what a thread hands to its workers for
    :func:`adopted`."""
    stack = getattr(_OPEN, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def adopted(span: Span | None):
    """Open this thread's spans under ``span``, a span open on the thread
    that handed it the work: they take ``span``'s request, so the work done
    for one request on several threads is one tree. ``span`` stays open on
    its own thread and is not closed here; None adopts nothing."""
    if span is None:
        yield
        return
    stack = _stack()
    stack.append(span)
    try:
        yield
    finally:
        stack.remove(span)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the running total ``name`` and, while recording, to the
    innermost span open on this thread (an adopted span may be open on
    another thread too, hence the lock)."""
    with _COUNT_LOCK:
        COUNTS[name] = COUNTS.get(name, 0) + n
        if _RECORDING:
            stack = getattr(_OPEN, "stack", None)
            if stack:
                top = stack[-1]
                if top.counts is None:
                    top.counts = {}
                top.counts[name] = top.counts.get(name, 0) + n


def on_host(t: torch.Tensor) -> bool:
    """Whether ``t`` is in the host's memory: the test of a crossing."""
    return t.is_cpu


PINNED_MIN_BYTES = 1 << 20  # a CUDA tensor this large comes down into page-locked memory


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, counted as a device-to-host copy when ``t`` is on a
    device.

    A CUDA tensor of ``PINNED_MIN_BYTES`` or more lands in a new contiguous
    tensor of page-locked memory from torch's caching host allocator, by a
    blocking copy on its device's current stream (counted as well as
    ``copy.d2h.pinned.{n,bytes}``): DMA at the link's speed, where a pageable
    copy goes through small staging buffers at a fraction of it. The
    block goes back to the allocator's cache when the result (or a numpy view
    of it) is dropped, and the next copy of its size reuses it. Anything else
    is ``t.cpu()``: a host tensor as itself, a small fetch unpinned, since a
    pinned block costs more than an 8-byte copy saves."""
    if on_host(t):
        return t.cpu()
    nbytes = t.numel() * t.element_size()
    count("copy.d2h.n")
    count("copy.d2h.bytes", nbytes)
    if t.device.type != "cuda" or nbytes < PINNED_MIN_BYTES:
        return t.cpu()
    count("copy.d2h.pinned.n")
    count("copy.d2h.pinned.bytes", nbytes)
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def to_device(x, device, dtype=None, copy: bool = False) -> torch.Tensor:
    """``x`` (a tensor, or what ``torch.as_tensor`` takes) on ``device`` as
    ``dtype``: ``torch.as_tensor`` (a tensor's ``.to``), or with ``copy``
    always a new tensor (``torch.tensor``). Counted as a host-to-device copy
    of the result's bytes when ``x`` is on the host and ``device`` is not,
    and as a device-to-device copy when ``x`` is on another device."""
    if isinstance(x, torch.Tensor):
        out = x.to(device, dtype, copy=copy)
        if out is x:  # nothing moved
            return out
        if not on_host(x):  # a device's tensor: to the host, on its device, or to another
            if not on_host(out) and out.device != x.device:
                count("copy.d2d.n")
                count("copy.d2d.bytes", out.numel() * out.element_size())
            return out
    else:
        out = (torch.tensor if copy else torch.as_tensor)(x, dtype=dtype, device=device)
    if not on_host(out):
        count("copy.h2d.n")
        count("copy.h2d.bytes", out.numel() * out.element_size())
    return out


def requests() -> list[list[Span]]:
    """The log by request, in the order the roots opened: each request's
    spans in the order they opened, its root first."""
    by: dict[int, list] = {}
    for s in list(_LOG):
        by.setdefault(s.request, []).append(s)
    return [spans for spans in by.values() if spans[0].parent is None]


def stage_stats() -> dict[str, dict]:
    """name -> {count, mean_ms, last_ms} over every closed span recorded
    since the last reset, with ``device_mean_ms`` for spans whose event
    pairs have completed."""
    acc: dict[str, list] = {}
    for s in list(_LOG):
        if s.end_ns is None:
            continue
        a = acc.setdefault(s.name, [0, 0, 0, 0.0, 0])
        a[0] += 1
        a[1] += s.end_ns - s.start_ns
        a[2] = s.end_ns - s.start_ns
        dev = s.device_ms()
        if dev is not None:
            a[3] += dev
            a[4] += 1
    out = {}
    for name, (n, total, last, dev, n_dev) in acc.items():
        out[name] = {"count": n, "mean_ms": total / n / 1e6, "last_ms": last / 1e6}
        if n_dev:
            out[name]["device_mean_ms"] = dev / n_dev
    return out


def summary() -> list[str]:
    """One line for each span (count, mean ms, device mean ms) and for each
    counter's running total."""
    lines = []
    for name, st in stage_stats().items():
        dev = f", device {st['device_mean_ms']:.3f} ms" if "device_mean_ms" in st else ""
        lines.append(f"[trace] {name}: {st['count']} x {st['mean_ms']:.3f} ms{dev}")
    lines += [f"[trace] {name}: {n}" for name, n in sorted(COUNTS.items())]
    return lines


def reset_stats() -> None:
    """Forget every recorded span and every running total."""
    _LOG.clear()
    COUNTS.clear()
