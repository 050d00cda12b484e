"""The program's own spans and counters, as the per-layer readers see them.

The program records spans in request trees and counts launches and the
copies between the host and the device (``raw2film_tpu_torch/utils/
trace.py``). A reader calls :func:`record` when it is imported; per-layer
readers are loaded only in ``--trace 1`` runs, so the runs that decide the
end-to-end metrics keep the program's recording off. The program records
with its profiler ranges off, so its spans add no event to the profiler's
trace, which the device metrics read whole; and with its device spans' CUDA
event pairs off, since they cost tens of us of host time each and the
rooflines time the same two kernels with the harness's own pairs.

Readers run after the window and before the driver's ``release()`` and
``check()``, so the window's requests are the last ``len(run.latencies_s)``
request trees of the program's log; the set-up's and the warm-up's come
before them. Each metric is a mean per request over the window. A program
without this recorder gives nothing, and its readers return None.
"""

from __future__ import annotations


def _trace():
    try:
        from raw2film_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace if hasattr(trace, "enable") and hasattr(trace, "requests") else None


def record() -> None:
    """Turn the program's recording on, with its profiler ranges and its
    device spans' event pairs off."""
    trace = _trace()
    if trace is not None:
        trace.enable(ranges=False, events=False)


def window(run) -> list | None:
    """The window's request trees (each a list of spans, its root first),
    or None without a recorder or requests."""
    trace = _trace()
    n = len(run.latencies_s)
    if trace is None or not trace.recording() or n == 0:
        return None
    trees = trace.requests()
    return trees[-n:] if len(trees) >= n else None


def span_ms(run, match) -> float | None:
    """The mean per request, in ms, of the host time of the closed spans
    whose names ``match``, summed in each request (0 in a request without
    one); None where no request of the window has one."""
    trees = window(run)
    if not trees:
        return None
    found, total = False, 0.0
    for tree in trees:
        for s in tree:
            if s.end_ns is not None and match(s.name):
                found, total = True, total + s.ms
    return total / len(trees) if found else None


def root_ms(run, name: str) -> float | None:
    """The mean host time, in ms, of the window's request roots; None unless
    every root is named ``name`` and closed."""
    trees = window(run)
    if not trees or any(t[0].name != name or t[0].end_ns is None for t in trees):
        return None
    return sum(t[0].ms for t in trees) / len(trees)


def counted(run, name: str) -> float | None:
    """The mean per request of the counter ``name`` over each request's
    tree (0 where nothing was counted)."""
    trees = window(run)
    if not trees:
        return None
    return sum((s.counts or {}).get(name, 0) for tree in trees for s in tree) / len(trees)
