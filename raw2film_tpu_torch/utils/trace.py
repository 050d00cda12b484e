"""Per-stage tracing/profiling (the counterpart of
``raw2film_tpu/utils/trace.py``).

A cheap stage timer that records a rolling log (:func:`stage_stats`) and
nests a ``torch.profiler.record_function`` range, so a stage shows by name
in a profiler trace, plus an env-gated report.

Enable wall-clock printing with RAW2FILM_TRACE=1.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

from torch.profiler import record_function

_LOG: dict[str, collections.deque] = collections.defaultdict(
    lambda: collections.deque(maxlen=64)
)


@contextlib.contextmanager
def stage_timer(name: str):
    """Times a stage on the host clock and nests a profiler range.

    The time is the host's: a stage that launches device work returns once
    the work is queued, unless it waits for a result (a download does), as
    the JAX package's timer measures around asynchronous dispatch. No
    synchronisation is added here."""
    t0 = time.perf_counter()
    with record_function(name):
        yield
    dt = time.perf_counter() - t0
    _LOG[name].append(dt)
    if _enabled():
        print(f"[trace] {name}: {dt * 1e3:.1f} ms")


def _enabled() -> bool:
    # Read at each stage: the package imports this module (through the
    # preview engine) before the CLI's --trace sets the variable.
    return os.environ.get("RAW2FILM_TRACE", "") not in ("", "0")


def stage_stats() -> dict[str, dict]:
    """name -> {count, mean_ms, last_ms} across recorded stages."""
    out = {}
    for name, samples in _LOG.items():
        if samples:
            out[name] = {
                "count": len(samples),
                "mean_ms": sum(samples) / len(samples) * 1e3,
                "last_ms": samples[-1] * 1e3,
            }
    return out


def reset_stats() -> None:
    _LOG.clear()
