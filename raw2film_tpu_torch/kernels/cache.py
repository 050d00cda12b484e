"""What a kernel launch keeps from one call to the next, behind one lock.

:func:`host` keeps a value built on the host (a kernel's packed by-value
launch struct); :func:`on_device` keeps a float32 table built on the host
and uploaded once per device (a resampling matrix, a tap stack above a
struct's capacity). Keys start with their kernel's or table's name; taps
are keyed by content (:func:`content_key`), since callers such as the burn
blur rebuild equal taps on every call. A hit is one dict lookup without
the lock; a miss builds outside it and inserts under it, the oldest entry
dropped first. Device tables are bounded per device, so frames on several
cards never evict each other's; every reader runs on its device's current
stream, so a dropped tensor is never in use on another.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from raw2film_tpu_torch.utils import trace

HOST_SIZE = 192  # launch structs kept, of every kernel
DEVICE_SIZE = 16  # tables kept per device, each up to a few MB at 45 MP

_lock = threading.Lock()
_host: dict = {}
_device: dict = {}  # str(device) -> {key: tensor}


def content_key(t):
    """A content key of a tap argument: arrays by dtype, shape and bytes,
    sequences element by element."""
    if isinstance(t, np.ndarray):
        return (t.dtype, t.shape, t.tobytes())
    return tuple(content_key(np.asarray(r)) for r in t)


def _insert(table: dict, key, value, bound: int):
    with _lock:
        if len(table) >= bound:
            table.pop(next(iter(table)))
        table[key] = value
    return value


def host(key, build):
    """``build()``, made once per ``key`` and kept."""
    hit = _host.get(key)
    if hit is not None:
        return hit
    return _insert(_host, key, build(), HOST_SIZE)


def on_device(key, build, device) -> torch.Tensor:
    """The float32 array ``build()`` on ``device``, contiguous (a kernel
    takes it as it is), uploaded once per ``key`` and device. Read-only by
    contract: callers only read it."""
    table = _device.setdefault(str(torch.device(device)), {})
    hit = table.get(key)
    if hit is not None:
        return hit
    out = trace.to_device(np.ascontiguousarray(build(), np.float32), device, copy=True)
    return _insert(table, key, out, DEVICE_SIZE)
