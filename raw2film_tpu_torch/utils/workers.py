"""Decode thread-pool sizing shared by the host RAW decoders.

One parse of the ``R2F_DECODE_THREADS`` override (documented in
docs/raw_formats.md) so the CRX band pool and the DNG tile pool cannot
drift, and so a malformed value (empty string from a YAML "unset", a
typo, a negative number) degrades to the default instead of crashing an
unrelated file's decode.
"""

from __future__ import annotations

import os

_CAP = 16  # diminishing returns past this; bounds pool memory


def decode_workers(n_jobs: int) -> int:
    """Thread count for ``n_jobs`` independent decode units (tiles,
    strips, subband records).

    ``R2F_DECODE_THREADS`` overrides when it parses as a positive int;
    anything else (unset, empty, non-numeric, <= 0) falls back to
    ``min(16, cpu_count)``. Always in ``[1, n_jobs]`` for ``n_jobs >= 1``.
    """
    raw = os.environ.get("R2F_DECODE_THREADS", "")
    n = 0
    try:
        n = int(raw)
    except (TypeError, ValueError):
        n = 0
    if n <= 0:
        n = min(_CAP, os.cpu_count() or 1)
    return max(1, min(n, n_jobs))
