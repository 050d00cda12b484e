"""The median, in ms, over every preview request of the window, from
``request()`` to its ``on_frame``: the slider's typical response."""

import statistics


def read(run):
    lat = run.latencies_s
    return 1e3 * statistics.median(lat) if lat else None
