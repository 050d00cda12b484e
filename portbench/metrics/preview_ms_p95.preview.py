"""The 95th percentile, in ms, over every preview request of the window,
from ``request()`` to its ``on_frame`` (at least 20 requests): the tail
beside the median that is bounded end to end."""

import statistics


def read(run):
    lat = run.latencies_s
    if len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[-1]
