"""The mean, in ms, over the window's calls of a host-clock span around
``io/dng.py::read_raw``: the DNG's parse and pixel read."""

SPANS = {"read": ("raw2film_tpu_torch.io.dng", "read_raw", "host")}


def read(run):
    span = run.spans.get("read")
    if span is None or not span.count:
        return None
    return 1e3 * sum(span.host_s()) / span.count
